"""Device codec benchmarks (the reference's rdtsc harness, re-done as
measured device time in Gpix/s on the accelerator).

Reference harness: one 2536×2048 random frame, rdtsc cycles → fps at an
assumed 3.33 GHz (dbde_util_test.cpp:303-364).  Measured on a 1-core Xeon
VM at 2.1 GHz (library -O3, driver -O0 — the only build that passes the
reference's own golden checks; provenance in BASELINE.md): encode ≈2.8
Gpix/s, decode ≈2.9 Gpix/s single-core under the harness's 3.33 GHz
convention.

Device times come from the JAX profiler's device trace
(utils/profiling.py); a run that finds no device trace fails.
"""

from __future__ import annotations

import time

import numpy as np

# Reference single-core throughput (BASELINE.md "Reference baseline
# provenance"); the higher of the two clock conventions, so ratios are
# conservative
REFERENCE_DECODE_GPIX_S = 2.9
REFERENCE_ENCODE_GPIX_S = 2.8


def make_content(width: int, height: int, frames: int, kind: str = "camera",
                 sigma: float | None = None) -> np.ndarray:
    """Synthesize benchmark frames.

    ``camera``: smooth illumination + shot-like noise → mixed tile depths
    (the format's design target: scientific imaging at fixed rate).
    ``random``: incompressible, all tiles depth 8 (the reference's worst case).
    ``flat``: all tiles depth 0 (payload-free best case).
    ``lowlight``: dim illumination + read-noise-scale noise → depths 2-3
    (the shallow regime).

    ``sigma`` overrides the noise scale of the camera/lowlight families;
    ignored for flat/random.
    """
    if kind not in ("camera", "random", "flat", "lowlight"):
        raise ValueError(f"unknown content kind {kind!r}")
    rng = np.random.default_rng(0)
    if kind == "flat":
        return np.full((frames, height, width), 128, np.uint8)
    if kind == "random":
        return rng.integers(0, 256, size=(frames, height, width)).astype(np.uint8)
    amp, def_sigma = (16.0, 0.8) if kind == "lowlight" else (64.0, 3.0)
    sigma = def_sigma if sigma is None else float(sigma)
    yy, xx = np.mgrid[0:height, 0:width]
    base = (
        96
        + amp * np.sin(2 * np.pi * xx / width)[None] * np.cos(2 * np.pi * yy / height)[None]
        + 8 * np.sin(2 * np.pi * np.arange(frames) / max(frames, 1))[:, None, None]
    )
    noise = rng.normal(0, sigma, size=(frames, height, width))
    return np.clip(base + noise, 0, 255).astype(np.uint8)


def make_adversarial(width: int, height: int, frames: int, maxd: int = 8,
                     seed: int = 0) -> np.ndarray:
    """Frames whose 8x8 tiles each realize an exact target depth <= maxd.

    Depth weights favor the corner cases: depth 0 (flat broadcast path)
    and maxd (a stream that ends on a full-depth tile), with minima drawn
    over the full legal range per depth so add-min and the (depth<<8)|min
    packing (dbde_util.cpp:63,101) see extreme values.  Used by the CPU
    fuzz tests and the parity phase of chip_smoke.py."""
    rng = np.random.default_rng(seed)
    th, tw = -(-height // 8), -(-width // 8)
    weights = np.ones(maxd + 1)
    weights[0] = 3.0
    weights[maxd] = 3.0
    d = rng.choice(np.arange(maxd + 1), size=(frames, th, tw),
                   p=weights / weights.sum()).astype(np.int64)
    span = np.where(d == 0, 0, (1 << d) - 1)  # realized tile range
    lo = rng.integers(0, 256 - span)  # tile min, legal for the range
    res = rng.integers(0, span[..., None, None] + 1,
                       size=(frames, th, tw, 8, 8))
    res[..., 0, 0] = 0          # pin the range exactly: one pixel at min,
    res[..., 7, 7] = span       # one at min+range (edge tiles may crop these)
    tiles = (lo[..., None, None] + res).astype(np.uint8)
    img = tiles.transpose(0, 1, 3, 2, 4).reshape(frames, th * 8, tw * 8)
    return np.ascontiguousarray(img[:, :height, :width])


def make_uniform8(width: int, height: int, frames: int, seed: int = 0
                  ) -> np.ndarray:
    """Frames whose EVERY 8x8 tile (including cropped edge tiles) realizes
    depth exactly 8 — the reference's own depth-8 special case
    (dbde_util.cpp:57-63).  Random bytes with per-tile extremes
    pinned: rows ≡0 (mod 8) carry 0 on cols ≡0 (mod 4), rows ≡1 carry 255
    on cols ≡1 (mod 4), so any tile with ≥2 real rows and ≥2 real cols
    spans [0, 255].  Geometries with H%8==1 or W%8==1 have single-pixel
    edge tiles that cannot reach depth 8 → ValueError.  Used by the CPU
    fuzz tests and the parity phase of chip_smoke.py."""
    if height % 8 == 1 or width % 8 == 1:
        raise ValueError("H%8==1 or W%8==1 leaves single-pixel edge tiles "
                         "that cannot realize depth 8")
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (frames, height, width)).astype(np.uint8)
    img[:, 0::8, 0::4] = 0
    img[:, 1::8, 1::4] = 255
    return img


def measure_codec(images_np: np.ndarray, reps: int = 4):
    """Encode and decode (B, H, W) u8 frames on the device, check the
    decoded pixels against the source, then trace both programs →
    (encode ProgramTime, decode ProgramTime, n64 per frame on the host)."""
    from functools import partial

    import jax

    from .codec import decode_jit, encode_jit
    from .utils.profiling import measure_program

    B, H, W = images_np.shape
    images = jax.device_put(images_np)
    depths, mins, payload, n64 = encode_jit(images)
    out = np.asarray(decode_jit(depths, mins, payload, H=H, W=W))
    np.testing.assert_array_equal(out, images_np)  # never report wrong results
    t_enc = measure_program(encode_jit, images, reps=reps)
    t_dec = measure_program(partial(decode_jit, H=H, W=W), depths, mins,
                            payload, reps=reps)
    return t_enc, t_dec, np.asarray(n64).astype(np.int64)


def run_bench(width: int = 2048, height: int = 2048, frames: int = 8,
              iters: int = 4, content: str = "camera") -> dict:
    """Device time per execution of the encode and decode programs, with
    the decoded pixels checked against the source before reporting."""
    from .format import tile_grid
    from .utils.profiling import device_info

    t_enc, t_dec, n64 = measure_codec(
        make_content(width, height, frames, content), reps=iters)
    h, w = tile_grid(width, height)
    npix = frames * height * width
    encoded_bytes = 12 * frames + 2 * h * w * frames + 8 * int(n64.sum())
    dec_gpix = npix / t_dec.seconds / 1e9
    enc_gpix = npix / t_enc.seconds / 1e9
    return {
        "metric": "decode_gpix_per_s",
        "value": dec_gpix,
        "unit": "Gpix/s",
        "vs_baseline": dec_gpix / REFERENCE_DECODE_GPIX_S,
        "encode_gpix_per_s": enc_gpix,
        "encode_vs_baseline": enc_gpix / REFERENCE_ENCODE_GPIX_S,
        "geometry": f"{frames}x{height}x{width}",
        "content": content,
        "compression_ratio": encoded_bytes / npix,
        "device": device_info(),
    }


def run_stream_bench(width: int = 2048, height: int = 2048, frames: int = 64,
                     batch_size: int = 16, content: str = "camera",
                     path: str | None = None, repeats: int = 2) -> dict:
    """End-to-end sustained streaming benchmark (BASELINE configs[2]/[4]).

    Unlike :func:`run_bench` (device-program time only), this measures wall
    clock around the full pipeline: host record assembly/parse, PCIe
    transfer, device codec, file IO — i.e. what a camera pipeline would see.
    Writes a whole .dbde file with DbdeWriter, then stream-decodes it with
    DbdeReader, verifying pixels.  Wall clock is safe here: every batch is
    distinct data and every result is fully materialized on the host.
    """
    import os
    import tempfile

    from .stream import DbdeReader, DbdeWriter
    from .utils.profiling import device_info

    npix = frames * height * width
    src = make_content(width, height, min(frames, 64), content)
    own = path is None
    if own:
        fd, path = tempfile.mkstemp(suffix=".dbde")
        os.close(fd)
    try:
        t_write = []
        t_read = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            with DbdeWriter(path, height=height, width=width, frame_hz=1000.0) as wr:
                done = 0
                while done < frames:
                    # cycle through the source stack so file frame i always
                    # holds src[i % len(src)] — the read loop's integrity
                    # check depends on this correspondence
                    base = done % src.shape[0]
                    n = min(batch_size, frames - done, src.shape[0] - base)
                    wr.write(src[base : base + n], indices=range(done, done + n))
                    done += n
            t_write.append(time.perf_counter() - t0)

            t0 = time.perf_counter()
            got = 0
            with DbdeReader(path, batch_size=batch_size) as rd:
                for headers, out in rd:
                    # integrity: every batch must match its source frames
                    base = headers[0].index % src.shape[0]
                    n = len(headers)
                    if base + n <= src.shape[0]:
                        np.testing.assert_array_equal(out, src[base : base + n])
                    got += n
            t_read.append(time.perf_counter() - t0)
            assert got == frames, (got, frames)
        enc_bytes = os.path.getsize(path)
        tw, tr = min(t_write), min(t_read)
        return {
            "metric": "stream_decode_gpix_per_s",
            "value": npix / tr / 1e9,
            "unit": "Gpix/s",
            "stream_encode_gpix_per_s": npix / tw / 1e9,
            "frames": frames,
            "geometry": f"{height}x{width}",
            "batch_size": batch_size,
            "content": content,
            "file_bytes": enc_bytes,
            "frame_hz_equiv_decode": frames / tr,
            "frame_hz_equiv_encode": frames / tw,
            "device": device_info(),
            "note": "wall clock end-to-end incl. host parse/assembly and transfer",
        }
    finally:
        if own:
            os.unlink(path)


def run_latency_bench(width: int = 2048, height: int = 2048,
                      content: str = "camera") -> dict:
    """Single-frame (batch=1) codec latency — the reference driver's
    per-frame timing analogue (dbde_util_test.cpp:234-299).  A camera
    pipeline at batch 1 pays whole-grid dispatch per frame; this pins it."""
    from .utils.profiling import device_info

    t_enc, t_dec, _ = measure_codec(make_content(width, height, 1, content),
                                    reps=8)
    npix = height * width
    return {
        "metric": "decode_latency_ms_per_frame",
        "value": t_dec.seconds * 1e3,
        "unit": "ms",
        "encode_latency_ms_per_frame": t_enc.seconds * 1e3,
        "decode_gpix_per_s": npix / t_dec.seconds / 1e9,
        "encode_gpix_per_s": npix / t_enc.seconds / 1e9,
        "geometry": f"1x{height}x{width}",
        "content": content,
        "device": device_info(),
        "note": "batch=1 device-program time (kernel time, no dispatch gaps)",
    }


def run_host_stream_bench(width: int = 2048, height: int = 2048, frames: int = 256,
                          batch_size: int = 16, content: str = "camera",
                          repeats: int = 3) -> dict:
    """Host-only L3 walker benchmark: sustained record scan/parse rate.

    Isolates the streaming layer (the reference walker's role,
    dbde_util.cpp:362-426) from codec and host↔device transfer: the file
    is synthesized by encoding ONE frame with the numpy oracle and
    repeating its data block under per-frame headers, then
    :meth:`DbdeReader.iter_raw` walks it without decoding.  This bounds
    the host-side cost a camera pipeline pays per frame on top of the
    device codec — the number that must exceed the camera rate (1 kHz for
    BASELINE configs[4]) for the device throughput to be reachable
    end-to-end.  No JAX involved.
    """
    import os
    import tempfile

    from . import ref_numpy as ref
    from .format import FrameHeader, VideoHeader
    from .stream import DbdeReader

    img = make_content(width, height, 1, content)[0]
    data = ref.pack_image(img)
    fd, path = tempfile.mkstemp(suffix=".dbde")
    os.close(fd)
    try:
        with open(path, "wb") as f:
            f.write(VideoHeader(height=height, width=width, frame_hz=1000.0).pack())
            for i in range(frames):
                f.write(FrameHeader(index=i).pack())
                f.write(data)
        file_bytes = os.path.getsize(path)
        times = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            got = 0
            with DbdeReader(path, batch_size=batch_size, device=False) as rd:
                for headers, (depths, mins, payload, n64) in rd.iter_raw():
                    got += len(headers)
            times.append(time.perf_counter() - t0)
            assert got == frames, (got, frames)
        t = min(times)
        npix = frames * height * width
        return {
            "metric": "host_walk_gpix_per_s",
            "value": npix / t / 1e9,
            "unit": "Gpix/s",
            "frames": frames,
            "geometry": f"{height}x{width}",
            "batch_size": batch_size,
            "content": content,
            "file_bytes": file_bytes,
            "file_gb_per_s": file_bytes / t / 1e9,
            "frame_hz_equiv": frames / t,
            "note": "host-only record scan/parse (iter_raw), no codec/transfer",
        }
    finally:
        os.unlink(path)
