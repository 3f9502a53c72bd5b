#!/usr/bin/env python
"""Smoke run of the served DBDE path on one GPU, in one process.

    python chip_smoke.py           # one card: every phase below
    python chip_smoke.py --four    # four cards: the sharded path only

Phases, in order; none catches its own failure, so any error exits nonzero
before the last line:

1. device  — fails unless JAX's first device is a GPU (there is no CPU
   fallback); prints the card as ``nvidia-smi`` names it, with its power
   limit.
2. parity  — ``DbdeCodec`` at real widths: 2048² × 16 frames in seven
   content regimes, 1920×1081, 2536×2048, 640×480 at batch 1 and the
   10×10 worked example.  Every frame must round-trip pixel-exact and the
   first frames' bytes must equal ``ref_numpy.pack_frame``.
3. stream  — the served path: raw frames through ``DbdeWriter`` into a
   ``.dbde`` file, the file equal to ``ref_numpy.encode_video``, then
   ``DbdeReader`` back to pixels equal to the source.
4. device time — the encode and decode programs' device time from the
   profiler trace, their five longest kernels, and the least time their
   bytes need at the card's memory bandwidth.

Every comparison has tolerance 0.  The codec is integer-only (no matrix
product, so no TF32 rounding arises); the one scatter-add, whose duplicate
indices become atomics on the GPU, adds integers and so stays exact in any
order.

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

import jax

from dbde_tpu import ref_numpy as ref
from dbde_tpu.bench_core import make_adversarial, make_content, make_uniform8, measure_codec
from dbde_tpu.codec import DbdeCodec, EncodedBatch, decode_jit, encode_jit, pack_frames_bytes
from dbde_tpu.golden_vectors import README_10x10_IMAGE
from dbde_tpu.utils.compile_cache import enable_compile_cache
from dbde_tpu.utils.profiling import device_info, hbm_bound_seconds


class SmokeError(RuntimeError):
    """A phase found a wrong result or the wrong platform."""


def log(*parts) -> None:
    print(*parts, flush=True)


class CompileCounter:
    """Counts XLA programs built (compiled, or loaded from the persistent
    cache) while ``active``."""

    EVENTS = ("/jax/core/compile/backend_compile_duration",
              "/jax/compilation_cache/cache_retrieval_time_sec")

    def __init__(self):
        self.count = 0
        self.active = False
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, name, _secs, **_kw) -> None:
        if self.active and name in self.EVENTS:
            self.count += 1


# -- phase 1 -----------------------------------------------------------------


def nvidia_smi() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        raise SmokeError("nvidia-smi not found")
    out = subprocess.run(
        [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def phase_device(min_count: int = 1) -> dict:
    """Fail unless JAX runs on at least ``min_count`` GPUs → device info."""
    info = device_info()
    if info["platform"] != "gpu":
        raise SmokeError(f"JAX's first device is {info['platform']!r}, not a GPU")
    if info["count"] < min_count:
        raise SmokeError(f"{info['count']} GPU(s) visible, {min_count} needed")
    from dbde_tpu.native import binding

    log(f"[device] kind={info['kind']} count={info['count']} jax={jax.__version__}")
    log(f"[device] host record library: "
        f"{'native' if binding.native_available() else 'numpy fallback'}")
    log(f"[device] nvidia-smi: {nvidia_smi()}")
    return info


# -- phase 2 -----------------------------------------------------------------


def real_parity_cases():
    """(label, frames) at the deployments' real widths; built lazily."""
    S, B = 2048, 16
    yield "camera 2048x2048 B16", make_content(S, S, B, "camera")
    yield "lowlight 2048x2048 B16", make_content(S, S, B, "lowlight")
    yield "random 2048x2048 B16", make_content(S, S, B, "random")
    yield "flat 2048x2048 B16", make_content(S, S, B, "flat")
    yield "adversarial maxd3 2048x2048 B16", make_adversarial(S, S, B, maxd=3, seed=3)
    yield "adversarial maxd8 2048x2048 B16", make_adversarial(S, S, B, maxd=8, seed=8)
    yield "uniform8 2048x2048 B16", make_uniform8(S, S, B, seed=1)
    yield "camera 1920x1081 B16", make_content(1920, 1081, B, "camera")
    yield "random 2536x2048 B16", make_content(2536, 2048, B, "random")
    yield "camera 640x480 B1", make_content(640, 480, 1, "camera")
    yield "golden 10x10 B1", README_10x10_IMAGE[None]


def check_case(label: str, frames: np.ndarray, oracle_frames: int = 2) -> dict:
    """Encode and decode ``frames`` through DbdeCodec; every frame must
    round-trip and the first ``oracle_frames`` must match the oracle's
    bytes exactly."""
    B, H, W = frames.shape
    codec = DbdeCodec(height=H, width=W)
    enc = codec.encode(frames)
    out = codec.decode(enc.depths, enc.mins, enc.payload)
    # exact comparison: the codec is integer-only, so no tolerance applies
    bad = int(np.count_nonzero(np.any(out != frames, axis=(1, 2))))
    if bad:
        raise SmokeError(f"{label}: {bad} of {B} frames differ after the round trip")
    n = min(oracle_frames, B)
    recs = pack_frames_bytes(
        EncodedBatch(enc.depths[:n], enc.mins[:n], enc.payload[:n], enc.n64[:n]))
    for i in range(n):
        if recs[i] != ref.pack_frame(i, frames[i]):
            raise SmokeError(f"{label}: frame {i} bytes differ from ref_numpy")
    n64 = np.asarray(enc.n64).astype(np.int64)
    log(f"[parity] {label}: {B}/{B} frames pixel-exact, {n}/{n} frames "
        f"byte-exact vs ref_numpy, payload {int(n64.sum()) * 8} B")
    return {"label": label, "frames": B, "oracle_frames": n}


def compile_report(H: int, W: int, B: int) -> dict:
    """Compile the encode and decode programs at (B, H, W) explicitly and
    print their compile seconds and memory analysis."""
    x = jax.ShapeDtypeStruct((B, H, W), np.uint8)
    t0 = time.perf_counter()
    enc = encode_jit.lower(x).compile()
    t_enc = time.perf_counter() - t0
    d, m, p, _ = jax.eval_shape(encode_jit, x)
    t0 = time.perf_counter()
    dec = decode_jit.lower(d, m, p, H=H, W=W).compile()
    t_dec = time.perf_counter() - t0
    log(f"[parity] compile {B}x{H}x{W}: encode {t_enc} s, decode {t_dec} s")
    log(f"[parity] encode memory_analysis: {enc.memory_analysis()}")
    log(f"[parity] decode memory_analysis: {dec.memory_analysis()}")
    return {"encode_compile_s": t_enc, "decode_compile_s": t_dec}


def phase_parity(cases, compile_shape=None) -> list:
    """Check every (label, frames) case; ``compile_shape`` (B, H, W) first
    reports the compile of that shape's programs."""
    if compile_shape is not None:
        compile_report(*compile_shape[1:], compile_shape[0])
    results = [check_case(label, frames) for label, frames in cases]
    stats = jax.devices()[0].memory_stats() or {}
    log(f"[parity] peak_bytes_in_use: {stats.get('peak_bytes_in_use', 'not reported')}")
    return results


# -- phase 3 -----------------------------------------------------------------


def phase_stream(H: int = 2048, W: int = 2048, n_frames: int = 64,
                 batch: int = 16) -> dict:
    """Raw frames → DbdeWriter → file (== oracle bytes) → DbdeReader →
    pixels (== source).  Wall time each direction, compilations counted
    inside both windows."""
    from dbde_tpu.stream import DbdeReader, DbdeWriter

    frames = make_content(W, H, n_frames, "camera")
    counter = CompileCounter()
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "stream.dbde")
        counter.count, counter.active = 0, True
        t0 = time.perf_counter()
        with DbdeWriter(path, height=H, width=W, frame_hz=1000.0, pipeline=2) as wr:
            for i in range(0, n_frames, batch):
                wr.write(frames[i : i + batch])
        t_write = time.perf_counter() - t0
        write_compiles, counter.active = counter.count, False
        with open(path, "rb") as f:
            data = f.read()
        if data != ref.encode_video(list(frames), frame_hz=1000.0):
            raise SmokeError("the writer's file differs from ref_numpy.encode_video")

        counter.count, counter.active = 0, True
        got = 0
        t0 = time.perf_counter()
        with DbdeReader(path, batch_size=batch, pipeline=2) as rd:
            for headers, out in rd:
                idx = [h.index for h in headers]
                if idx != list(range(got, got + len(idx))):
                    raise SmokeError(f"reader returned frame indices {idx}")
                if not np.array_equal(out, frames[got : got + len(idx)]):
                    raise SmokeError(f"reader pixels differ in frames {idx}")
                got += len(idx)
        t_read = time.perf_counter() - t0
        read_compiles, counter.active = counter.count, False
    if got != n_frames:
        raise SmokeError(f"reader returned {got} of {n_frames} frames")
    npix = n_frames * H * W
    log(f"[stream] {n_frames}x{H}x{W} camera, batch {batch}, pipeline 2: "
        f"file {len(data)} B == ref_numpy.encode_video, {got} frames pixel-exact")
    log(f"[stream] write wall {t_write} s ({npix / t_write / 1e9} Gpix/s), "
        f"{write_compiles} programs built inside the window")
    log(f"[stream] read wall {t_read} s ({npix / t_read / 1e9} Gpix/s), "
        f"{read_compiles} programs built inside the window")
    return {"write_s": t_write, "read_s": t_read, "file_bytes": len(data),
            "write_compiles": write_compiles, "read_compiles": read_compiles}


# -- phase 4 -----------------------------------------------------------------


def codec_bytes(frames: int, H: int, W: int, payload_bytes: int) -> int:
    """Bytes one direction of the codec must move at least: the raw frames
    on one side; payload, depths and minima on the other."""
    from dbde_tpu.format import tile_grid

    h, w = tile_grid(W, H)
    return frames * H * W + payload_bytes + 2 * frames * h * w


def phase_device_time(H: int = 2048, W: int = 2048, B: int = 16,
                      reps: int = 5) -> dict:
    """Device time per execution of the encode and decode programs."""
    t_enc, t_dec, n64 = measure_codec(make_content(W, H, B, "camera"), reps=reps)
    nbytes = codec_bytes(B, H, W, 8 * int(n64.sum()))
    bound = hbm_bound_seconds(nbytes, device_info()["kind"])
    res = {}
    for name, t in (("encode", t_enc), ("decode", t_dec)):
        log(f"[time] {name} {B}x{H}x{W} camera: {t.seconds * 1e3} ms device time "
            f"per execution ({B * H * W / t.seconds / 1e9} Gpix/s), "
            f"{len(t.kernels)} distinct kernels")
        for k, s in t.kernels[:5]:
            log(f"[time]    {name} kernel {k}: {s * 1e3} ms")
        log(f"[time] {name} moves >= {nbytes} B: {bound * 1e3} ms at the memory "
            f"bound, {bound / t.seconds} of it reached")
        res[name] = {"seconds": t.seconds, "kernels": t.kernels[:5],
                     "bound_seconds": bound}
    return res


# -- four cards ----------------------------------------------------------------


def phase_four(H: int = 2048, W: int = 2048, per_shard: int = 16,
               file_frames: int = 37) -> None:
    """The sharded path on a (4 x 1) and a (2 x 2) mesh: the fused step
    pixel-exact, the sharded writer's file equal to the oracle's, and the
    sharded walker pixel-exact."""
    from dbde_tpu.parallel import (iter_video_sharded, make_mesh,
                                   sharded_roundtrip_step, write_video_sharded)

    devices = jax.devices()[:4]
    file_src = make_content(W, H, file_frames, "camera")
    oracle = ref.encode_video(list(file_src), frame_hz=1000.0)
    for n_data, n_tiles in ((4, 1), (2, 2)):
        mesh = make_mesh(n_data=n_data, n_tiles=n_tiles, devices=devices)
        frames = make_content(W, H, n_data * per_shard, "camera")
        out, n64 = sharded_roundtrip_step(frames, mesh)
        if not np.array_equal(out, frames):
            raise SmokeError(f"mesh {n_data}x{n_tiles}: step pixels differ")
        log(f"[four] mesh {n_data}x{n_tiles}: sharded_roundtrip_step on "
            f"{frames.shape} pixel-exact, n64={int(n64)}")
        with tempfile.TemporaryDirectory() as td:
            path = os.path.join(td, "sharded.dbde")
            write_video_sharded(path, file_src, mesh, frame_hz=1000.0,
                                batch_size=per_shard * n_data)
            with open(path, "rb") as f:
                if f.read() != oracle:
                    raise SmokeError(f"mesh {n_data}x{n_tiles}: sharded file "
                                     "differs from ref_numpy.encode_video")
            got = np.concatenate([c for _, c in iter_video_sharded(
                path, mesh, batch_size=per_shard * n_data)])
            if not np.array_equal(got, file_src):
                raise SmokeError(f"mesh {n_data}x{n_tiles}: sharded walker "
                                 "pixels differ")
        log(f"[four] mesh {n_data}x{n_tiles}: write_video_sharded == "
            f"ref_numpy.encode_video ({len(oracle)} B, {file_frames} frames), "
            "iter_video_sharded pixel-exact")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--four", action="store_true",
                   help="run only the sharded path, on four GPUs")
    args = p.parse_args(argv)
    enable_compile_cache()
    if args.four:
        info = phase_device(min_count=4)
        phase_four()
    else:
        info = phase_device()
        phase_parity(real_parity_cases(), compile_shape=(16, 2048, 2048))
        phase_stream()
        phase_device_time()
    print(json.dumps({"ok": True, "device": info}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
