"""Command-line interface: encode/decode/inspect/preview DBDE videos.

Runtime replacement for the reference's compile-time ``#ifdef`` test-driver
flags (``DBDE_WRITE_MINIMAL``, ``DBDE_READ_FILE_TEST``, ``DBDE_WRITE_A_FRAME``
— dbde_util_test.cpp:204-211,368-398): everything is a subcommand.

  python -m dbde_tpu.cli info    video.dbde
  python -m dbde_tpu.cli encode  frames.raw --width 640 --height 480 -o out.dbde
  python -m dbde_tpu.cli decode  video.dbde -o frames.raw [--pgm-dir d/]
  python -m dbde_tpu.cli preview video.dbde [--frame N]
  python -m dbde_tpu.cli roundtrip video.dbde   # integrity check
  python -m dbde_tpu.cli bench   [--width W --height H --frames N]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from .format import FRAME_HEADER_BYTES, VIDEO_HEADER_BYTES, unpack_video_header
from .stream import DbdeReader, DbdeWriter, read_video, write_video
from .utils.compile_cache import enable_compile_cache
from .utils.visualize import ascii_preview, write_pgm


def _cmd_info(args) -> int:
    with open(args.file, "rb") as f:
        head = f.read(VIDEO_HEADER_BYTES)
        size = os.fstat(f.fileno()).st_size
    vh, _ = unpack_video_header(head)
    if not vh.ok:
        print("not a DBDE file (bad video header)", file=sys.stderr)
        return 1
    print(f"geometry:  {vh.width} x {vh.height}")
    print(f"frame_hz:  {vh.frame_hz}")
    print(f"file size: {size} bytes")
    if args.scan:
        with DbdeReader(args.file, device=False) as r:
            n = 0
            first = last = None
            for headers, _ in r:
                for fh in headers:
                    if first is None:
                        first = fh
                    last = fh
                    n += 1
            print(f"frames:    {n}")
            if first is not None:
                print(f"indices:   {first.index} .. {last.index}")
                npix = n * vh.width * vh.height
                print(f"ratio:     {size / npix:.4f} bytes/pixel")
    return 0


def _cmd_encode(args) -> int:
    W, H = args.width, args.height
    raw = np.fromfile(args.input, dtype=np.uint8)
    if raw.size % (W * H) != 0:
        print(f"input size {raw.size} not a multiple of {W}x{H}", file=sys.stderr)
        return 1
    frames = raw.reshape(-1, H, W)
    t0 = time.perf_counter()
    write_video(args.output, frames, frame_hz=args.hz, device=not args.no_device,
                batch_size=args.batch)
    dt = time.perf_counter() - t0
    out_size = os.path.getsize(args.output)
    print(f"encoded {frames.shape[0]} frames ({raw.size} px) in {dt:.3f}s "
          f"({raw.size / dt / 1e9:.2f} Gpix/s end-to-end), "
          f"{out_size} bytes (ratio {out_size / raw.size:.3f})")
    return 0


def _cmd_decode(args) -> int:
    t0 = time.perf_counter()
    vh, headers, frames = read_video(args.file, device=not args.no_device, batch_size=args.batch)
    dt = time.perf_counter() - t0
    npix = frames.size
    if args.output:
        frames.tofile(args.output)
    if args.pgm_dir:
        os.makedirs(args.pgm_dir, exist_ok=True)
        for fh, img in zip(headers, frames):
            write_pgm(os.path.join(args.pgm_dir, f"frame_{fh.index:06d}.pgm"), img)
    print(f"decoded {len(headers)} frames ({npix} px) in {dt:.3f}s "
          f"({npix / dt / 1e9:.2f} Gpix/s end-to-end)")
    return 0


def _cmd_preview(args) -> int:
    with DbdeReader(args.file, batch_size=max(1, args.frame + 1), device=False) as r:
        seen = 0
        for headers, frames in r:
            for fh, img in zip(headers, frames):
                if seen == args.frame:
                    print(f"frame {fh.index} ({r.width}x{r.height}):")
                    print(ascii_preview(img, size=args.size))
                    return 0
                seen += 1
    print(f"frame {args.frame} not found ({seen} frames in file)", file=sys.stderr)
    return 1


def _cmd_roundtrip(args) -> int:
    """Decode + re-encode the file; verify bit-exact equality."""
    vh, headers, frames = read_video(args.file, device=not args.no_device)
    import io

    buf = io.BytesIO()
    with DbdeWriter(buf, height=vh.height, width=vh.width, frame_hz=vh.frame_hz,
                    device=not args.no_device) as wr:
        wr.write(frames, indices=[h.index for h in headers],
                 elapsed_ns=[h.elapsed_ns for h in headers])
    ours = buf.getvalue()
    theirs = open(args.file, "rb").read()
    if ours == theirs:
        print(f"OK: {len(headers)} frames, {len(ours)} bytes, bit-exact re-encode")
        return 0
    print(f"MISMATCH: re-encode differs ({len(ours)} vs {len(theirs)} bytes)", file=sys.stderr)
    return 1


def _cmd_golden(args) -> int:
    """Write the format-conformance golden file (the reference's
    DBDE_WRITE_MINIMAL / DBDE_MULTIPLE_MINIMAL_FRAMES fixture generator,
    dbde_util_test.cpp:204-211, as a runtime command)."""
    from .golden_vectors import GOLDEN_8x16_FILE

    data = GOLDEN_8x16_FILE
    if args.frames > 1:
        data = data + GOLDEN_8x16_FILE[28:] * (args.frames - 1)
    with open(args.output, "wb") as f:
        f.write(data)
    print(f"wrote {len(data)} bytes ({args.frames} frame(s)) to {args.output}")
    return 0


def _cmd_bench(args) -> int:
    if args.latency:
        from .bench_core import run_latency_bench

        result = run_latency_bench(width=args.width, height=args.height,
                                   content=args.content)
    elif args.host_stream:
        from .bench_core import run_host_stream_bench

        result = run_host_stream_bench(width=args.width, height=args.height,
                                       frames=args.frames, batch_size=args.batch,
                                       content=args.content, repeats=args.repeats)
    elif args.stream:
        from .bench_core import run_stream_bench

        result = run_stream_bench(width=args.width, height=args.height,
                                  frames=args.frames, batch_size=args.batch,
                                  content=args.content, repeats=args.repeats)
    else:
        from .bench_core import run_bench

        result = run_bench(width=args.width, height=args.height, frames=args.frames,
                           iters=args.iters, content=args.content)
    print(json.dumps(result))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="dbde_tpu", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("info", help="print video header / stats")
    s.add_argument("file")
    s.add_argument("--scan", action="store_true", help="walk all frames for counts")
    s.set_defaults(fn=_cmd_info)

    s = sub.add_parser("encode", help="raw u8 frames -> .dbde")
    s.add_argument("input", help="raw u8 file, N*H*W bytes")
    s.add_argument("-o", "--output", required=True)
    s.add_argument("--width", type=int, required=True)
    s.add_argument("--height", type=int, required=True)
    s.add_argument("--hz", type=float, default=1.0)
    s.add_argument("--batch", type=int, default=16)
    s.add_argument("--no-device", action="store_true", help="host-only (numpy oracle)")
    s.set_defaults(fn=_cmd_encode)

    s = sub.add_parser("decode", help=".dbde -> raw u8 frames / PGMs")
    s.add_argument("file")
    s.add_argument("-o", "--output")
    s.add_argument("--pgm-dir")
    s.add_argument("--batch", type=int, default=16)
    s.add_argument("--no-device", action="store_true")
    s.set_defaults(fn=_cmd_decode)

    s = sub.add_parser("preview", help="ASCII-art preview of one frame")
    s.add_argument("file")
    s.add_argument("--frame", type=int, default=0)
    s.add_argument("--size", type=int, default=32)
    s.set_defaults(fn=_cmd_preview)

    s = sub.add_parser("roundtrip", help="verify decode+re-encode is bit-exact")
    s.add_argument("file")
    s.add_argument("--no-device", action="store_true")
    s.set_defaults(fn=_cmd_roundtrip)

    s = sub.add_parser("golden", help="write the 8x16 conformance fixture file")
    s.add_argument("-o", "--output", default="minimal.dbde")
    s.add_argument("--frames", type=int, default=1, help="repeat the frame N times")
    s.set_defaults(fn=_cmd_golden)

    s = sub.add_parser("bench", help="device codec throughput benchmark")
    s.add_argument("--width", type=int, default=2048)
    s.add_argument("--height", type=int, default=2048)
    s.add_argument("--frames", type=int, default=8)
    s.add_argument("--iters", type=int, default=20)
    s.add_argument("--content", default="camera",
                   choices=["camera", "lowlight", "random", "flat"])
    s.add_argument("--stream", action="store_true",
                   help="end-to-end wall-clock file streaming benchmark (write+read a whole .dbde)")
    s.add_argument("--host-stream", action="store_true",
                   help="host-only walker benchmark: record scan/parse rate, no codec/transfer")
    s.add_argument("--latency", action="store_true",
                   help="single-frame (batch=1) codec latency")
    s.add_argument("--batch", type=int, default=16)
    s.add_argument("--repeats", type=int, default=2,
                   help="--stream/--host-stream repetitions (best-of is reported)")
    s.set_defaults(fn=_cmd_bench)

    args = p.parse_args(argv)
    enable_compile_cache()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
