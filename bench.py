#!/usr/bin/env python
"""Device codec throughput, three configs, as ONE JSON line.

Top-level fields are the flagship config (camera 2048x2048 decode Gpix/s,
BASELINE.json's north-star geometry); ``configs`` carries the other two:

  * ``random_2048``  — incompressible, all tiles depth 8 (the reference's
    own depth-8 special case, dbde_util.cpp:57-63).
  * ``random_2536x2048`` — the reference test driver's own default bench
    geometry (dbde_util_test.cpp:303-349), ragged width.

Times are device time per execution from the profiler trace; vs_baseline is
relative to the reference C library's single-core numbers (BASELINE.md).
Every config checks decoded pixels against its source before reporting, and
any failure fails the run.  Run from the repository root:
``python bench.py``.
"""

import json

from dbde_tpu.bench_core import run_bench
from dbde_tpu.utils.compile_cache import enable_compile_cache


def _sub(r: dict) -> dict:
    """Compact per-config record for the nested ``configs`` object."""
    return {
        "decode_gpix_per_s": r["value"],
        "decode_vs_baseline": r["vs_baseline"],
        "encode_gpix_per_s": r["encode_gpix_per_s"],
        "encode_vs_baseline": r["encode_vs_baseline"],
        "geometry": r["geometry"],
        "content": r["content"],
        "compression_ratio": r["compression_ratio"],
    }


if __name__ == "__main__":
    enable_compile_cache()
    out = run_bench(width=2048, height=2048, frames=8, iters=20, content="camera")
    configs = {"camera_2048": _sub(out)}
    configs["random_2048"] = _sub(run_bench(width=2048, height=2048, frames=8,
                                            iters=12, content="random"))
    configs["random_2536x2048"] = _sub(run_bench(width=2536, height=2048,
                                                 frames=8, iters=12,
                                                 content="random"))
    out["configs"] = configs
    print(json.dumps(out))
