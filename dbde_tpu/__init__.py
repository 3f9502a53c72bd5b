"""dbde_tpu — a JAX/XLA framework for DBDE video.

Layers (mirroring SURVEY.md's map of the reference library):
  * :mod:`dbde_tpu.format`    — host byte-level container serde (L2)
  * :mod:`dbde_tpu.ref_numpy` — pure-numpy oracle codec (differential oracle)
  * :mod:`dbde_tpu.ops`       — XLA tile ops of the device codec (L0/L1)
  * :mod:`dbde_tpu.codec`     — jitted public encode/decode API (L1/L2)
  * :mod:`dbde_tpu.stream`    — streaming file reader/writer (L3)
  * :mod:`dbde_tpu.parallel`  — multi-device sharding (mesh/shard_map)
  * :mod:`dbde_tpu.utils`     — visualization, config, profiling
"""

from .format import (
    FRAME_HEADER_BYTES,
    VIDEO_HEADER_BYTES,
    FrameHeader,
    VideoHeader,
    unpack_frame_header,
    unpack_video_header,
)

__version__ = "0.1.0"

_LAZY = {
    "DbdeCodec": ("dbde_tpu.codec", "DbdeCodec"),
    "EncodedBatch": ("dbde_tpu.codec", "EncodedBatch"),
    "DbdeReader": ("dbde_tpu.stream", "DbdeReader"),
    "DbdeWriter": ("dbde_tpu.stream", "DbdeWriter"),
    "read_video": ("dbde_tpu.stream", "read_video"),
    "write_video": ("dbde_tpu.stream", "write_video"),
}


def __getattr__(name):
    """Lazy re-exports: keep `import dbde_tpu` JAX-free for host-only use."""
    if name in _LAZY:
        import importlib

        mod, attr = _LAZY[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError(f"module 'dbde_tpu' has no attribute {name!r}")
