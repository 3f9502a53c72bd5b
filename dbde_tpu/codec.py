"""Public device codec API: batched DBDE encode/decode under ``jax.jit``.

Mirrors the reference's L1/L2 surface (dbde_util.h:21-37) in array-in/
array-out style:

  * :class:`DbdeCodec` — per-(H, W) compiled encode/decode over frame batches;
  * :func:`pack_frames_bytes` / :func:`unpack_frames_bytes` — host glue
    between device arrays and the on-disk frame-data byte layout.

Design: shapes are static per (H, W, batch) so XLA compiles once per camera
geometry (the DBDE use case is fixed-rate cameras — one geometry per file).
The payload lives in a worst-case (16 words/tile) buffer on device; the true
length ``2*n64`` travels alongside and the host slices when serializing.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from .format import FrameHeader, tile_grid, packed_image_size
from .ops.bitpack import MAX_WORDS_PER_TILE, pack_tiles_to_words, unpack_words_to_tiles
from .ops.payload import compact_payload, gather_windows, word_offsets
from .ops.tiling import pad_and_tile, untile


@dataclass
class EncodedBatch:
    """Device-side encoded frames: one row per frame in the batch."""

    depths: jax.Array  # (B, T) u8
    mins: jax.Array  # (B, T) u8
    # (B, 16*T) u32, worst-case sized: only the first 2*n64 words per frame
    # are meaningful; use payload_host() for the live prefix on the host
    payload: jax.Array
    n64: jax.Array  # (B,) i32 — number of payload u64 words per frame

    def payload_host(self, max_words: int | None = None) -> np.ndarray:
        """Payload as a (B, S) u32 host array, S >= ``max_words`` when
        given.  Slices the live prefix on the device first so only
        ``max_words`` words per frame cross to the host."""
        p = self.payload
        if max_words is not None and max_words < p.shape[1]:
            p = p[:, :max_words]
        return np.asarray(p)


def encode_frames(images: jnp.ndarray):
    """(B, H, W) u8 → (depths (B, T) u8, mins (B, T) u8, payload (B, 16*T)
    u32, n64 (B,) i32): tile, pack every tile at once, then compact the
    dense windows to the flat stream at prefix-summed offsets."""
    tiles = pad_and_tile(images)
    depth, mn, words = pack_tiles_to_words(tiles)
    offsets, total = word_offsets(depth)
    payload = compact_payload(words, offsets, total)
    return depth.astype(jnp.uint8), mn, payload, (total // 2).astype(jnp.int32)


def decode_frames(depths: jnp.ndarray, mins: jnp.ndarray, payload: jnp.ndarray,
                  H: int, W: int) -> jnp.ndarray:
    """Inverse of :func:`encode_frames` → (B, H, W) u8.  ``payload`` may be
    any width ≥ each frame's live 2*n64 words."""
    offsets, _ = word_offsets(depths.astype(jnp.int32))
    windows = gather_windows(payload, offsets)
    tiles = unpack_words_to_tiles(depths.astype(jnp.int32), mins, windows)
    return untile(tiles, H, W)


def roundtrip_frames(images: jnp.ndarray):
    """Fused encode→decode of a (B, H, W) u8 stack → (frames, n64)."""
    B, H, W = images.shape
    depths, mins, payload, n64 = encode_frames(images)
    return decode_frames(depths, mins, payload, H, W), n64


# One compiled program per input shape, shared by every codec instance.
encode_jit = jax.jit(encode_frames)
decode_jit = jax.jit(decode_frames, static_argnames=("H", "W"))
roundtrip_jit = jax.jit(roundtrip_frames)


class DbdeCodec:
    """DBDE codec for a fixed frame geometry, compiled once per batch shape.

    >>> codec = DbdeCodec(height=480, width=640)
    >>> enc = codec.encode(frames_u8)          # (B, H, W) u8
    >>> out = codec.decode(enc.depths, enc.mins, enc.payload)

    Stateless after construction: safe to share between threads.
    """

    def __init__(self, height: int, width: int):
        self.height = int(height)
        self.width = int(width)
        h, w = tile_grid(self.width, self.height)
        self.tiles = h * w

    def _check(self, images) -> tuple[jnp.ndarray, bool]:
        images = jnp.asarray(images, dtype=jnp.uint8)
        single = images.ndim == 2
        if single:
            images = images[None]
        if images.shape[-2:] != (self.height, self.width):
            raise ValueError(
                f"expected frames of shape (*, {self.height}, {self.width}), got {images.shape}"
            )
        return images, single

    def encode(self, images) -> EncodedBatch:
        """(B, H, W) or (H, W) u8 frames → :class:`EncodedBatch` (async)."""
        images, _ = self._check(images)
        depths, mins, payload, n64 = encode_jit(images)
        return EncodedBatch(depths=depths, mins=mins, payload=payload, n64=n64)

    def decode_dispatch(self, depths, mins, payload):
        """Launch the device decode without blocking; returns a pending handle
        for :meth:`materialize` (the async half of :meth:`decode` — lets a
        streaming pipeline overlap host parsing with device compute)."""
        return decode_jit(
            jnp.asarray(depths, jnp.uint8),
            jnp.asarray(mins, jnp.uint8),
            jnp.asarray(payload, jnp.uint32),
            H=self.height, W=self.width,
        )

    def materialize(self, pending) -> np.ndarray:
        """Pending decode handle → (B, H, W) u8 numpy (blocks on the device)."""
        return np.asarray(pending)

    def decode(self, depths, mins, payload) -> np.ndarray:
        """Encoded arrays → (B, H, W) u8 numpy frames."""
        return self.materialize(self.decode_dispatch(depths, mins, payload))

    def roundtrip(self, images):
        """Fused encode→decode (single compiled program); returns (frames, n64)."""
        images, single = self._check(images)
        out, n64 = roundtrip_jit(images)
        return (out[0], n64[0]) if single else (out, n64)


# ---------------------------------------------------------------------------
# Host byte glue: device arrays ↔ on-disk frame-data layout
# ---------------------------------------------------------------------------


RECORD_IOVECS_PER_FRAME = 7


def record_iovecs(depths, mins, payload, n64, indices=None, elapsed_ns=None) -> list:
    """Per-frame record buffers for vectored IO — 7 per frame: 20 B header,
    ``i32 h·w``, depths row, ``i32 h·w``, minima row, ``i32 n64``, payload
    prefix (layout parity with dbde_util.cpp:137-196, little-endian).

    The array rows are zero-copy views into the caller's host arrays; they
    must stay unmodified until the write consumes them.  Feeding these to
    ``os.writev`` makes the kernel's copy-to-page-cache the *only* pass over
    the record bytes, with no contiguous assembly buffer first.
    """
    depths = np.ascontiguousarray(depths, np.uint8)
    mins = np.ascontiguousarray(mins, np.uint8)
    payload = np.ascontiguousarray(payload, np.uint32)
    n64 = np.asarray(n64)
    B, T = depths.shape
    count = struct.pack("<i", T)
    iov = []
    for b in range(B):
        idx = int(indices[b]) if indices is not None else b
        ns = int(elapsed_ns[b]) if elapsed_ns is not None else 0
        n = int(n64[b])
        iov += [
            FrameHeader(index=idx, elapsed_ns=ns).pack(),
            count,
            depths[b].data,
            count,
            mins[b].data,
            struct.pack("<i", n),
            payload[b, : 2 * n].data,
        ]
    return iov


def pack_frames_bytes(enc: EncodedBatch, indices=None, elapsed_ns=None) -> list[bytes]:
    """EncodedBatch → list of per-frame bytes (20 B header + frame data).

    Layout parity with dbde_util.cpp:137-196: ``i32 h·w``, depths, ``i32
    h·w``, minima, ``i32 n64``, payload u64s (little-endian).
    """
    n64 = np.asarray(enc.n64)
    # transfer only the live payload prefix (the buffer is worst-case sized)
    mx = 2 * int(n64.max()) if len(n64) else 0
    iov = record_iovecs(np.asarray(enc.depths), np.asarray(enc.mins),
                        enc.payload_host(mx), n64, indices, elapsed_ns)
    k = RECORD_IOVECS_PER_FRAME
    return [b"".join(iov[k * b : k * (b + 1)]) for b in range(len(n64))]


def unpack_frames_bytes(buf: bytes, W: int, H: int, offsets: list[int],
                        stride_words: int | None = None):
    """Parse frame-data records at byte ``offsets`` → stacked numpy arrays.

    Returns (depths (B,T) u8, mins (B,T) u8, payload (B,S) u32, n64 (B,)),
    ready for :meth:`DbdeCodec.decode` (S defaults to the worst case 16*T).
    Raises ValueError on count-field mismatches (the reference's hard-error
    parity, dbde_util.cpp:295-303).
    """
    h, w = tile_grid(W, H)
    T = h * w
    B = len(offsets)
    S = stride_words if stride_words is not None else T * MAX_WORDS_PER_TILE
    depths = np.empty((B, T), np.uint8)
    mins = np.empty((B, T), np.uint8)
    payload = np.zeros((B, S), np.uint32)
    n64s = np.empty((B,), np.int32)
    for b, off in enumerate(offsets):
        (nb,) = struct.unpack_from("<i", buf, off)
        if nb != T:
            raise ValueError(f"frame {b}: depth count {nb} != {T}")
        depths[b] = np.frombuffer(buf, np.uint8, T, off + 4)
        (nm,) = struct.unpack_from("<i", buf, off + 4 + T)
        if nm != T:
            raise ValueError(f"frame {b}: min count {nm} != {T}")
        mins[b] = np.frombuffer(buf, np.uint8, T, off + 8 + T)
        (n64,) = struct.unpack_from("<i", buf, off + 8 + 2 * T)
        if n64 != int(depths[b].astype(np.int64).sum()):
            raise ValueError(f"frame {b}: n64 {n64} != sum of depths")
        payload[b, : 2 * n64] = np.frombuffer(buf, np.uint32, 2 * n64, off + 12 + 2 * T)
        n64s[b] = n64
    return depths, mins, payload, n64s


def frame_data_size(depths_row: np.ndarray, W: int, H: int) -> int:
    """Encoded byte size of one frame's data block."""
    return packed_image_size(W, H, int(depths_row.astype(np.int64).sum()))
