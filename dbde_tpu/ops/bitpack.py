"""Vectorized variable-bit-depth pack/unpack over u32 lanes.

Data-parallel replacement for the reference's per-tile SIMD/scalar bit loops
(encode: dbde_util.cpp:66-100; decode: dbde_util.cpp:229-244).  The reference
serializes 4k-bit groups through a scalar u64 accumulator; here every tile
packs at once in u32 lanes, using the closed form:

  pixel ``i`` of a depth-``k`` tile occupies bits ``[i*k, i*k + k)`` of the
  tile's payload; u32 word ``j = (i*k) >> 5``, bit offset ``(i*k) & 31``,
  possibly straddling into word ``j+1`` (only for k ∈ {3,5,6,7}).

For each *static* k ∈ 1..8 these index/shift values are compile-time
constants, so packing 2k words is a flat OR of statically-shifted pixel lanes
and unpacking 64 pixels is a flat funnel-shift — elementwise code, vectorized
across all tiles of all frames at once.  The 9 static variants are evaluated
and combined with a per-tile depth select; XLA fuses the whole select chain
into one elementwise pass, and per-u32 cost is a handful of shift/or ops.

The dense layout is (..., T, 16) u32: each tile's payload left-justified in a
16-word (= depth-8) slot.  Ragged↔dense conversion lives in payload.py.
"""

from __future__ import annotations

import jax.numpy as jnp

MAX_WORDS_PER_TILE = 16  # depth 8 → 64 pixels * 8 bits / 32 = 16 u32 words


def tile_depths_mins(tiles: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(..., T, 64) u8 tiles → per-tile (depth i32 in [0,8], min u8).

    Depth rule parity (dbde_util.cpp:48,57,66-68): 0 iff flat, 8 iff
    range ≥ 128, else bit_length(max - min).
    """
    mn = tiles.min(axis=-1)
    mx = tiles.max(axis=-1)
    rng = mx.astype(jnp.int32) - mn.astype(jnp.int32)
    depth = sum((rng > (1 << i) - 1).astype(jnp.int32) for i in range(8))
    return depth, mn


def _pack_words_static(res: jnp.ndarray, k: int) -> jnp.ndarray:
    """res (..., 64) u32 → (..., 16) u32 packed at static depth k.

    Word j collects every pixel i whose bit range [i*k, i*k+k) overlaps
    [32j, 32j+32); contributions are non-overlapping so OR == ADD.
    u32 left-shift wraparound performs the straddle truncation for free.
    """
    words = []
    for j in range(2 * k):
        acc = None
        for i in range(64):
            rel = i * k - 32 * j
            if rel <= -k or rel >= 32:
                continue
            pix = res[..., i]
            contrib = (pix << rel) if rel >= 0 else (pix >> (-rel))
            acc = contrib if acc is None else (acc | contrib)
        words.append(acc)
    pad = res[..., :1] * jnp.uint32(0)
    words.extend([pad[..., 0]] * (MAX_WORDS_PER_TILE - 2 * k))
    return jnp.stack(words, axis=-1)


def _unpack_words_static(words: jnp.ndarray, k: int) -> jnp.ndarray:
    """words (..., 16) u32 → res (..., 64) u32 at static depth k (inverse)."""
    mask = jnp.uint32((1 << k) - 1)
    pixels = []
    for i in range(64):
        b = i * k
        j, sh = b >> 5, b & 31
        v = words[..., j] >> sh
        if sh + k > 32:
            v = v | (words[..., j + 1] << (32 - sh))
        pixels.append(v & mask)
    return jnp.stack(pixels, axis=-1)


def pack_tiles_to_words(tiles: jnp.ndarray):
    """(..., T, 64) u8 tiles → (depths i32, mins u8, dense words (..., T, 16) u32).

    The parallel replacement for the encode hot loop (dbde_util.cpp:150-158):
    every tile of every frame packs simultaneously; output offsets are
    resolved later by a prefix sum (payload.py), not a serial dependency.
    """
    depth, mn = tile_depths_mins(tiles)
    res = (tiles - mn[..., None]).astype(jnp.uint32)
    out = jnp.zeros(tiles.shape[:-1] + (MAX_WORDS_PER_TILE,), dtype=jnp.uint32)
    for k in range(1, 9):
        sel = (depth == k)[..., None]
        out = jnp.where(sel, _pack_words_static(res, k), out)
    return depth, mn, out


def unpack_words_to_tiles(depths: jnp.ndarray, mins: jnp.ndarray, words: jnp.ndarray) -> jnp.ndarray:
    """(depths, mins, dense words (..., T, 16) u32) → (..., T, 64) u8 tiles.

    Parallel replacement for the decode hot loop (dbde_util.cpp:230-243): the
    64-iteration scalar bit-extract becomes 64 static funnel-shift lanes.
    Depth 0 tiles broadcast the minimum (dbde_util.cpp:218-226).
    """
    res = jnp.zeros(words.shape[:-1] + (64,), dtype=jnp.uint32)
    for k in range(1, 9):
        sel = (depths == k)[..., None]
        res = jnp.where(sel, _unpack_words_static(words, k), res)
    return (res + mins[..., None].astype(jnp.uint32)).astype(jnp.uint8)
