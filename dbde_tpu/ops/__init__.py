"""Device-side (JAX/XLA) tile codec ops.

The reference's per-tile sequential loops (dbde_util.cpp:150-178, 307-326) are
re-designed here as a data-parallel two-phase pipeline:

  encode:  tile → per-tile min/max/depth (vector reductions)
           → exclusive prefix-sum of per-tile word counts (offsets)
           → parallel fixed-offset bit-pack of ALL tiles at once
  decode:  offsets from prefix-summed depths
           → parallel window gather → vectorized bit-extract → add-min → untile

Everything is static-shaped and batched; no data-dependent Python control flow.
"""

from .tiling import pad_and_tile, untile
from .bitpack import pack_tiles_to_words, unpack_words_to_tiles, tile_depths_mins
from .payload import (
    word_offsets,
    compact_payload,
    gather_windows,
)
