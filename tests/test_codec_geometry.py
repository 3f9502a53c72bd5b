"""DbdeCodec bytes vs the numpy oracle across frame geometries and
adversarial depth patterns (CPU, small shapes)."""

import numpy as np
import pytest

from dbde_tpu import ref_numpy as ref
from dbde_tpu.bench_core import make_adversarial, make_uniform8
from dbde_tpu.codec import DbdeCodec, pack_frames_bytes


def assert_codec_matches_oracle(frames: np.ndarray) -> np.ndarray:
    """Every frame's record bytes equal ref_numpy's and every frame
    round-trips; returns the depths."""
    B, H, W = frames.shape
    codec = DbdeCodec(height=H, width=W)
    enc = codec.encode(frames)
    recs = pack_frames_bytes(enc)
    for b in range(B):
        assert recs[b] == ref.pack_frame(b, frames[b]), f"frame {b}"
    out = codec.decode(enc.depths, enc.mins, enc.payload)
    np.testing.assert_array_equal(out, frames)
    return np.asarray(enc.depths)


def _mixed(B, H, W, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (B, H, W))
            & rng.integers(0, 256, (B, H, W))).astype(np.uint8)


# (H, W): single tile, ragged H and W, narrow widths from 8 to 320, and
# wide widths like the reference harness's 2536.
GEOMETRIES = [
    (8, 8), (5, 3), (16, 8), (24, 16), (21, 76), (40, 53), (33, 64),
    (17, 128), (64, 200), (9, 320), (520, 128), (40, 1000), (16, 2536),
    (11, 2536),
]


@pytest.mark.parametrize("geom", GEOMETRIES, ids=[f"{h}x{w}" for h, w in GEOMETRIES])
def test_codec_bytes_match_oracle(geom):
    H, W = geom
    assert_codec_matches_oracle(_mixed(2, H, W, seed=H * 7919 + W))


ADV = [(seed, maxd) for seed in range(3) for maxd in (1, 3, 5, 8)]
ADV_GEOMS = [(48, 40), (37, 91), (16, 264)]


@pytest.mark.parametrize("seed,maxd", ADV, ids=[f"s{s}-d{d}" for s, d in ADV])
def test_adversarial_depths_match_oracle(seed, maxd):
    H, W = ADV_GEOMS[seed]
    frames = make_adversarial(W, H, 3, maxd=maxd, seed=seed)
    depths = assert_codec_matches_oracle(frames)
    assert depths.max() <= maxd


U8_GEOMS = [(8, 8), (16, 24), (30, 46), (10, 1024), (24, 2536), (1082, 16)]


@pytest.mark.parametrize("geom", U8_GEOMS, ids=[f"{h}x{w}" for h, w in U8_GEOMS])
def test_uniform8_frames_match_oracle(geom):
    H, W = geom
    depths = assert_codec_matches_oracle(make_uniform8(W, H, 2, seed=H + W))
    assert (depths == 8).all()


def test_uniform8_rejects_single_pixel_edge_tiles():
    with pytest.raises(ValueError):
        make_uniform8(17, 16, 1)
