"""Multi-chip sharding tests on a virtual 8-device CPU mesh (conftest.py)."""

import numpy as np
import pytest
import jax

from dbde_tpu import ref_numpy as ref
from dbde_tpu.parallel import (
    decode_sharded,
    encode_sharded,
    iter_video_sharded,
    make_mesh,
    read_video_sharded,
    sharded_roundtrip_step,
    split_payload_host,
    write_video_sharded,
)
from dbde_tpu.parallel.sharding import (
    assemble_payload_host,
    assemble_payload_padded,
)


def _frames(B=4, H=48, W=40, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 32, size=(B, H, W)) + 50).astype(np.uint8)


def test_mesh_construction():
    mesh = make_mesh(n_data=4, n_tiles=2)
    assert mesh.shape == {"data": 4, "tiles": 2}
    mesh = make_mesh(n_tiles=2)
    import jax

    assert mesh.shape["data"] == len(jax.devices()) // 2
    assert mesh.shape["tiles"] == 2


@pytest.mark.parametrize("n_data,n_tiles", [(2, 1), (1, 2), (4, 2), (2, 3)])
def test_sharded_encode_matches_oracle(n_data, n_tiles):
    mesh = make_mesh(n_data=n_data, n_tiles=n_tiles)
    frames = _frames(B=n_data * 2, H=8 * 6, W=21)  # h=6 divides 1,2,3
    depth, mn, payload, totals, bases, Hp = encode_sharded(frames, mesh)
    payloads = assemble_payload_host(payload, totals)

    for b in range(frames.shape[0]):
        expected = ref.pack_image(frames[b])
        T = 6 * 3  # h=6, w=ceil(21/8)=3
        exp_depths = np.frombuffer(expected, np.uint8, T, 4)
        exp_mins = np.frombuffer(expected, np.uint8, T, 8 + T)
        exp_payload = np.frombuffer(expected, np.uint32, offset=12 + 2 * T)
        np.testing.assert_array_equal(np.asarray(depth)[b], exp_depths)
        np.testing.assert_array_equal(np.asarray(mn)[b], exp_mins)
        np.testing.assert_array_equal(payloads[b], exp_payload)


def test_sharded_encode_rejects_uneven_bands():
    mesh = make_mesh(n_data=2, n_tiles=4)
    with pytest.raises(ValueError):
        encode_sharded(_frames(B=2, H=8 * 6, W=16), mesh)  # 6 tiles % 4 != 0


@pytest.mark.parametrize("n_data,n_tiles", [(2, 2), (1, 4)])
def test_sharded_decode_roundtrip(n_data, n_tiles):
    mesh = make_mesh(n_data=n_data, n_tiles=n_tiles)
    frames = _frames(B=n_data * 3, H=8 * 4, W=30, seed=3)
    depth, mn, payload, totals, bases, Hp = encode_sharded(frames, mesh)
    out = decode_sharded(depth, mn, payload, mesh, H=frames.shape[1], W=30, Hp=Hp)
    np.testing.assert_array_equal(np.asarray(out), frames)


def test_sharded_roundtrip_step_ragged():
    """The fused dp+sp step handles ragged H via internal band padding."""
    mesh = make_mesh(n_data=2, n_tiles=2)
    frames = _frames(B=4, H=37, W=29, seed=9)  # ragged both dims
    out, n64 = sharded_roundtrip_step(frames, mesh)
    np.testing.assert_array_equal(np.asarray(out), frames)
    assert int(n64) > 0


def test_sharded_encode_to_whole_file():
    """Full multi-chip → file path: sharded encode, host ragged assembly,
    whole-file equality with the single-host oracle encoding."""
    import struct

    from dbde_tpu.format import VideoHeader, FrameHeader

    mesh = make_mesh(n_data=2, n_tiles=2)
    frames = _frames(B=4, H=8 * 4, W=24, seed=11)
    H, W = 32, 24
    depth, mn, payload, totals, bases, Hp = encode_sharded(frames, mesh)
    payloads = assemble_payload_host(payload, totals)
    depth, mn = np.asarray(depth), np.asarray(mn)
    T = depth.shape[1]

    out = [VideoHeader(height=H, width=W, frame_hz=7.0).pack()]
    for b in range(frames.shape[0]):
        n64 = int(len(payloads[b]) // 2)
        out.append(FrameHeader(index=b).pack())
        out.append(struct.pack("<i", T) + depth[b].tobytes())
        out.append(struct.pack("<i", T) + mn[b].tobytes())
        out.append(struct.pack("<i", n64) + payloads[b].tobytes())
    sharded_file = b"".join(out)

    expected = ref.encode_video(list(frames), frame_hz=7.0)
    assert sharded_file == expected


def test_sharded_matches_global_n64():
    mesh = make_mesh(n_data=1, n_tiles=2)
    frames = _frames(B=2, H=32, W=32, seed=4)
    depth, mn, payload, totals, bases, Hp = encode_sharded(frames, mesh)
    # totals sum = 2 * n64 per frame
    exp = [ref.pack_image(f) for f in frames]
    import struct

    for b, e in enumerate(exp):
        T = 4 * 4
        (n64,) = struct.unpack_from("<i", e, 8 + 2 * T)
        assert int(np.asarray(totals)[:, b].sum()) == 2 * n64
        # bases are the exclusive scan of totals
        np.testing.assert_array_equal(
            np.asarray(bases)[:, b],
            np.concatenate([[0], np.cumsum(np.asarray(totals)[:-1, b])]),
        )


def test_split_payload_inverse_of_assemble():
    """split_payload_host reconstructs decode-ready per-shard segments from
    a file-flat payload: live prefixes byte-equal the device's own segments
    and the mesh decode of the split is pixel-exact."""
    mesh = make_mesh(n_data=2, n_tiles=2)
    frames = _frames(B=4, H=32, W=30, seed=7)
    depth, mn, payload, totals, bases, Hp = encode_sharded(frames, mesh)
    pays = assemble_payload_host(payload, totals)
    mx = max(p.size for p in pays)
    flat = np.zeros((4, mx), np.uint32)
    for b, p in enumerate(pays):
        flat[b, : p.size] = p
    segs = split_payload_host(flat, np.asarray(depth), 32, 30, 2)
    assert segs.shape == np.asarray(payload).shape
    t = np.asarray(totals)
    dev = np.asarray(payload).reshape(4, 2, -1)
    sp = segs.reshape(4, 2, -1)
    for b in range(4):
        for s in range(2):
            np.testing.assert_array_equal(sp[b, s, : t[s, b]], dev[b, s, : t[s, b]])
    out = decode_sharded(np.asarray(depth), np.asarray(mn), segs, mesh,
                         H=32, W=30, Hp=Hp)
    np.testing.assert_array_equal(out, frames)


GARBAGE_CASES = [((2, 2), 32, 30), ((2, 2), 16, 8), ((1, 4), 64, 1000),
                 ((4, 1), 21, 77)]


@pytest.mark.parametrize("mesh_shape,H,W", GARBAGE_CASES,
                         ids=[f"{a}x{b}-{h}x{w}" for (a, b), h, w in GARBAGE_CASES])
def test_decode_tolerates_garbage_segment_tails(mesh_shape, H, W):
    """Segment slot words past each shard's live count must never reach the
    output: the decode window gathers mask dead lanes by depth.  This is
    the invariant that lets split_payload_host skip the worst-case zero
    fill (np.empty slots)."""
    n_data, n_tiles = mesh_shape
    mesh = make_mesh(n_data=n_data, n_tiles=n_tiles)
    frames = _frames(B=2 * n_data, H=H, W=W, seed=13)
    B = frames.shape[0]
    depth, mn, payload, totals, bases, Hp = encode_sharded(frames, mesh)
    t = np.asarray(totals)
    segs = np.asarray(payload).reshape(B, n_tiles, -1).copy()
    for b in range(B):
        for s in range(n_tiles):
            segs[b, s, t[s, b]:] = 0xDEADBEEF
    out = decode_sharded(np.asarray(depth), np.asarray(mn),
                         segs.reshape(B, -1), mesh, H=H, W=W, Hp=Hp)
    np.testing.assert_array_equal(out, frames)


NARROW_CASES = [(1, 2, 32, 8), (1, 2, 32, 64), (2, 2, 48, 16), (4, 2, 16, 24),
                (2, 1, 40, 320)]


@pytest.mark.parametrize("n_data,n_tiles,H,W", NARROW_CASES,
                         ids=[f"{a}x{b}-{h}x{w}" for a, b, h, w in NARROW_CASES])
def test_sharded_narrow_width_byte_parity(n_data, n_tiles, H, W):
    """Narrow frames split into tile-row bands: the assembled per-shard
    segments equal the oracle's stream and the mesh decode is exact."""
    mesh = make_mesh(n_data=n_data, n_tiles=n_tiles)
    rng = np.random.default_rng(H * W)
    frames = (rng.integers(0, 256, (n_data, H, W))
              & rng.integers(0, 256, (n_data, H, W))).astype(np.uint8)
    depth, mn, payload, totals, bases, Hp = encode_sharded(frames, mesh)
    payloads = assemble_payload_host(payload, totals)
    T = (H // 8) * (-(-W // 8))
    for b in range(n_data):
        expected = ref.pack_image(frames[b])
        np.testing.assert_array_equal(np.asarray(depth)[b],
                                      np.frombuffer(expected, np.uint8, T, 4))
        np.testing.assert_array_equal(np.asarray(mn)[b],
                                      np.frombuffer(expected, np.uint8, T, 8 + T))
        np.testing.assert_array_equal(
            payloads[b], np.frombuffer(expected, np.uint32, offset=12 + 2 * T))
    out = decode_sharded(depth, mn, payload, mesh, H=H, W=W, Hp=Hp)
    np.testing.assert_array_equal(out, frames)


RAGGED_STEPS = [(2, 2, 37, 29), (4, 2, 13, 11), (2, 4, 70, 9), (1, 8, 61, 130)]


@pytest.mark.parametrize("n_data,n_tiles,H,W", RAGGED_STEPS,
                         ids=[f"{a}x{b}-{h}x{w}" for a, b, h, w in RAGGED_STEPS])
def test_sharded_roundtrip_step_ragged_geometries(n_data, n_tiles, H, W):
    """The fused step pads ragged H to whole bands internally and crops
    back: exact pixels, and n64 equal to the single-device encoding's when
    the bands need no extra tile rows."""
    mesh = make_mesh(n_data=n_data, n_tiles=n_tiles)
    frames = _frames(B=2 * n_data, H=H, W=W, seed=H + W)
    out, n64 = sharded_roundtrip_step(frames, mesh)
    np.testing.assert_array_equal(out, frames)
    if -(-H // 8) % n_tiles == 0:
        import struct

        T = (-(-H // 8)) * (-(-W // 8))
        exp = sum(struct.unpack_from("<i", ref.pack_image(f), 8 + 2 * T)[0]
                  for f in frames)
        assert int(n64) == exp


def test_assemble_payload_padded_matches_ragged():
    """The writer-side padded assembly equals the ragged per-frame concat on
    every live prefix (rows are np.empty-padded past 2*n64)."""
    mesh = make_mesh(n_data=2, n_tiles=2)
    frames = _frames(B=4, H=32, W=30, seed=5)
    depth, mn, payload, totals, bases, Hp = encode_sharded(frames, mesh)
    pay, n64 = assemble_payload_padded(payload, totals)
    t = np.asarray(totals)
    segments = np.asarray(payload).reshape(4, 2, -1)
    for b in range(4):
        expected = np.concatenate([segments[b, s, : t[s, b]] for s in range(2)])
        assert 2 * int(n64[b]) == expected.size
        np.testing.assert_array_equal(pay[b, : expected.size], expected)


def test_iter_video_sharded_bounded_walker(tmp_path):
    """The sharded walker yields batch-sized chunks (bounded memory, never
    the whole video), agrees with read_video_sharded frame-for-frame, and
    handles a tail batch that doesn't fill the data axis."""
    mesh = make_mesh(n_data=2, n_tiles=2)
    frames = _frames(B=7, H=32, W=24, seed=23)  # 7 frames, batch 4 → 4+3
    p = tmp_path / "w.dbde"
    write_video_sharded(p, frames, mesh, frame_hz=2.0, batch_size=4)
    seen, sizes = [], []
    for headers, chunk in iter_video_sharded(p, mesh, batch_size=4):
        assert chunk.shape[0] == len(headers)
        sizes.append(chunk.shape[0])
        seen.append(chunk)
    assert sizes == [4, 3]
    np.testing.assert_array_equal(np.concatenate(seen), frames)
    vh, headers, out = read_video_sharded(p, mesh, batch_size=4)
    np.testing.assert_array_equal(out, frames)
    assert [h.index for h in headers] == list(range(7))


def test_sharded_file_write_and_read(tmp_path):
    """The sharded file layer: write_video_sharded produces bytes identical
    to the single-host oracle encoding (incl. a tail batch that doesn't fill
    the data axis), and read_video_sharded decodes the file pixel-exactly
    through the mesh."""
    mesh = make_mesh(n_data=2, n_tiles=2)
    frames = _frames(B=5, H=32, W=24, seed=21)  # N=5: tail pads the data axis
    p = tmp_path / "s.dbde"
    write_video_sharded(p, frames, mesh, frame_hz=7.0, batch_size=4)
    assert p.read_bytes() == ref.encode_video(list(frames), frame_hz=7.0)
    vh, headers, out = read_video_sharded(p, mesh, batch_size=4)
    assert vh.frame_hz == 7.0
    assert [h.index for h in headers] == list(range(5))
    np.testing.assert_array_equal(out, frames)
