"""Multi-device sharding of the DBDE codec over a device mesh.

The reference is single-threaded C++ — there is no distributed design to
port.  This module scales the codec over a ``("data", "tiles")`` mesh:

  * axis ``"data"`` — frame-batch data parallelism (the production mode for
    camera streams: each device encodes/decodes its own frames; zero
    cross-device traffic in the hot path).
  * axis ``"tiles"`` — tile (sequence-parallel analogue) sharding of single
    huge frames: the image is split into horizontal bands of 8-pixel-row
    tiles.  The only cross-shard coupling in the whole format is the payload
    offset prefix-sum; it becomes an ``all_gather`` of one scalar per shard
    (the shard's total word count), which XLA hands to NCCL on GPUs;
    after it every shard compacts its payload segment independently.
    Every device reaches every other directly, so the mesh shape follows
    the algorithm alone.

Per-shard payload segments stay sharded (each shard owns a worst-case-sized
slot); the host assembles the ragged file bytes from (segment, length) pairs.
This is the standard ragged-allgather pattern — moving the ragged concat to
the host avoids a device-side all-to-all entirely.
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..codec import decode_frames, encode_frames
from ..format import tile_grid


def make_mesh(n_data: int | None = None, n_tiles: int = 1, devices=None) -> Mesh:
    """Build a ("data", "tiles") mesh from the available devices."""
    devices = list(jax.devices()) if devices is None else list(devices)
    if n_data is None:
        n_data = len(devices) // n_tiles
    if n_data * n_tiles > len(devices):
        raise ValueError(f"mesh {n_data}x{n_tiles} needs more than {len(devices)} devices")
    dev = np.array(devices[: n_data * n_tiles]).reshape(n_data, n_tiles)
    return Mesh(dev, axis_names=("data", "tiles"))


# ---------------------------------------------------------------------------
# shard_map bodies (everything below runs per-device on local blocks)
# ---------------------------------------------------------------------------


def _encode_block(images_local: jnp.ndarray):
    """Per-device encode of a (B_local, H_local, W) band stack.

    H_local must be a multiple of 8 (bands align to tile rows), which
    :func:`encode_sharded` guarantees by pre-padding.  Returns local depths,
    mins, a locally-compacted payload segment, and the segment's word count.
    The global offset of each shard's segment is an exclusive sum over the
    ``tiles`` axis of segment totals — the format's single serialization,
    reduced to one tiny collective.
    """
    depth, mn, payload, n64 = encode_frames(images_local)
    total = 2 * n64  # u32 words
    # exclusive prefix over the tiles axis: word base of this shard's segment
    totals = jax.lax.all_gather(total, "tiles")  # (n_tiles, B_local)
    my = jax.lax.axis_index("tiles")
    mask = (jnp.arange(totals.shape[0]) < my)[:, None]
    base = jnp.sum(totals * mask, axis=0)
    return depth, mn, payload, total[None, :], base[None, :]


# ---------------------------------------------------------------------------
# cached compiled sharded programs: the file helpers below call encode/decode
# once per batch, and a freshly-constructed shard_map closure per call would
# defeat jax.jit's compile cache — Mesh is hashable, so memoize the jitted
# callables by (mesh, geometry) and let jit cache executables per shape
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _encode_jit(mesh: Mesh):
    fn = jax.shard_map(
        _encode_block,
        mesh=mesh,
        in_specs=P("data", "tiles", None),
        out_specs=(
            P("data", "tiles"),  # depths: T dim band-sharded
            P("data", "tiles"),  # mins
            P("data", "tiles"),  # payload segments, concatenated band-major
            P("tiles", "data"),  # totals per shard
            P("tiles", "data"),  # bases per shard
        ),
    )
    return jax.jit(fn)


@lru_cache(maxsize=None)
def _decode_jit(mesh: Mesh, H_local: int, W: int):
    fn = jax.shard_map(
        partial(decode_frames, H=H_local, W=W),
        mesh=mesh,
        in_specs=(P("data", "tiles"), P("data", "tiles"), P("data", "tiles")),
        out_specs=P("data", "tiles", None),
    )
    return jax.jit(fn)


# ---------------------------------------------------------------------------
# public sharded API
# ---------------------------------------------------------------------------


def _pad_to_bands(images: np.ndarray, n_tiles: int):
    """Edge-pad H so each of the ``n_tiles`` bands is a multiple of 8 rows."""
    B, H, W = images.shape
    unit = 8 * n_tiles
    Hp = -(-H // unit) * unit
    if Hp != H:
        images = np.concatenate(
            [images, np.repeat(images[:, -1:, :], Hp - H, axis=1)], axis=1
        )
    return images, Hp


def _band_rows(H: int, n_tiles: int) -> int:
    """Tile rows per shard; raises unless the bands are equal."""
    h = -(-H // 8)
    if h % n_tiles != 0:
        raise ValueError(
            f"tile rows ({h}) must divide evenly into {n_tiles} bands for "
            "bit-exact sharded encode; pick n_tiles dividing ceil(H/8)"
        )
    return h // n_tiles


def _put(x, mesh: Mesh, spec: P):
    """Host or device array → array split over ``mesh``: each device
    receives only its own block (no staging on the first device)."""
    return jax.device_put(x, NamedSharding(mesh, spec))


def encode_sharded(images, mesh: Mesh):
    """(B, H, W) u8 frames → sharded encoded arrays.

    ``B`` is sharded over ``data``; tile rows are sharded into ``tiles``
    bands.  Requires ``ceil(H/8) % n_tiles == 0`` (equal 8-row-aligned bands)
    so the output is bit-identical to the single-device encoding — band-major
    tile order == global row-major tile order.

    Returns (depths (B,T) u8, mins (B,T) u8, payload (B, n_tiles*S_local)
    u32 per-shard worst-case segments, totals (n_tiles, B) i32 segment word
    counts, bases (n_tiles, B) i32 global word offsets, Hp).
    """
    images = np.asarray(images, dtype=np.uint8)
    n_tiles = mesh.shape["tiles"]
    _band_rows(images.shape[1], n_tiles)
    images, Hp = _pad_to_bands(images, n_tiles)
    depth, mn, payload, totals, bases = _encode_jit(mesh)(
        _put(images, mesh, P("data", "tiles", None)))
    return depth, mn, payload, totals, bases, Hp


def decode_sharded_dispatch(depths, mins, segments, mesh: Mesh, H: int, W: int,
                            Hp: int):
    """Dispatch a sharded decode asynchronously → a pending (B, Hp, W) u8
    device array.

    Returns immediately after the (async) jit dispatch; pass the result to
    :func:`decode_sharded_materialize` to block and get the (B, H, W) u8
    numpy frames.  The split lets a walker overlap the next batch's host
    parse/split with the device decode (see :func:`iter_video_sharded`).
    """
    spec = P("data", "tiles")
    H_local = Hp // mesh.shape["tiles"]
    return _decode_jit(mesh, H_local, W)(
        _put(depths, mesh, spec), _put(mins, mesh, spec),
        _put(segments, mesh, spec))


def decode_sharded_materialize(pending, H: int, W: int) -> np.ndarray:
    """Block on a :func:`decode_sharded_dispatch` value → (B, H, W) u8."""
    return np.asarray(pending[:, :H, :W])


def decode_sharded(depths, mins, segments, mesh: Mesh, H: int, W: int,
                   Hp: int) -> np.ndarray:
    """Inverse of :func:`encode_sharded`; → (B, H, W) u8 numpy."""
    return decode_sharded_materialize(
        decode_sharded_dispatch(depths, mins, segments, mesh, H, W, Hp), H, W)


@lru_cache(maxsize=None)
def _roundtrip_jit(mesh: Mesh, H: int, H_local: int, W: int):
    def body(x_local):
        depth, mn, payload, total, base = _encode_block(x_local)
        out = decode_frames(depth, mn, payload, H_local, W)
        # global n64 via cross-mesh reduction
        n64 = jax.lax.psum(jnp.sum(total), ("data", "tiles")) // 2
        return out, n64

    fn = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=P("data", "tiles", None),
        out_specs=(P("data", "tiles", None), P()),
    )

    def step(x):
        out, n64 = fn(x)
        return out[:, :H, :W], n64

    return jax.jit(step)


def sharded_roundtrip_step(images, mesh: Mesh):
    """One full sharded encode→decode step: dp over frames + sp over tile
    bands, compiled as one program.  Returns ((B, H, W) u8 numpy, global
    n64)."""
    images = np.asarray(images, dtype=np.uint8)
    B, H, W = images.shape
    n_tiles = mesh.shape["tiles"]
    padded, Hp = _pad_to_bands(images, n_tiles)
    out, n64 = _roundtrip_jit(mesh, H, Hp // n_tiles, W)(
        _put(padded, mesh, P("data", "tiles", None)))
    return np.asarray(out), n64


def assemble_payload_host(segments, totals) -> list[np.ndarray]:
    """Per-frame flat u32 payloads from sharded segments (host ragged concat).

    segments: (B, n_tiles*16*T_local) u32; totals: (n_tiles, B) i32.
    """
    pay, n64 = assemble_payload_padded(segments, totals)
    return [pay[b, : 2 * int(n64[b])].copy() for b in range(pay.shape[0])]


def assemble_payload_padded(segments, totals, out=None):
    """Sharded segments → one padded (B, mx) u32 payload matrix + n64 (B,).

    The writer-side host leg: each frame's flat stream is its shards'
    live-prefix slices back to back, written straight into an UNINITIALIZED
    row-padded matrix — consumers (:func:`dbde_tpu.codec.record_iovecs`)
    only ever read ``2*n64`` words per row, so neither the inter-frame
    padding nor a zero fill is needed.  One contiguous memcpy per (frame,
    shard); no intermediate per-frame list, no second copy, no worst-case
    memset.

    ``out``: optional reusable (≥B, ≥mx) u32 buffer, which spares a fresh
    allocation's page faults per batch; rows may be wider than mx
    (consumers read per-row prefixes).  Returns (matrix (B, ≥mx) u32, n64 (B,) i64);
    allocates when ``out`` is absent or too small.
    """
    totals = np.asarray(totals)
    n_tiles = totals.shape[0]
    segments = np.asarray(segments)
    B = segments.shape[0]
    segments = segments.reshape(B, n_tiles, -1)
    counts = totals.T.astype(np.int64)  # (B, n_tiles)
    bases = np.cumsum(counts, axis=1) - counts
    words = counts.sum(1)
    mx = int(words.max()) if B else 0
    if out is not None and out.shape[0] >= B and out.shape[1] >= mx:
        pay = out[:B]
    else:
        pay = np.empty((B, mx), np.uint32)
    for b in range(B):
        row = pay[b]
        for s in range(n_tiles):
            c = counts[b, s]
            row[bases[b, s] : bases[b, s] + c] = segments[b, s, :c]
    return pay, words // 2


def segment_slot_words(W: int, H: int, n_tiles: int) -> int:
    """Per-shard payload segment slot size in u32 words — the stride both
    :func:`encode_sharded` emits and :func:`decode_sharded` expects per
    shard (worst-case 16 words per tile)."""
    return 16 * _band_rows(H, n_tiles) * tile_grid(W, H)[1]


def split_payload_host(payload, depths, H: int, W: int, n_tiles: int,
                       out=None) -> np.ndarray:
    """File-flat per-frame payloads → per-shard worst-case segments.

    The inverse of :func:`assemble_payload_host`, computable entirely on
    the host from per-band depth sums: shard ``s`` of frame ``b`` owns tile
    rows ``[s*h_loc, (s+1)*h_loc)``, so its segment is the
    ``2*Σ depths``-word slice of the flat stream starting at the exclusive
    prefix of the earlier shards' word counts (the same prefix the device
    encode derives with its one-scalar all_gather).  This is what lets a
    mesh decode a file's bytes — the walker→decoder coupling the reference
    has single-threaded (dbde_util.cpp:362-426), at mesh scale.

    payload: (B, S) u32 flat streams (any S ≥ each frame's 2*n64);
    depths: (B, T) u8.  Returns (B, n_tiles*S_local) u32 segments ready for
    :func:`decode_sharded`.  Slot words past each shard's live count are
    UNINITIALIZED: the decode window gathers mask dead lanes by depth, so
    output never depends on them (pinned by
    tests/test_parallel.py::test_decode_tolerates_garbage_segment_tails) —
    skipping the worst-case zero fill saves more host time per batch than
    the copies themselves cost (the slots are sized for 16 words/tile; live
    camera content fills ~a third of that).

    ``out``: optional reusable (B, n_tiles*S_local) u32 buffer: a fresh
    worst-case-sized allocation per batch pays its page faults every time,
    so :func:`iter_video_sharded` pools these buffers with the same
    release-gating discipline as the single-device reader's parse pool.
    """
    depths = np.asarray(depths)
    payload = np.asarray(payload)
    B, T = depths.shape
    _band_rows(H, n_tiles)
    counts = 2 * depths.reshape(B, n_tiles, -1).astype(np.int64).sum(-1)
    bases = np.cumsum(counts, axis=1) - counts
    S_local = segment_slot_words(W, H, n_tiles)
    if out is None or out.shape != (B, n_tiles * S_local):
        out = np.empty((B, n_tiles * S_local), np.uint32)
    segs = out.reshape(B, n_tiles, S_local)
    for b in range(B):
        src = payload[b]
        for s in range(n_tiles):
            c = counts[b, s]
            segs[b, s, :c] = src[bases[b, s] : bases[b, s] + c]
    return out


# ---------------------------------------------------------------------------
# sharded file layer: the L3 walker/writer coupled to the mesh codec
# ---------------------------------------------------------------------------


def write_video_sharded(path, frames, mesh: Mesh, frame_hz: float = 1.0,
                        batch_size: int = 16,
                        hz_as_integer: bool = False) -> None:
    """Encode a (N, H, W) u8 stack to a ``.dbde`` file on a device mesh.

    Each batch shards over the mesh (frames over ``data``, tile-row bands
    over ``tiles``); the host assembles the ragged payload segments
    (:func:`assemble_payload_host`) and writes records byte-identical to the
    single-device writer — band-major tile order equals global row-major
    order, the invariant :func:`encode_sharded` guarantees.  Tail batches
    that don't fill the data axis are padded with repeated frames on device
    and dropped at the file boundary.
    """
    from ..codec import record_iovecs
    from ..format import VideoHeader
    from ..stream import _writev_all

    frames = np.asarray(frames, dtype=np.uint8)
    N, H, W = frames.shape
    n_data = mesh.shape["data"]
    step = max(batch_size - batch_size % n_data, n_data)
    pay_buf = None  # reused across batches; os.writev is synchronous, so
    # the buffer is free the moment _writev_all returns
    with open(path, "wb") as f:
        f.write(VideoHeader(height=H, width=W, frame_hz=frame_hz).pack(hz_as_integer))
        f.flush()  # the records below bypass the buffer via writev on the fd
        for i in range(0, N, step):
            batch = frames[i : i + step]
            n = batch.shape[0]
            if n % n_data:  # pad the tail to fill the data axis; drop below
                pad = n_data - n % n_data
                batch = np.concatenate([batch, np.repeat(batch[-1:], pad, 0)])
            depth, mn, payload, totals, bases, Hp = encode_sharded(batch, mesh)
            pay, n64 = assemble_payload_padded(payload, totals, out=pay_buf)
            if pay_buf is None or pay.shape[1] > pay_buf.shape[1]:
                pay_buf = pay if pay.base is None else None
            iov = record_iovecs(np.asarray(depth)[:n], np.asarray(mn)[:n],
                                pay[:n], n64[:n], indices=range(i, i + n))
            _writev_all(f.fileno(), iov)


def iter_video_sharded(path, mesh: Mesh, batch_size: int = 16,
                       hz_as_integer: bool = False, pipeline: int = 2):
    """Bounded-memory sharded file walker: yield (headers, (n, H, W) u8)
    batches of a ``.dbde`` file decoded across a device mesh.

    The mesh-scale analogue of the reference walker's fixed-buffer loop
    (dbde_util.cpp:372-426) and of the single-device
    :meth:`DbdeReader._iter_device` pipeline: the host walker scans and
    parses records (mmap, no decode), each batch's flat payloads split into
    per-shard segments (:func:`split_payload_host`, host leg), and the mesh
    decode dispatches ASYNCHRONOUSLY — up to ``pipeline`` batches are in
    flight, so the next batch's parse+split overlaps the current decode.
    Memory is O(pipeline · batch) — parsed records, segments, and decoded
    frames for in-flight batches only, never the whole video.

    Tail batches pad the data axis with zero records (depth 0 everywhere —
    a frame of zeros) and slice them off after decode.
    """
    import collections

    from ..stream import DbdeReader

    n_data = mesh.shape["data"]
    n_tiles = mesh.shape["tiles"]
    with DbdeReader(path, batch_size=max(batch_size, n_data), device=False,
                    hz_as_integer=hz_as_integer) as rd:
        H, W = rd.height, rd.width
        Hp = 8 * n_tiles * _band_rows(H, n_tiles)
        raw = rd.iter_raw()
        pending = collections.deque()
        seg_pool: dict = {}  # batch shape → free segment buffers, reused
        # to spare fresh worst-case allocations their page faults;
        # release-gated like DbdeReader._pooled_batches — a buffer returns
        # only after its decode materialized, which implies the h2d
        # transfer consumed it

        def dispatch():
            item = next(raw, None)
            if item is None:
                return False
            headers, (depths, mins, payload, n64) = item
            n = len(headers)
            if n % n_data:
                pad = n_data - n % n_data
                z8 = np.zeros((pad, depths.shape[1]), np.uint8)
                depths = np.concatenate([depths, z8])
                mins = np.concatenate([mins, z8])
                payload = np.concatenate(
                    [payload, np.zeros((pad, payload.shape[1]), np.uint32)])
            free = seg_pool.setdefault(depths.shape[0], [])
            buf = free.pop() if free else None
            segments = split_payload_host(payload, depths, H, W, n_tiles,
                                          out=buf)
            out = decode_sharded_dispatch(depths, mins, segments, mesh, H=H,
                                          W=W, Hp=Hp)
            pending.append((headers, out, n, segments))
            return True

        while len(pending) < pipeline and dispatch():
            pass
        while pending:
            dispatch()  # overlap: parse + split + dispatch while device busy
            headers, out, n, segments = pending.popleft()
            frames = decode_sharded_materialize(out, H, W)[:n]
            # decode output on host ⇒ h2d transfer done ⇒ buffer free
            seg_pool[segments.shape[0]].append(segments)
            yield headers, frames


def read_video_sharded(path, mesh: Mesh, batch_size: int = 16,
                       hz_as_integer: bool = False):
    """Decode a whole ``.dbde`` file on a device mesh →
    (VideoHeader, [FrameHeader], (N, H, W) u8).

    Whole-video convenience wrapper over :func:`iter_video_sharded` — use
    the iterator directly for unbounded streams.
    """
    from ..stream import DbdeReader

    headers_all, chunks = [], []
    for headers, frames in iter_video_sharded(
            path, mesh, batch_size=batch_size, hz_as_integer=hz_as_integer):
        headers_all.extend(headers)
        chunks.append(frames)
    with DbdeReader(path, hz_as_integer=hz_as_integer) as rd:
        header, H, W = rd.header, rd.height, rd.width
    frames = (np.concatenate(chunks) if chunks
              else np.empty((0, H, W), np.uint8))
    return header, headers_all, frames
