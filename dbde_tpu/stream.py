"""Streaming DBDE file reader/writer (the reference's L3 file walker,
re-designed for batched device codecs).

The reference walks one frame per call through a refillable buffer
(dbde_file_walker, dbde_util.cpp:362-426).  Here the walker becomes:

  * :class:`DbdeReader` — scans frame records on the host (records are
    self-delimiting via their ``n64`` field), batches B frames of header
    arrays, and dispatches one device decode per batch.  The *next* batch is
    dispatched before the current one is materialized, so host parsing and
    PCIe transfer overlap device compute (double buffering).
  * :class:`DbdeWriter` — encodes frame batches on device and assembles
    records on the host, with the same 1-deep pipeline.

Both fall back to the numpy oracle when ``device=False`` (or JAX is
unavailable), and both are context managers that actually close/free their
resources (the reference's walker leaks its buffer — SURVEY §5 quirk 3 —
which we deliberately fix).
"""

from __future__ import annotations

import collections
import io
import os
import struct
from typing import Iterator

import numpy as np

from .format import (
    FRAME_HEADER_BYTES,
    VIDEO_HEADER_BYTES,
    FrameHeader,
    VideoHeader,
    max_packed_image_size,
    tile_grid,
    unpack_frame_header,
    unpack_video_header,
)

__all__ = ["DbdeReader", "DbdeWriter", "read_video", "write_video", "scan_record_size"]


def scan_record_size(buf, offset: int, T: int) -> int | None:
    """Byte size of the frame record (header + data) at ``offset``.

    Validates the three count fields like the reference decoder
    (dbde_util.cpp:295-303) but *without* touching the payload.  Returns
    None if the buffer is too short or the record is corrupt.
    """
    if len(buf) - offset < FRAME_HEADER_BYTES + 12 + 2 * T:
        return None
    (u64s,) = struct.unpack_from("<I", buf, offset)
    if u64s != 2:
        return None
    base = offset + FRAME_HEADER_BYTES
    (nb,) = struct.unpack_from("<i", buf, base)
    if nb != T:
        return None
    (nm,) = struct.unpack_from("<i", buf, base + 4 + T)
    if nm != T:
        return None
    (n64,) = struct.unpack_from("<i", buf, base + 8 + 2 * T)
    depths = np.frombuffer(buf, np.uint8, T, base + 4)
    if n64 != int(depths.astype(np.int64).sum()) or n64 < 0:
        return None
    size = FRAME_HEADER_BYTES + 12 + 2 * T + 8 * n64
    if len(buf) - offset < size:
        return None
    return size


try:
    _IOV_MAX = min(os.sysconf("SC_IOV_MAX"), 1024)
except (AttributeError, OSError, ValueError):
    _IOV_MAX = 1024


class _GatedPool:
    """Release-gated parse-buffer pool for the async device pipeline.

    Unlike the fixed-depth rotation of ``reuse_buffers`` (safe only when the
    consumer is done with a batch after N more reads), a slot here returns to
    the free list only when the consumer explicitly releases it — which the
    device iterator does after *materializing* the batch's decode output,
    because output-ready implies the decode program ran, which implies its
    host→device input transfers completed.  That gate is what makes pooled
    parsing legal under async dispatch (a blind rotation could overwrite a
    batch whose transfer is still in flight).  Steady state allocates
    ``pipeline + 1`` slots per array-shape key and then reuses them forever.
    """

    def __init__(self):
        self._free: dict = {}

    def acquire(self, key):
        lst = self._free.get(key)
        return lst.pop() if lst else None

    def release(self, key, slot) -> None:
        self._free.setdefault(key, []).append(slot)


def _writev_all(fd: int, iov: list) -> int:
    """``os.writev`` an entire buffer list (chunked to IOV_MAX, resuming
    partial writes).  The kernel's gather copy into the page cache is the
    only pass over the bytes — no host-side assembly buffer."""
    views = [memoryview(b).cast("B") for b in iov]
    total = 0
    i = 0
    while i < len(views):
        n = os.writev(fd, views[i : i + _IOV_MAX])
        if n <= 0 and any(v.nbytes for v in views[i : i + _IOV_MAX]):
            raise OSError("writev wrote 0 bytes")
        total += n
        while i < len(views) and n >= views[i].nbytes:
            n -= views[i].nbytes
            i += 1
        if i < len(views) and n:
            views[i] = views[i][n:]
    return total


class DbdeReader:
    """Batched streaming reader over a ``.dbde`` file.

    >>> with DbdeReader("video.dbde", batch_size=16) as r:
    ...     for headers, frames in r:   # frames: (b, H, W) u8 numpy
    ...         ...
    """

    def __init__(self, path_or_file, batch_size: int = 8, device: bool = True,
                 use_native: bool = True, hz_as_integer: bool = False,
                 pipeline: int = 2, readahead: bool = True,
                 reuse_buffers: int = 0):
        self._own_file = isinstance(path_or_file, (str, os.PathLike))
        self._f = open(path_or_file, "rb") if self._own_file else path_or_file
        self.batch_size = int(batch_size)
        self.pipeline = max(1, int(pipeline))  # device batches in flight
        self._reader_thread = None
        self._chunks = None
        self._readahead = bool(readahead)
        # reuse_buffers=N rotates the native parse's output arrays through
        # an N-slot pool (skips per-batch fresh-page faults).  A batch's
        # arrays are overwritten after N more
        # batches are read — keep 0 (off) if the consumer retains them.
        # Applies to iter_raw/host decoding only; the async device iterator
        # always pools via the release-gated _GatedPool (safe by
        # construction — see _pooled_batches), independent of this knob.
        self._gather_scratch = (
            {"nslots": int(reuse_buffers)} if reuse_buffers else None
        )
        self._native = None
        if use_native:
            from .native import binding as _nb

            self._native = _nb if _nb.native_available() else None
        raw = self._f.read(VIDEO_HEADER_BYTES)
        if len(raw) < VIDEO_HEADER_BYTES:
            raise ValueError("file too short for a video header")
        # hz_as_integer: the reference's DBDE_HZ_AS_INTEGER read variant
        # (dbde_util.cpp:352-356) — frame_hz stored as a rounded u64
        self.header, _ = unpack_video_header(raw, hz_as_integer=hz_as_integer)
        if not self.header.ok:
            raise ValueError(f"bad video header (u64s={self.header.u64s})")
        self.height = int(self.header.height)
        self.width = int(self.header.width)
        # geometry caps parity with the reference walker (dbde_util.cpp:374-378)
        from .format import MAX_DIM, MAX_PIXELS

        if not (0 < self.height <= MAX_DIM and 0 < self.width <= MAX_DIM
                and self.height * self.width <= MAX_PIXELS):
            raise ValueError("bad frame geometry")
        h, w = tile_grid(self.width, self.height)
        self.tiles = h * w
        # worst-case record + slack, times a few frames of lookahead
        self._chunk = max(1 << 20, (max_packed_image_size(self.width, self.height) + 64) * self.batch_size)
        self._buf = bytearray()
        self._pos = 0
        self._eof = False
        self._mm = None
        # regular files are walked zero-copy through mmap: no readahead
        # thread, no append/compact copies — the record scan and the native
        # field gather read straight from the page cache.  Pipes, sockets
        # and BytesIO keep the buffered path.
        try:
            import mmap
            import stat as _stat

            if _stat.S_ISREG(os.fstat(self._f.fileno()).st_mode):
                self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
                self._buf = self._mm
                self._pos = VIDEO_HEADER_BYTES
                self._eof = True  # the map is the whole file; never refill
        except (OSError, ValueError, io.UnsupportedOperation):
            self._mm = None
        self.frames_read = 0
        self._codec = None
        self._device = device
        if device:
            from .codec import DbdeCodec  # deferred: keep host-only use JAX-free

            self._codec = DbdeCodec(height=self.height, width=self.width)

    # -- host record scanning ------------------------------------------------

    def _start_readahead(self) -> None:
        """Background file reader: overlaps disk IO with host parse and
        device compute (the reference's memmove+fread refill, made async)."""
        import queue
        import threading

        self._chunks = queue.Queue(maxsize=4)
        stop = self._stop_read = threading.Event()
        f = self._f

        def run():
            while not stop.is_set():
                data = f.read(self._chunk)
                while not stop.is_set():
                    try:
                        self._chunks.put(data, timeout=0.2)
                        break
                    except queue.Full:
                        continue
                if not data:
                    return

        self._reader_thread = threading.Thread(target=run, daemon=True)
        self._reader_thread.start()

    def _fill(self) -> None:
        """Append more file bytes.  Never compacts (record offsets collected
        by the current batch must stay valid); compaction happens between
        batches in :meth:`_read_batch_arrays`."""
        if self._eof:
            return
        if self._readahead:
            if self._reader_thread is None:
                self._start_readahead()
            data = self._chunks.get()
        else:
            data = self._f.read(self._chunk)
        if not data:
            self._eof = True
        else:
            self._buf.extend(data)

    def _next_record(self):
        """→ (FrameHeader, record_offset) or None at EOF/corruption."""
        while True:
            if self._native is not None:
                size = self._native.record_size(self._buf, self._pos, self.tiles) or None
            else:
                size = scan_record_size(self._buf, self._pos, self.tiles)
            if size is not None:
                off = self._pos
                self._pos += size
                fh, _ = unpack_frame_header(self._buf, off)
                return fh, off, size
            if self._eof:
                return None
            self._fill()

    def _read_batch_arrays(self, pooled: bool = True, pool: _GatedPool | None = None):
        """Parse up to batch_size records → (headers, depths, mins, payload).

        Uses the native C++ scanner/parser when available (zero-copy over the
        read buffer, multithreaded memcpy); numpy fallback otherwise.
        ``pooled=False`` bypasses the ``reuse_buffers`` rotation pool.

        ``pool``: a :class:`_GatedPool` — the arrays come from (and must be
        returned to) a release-gated slot, and the return value grows a third
        element ``release`` (a zero-arg callable).  This is how the async
        device iterator gets pooled parsing safely: the slot is only reused
        after the consumer proves the batch's host→device transfer finished.
        """
        from .codec import unpack_frames_bytes

        if self._pos > 0 and self._mm is None:
            # compact between batches (offsets below stay valid); the mmap
            # path keeps absolute offsets and never compacts
            del self._buf[: self._pos]
            self._pos = 0
        headers, offsets, max_n64 = [], [], 0
        if self._native is not None and self._mm is not None:
            # mmap'd regular file: one native scan call per batch (the map
            # is the whole file, so a short scan IS EOF/corruption — no
            # refill to try)
            offs, sizes = self._native.scan_records(
                self._buf, self._pos, self.tiles, self.batch_size)
            for off, size in zip(offs, sizes):
                fh, _ = unpack_frame_header(self._buf, off)
                headers.append(fh)
                offsets.append(off + FRAME_HEADER_BYTES)
                max_n64 = max(max_n64, (size - FRAME_HEADER_BYTES - 12 - 2 * self.tiles) // 8)
                self._pos = off + size
        else:
            while len(headers) < self.batch_size:
                rec = self._next_record()
                if rec is None:
                    break
                fh, off, size = rec
                headers.append(fh)
                offsets.append(off + FRAME_HEADER_BYTES)
                max_n64 = max(max_n64, (size - FRAME_HEADER_BYTES - 12 - 2 * self.tiles) // 8)
        if not headers:
            return None
        # round the payload stride up to bound device-program recompiles while
        # keeping host->device transfer near the true encoded size
        stride = min(16 * self.tiles, -(-2 * max_n64 // 65536) * 65536 or 2)
        if pool is not None and self._native is not None:
            B = len(headers)
            key = (B, self.tiles, stride)
            slot = pool.acquire(key)
            if slot is None:
                slot = (np.empty((B, self.tiles), np.uint8),
                        np.empty((B, self.tiles), np.uint8),
                        np.empty((B, stride), np.uint32),
                        np.empty((B,), np.int32))
            arrays = self._native.gather_fields(self._buf, offsets, self.tiles,
                                                stride, out=slot)
            return headers, arrays, lambda: pool.release(key, slot)
        if self._native is not None:
            scratch = self._gather_scratch if pooled else None
            arrays = self._native.gather_fields(self._buf, offsets, self.tiles, stride,
                                                scratch=scratch)
        else:
            buf = self._buf if self._mm is not None else bytes(self._buf)
            arrays = unpack_frames_bytes(
                buf, self.width, self.height, offsets, stride
            )
        if pool is not None:
            return headers, arrays, lambda: None  # fresh arrays: nothing to gate
        return headers, arrays

    # -- iteration -----------------------------------------------------------

    def __iter__(self) -> Iterator[tuple[list[FrameHeader], np.ndarray]]:
        if self._device:
            return self._iter_device()
        return self._iter_host()

    def _iter_host(self):
        from . import ref_numpy as ref

        while True:
            batch = self._read_batch_arrays()
            if batch is None:
                return
            headers, (depths, mins, payload, n64) = batch
            frames = np.stack(
                [self._decode_host(depths[i], mins[i], payload[i]) for i in range(len(headers))]
            )
            self.frames_read += len(headers)
            yield headers, frames

    def _decode_host(self, depths, mins, payload):
        from . import ref_numpy as ref

        windows_offsets = 2 * (np.cumsum(depths.astype(np.int64)) - depths)
        tiles = np.empty((self.tiles, 64), np.uint8)
        pay8 = payload.view(np.uint8)
        for t in range(self.tiles):
            d = int(depths[t])
            start = int(windows_offsets[t]) * 4
            tiles[t] = ref._unpack_tile_payload(pay8[start : start + 8 * d].tobytes(), d, int(mins[t]))
        return ref.untile_image(tiles, self.width, self.height)

    def _pooled_batches(self):
        """The device iterator's parse path: release-gated pooled batches.

        Yields (headers, arrays, release).  ``release()`` returns the parse
        buffers to the pool; the consumer calls it once the batch's
        host→device transfer has provably completed (materializing any
        result computed from the batch implies it).  Steady-state slot use
        is ``pipeline + 1`` buffers reused forever — the same fresh-page
        fault saving as ``reuse_buffers``, made legal for async dispatch by
        the explicit gate.
        """
        pool = _GatedPool()
        while True:
            batch = self._read_batch_arrays(pool=pool)
            if batch is None:
                return
            yield batch

    def _iter_device(self):
        pending = collections.deque()
        batches = self._pooled_batches()

        def dispatch():
            batch = next(batches, None)
            if batch is None:
                return False
            headers, (depths, mins, payload, n64), release = batch
            frames = self._codec.decode_dispatch(depths, mins, payload)  # async
            pending.append((headers, frames, release))
            return True

        while len(pending) < self.pipeline and dispatch():
            pass
        while pending:
            dispatch()  # overlap: parse + dispatch next while current computes
            headers, frames, release = pending.popleft()
            self.frames_read += len(headers)
            out = self._codec.materialize(frames)  # blocks on device
            release()  # decode output ready ⇒ h2d transfers done ⇒ slot free
            yield headers, out

    def iter_raw(self):
        """Yield (headers, (depths, mins, payload, n64)) batches without
        decoding — the walker surface for consumers that want the encoded
        fields themselves (analytics over depth maps, transcoding, or
        benchmarking the L3 layer in isolation).  Array shapes match
        :func:`dbde_tpu.codec.unpack_frames_bytes`."""
        while True:
            batch = self._read_batch_arrays()
            if batch is None:
                return
            headers, arrays = batch
            self.frames_read += len(headers)
            yield headers, arrays

    def read_all(self) -> tuple[list[FrameHeader], np.ndarray]:
        headers, chunks = [], []
        for hs, frames in self:
            headers.extend(hs)
            chunks.append(frames)
        if not chunks:
            return [], np.empty((0, self.height, self.width), np.uint8)
        return headers, np.concatenate(chunks, axis=0)

    def close(self) -> None:
        if self._reader_thread is not None:
            self._stop_read.set()
            try:
                self._chunks.get_nowait()  # unblock a pending put
            except Exception:
                pass
            self._reader_thread.join(timeout=2.0)
            self._reader_thread = None
        if self._mm is not None:
            self._mm.close()
            self._mm = None
        if self._own_file and self._f is not None:
            self._f.close()
        self._f = None
        self._buf = bytearray()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class DbdeWriter:
    """Batched streaming writer producing a ``.dbde`` file."""

    def __init__(self, path_or_file, height: int, width: int, frame_hz: float = 1.0,
                 device: bool = True, hz_as_integer: bool = False, use_native: bool = True,
                 pipeline: int = 2):
        self._own_file = isinstance(path_or_file, (str, os.PathLike))
        self._f = open(path_or_file, "wb") if self._own_file else path_or_file
        try:
            # real file/pipe → vectored writes straight from the encoded
            # host arrays (no assembly pass; see record_iovecs)
            self._fd = self._f.fileno()
        except (AttributeError, OSError, ValueError):
            self._fd = None  # BytesIO and friends → assembled records
        self._native = None
        if use_native:
            from .native import binding as _nb

            self._native = _nb if _nb.native_available() else None
        self.height, self.width = int(height), int(width)
        self.header = VideoHeader(height=self.height, width=self.width, frame_hz=frame_hz)
        self._f.write(self.header.pack(hz_as_integer))
        self.frames_written = 0
        self.pipeline = max(1, int(pipeline))  # device batches in flight
        self._pending = collections.deque()
        self._asm_scratch: list = []  # reused assemble_records output buffer
        self._device = device
        self._codec = None
        if device:
            from .codec import DbdeCodec

            self._codec = DbdeCodec(height=self.height, width=self.width)

    def write(self, frames: np.ndarray, indices=None, elapsed_ns=None) -> None:
        """Queue a (B, H, W) or (H, W) u8 batch for encoding."""
        frames = np.asarray(frames, dtype=np.uint8)
        if frames.ndim == 2:
            frames = frames[None]
        B = frames.shape[0]
        if indices is None:
            indices = range(self.frames_written, self.frames_written + B)
        indices = [int(i) for i in indices]
        ns = [int(x) for x in elapsed_ns] if elapsed_ns is not None else [0] * B
        self.frames_written += B
        if self._device:
            enc = self._codec.encode(frames)  # async: drained pipeline-deep
            self._pending.append((enc, indices, ns))
            while len(self._pending) > self.pipeline:
                self._drain_one()
        else:
            from . import ref_numpy as ref

            for b in range(B):
                self._f.write(ref.pack_frame(indices[b], frames[b], ns[b]))

    def _drain_one(self) -> None:
        from .codec import pack_frames_bytes, record_iovecs

        enc, indices, ns = self._pending.popleft()
        if self._fd is not None:
            # vectored write straight from the encoded host arrays: the
            # kernel's gather copy is the only host pass over the record
            # bytes
            n64 = np.asarray(enc.n64)
            mx = 2 * int(n64.max()) if len(n64) else 0
            iov = record_iovecs(np.asarray(enc.depths), np.asarray(enc.mins),
                                enc.payload_host(mx), n64, indices, ns)
            self._f.flush()
            _writev_all(self._fd, iov)
        elif self._native is not None:
            n64 = np.asarray(enc.n64)
            mx = 2 * int(n64.max()) if len(n64) else 0
            payload = enc.payload_host(mx)
            # zero-copy view over the writer's reused scratch buffer —
            # written out before the next _drain_one touches it
            self._f.write(
                self._native.assemble_records(
                    np.asarray(enc.depths), np.asarray(enc.mins),
                    payload, n64, indices=indices, elapsed_ns=ns,
                    scratch=self._asm_scratch,
                )
            )
        else:
            for rec in pack_frames_bytes(enc, indices=indices, elapsed_ns=ns):
                self._f.write(rec)

    def close(self) -> None:
        while self._pending:
            self._drain_one()
        if self._own_file and self._f is not None:
            self._f.close()
        self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_video(path, frames, frame_hz: float = 1.0, device: bool = True, batch_size: int = 16) -> None:
    """Encode a (N, H, W) u8 stack to a .dbde file."""
    frames = np.asarray(frames, dtype=np.uint8)
    N, H, W = frames.shape
    with DbdeWriter(path, height=H, width=W, frame_hz=frame_hz, device=device) as wr:
        for i in range(0, N, batch_size):
            wr.write(frames[i : i + batch_size])


def read_video(path, device: bool = True, batch_size: int = 16, hz_as_integer: bool = False):
    """Decode a whole .dbde file → (VideoHeader, [FrameHeader], (N, H, W) u8)."""
    with DbdeReader(path, batch_size=batch_size, device=device, hz_as_integer=hz_as_integer) as r:
        headers, frames = r.read_all()
        return r.header, headers, frames
