"""Host-staged multithreaded shuffle transport
(``spark_rapids_tpu/parallel/host_shuffle.py`` counterpart).

Partition slices leave the device as host columns; a writer pool
serializes them, compresses them and appends them as frames to one file
per partition; the read side streams a partition's frames back,
verifies, decompresses and decodes them.  This bounds device memory by a
single partition, and the files are host-portable.

The frame header is the reference's ``<cQQI>``: codec flag, stored length,
raw length and the crc32 of the stored bytes, checked on EVERY decode
(a mismatch raises ``FrameCorrupt``).  The payload is the port's own
numpy column serialization (the card has no pyarrow, so not Arrow IPC):
per column its kind, its data, its validity, and for string columns
either dictionary codes or the strings themselves, strings as int64
offsets plus UTF-8 bytes.  A string column's dictionary is written once
per shuffle, in a frame file of its own, not with every frame.  The
codec is zlib level 1 (flag ``Z``; a frame that does not shrink is stored
raw, flag ``R``), as the reference falls back to zlib when its native LZ4 library is not built
(``native.py:310``); the native codec is a later item.
"""

from __future__ import annotations

import io
import os
import struct
import threading
import time
import uuid
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Optional, Tuple

import numpy as np

__all__ = ["HostShuffle", "iter_frames", "verify_stream",
           "gc_orphan_frames", "encode_columns", "decode_columns",
           "FrameCorrupt", "HostSlice"]

_FRAME = struct.Struct("<cQQI")
_MAGIC = b"SRTF"

# column kinds of the payload
_NUMERIC, _CODES, _STRINGS = 0, 1, 2


class FrameCorrupt(RuntimeError):
    """A frame's stored bytes do not match their stamped crc32."""


class HostSlice:
    """The rows of one partition on the host: ``columns`` per column a
    tuple (kind, data, valid) — kind ``"numeric"`` (a numpy array),
    ``"codes"`` (int32 codes of the column's dictionary, which the
    shuffle writes once, :meth:`HostShuffle.write_dictionary`) or
    ``"strings"`` (an object array of str)."""

    def __init__(self, columns: List[tuple], num_rows: int):
        self.columns = columns
        self.num_rows = num_rows


# ---------------------------------------------------------------------------------
# Payload
# ---------------------------------------------------------------------------------

def _put_array(out: io.BytesIO, a: np.ndarray) -> None:
    a = np.ascontiguousarray(a)
    dt = a.dtype.str.encode()
    out.write(struct.pack("<B", len(dt)))
    out.write(dt)
    out.write(struct.pack("<B", a.ndim))
    out.write(struct.pack(f"<{a.ndim}q", *a.shape))
    out.write(a.tobytes())


def _get_array(buf: memoryview, pos: int) -> Tuple[np.ndarray, int]:
    (ndt,) = struct.unpack_from("<B", buf, pos)
    pos += 1
    dt = np.dtype(bytes(buf[pos:pos + ndt]).decode())
    pos += ndt
    (ndim,) = struct.unpack_from("<B", buf, pos)
    pos += 1
    shape = struct.unpack_from(f"<{ndim}q", buf, pos)
    pos += 8 * ndim
    nbytes = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
    a = np.frombuffer(buf, dtype=dt, count=nbytes // dt.itemsize
                      if dt.itemsize else 0, offset=pos).reshape(shape)
    return a.copy(), pos + nbytes


def _put_strings(out: io.BytesIO, values: np.ndarray,
                 valid: Optional[np.ndarray]) -> None:
    """UTF-8 bytes and int64 offsets (a null row as an empty string)."""
    lst = values.tolist()
    if valid is not None:
        lst = [v if ok else None for v, ok in zip(lst, valid.tolist())]
    enc = [b"" if v is None else v.encode() for v in lst]
    offsets = np.zeros(len(enc) + 1, dtype=np.int64)
    np.cumsum(np.fromiter(map(len, enc), np.int64, len(enc)),
              out=offsets[1:])
    _put_array(out, offsets)
    _put_array(out, np.frombuffer(b"".join(enc), dtype=np.uint8))


def _get_strings(buf: memoryview, pos: int) -> Tuple[np.ndarray, int]:
    offsets, pos = _get_array(buf, pos)
    raw, pos = _get_array(buf, pos)
    data = raw.tobytes()
    bounds = offsets.tolist()
    out = np.empty(len(bounds) - 1, dtype=object)
    out[:] = [data[a:b].decode() for a, b in zip(bounds[:-1], bounds[1:])]
    return out, pos


def encode_columns(sl: HostSlice) -> bytes:
    """A host slice as payload bytes."""
    out = io.BytesIO()
    out.write(_MAGIC)
    out.write(struct.pack("<qI", sl.num_rows, len(sl.columns)))
    for kind, data, valid in sl.columns:
        code = {"numeric": _NUMERIC, "codes": _CODES,
                "strings": _STRINGS}[kind]
        out.write(struct.pack("<BB", code, valid is not None))
        if kind == "strings":
            _put_strings(out, data, valid)
        else:
            _put_array(out, data)
        if valid is not None:
            _put_array(out, valid.astype(np.bool_))
    return out.getvalue()


def decode_columns(payload: bytes) -> HostSlice:
    """Inverse of :func:`encode_columns`."""
    buf = memoryview(payload)
    if bytes(buf[:4]) != _MAGIC:
        raise FrameCorrupt("shuffle payload: bad magic")
    num_rows, ncols = struct.unpack_from("<qI", buf, 4)
    pos = 4 + 12
    cols = []
    for _ in range(ncols):
        code, has_valid = struct.unpack_from("<BB", buf, pos)
        pos += 2
        if code == _STRINGS:
            data, pos = _get_strings(buf, pos)
        else:
            data, pos = _get_array(buf, pos)
        valid = None
        if has_valid:
            valid, pos = _get_array(buf, pos)
        if code == _STRINGS and valid is not None:
            data[~valid] = None
        cols.append((("numeric", "codes", "strings")[code], data, valid))
    return HostSlice(cols, int(num_rows))


# ---------------------------------------------------------------------------------
# Frames
# ---------------------------------------------------------------------------------

def _compress(payload: bytes):
    z = zlib.compress(payload, 1)
    if len(z) < len(payload):
        return b"Z", z
    return b"R", payload


def _decompress(flag: bytes, data: bytes, raw_len: int) -> bytes:
    if flag == b"Z":
        out = zlib.decompress(data)
    elif flag == b"R":
        out = bytes(data)
    else:
        raise FrameCorrupt(f"shuffle frame: unknown codec flag {flag!r}")
    if len(out) != raw_len:
        raise FrameCorrupt(f"shuffle frame: {len(out)} bytes decoded, "
                           f"{raw_len} stamped")
    return out


def _verify(stored: bytes, crc: int, what: str) -> None:
    got = zlib.crc32(stored) & 0xFFFFFFFF
    if got != crc:
        raise FrameCorrupt(f"{what}: crc32 {got:#010x} != stamped "
                           f"{crc:#010x}")


def frame(payload: bytes, compress: bool = True) -> bytes:
    """One frame: header and stored bytes."""
    flag, data = _compress(payload) if compress else (b"R", payload)
    return _FRAME.pack(flag, len(data), len(payload),
                       zlib.crc32(data) & 0xFFFFFFFF) + data


def iter_frames(data: bytes) -> Iterator[HostSlice]:
    """Decode a frame stream (a partition file's bytes) into host slices,
    each frame's stored bytes verified against its crc first."""
    pos = 0
    while pos < len(data):
        flag, clen, rlen, crc = _FRAME.unpack_from(data, pos)
        pos += _FRAME.size
        stored = data[pos:pos + clen]
        _verify(stored, crc, f"shuffle frame @{pos}")
        pos += clen
        yield decode_columns(_decompress(flag, stored, rlen))


def verify_stream(data: bytes, what: str = "frame stream") -> bytes:
    """Walk a frame stream verifying each frame's crc without decoding;
    returns ``data``."""
    pos, i = 0, 0
    while pos < len(data):
        flag, clen, rlen, crc = _FRAME.unpack_from(data, pos)
        pos += _FRAME.size
        _verify(data[pos:pos + clen], crc, f"{what} frame {i}")
        pos += clen
        i += 1
    return data


def gc_orphan_frames(spill_dir: str, older_than_ms: float) -> int:
    """Remove ``shuffle-*`` frame directories under ``spill_dir`` whose
    newest file is older than the threshold (a live shuffle's directory
    is recent); returns the directories removed."""
    import shutil
    if older_than_ms <= 0:
        return 0
    try:
        names = os.listdir(spill_dir)
    except OSError:
        return 0
    removed = 0
    now = time.time()
    for name in names:
        if not name.startswith("shuffle-"):
            continue
        path = os.path.join(spill_dir, name)
        try:
            if not os.path.isdir(path):
                continue
            mtime = max([os.path.getmtime(path)] + [
                os.path.getmtime(os.path.join(path, f))
                for f in os.listdir(path)])
        except OSError:
            continue
        if (now - mtime) * 1000.0 > older_than_ms:
            shutil.rmtree(path, ignore_errors=True)
            removed += 1
    return removed


class HostShuffle:
    """One shuffle's map-side output: ``n_parts`` append-only frame files
    written by a thread pool, read back a partition at a time."""

    def __init__(self, n_parts: int, spill_dir: str, num_threads: int = 4,
                 compress: bool = True):
        self.n_parts = n_parts
        self.dir = os.path.join(spill_dir,
                                f"shuffle-{uuid.uuid4().hex[:12]}")
        os.makedirs(self.dir, exist_ok=True)
        self.compress = compress
        self._paths = [os.path.join(self.dir, f"part-{p:05d}.bin")
                       for p in range(n_parts)]
        self._locks = [threading.Lock() for _ in range(n_parts)]
        self._pool = ThreadPoolExecutor(max_workers=max(1, num_threads))
        self._pending: List = []
        self._count_lock = threading.Lock()
        self.bytes_written = 0
        self.rows_written = 0
        self.part_rows = [0] * n_parts   # rows queued per partition
        self.bytes_read = 0
        self._dict_paths: dict = {}

    def write_partition(self, p: int, sl: HostSlice) -> None:
        """Queue a host slice for partition ``p`` (serialized, compressed
        and appended on the pool)."""
        if sl.num_rows == 0:
            return
        self.part_rows[p] += sl.num_rows
        self._pending.append(self._pool.submit(self._do_write, p, sl))

    def _do_write(self, p: int, sl: HostSlice) -> None:
        data = frame(encode_columns(sl), self.compress)
        with self._locks[p]:
            with open(self._paths[p], "ab") as f:
                f.write(data)
        with self._count_lock:
            self.bytes_written += len(data)
            self.rows_written += sl.num_rows

    def write_dictionary(self, col: int, values: np.ndarray) -> None:
        """Column ``col``'s dictionary, once per shuffle, as one frame in
        its own file (``dict-<col>.bin``): the partition frames carry the
        column's codes alone."""
        data = frame(encode_columns(HostSlice(
            [("strings", np.asarray(values, dtype=object), None)],
            len(values))), self.compress)
        path = os.path.join(self.dir, f"dict-{col:05d}.bin")
        with open(path, "wb") as f:
            f.write(data)
        self._dict_paths[col] = path
        with self._count_lock:
            self.bytes_written += len(data)

    def read_dictionary(self, col: int, decode: bool = True
                        ) -> Optional[np.ndarray]:
        """Column ``col``'s dictionary frame, its crc checked; the values
        (or, with ``decode=False``, None: the caller holds them)."""
        with open(self._dict_paths[col], "rb") as f:
            data = f.read()
        self.bytes_read += len(data)
        verify_stream(data, f"dict-{col:05d}")
        if not decode:
            return None
        return next(iter_frames(data)).columns[0][1]

    def finish_writes(self) -> None:
        """Barrier: every queued frame written (the map side is done)."""
        for fut in self._pending:
            fut.result()
        self._pending.clear()

    def read_partition(self, p: int) -> Iterator[HostSlice]:
        """The host slices written to partition ``p``, each frame's crc
        checked before it is decompressed."""
        path = self._paths[p]
        if not os.path.exists(path):
            return
        with open(path, "rb") as f:
            while True:
                header = f.read(_FRAME.size)
                if not header:
                    break
                flag, clen, rlen, crc = _FRAME.unpack(header)
                stored = f.read(clen)
                self.bytes_read += _FRAME.size + clen
                _verify(stored, crc, f"part-{p:05d} frame")
                yield decode_columns(_decompress(flag, stored, rlen))

    def close(self, delete: bool = True) -> None:
        """Shut the writer pool down and (by default) delete the files."""
        self._pool.shutdown(wait=True)
        if not delete:
            return
        for path in self._paths + list(self._dict_paths.values()):
            try:
                os.unlink(path)
            except OSError:
                pass
        try:
            os.rmdir(self.dir)
        except OSError:
            pass
