"""A parquet writer in numpy, and ``DataFrame.write.parquet``.

Counterpart of the parquet half of ``spark_rapids_tpu/io/writers.py``
(``DataFrameWriter.parquet`` :220), which writes through pyarrow.  The
port writes the format itself (``io/thrift.py``, ``io/pqformat.py``):

* every field OPTIONAL, as pyarrow writes a nullable field, with its
  definition levels as the RLE/bit-packed hybrid;
* numbers, dates and timestamps PLAIN; strings dictionary-encoded: a PLAIN
  dictionary page of the chunk's distinct strings in ascending order
  (marked ``is_sorted``, so a reader needs no sort) and RLE_DICTIONARY
  indices;
* min/max (``min_value``/``max_value``, type-defined order) and the null
  count per chunk;
* one data page (v1) per column chunk; codec UNCOMPRESSED (the default)
  or GZIP.

:class:`ParquetWriter` writes one row group per ``write_table`` call of at
most ``row_group_size`` rows (more rows make several groups), as pyarrow's
``ParquetWriter`` does; :func:`write_table` writes a whole table the same
way.  Input columns are what ``batch.numpy_column`` takes, or its
``(type, data, valid)`` result.
"""

from __future__ import annotations

import datetime
import os
import struct
import uuid
import zlib
from typing import Dict, List, Optional

import numpy as np

from .. import types as T
from ..batch import numpy_column
from .pqformat import plain_encode_strings, rle_hybrid_encode
from .thrift import write_struct

__all__ = ["ParquetWriter", "write_table", "DataFrameWriter",
           "ROW_GROUP_ROWS"]

# pyarrow's default maximum row group length
ROW_GROUP_ROWS = 1 << 20
_CODECS = {"UNCOMPRESSED": 0, "GZIP": 2}
_CREATED_BY = "spark_rapids_tpu_torch parquet writer"
_EPOCH = datetime.date(1970, 1, 1)


def _physical(dt: T.DataType):
    """(physical type, converted type, logical type fields, numpy dtype)."""
    k = dt.kind
    if k == T.TypeKind.BOOLEAN:
        return 0, None, None, None
    if k in (T.TypeKind.INT8, T.TypeKind.INT16):
        bits = 8 if k == T.TypeKind.INT8 else 16
        return 1, 15 if bits == 8 else 16, \
            [(10, "struct", [(1, "byte", bits), (2, "bool", True)])], "<i4"
    if k == T.TypeKind.INT32:
        return 1, None, None, "<i4"
    if k == T.TypeKind.INT64:
        return 2, None, None, "<i8"
    if k == T.TypeKind.FLOAT32:
        return 4, None, None, "<f4"
    if k == T.TypeKind.FLOAT64:
        return 5, None, None, "<f8"
    if k == T.TypeKind.DATE:
        return 1, 6, [(6, "struct", [])], "<i4"
    if k == T.TypeKind.TIMESTAMP:
        return 2, None, [(8, "struct", [(1, "bool", False),
                                        (2, "struct", [(2, "struct", [])])])
                         ], "<i8"
    if dt.is_string:
        return 6, 0, [(1, "struct", [])], None
    raise NotImplementedError(
        f"writing a {dt} column to parquet is not ported yet (ROADMAP.md "
        f"item 9)")


def _stat_bytes(ptype: int, v) -> bytes:
    if ptype == 6:
        return v.encode("utf-8")
    if ptype == 0:
        return bytes([int(bool(v))])
    fmt = {1: "<i", 2: "<q", 4: "<f", 5: "<d"}[ptype]
    return struct.pack(fmt, v)


def _dictionary(values: np.ndarray):
    """(the distinct strings in ascending order as str, each value's index
    into them).  A fixed-width unicode array is hashed word by word and
    the distinct hashes sorted as integers, so only the distinct strings
    are sorted as strings; a hash shared by two strings falls back to
    ``np.unique`` of the strings."""
    if values.dtype.kind != "U":
        values = np.asarray(values, dtype=object).astype(str)
    n = len(values)
    if n > 4096 and values.dtype.itemsize:
        words = np.ascontiguousarray(values).view(np.uint32).reshape(n, -1)
        h = np.zeros(n, dtype=np.uint64)
        for j in range(words.shape[1]):
            h = (h * np.uint64(0x100000001B3)) ^ words[:, j]
        _, first, inverse = np.unique(h, return_index=True,
                                      return_inverse=True)
        cand = values[first]
        order = np.argsort(cand, kind="stable")
        if len(np.unique(cand)) == len(cand):
            rank = np.empty(len(order), dtype=np.int64)
            rank[order] = np.arange(len(order))
            return cand[order].tolist(), rank[inverse.reshape(-1)]
    uniq, inverse = np.unique(values, return_inverse=True)
    return uniq.tolist(), inverse.reshape(-1)


class _Column:
    """One column's type and the byte layout of its chunks."""

    def __init__(self, name: str, dt: T.DataType):
        self.name = name
        self.dtype = dt
        self.ptype, self.converted, self.logical, self.np = _physical(dt)

    def schema_element(self) -> list:
        return [(1, "i32", self.ptype), (3, "i32", 1),
                (4, "binary", self.name), (6, "i32", self.converted),
                (10, "struct", self.logical)]


class ParquetWriter:
    """An open parquet file: ``write_table`` adds row groups, ``close``
    writes the footer.  ``codec`` is ``"UNCOMPRESSED"`` or ``"GZIP"``."""

    def __init__(self, path: str, codec: str = "UNCOMPRESSED",
                 row_group_size: int = ROW_GROUP_ROWS):
        if codec not in _CODECS:
            raise NotImplementedError(
                f"the port's parquet writer writes {sorted(_CODECS)}, not "
                f"{codec!r} (ROADMAP.md item 9)")
        self.path = path
        self.codec = _CODECS[codec]
        self.row_group_size = row_group_size
        self._f = open(path, "wb")
        self._f.write(b"PAR1")
        self._cols: Optional[List[_Column]] = None
        self._groups: List[list] = []
        self._rows = 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def write_table(self, columns: Dict[str, object]) -> None:
        typed = {n: a if isinstance(a, tuple) else numpy_column(a)
                 for n, a in columns.items()}
        cols = [_Column(n, dt) for n, (dt, _, _) in typed.items()]
        if self._cols is None:
            self._cols = cols
        elif [(c.name, c.dtype) for c in cols] != \
                [(c.name, c.dtype) for c in self._cols]:
            raise ValueError("every table written to one file has the "
                             "file's schema")
        n = len(next(iter(typed.values()))[1]) if typed else 0
        for off in range(0, n, self.row_group_size):
            m = min(self.row_group_size, n - off)
            self._row_group([(c, typed[c.name][1][off:off + m],
                              None if typed[c.name][2] is None
                              else typed[c.name][2][off:off + m])
                             for c in self._cols], m)

    def _compress(self, raw: bytes) -> bytes:
        if self.codec == 0:
            return raw
        z = zlib.compressobj(6, zlib.DEFLATED, 31)
        return z.compress(raw) + z.flush()

    def _page(self, ptype_header: list, raw: bytes) -> bytes:
        body = self._compress(raw)
        head = write_struct([(1, "i32", ptype_header[0]),
                             (2, "i32", len(raw)), (3, "i32", len(body))]
                            + ptype_header[1:])
        return head + body

    def _chunk(self, col: _Column, data: np.ndarray,
               valid: Optional[np.ndarray], n: int) -> list:
        ok = np.ones(n, dtype=bool) if valid is None else valid
        live = data if valid is None else data[ok]
        levels = rle_hybrid_encode(ok.astype(np.int64), 1)
        levels = len(levels).to_bytes(4, "little") + levels
        start = self._f.tell()
        dict_off = None
        stats = [(3, "i64", int(n - len(live)))]
        encodings = [0, 3]
        if col.ptype == 6:
            uniq, idx = _dictionary(live)
            dict_off = start
            self._f.write(self._page(
                [2, (7, "struct", [(1, "i32", len(uniq)), (2, "i32", 0),
                                   (3, "bool", True)])],
                plain_encode_strings(uniq)))
            bw = max(1, int(len(uniq) - 1).bit_length())
            values = bytes([bw]) + rle_hybrid_encode(idx.reshape(-1), bw)
            encoding, encodings = 8, [0, 3, 8]
            if uniq:
                stats += [(5, "binary", _stat_bytes(6, uniq[-1])),
                          (6, "binary", _stat_bytes(6, uniq[0]))]
        else:
            if col.ptype == 0:
                values = np.packbits(live.astype(bool),
                                     bitorder="little").tobytes()
            else:
                values = np.ascontiguousarray(live.astype(col.np)).tobytes()
            encoding = 0
            if len(live):
                lo, hi = live.min(), live.max()
                if col.ptype in (4, 5):
                    finite = live[~np.isnan(live)]
                    lo, hi = (finite.min(), finite.max()) if len(finite) \
                        else (None, None)
                    if lo is not None:
                        lo = -0.0 if lo == 0 else lo
                        hi = 0.0 if hi == 0 else hi
                if lo is not None:
                    py = int if col.ptype in (1, 2) else (
                        bool if col.ptype == 0 else float)
                    stats += [(5, "binary", _stat_bytes(col.ptype, py(hi))),
                              (6, "binary", _stat_bytes(col.ptype, py(lo)))]
        data_off = self._f.tell()
        self._f.write(self._page(
            [0, (5, "struct", [(1, "i32", n), (2, "i32", encoding),
                               (3, "i32", 3), (4, "i32", 3)])],
            levels + values))
        end = self._f.tell()
        size = end - start
        meta = [(1, "i32", col.ptype), (2, "list", ("i32", encodings)),
                (3, "list", ("binary", [col.name])),
                (4, "i32", self.codec), (5, "i64", n),
                (6, "i64", size), (7, "i64", size),
                (9, "i64", data_off), (11, "i64", dict_off),
                (12, "struct", sorted(stats))]
        return [(2, "i64", start), (3, "struct", meta)], size, start

    def _row_group(self, cols, n: int) -> None:
        chunks, total, first = [], 0, None
        for col, data, valid in cols:
            cc, size, start = self._chunk(col, data, valid, n)
            first = start if first is None else first
            chunks.append(cc)
            total += size
        self._groups.append([(1, "list", ("struct", chunks)),
                             (2, "i64", total), (3, "i64", n),
                             (5, "i64", first), (6, "i64", total)])
        self._rows += n

    def close(self) -> None:
        if self._f is None:
            return
        cols = self._cols or []
        schema = [[(4, "binary", "schema"), (5, "i32", len(cols))]] + \
            [c.schema_element() for c in cols]
        footer = write_struct([
            (1, "i32", 1), (2, "list", ("struct", schema)),
            (3, "i64", self._rows), (4, "list", ("struct", self._groups)),
            (6, "binary", _CREATED_BY),
            (7, "list", ("struct", [[(1, "struct", [])] for _ in cols]))])
        self._f.write(footer)
        self._f.write(len(footer).to_bytes(4, "little") + b"PAR1")
        self._f.close()
        self._f = None


def write_table(columns: Dict[str, object], path: str,
                codec: str = "UNCOMPRESSED",
                row_group_size: int = ROW_GROUP_ROWS) -> None:
    """``columns`` to one parquet file, in row groups of at most
    ``row_group_size`` rows."""
    with ParquetWriter(path, codec, row_group_size) as w:
        w.write_table(columns)


def _rows_to_columns(rows: list, schema) -> Dict[str, tuple]:
    """Collected rows → ``(type, data, valid)`` columns of the schema's
    types, zeros (None for strings) under a null."""
    out = {}
    for i, f in enumerate(schema):
        vals = [r[i] for r in rows]
        ok = np.array([v is not None for v in vals], dtype=bool)
        valid = None if ok.all() else ok
        if f.dtype.is_string:
            data = np.empty(len(vals), dtype=object)
            data[:] = vals
        elif f.dtype.kind == T.TypeKind.DATE:
            data = np.array([(v - _EPOCH).days if v is not None else 0
                             for v in vals], dtype=np.int32)
        elif f.dtype.kind == T.TypeKind.TIMESTAMP:
            data = np.array(["NaT" if v is None else v for v in vals],
                            dtype="datetime64[us]").astype(np.int64)
            data[~ok] = 0
        else:
            data = np.array([0 if v is None else v for v in vals],
                            dtype=f.dtype.numpy_dtype)
        out[f.name] = (f.dtype, data, valid)
    return out


class DataFrameWriter:
    """``df.write.mode(...).parquet(path)``: the result's rows into one
    part file under the directory ``path`` (the reference's writer,
    ``io/writers.py:192``, without partitioning or other formats)."""

    def __init__(self, df):
        self._df = df
        self._mode = "error"

    def mode(self, m: str) -> "DataFrameWriter":
        if m not in ("error", "errorifexists", "overwrite", "append",
                     "ignore"):
            raise ValueError(f"unknown write mode {m!r}")
        self._mode = m
        return self

    def parquet(self, path: str) -> int:
        """Write; returns the number of rows written."""
        if os.path.exists(path) and os.listdir(path):
            if self._mode in ("error", "errorifexists"):
                raise FileExistsError(f"path {path} already exists "
                                      f"(write mode 'error')")
            if self._mode == "ignore":
                return 0
            if self._mode == "overwrite":
                import shutil
                shutil.rmtree(path)
        os.makedirs(path, exist_ok=True)
        rows = self._df.collect()
        write_table(_rows_to_columns(rows, self._df.schema), os.path.join(
            path, f"part-00000-{uuid.uuid4().hex}.parquet"))
        return len(rows)
