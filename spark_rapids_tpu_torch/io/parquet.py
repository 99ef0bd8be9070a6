"""The parquet scan source: footers, row-group pruning, the exact host
filter, batches and prefetch, in numpy.

Counterpart of ``spark_rapids_tpu/io/parquet.py``, which reads through
pyarrow; the card's machine has no pyarrow, so the port parses the format
itself (``io/thrift.py``, ``io/pqformat.py``).  The functions keep the
reference's names and semantics:

* :func:`expand_paths` (:41), :func:`hive_partition_values` (:56),
  :func:`_infer_partition_type` (:85), :func:`parquet_schema` (:105);
* :func:`_stat_keep` (:118) and :func:`prune_row_groups` (:146): a row
  group is skipped when its footer statistics (typed as pyarrow types
  them: ints, floats, ``datetime.date``, ``str``) show that no row can
  satisfy a pushed conjunct;
* :func:`_exact_filter_mask` (:172): the pushed conjuncts applied exactly
  on the host with Kleene AND (a null compare drops the row; ``in`` is
  ``np.isin`` over the non-null values), so dropped rows are never
  uploaded; None when a conjunct cannot be applied exactly;
* :class:`ParquetSource` (:226), with ``with_pushdown`` (:300),
  ``estimated_rows`` (:318), ``cache_token``, the batches of
  ``batch_rows`` rows cut from the kept row groups of each file as one
  stream (pyarrow's ``iter_batches`` boundaries), and the prefetch thread
  (:555, ``io/sources.FileSource``) that decodes ahead of the upload;
* :func:`parquet_source` (:621).

A batch is a :class:`HostTable`: numbers as numpy (zeros under nulls),
strings as ``HostStringColumn`` objects whose distinct values and
per-row indices come from the file's dictionary pages (``_distinct``), so
the engine above groups, joins and filters them without sorting every
row's string.  The decoded-file cache (``io/filecache.py``) keeps these
tables, and with them the encodings the engine caches on their string
columns.  Deletion vectors, equality deletes, crc sidecars and the
transient-read retry (the reference's ``_skip_rows``, ``_anti_rows``,
``integrity``, ``faults``) are not ported (ROADMAP.md item 9): passing
them raises.
"""

from __future__ import annotations

import datetime
import glob as _glob
import operator as _op
import os
import struct
import threading
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .. import types as T
from ..batch import Field, HostStringColumn, Schema
from .pqformat import PHYSICAL, read_chunk, unsupported
from .sources import FileSource
from .thrift import read_file_metadata

__all__ = ["parquet_schema", "parquet_source", "expand_paths",
           "hive_partition_values", "ParquetSource", "ParquetFile",
           "HostTable", "prune_row_groups", "Predicate"]

# A pushed-down predicate conjunct: (column, op, value) with op one of
# < <= > >= == != in isnotnull ("in" carries a list value).
Predicate = Tuple[str, str, object]
_EPOCH = datetime.date(1970, 1, 1)
_EPOCH_DT = datetime.datetime(1970, 1, 1)


def expand_paths(path, ext: str = ".parquet") -> List[str]:
    if isinstance(path, (list, tuple)):
        out: List[str] = []
        for p in path:
            out += expand_paths(p, ext)
        return out
    if os.path.isdir(path):
        # recursive: picks up hive-partitioned layouts (p=1/part-....parquet)
        return sorted(_glob.glob(os.path.join(path, "**", f"*{ext}"),
                                 recursive=True))
    if any(ch in path for ch in "*?["):
        return sorted(_glob.glob(path))
    return [path]


def hive_partition_values(root, paths: List[str]):
    """``key=value`` partition columns inferred from file paths:
    ``(part_names, {path: {name: raw string or None}})``, empty when the
    layout is not partitioned."""
    if not isinstance(root, str) or not os.path.isdir(root):
        return [], {}
    rootp = os.path.abspath(root)
    names: List[str] = []
    per_path = {}
    for p in paths:
        rel = os.path.relpath(os.path.abspath(p), rootp)
        kv = {}
        for comp in rel.split(os.sep)[:-1]:
            if "=" in comp:
                k, _, v = comp.partition("=")
                kv[k] = None if v == "__HIVE_DEFAULT_PARTITION__" else v
                if k not in names:
                    names.append(k)
        per_path[p] = kv
    if not names:
        return [], {}
    return names, per_path


def _infer_partition_type(values):
    """Narrowest of int64/float64/string fitting every non-null value."""
    present = [v for v in values if v is not None]
    if not present:
        return "string"
    try:
        for v in present:
            int(v)
        return "int64"
    except ValueError:
        pass
    try:
        for v in present:
            float(v)
        return "float64"
    except ValueError:
        return "string"


# ---------------------------------------------------------------------------------
# Footers
# ---------------------------------------------------------------------------------

class _Leaf:
    """A flat column of the file: name, physical type, logical type and
    its definition level (0 required, 1 optional)."""

    def __init__(self, el: dict):
        self.name = el["name"]
        self.ptype = el["type"]
        self.max_def = 1 if el["repetition"] == 1 else 0
        if el["repetition"] == 2:
            raise unsupported(f"repeated column {self.name!r}")
        self.unit = None
        self.dtype = self._logical(el)

    def _logical(self, el) -> T.DataType:
        lt = el["logical_type"]
        name, params = lt if lt else (None, {})
        conv = el["converted_type"]
        p = self.ptype
        if name == "DECIMAL" or conv == 5:
            raise unsupported(f"decimal column {self.name!r}")
        if p == 0:
            return T.BOOLEAN
        if p == 1:
            if name == "DATE" or conv == 6:
                return T.DATE
            if name == "INTEGER" or conv in (15, 16, 17, 11, 12, 13):
                bits = params.get("bits") or {15: 8, 16: 16, 17: 32, 11: 8,
                                              12: 16, 13: 32}[conv]
                if name == "INTEGER" and not params.get("signed") \
                        or conv in (11, 12, 13):
                    raise unsupported(f"unsigned column {self.name!r}")
                return {8: T.INT8, 16: T.INT16, 32: T.INT32}[bits]
            if name is None and conv is None:
                return T.INT32
        if p == 2:
            if name == "TIMESTAMP" or conv in (9, 10):
                self.unit = params.get("unit") or {9: "ms", 10: "us"}[conv]
                return T.TIMESTAMP
            if name in (None, "INTEGER") and conv in (None, 18):
                if name == "INTEGER" and not params.get("signed"):
                    raise unsupported(f"unsigned column {self.name!r}")
                return T.INT64
        if p == 4:
            return T.FLOAT32
        if p == 5:
            return T.FLOAT64
        if p == 6 and (name in ("STRING", "ENUM", "JSON")
                       or conv in (0, 4, 19)):
            return T.STRING
        raise unsupported(f"column {self.name!r} of physical type "
                          f"{PHYSICAL.get(p, p)} with logical type "
                          f"{name or conv}")

    def stat(self, raw: Optional[bytes]):
        """A footer statistic as the Python value pyarrow gives."""
        if raw is None:
            return None
        p = self.ptype
        if p == 6:
            return raw.decode("utf-8")
        if p == 0:
            return bool(raw[0])
        if p == 4:
            return struct.unpack("<f", raw[:4])[0]
        if p == 5:
            return struct.unpack("<d", raw[:8])[0]
        v = int.from_bytes(raw, "little", signed=True)
        if self.dtype == T.DATE:
            return _EPOCH + datetime.timedelta(days=v)
        if self.dtype == T.TIMESTAMP:
            us = {"ms": v * 1000, "us": v, "ns": v // 1000}[self.unit]
            return _EPOCH_DT + datetime.timedelta(microseconds=us)
        return v


class _Stats:
    """A column chunk's statistics as ``_stat_keep`` reads them."""

    def __init__(self, leaf: _Leaf, s: dict):
        self.null_count = s.get("null_count")
        self.has_null_count = self.null_count is not None
        lo, hi = s.get("min_value"), s.get("max_value")
        if (lo is None or hi is None) and leaf.ptype != 6:
            lo, hi = s.get("min"), s.get("max")   # legacy, signed order
        self.has_min_max = lo is not None and hi is not None
        self.min = leaf.stat(lo) if self.has_min_max else None
        self.max = leaf.stat(hi) if self.has_min_max else None


class ParquetFile:
    """One file's parsed footer: ``leaves`` (the flat columns), ``num_rows``
    and ``row_groups`` (each ``{"num_rows", "columns"}``)."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            if size < 12:
                raise ValueError(f"{path} is not a parquet file")
            f.seek(size - 8)
            tail = f.read(8)
            if tail[4:] != b"PAR1":
                raise ValueError(f"{path} is not a parquet file")
            flen = int.from_bytes(tail[:4], "little")
            f.seek(size - 8 - flen)
            meta = read_file_metadata(f.read(flen))
        schema = meta["schema"]
        if any(e["num_children"] for e in schema[1:]):
            raise unsupported(f"nested column in {path}")
        self.leaves = [_Leaf(e) for e in schema[1:]]
        self.num_rows = meta["num_rows"]
        self.row_groups = meta["row_groups"]
        self.index = {leaf.name: i for i, leaf in enumerate(self.leaves)}

    @property
    def num_row_groups(self) -> int:
        return len(self.row_groups)

    def statistics(self, rg: int, ci: int) -> Optional[_Stats]:
        s = self.row_groups[rg]["columns"][ci]["statistics"]
        return None if s is None else _Stats(self.leaves[ci], s)

    def read_column(self, f, rg: int, ci: int):
        """Row group ``rg``'s column ``ci`` decoded (a ``pqformat.Chunk``),
        reading its bytes from the open file ``f``."""
        meta = dict(self.row_groups[rg]["columns"][ci])
        if meta.get("file_path"):
            raise unsupported("column chunks in other files")
        start = meta["data_page_offset"]
        d = meta["dictionary_page_offset"]
        if d is not None and 0 < d < start:
            start = d
        else:
            d = None   # some writers store 0 for "no dictionary page"
        f.seek(start)
        # a writable buffer: PLAIN values are used in place, not copied
        buf = bytearray(meta["total_compressed_size"])
        f.readinto(buf)
        meta["data_page_offset"] -= start
        meta["dictionary_page_offset"] = None if d is None else d - start
        leaf = self.leaves[ci]
        return read_chunk(buf, meta, leaf.ptype, leaf.max_def,
                          self.row_groups[rg]["num_rows"])


_FOOTERS: Dict[str, tuple] = {}
_FOOTERS_LOCK = threading.Lock()


def open_file(path: str) -> ParquetFile:
    """The parsed footer of ``path``, cached per (path, mtime, size)."""
    st = os.stat(path)
    key = (st.st_mtime_ns, st.st_size)
    with _FOOTERS_LOCK:
        hit = _FOOTERS.get(path)
        if hit is not None and hit[0] == key:
            return hit[1]
    pf = ParquetFile(path)
    with _FOOTERS_LOCK:
        _FOOTERS[path] = (key, pf)
    return pf


def parquet_schema(paths: List[str], columns: Optional[List[str]] = None
                   ) -> Schema:
    pf = open_file(paths[0])
    fields = [Field(leaf.name, leaf.dtype, leaf.max_def > 0)
              for leaf in pf.leaves
              if columns is None or leaf.name in columns]
    if columns is not None:
        order = {n: i for i, n in enumerate(columns)}
        fields.sort(key=lambda f: order[f.name])
    return Schema(fields)


# ---------------------------------------------------------------------------------
# Pruning
# ---------------------------------------------------------------------------------

def _stat_keep(stats, op: str, value, num_rows: int) -> bool:
    """Can any row in a row group with these stats satisfy (col op value)?"""
    if op == "isnotnull":
        return stats is None or not getattr(stats, "has_null_count", False) \
            or stats.null_count < num_rows
    if stats is None or not stats.has_min_max:
        return True
    lo, hi = stats.min, stats.max
    try:
        if op == "<":
            return lo < value
        if op == "<=":
            return lo <= value
        if op == ">":
            return hi > value
        if op == ">=":
            return hi >= value
        if op == "==":
            return lo <= value <= hi
        if op == "!=":
            return not (lo == hi == value)
        if op == "in":
            return any(lo <= v <= hi for v in value if v is not None)
    except TypeError:
        return True  # incomparable stat/literal types: cannot prune
    return True


def prune_row_groups(pf: ParquetFile, predicates: Sequence[Predicate]
                     ) -> List[int]:
    """Row-group indices that may contain matching rows."""
    if not predicates:
        return list(range(pf.num_row_groups))
    keep: List[int] = []
    for rg in range(pf.num_row_groups):
        n = pf.row_groups[rg]["num_rows"]
        ok = True
        for name, op, value in predicates:
            ci = pf.index.get(name)
            if ci is None:
                continue
            if not _stat_keep(pf.statistics(rg, ci), op, value, n):
                ok = False
                break
        if ok:
            keep.append(rg)
    return keep


# ---------------------------------------------------------------------------------
# Decoded tables
# ---------------------------------------------------------------------------------

class _RawColumn:
    """A decoded column of a batch in the making: ``data`` (numbers, zeros
    under nulls) or ``dictionary`` + ``codes`` (strings: ascending distinct
    values and each row's index, 0 under nulls), and ``valid``."""

    __slots__ = ("dtype", "data", "dictionary", "codes", "valid")

    def __init__(self, dtype, valid, data=None, dictionary=None, codes=None):
        self.dtype = dtype
        self.valid = valid
        self.data = data
        self.dictionary = dictionary
        self.codes = codes

    @classmethod
    def from_chunk(cls, leaf: _Leaf, chunk) -> "_RawColumn":
        n, valid = chunk.n, chunk.valid
        if leaf.dtype.is_string:
            codes = chunk.codes
            if valid is not None:
                codes = np.zeros(n, dtype=np.int32)
                codes[valid] = chunk.codes
            return cls(leaf.dtype, valid, dictionary=chunk.dictionary,
                       codes=codes)
        vals = chunk.values
        np_dt = leaf.dtype.numpy_dtype
        if leaf.dtype == T.TIMESTAMP and leaf.unit != "us":
            vals = vals * 1000 if leaf.unit == "ms" else vals // 1000
        if valid is None:
            data = vals.astype(np_dt, copy=False)
        else:
            data = np.zeros(n, dtype=np_dt)
            data[valid] = vals
        return cls(leaf.dtype, valid, data=data)

    @classmethod
    def constant(cls, dtype, value, n: int) -> "_RawColumn":
        """A partition column: one value (or null) in every row."""
        valid = None if value is not None else np.zeros(n, dtype=bool)
        if dtype.is_string:
            d = np.empty(1, dtype=object)
            d[0] = "" if value is None else value
            return cls(dtype, valid, dictionary=d,
                       codes=np.zeros(n, dtype=np.int32))
        return cls(dtype, valid, data=np.full(n, 0 if value is None
                                              else value,
                                              dtype=dtype.numpy_dtype))

    def __len__(self):
        return len(self.data if self.data is not None else self.codes)

    def take(self, rows) -> "_RawColumn":
        valid = None if self.valid is None else self.valid[rows]
        if self.data is not None:
            return _RawColumn(self.dtype, valid, data=self.data[rows])
        return _RawColumn(self.dtype, valid, dictionary=self.dictionary,
                          codes=self.codes[rows])

    @staticmethod
    def concat(parts: List["_RawColumn"]) -> "_RawColumn":
        if len(parts) == 1:
            return parts[0]
        first = parts[0]
        valid = None
        if any(p.valid is not None for p in parts):
            valid = np.concatenate([np.ones(len(p), dtype=bool)
                                    if p.valid is None else p.valid
                                    for p in parts])
        if first.data is not None:
            return _RawColumn(first.dtype, valid, data=np.concatenate(
                [p.data for p in parts]))
        dicts = [p.dictionary for p in parts]
        if all(len(d) == len(dicts[0]) and (d is dicts[0] or (
                d == dicts[0]).all()) for d in dicts[1:]):
            return _RawColumn(first.dtype, valid, dictionary=dicts[0],
                              codes=np.concatenate([p.codes for p in parts]))
        # distinct dictionaries: merge them (fixed-width unicode sorts in C)
        allv = np.concatenate(dicts)
        uniq, inverse = np.unique(allv.astype(str), return_inverse=True)
        merged = np.empty(len(uniq), dtype=object)
        merged[:] = uniq.tolist()
        inverse = inverse.reshape(-1).astype(np.int32)
        codes, at = [], 0
        for p in parts:
            codes.append(inverse[at:at + len(p.dictionary)][p.codes]
                         if len(p.dictionary) else p.codes)
            at += len(p.dictionary)
        return _RawColumn(first.dtype, valid, dictionary=merged,
                          codes=np.concatenate(codes))

    def _literal(self, v):
        """``v`` as a value of this column's physical data, or raise
        TypeError where the compare is not exact (the reference's pyarrow
        kernels reject it)."""
        dt = self.dtype
        if dt.is_string:
            if not isinstance(v, str):
                raise TypeError(v)
            return v
        if isinstance(v, str) or v is None:
            raise TypeError(v)
        if dt == T.DATE:
            if isinstance(v, datetime.datetime) \
                    or not isinstance(v, datetime.date):
                raise TypeError(v)
            return (v - _EPOCH).days
        if dt == T.TIMESTAMP:
            if not isinstance(v, datetime.datetime):
                raise TypeError(v)
            return int((v.replace(tzinfo=None) - _EPOCH_DT)
                       // datetime.timedelta(microseconds=1))
        if isinstance(v, (datetime.date, datetime.datetime)):
            raise TypeError(v)
        return v

    def compare(self, op: str, value) -> np.ndarray:
        """Bool mask: rows where (column op value) is true (a null row is
        never true)."""
        n = len(self)
        if op == "isnotnull":
            return np.ones(n, dtype=bool) if self.valid is None \
                else self.valid.copy()
        if op == "in":
            vals = [self._literal(v) for v in value if v is not None]
            if self.data is not None:
                kinds = {np.asarray(vals).dtype.kind} if vals else set()
                if self.dtype.is_integral and kinds - {"i", "u", "b"}:
                    raise TypeError(vals)
                hit = np.isin(self.data, np.asarray(vals)) if vals \
                    else np.zeros(n, dtype=bool)
            else:
                hit = np.isin(self.dictionary, np.asarray(vals, dtype=object)
                              )[self.codes] if vals and len(self.dictionary) \
                    else np.zeros(n, dtype=bool)
        else:
            fn = {"<": _op.lt, "<=": _op.le, ">": _op.gt, ">=": _op.ge,
                  "==": _op.eq}[op]
            v = self._literal(value)
            if self.data is not None:
                hit = np.asarray(fn(self.data, v), dtype=bool)
            elif len(self.dictionary):
                hit = np.fromiter((fn(s, v) for s in self.dictionary),
                                  dtype=bool, count=len(self.dictionary)
                                  )[self.codes]
            else:
                hit = np.zeros(n, dtype=bool)
        return hit if self.valid is None else hit & self.valid

    def host_column(self):
        """The column as the scan hands it on: ``(data, valid)`` numpy for
        a device column, a ``HostStringColumn`` for strings (its distinct
        live values and their row indices set from the dictionary)."""
        if self.data is not None:
            return (np.ascontiguousarray(self.data), self.valid)
        d = self.dictionary
        live = self.codes if self.valid is None else self.codes[self.valid]
        present = np.bincount(live, minlength=len(d)) > 0 if len(d) \
            else np.zeros(0, dtype=bool)
        rank = np.cumsum(present) - 1
        data = d[self.codes] if len(d) else np.empty(len(self.codes), object)
        if self.valid is not None:
            data[~self.valid] = None
        col = HostStringColumn(data, self.valid)
        col._distinct = (d[present], rank[live])
        return col


class HostTable:
    """One decoded, filtered batch of a file scan: ``columns`` in schema
    order, each ``(data, valid)`` numpy or a ``HostStringColumn``.  The
    scan caches pinned host copies on it (``pinned``), so a table served
    again by the file cache is not pinned again."""

    def __init__(self, schema: Schema, columns: list, num_rows: int):
        self.schema = schema
        self.columns = columns
        self.num_rows = num_rows
        self.pinned: dict = {}

    @property
    def nbytes(self) -> int:
        total = 0
        for c in self.columns:
            if isinstance(c, tuple):
                total += c[0].nbytes + (0 if c[1] is None else c[1].nbytes)
            else:
                total += c.data.nbytes
        return total


def _exact_filter_mask(table: Dict[str, _RawColumn],
                       predicates: Sequence[Predicate]):
    """Kleene-AND mask of the pushed conjuncts over a decoded table, or
    None when any conjunct cannot be applied exactly (an unknown column, an
    op other than < <= > >= == in isnotnull, a literal of another type)."""
    mask = None
    for name, op, value in predicates:
        col = table.get(name)
        if col is None or op not in ("<", "<=", ">", ">=", "==", "in",
                                     "isnotnull"):
            return None
        try:
            m = col.compare(op, value)
        except (TypeError, ValueError):
            return None
        mask = m if mask is None else mask & m
    return mask


# ---------------------------------------------------------------------------------
# The source
# ---------------------------------------------------------------------------------

class ParquetSource(FileSource):
    """A rebuildable parquet scan source.  The planner calls
    :meth:`with_pushdown` to narrow columns and attach predicates; calling
    the instance yields :class:`HostTable` batches (decoded ahead on the
    prefetch thread of ``FileSource``), which ``ScanExec`` uploads."""

    fmt = "parquet"

    def __init__(self, path, columns: Optional[List[str]] = None,
                 predicates: Optional[List[Predicate]] = None,
                 batch_rows: int = 1 << 20, num_threads: int = 8,
                 cache_bytes: int = 0, exact_filter: bool = True,
                 _paths: Optional[List[str]] = None,
                 partitions: Optional[tuple] = None,
                 _skip_rows: Optional[dict] = None,
                 _rename: Optional[dict] = None,
                 _anti_rows: Optional[dict] = None):
        if _skip_rows or _rename or _anti_rows:
            raise NotImplementedError(
                "deletion vectors, column renames and equality deletes of "
                "a parquet scan are not ported yet (ROADMAP.md item 9)")
        super().__init__(path, _paths if _paths is not None
                         else expand_paths(path), columns, predicates,
                         batch_rows, num_threads)
        self._partitions = partitions
        if partitions is not None:
            self.part_names, self._part_vals = partitions
        else:
            self.part_names, self._part_vals = hive_partition_values(
                path, self.paths)
        self._part_types = {
            n: _infer_partition_type([self._part_vals[p].get(n)
                                      for p in self.paths])
            for n in self.part_names}
        self._part_nullable = {
            n: any(self._part_vals[p].get(n) is None for p in self.paths)
            for n in self.part_names}
        self.cache_bytes = cache_bytes
        self.exact_filter = exact_filter
        # row groups of the read files that pruning kept, and their total
        self.row_groups_kept = 0
        self.row_groups_total = 0

    def schema(self) -> Schema:
        file_cols = None
        if self.columns is not None:
            file_cols = [c for c in self.columns if c not in self.part_names]
        sch = parquet_schema(self.paths, file_cols)
        if not self.part_names:
            return sch
        logical = {"int64": T.INT64, "float64": T.FLOAT64, "string": T.STRING}
        fields = list(sch.fields)
        for n in self.part_names:  # Spark appends partition cols at the end
            if self.columns is None or n in self.columns:
                fields.append(Field(n, logical[self._part_types[n]],
                                    self._part_nullable[n]))
        return Schema(fields)

    def with_pushdown(self, columns: Optional[List[str]],
                      predicates: Optional[List[Predicate]]
                      ) -> "ParquetSource":
        cols = self.columns
        if columns is not None:
            # preserve file order; never widen beyond the current projection
            base = self.columns if self.columns is not None else \
                self.schema().names()
            cols = [c for c in base if c in set(columns)]
        preds = self.predicates + [p for p in (predicates or [])
                                   if p not in self.predicates]
        return ParquetSource(self.path, cols, preds, self.batch_rows,
                             self.num_threads, self.cache_bytes,
                             self.exact_filter, _paths=self.paths,
                             partitions=self._partitions)

    def estimated_rows(self) -> Optional[int]:
        """Row count from the footers (after partition pruning of the file
        list; predicates not modeled): the planner's cardinality source.
        Memoized per source."""
        cached = getattr(self, "_est_rows", False)
        if cached is not False:
            return cached
        try:
            total = sum(open_file(p).num_rows for p in self.paths)
        except (OSError, ValueError):
            total = None
        self._est_rows = total
        return total

    def cache_token(self) -> Optional[tuple]:
        """Identity of this scan's output for the device-tier cache: files
        (path, mtime, size), projection and pushed predicates."""
        files = []
        for p in self.paths:
            try:
                st = os.stat(p)
            except OSError:
                return None
            files.append((os.path.abspath(p), st.st_mtime_ns, st.st_size))
        cols = tuple(self.columns) if self.columns is not None else None
        preds = tuple((n, op, str(v)) for n, op, v in self.predicates)
        return (tuple(files), cols, preds, self.batch_rows,
                self.exact_filter)

    # -- reading ------------------------------------------------------------------
    def _typed_part_value(self, name: str, raw):
        if raw is None:
            return None
        t = self._part_types.get(name, "string")
        if t == "int64":
            return int(raw)
        if t == "float64":
            return float(raw)
        return raw

    def _partition_match(self, path: str, preds) -> bool:
        """File-level partition pruning: skip files whose ``key=value``
        path components cannot satisfy a pushed conjunct."""
        cmp = {"<": _op.lt, "<=": _op.le, ">": _op.gt, ">=": _op.ge,
               "==": _op.eq, "!=": _op.ne}
        kv = self._part_vals.get(path, {})
        for name, op, value in preds:
            if name not in kv:
                continue
            pv = self._typed_part_value(name, kv[name])
            if pv is None:
                return False
            try:
                if op == "in":
                    if pv not in value:
                        return False
                elif op == "isnotnull":
                    continue
                elif op in cmp and not cmp[op](pv, value):
                    return False
            except TypeError:
                continue
        return True

    def _groups(self, pf: ParquetFile, rgs: List[int], names: List[str]
                ) -> Iterator[Dict[str, _RawColumn]]:
        """The kept row groups of one file, decoded column by column."""
        with open(pf.path, "rb") as f:
            for rg in rgs:
                yield {n: _RawColumn.from_chunk(
                    pf.leaves[pf.index[n]],
                    pf.read_column(f, rg, pf.index[n])) for n in names}

    def _batches(self, groups: Iterator[Dict[str, _RawColumn]],
                 names: List[str]) -> Iterator[Dict[str, _RawColumn]]:
        """The row groups' rows as one stream cut every ``batch_rows``
        rows (a batch may span row groups; the last one is short)."""
        pending: List[Dict[str, _RawColumn]] = []
        have = 0
        for g in groups:
            n = len(g[names[0]]) if names else 0
            pending.append(g)
            have += n
            while have >= self.batch_rows:
                out, rest, need = [], [], self.batch_rows
                for p in pending:
                    m = len(p[names[0]])
                    if need >= m:
                        out.append(p)
                        need -= m
                    elif need > 0:
                        out.append({k: c.take(slice(0, need))
                                    for k, c in p.items()})
                        rest.append({k: c.take(slice(need, m))
                                     for k, c in p.items()})
                        need = 0
                    else:
                        rest.append(p)
                yield {k: _RawColumn.concat([p[k] for p in out])
                       for k in names}
                pending = rest
                have -= self.batch_rows
        if have:
            yield {k: _RawColumn.concat([p[k] for p in pending])
                   for k in names}

    def _read_file(self, path: str) -> Iterator[HostTable]:
        part_kv = self._part_vals.get(path, {})
        file_preds = [p for p in self.predicates
                      if p[0] not in self.part_names]
        if not self._partition_match(path, self.predicates):
            return
        cache = None
        key = None
        if self.cache_bytes > 0:
            from .filecache import FileCache, get_file_cache
            cache = get_file_cache(self.cache_bytes)
        pf = open_file(path)
        rgs = prune_row_groups(pf, file_preds)
        self.row_groups_kept += len(rgs)
        self.row_groups_total += pf.num_row_groups
        pred_key = tuple((n, op, str(v)) for n, op, v in file_preds) \
            if (self.exact_filter and file_preds) else None
        part_cols = [(n, self._typed_part_value(n, part_kv.get(n)))
                     for n in self.part_names
                     if self.columns is None or n in self.columns]
        if cache is not None:
            key = FileCache.key_for(path, self.columns, rgs)
            if key is not None and pred_key is not None:
                key = key + (pred_key,)
            if key is not None:
                hit = cache.get(key)
                if hit is not None:
                    yield from hit
                    return
        if not rgs:
            return
        schema = self.schema()
        file_cols = [f.name for f in schema if f.name not in self.part_names]
        logical = {"int64": T.INT64, "float64": T.FLOAT64, "string": T.STRING}
        acc = [] if (cache is not None and key is not None) else None
        for raw in self._batches(self._groups(pf, rgs, file_cols), file_cols):
            n = len(raw[file_cols[0]]) if file_cols else 0
            for name, v in part_cols:
                raw[name] = _RawColumn.constant(
                    logical[self._part_types[name]], v, n)
            if self.exact_filter and file_preds:
                mask = _exact_filter_mask(raw, file_preds)
                if mask is not None:
                    raw = {k: c.take(mask) for k, c in raw.items()}
                    n = int(mask.sum())
                    if n == 0:
                        continue
            t = HostTable(schema, [raw[f.name].host_column()
                                   for f in schema], n)
            if acc is not None:
                acc.append(t)
            yield t
        if acc is not None:
            cache.put(key, acc)

    def _read_all(self) -> Iterator[HostTable]:
        for p in self.paths:
            yield from self._read_file(p)


def parquet_source(path, columns: Optional[List[str]] = None,
                   batch_rows: int = 1 << 20,
                   filters=None) -> Tuple[Schema, Callable[[], Iterator]]:
    """(schema, source) of a parquet scan."""
    src = ParquetSource(path, columns=columns, batch_rows=batch_rows,
                        predicates=filters)
    return src.schema(), src
