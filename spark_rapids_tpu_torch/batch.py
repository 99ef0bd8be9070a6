"""Columnar batch: the device-resident data model.

Counterpart of ``spark_rapids_tpu/batch.py``.  Device columns are torch
tensors on the session's device.  The reference pads every batch to a
power-of-two capacity bucket because XLA compiles one program per shape;
PyTorch runs eagerly, so a port batch holds exactly ``num_rows`` rows.  The
``(num_rows, sel)`` contract stays: ``sel`` is an optional bool mask of live
rows that filters narrow instead of moving data.

Nulls are bool validity masks (True = valid); ``valid=None`` means no nulls.
Strings have no device representation: they ride as host columns
(:class:`HostStringColumn`) and group on the device as int32 dictionary
codes (``ops/strings.py``).  Decimals are scaled integers: an int64 column
for precision <= 18, an int64 ``[n, 2]`` limb column ``[lo, hi]`` above
(reference ``batch.py:444-455``, ``:509 wide_decimal_limbs``).  The host
side is numpy only: the port takes its input as the dict of numpy arrays
that the reference's ``Session.create_dataframe`` is given
(:func:`from_numpy`); a decimal column comes as an object array of
``decimal.Decimal`` (typed as pyarrow infers it) or as a
:class:`DecimalArray`, the port's stand-in for a pyarrow ``decimal128``
array.  A list column (ARRAY<element>) comes as an object array of Python
lists and None (what the reference's ``pa.table`` turns into an arrow list
array) or as a :class:`ListArray` (offsets and flat values, the port's
stand-in for a ``pa.ListArray``), and rides on the host as a
:class:`HostListColumn`.
"""

from __future__ import annotations

import datetime
import decimal
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import types as T
from .types import DataType

__all__ = ["Field", "Schema", "DeviceColumn", "HostColumn",
           "HostStringColumn", "HostListColumn", "DictStringColumn",
           "ColumnBatch", "DecimalArray", "ListArray", "numpy_column",
           "live_mask", "upload", "from_numpy", "to_host", "wide_limbs",
           "limbs_to_ints", "decimal_values"]


@dataclass(frozen=True)
class Field:
    name: str
    dtype: DataType
    nullable: bool = True


class Schema:
    def __init__(self, fields: Sequence[Field]):
        self.fields = list(fields)
        self._index = {f.name: i for i, f in enumerate(self.fields)}
        if len(self._index) != len(self.fields):
            raise ValueError(f"duplicate column names in {self.names()}")

    @classmethod
    def pair(cls, left: "Schema", right: "Schema") -> "Schema":
        """The left side's fields then the right side's, as a join
        condition binds them: a name both sides carry (a USING key)
        resolves to the left side's."""
        out = cls.__new__(cls)
        out.fields = list(left.fields) + list(right.fields)
        out._index = {}
        for i, f in enumerate(out.fields):
            out._index.setdefault(f.name, i)
        return out

    def __len__(self):
        return len(self.fields)

    def __iter__(self):
        return iter(self.fields)

    def index_of(self, name: str) -> int:
        return self._index[name]

    def names(self) -> List[str]:
        return [f.name for f in self.fields]

    def __repr__(self):
        inner = ", ".join(f"{f.name}: {f.dtype}" for f in self.fields)
        return f"Schema({inner})"


@dataclass
class DeviceColumn:
    """One column resident on the device: ``data`` and an optional bool
    ``valid`` mask of the same length."""

    dtype: DataType
    data: torch.Tensor
    valid: Optional[torch.Tensor] = None


class HostColumn:
    """A column resident on the host as numpy: strings, and the rows a CPU
    operator produced.  ``data`` holds zero (or None for strings) at null
    slots; ``valid`` is a bool mask or None."""

    def __init__(self, dtype: DataType, data: np.ndarray,
                 valid: Optional[np.ndarray] = None):
        self.dtype = dtype
        self.data = data
        self.valid = valid


class HostStringColumn(HostColumn):
    """A string column on the host.  The dictionary encoding of a column is
    cached on the object (``_enc_cache``), as the reference caches it
    (``plan/physical.py:2061 _encode_string_keys``): the in-memory scan hands
    out the same column objects on every run, so warm runs skip the host
    encode and the code upload."""

    def __init__(self, data: np.ndarray, valid: Optional[np.ndarray] = None):
        super().__init__(T.STRING, data, valid)
        self._enc_cache = None


class ListArray:
    """A list column in numpy, with no pyarrow: int64 ``offsets`` ``[n + 1]``
    into the flat element ``values`` (list i holds ``values[offsets[i]:
    offsets[i + 1]]``), an optional bool ``elem_valid`` per element and an
    optional bool ``valid`` per list (True = valid), and the ``element``
    type (inferred from ``values`` when not given).  Indexing with a slice,
    a bool mask or an index array gives the selected lists as a new
    ``ListArray``; a slice shares ``values`` (its offsets stay absolute)."""

    def __init__(self, offsets: np.ndarray, values: np.ndarray,
                 valid: Optional[np.ndarray] = None,
                 elem_valid: Optional[np.ndarray] = None,
                 element: Optional[DataType] = None):
        self.offsets = np.ascontiguousarray(offsets, dtype=np.int64)
        self.values = values
        self.valid = None if valid is None else np.asarray(valid, bool)
        self.elem_valid = None if elem_valid is None \
            else np.asarray(elem_valid, bool)
        if element is None and values.dtype.kind not in "OMU":
            element = numpy_column(values)[0]
        # None until typed from the values (batch.numpy_column)
        self.element = element
        if self.offsets.ndim != 1 or len(self.offsets) == 0:
            raise ValueError("offsets are int64 [n + 1]")

    def __len__(self) -> int:
        return len(self.offsets) - 1

    def __getitem__(self, idx) -> "ListArray":
        valid = None if self.valid is None else self.valid[idx]
        if isinstance(idx, slice):
            lo, hi, step = idx.indices(len(self))
            if step != 1:
                raise ValueError("list columns slice with step 1")
            return ListArray(self.offsets[lo:max(hi, lo) + 1], self.values,
                             valid, self.elem_valid, self.element)
        rows = np.asarray(idx)
        if rows.dtype == bool:
            rows = np.flatnonzero(rows)
        starts = self.offsets[:-1][rows]
        lens = self.offsets[1:][rows] - starts
        offsets = np.zeros(len(rows) + 1, dtype=np.int64)
        np.cumsum(lens, out=offsets[1:])
        at = np.repeat(starts - offsets[:-1], lens) \
            + np.arange(offsets[-1], dtype=np.int64)
        return ListArray(offsets, self.values[at], valid,
                         None if self.elem_valid is None
                         else self.elem_valid[at], self.element)

    def to_pylist(self, values) -> list:
        """Python lists (None for a null list) whose elements come from
        ``values``, the flat elements as Python values (None for a null
        element)."""
        out = []
        ok = None if self.valid is None else self.valid.tolist()
        offs = self.offsets.tolist()
        for i in range(len(self)):
            if ok is not None and not ok[i]:
                out.append(None)
            else:
                out.append(values[offs[i]:offs[i + 1]])
        return out


class HostListColumn(HostColumn):
    """An ARRAY column on the host: ``data`` is a :class:`ListArray`
    (offsets, flat values, element validity; a null list has no elements)
    and ``valid`` the list validity, as the reference carries an arrow
    list array in a host column.  What an explode reads of it (the output
    starts and the flat elements, in pinned memory for a CUDA upload) is
    cached on the object (``_explode_cache``): the in-memory scan hands
    out the same column objects on every run."""

    def __init__(self, data: ListArray, valid: Optional[np.ndarray] = None):
        super().__init__(T.array(data.element), data, valid)
        self._explode_cache = None


class DictStringColumn:
    """A string column carried as device int32 dictionary codes plus the
    host dictionary values; decoded to strings where rows reach the host
    (:func:`to_host`)."""

    dtype = T.STRING

    def __init__(self, codes: torch.Tensor, valid: Optional[torch.Tensor],
                 dictionary: np.ndarray):
        self.codes = codes
        self.valid = valid
        self.dictionary = dictionary


Column = Union[DeviceColumn, HostColumn, DictStringColumn]


class ColumnBatch:
    """A batch of rows: columns plus row accounting.  Live rows are all of
    ``num_rows`` rows where ``sel`` is None, else those where ``sel`` is
    True."""

    def __init__(self, schema: Schema, columns: Sequence[Column],
                 num_rows: int, sel: Optional[torch.Tensor] = None):
        if len(schema) != len(columns):
            raise ValueError("schema and columns differ in length")
        self.schema = schema
        self.columns = list(columns)
        self.num_rows = int(num_rows)
        self.sel = sel

    def active_mask(self, device: torch.device) -> torch.Tensor:
        """Bool [num_rows] mask of live rows, on ``device``."""
        if self.sel is not None:
            return self.sel
        return torch.ones(self.num_rows, dtype=torch.bool, device=device)

    def column(self, name: str) -> Column:
        return self.columns[self.schema.index_of(name)]

    def __repr__(self):
        sel = ", sel" if self.sel is not None else ""
        return f"ColumnBatch(rows={self.num_rows}{sel}, schema={self.schema})"


# ---------------------------------------------------------------------------------
# Host numpy -> logical columns
# ---------------------------------------------------------------------------------

class DecimalArray:
    """A decimal column in numpy: ``unscaled`` int64 ``[n]`` (any
    precision) or int64 limbs ``[n, 2]`` ``[lo, hi]`` of the scaled 128-bit
    two's-complement value (18 < precision <= 38), with ``precision``,
    ``scale`` and an optional bool ``valid`` mask (True = valid).  The
    unscaled value of row i is the decimal times 10^scale."""

    def __init__(self, unscaled: np.ndarray, precision: int, scale: int,
                 valid: Optional[np.ndarray] = None):
        self.dtype = T.decimal(precision, scale)
        unscaled = np.asarray(unscaled, dtype=np.int64)
        if unscaled.ndim == 2 and (unscaled.shape[1] != 2
                                   or not self.dtype.is_wide_decimal):
            raise ValueError("limbs are [n, 2] and need precision > 18")
        if self.dtype.is_wide_decimal and unscaled.ndim == 1:
            unscaled = np.stack([unscaled, unscaled >> 63], axis=1)
        self.unscaled = np.ascontiguousarray(unscaled)
        self.valid = None if valid is None else np.asarray(valid, bool)

    def __len__(self) -> int:
        return self.unscaled.shape[0]


def wide_limbs(values) -> np.ndarray:
    """Python ints (the unscaled values) → ``[n, 2]`` int64 limbs, each
    taken modulo 2^128."""
    out = np.zeros((len(values), 2), dtype=np.int64)
    for i, v in enumerate(values):
        u = int(v) & ((1 << 128) - 1)
        out[i] = [x - (1 << 64) if x >= (1 << 63) else x
                  for x in (u & ((1 << 64) - 1), u >> 64)]
    return out


def limbs_to_ints(data: np.ndarray) -> List[int]:
    """``[n, 2]`` int64 limbs → exact Python ints."""
    lo = data[:, 0].astype(object) & ((1 << 64) - 1)
    return list((data[:, 1].astype(object) << 64) + lo)


def decimal_values(dtype: DataType, data: np.ndarray) -> list:
    """The unscaled int64 (or limb) values of a decimal column as
    ``decimal.Decimal`` objects."""
    ints = limbs_to_ints(data) if data.ndim == 2 else data.tolist()
    return [decimal.Decimal(int(x)).scaleb(-dtype.scale) for x in ints]


def _infer_decimal(values) -> DataType:
    """pyarrow's decimal128 inference: the widest scale, and the most
    integer digits of any value."""
    scale = int_digits = 0
    for v in values:
        _, digits, exp = v.as_tuple()
        if exp >= 0:
            p, s = len(digits) + exp, 0
        else:
            s = -exp
            p = max(len(digits), s)
        scale = max(scale, s)
        int_digits = max(int_digits, p - s)
    return T.decimal(int_digits + scale, scale)


_NUMPY_TO_LOGICAL = {
    np.dtype(np.bool_): T.BOOLEAN, np.dtype(np.int8): T.INT8,
    np.dtype(np.int16): T.INT16, np.dtype(np.int32): T.INT32,
    np.dtype(np.int64): T.INT64, np.dtype(np.float32): T.FLOAT32,
    np.dtype(np.float64): T.FLOAT64,
}
_EPOCH = datetime.date(1970, 1, 1)


def _object_column(arr: np.ndarray) -> Tuple[DataType, np.ndarray,
                                             Optional[np.ndarray]]:
    """An object array with None for nulls, typed as pyarrow would infer
    it (str → string, bool → boolean, int → bigint, float or a mix of int
    and float → double, datetime.date → date, decimal.Decimal → decimal of
    the inferred precision and scale)."""
    valid = np.fromiter((x is not None for x in arr), dtype=bool,
                        count=len(arr))
    kinds = {type(x) for x in arr[valid]}
    if kinds and kinds <= {list, tuple, np.ndarray}:
        return _list_column(arr, valid)
    if kinds and kinds <= {decimal.Decimal}:
        dt = _infer_decimal(arr[valid])
        ints = [int(x.scaleb(dt.scale)) if ok else 0
                for x, ok in zip(arr, valid)]
        data = wide_limbs(ints) if dt.is_wide_decimal \
            else np.array(ints, dtype=np.int64)
        return dt, data, (None if valid.all() else valid)
    if kinds <= {str}:
        data = arr.copy()
        data[~valid] = None
        return T.STRING, data, (None if valid.all() else valid)
    if kinds <= {bool, np.bool_}:
        dt, fill = T.BOOLEAN, False
    elif kinds <= {int, np.int64}:
        dt, fill = T.INT64, 0
    elif kinds <= {int, float, np.int64, np.float64}:
        dt, fill = T.FLOAT64, 0.0
    elif kinds <= {datetime.date}:
        dt, fill = T.DATE, _EPOCH
    else:
        raise TypeError(
            f"cannot infer a column type from {sorted(map(str, kinds))}")
    filled = np.where(valid, arr, fill)
    if dt == T.DATE:
        data = np.array([(d - _EPOCH).days for d in filled], dtype=np.int32)
    else:
        data = filled.astype(dt.numpy_dtype)
    return dt, data, (None if valid.all() else valid)


def _list_column(arr: np.ndarray, valid: np.ndarray):
    """An object array of lists and None → (ARRAY type, ListArray, list
    validity), the element type inferred from the elements as pyarrow
    infers it."""
    lens = np.fromiter((len(x) if ok else 0 for x, ok in zip(arr, valid)),
                       dtype=np.int64, count=len(arr))
    flat = np.empty(int(lens.sum()), dtype=object)
    at = 0
    for x, ok in zip(arr, valid):
        if ok:
            flat[at:at + len(x)] = list(x)
            at += len(x)
    if any(isinstance(x, (list, tuple, np.ndarray)) for x in flat):
        raise TypeError("nested arrays are not ported (ROADMAP.md item 8)")
    offsets = np.zeros(len(arr) + 1, dtype=np.int64)
    np.cumsum(lens, out=offsets[1:])
    return _normalized(ListArray(offsets, flat, valid), valid)


def _normalized(arr: ListArray, valid: Optional[np.ndarray]):
    """(ARRAY type, the lists rebased to offset 0 with typed element values,
    zeros at null elements and no elements under a null list, list
    validity or None)."""
    offsets = arr.offsets - arr.offsets[0]
    lo, hi = int(arr.offsets[0]), int(arr.offsets[-1])
    values = arr.values[lo:hi]
    ev = None if arr.elem_valid is None else arr.elem_valid[lo:hi]
    if valid is not None and (np.diff(offsets)[~valid] != 0).any():
        keep = np.repeat(valid, np.diff(offsets))
        values = values[keep]
        ev = None if ev is None else ev[keep]
        offsets = np.zeros(len(valid) + 1, dtype=np.int64)
        np.cumsum(np.where(valid, np.diff(arr.offsets), 0), out=offsets[1:])
    elem = arr.element
    if values.dtype.kind in "OMU" and not (elem is not None
                                           and elem.is_nested):
        if values.dtype.kind == "O" and all(x is None for x in values):
            # no value to type the elements by: pyarrow's null type
            elem = elem or T.NULLTYPE
            ev = np.zeros(len(values), dtype=bool)
            if not elem.is_host_carried:
                values = np.zeros(len(values), dtype=elem.numpy_dtype)
        else:
            dt, values, vv = numpy_column(values)
            if elem is None or elem.is_decimal:
                elem = dt
            elif not elem.is_host_carried:
                values = values.astype(elem.numpy_dtype)
            if vv is not None:
                ev = vv if ev is None else ev & vv
    if not elem.is_host_carried and not elem.is_decimal \
            and values.dtype != elem.numpy_dtype:
        values = values.astype(elem.numpy_dtype)
    if ev is not None and not elem.is_host_carried:
        values = np.where(ev if values.ndim == 1 else ev[:, None], values,
                          0).astype(values.dtype)
    if ev is not None and ev.all():
        ev = None
    ok = None if valid is None or valid.all() else valid
    return T.array(elem), ListArray(offsets, values, None, ev, elem), ok


def numpy_column(arr) -> Tuple[DataType, np.ndarray, Optional[np.ndarray]]:
    """One numpy input column → (logical type, physical data, valid).

    ``datetime64[D]`` becomes int32 days (date32), ``datetime64[us]``
    int64 microseconds; unicode arrays stay host strings; a
    :class:`DecimalArray` keeps its type and unscaled values; a
    :class:`ListArray` (or an object array of lists) becomes the typed
    lists and their validity."""
    if isinstance(arr, ListArray):
        return _normalized(ListArray(arr.offsets, arr.values, None,
                                     arr.elem_valid, arr.element),
                           arr.valid)
    if isinstance(arr, DecimalArray):
        valid = arr.valid
        data = arr.unscaled
        if valid is not None:
            fill = valid if data.ndim == 1 else valid[:, None]
            data = np.where(fill, data, 0)
        return arr.dtype, data, (None if valid is None or valid.all()
                                 else valid)
    arr = np.asarray(arr)
    if arr.dtype.kind == "U":
        return T.STRING, arr, None
    if arr.dtype.kind == "O":
        return _object_column(arr)
    if arr.dtype.kind == "M":
        unit = np.datetime_data(arr.dtype)[0]
        if unit == "D":
            return T.DATE, arr.astype(np.int64).astype(np.int32), None
        return (T.TIMESTAMP,
                arr.astype("datetime64[us]").astype(np.int64), None)
    dt = _NUMPY_TO_LOGICAL.get(arr.dtype)
    if dt is None:
        raise TypeError(f"unsupported numpy dtype {arr.dtype}")
    return dt, np.ascontiguousarray(arr), None


def live_mask(n: int, valid: Optional[torch.Tensor],
              active: Optional[torch.Tensor], device) -> torch.Tensor:
    """Bool [n]: the rows that are live (``active``, None = all) and valid
    (``valid``, None = all)."""
    m = torch.ones(n, dtype=torch.bool, device=device) if active is None \
        else active
    return m if valid is None else m & valid


def upload(host: torch.Tensor, device: torch.device) -> torch.Tensor:
    """Host tensor → ``device``.  CUDA uploads copy from pinned memory with
    ``non_blocking=True``: the copy is queued on the current stream and the
    host moves on.  The pinned buffer comes from PyTorch's caching host
    allocator, which keeps it alive until the copy has run."""
    if device.type != "cuda":
        return host
    if not host.is_pinned():
        host = host.pin_memory()
    return host.to(device, non_blocking=True)


def from_numpy(columns: Dict[str, np.ndarray],
               device: Union[str, torch.device]) -> ColumnBatch:
    """The dict of numpy arrays given to the reference's
    ``create_dataframe`` → one port batch on ``device``."""
    device = torch.device(device)
    fields, cols, n = [], [], None
    for name, arr in columns.items():
        dt, data, valid = numpy_column(arr)
        if n is None:
            n = len(data)
        elif len(data) != n:
            raise ValueError(f"column {name!r} has {len(data)} rows, not {n}")
        fields.append(Field(name, dt, valid is not None))
        if dt.is_host_carried:
            cols.append(HostListColumn(data, valid) if dt.is_nested
                        else HostStringColumn(data, valid))
            continue
        dvalid = (None if valid is None
                  else upload(torch.from_numpy(valid), device))
        cols.append(DeviceColumn(dt, upload(torch.from_numpy(data), device),
                                 dvalid))
    return ColumnBatch(Schema(fields), cols, n or 0)


def to_host(batch: ColumnBatch) -> List[HostColumn]:
    """The live rows of ``batch`` as host columns, in ONE counted fetch
    (dictionary codes decode on the host)."""
    from .utils.metrics import fetch
    tree = {"sel": batch.sel, "cols": []}
    for col in batch.columns:
        if isinstance(col, DeviceColumn):
            tree["cols"].append((col.data, col.valid))
        elif isinstance(col, DictStringColumn):
            tree["cols"].append((col.codes, col.valid))
        else:
            tree["cols"].append(None)
    has_device = batch.sel is not None or any(
        c is not None for c in tree["cols"])
    host = fetch(tree) if has_device else tree
    keep = host["sel"]
    out: List[HostColumn] = []
    for col, fetched in zip(batch.columns, host["cols"]):
        if isinstance(col, HostColumn):
            data, valid = col.data[:batch.num_rows], col.valid
            valid = None if valid is None else valid[:batch.num_rows]
        else:
            data, valid = fetched
        if keep is not None:
            data = data[keep]
            valid = None if valid is None else valid[keep]
        if isinstance(col, DictStringColumn):
            ok = np.ones(len(data), dtype=bool) if valid is None else valid
            strings = np.empty(len(data), dtype=object)
            strings[ok] = col.dictionary[data[ok]]
            data = strings
        if col.dtype.is_string:
            out.append(HostStringColumn(data, valid))
        elif col.dtype.is_nested:
            out.append(HostListColumn(data, valid))
        else:
            out.append(HostColumn(col.dtype, data, valid))
    return out
