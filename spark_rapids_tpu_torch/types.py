"""Logical data types and the TypeSig support-signature algebra.

The port's own copy of ``spark_rapids_tpu/types.py`` (numpy only), cut to
the flat types the port executes.  Spark SQL logical types map onto
physical torch dtypes here.  STRING has no device representation: string
columns ride on the host and group on the device as int32 dictionary codes
(``ops/strings.py``).  DECIMAL(p, s) is the scaled integer: int64 for
p <= 18, and for 18 < p <= 38 two int64 limbs ``[lo, hi]`` of the 128-bit
two's-complement value, a ``[n, 2]`` device tensor (``ops/wide_decimal.py``).  ``TypeSig`` mirrors the reference's support-signature
algebra (TypeChecks.scala:171): each expression declares the input and
output types it supports on the device, and the planner tags unsupported
nodes with a reason.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Iterable, Optional

import numpy as np
import torch

__all__ = [
    "DataType", "TypeKind",
    "BOOLEAN", "INT8", "INT16", "INT32", "INT64",
    "FLOAT32", "FLOAT64", "STRING", "DATE", "TIMESTAMP",
    "NULLTYPE", "decimal", "integral_as_decimal", "common_type", "TypeSig",
]


class TypeKind(enum.Enum):
    BOOLEAN = "boolean"
    INT8 = "tinyint"
    INT16 = "smallint"
    INT32 = "int"
    INT64 = "bigint"
    FLOAT32 = "float"
    FLOAT64 = "double"
    STRING = "string"
    DATE = "date"              # days since epoch, int32 physical
    TIMESTAMP = "timestamp"    # microseconds since epoch, int64 physical
    DECIMAL = "decimal"        # scaled integer: int64, or two int64 limbs
    NULL = "void"


_NUMPY_PHYSICAL = {
    TypeKind.BOOLEAN: np.bool_,
    TypeKind.INT8: np.int8,
    TypeKind.INT16: np.int16,
    TypeKind.INT32: np.int32,
    TypeKind.INT64: np.int64,
    TypeKind.FLOAT32: np.float32,
    TypeKind.FLOAT64: np.float64,
    TypeKind.DATE: np.int32,
    TypeKind.TIMESTAMP: np.int64,
    TypeKind.DECIMAL: np.int64,
    TypeKind.NULL: np.bool_,
    # strings group on the device as int32 dictionary codes
    TypeKind.STRING: np.int32,
}

_TORCH_OF_NUMPY = {
    np.dtype(np.bool_): torch.bool, np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16, np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64, np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}


@dataclass(frozen=True)
class DataType:
    """A Spark-SQL-equivalent logical type; ``precision``/``scale`` are
    DECIMAL's.  The nested types of the reference are not ported yet
    (ROADMAP item 8)."""

    kind: TypeKind
    precision: int = 0
    scale: int = 0

    @property
    def is_numeric(self) -> bool:
        return self.kind in (
            TypeKind.INT8, TypeKind.INT16, TypeKind.INT32, TypeKind.INT64,
            TypeKind.FLOAT32, TypeKind.FLOAT64, TypeKind.DECIMAL,
        )

    @property
    def is_integral(self) -> bool:
        return self.kind in (
            TypeKind.INT8, TypeKind.INT16, TypeKind.INT32, TypeKind.INT64,
        )

    @property
    def is_floating(self) -> bool:
        return self.kind in (TypeKind.FLOAT32, TypeKind.FLOAT64)

    @property
    def is_string(self) -> bool:
        return self.kind == TypeKind.STRING

    @property
    def is_decimal(self) -> bool:
        return self.kind == TypeKind.DECIMAL

    @property
    def is_wide_decimal(self) -> bool:
        """DECIMAL with 18 < p <= 38: a ``[n, 2]`` int64 limb column."""
        return self.is_decimal and 18 < self.precision <= 38

    @property
    def is_host_carried(self) -> bool:
        """True if columns of this type ride as host columns in device
        batches (no device representation)."""
        return self.is_string

    @property
    def numpy_dtype(self):
        return np.dtype(_NUMPY_PHYSICAL[self.kind])

    @property
    def torch_dtype(self) -> torch.dtype:
        return _TORCH_OF_NUMPY[self.numpy_dtype]

    def __str__(self) -> str:
        if self.is_decimal:
            return f"decimal({self.precision},{self.scale})"
        return self.kind.value


BOOLEAN = DataType(TypeKind.BOOLEAN)
INT8 = DataType(TypeKind.INT8)
INT16 = DataType(TypeKind.INT16)
INT32 = DataType(TypeKind.INT32)
INT64 = DataType(TypeKind.INT64)
FLOAT32 = DataType(TypeKind.FLOAT32)
FLOAT64 = DataType(TypeKind.FLOAT64)
STRING = DataType(TypeKind.STRING)
DATE = DataType(TypeKind.DATE)
TIMESTAMP = DataType(TypeKind.TIMESTAMP)
NULLTYPE = DataType(TypeKind.NULL)


def decimal(precision: int, scale: int) -> DataType:
    """DECIMAL(precision, scale): int64 for p <= 18, two int64 limbs for
    18 < p <= 38."""
    if not 1 <= precision <= 38 or not 0 <= scale <= precision:
        raise TypeError(f"decimal({precision},{scale}) is out of range")
    return DataType(TypeKind.DECIMAL, precision, scale)


_INT_WIDENING = [TypeKind.INT8, TypeKind.INT16, TypeKind.INT32, TypeKind.INT64]
# the decimal digits an integral type holds (Spark's DecimalType.forType)
_INT_DECIMAL_DIGITS = {TypeKind.INT8: 3, TypeKind.INT16: 5,
                       TypeKind.INT32: 10, TypeKind.INT64: 19}


def integral_as_decimal(a: DataType) -> DataType:
    """The narrowest decimal that holds an integral type (capped at 18
    digits, as the reference caps it)."""
    return decimal(min(_INT_DECIMAL_DIGITS[a.kind], 18), 0)


def common_type(a: DataType, b: DataType) -> DataType:
    """Spark's findTightestCommonType subset for binary arithmetic and
    comparison (``spark_rapids_tpu/types.py:common_type``), with the
    wider-decimal rule: the widest integral part and the widest scale,
    capped at 38 digits."""
    if a == b:
        return a
    if a.kind == TypeKind.NULL:
        return b
    if b.kind == TypeKind.NULL:
        return a
    if a.is_integral and b.is_integral:
        ia, ib = _INT_WIDENING.index(a.kind), _INT_WIDENING.index(b.kind)
        return DataType(_INT_WIDENING[max(ia, ib)])
    if a.is_floating and b.is_floating:
        return FLOAT64 if TypeKind.FLOAT64 in (a.kind, b.kind) else FLOAT32
    if a.is_integral and b.is_floating:
        return (b if b.kind == TypeKind.FLOAT64
                or a.kind in _INT_WIDENING[:2] else FLOAT64)
    if b.is_integral and a.is_floating:
        return common_type(b, a)
    if a.is_decimal and b.is_decimal:
        s = max(a.scale, b.scale)
        ip = max(a.precision - a.scale, b.precision - b.scale)
        return decimal(min(ip + s, 38), s)
    if a.is_decimal and b.is_integral:
        return common_type(a, integral_as_decimal(b))
    if b.is_decimal and a.is_integral:
        return common_type(integral_as_decimal(a), b)
    if (a.is_decimal and b.is_floating) or (b.is_decimal and a.is_floating):
        return FLOAT64
    raise TypeError(f"no common type for {a} and {b}")


class TypeSig:
    """A set of supported :class:`DataType` kinds and the largest decimal
    precision; ``check(dt)`` returns None when supported, else the reason
    string the planner reports (the reference's wording)."""

    def __init__(self, kinds: Iterable[TypeKind] = (),
                 max_decimal_precision: int = 18):
        self.kinds = frozenset(kinds)
        self.max_decimal_precision = max_decimal_precision

    def __add__(self, other: "TypeSig") -> "TypeSig":
        return TypeSig(self.kinds | other.kinds,
                       max(self.max_decimal_precision,
                           other.max_decimal_precision))

    def check(self, dt: DataType) -> Optional[str]:
        if dt.kind not in self.kinds:
            return f"type {dt} is not supported"
        if dt.is_decimal and dt.precision > self.max_decimal_precision:
            return (f"decimal precision {dt.precision} exceeds max "
                    f"supported {self.max_decimal_precision}")
        return None


TypeSig.BOOLEAN = TypeSig([TypeKind.BOOLEAN])
TypeSig.numeric = TypeSig([TypeKind.INT8, TypeKind.INT16, TypeKind.INT32,
                           TypeKind.INT64, TypeKind.FLOAT32,
                           TypeKind.FLOAT64, TypeKind.DECIMAL])
TypeSig.datetime = TypeSig([TypeKind.DATE, TypeKind.TIMESTAMP])
TypeSig.null = TypeSig([TypeKind.NULL])
TypeSig.device_compute = (TypeSig.numeric + TypeSig.datetime
                          + TypeSig.BOOLEAN + TypeSig.null)
# the expressions with two-limb decimal kernels (ops/wide_decimal.py)
TypeSig.decimal128 = TypeSig([TypeKind.DECIMAL], max_decimal_precision=38)
