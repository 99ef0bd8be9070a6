"""Aggregate functions: SUM, AVG, COUNT, COUNT(*), MIN, MAX, FIRST, LAST.

Counterpart of ``spark_rapids_tpu/aggfns.py``.  Each aggregate declares
its reduction buffers (``buffers()`` → [(accumulator type, op)], op in
sum/min/max and first/last/first_valid/last_valid), its per-row
contributions (``update``) and its ``finalize``.  FIRST/LAST buffers
reduce to ``(value, has)`` pairs, ``has`` telling whether any batch had a
qualifying row (``ops/groupby.py``).

Decimals follow the reference: SUM of DECIMAL(p, s) is
DECIMAL(min(38, p + 10), s); a result wider than 18 digits accumulates as
int64 lanes whose sums stay exact (``ops/wide_decimal.sum_lanes``) and is
finalized into ``[n, 2]`` limbs on the device
(``wide_decimal.sum_finalize``), null where it overflows its precision
(ANSI mode raises: the aggregate operator checks ``overflowed``); AVG of a
decimal is a double; MIN and MAX take DECIMAL(p <= 18) as int64.

A contribution is a Value ``(data, valid)``.  ``data=None`` stands for
"count the live rows where ``valid`` holds" (all live rows when ``valid``
is None too): the reduction kernels count such a channel without reading
a column of ones.  ``row_counts()`` says, per buffer, whether its
contribution is a count that can never carry a mask (its child is not
nullable); the grid path folds those into its per-slot presence count.  Accumulators are float64 or int64, the two
types the kernels reduce; ``finalize`` casts back to the result type.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from . import types as T
from .exprs import AggregateExpression, EvalContext, Value
from .types import TypeSig

__all__ = ["Sum", "Count", "CountStar", "Min", "Max", "Average", "First",
           "Last"]


def _acc_type(dt: T.DataType) -> T.DataType:
    return T.FLOAT64 if dt.is_floating else T.INT64


def _no_wide(agg: AggregateExpression) -> None:
    if agg.children[0].dtype.is_wide_decimal:
        raise NotImplementedError(
            f"{agg.func} of {agg.children[0].dtype} is not ported "
            f"(ROADMAP.md item 7)")


class Sum(AggregateExpression):
    """SUM: integral/boolean → bigint, floating → double, DECIMAL(p, s) →
    DECIMAL(min(38, p + 10), s) (reference ``aggfns.py:47-156``)."""

    func = "sum"
    input_sig = TypeSig.device_compute + TypeSig.decimal128
    output_sig = TypeSig.device_compute + TypeSig.decimal128
    overflowed: Optional[torch.Tensor] = None

    def _resolve(self):
        c = self.children[0].dtype
        if c.is_integral or c.kind == T.TypeKind.BOOLEAN:
            self.dtype = T.INT64
        elif c.is_floating:
            self.dtype = T.FLOAT64
        elif c.is_decimal:
            self.dtype = T.decimal(min(c.precision + 10, 38), c.scale)
        else:
            raise TypeError(f"sum of {c} is not ported")
        self.nullable = True

    @property
    def lanes(self) -> int:
        """The int64 lanes of a wide result (0: one plain sum)."""
        if not self.dtype.is_wide_decimal:
            return 0
        return 4 if self.children[0].dtype.is_wide_decimal else 2

    def buffers(self):
        return [(T.INT64 if self.lanes else self.dtype, "sum")] \
            * max(self.lanes, 1) + [(T.INT64, "sum")]

    def row_counts(self) -> List[bool]:
        return [False] * max(self.lanes, 1) + [not self.children[0].nullable]

    def update(self, ctx: EvalContext) -> List[Value]:
        d, v = self.children[0].eval(ctx)
        if self.lanes:
            from .ops.wide_decimal import sum_lanes
            return [(x, v) for x in sum_lanes(d)] + [(None, v)]
        return [(d.to(self.dtype.torch_dtype), v), (None, v)]

    def finalize(self, values: List[Value]) -> Value:
        if self.lanes:
            from .ops.wide_decimal import sum_finalize
            data, valid, self.overflowed = sum_finalize(
                [x for x, _ in values[:-1]], values[-1][0],
                self.dtype.precision)
            return data, valid
        (s, _), (cnt, _) = values
        return s, cnt > 0


class Count(AggregateExpression):
    func = "count"

    def _resolve(self):
        self.dtype = T.INT64
        self.nullable = False

    def buffers(self):
        return [(T.INT64, "sum")]

    def row_counts(self):
        return [not self.children[0].nullable]

    def update(self, ctx):
        _, v = self.children[0].eval(ctx)
        return [(None, v)]

    def finalize(self, values):
        return values[0][0], None


class CountStar(AggregateExpression):
    func = "count(*)"

    def __init__(self):
        super().__init__(None)
        self.dtype = T.INT64
        self.nullable = False

    def _resolve(self):
        pass

    def buffers(self):
        return [(T.INT64, "sum")]

    def row_counts(self):
        return [True]

    def update(self, ctx):
        return [(None, None)]

    def finalize(self, values):
        return values[0][0], None


class _MinMax(AggregateExpression):
    reduce_op = "?"

    def _resolve(self):
        self.dtype = self.children[0].dtype
        if not (self.dtype.is_numeric or self.dtype.kind in (
                T.TypeKind.BOOLEAN, T.TypeKind.DATE, T.TypeKind.TIMESTAMP)):
            raise TypeError(f"{self.func} of {self.dtype} is not ported")
        self.nullable = True

    def buffers(self):
        _no_wide(self)
        return [(_acc_type(self.dtype), self.reduce_op), (T.INT64, "sum")]

    def row_counts(self):
        return [False, not self.children[0].nullable]

    def update(self, ctx):
        d, v = self.children[0].eval(ctx)
        acc = _acc_type(self.dtype).torch_dtype
        return [(d.to(acc), v), (None, v)]

    def finalize(self, values):
        (m, _), (cnt, _) = values
        return m.to(self.dtype.torch_dtype), cnt > 0


class Min(_MinMax):
    func = "min"
    reduce_op = "min"


class Max(_MinMax):
    func = "max"
    reduce_op = "max"


class Average(AggregateExpression):
    """AVG: tracked as (sum, count) in double; a decimal's average is a
    double too, its values unscaled first (reference ``aggfns.py:226``)."""

    func = "avg"

    def _resolve(self):
        self.dtype = T.FLOAT64
        self.nullable = True

    def buffers(self):
        _no_wide(self)
        return [(T.FLOAT64, "sum"), (T.INT64, "sum")]

    def row_counts(self):
        return [False, not self.children[0].nullable]

    def update(self, ctx):
        d, v = self.children[0].eval(ctx)
        src = self.children[0].dtype
        d = d.to(torch.float64)
        if src.is_decimal:
            d = d / float(10 ** src.scale)
        return [(d, v), (None, v)]

    def finalize(self, values):
        (s, _), (cnt, _) = values
        ok = cnt > 0
        return s / torch.where(ok, cnt, 1).to(torch.float64), ok


class First(AggregateExpression):
    """FIRST(x) (reference ``aggfns.py:254-300``): the value at the first
    live row in input order.  With ``ignore_nulls`` one ``first_valid``
    buffer picks the first row whose value is valid (null when none is);
    without, a ``first`` buffer takes the value and a second one its
    validity.  The value rides as float64 or int64 words."""

    func = "first"
    reduce_choice = "first"

    def __init__(self, child, ignore_nulls: bool = False):
        self.ignore_nulls = ignore_nulls
        super().__init__(child)

    def _resolve(self):
        self.dtype = self.children[0].dtype
        self.nullable = True

    def buffers(self):
        _no_wide(self)
        if self.dtype.is_string:
            raise NotImplementedError(
                f"{self.func} of a string runs on the CPU in the reference "
                f"(plan/overrides.py:192-194); the CPU aggregate is not "
                f"ported (ROADMAP.md item 6)")
        acc = _acc_type(self.dtype)
        if self.ignore_nulls:
            return [(acc, f"{self.reduce_choice}_valid")]
        return [(acc, self.reduce_choice), (T.INT64, self.reduce_choice)]

    def row_counts(self):
        return [False] * len(self.buffers())

    def update(self, ctx):
        d, v = self.children[0].eval(ctx)
        d = d.to(_acc_type(self.dtype).torch_dtype)
        if self.ignore_nulls:
            return [(d, v)]
        flag = (torch.ones((), dtype=torch.int64, device=ctx.device)
                if v is None else v.to(torch.int64))
        return [(d, v), (flag, None)]

    def finalize(self, values):
        if self.ignore_nulls:
            return values[0]
        (d, _), (flag, has) = values
        return d, (flag > 0) & has

    def _fp_extra(self):
        return f"{self.func}:{self.dtype}:ign={self.ignore_nulls}"


class Last(First):
    func = "last"
    reduce_choice = "last"
