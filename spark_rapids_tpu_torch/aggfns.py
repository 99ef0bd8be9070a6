"""Aggregate functions: SUM, AVG, COUNT, COUNT(*), MIN, MAX, and FIRST/LAST,
which resolve but have no device reduction yet.

Counterpart of ``spark_rapids_tpu/aggfns.py``.  Each aggregate declares
its reduction buffers (``buffers()`` → [(accumulator type, op)], op in
sum/min/max), its per-row contributions (``update``) and its ``finalize``.

A contribution is a Value ``(data, valid)``.  ``data=None`` stands for
"count the live rows where ``valid`` holds" (all live rows when ``valid``
is None too): the reduction kernels count such a channel without reading
a column of ones.  ``row_counts()`` says, per buffer, whether its
contribution is a count that can never carry a mask (its child is not
nullable); the grid path folds those into its per-slot presence count.  Accumulators are float64 or int64, the two
types the kernels reduce; ``finalize`` casts back to the result type.
"""

from __future__ import annotations

from typing import List

import torch

from . import types as T
from .exprs import AggregateExpression, EvalContext, Value

__all__ = ["Sum", "Count", "CountStar", "Min", "Max", "Average", "First",
           "Last"]


def _acc_type(dt: T.DataType) -> T.DataType:
    return T.FLOAT64 if dt.is_floating else T.INT64


class Sum(AggregateExpression):
    """SUM: integral/boolean → bigint, floating → double."""

    func = "sum"

    def _resolve(self):
        c = self.children[0].dtype
        if c.is_integral or c.kind == T.TypeKind.BOOLEAN:
            self.dtype = T.INT64
        elif c.is_floating:
            self.dtype = T.FLOAT64
        else:
            raise TypeError(f"sum of {c} is not ported")
        self.nullable = True

    def buffers(self):
        return [(self.dtype, "sum"), (T.INT64, "sum")]

    def row_counts(self) -> List[bool]:
        return [False, not self.children[0].nullable]

    def update(self, ctx: EvalContext) -> List[Value]:
        d, v = self.children[0].eval(ctx)
        return [(d.to(self.dtype.torch_dtype), v), (None, v)]

    def finalize(self, values: List[Value]) -> Value:
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
    """AVG: tracked as (sum, count) in double."""

    func = "avg"

    def _resolve(self):
        self.dtype = T.FLOAT64
        self.nullable = True

    def buffers(self):
        return [(T.FLOAT64, "sum"), (T.INT64, "sum")]

    def row_counts(self):
        return [False, not self.children[0].nullable]

    def update(self, ctx):
        d, v = self.children[0].eval(ctx)
        return [(d.to(torch.float64), v), (None, v)]

    def finalize(self, values):
        (s, _), (cnt, _) = values
        ok = cnt > 0
        return s / torch.where(ok, cnt, 1).to(torch.float64), ok


class First(AggregateExpression):
    """FIRST(x): resolves like the reference's (``aggfns.py:254``), but the
    order-sensitive reductions are not ported: the aggregate operator
    raises for it (ROADMAP queue 2 row 4)."""

    func = "first"

    def __init__(self, child, ignore_nulls: bool = False):
        super().__init__(child)
        self.ignore_nulls = ignore_nulls

    def _resolve(self):
        self.dtype = self.children[0].dtype
        self.nullable = True

    def buffers(self):
        raise NotImplementedError(
            f"{self.func} is not ported yet (ROADMAP.md queue 2 row 4)")


class Last(First):
    func = "last"
