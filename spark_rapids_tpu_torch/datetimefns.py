"""Date functions over the port's int32 days since the Unix epoch
(``spark_rapids_tpu/datetimefns.py`` counterpart; ``Year`` :102 is what
TPC-H Q7, Q8 and Q9 use).

The civil-calendar conversion is the branchless Euclidean-affine algorithm
the reference uses (Howard Hinnant's ``civil_from_days``), written with
torch integer ops, so every date, before the epoch included, gives the
reference's year.  A timestamp (int64 microseconds, UTC) is truncated to
its day first.  The result is Spark's IntegerType.
"""

from __future__ import annotations

import torch

from . import types as T
from .exprs import Expression, Value

__all__ = ["Year", "civil_from_days"]

_US_PER_DAY = 86_400_000_000


def _fdiv(a: torch.Tensor, b: int) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


def civil_from_days(z: torch.Tensor):
    """int days since the epoch → (year, month, day) as int64 tensors."""
    z = z.to(torch.int64) + 719468
    era = _fdiv(z, 146097)
    doe = z - era * 146097
    yoe = _fdiv(doe - _fdiv(doe, 1460) + _fdiv(doe, 36524)
                - _fdiv(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + _fdiv(yoe, 4) - _fdiv(yoe, 100))
    mp = _fdiv(5 * doy + 2, 153)
    d = doy - _fdiv(153 * mp + 2, 5) + 1
    m = mp + torch.where(mp < 10, 3, -9)
    return y + (m <= 2).to(torch.int64), m, d


class _DateExpression(Expression):
    """Base: the child is a DATE (days) or a TIMESTAMP (truncated to its
    UTC day); the result is an int32 field of the civil date."""

    def __init__(self, child: Expression):
        self.children = (child,)
        if child.resolved():
            self._rebind()

    def _rebind(self):
        self.dtype = T.INT32
        self.nullable = self.children[0].nullable

    def _days(self, d: torch.Tensor) -> torch.Tensor:
        if self.children[0].dtype.kind == T.TypeKind.TIMESTAMP:
            return _fdiv(d.to(torch.int64), _US_PER_DAY)
        return d.to(torch.int64)


class Year(_DateExpression):
    def eval(self, ctx) -> Value:
        d, v = self.children[0].eval(ctx)
        y, _, _ = civil_from_days(self._days(d))
        return y.to(torch.int32), v
