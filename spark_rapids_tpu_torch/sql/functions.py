"""Column functions (``spark_rapids_tpu/sql/functions.py`` counterpart):
the column reference, literals, the aggregates and the window functions
(:418-460) of the port."""

from __future__ import annotations

from typing import Any, Optional

from .. import aggfns as A
from .. import exprs as E
from .. import types as T
from .column import Column, to_expr

__all__ = ["col", "lit", "sum", "avg", "count", "count_star", "min", "max",
           "first", "last", "row_number", "rank", "dense_rank",
           "percent_rank", "cume_dist", "ntile", "lag", "lead"]


def col(name: str) -> Column:
    return Column(E.UnresolvedColumn(name))


def lit(value: Any, dtype: Optional[T.DataType] = None) -> Column:
    return Column(E.Literal(value, dtype))


def sum(c) -> Column:  # noqa: A001 — mirrors pyspark naming
    return Column(A.Sum(to_expr(c)))


def avg(c) -> Column:
    return Column(A.Average(to_expr(c)))


def count(c) -> Column:
    if isinstance(c, str) and c == "*":
        return Column(A.CountStar())
    return Column(A.Count(to_expr(c)))


def count_star() -> Column:
    return Column(A.CountStar())


def min(c) -> Column:  # noqa: A001
    return Column(A.Min(to_expr(c)))


def max(c) -> Column:  # noqa: A001
    return Column(A.Max(to_expr(c)))


def first(c, ignore_nulls: bool = False) -> Column:
    return Column(A.First(to_expr(c), ignore_nulls))


def last(c, ignore_nulls: bool = False) -> Column:
    return Column(A.Last(to_expr(c), ignore_nulls))


# -- window functions ---------------------------------------------------------------

def row_number() -> Column:
    from ..windowfns import RowNumber
    return Column(RowNumber())


def rank() -> Column:
    from ..windowfns import Rank
    return Column(Rank())


def dense_rank() -> Column:
    from ..windowfns import DenseRank
    return Column(DenseRank())


def percent_rank() -> Column:
    from ..windowfns import PercentRank
    return Column(PercentRank())


def cume_dist() -> Column:
    from ..windowfns import CumeDist
    return Column(CumeDist())


def ntile(n: int) -> Column:
    from ..windowfns import NTile
    return Column(NTile(n))


def _colref(c) -> E.Expression:
    """A str is a column NAME here (PySpark semantics for lag/lead)."""
    if isinstance(c, str):
        return E.UnresolvedColumn(c)
    return to_expr(c)


def lag(c, offset: int = 1, default=None) -> Column:
    from ..windowfns import Lag
    return Column(Lag(_colref(c), offset, default))


def lead(c, offset: int = 1, default=None) -> Column:
    from ..windowfns import Lead
    return Column(Lead(_colref(c), offset, default))
