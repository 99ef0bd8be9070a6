"""Column functions (``spark_rapids_tpu/sql/functions.py`` counterpart):
the column reference, literals, CASE WHEN (:317), ``coalesce``,
``isnull``, ``expr_abs``, the aggregates, the window functions
(:418-460), ``year`` (:610), ``substring`` (:719), ``like`` (:744) and
``scalar_subquery`` (:70)."""

from __future__ import annotations

from typing import Any, Optional

from .. import aggfns as A
from .. import exprs as E
from .. import types as T
from .column import Column, to_expr

__all__ = ["col", "lit", "when", "coalesce", "isnull", "expr_abs", "sum", "avg", "count", "count_star", "min", "max",
           "first", "last", "row_number", "rank", "dense_rank",
           "percent_rank", "cume_dist", "ntile", "lag", "lead", "year",
           "substring", "like", "scalar_subquery"]


def col(name: str) -> Column:
    return Column(E.UnresolvedColumn(name))


def lit(value: Any, dtype: Optional[T.DataType] = None) -> Column:
    return Column(E.Literal(value, dtype))


class _WhenBuilder(Column):
    """``when(c, v)[.when(c, v)...].otherwise(v)``; without ``otherwise``
    the unmatched rows are null."""

    def __init__(self, branches):
        self._branches = branches
        super().__init__(E.CaseWhen(branches, None))

    def when(self, cond, value) -> "_WhenBuilder":
        return _WhenBuilder(self._branches
                            + [(to_expr(cond), to_expr(value))])

    def otherwise(self, value) -> Column:
        return Column(E.CaseWhen(self._branches, to_expr(value)))


def when(cond, value) -> _WhenBuilder:
    return _WhenBuilder([(to_expr(cond), to_expr(value))])


def coalesce(*cols) -> Column:
    return Column(E.Coalesce(*[to_expr(c) for c in cols]))


def isnull(c) -> Column:
    return Column(E.IsNull(to_expr(c)))


def expr_abs(c) -> Column:
    return Column(E.Abs(to_expr(c)))


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


# -- dates and strings --------------------------------------------------------------

def year(c) -> Column:
    from ..datetimefns import Year
    return Column(Year(_colref(c)))


def substring(c, pos, length) -> Column:  # noqa: A002
    from ..stringfns import Substring
    return Column(Substring(_colref(c), _colref(pos), _colref(length)))


def like(c, pattern: str, escape: str = "\\") -> Column:
    from ..stringfns import Like
    return Column(Like(_colref(c), pattern, escape))


def scalar_subquery(df) -> Column:
    """A one-row, one-column DataFrame as a value: it runs when the outer
    query is collected (its own subqueries first) and its value replaces
    it as a literal (``plan/subquery.py``)."""
    from ..plan.subquery import ScalarSubquery
    return Column(ScalarSubquery(df._plan))
