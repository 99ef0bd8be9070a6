"""Column functions (``spark_rapids_tpu/sql/functions.py`` counterpart):
the column reference, literals and the aggregates of this slice."""

from __future__ import annotations

from typing import Any, Optional

from .. import aggfns as A
from .. import exprs as E
from .. import types as T
from .column import Column, to_expr

__all__ = ["col", "lit", "sum", "avg", "count", "count_star", "min", "max",
           "first", "last"]


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
