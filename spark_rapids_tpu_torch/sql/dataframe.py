"""DataFrame: the lazy query surface (``spark_rapids_tpu/sql/dataframe.py``
counterpart).  Transformations build a logical plan; ``collect`` plans and
runs it on the session's device."""

from __future__ import annotations

from typing import List, Union

from .. import exprs as E
from ..plan import logical as L
from .column import Column

__all__ = ["DataFrame", "GroupedData"]


def _named(c: Union[str, Column]) -> tuple:
    if isinstance(c, str):
        return (c, E.UnresolvedColumn(c))
    return (c.name, c.expr)


class DataFrame:
    def __init__(self, plan: L.LogicalPlan, session):
        self._plan = plan
        self.session = session

    def select(self, *cols: Union[str, Column]) -> "DataFrame":
        return DataFrame(L.Project(self._plan, [_named(c) for c in cols]),
                         self.session)

    def where(self, condition: Column) -> "DataFrame":
        return DataFrame(L.Filter(self._plan, condition.expr), self.session)

    filter = where

    def group_by(self, *cols: Union[str, Column]) -> "GroupedData":
        return GroupedData(self, [_named(c) for c in cols])

    def agg(self, *cols: Column) -> "DataFrame":
        return GroupedData(self, []).agg(*cols)

    def sort(self, *cols: Union[str, Column, L.SortOrder]) -> "DataFrame":
        """ORDER BY: column names or Columns sort ascending with nulls
        first; ``col.desc()`` gives a descending order."""
        orders = []
        for c in cols:
            if isinstance(c, L.SortOrder):
                orders.append(c)
            elif isinstance(c, str):
                orders.append(L.SortOrder(E.UnresolvedColumn(c)))
            else:
                orders.append(L.SortOrder(c.expr))
        return DataFrame(L.Sort(self._plan, orders), self.session)

    def limit(self, n: int) -> "DataFrame":
        """The first ``n`` rows; after ``sort`` this is a top-k."""
        return DataFrame(L.Limit(self._plan, n), self.session)

    def distinct(self) -> "DataFrame":
        """The distinct rows (a GROUP BY every column)."""
        return DataFrame(L.Distinct(self._plan), self.session)

    def join(self, other: "DataFrame", on, how: str = "inner"
             ) -> "DataFrame":
        """Equi-join with ``other``: ``on`` is a column name or list of
        names present on both sides (the right copies are dropped), or a
        list of (left name, right name) pairs.  ``how`` takes the
        reference's names: inner, left (left_outer), semi (left_semi),
        anti (left_anti), right (right_outer) and full (full_outer)."""
        if isinstance(on, str):
            on = [on]
        if isinstance(on, (list, tuple)) and on \
                and all(isinstance(x, str) for x in on):
            node = L.Join(self._plan, other._plan,
                          [E.UnresolvedColumn(k) for k in on],
                          [E.UnresolvedColumn(k) for k in on], how=how)
            node.using = list(on)
            return DataFrame(node, self.session)
        if isinstance(on, (list, tuple)) and on and all(
                isinstance(x, (list, tuple)) and len(x) == 2 for x in on):
            return DataFrame(L.Join(self._plan, other._plan,
                                    [E.UnresolvedColumn(a) for a, _ in on],
                                    [E.UnresolvedColumn(b) for _, b in on],
                                    how=how), self.session)
        raise NotImplementedError(
            "join on: column names or (left, right) name pairs")

    def cross_join(self, other: "DataFrame") -> "DataFrame":
        """The cartesian product with ``other`` (planning raises: the cross
        join is not ported yet)."""
        return DataFrame(L.Join(self._plan, other._plan, [], [],
                                how="cross"), self.session)

    def collect(self) -> List[tuple]:
        """Execute and fetch all rows as tuples of Python values."""
        return self.session._execute(self._plan)

    def explain_string(self) -> str:
        return self.session._explain(self._plan)


class GroupedData:
    def __init__(self, df: DataFrame, group_exprs):
        self._df = df
        self._group_exprs = group_exprs

    def agg(self, *cols: Column) -> DataFrame:
        node = L.Aggregate(self._df._plan, self._group_exprs,
                           [_named(c) for c in cols])
        return DataFrame(node, self._df.session)
