"""DataFrame: the lazy query surface (``spark_rapids_tpu/sql/dataframe.py``
counterpart).  Transformations build a logical plan; ``collect`` plans and
runs it on the session's device and brings the rows to the host;
``to_device_arrays`` leaves the result on the device.  Window expressions
in ``select`` and ``with_column`` become a chain of ``Window`` nodes, one
per (partition, order) spec (``_rewrite_windows``); arithmetic over
aggregate calls in ``agg`` becomes an ``Aggregate`` of the plain calls
under a ``Project`` (``_decompose_agg_exprs``)."""

from __future__ import annotations

import copy
from typing import Dict, List, Optional, Union

from .. import exprs as E
from ..plan import logical as L
from .column import Column

__all__ = ["DataFrame", "GroupedData"]


def _named(c: Union[str, Column]) -> tuple:
    if isinstance(c, str):
        return (c, E.UnresolvedColumn(c))
    return (c.name, c.expr)


def _decompose_agg_exprs(child: L.LogicalPlan, group_exprs, agg_exprs
                         ) -> L.LogicalPlan:
    """The Aggregate node of ``agg``, with compound aggregate expressions
    split as Spark splits a physical aggregate's result expressions
    (reference :28): ``agg((sum(v) * 0.2).alias("lim"))`` becomes
    ``Aggregate(__agg0=sum(v))`` under ``Project(lim=__agg0 * 0.2)``.
    Structurally equal aggregate calls are computed once.  An ``agg``
    without any aggregate call, or one that reads a column that is neither
    grouped nor inside an aggregate call, raises ``ValueError`` with the
    reference's message."""
    from ..plan.planner import strip_alias

    agg_exprs = [(n, strip_alias(e)) for n, e in agg_exprs]
    if all(isinstance(e, E.AggregateExpression) for _, e in agg_exprs):
        return L.Aggregate(child, group_exprs, agg_exprs)

    internal: List[tuple] = []
    by_fp: Dict[str, str] = {}

    def rewrite(e: E.Expression) -> E.Expression:
        e = strip_alias(e)
        if isinstance(e, E.AggregateExpression):
            fp = e.fingerprint()
            if fp not in by_fp:
                by_fp[fp] = f"__agg{len(internal)}"
                internal.append((by_fp[fp], e))
            return E.UnresolvedColumn(by_fp[fp])
        if not e.children:
            return e
        node = copy.copy(e)
        node.children = tuple(rewrite(c) for c in e.children)
        return node

    finals = [(name, rewrite(e)) for name, e in agg_exprs]
    if not internal:
        raise ValueError(
            "agg() expressions must contain at least one aggregate "
            "function (use select() for row-wise expressions)")
    valid = {n for n, _ in group_exprs} | {n for n, _ in internal}
    for name, e in finals:
        stray = {r for r in e.references() if r not in valid}
        if stray:
            raise ValueError(
                f"agg() expression {name!r} references non-grouping "
                f"column(s) {sorted(stray)}: every column must be inside "
                f"an aggregate function or be a grouping column")
    node = L.Aggregate(child, group_exprs, internal)
    return L.Project(node, [(n, E.UnresolvedColumn(n))
                            for n, _ in group_exprs] + finals)


def _rewrite_windows(plan: L.LogicalPlan, exprs: List[tuple]):
    """Pull window expressions out of a projection into Window nodes
    (reference :85, Spark's ExtractWindowExpressions): each window subtree
    becomes a reference to a generated ``__w{i}`` column, computed by a
    chain of Window nodes, one per distinct (partition, order) spec in the
    order the specs first appear.  Returns (child plan, rewritten
    expressions)."""
    from ..windowfns import WindowExpression

    found: List[tuple] = []  # (generated name, window expression)
    by_fp: Dict[str, str] = {}

    def walk_replace(e: E.Expression) -> E.Expression:
        if isinstance(e, WindowExpression):
            fp = e.fingerprint()
            if fp not in by_fp:
                by_fp[fp] = f"__w{len(found)}"
                found.append((by_fp[fp], e))
            return E.UnresolvedColumn(by_fp[fp])
        if not e.children:
            return e
        kids = tuple(walk_replace(c) for c in e.children)
        if all(a is b for a, b in zip(kids, e.children)):
            return e
        node = copy.copy(e)
        node.children = kids
        return node

    new_exprs = [(n, walk_replace(e)) for n, e in exprs]
    if not found:
        return plan, exprs
    groups: Dict[str, List[tuple]] = {}
    for gen, w in found:
        groups.setdefault(w.spec.spec_fingerprint(), []).append((gen, w))
    child = plan
    for members in groups.values():
        child = L.Window(child, members)
    return child, new_exprs


class DataFrame:
    def __init__(self, plan: L.LogicalPlan, session):
        self._plan = plan
        self.session = session

    @property
    def schema(self):
        return self._plan.schema()

    @property
    def columns(self) -> List[str]:
        return self._plan.schema().names()

    def select(self, *cols: Union[str, Column]) -> "DataFrame":
        child, exprs = _rewrite_windows(self._plan,
                                        [_named(c) for c in cols])
        return DataFrame(L.Project(child, exprs), self.session)

    def where(self, condition: Column) -> "DataFrame":
        return DataFrame(L.Filter(self._plan, condition.expr), self.session)

    filter = where

    def with_column(self, name: str, c: Column) -> "DataFrame":
        """Every column, with ``name`` replaced by (or appended as) ``c``
        (reference :165)."""
        exprs, replaced = [], False
        for f in self._plan.schema():
            if f.name == name:
                exprs.append((name, c.expr))
                replaced = True
            else:
                exprs.append((f.name, E.UnresolvedColumn(f.name)))
        if not replaced:
            exprs.append((name, c.expr))
        child, exprs = _rewrite_windows(self._plan, exprs)
        return DataFrame(L.Project(child, exprs), self.session)

    withColumn = with_column

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

    def explode(self, column: str, out_name: Optional[str] = None,
                outer: bool = False) -> "DataFrame":
        """One row per element of the ARRAY column ``column``, named
        ``out_name`` (default: the column's name) in the column's place;
        ``outer`` keeps an empty or null array as one row with a null
        element (reference :223)."""
        return DataFrame(L.Generate(self._plan, column, out_name or column,
                                    outer=outer), self.session)

    def sample(self, fraction: float, seed: Optional[int] = None
               ) -> "DataFrame":
        """A Bernoulli sample without replacement: each row is kept with
        probability ``fraction``; with no seed, one is drawn at random
        (reference :243)."""
        if seed is None:
            import random
            seed = random.randint(0, 2 ** 31 - 1)
        return DataFrame(L.Sample(self._plan, fraction, seed), self.session)

    def cache(self) -> "DataFrame":
        """This result, materialized on the device on first use; later
        actions replay the cached batches (reference :231,
        ``plan/exec_nodes.py CacheExec``).  The child is optimized here,
        once, against its own whole output, as Spark plans a cached
        query: no filter or column need of a plan above reaches into it,
        and its batches keep the child's schema."""
        from ..plan.optimizer import optimize
        return DataFrame(L.Cache(optimize(self._plan)), self.session)

    persist = cache

    def unpersist(self) -> "DataFrame":
        """Release the cached batches; the next action runs the child
        again (reference :238)."""
        if isinstance(self._plan, L.Cache):
            self._plan.unpersist()
        return self

    def union(self, other: "DataFrame") -> "DataFrame":
        """The rows of both inputs, this one's first, duplicates kept
        (UNION ALL, reference :251); the schemas must agree column by
        column in type."""
        return DataFrame(L.Union([self._plan, other._plan]), self.session)

    unionAll = union

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
        """The cartesian product with ``other`` (reference :292)."""
        return DataFrame(L.Join(self._plan, other._plan, [], [],
                                how="cross"), self.session)

    crossJoin = cross_join

    def collect(self) -> List[tuple]:
        """Execute and fetch all rows as tuples of Python values."""
        return self.session._execute(self._plan)

    def count(self) -> int:
        """The number of rows, as an int: ``count(*)`` over this result
        (reference :380)."""
        from . import functions as F
        counted = self.agg(F.count_star().alias("count"))
        return self.session._execute(counted._plan)[0][0]

    def to_device_arrays(self) -> dict:
        """Execute and return the result on the device (reference :298,
        the ColumnarRdd hand-off): ``{column: (data, valid)}``, ``data`` a
        tensor of the column's physical type (dates as int32 days),
        ``valid`` a bool mask or None.  A host-carried (string) column has
        no device form and raises ``TypeError``."""
        from ..batch import DeviceColumn
        whole = self.session._execute_device(self._plan)
        if whole is None:
            return {f.name: None for f in self.schema}
        out = {}
        for f, c in zip(whole.schema, whole.columns):
            if not isinstance(c, DeviceColumn):
                raise TypeError(
                    f"column {f.name!r} ({f.dtype}) is host-carried and "
                    f"has no device representation; drop or encode it "
                    f"before to_device_arrays()")
            out[f.name] = (c.data, c.valid)
        return out

    def explain_string(self) -> str:
        return self.session._explain(self._plan)

    @property
    def write(self):
        """The writer: ``df.write.mode("overwrite").parquet(path)``
        (``io/writers.py``)."""
        from ..io.writers import DataFrameWriter
        return DataFrameWriter(self)


class GroupedData:
    def __init__(self, df: DataFrame, group_exprs):
        self._df = df
        self._group_exprs = group_exprs

    def agg(self, *cols: Column) -> DataFrame:
        node = _decompose_agg_exprs(self._df._plan, self._group_exprs,
                                    [_named(c) for c in cols])
        return DataFrame(node, self._df.session)
