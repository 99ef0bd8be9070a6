"""Logical plan nodes built by the DataFrame API
(``spark_rapids_tpu/plan/logical.py`` counterpart: scan, project, filter,
aggregate, distinct, sort, join, limit, window, sample, generate)."""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..batch import Field, Schema
from ..exprs import Expression, bind

__all__ = ["LogicalPlan", "LogicalScan", "Project", "Filter", "Aggregate",
           "Distinct", "Sort", "SortOrder", "Join", "Limit", "Window",
           "Sample", "Generate"]


class LogicalPlan:
    children: Tuple["LogicalPlan", ...] = ()

    def schema(self) -> Schema:
        raise NotImplementedError

    def node_desc(self) -> str:
        return type(self).__name__


class LogicalScan(LogicalPlan):
    """Leaf: an in-memory source (``plan/physical.py MemorySource``)."""

    def __init__(self, schema: Schema, source, desc: str,
                 fmt: str = "memory"):
        self._schema = schema
        self.source = source
        self.desc = desc
        self.fmt = fmt

    def schema(self) -> Schema:
        return self._schema

    def node_desc(self):
        return f"Scan {self.fmt} [{self.desc}]"


class Project(LogicalPlan):
    def __init__(self, child: LogicalPlan,
                 exprs: List[Tuple[str, Expression]]):
        self.children = (child,)
        self.exprs = exprs  # unbound; names are output names

    def schema(self) -> Schema:
        in_schema = self.children[0].schema()
        fields = []
        for name, e in self.exprs:
            b = bind(e, in_schema)
            fields.append(Field(name, b.dtype, b.nullable))
        return Schema(fields)

    def node_desc(self):
        return f"Project [{', '.join(n for n, _ in self.exprs)}]"


class Filter(LogicalPlan):
    def __init__(self, child: LogicalPlan, condition: Expression):
        self.children = (child,)
        self.condition = condition

    def schema(self) -> Schema:
        return self.children[0].schema()

    def node_desc(self):
        return f"Filter [{self.condition.fingerprint()}]"


class Aggregate(LogicalPlan):
    def __init__(self, child: LogicalPlan,
                 group_exprs: List[Tuple[str, Expression]],
                 agg_exprs: List[Tuple[str, Expression]]):
        self.children = (child,)
        self.group_exprs = group_exprs
        self.agg_exprs = agg_exprs

    def schema(self) -> Schema:
        in_schema = self.children[0].schema()
        fields = []
        for name, e in self.group_exprs + self.agg_exprs:
            b = bind(e, in_schema)
            fields.append(Field(name, b.dtype, b.nullable))
        return Schema(fields)

    def node_desc(self):
        return (f"Aggregate keys=[{', '.join(n for n, _ in self.group_exprs)}]"
                f" aggs=[{', '.join(n for n, _ in self.agg_exprs)}]")


class Distinct(LogicalPlan):
    """The distinct rows of the child: a GROUP BY every column with no
    aggregate (reference ``logical.py:186``)."""

    def __init__(self, child: LogicalPlan):
        self.children = (child,)

    def schema(self) -> Schema:
        return self.children[0].schema()


class SortOrder:
    def __init__(self, expr: Expression, ascending: bool = True,
                 nulls_first: Optional[bool] = None):
        self.expr = expr
        self.ascending = ascending
        # Spark default: nulls first for ASC, nulls last for DESC
        self.nulls_first = (nulls_first if nulls_first is not None
                            else ascending)


class Sort(LogicalPlan):
    def __init__(self, child: LogicalPlan, orders: List[SortOrder],
                 global_sort: bool = True):
        self.children = (child,)
        self.orders = orders
        self.global_sort = global_sort

    def schema(self) -> Schema:
        return self.children[0].schema()

    def node_desc(self):
        return f"Sort [{len(self.orders)} keys, global={self.global_sort}]"


class Join(LogicalPlan):
    """Equi-join on ``left_keys[i] = right_keys[i]`` and, where given, a
    residual ``condition`` over both sides' columns; ``using`` (set by
    ``DataFrame.join`` on column names) drops the right side's copies of
    the key columns.  A semi or anti join keeps the left schema only, an
    existence join adds a boolean ``exists`` column to it; a left outer
    join makes the right side's fields nullable.  A cross join has no
    keys."""

    def __init__(self, left: LogicalPlan, right: LogicalPlan,
                 left_keys: List[Expression], right_keys: List[Expression],
                 how: str = "inner", condition: Optional[Expression] = None):
        self.children = (left, right)
        self.left_keys = left_keys
        self.right_keys = right_keys
        self.how = how
        self.condition = condition
        self.using: List[str] = []

    def schema(self) -> Schema:
        l, r = self.children[0].schema(), self.children[1].schema()
        if self.how in ("semi", "anti", "left_semi", "left_anti"):
            return l
        if self.how == "existence":
            # the left rows and a boolean match column (Spark's
            # ExistenceJoin, from IN/EXISTS inside a disjunction)
            from .. import types as T
            return Schema(list(l.fields)
                          + [Field(getattr(self, "exists_col", "exists"),
                                   T.BOOLEAN, False)])
        using = set(self.using)
        fields = list(l.fields)
        rf = [f for f in r.fields if f.name not in using]
        if self.how in ("left", "left_outer", "full", "full_outer"):
            rf = [Field(f.name, f.dtype, True) for f in rf]
        if self.how in ("right", "right_outer", "full", "full_outer"):
            fields = [Field(f.name, f.dtype, True) for f in fields]
        return Schema(fields + rf)

    def node_desc(self):
        return f"Join {self.how}"


class Limit(LogicalPlan):
    def __init__(self, child: LogicalPlan, n: int):
        self.children = (child,)
        self.n = n

    def schema(self) -> Schema:
        return self.children[0].schema()

    def node_desc(self):
        return f"Limit {self.n}"


class Window(LogicalPlan):
    """Appends window-function columns (reference :288).  Every one of
    ``window_exprs`` shares one (partition_by, order_by) spec: the
    DataFrame layer splits mixed specs into a chain of Window nodes, as
    Spark's ExtractWindowExpressions rule does.  Output schema: the child's
    columns, then the window columns."""

    def __init__(self, child: LogicalPlan,
                 window_exprs: List[Tuple[str, Expression]]):
        self.children = (child,)
        self.window_exprs = window_exprs

    def schema(self) -> Schema:
        in_schema = self.children[0].schema()
        fields = list(in_schema.fields)
        for name, e in self.window_exprs:
            b = bind(e, in_schema)
            fields.append(Field(name, b.dtype, b.nullable))
        return Schema(fields)

    def node_desc(self):
        return f"Window [{', '.join(n for n, _ in self.window_exprs)}]"


class Sample(LogicalPlan):
    """A Bernoulli sample of the child's rows, each kept with probability
    ``fraction`` under ``seed`` (reference :278)."""

    def __init__(self, child: LogicalPlan, fraction: float, seed: int = 0):
        self.children = (child,)
        self.fraction = fraction
        self.seed = seed

    def schema(self) -> Schema:
        return self.children[0].schema()


class Generate(LogicalPlan):
    """Explode an ARRAY column into one row per element (reference :209);
    the element field ``out_name`` takes the array column's place, and
    ``outer`` keeps an empty or null array as one row with a null
    element."""

    def __init__(self, child: LogicalPlan, column: str, out_name: str,
                 outer: bool = False):
        self.children = (child,)
        self.column = column
        self.out_name = out_name
        self.outer = outer

    def schema(self) -> Schema:
        fields = []
        for f in self.children[0].schema():
            if f.name == self.column:
                fields.append(Field(self.out_name, f.dtype.element, True))
            else:
                fields.append(f)
        return Schema(fields)

    def node_desc(self):
        kind = "explode_outer" if self.outer else "explode"
        return f"Generate {kind}({self.column}) as {self.out_name}"
