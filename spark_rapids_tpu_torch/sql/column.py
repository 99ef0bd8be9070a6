"""Column: the user-facing expression wrapper (PySpark ``Column`` analog,
``spark_rapids_tpu/sql/column.py`` counterpart)."""

from __future__ import annotations

from typing import Any

from .. import exprs as E

__all__ = ["Column", "to_expr"]


def to_expr(v: Any) -> E.Expression:
    if isinstance(v, Column):
        return v.expr
    if isinstance(v, E.Expression):
        return v
    return E.Literal(v)


class Column:
    def __init__(self, expr: E.Expression):
        self.expr = expr

    def alias(self, name: str) -> "Column":
        return Column(_AliasMarker(self.expr, name))

    @property
    def name(self) -> str:
        if isinstance(self.expr, (_AliasMarker, E.UnresolvedColumn,
                                  E.BoundReference)):
            return self.expr.name
        return self.expr.fingerprint()

    # -- arithmetic ---------------------------------------------------------------
    def __add__(self, o):
        return Column(E.Add(self.expr, to_expr(o)))

    def __radd__(self, o):
        return Column(E.Add(to_expr(o), self.expr))

    def __sub__(self, o):
        return Column(E.Subtract(self.expr, to_expr(o)))

    def __rsub__(self, o):
        return Column(E.Subtract(to_expr(o), self.expr))

    def __mul__(self, o):
        return Column(E.Multiply(self.expr, to_expr(o)))

    def __rmul__(self, o):
        return Column(E.Multiply(to_expr(o), self.expr))

    def __truediv__(self, o):
        return Column(E.Divide(self.expr, to_expr(o)))

    def __rtruediv__(self, o):
        return Column(E.Divide(to_expr(o), self.expr))

    def __mod__(self, o):
        return Column(E.Remainder(self.expr, to_expr(o)))

    def __neg__(self):
        return Column(E.UnaryMinus(self.expr))

    # -- comparisons --------------------------------------------------------------
    def __eq__(self, o):  # noqa: E721 — Column semantics, as in pyspark
        return Column(E.EqualTo(self.expr, to_expr(o)))

    def __ne__(self, o):
        return Column(E.Not(E.EqualTo(self.expr, to_expr(o))))

    def __lt__(self, o):
        return Column(E.LessThan(self.expr, to_expr(o)))

    def __le__(self, o):
        return Column(E.LessThanOrEqual(self.expr, to_expr(o)))

    def __gt__(self, o):
        return Column(E.GreaterThan(self.expr, to_expr(o)))

    def __ge__(self, o):
        return Column(E.GreaterThanOrEqual(self.expr, to_expr(o)))

    # -- boolean ------------------------------------------------------------------
    def __and__(self, o):
        return Column(E.And(self.expr, to_expr(o)))

    def __or__(self, o):
        return Column(E.Or(self.expr, to_expr(o)))

    def __invert__(self):
        return Column(E.Not(self.expr))

    def between(self, low, high) -> "Column":
        """``low <= self <= high``, as ``(self >= low) & (self <= high)``
        (reference :163)."""
        return (self >= low) & (self <= high)

    def isin(self, *values) -> "Column":
        vals = values[0] if len(values) == 1 and isinstance(
            values[0], (list, tuple, set)) else values
        return Column(E.In(self.expr, list(vals)))

    def isin_subquery(self, df) -> "Column":
        """``col IN (one-column subquery)``: a left-semi join when the
        query is collected; ``~`` gives SQL NOT IN with its null semantics
        (``plan/subquery.py``)."""
        from ..plan.subquery import in_subquery
        return Column(in_subquery(self.expr, df._plan))

    def is_null(self) -> "Column":
        return Column(E.IsNull(self.expr))

    def is_not_null(self) -> "Column":
        return Column(E.IsNotNull(self.expr))

    isNull = is_null
    isNotNull = is_not_null

    def like(self, pattern: str) -> "Column":
        from ..stringfns import Like
        return Column(Like(self.expr, pattern))

    def substr(self, pos, length) -> "Column":
        from ..stringfns import Substring
        return Column(Substring(self.expr, to_expr(pos), to_expr(length)))

    def cast(self, dtype) -> "Column":
        return Column(E.Cast(self.expr, dtype))

    def over(self, spec) -> "Column":
        """Attach a window spec: ``F.row_number().over(w)`` (reference
        :194)."""
        from ..windowfns import WindowExpression
        from .window import WindowSpec
        if not isinstance(spec, WindowSpec):
            raise TypeError("over() takes a WindowSpec")
        core = self.expr
        name = None
        if isinstance(core, _AliasMarker):
            name, core = core.name, core.children[0]
        w = WindowExpression(core, spec._spec)
        return Column(_AliasMarker(w, name) if name else w)

    # -- sort orders --------------------------------------------------------------
    def asc(self):
        from ..plan.logical import SortOrder
        return SortOrder(self.expr, ascending=True)

    def desc(self):
        from ..plan.logical import SortOrder
        return SortOrder(self.expr, ascending=False)

    def asc_nulls_last(self):
        from ..plan.logical import SortOrder
        return SortOrder(self.expr, ascending=True, nulls_first=False)

    def desc_nulls_first(self):
        from ..plan.logical import SortOrder
        return SortOrder(self.expr, ascending=False, nulls_first=True)

    def __repr__(self):
        return f"Column<{self.expr.fingerprint()}>"

    def __hash__(self):
        return hash(self.expr.fingerprint())

    def __bool__(self):
        raise ValueError(
            "Cannot convert Column to bool: use '&' for AND, '|' for OR, "
            "'~' for NOT when building expressions.")


class _AliasMarker(E.Expression):
    """Pre-binding alias: stripped by the planner."""

    def __init__(self, child: E.Expression, name: str):
        self.children = (child,)
        self.name = name
        self.dtype = child.dtype
        self.nullable = child.nullable

    def resolved(self):
        return self.children[0].resolved()

    def eval(self, ctx):
        return self.children[0].eval(ctx)

    def _fp_extra(self):
        return self.name

    def _rebind(self):
        self.dtype = self.children[0].dtype
        self.nullable = self.children[0].nullable
