"""Expression binding helpers shared by the planner (``overrides.py``)."""

from __future__ import annotations

from ..batch import Field, Schema
from ..exprs import BoundReference, Expression, bind

__all__ = ["strip_alias", "bind_project"]


def strip_alias(e: Expression) -> Expression:
    from ..sql.column import _AliasMarker
    while isinstance(e, _AliasMarker):
        e = e.children[0]
    return e


def bind_project(exprs, schema: Schema):
    """Bind projection exprs; a bare host-carried column passes through by
    reference.  Returns ([(name, bound_expr_or_None, host_src)], schema)."""
    triples, fields = [], []
    for name, e in exprs:
        b = bind(e, schema)
        core = strip_alias(b)
        if isinstance(core, BoundReference) and core.dtype.is_host_carried:
            triples.append((name, None, core.ordinal))
            fields.append(Field(name, core.dtype, core.nullable))
        else:
            triples.append((name, b, None))
            fields.append(Field(name, b.dtype, b.nullable))
    return triples, Schema(fields)
