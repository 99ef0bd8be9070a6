"""Expression binding helpers shared by the planner (``overrides.py``), and
the choice of a join's physical plan."""

from __future__ import annotations

from ..batch import Field, Schema
from ..exprs import BoundReference, Expression, bind

__all__ = ["strip_alias", "bind_project", "plan_join"]


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


def plan_join(plan, left, right, conf):
    """A join's physical plan (the reference's ``exec_nodes.py:641
    plan_join``): a broadcast join when a legal side's estimate fits the
    threshold, else a sort-merge join over hash-partitioned sides (both
    sides' keys cast to their common types, so equal keys land in the same
    partition), or over the two sides whole when exchanges are off.  One
    dictionary per string key is shared by both exchanges and the join.
    A cross join (no keys) that no broadcast takes joins its sides
    whole."""
    from ..exprs import Cast
    from .exchange_exec import ShuffleExchangeExec
    from .join_exec import (SortMergeJoinExec, bound_join_keys, canon_how,
                            plan_broadcast_join)
    shared: dict = {}
    bc = plan_broadcast_join(plan, left, right, conf, shared)
    if bc is not None:
        return bc
    if canon_how(plan.how) != "cross" and plan.left_keys \
            and conf["spark.rapids.tpu.sql.exchange.enabled"]:
        lk, rk, common = bound_join_keys(plan, left.output_schema,
                                         right.output_schema)

        def promoted(keys):
            return [k if k.dtype == ct else Cast(k, ct)
                    for k, ct in zip(keys, common)]
        n_parts = conf["spark.rapids.tpu.sql.shuffle.partitions"]
        left = ShuffleExchangeExec(left, promoted(lk), n_parts, shared)
        right = ShuffleExchangeExec(right, promoted(rk), n_parts, shared)
    return SortMergeJoinExec(plan, left, right, shared)
