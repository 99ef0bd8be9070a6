"""Column pruning (the column part of the reference's scan pushdown,
``spark_rapids_tpu/plan/pushdown.py``, which the port keeps in its
optimizer module).

One walk from the root narrows every scan to the columns the plan above it
references, so pruned columns are never uploaded: TPC-H Q6 reads 4 of
lineitem's 10 columns.  The scan keeps its description, so the explain
string does not change.
"""

from __future__ import annotations

from typing import Optional, Set

from . import logical as L

__all__ = ["prune_columns"]


def _refs(exprs) -> Set[str]:
    out: Set[str] = set()
    for e in exprs:
        out |= e.references()
    return out


def prune_columns(plan: L.LogicalPlan,
                  required: Optional[Set[str]] = None) -> L.LogicalPlan:
    """``plan`` with every scan narrowed to ``required`` (None: all of the
    node's output columns are needed)."""
    if isinstance(plan, L.LogicalScan):
        names = plan.schema().names()
        if required is None or not set(names) - required:
            return plan
        keep = [n for n in names if n in required]
        if not keep:
            # count(*)-style plans reference no column; keep one (a device
            # column where there is one) for row accounting
            fields = plan.schema().fields
            keep = [next((f.name for f in fields if not f.dtype.is_string),
                         names[0])]
        src = plan.source.pruned(keep)
        return L.LogicalScan(src.schema(), src, plan.desc, plan.fmt)
    if isinstance(plan, L.Project):
        child = prune_columns(plan.children[0],
                              _refs(e for _, e in plan.exprs))
        return L.Project(child, plan.exprs)
    if isinstance(plan, L.Filter):
        need = None if required is None else (
            required | plan.condition.references())
        return L.Filter(prune_columns(plan.children[0], need), plan.condition)
    if isinstance(plan, L.Aggregate):
        need = _refs(e for _, e in plan.group_exprs + plan.agg_exprs)
        return L.Aggregate(prune_columns(plan.children[0], need),
                           plan.group_exprs, plan.agg_exprs)
    if isinstance(plan, L.Sort):
        need = None if required is None else (
            required | _refs(o.expr for o in plan.orders))
        return L.Sort(prune_columns(plan.children[0], need), plan.orders,
                      plan.global_sort)
    raise NotImplementedError(f"no pruning rule for {type(plan).__name__}")
