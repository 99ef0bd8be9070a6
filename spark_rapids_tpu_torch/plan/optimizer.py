"""Logical rewrites before physical planning: filter pushdown through joins
and projects (``spark_rapids_tpu/plan/optimizer.py push_filters``; a
filter stays above a window), then column pruning (the column part of ``spark_rapids_tpu/plan/pushdown.py
optimize_scans``).

``push_filters`` sinks filter conjuncts below joins: a conjunct that
references one side only moves to that side where the join type allows
it, a range predicate on a join key is mirrored onto the other side's key,
and from a disjunction each side gets the OR of its branches' side-only
conjuncts.  The port's expressions are deterministic, so every conjunct
may move.  Not ported: the extraction of string predicates out of residual
join conditions into projected booleans (the reference's
``_extract_bool_subtrees``).  A filter above a union moves into every
branch.  Neither rewrite enters a ``Cache`` (reference ``optimizer.py:204``,
``pushdown.py:93``, ``:235``): the node is state shared by every plan that
reads it, and its batches keep the child's whole schema.  Unlike the
reference's, its child was optimized on its own when the cache was made
(``DataFrame.cache``), so a cached subplan scans only the columns it reads.

``prune_columns`` narrows every scan to the columns the plan above it
references, so pruned columns are never uploaded, and puts a Project on a
join input that carries columns the join does not need, as the reference
does (``pushdown.py _prune_to``).  An in-memory scan keeps its
description, so the explain string shows the same plan as the reference's
unnarrowed one; a file scan is rebuilt through ``with_pushdown`` with the
columns and with the filter predicates that hold above it
(``pushdown.extract_predicates``), and shows both, as the reference's
``optimize_scans`` (``pushdown.py:75``) does in the same walk.
"""

from __future__ import annotations

import copy
from typing import List, Optional, Sequence, Set

from .. import exprs as E
from . import logical as L
from .pushdown import extract_predicates

Predicate = tuple

__all__ = ["push_filters", "prune_columns", "optimize"]

_CANON = {"left_semi": "semi", "left_anti": "anti", "leftsemi": "semi",
          "leftanti": "anti", "left_outer": "left", "right_outer": "right",
          "full_outer": "full", "outer": "full"}
_RANGE_OPS = (E.LessThan, E.LessThanOrEqual, E.GreaterThan,
              E.GreaterThanOrEqual, E.EqualTo)


def optimize(plan: L.LogicalPlan) -> L.LogicalPlan:
    """The rewrites the planner and explain both see."""
    return prune_columns(push_filters(plan))


# ---------------------------------------------------------------------------------
# Filter pushdown
# ---------------------------------------------------------------------------------

def _conjuncts(e: E.Expression) -> List[E.Expression]:
    if isinstance(e, E.And):
        return _conjuncts(e.children[0]) + _conjuncts(e.children[1])
    return [e]


def _disjuncts(e: E.Expression) -> List[E.Expression]:
    if isinstance(e, E.Or):
        return _disjuncts(e.children[0]) + _disjuncts(e.children[1])
    return [e]


def _and_all(conjs: List[E.Expression]) -> Optional[E.Expression]:
    if not conjs:
        return None
    out = conjs[0]
    for c in conjs[1:]:
        out = E.And(out, c)
    return out


def _wrap(child: L.LogicalPlan, conjs: List[E.Expression]) -> L.LogicalPlan:
    cond = _and_all(conjs)
    return child if cond is None else L.Filter(child, cond)


def _rebuild_join(node: L.Join, left, right) -> L.Join:
    out = L.Join(left, right, node.left_keys, node.right_keys,
                 how=node.how, condition=node.condition)
    out.using = node.using
    if hasattr(node, "exists_col"):  # an existence join's named flag
        out.exists_col = node.exists_col
    return out


def _remap_cols(e: E.Expression, mapping: dict) -> Optional[E.Expression]:
    """``e`` with every column reference renamed through ``mapping``; None
    if a referenced column has no image."""
    if isinstance(e, E.UnresolvedColumn):
        to = mapping.get(e.name)
        return E.UnresolvedColumn(to) if to is not None else None
    if not e.children:
        return e
    kids = []
    for c in e.children:
        r = _remap_cols(c, mapping)
        if r is None:
            return None
        kids.append(r)
    out = copy.copy(e)
    out.children = tuple(kids)
    return out


def _derive_side_predicate(c: E.Expression,
                           names: set) -> Optional[E.Expression]:
    """From a disjunction, the OR of each branch's side-only conjuncts;
    None when a branch has none (then no side condition is implied)."""
    branches = _disjuncts(c)
    if len(branches) < 2:
        return None
    per_branch = []
    for b in branches:
        side = [cc for cc in _conjuncts(b)
                if cc.references() and cc.references() <= names]
        if not side:
            return None
        per_branch.append(_and_all(side))
    out = per_branch[0]
    for p in per_branch[1:]:
        out = E.Or(out, p)
    return out


def _mirror_key_conjunct(c: E.Expression, key_map: dict
                         ) -> Optional[E.Expression]:
    """A comparison over join-key columns and literals, restated on the
    other side's keys: under key equality it holds on matching rows of
    either side."""
    if not isinstance(c, _RANGE_OPS):
        return None
    refs = c.references()
    if not refs or not refs <= set(key_map):
        return None
    return _remap_cols(c, key_map)


def push_filters(plan: L.LogicalPlan) -> L.LogicalPlan:
    """Rewrite the tree, sinking filters toward scans."""
    if isinstance(plan, L.Filter):
        return _push_filter(plan)
    if isinstance(plan, L.Cache):
        return plan  # a barrier: shared state, never rebuilt
    if not plan.children:
        return plan
    kids = tuple(push_filters(c) for c in plan.children)
    if all(n is o for n, o in zip(kids, plan.children)):
        return plan
    out = copy.copy(plan)
    out.children = kids
    return out


def _push_filter(node: L.Filter) -> L.LogicalPlan:
    child = node.children[0]
    conjs = _conjuncts(node.condition)
    while isinstance(child, L.Filter):  # merge stacked filters
        conjs = conjs + _conjuncts(child.condition)
        child = child.children[0]
    if isinstance(child, L.Join):
        return _push_filter_join(child, conjs)
    if isinstance(child, L.Project):
        # substitute through pure renames only: a conjunct over a computed
        # projection stays above it
        mapping = {name: (e.name if isinstance(e, E.UnresolvedColumn)
                          else None) for name, e in child.exprs}
        moved, kept = [], []
        for c in conjs:
            refs = c.references()
            if refs and all(mapping.get(r) is not None for r in refs):
                moved.append(_remap_cols(c, {r: mapping[r] for r in refs}))
            else:
                kept.append(c)
        inner = child.children[0]
        inner = push_filters(L.Filter(inner, _and_all(moved))) if moved \
            else push_filters(inner)
        return _wrap(L.Project(inner, child.exprs), kept)
    if isinstance(child, L.Union):
        # every branch gets the whole filter (reference :274-278)
        cond = _and_all(conjs)
        return L.Union([push_filters(L.Filter(c, cond))
                        for c in child.children])
    return _wrap(push_filters(child), conjs)


def _push_filter_join(join: L.Join, conjs: List[E.Expression]
                      ) -> L.LogicalPlan:
    how = _CANON.get(join.how, join.how)
    lnames = set(join.children[0].schema().names())
    rnames = set(join.children[1].schema().names())
    push_left_ok = how in ("inner", "cross", "left", "semi", "anti")
    push_right_ok = how in ("inner", "cross", "right", "semi")
    l2r, r2l = {}, {}
    if how in ("inner", "semi"):
        for lk, rk in zip(join.left_keys, join.right_keys):
            if isinstance(lk, E.UnresolvedColumn) \
                    and isinstance(rk, E.UnresolvedColumn):
                l2r[lk.name] = rk.name
                r2l[rk.name] = lk.name
    to_left: List[E.Expression] = []
    to_right: List[E.Expression] = []
    stay: List[E.Expression] = []
    for c in conjs:
        refs = c.references()
        if refs and refs <= lnames and push_left_ok:
            to_left.append(c)
            m = _mirror_key_conjunct(c, l2r) if push_right_ok else None
            if m is not None:
                to_right.append(m)
        elif refs and refs <= rnames and push_right_ok:
            to_right.append(c)
            m = _mirror_key_conjunct(c, r2l) if push_left_ok else None
            if m is not None:
                to_left.append(m)
        else:
            # the original stays for exactness; each side may get the
            # necessary condition a disjunction implies for it
            stay.append(c)
            if isinstance(c, E.Or):
                for ok, names, dest in ((push_left_ok, lnames, to_left),
                                        (push_right_ok, rnames, to_right)):
                    d = _derive_side_predicate(c, names) if ok else None
                    if d is not None:
                        dest.append(d)
    left = push_filters(_wrap(join.children[0], to_left))
    right = push_filters(_wrap(join.children[1], to_right))
    return _wrap(_rebuild_join(join, left, right), stay)


# ---------------------------------------------------------------------------------
# Column pruning
# ---------------------------------------------------------------------------------

def _refs(exprs) -> Set[str]:
    out: Set[str] = set()
    for e in exprs:
        out |= e.references()
    return out


def _prune_to(node: L.LogicalPlan,
              required: Optional[Set[str]]) -> L.LogicalPlan:
    """A column-pruning Project over a join input whose schema carries
    columns the join does not need (a filtered dimension table would drag
    its filter column into the build side)."""
    if required is None or isinstance(node, (L.LogicalScan, L.Cache)):
        return node
    names = node.schema().names()
    keep = [n for n in names if n in required]
    if not keep or len(keep) == len(names):
        return node
    return L.Project(node, [(n, E.UnresolvedColumn(n)) for n in keep])


def prune_columns(plan: L.LogicalPlan,
                  required: Optional[Set[str]] = None,
                  preds: Sequence[Predicate] = ()) -> L.LogicalPlan:
    """``plan`` with every scan narrowed to ``required`` (None: all of the
    node's output columns are needed), and every file scan given the
    filter predicates ``preds`` that hold above it (``pushdown.py``; the
    reference's ``optimize_scans`` walk, which stops predicates at
    aggregates, limits, joins, windows and samples)."""
    if isinstance(plan, L.LogicalScan):
        names = plan.schema().names()
        keep = None
        if required is not None and set(names) - required:
            keep = [n for n in names if n in required]
            if not keep:
                # count(*)-style plans reference no column; keep one (a
                # device column where there is one) for row accounting
                fields = plan.schema().fields
                keep = [next((f.name for f in fields
                              if not f.dtype.is_string), names[0])]
        if hasattr(plan.source, "with_pushdown"):
            scan_preds = [p for p in preds if p[0] in names]
            if keep is None and not scan_preds:
                return plan
            src = plan.source.with_pushdown(keep, scan_preds)
            return L.LogicalScan(src.schema(), src, src.describe(), plan.fmt)
        if keep is None:
            return plan
        src = plan.source.pruned(keep)
        return L.LogicalScan(src.schema(), src, plan.desc, plan.fmt)
    if isinstance(plan, L.Project):
        kept = plan.exprs
        if required is not None:
            kept = [(n, e) for n, e in plan.exprs if n in required] \
                or plan.exprs[:1]
        # predicates pass through pure column pass-throughs
        mapping = {n: e.name for n, e in kept
                   if isinstance(e, E.UnresolvedColumn)}
        child = prune_columns(plan.children[0], _refs(e for _, e in kept),
                              [(mapping[c], op, v) for c, op, v in preds
                               if c in mapping])
        return L.Project(child, kept)
    if isinstance(plan, L.Filter):
        need = None if required is None else (
            required | plan.condition.references())
        return L.Filter(prune_columns(
            plan.children[0], need,
            list(preds) + extract_predicates(plan.condition)),
            plan.condition)
    if isinstance(plan, L.Aggregate):
        need = _refs(e for _, e in plan.group_exprs + plan.agg_exprs)
        return L.Aggregate(prune_columns(plan.children[0], need),
                           plan.group_exprs, plan.agg_exprs)
    if isinstance(plan, L.Distinct):
        # every column is a group key: the child keeps them all
        return L.Distinct(prune_columns(plan.children[0], None))
    if isinstance(plan, L.Sort):
        need = None if required is None else (
            required | _refs(o.expr for o in plan.orders))
        return L.Sort(prune_columns(plan.children[0], need, preds),
                      plan.orders, plan.global_sort)
    if isinstance(plan, L.Limit):
        # predicates never cross a limit (they would change the rows it
        # sees)
        return L.Limit(prune_columns(plan.children[0], required), plan.n)
    if isinstance(plan, L.Sample):
        # row positions do not depend on the columns: prune through it
        # (reference pushdown.py:231)
        return L.Sample(prune_columns(plan.children[0], required),
                        plan.fraction, plan.seed)
    if isinstance(plan, L.Generate):
        # the reference's pruning passes no operator it does not know, so
        # everything below a Generate is kept (pushdown.py:243)
        return L.Generate(prune_columns(plan.children[0], None),
                          plan.column, plan.out_name, plan.outer)
    if isinstance(plan, L.Window):
        # the child keeps what the plan above needs besides the window
        # columns, and every column the window expressions read (reference
        # pushdown.py:220); filters never move below a window (push_filters
        # leaves them above it), as that would change partition contents
        need = None
        if required is not None:
            wnames = {n for n, _ in plan.window_exprs}
            need = ({c for c in required if c not in wnames}
                    | _refs(e for _, e in plan.window_exprs))
        return L.Window(prune_columns(plan.children[0], need),
                        plan.window_exprs)
    if isinstance(plan, L.Cache):
        # a barrier: nothing is pruned or pushed through the cache
        return plan
    if isinstance(plan, L.Union):
        # the branches stay aligned column by column: nothing is pruned
        # through a union, and no predicate crosses it (reference
        # pushdown.py:206-208; the filters above were pushed into each
        # branch)
        return L.Union([prune_columns(c, None) for c in plan.children])
    if isinstance(plan, L.Join):
        lnames = set(plan.children[0].schema().names())
        rnames = set(plan.children[1].schema().names())
        lreq = rreq = None
        # a semi or anti join outputs the left side only, so what the plan
        # above requires leaves its right side just the keys (and a
        # condition's columns), as the reference prunes (pushdown.py:190)
        if required is not None:
            lreq = {c for c in required if c in lnames} \
                | _refs(plan.left_keys)
            rreq = {c for c in required if c in rnames} \
                | _refs(plan.right_keys)
            if plan.condition is not None:
                crefs = plan.condition.references()
                lreq |= crefs & lnames
                rreq |= crefs & rnames
        left = _prune_to(prune_columns(plan.children[0], lreq), lreq)
        right = _prune_to(prune_columns(plan.children[1], rreq), rreq)
        return _rebuild_join(plan, left, right)
    raise NotImplementedError(f"no pruning rule for {type(plan).__name__}")
