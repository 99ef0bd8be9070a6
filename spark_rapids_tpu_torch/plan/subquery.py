"""Scalar and IN/NOT-IN subqueries (``spark_rapids_tpu/plan/subquery.py``
counterpart).

The rewrites run on the logical plan at ``collect()`` time, before
planning, so filter pushdown, column pruning and physical planning see
plain filters and joins:

* ``ScalarSubquery(plan)``: the subplan runs (its own subqueries resolved
  first), at most one row comes back, and its value replaces the marker as
  a Literal (None when no row comes back).
* ``In(col, InSubqueryValues(plan))`` as a filter conjunct: a left-semi
  join with the subplan.
* ``Not(In(col, ...))`` as a filter conjunct: SQL NOT IN over one run of
  the subplan's distinct values.  An empty set keeps every row; a NULL in
  the set keeps none; otherwise null keys drop and the rest anti-join, or,
  for at most 1024 values, filter by a literal ``NOT IN`` list.
* IN markers inside a compound predicate (an OR): each becomes an
  existence join whose boolean column the predicate reads
  (``plan/join_exec.py``'s existence join, ``csrc/cond_join.cu``); the
  boolean columns are projected away above.  A negated marker there
  raises, as in the reference.

``collect(subplan) -> rows`` is the session's executor
(``Session._collect_rows``); the subplans it is given are subquery-free.
"""

from __future__ import annotations

import copy
from typing import Callable, List

from .. import exprs as E
from . import logical as L

__all__ = ["ScalarSubquery", "InSubqueryValues", "resolve_subqueries"]

Collect = Callable[[L.LogicalPlan], list]


class ScalarSubquery(E.Expression):
    """A one-column subquery's single value; replaced by a Literal before
    planning, never evaluated (reference :32)."""

    def __init__(self, plan: L.LogicalPlan):
        self.plan = plan
        self.children = ()
        f = plan.schema().fields
        if len(f) != 1:
            raise ValueError(f"scalar subquery must produce exactly one "
                             f"column, got {len(f)}")
        self.dtype = f[0].dtype
        self.nullable = True

    def references(self):
        return set()

    def _fp_extra(self):
        return f"scalar@{id(self.plan)}"


class InSubqueryValues(E.Expression):
    """The values of ``col IN (subquery)``, carried as ``In.values``; the
    filter holding it is rewritten to a join (reference :54)."""

    def __init__(self, plan: L.LogicalPlan):
        self.plan = plan
        self.children = ()
        f = plan.schema().fields
        if len(f) != 1:
            raise ValueError(f"IN subquery must produce exactly one column, "
                             f"got {len(f)}")
        self.dtype = f[0].dtype


def in_subquery(child: E.Expression, plan: L.LogicalPlan) -> E.In:
    """``child IN (plan)``: an ``In`` whose values are the subquery's."""
    from .. import types as T
    e = E.In.__new__(E.In)
    e.children = (child,)
    e.values = InSubqueryValues(plan)
    e.dtype = T.BOOLEAN
    e.nullable = True
    return e


def _is_marker(e: E.Expression) -> bool:
    return isinstance(e, E.In) and isinstance(getattr(e, "values", None),
                                              InSubqueryValues)


def resolve_subqueries(plan: L.LogicalPlan, collect: Collect
                       ) -> L.LogicalPlan:
    """``plan`` with every subquery rewritten; ``collect`` runs a subplan
    through the engine."""
    out = _walk(plan, collect)
    _check_no_markers(out)
    return out


def _check_no_markers(node: L.LogicalPlan) -> None:
    """IN subqueries survive only as filter conjuncts (or inside an OR
    there); anywhere else raise a clear error."""
    def scan(e):
        if _is_marker(e):
            raise NotImplementedError(
                "IN (subquery) is only supported as a top-level filter "
                "conjunct (optionally negated); rewrite OR/projection "
                "uses with explicit joins")
        for c in e.children:
            scan(c)

    for e in _exprs_of(node):
        scan(e)
    for c in node.children:
        _check_no_markers(c)


def _exprs_of(node: L.LogicalPlan) -> List[E.Expression]:
    if isinstance(node, L.Filter):
        return [node.condition]
    if isinstance(node, L.Project):
        return [e for _, e in node.exprs]
    if isinstance(node, L.Aggregate):
        return [e for _, e in node.group_exprs + node.agg_exprs]
    if isinstance(node, L.Join) and node.condition is not None:
        return [node.condition]
    return []


def _walk(node: L.LogicalPlan, collect: Collect) -> L.LogicalPlan:
    if isinstance(node, L.Cache):
        return node  # shared state: never rebuilt (reference :108)
    if isinstance(node, L.Filter) and _has_in_subquery(node.condition):
        return _rewrite_in_filter(node, collect)
    kids = tuple(_walk(c, collect) for c in node.children)
    if not all(n is o for n, o in zip(kids, node.children)):
        node = copy.copy(node)
        node.children = kids
    return _map_exprs(node, lambda e: _resolve_scalar(e, collect))


def _resolve_scalar(e: E.Expression, collect: Collect) -> E.Expression:
    if isinstance(e, ScalarSubquery):
        rows = collect(resolve_subqueries(e.plan, collect))
        if len(rows) > 1:
            raise ValueError(f"scalar subquery returned {len(rows)} rows "
                             f"(expected <=1)")
        return E.Literal(rows[0][0] if rows else None, e.dtype)
    if not e.children:
        return e
    kids = tuple(_resolve_scalar(c, collect) for c in e.children)
    if all(k is c for k, c in zip(kids, e.children)):
        return e
    out = copy.copy(e)
    out.children = kids
    return out


def _map_exprs(node: L.LogicalPlan, fn) -> L.LogicalPlan:
    """``node`` with ``fn`` applied to each of its expressions (a copy
    where any changed)."""
    if isinstance(node, L.Filter):
        cond = fn(node.condition)
        if cond is node.condition:
            return node
        out = copy.copy(node)
        out.condition = cond
        return out
    if isinstance(node, L.Project):
        exprs = [(n, fn(e)) for n, e in node.exprs]
        if all(a[1] is b[1] for a, b in zip(exprs, node.exprs)):
            return node
        out = copy.copy(node)
        out.exprs = exprs
        return out
    if isinstance(node, L.Aggregate):
        g = [(n, fn(e)) for n, e in node.group_exprs]
        a = [(n, fn(e)) for n, e in node.agg_exprs]
        if all(x[1] is y[1] for x, y in zip(g + a, node.group_exprs
                                           + node.agg_exprs)):
            return node
        out = copy.copy(node)
        out.group_exprs, out.agg_exprs = g, a
        return out
    if isinstance(node, L.Join) and node.condition is not None:
        cond = fn(node.condition)
        if cond is node.condition:
            return node
        out = copy.copy(node)
        out.condition = cond
        return out
    return node


def _has_in_subquery(e: E.Expression) -> bool:
    return _is_marker(e) or any(_has_in_subquery(c) for c in e.children)


def _extract_positive_markers(e: E.Expression, under_not: bool,
                              acc: list) -> None:
    """The IN markers of a compound predicate; one under a NOT there would
    need NOT IN's null semantics, which an existence column cannot carry:
    raise."""
    if _is_marker(e):
        if under_not:
            raise NotImplementedError(
                "negated IN (subquery) inside a compound predicate is "
                "not supported (null semantics need null-aware "
                "anti-join); rewrite with explicit joins")
        acc.append(e)
        return
    for c in e.children:
        _extract_positive_markers(c, under_not or isinstance(e, E.Not), acc)


def _substitute(e: E.Expression, mapping: dict) -> E.Expression:
    if id(e) in mapping:
        return mapping[id(e)]
    if not e.children:
        return e
    kids = tuple(_substitute(c, mapping) for c in e.children)
    if all(k is c for k, c in zip(kids, e.children)):
        return e
    out = copy.copy(e)
    out.children = kids
    return out


def _conjuncts(e: E.Expression) -> List[E.Expression]:
    if isinstance(e, E.And):
        return _conjuncts(e.children[0]) + _conjuncts(e.children[1])
    return [e]


def _and_all(conjs: List[E.Expression]) -> E.Expression:
    out = conjs[0]
    for c in conjs[1:]:
        out = E.And(out, c)
    return out


def _rewrite_in_filter(node: L.Filter, collect: Collect) -> L.LogicalPlan:
    """A filter with IN-subquery conjuncts → semi, anti or existence joins
    above its (resolved) child; the other conjuncts stay a filter
    (reference :246)."""
    out = _walk(node.children[0], collect)
    keep_names = node.schema().names()
    n_existence = 0
    plain: List[E.Expression] = []
    for ci, c in enumerate(_conjuncts(node.condition)):
        neg, core = False, c
        if isinstance(core, E.Not) and _has_in_subquery(core.children[0]):
            neg, core = True, core.children[0]
        if _is_marker(core):
            sub = resolve_subqueries(core.values.plan, collect)
            key = core.children[0]
            sub_name = sub.schema().fields[0].name
            # a fixed alias no outer column is named
            alias = f"__in_sq{ci}_{sub_name}"
            sub_proj = L.Project(sub, [(alias, E.UnresolvedColumn(sub_name))])
            if not neg:
                out = L.Join(out, sub_proj, [key], [E.UnresolvedColumn(alias)],
                             how="semi")
                continue
            vals = [r[0] for r in collect(L.Distinct(sub_proj))]
            if not vals:
                continue  # NOT IN (empty) holds for every row
            if any(v is None for v in vals):
                out = L.Filter(out, E.Literal(False))
                continue
            out = L.Filter(out, E.IsNotNull(key))
            if len(vals) <= 1024:
                out = L.Filter(out, E.Not(E.In(key, vals)))
                continue
            out = L.Join(out, sub_proj, [key], [E.UnresolvedColumn(alias)],
                         how="anti")
        elif _has_in_subquery(c):
            markers: list = []
            _extract_positive_markers(c, False, markers)
            mapping = {}
            for mk in markers:
                sub = resolve_subqueries(mk.values.plan, collect)
                sub_name = sub.schema().fields[0].name
                ex_alias = f"__exists{ci}_{n_existence}"
                n_existence += 1
                sub_proj = L.Project(sub, [(f"__ex_key_{ex_alias}",
                                            E.UnresolvedColumn(sub_name))])
                j = L.Join(out, sub_proj, [mk.children[0]],
                           [E.UnresolvedColumn(f"__ex_key_{ex_alias}")],
                           how="existence")
                j.exists_col = ex_alias
                out = j
                mapping[id(mk)] = E.UnresolvedColumn(ex_alias)
            plain.append(_substitute(c, mapping))
        else:
            plain.append(c)
    if plain:
        # scalar subqueries of the other conjuncts resolve before a Project
        # hides the filter from the mapper
        out = _map_exprs(L.Filter(out, _and_all(plain)),
                         lambda e: _resolve_scalar(e, collect))
    if n_existence:
        out = L.Project(out, [(n, E.UnresolvedColumn(n)) for n in keep_names])
    return out
