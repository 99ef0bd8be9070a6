"""String predicates evaluated on the host once per distinct value
(``spark_rapids_tpu/plan/stringpred.py`` counterpart, single-column case:
``lowerable_kind``, ``lower_string_predicate_steps`` :176 and
``evaluate_host_expr`` :244).

Strings have no device representation in the port.  A boolean expression
whose only column input is one string column is a function of that
column's values, so it is evaluated on the host over the column's distinct
values (``np.unique``) and mapped back to the rows; the result joins the
stage as a device bool column (``EvalContext.extras``).  The uploaded
column is cached on the source's column object, as the dictionary
encodings of string group keys are, so warm runs neither evaluate nor
upload it again.  Null semantics are exact: the expression is also
evaluated on a null input.  Numpy only.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import exprs as E
from .. import types as T
from ..batch import HostStringColumn, upload

__all__ = ["PrecomputedCol", "lowerable_kind", "lower_string_predicate_steps",
           "evaluate_host_expr", "host_predicate_column"]

_COMPARE = {E.EqualTo: np.equal, E.LessThan: np.less,
            E.LessThanOrEqual: np.less_equal, E.GreaterThan: np.greater,
            E.GreaterThanOrEqual: np.greater_equal}
_HOST_NODES = tuple(_COMPARE) + (E.Not, E.And, E.Or, E.BoundReference,
                                 E.Literal)


class PrecomputedCol(E.Expression):
    """Placeholder for a host-evaluated column fed to the stage as
    ``ctx.extras[index]``."""

    def __init__(self, index: int, inner: E.Expression):
        self.index = index
        self.inner = inner
        self.dtype = inner.dtype
        self.nullable = inner.nullable
        self.children = ()

    def eval(self, ctx) -> E.Value:
        return ctx.extras[self.index]

    def _fp_extra(self):
        return f"{self.index}:{self.inner.fingerprint()}"


def _refs(e: E.Expression) -> List[E.BoundReference]:
    if isinstance(e, E.BoundReference):
        return [e]
    out = []
    for c in e.children:
        out += _refs(c)
    return out


def lowerable_kind(e: E.Expression) -> Optional[str]:
    """'device' for a bound boolean subtree the host evaluates per distinct
    value: only comparisons, NOT, AND, OR, literals and references to one
    string column.  None otherwise (plain references and literals pass
    through; device columns stay on the device)."""
    if e.dtype != T.BOOLEAN or isinstance(e, (E.BoundReference, E.Literal)):
        return None

    def ok(node):
        return isinstance(node, _HOST_NODES) and all(ok(c)
                                                    for c in node.children)

    refs = _refs(e)
    if not ok(e) or not refs:
        return None
    if not all(r.dtype is not None and r.dtype.is_string for r in refs):
        return None
    return "device" if len({r.ordinal for r in refs}) == 1 else None


def _rebuild(e: E.Expression, children) -> E.Expression:
    import copy
    out = copy.copy(e)
    out.children = tuple(children)
    return out


def _resolve_to_input(e: E.Expression, steps_before) -> Optional[E.Expression]:
    """``e`` with its references rewritten to the stage's input ordinals,
    through the host columns that earlier project steps pass along."""
    if isinstance(e, E.BoundReference):
        ord_ = e.ordinal
        for kind, payload in reversed(steps_before):
            if kind != "project":
                continue
            _, expr, src = payload[ord_]
            if expr is not None:
                return None
            ord_ = src
        return E.BoundReference(ord_, e.dtype, e.nullable, e.name)
    if not e.children:
        return e
    kids = []
    for c in e.children:
        r = _resolve_to_input(c, steps_before)
        if r is None:
            return None
        kids.append(r)
    return _rebuild(e, kids)


def lower_string_predicate_steps(steps):
    """Stage steps with every lowerable subtree replaced by a
    :class:`PrecomputedCol`.  Returns (steps, host_exprs): each host expr
    is (expression over the stage input, the string column's input
    ordinal)."""
    host_exprs: List[Tuple[E.Expression, int]] = []

    def lower(e, before):
        if lowerable_kind(e) is not None:
            resolved = _resolve_to_input(e, before)
            if resolved is None:
                raise NotImplementedError(
                    f"string predicate {e.fingerprint()} reads a computed "
                    f"column; only stage-input string columns are "
                    f"evaluated on the host (ROADMAP.md, modules to port, "
                    f"item 3)")
            host_exprs.append((resolved, _refs(resolved)[0].ordinal))
            return PrecomputedCol(len(host_exprs) - 1, e)
        if not e.children:
            return e
        kids = [lower(c, before) for c in e.children]
        if all(a is b for a, b in zip(kids, e.children)):
            return e
        return _rebuild(e, kids)

    out = []
    for kind, payload in steps:
        before = list(out)
        if kind == "filter":
            out.append((kind, lower(payload, before)))
        else:
            out.append((kind, [(n, None if e is None else lower(e, before),
                                src) for n, e, src in payload]))
    return out, host_exprs


def _eval_host(e: E.Expression, values: np.ndarray, valid: np.ndarray):
    """(data, valid) numpy arrays of ``e`` over the string ``values`` (the
    one column every reference reads) with Spark's null semantics."""
    n = len(values)
    if isinstance(e, E.BoundReference):
        return values, valid
    if isinstance(e, E.Literal):
        if e.value is None:
            return np.zeros(n, dtype=object), np.zeros(n, dtype=bool)
        return np.full(n, e.value, dtype=object), np.ones(n, dtype=bool)
    if isinstance(e, E.Not):
        d, v = _eval_host(e.children[0], values, valid)
        return ~d.astype(bool), v
    if isinstance(e, (E.And, E.Or)):
        ld, lv = _eval_host(e.children[0], values, valid)
        rd, rv = _eval_host(e.children[1], values, valid)
        ld, rd = ld.astype(bool), rd.astype(bool)
        lt, rt = ld & lv, rd & rv             # definitely true
        lf, rf = ~ld & lv, ~rd & rv           # definitely false
        if isinstance(e, E.And):
            return lt & rt, lf | rf | (lt & rt)
        return lt | rt, lt | rt | (lv & rv)
    op = _COMPARE[type(e)]
    ld, lv = _eval_host(e.children[0], values, valid)
    rd, rv = _eval_host(e.children[1], values, valid)
    ok = lv & rv
    data = np.zeros(n, dtype=bool)
    if ok.any():
        data[ok] = op(ld[ok].astype(str), rd[ok].astype(str))
    return data, ok


def evaluate_host_expr(expr: E.Expression, col: HostStringColumn
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-row (bool data, bool valid) of ``expr`` over one string column,
    evaluated once per distinct value and once on a null input."""
    n = len(col.data)
    valid = np.ones(n, dtype=bool) if col.valid is None else col.valid
    live = col.data[valid]
    if live.dtype.kind == "O":
        live = live.astype(str)
    uniq, inverse = np.unique(live, return_inverse=True)
    ud, uv = _eval_host(expr, uniq.astype(object),
                        np.ones(len(uniq), dtype=bool))
    nd, nv = _eval_host(expr, np.array([None], dtype=object),
                        np.zeros(1, dtype=bool))
    data = np.full(n, bool(nd[0]))
    ok = np.full(n, bool(nv[0]))
    inverse = inverse.reshape(-1)
    data[valid] = ud.astype(bool)[inverse]
    ok[valid] = uv[inverse]
    return data, ok


def host_predicate_column(expr: E.Expression, col: HostStringColumn,
                          device: torch.device) -> E.Value:
    """The device (data, valid) column of ``expr`` over ``col``, cached on
    the column object per expression and device."""
    if not isinstance(col, HostStringColumn):
        raise NotImplementedError(
            "a string predicate over dictionary codes (a string column an "
            "operator produced) is not ported yet (ROADMAP.md, modules to "
            "port, item 3)")
    cache = col.__dict__.setdefault("_pred_cache", {})
    key = (expr.fingerprint(), str(device))
    hit = cache.get(key)
    if hit is None:
        data, ok = evaluate_host_expr(expr, col)
        hit = (upload(torch.from_numpy(data), device),
               None if ok.all() else upload(torch.from_numpy(ok), device))
        cache[key] = hit
    return hit
