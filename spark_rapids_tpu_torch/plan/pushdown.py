"""Scan predicate extraction (``spark_rapids_tpu/plan/pushdown.py``
counterpart: ``_conjuncts`` :36, ``_as_predicate`` :42,
``extract_predicates`` :61).

A filter's simple conjuncts — a column compared with a non-null literal,
``col IN (...)``, ``col IS NOT NULL`` — become ``(column, op, value)``
predicates.  ``optimizer.prune_columns`` carries them down to the file
scans below the filter, as the reference's ``optimize_scans`` (:75) does,
where they prune row groups and filter rows exactly on the host.  The
filter itself still runs on the device, so the predicates change no
result.
"""

from __future__ import annotations

from typing import List, Tuple

from .. import exprs as E

__all__ = ["extract_predicates"]

_OPS = {
    E.LessThan: "<", E.LessThanOrEqual: "<=",
    E.GreaterThan: ">", E.GreaterThanOrEqual: ">=", E.EqualTo: "==",
}
_FLIP = {"<": ">", "<=": ">=", ">": "<", ">=": "<=", "==": "=="}


def _conjuncts(e: E.Expression) -> List[E.Expression]:
    if isinstance(e, E.And):
        return _conjuncts(e.children[0]) + _conjuncts(e.children[1])
    return [e]


def _as_predicate(e: E.Expression):
    op = _OPS.get(type(e))
    if op is not None:
        l, r = e.children
        if isinstance(l, E.UnresolvedColumn) and isinstance(r, E.Literal) \
                and r.value is not None:
            return (l.name, op, r.value)
        if isinstance(r, E.UnresolvedColumn) and isinstance(l, E.Literal) \
                and l.value is not None:
            return (r.name, _FLIP[op], l.value)
        return None
    if isinstance(e, E.In) and isinstance(e.children[0], E.UnresolvedColumn):
        return (e.children[0].name, "in", list(e.values))
    if isinstance(e, E.IsNotNull) and isinstance(e.children[0],
                                                 E.UnresolvedColumn):
        return (e.children[0].name, "isnotnull", None)
    return None


def extract_predicates(condition: E.Expression
                       ) -> List[Tuple[str, str, object]]:
    """Simple pushable conjuncts of a filter condition (others are
    ignored)."""
    out = []
    for c in _conjuncts(condition):
        p = _as_predicate(c)
        if p is not None:
            out.append(p)
    return out
