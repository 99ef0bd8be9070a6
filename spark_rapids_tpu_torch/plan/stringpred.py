"""String expressions evaluated on the host once per distinct value
(``spark_rapids_tpu/plan/stringpred.py`` counterpart, single-column case:
``lowerable_kind``, ``lower_string_predicate_steps`` :176 and
``evaluate_host_expr`` :244).

Strings have no device representation in the port.  An expression whose
only column input is one string column is a function of that column's
values, so the stage evaluates it on the host over the distinct values and
maps the results back to the rows:

* a boolean expression (comparisons, NOT/AND/OR, IN, IS [NOT] NULL, LIKE,
  over the column or a substring of it) becomes a device bool column;
* a string-valued one (``substring``) becomes a new dictionary and the
  device int32 codes of its rows (a ``DictStringColumn``), which later
  steps, joins, aggregates and sorts read as any dictionary column.

The column may be a host column (a scan's; its distinct values by
``np.unique``, the result cached on the column object, so warm runs
neither evaluate nor upload again) or the dictionary codes a join, an
exchange or an earlier string step produced (evaluated once per dictionary
entry, cached per dictionary, then gathered by code on the device).  The
reference instead moves side-pure predicates below joins
(``optimizer.py:167 _extract_bool_subtrees``); the results are equal.
Null semantics are exact: the expression is also evaluated on a null
input.  Numpy only.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import exprs as E
from .. import types as T
from ..batch import DictStringColumn, HostStringColumn, upload
from ..ops.strings import distinct_strings
from ..stringfns import Like, Substring

__all__ = ["HostStringExpr", "lowerable_kind", "lower_string_predicate_steps",
           "evaluate_host_expr", "host_predicate_column",
           "host_string_column"]

_COMPARE = {E.EqualTo: np.equal, E.LessThan: np.less,
            E.LessThanOrEqual: np.less_equal, E.GreaterThan: np.greater,
            E.GreaterThanOrEqual: np.greater_equal}
_HOST_NODES = tuple(_COMPARE) + (E.Not, E.And, E.Or, E.In, E.IsNull,
                                 E.IsNotNull, Like, Substring,
                                 E.BoundReference, E.Literal)


class HostStringExpr(E.Expression):
    """A bound expression over the string column at ``ordinal`` of the
    step's input, evaluated on the host from ``ctx.host[ordinal]``."""

    def __init__(self, inner: E.Expression, ordinal: int):
        self.inner = inner
        self.ordinal = ordinal
        self.dtype = inner.dtype
        self.nullable = inner.nullable
        self.children = ()

    def eval(self, ctx) -> E.Value:
        return host_predicate_column(self.inner, ctx.host[self.ordinal],
                                     ctx.device)

    def column(self, ctx) -> DictStringColumn:
        """The string-valued result as dictionary codes."""
        return host_string_column(self.inner, ctx.host[self.ordinal],
                                  ctx.device)

    def _fp_extra(self):
        return f"{self.ordinal}:{self.inner.fingerprint()}"


def _refs(e: E.Expression) -> List[E.BoundReference]:
    if isinstance(e, E.BoundReference):
        return [e]
    out = []
    for c in e.children:
        out += _refs(c)
    return out


def lowerable_kind(e: E.Expression) -> Optional[str]:
    """'device' for a bound boolean subtree and 'string' for a string-valued
    one that the host evaluates per distinct value: only the host nodes
    above, literals and references to one string column.  None otherwise
    (plain references and literals pass through; device columns stay on
    the device)."""
    if e.dtype is None or isinstance(e, (E.BoundReference, E.Literal)):
        return None
    if e.dtype != T.BOOLEAN and not e.dtype.is_string:
        return None

    def ok(node):
        return isinstance(node, _HOST_NODES) and all(ok(c)
                                                    for c in node.children)

    refs = _refs(e)
    if not ok(e) or not refs:
        return None
    if not all(r.dtype is not None and r.dtype.is_string for r in refs):
        return None
    if len({r.ordinal for r in refs}) != 1:
        return None
    return "device" if e.dtype == T.BOOLEAN else "string"


def _rebuild(e: E.Expression, children) -> E.Expression:
    import copy
    out = copy.copy(e)
    out.children = tuple(children)
    if hasattr(out, "_rebind"):  # CASE WHEN keeps its branches apart
        out._rebind()
    return out


def lower_string_predicate_steps(steps):
    """Stage steps with every lowerable subtree replaced by a
    :class:`HostStringExpr` over the step's input."""

    def lower(e):
        if lowerable_kind(e) is not None:
            return HostStringExpr(e, _refs(e)[0].ordinal)
        if not e.children:
            return e
        kids = [lower(c) for c in e.children]
        if all(a is b for a, b in zip(kids, e.children)):
            return e
        return _rebuild(e, kids)

    out = []
    for kind, payload in steps:
        if kind == "filter":
            out.append((kind, lower(payload)))
        else:
            out.append((kind, [(n, None if e is None else lower(e), src)
                               for n, e, src in payload]))
    return out


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
    if isinstance(e, (E.IsNull, E.IsNotNull)):
        _, v = _eval_host(e.children[0], values, valid)
        return (~v if isinstance(e, E.IsNull) else v.copy()), \
            np.ones(n, dtype=bool)
    if isinstance(e, (E.In, Like, Substring)):
        d, v = _eval_host(e.children[0], values, valid)
        live = d[v].astype(str)
        if isinstance(e, E.In):
            want = [x for x in e.values if x is not None]
            hit = np.zeros(n, dtype=bool)
            hit[v] = np.isin(live, np.array(want, dtype=str)) if want \
                else False
            if len(want) < len(e.values):
                v = v & hit
            return hit, v
        out = np.zeros(n, dtype=bool if isinstance(e, Like) else object)
        out[v] = e.apply(live)
        return out, v
    op = _COMPARE[type(e)]
    ld, lv = _eval_host(e.children[0], values, valid)
    rd, rv = _eval_host(e.children[1], values, valid)
    ok = lv & rv
    data = np.zeros(n, dtype=bool)
    if ok.any():
        data[ok] = op(ld[ok].astype(str), rd[ok].astype(str))
    return data, ok


def evaluate_host_expr(expr: E.Expression, values: np.ndarray):
    """(per-value data, per-value valid, null-input data, null-input
    valid) of ``expr`` over distinct non-null string ``values``."""
    vals = np.asarray(values, dtype=object)
    ud, uv = _eval_host(expr, vals, np.ones(len(vals), dtype=bool))
    nd, nv = _eval_host(expr, np.array([None], dtype=object),
                        np.zeros(1, dtype=bool))
    return ud, uv, nd[0], bool(nv[0])


def _distinct(col: HostStringColumn):
    """(distinct live values, each live row's index into them, live
    mask-or-None) of a host string column, computed once per column
    object."""
    hit = col.__dict__.get("_distinct")
    if hit is None:
        live = col.data if col.valid is None else col.data[col.valid]
        hit = col._distinct = distinct_strings(live)
    return hit[0], hit[1], col.valid


# per dictionary values array (a join's or an earlier step's), the
# device tables of each expression; the entry holds the array, so its id
# cannot be reused while cached
_DICT_CACHE: Dict[tuple, tuple] = {}
_DICT_CACHE_MAX = 256


def _dict_cached(dictionary: np.ndarray, key: tuple, make):
    full = (id(dictionary),) + key
    hit = _DICT_CACHE.get(full)
    if hit is None or hit[0] is not dictionary:
        if len(_DICT_CACHE) >= _DICT_CACHE_MAX:
            _DICT_CACHE.clear()
        hit = (dictionary, make())
        _DICT_CACHE[full] = hit
    return hit[1]


def _codes_or_null(col: DictStringColumn, n_entries: int) -> torch.Tensor:
    """Each row's dictionary code, or ``n_entries`` (the null entry of a
    per-entry table) where the row is null."""
    codes = col.codes.to(torch.int64)
    if col.valid is None:
        return codes
    return torch.where(col.valid, codes, n_entries)


def host_predicate_column(expr: E.Expression, col, device: torch.device
                          ) -> E.Value:
    """The device (data, valid) column of boolean ``expr`` over string
    column ``col`` (host or dictionary codes), cached per expression and
    device on the column object or its dictionary."""
    key = (expr.fingerprint(), str(device))
    if isinstance(col, DictStringColumn):
        def make():
            ud, uv, nd, nv = evaluate_host_expr(expr, col.dictionary)
            data = np.append(ud.astype(bool), bool(nd))
            ok = np.append(uv, nv)
            return (upload(torch.from_numpy(data), col.codes.device),
                    None if ok.all() else upload(torch.from_numpy(ok),
                                                 col.codes.device))
        td, tv = _dict_cached(col.dictionary, ("pred",) + key, make)
        idx = _codes_or_null(col, len(col.dictionary))
        return td[idx], None if tv is None else tv[idx]
    if not isinstance(col, HostStringColumn):
        raise TypeError(f"a string expression over {type(col).__name__}")
    cache = col.__dict__.setdefault("_pred_cache", {})
    hit = cache.get(key)
    if hit is None:
        uniq, inverse, valid = _distinct(col)
        ud, uv, nd, nv = evaluate_host_expr(expr, uniq)
        n = len(col.data)
        data, ok = np.full(n, bool(nd)), np.full(n, nv)
        rows = slice(None) if valid is None else valid
        data[rows] = ud.astype(bool)[inverse]
        ok[rows] = uv[inverse]
        hit = (upload(torch.from_numpy(data), device),
               None if ok.all() else upload(torch.from_numpy(ok), device))
        cache[key] = hit
    return hit


def _new_dictionary(results: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(dictionary values as an object array, code of each result)."""
    values, codes = np.unique(np.asarray(results, dtype=str),
                              return_inverse=True)
    dictionary = np.empty(len(values), dtype=object)
    dictionary[:] = values.tolist()
    return dictionary, codes.reshape(-1).astype(np.int32)


def host_string_column(expr: E.Expression, col, device: torch.device
                       ) -> DictStringColumn:
    """String-valued ``expr`` (null on a null input) over string column
    ``col`` as a new dictionary and its device codes, cached per
    expression and device on the column object or its dictionary."""
    key = (expr.fingerprint(), str(device))

    def results(values):
        ud, uv, _, _ = evaluate_host_expr(expr, values)
        if not uv.all():
            raise NotImplementedError(
                f"{expr.fingerprint()} is null on a non-null input")
        return ud

    if isinstance(col, DictStringColumn):
        def make():
            dictionary, codes = _new_dictionary(results(col.dictionary)) \
                if len(col.dictionary) else (np.empty(0, dtype=object),
                                             np.zeros(0, dtype=np.int32))
            remap = np.append(codes, np.int32(0))
            return dictionary, upload(torch.from_numpy(remap),
                                      col.codes.device)
        dictionary, remap = _dict_cached(col.dictionary, ("str",) + key, make)
        return DictStringColumn(remap[col.codes.to(torch.int64)], col.valid,
                                dictionary)
    if not isinstance(col, HostStringColumn):
        raise TypeError(f"a string expression over {type(col).__name__}")
    cache = col.__dict__.setdefault("_pred_cache", {})
    hit = cache.get(key)
    if hit is None:
        uniq, inverse, valid = _distinct(col)
        dictionary, codes = _new_dictionary(results(uniq)) if len(uniq) \
            else (np.empty(0, dtype=object), np.zeros(0, dtype=np.int32))
        rows = np.zeros(len(col.data), dtype=np.int32)
        rows[slice(None) if valid is None else valid] = codes[inverse]
        hit = (upload(torch.from_numpy(rows), device),
               None if valid is None else upload(torch.from_numpy(valid),
                                                 device), dictionary)
        cache[key] = hit
    return DictStringColumn(hit[0], hit[1], hit[2])
