"""Window expressions: specs, ranking functions, framed aggregates.

Counterpart of ``spark_rapids_tpu/windowfns.py``.  A ``WindowExpression``
wraps a window function (a ranking function, lag/lead, or an aggregate)
with its partition/order spec and frame; ``WindowExec`` evaluates every
expression of one spec over one sort (``ops/window.py``).

Frame model: ``WindowFrame(kind, lo, hi)`` with ``kind`` "rows" or
"range", ``lo``/``hi`` offsets from the current row (rows) or its order
key (range), ``None`` for unbounded.  ("range", None, 0) is Spark's default
frame with an ORDER BY, ("rows", None, None) without.

Aggregates over frames (``_agg_window_eval``, reference :247): sum, count,
count(*), avg, min and max over unbounded frames (a partition reduction),
running frames (a segmented scan, read at the peer group's last row for
RANGE), bounded ROWS frames and bounded RANGE frames over one integral or
date order key.  A frame with no valid value gives null (count gives 0).
FIRST and LAST raise, as their grouped forms do (ROADMAP queue 2 row 4).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from . import types as T
from .exprs import AggregateExpression, EvalContext, Expression, Literal, \
    Value
from .ops import window as W

__all__ = ["WindowFrame", "WindowSpecDef", "WindowExpression",
           "WindowFunction", "RowNumber", "Rank", "DenseRank", "PercentRank",
           "CumeDist", "NTile", "Lag", "Lead", "device_support_reason"]


@dataclass(frozen=True)
class WindowFrame:
    kind: str  # "rows" | "range"
    lo: Optional[int]  # None = unbounded preceding
    hi: Optional[int]  # None = unbounded following

    def fingerprint(self) -> str:
        return f"{self.kind}[{self.lo},{self.hi}]"

    @property
    def is_unbounded_both(self) -> bool:
        return self.lo is None and self.hi is None

    @property
    def is_running(self) -> bool:
        return self.lo is None and self.hi == 0


class WindowSpecDef:
    """partition_by + order_by + frame (bound or unbound expressions)."""

    def __init__(self, partition_by: Sequence[Expression],
                 order_by: Sequence,  # List[SortOrder]
                 frame: Optional[WindowFrame] = None,
                 frame_explicit: bool = False):
        self.partition_by = list(partition_by)
        self.order_by = list(order_by)
        # an explicitly set frame survives later order_by() calls (PySpark
        # WindowSpec semantics); only the implicit default is recomputed
        self.frame_explicit = frame_explicit and frame is not None
        if frame is None:
            frame = (WindowFrame("range", None, 0) if self.order_by
                     else WindowFrame("rows", None, None))
        self.frame = frame

    def spec_fingerprint(self) -> str:
        """Identity of the sort (partition + order): expressions sharing it
        share one sort; the frame is not part of it."""
        parts = [e.fingerprint() for e in self.partition_by]
        ords = [f"{o.expr.fingerprint()}:{o.ascending}:{o.nulls_first}"
                for o in self.order_by]
        return "P(" + ",".join(parts) + ")O(" + ",".join(ords) + ")"


class WindowFunction(Expression):
    """Base of the pure window functions (ranking family, lag/lead)."""

    def window_eval(self, w: W.SortedWindowContext,
                    ectx: EvalContext) -> Value:
        raise NotImplementedError


class _RankLike(WindowFunction):
    fn = "?"

    def __init__(self):
        self.children = ()
        self.dtype = T.FLOAT64 if self.fn in ("percent_rank",
                                              "cume_dist") else T.INT32
        self.nullable = False

    def window_eval(self, w, ectx):
        return W.win_rank(self.fn, w), None


class RowNumber(_RankLike):
    fn = "row_number"


class Rank(_RankLike):
    fn = "rank"


class DenseRank(_RankLike):
    fn = "dense_rank"


class PercentRank(_RankLike):
    fn = "percent_rank"


class CumeDist(_RankLike):
    fn = "cume_dist"


class NTile(WindowFunction):
    def __init__(self, n: int):
        if n < 1:
            raise ValueError("ntile requires n >= 1")
        self.n = n
        self.children = ()
        self.dtype = T.INT32
        self.nullable = False

    def _fp_extra(self):
        return f"n={self.n}"

    def window_eval(self, w, ectx):
        return W.win_rank("ntile", w, self.n), None


class Lag(WindowFunction):
    offset_sign = 1

    def __init__(self, child: Expression, offset: int = 1, default=None):
        self.offset = offset
        self.default = default
        self.children = (child,) if default is None else (
            child, default if isinstance(default, Expression)
            else Literal(default))
        if child.resolved():
            self._rebind()

    def _rebind(self):
        self.dtype = self.children[0].dtype
        self.nullable = True

    def _fp_extra(self):
        return f"off={self.offset}:{self.dtype}"

    def window_eval(self, w, ectx):
        val = w.full(self.children[0].eval(ectx))
        default = None
        if len(self.children) > 1:
            dd, dv = w.full(self.children[1].eval(ectx))
            default = (dd.to(val[0].dtype), dv)
        return W.win_shift(w, val, self.offset_sign * self.offset, default)


class Lead(Lag):
    offset_sign = -1


def _not_ported(what: str, where: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md "
                               f"{where})")


class WindowExpression(Expression):
    """``func OVER spec``.  children = (func, *partition_by, *order_exprs)
    so that binding resolves every subtree; ``_rebind`` reassembles."""

    def __init__(self, func: Expression, spec: WindowSpecDef):
        self.func = func
        self.spec = spec
        self.children = ((func,) + tuple(spec.partition_by)
                         + tuple(o.expr for o in spec.order_by))
        if all(c.resolved() for c in self.children):
            self._rebind()

    def _rebind(self):
        from .plan.logical import SortOrder
        n_part = len(self.spec.partition_by)
        self.func = self.children[0]
        part = list(self.children[1:1 + n_part])
        ord_exprs = list(self.children[1 + n_part:])
        orders = [SortOrder(e, o.ascending, o.nulls_first)
                  for e, o in zip(ord_exprs, self.spec.order_by)]
        self.spec = WindowSpecDef(part, orders, self.spec.frame,
                                  frame_explicit=self.spec.frame_explicit)
        if isinstance(self.func, AggregateExpression):
            if self.func.children and self.func.children[0].resolved():
                self.func._resolve()
        self.dtype = self.func.dtype
        self.nullable = (self.func.nullable
                         or isinstance(self.func, AggregateExpression))

    def _fp_extra(self):
        return f"{self.spec.spec_fingerprint()}:{self.spec.frame.fingerprint()}"

    def window_eval(self, w: W.SortedWindowContext, ectx: EvalContext
                    ) -> Value:
        if isinstance(self.func, WindowFunction):
            return self.func.window_eval(w, ectx)
        return self._agg_window_eval(w, ectx)

    def _positions(self, w, ectx):
        """[lo_pos, hi_pos] of a bounded (not running) frame."""
        frame = self.spec.frame
        if frame.kind == "rows":
            return W.frame_rows(w, frame.lo, frame.hi)
        o = self.spec.order_by[0]
        d, v = w.full(o.expr.eval(ectx))
        key = (d.to(torch.int32) if d.element_size() < 4 else d, v)
        return W.frame_range(w, key, frame.lo, frame.hi,
                             descending=not o.ascending,
                             nulls_first=o.nulls_first)

    def _framed(self, w, pos, vals, mask, op: str):
        """The frame's sum (``vals`` None: count of ``mask``), or its min
        or max over an unbounded or running frame; ``pos`` holds a bounded
        frame's (lo, hi) positions."""
        run = (W.running_count(w, mask) if vals is None
               else W.running(w, vals, mask, op))
        if pos is not None:
            return W.frame_sum(run, vals, mask, *pos)
        if self.spec.frame.is_unbounded_both:
            return W.partition_reduce(w, run)
        if self.spec.frame.kind == "range":
            return W.win_take(run, w.peer_end_pos)
        return run

    def _agg_window_eval(self, w, ectx) -> Value:
        agg = self.func
        fname = agg.func
        frame = self.spec.frame
        if fname in ("first", "last"):
            raise _not_ported(f"the window aggregate {fname}",
                              "queue 2 row 4")
        if fname not in ("count(*)", "count", "sum", "avg", "min", "max"):
            raise _not_ported(f"the window aggregate {fname}", "item 7")
        bounded = not (frame.is_unbounded_both or frame.is_running)
        pos = self._positions(w, ectx) if bounded else None
        if fname == "count(*)":
            return self._framed(w, pos, None, None, "sum"), None
        d, v = w.full(agg.children[0].eval(ectx))
        if fname == "count":
            return self._framed(w, pos, None, v, "sum"), None
        if fname in ("min", "max"):
            wide = d.to(torch.float64 if d.is_floating_point()
                        else torch.int64)
            if bounded:
                out, ok = W.frame_minmax(wide, v, fname, *pos)
            else:
                out = self._framed(w, pos, wide, v, fname)
                ok = self._valid(w, pos, v)
            return out.to(self.dtype.torch_dtype), ok
        src = agg.children[0].dtype
        data = d.to(torch.float64 if fname == "avg" or src.is_floating
                    else torch.int64)
        s = self._framed(w, pos, data, v, "sum")
        if fname == "sum":
            return s.to(self.dtype.torch_dtype), self._valid(w, pos, v)
        cnt = self._framed(w, pos, None, v, "sum")
        if v is None and pos is None:
            return s / cnt.to(torch.float64), None
        ok = cnt > 0
        return s / torch.where(ok, cnt, torch.ones_like(cnt)).to(
            torch.float64), ok

    def _valid(self, w, pos, v) -> Optional[torch.Tensor]:
        """Whether each row's frame holds a valid value; None when every
        one does (a column without nulls, under an unbounded or running
        frame, which holds the row itself)."""
        if v is None and pos is None:
            return None
        return self._framed(w, pos, None, v, "sum") > 0


# Which (function, frame) pairs run on the device (reference :392).
_DEVICE_AGGS = {"sum", "count", "count(*)", "min", "max", "avg", "first",
                "last"}


def device_support_reason(wexpr: WindowExpression) -> Optional[str]:
    """None if this window expression lowers to the device; else why."""
    func = wexpr.func
    frame = wexpr.spec.frame
    if isinstance(func, (Rank, DenseRank, PercentRank, CumeDist, NTile)):
        if not wexpr.spec.order_by:
            return f"{type(func).__name__} requires an ORDER BY"
        return None
    if isinstance(func, (RowNumber, Lag, Lead)):
        return None
    if isinstance(func, AggregateExpression):
        if func.func not in _DEVICE_AGGS:
            return f"window aggregate {func.func} not on device"
        if frame.is_unbounded_both or frame.is_running \
                or frame.kind == "rows":
            return None
        ob = wexpr.spec.order_by
        if len(ob) != 1:
            return "bounded range frame needs exactly one order key"
        dt = ob[0].expr.dtype
        if dt is None or dt.kind not in (
                T.TypeKind.INT8, T.TypeKind.INT16, T.TypeKind.INT32,
                T.TypeKind.DATE, T.TypeKind.INT64, T.TypeKind.TIMESTAMP):
            return (f"bounded range frame over {dt} order key (needs an "
                    f"integer-representable key; CPU fallback)")
        return None
    return f"unknown window function {type(func).__name__}"
