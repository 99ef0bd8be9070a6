"""Expression IR with Spark SQL semantics, evaluated with torch tensor ops.

Counterpart of ``spark_rapids_tpu/exprs.py``, cut to the families the
ported TPC-H queries run: column references, literals (dates and decimals
included), comparisons, Kleene AND/OR and NOT, IN, IS [NOT] NULL,
+ - * / % pmod, unary minus, abs, IF, CASE WHEN, COALESCE and numeric and
decimal casts.  Decimals follow the reference's rules, which differ from
Spark's: operands are promoted to the wider decimal and rescaled
(``promote_physical``); a product's precision caps at 18 and its int64
product wraps; a quotient is a double.  Add, subtract and compare over
DECIMAL(p > 18) operands run in ``ops/wide_decimal.py`` (one
``csrc/wide_decimal.cu`` launch each on the card).  The reference traces
every expression of a stage into one XLA program; here each node is one or
a few eager elementwise torch ops on the batch's tensors.  Fusing them into
one hand-written kernel is later work (ROADMAP queue 2 row 1).

Null model: a value is a pair ``(data, valid)`` where ``valid`` is a bool
tensor or ``None`` (= all valid).  Semantics match Spark: nulls propagate
through arithmetic and comparisons, AND/OR are three-valued, and division
by zero gives null unless ANSI mode is on.  Literals are 0-dim tensors of
their physical dtype on the batch's device, so they broadcast without
materializing a column and never round-trip through the host.
"""

from __future__ import annotations

import copy
import datetime
import decimal
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import types as T
from .types import DataType, TypeSig

__all__ = [
    "Expression", "BoundReference", "UnresolvedColumn", "Literal",
    "Cast", "Add", "Subtract", "Multiply", "Divide",
    "EqualTo", "LessThan", "LessThanOrEqual", "GreaterThan",
    "GreaterThanOrEqual", "Not", "And", "Or", "Remainder", "Pmod",
    "UnaryMinus", "Abs", "In", "IsNull", "IsNotNull", "If", "CaseWhen",
    "Coalesce", "Value", "EvalContext", "bind", "promote_physical", "physical_literal",
    "AggregateExpression",
]

Value = Tuple[torch.Tensor, Optional[torch.Tensor]]  # (data, valid-or-None)


def _and_valid(a: Optional[torch.Tensor],
               b: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    if a is None:
        return b
    if b is None:
        return a
    return a & b


class Expression:
    """Base expression node.  Subclasses set ``dtype``/``nullable`` on
    resolve."""

    dtype: DataType = None
    nullable: bool = True
    children: Tuple["Expression", ...] = ()
    input_sig: TypeSig = TypeSig.device_compute
    output_sig: TypeSig = TypeSig.device_compute

    def eval(self, ctx: "EvalContext") -> Value:
        raise NotImplementedError(type(self).__name__)

    def resolved(self) -> bool:
        return self.dtype is not None and all(c.resolved()
                                              for c in self.children)

    def fingerprint(self) -> str:
        """Structural rendering, identical to the reference's (the explain
        string shows it)."""
        args = ",".join(c.fingerprint() for c in self.children)
        return f"{type(self).__name__}[{self._fp_extra()}]({args})"

    def _fp_extra(self) -> str:
        return str(self.dtype)

    def references(self) -> set:
        out = set()
        for c in self.children:
            out |= c.references()
        return out

    def __repr__(self):
        return self.fingerprint()


class EvalContext:
    """The inputs of one batch's evaluation.

    ``arrays[i]`` is the (data, valid) pair of bound ordinal ``i`` (None for
    a host column); ``active`` is the live-row mask; ``extras`` are the
    host-evaluated columns of string predicates (``plan/stringpred.py``).
    Under ANSI mode, expressions append per-row error masks to ``errors``
    and the stage raises if any is set."""

    def __init__(self, arrays: Sequence[Optional[Value]], num_rows: int,
                 device: torch.device, active: Optional[torch.Tensor] = None,
                 ansi: bool = False, host: Sequence = ()):
        self.arrays = list(arrays)
        self.host = list(host)
        self.num_rows = num_rows
        self.device = device
        self.active = active
        self.ansi = ansi
        self.errors: List[torch.Tensor] = []

    def record_error(self, err: torch.Tensor,
                     valid: Optional[torch.Tensor] = None) -> None:
        """Append a per-row ANSI error mask, confined to live valid rows."""
        if valid is not None:
            err = err & valid
        if self.active is not None:
            err = err & self.active
        self.errors.append(err)


# ---------------------------------------------------------------------------------
# Leaves
# ---------------------------------------------------------------------------------

class UnresolvedColumn(Expression):
    """A by-name column reference produced by the DataFrame API."""

    def __init__(self, name: str):
        self.name = name
        self.children = ()

    def resolved(self):
        return False

    def _fp_extra(self):
        return self.name

    def references(self):
        return {self.name}


class BoundReference(Expression):
    input_sig = TypeSig.device_compute + TypeSig.decimal128
    output_sig = TypeSig.device_compute + TypeSig.decimal128

    def __init__(self, ordinal: int, dtype: DataType, nullable: bool,
                 name: str = ""):
        self.ordinal = ordinal
        self.dtype = dtype
        self.nullable = nullable
        self.name = name
        self.children = ()

    def eval(self, ctx: EvalContext) -> Value:
        return ctx.arrays[self.ordinal]

    def _fp_extra(self):
        return f"{self.ordinal}:{self.dtype}"


class Literal(Expression):
    input_sig = TypeSig.device_compute + TypeSig.decimal128
    output_sig = TypeSig.device_compute + TypeSig.decimal128

    def __init__(self, value: Any, dtype: Optional[DataType] = None):
        self.value = value
        self.dtype = dtype if dtype is not None else _infer_literal_type(value)
        self.nullable = value is None
        self.children = ()

    def eval(self, ctx: EvalContext) -> Value:
        """A 0-dim tensor, or for a wide decimal the ``[2]`` limbs."""
        tdt = self.dtype.torch_dtype
        shape = (2,) if self.dtype.is_wide_decimal else ()
        if self.value is None:
            return (torch.zeros(shape, dtype=tdt, device=ctx.device),
                    torch.zeros((), dtype=torch.bool, device=ctx.device))
        v = physical_literal(self.value, self.dtype)
        if self.dtype.is_wide_decimal:
            from .ops.wide_decimal import limb_constant
            return torch.tensor(limb_constant(v), dtype=tdt,
                                device=ctx.device), None
        return torch.full((), v, dtype=tdt, device=ctx.device), None

    def _fp_extra(self):
        return f"{self.value!r}:{self.dtype}"


def physical_literal(v: Any, dtype: DataType):
    """A Python literal → its physical device value (a decimal: its
    unscaled integer, as the reference rounds it)."""
    if dtype.is_decimal:
        if isinstance(v, decimal.Decimal):
            return int(v.scaleb(dtype.scale).to_integral_value())
        return int(round(float(v) * 10 ** dtype.scale))
    if dtype.kind == T.TypeKind.DATE and isinstance(v, datetime.date):
        return (v - datetime.date(1970, 1, 1)).days
    if dtype.kind == T.TypeKind.TIMESTAMP and isinstance(v, datetime.datetime):
        epoch = datetime.datetime(1970, 1, 1, tzinfo=v.tzinfo)
        return int((v - epoch).total_seconds() * 1_000_000)
    return v


def _infer_literal_type(v: Any) -> DataType:
    if v is None:
        return T.NULLTYPE
    if isinstance(v, decimal.Decimal):
        _, digits, exp = v.as_tuple()
        scale = max(0, -exp)
        return T.decimal(min(max(len(digits), scale), 38), scale)
    if isinstance(v, bool):
        return T.BOOLEAN
    if isinstance(v, int):
        return T.INT32 if -(2**31) <= v < 2**31 else T.INT64
    if isinstance(v, float):
        return T.FLOAT64
    if isinstance(v, str):
        return T.STRING
    if isinstance(v, datetime.datetime):
        return T.TIMESTAMP
    if isinstance(v, datetime.date):
        return T.DATE
    if isinstance(v, np.generic):
        return {np.dtype(np.int32): T.INT32, np.dtype(np.int64): T.INT64,
                np.dtype(np.float32): T.FLOAT32,
                np.dtype(np.float64): T.FLOAT64}[v.dtype]
    raise TypeError(f"cannot infer literal type for {v!r}")


# ---------------------------------------------------------------------------------
# Cast (numeric, boolean and date subset of ops/cast.py cast_value)
# ---------------------------------------------------------------------------------

_INT_BOUNDS = {k: (int(np.iinfo(t).min), int(np.iinfo(t).max)) for k, t in (
    (T.TypeKind.INT8, np.int8), (T.TypeKind.INT16, np.int16),
    (T.TypeKind.INT32, np.int32), (T.TypeKind.INT64, np.int64))}
_MICROS_PER_DAY = 86_400_000_000


class Cast(Expression):
    input_sig = TypeSig.device_compute
    output_sig = TypeSig.device_compute

    def __init__(self, child: Expression, to: DataType, ansi: bool = False):
        self.children = (child,)
        self.dtype = to
        self.nullable = child.nullable
        self.ansi = ansi

    def eval(self, ctx: EvalContext) -> Value:
        data, valid = self.children[0].eval(ctx)
        src, dst = self.children[0].dtype, self.dtype
        out_dt = dst.torch_dtype
        if src == dst:
            return data, valid
        if src.kind == T.TypeKind.NULL:
            return (torch.zeros_like(data, dtype=out_dt),
                    torch.zeros_like(data, dtype=torch.bool))
        if dst.kind == T.TypeKind.BOOLEAN:
            return data != 0, valid
        if src.kind == T.TypeKind.DATE and dst.kind == T.TypeKind.TIMESTAMP:
            return data.to(torch.int64) * _MICROS_PER_DAY, valid
        if src.kind == T.TypeKind.TIMESTAMP and dst.kind == T.TypeKind.DATE:
            return torch.div(data, _MICROS_PER_DAY,
                             rounding_mode="floor").to(out_dt), valid
        ansi = self.ansi or ctx.ansi
        if src.is_decimal or dst.is_decimal:
            return _cast_decimal(ctx, data, valid, src, dst, ansi)
        if dst.is_integral and src.is_floating:
            # JVM semantics: NaN → 0, truncate toward zero, clamp at the
            # target's bounds (ANSI: those rows are errors)
            lo, hi = _INT_BOUNDS[dst.kind]
            if ansi:
                ctx.record_error(torch.isnan(data) | (data < float(lo))
                                 | (data > float(hi)), valid)
            d = torch.nan_to_num(data.to(torch.float64), nan=0.0,
                                 posinf=float(hi), neginf=float(lo))
            return torch.clamp(torch.trunc(d), float(lo),
                               float(hi)).to(out_dt), valid
        if dst.is_integral and src.is_integral and ansi:
            lo, hi = _INT_BOUNDS[dst.kind]
            if hi < _INT_BOUNDS[src.kind][1]:
                ctx.record_error((data < lo) | (data > hi), valid)
        # widening, int→float, and wrapping integer narrowing
        return data.to(out_dt), valid

    def _fp_extra(self):
        return f"->{self.dtype}"


def _cast_decimal(ctx, data, valid, src: DataType, dst: DataType,
                  ansi: bool) -> Value:
    """The decimal casts of the reference's ``ops/cast.py:92-110`` (narrow
    decimals): a value that needs more than ``dst.precision`` digits is
    null (an error under ANSI); decimal → integral floors."""
    def bounded(out, ok):
        if ansi:
            ctx.record_error(~ok, valid)
        return out, _and_valid(valid, ok)

    if src.is_wide_decimal or dst.is_wide_decimal:
        raise NotImplementedError(
            f"cast {src} -> {dst}: wide decimal casts are not ported "
            f"(ROADMAP.md item 7)")
    limit = 10 ** dst.precision if dst.is_decimal else None
    if src.is_decimal and dst.is_floating:
        return (data.to(dst.torch_dtype)
                / float(10 ** src.scale)).to(dst.torch_dtype), valid
    if src.is_decimal and dst.is_integral:
        return torch.div(data, 10 ** src.scale, rounding_mode="floor").to(
            dst.torch_dtype), valid
    if (src.is_integral or src.kind == T.TypeKind.BOOLEAN) \
            and dst.is_decimal:
        out = data.to(torch.int64) * 10 ** dst.scale
        return bounded(out, out.abs() < limit)
    if src.is_floating and dst.is_decimal:
        scaled = torch.round(data.to(torch.float64) * 10.0 ** dst.scale)
        ok = torch.isfinite(scaled) & (scaled.abs() < float(limit))
        return bounded(torch.where(ok, scaled, 0.0).to(torch.int64), ok)
    if src.is_decimal and dst.is_decimal:
        k = dst.scale - src.scale
        out = data * 10 ** k if k >= 0 else _round_div(data, 10 ** -k)
        return bounded(out, out.abs() < limit)
    raise NotImplementedError(f"cast {src} -> {dst} is not ported "
                              f"(ROADMAP.md item 8)")


# ---------------------------------------------------------------------------------
# Arithmetic
# ---------------------------------------------------------------------------------

def _round_div(x: torch.Tensor, d: int) -> torch.Tensor:
    """Integer division rounding half away from zero (reference :514)."""
    q = torch.div(x.abs() + d // 2, d, rounding_mode="floor")
    return torch.where(x >= 0, q, -q)


def promote_physical(data: torch.Tensor, src: DataType,
                     dst: DataType) -> torch.Tensor:
    """Convert a physical value from ``src``'s representation to ``dst``'s,
    honouring decimal scales (reference :368-420): decimal → float divides
    by 10^scale, decimal → decimal shifts by the scale difference (rounding
    half away from zero when it drops digits), an integral operand joining
    a decimal is multiplied in; a wide target lifts to limbs
    (``ops/wide_decimal.py``)."""
    if dst.is_wide_decimal:
        from .ops import wide_decimal as wd
        if src.is_decimal:
            k = dst.scale - src.scale
        else:
            data, k = data.to(torch.int64), dst.scale
        if k < 0:
            raise TypeError(f"wide-decimal down-scale {src} -> {dst} not "
                            f"supported on device")
        if src.is_wide_decimal and k == 0:
            return data
        return wd.wide_binary("lift", data, None, ka=k)
    if src.is_wide_decimal:
        if not dst.is_floating:
            raise TypeError(f"wide-decimal narrowing {src} -> {dst} not "
                            f"supported on device")
        lo, hi = data[..., 0], data[..., 1]
        lo_f = lo.to(torch.float64) + torch.where(lo < 0, 2.0 ** 64, 0.0)
        val = hi.to(torch.float64) * 2.0 ** 64 + lo_f
        return (val / float(10 ** src.scale)).to(dst.torch_dtype)
    tdt = dst.torch_dtype
    if src.is_decimal and dst.is_floating:
        return data.to(tdt) / torch.tensor(float(10 ** src.scale),
                                           dtype=tdt)
    if src.is_decimal and dst.is_decimal:
        if dst.scale >= src.scale:
            return data * 10 ** (dst.scale - src.scale) \
                if dst.scale > src.scale else data
        return _round_div(data, 10 ** (src.scale - dst.scale))
    if dst.is_decimal:
        return data.to(torch.int64) * 10 ** dst.scale
    return data if data.dtype == tdt else data.to(tdt)


class BinaryExpression(Expression):
    symbol = "?"

    def __init__(self, left: Expression, right: Expression):
        self.children = (left, right)
        if left.resolved() and right.resolved():
            self._resolve()

    def _resolve(self):
        l, r = self.children
        self.dtype = self._result_type(l.dtype, r.dtype)
        self.nullable = l.nullable or r.nullable

    def _result_type(self, lt: DataType, rt: DataType) -> DataType:
        return T.common_type(lt, rt)

    def _operand_type(self) -> DataType:
        return T.common_type(self.children[0].dtype, self.children[1].dtype)

    def _eval_children_promoted(self, ctx):
        l, r = self.children
        ld, lv = l.eval(ctx)
        rd, rv = r.eval(ctx)
        ct = self._operand_type()
        return (promote_physical(ld, l.dtype, ct),
                promote_physical(rd, r.dtype, ct), _and_valid(lv, rv))

    def _eval_wide(self, ctx, op: str) -> Value:
        """``op`` over operands promoted to a wide decimal: one launch
        lifts and rescales both (``wide_decimal.wide_binary``)."""
        from .ops import wide_decimal as wd
        l, r = self.children
        ct = self._operand_type()
        ld, lv = l.eval(ctx)
        rd, rv = r.eval(ctx)

        def scale_of(e):
            return e.dtype.scale if e.dtype.is_decimal else 0

        def physical(d, e):
            return d if e.dtype.is_decimal else d.to(torch.int64)

        ka, kb = ct.scale - scale_of(l), ct.scale - scale_of(r)
        if ka < 0 or kb < 0:
            raise TypeError(f"wide-decimal down-scale to {ct} not "
                            f"supported on device")
        return (wd.wide_binary(op, physical(ld, l), physical(rd, r), ka,
                               kb), _and_valid(lv, rv))


class Add(BinaryExpression):
    symbol = "+"
    input_sig = TypeSig.device_compute + TypeSig.decimal128
    output_sig = TypeSig.device_compute + TypeSig.decimal128

    def eval(self, ctx):
        if self._operand_type().is_wide_decimal:
            return self._eval_wide(ctx, "add")
        ld, rd, v = self._eval_children_promoted(ctx)
        return ld + rd, v


class Subtract(BinaryExpression):
    symbol = "-"
    input_sig = TypeSig.device_compute + TypeSig.decimal128
    output_sig = TypeSig.device_compute + TypeSig.decimal128

    def eval(self, ctx):
        if self._operand_type().is_wide_decimal:
            return self._eval_wide(ctx, "sub")
        ld, rd, v = self._eval_children_promoted(ctx)
        return ld - rd, v


class Multiply(BinaryExpression):
    """``*``; for decimals the reference's rule: precision
    min(p1 + p2 + 1, 18), scale s1 + s2 (capped at it), the int64 product
    of the operands at their own scales (wrapping like the reference's),
    rounded half away from zero to the result scale."""
    symbol = "*"

    def _result_type(self, lt, rt):
        if lt.is_decimal and rt.is_integral:
            rt = T.integral_as_decimal(rt)
        if rt.is_decimal and lt.is_integral:
            lt = T.integral_as_decimal(lt)
        if lt.is_decimal and rt.is_decimal:
            p = min(lt.precision + rt.precision + 1, 18)
            return T.decimal(p, min(lt.scale + rt.scale, p))
        return T.common_type(lt, rt)

    def eval(self, ctx):
        if self.dtype.is_decimal:
            l, r = self.children
            ld, lv = l.eval(ctx)
            rd, rv = r.eval(ctx)
            ls = l.dtype.scale if l.dtype.is_decimal else 0
            rs = r.dtype.scale if r.dtype.is_decimal else 0
            prod = ld.to(torch.int64) * rd.to(torch.int64)
            drop = ls + rs - self.dtype.scale
            if drop > 0:
                prod = _round_div(prod, 10 ** drop)
            return prod, _and_valid(lv, rv)
        ld, rd, v = self._eval_children_promoted(ctx)
        return ld * rd, v


class Divide(BinaryExpression):
    """Spark ``/``: always double; null on division by zero (ANSI mode:
    an error)."""
    symbol = "/"

    def _result_type(self, lt, rt):
        return T.FLOAT64

    def _operand_type(self):
        return T.FLOAT64

    def _resolve(self):
        super()._resolve()
        self.nullable = True  # x / 0 is null

    def eval(self, ctx):
        ld, rd, v = self._eval_children_promoted(ctx)
        zero = rd == 0
        if ctx.ansi:
            ctx.record_error(zero, v)
        out = ld / torch.where(zero, torch.ones_like(rd), rd)
        return out, _and_valid(v, ~zero)


class Remainder(BinaryExpression):
    """Spark ``%``: the sign follows the dividend; null on ``% 0``."""
    symbol = "%"

    def eval(self, ctx):
        ld, rd, v = self._eval_children_promoted(ctx)
        zero = rd == 0
        safe = torch.where(zero, torch.ones_like(rd), rd)
        r = torch.sign(ld) * torch.remainder(torch.abs(ld), torch.abs(safe))
        return r.to(ld.dtype), _and_valid(v, ~zero)


class Pmod(BinaryExpression):
    """``pmod(a, b)``: the remainder of ``a`` by ``|b|``, never negative;
    null on a zero divisor."""
    symbol = "pmod"

    def eval(self, ctx):
        ld, rd, v = self._eval_children_promoted(ctx)
        zero = rd == 0
        safe = torch.where(zero, torch.ones_like(rd), rd)
        return torch.remainder(ld, torch.abs(safe)).to(ld.dtype), \
            _and_valid(v, ~zero)


class UnaryMinus(Expression):
    def __init__(self, child: Expression):
        self.children = (child,)
        self.dtype = child.dtype
        self.nullable = child.nullable

    def _rebind(self):
        self.dtype = self.children[0].dtype
        self.nullable = self.children[0].nullable

    def eval(self, ctx):
        d, v = self.children[0].eval(ctx)
        return -d, v


class Abs(UnaryMinus):
    def eval(self, ctx):
        d, v = self.children[0].eval(ctx)
        return torch.abs(d), v


# ---------------------------------------------------------------------------------
# Comparisons and boolean logic
# ---------------------------------------------------------------------------------

class BinaryComparison(BinaryExpression):
    op: Callable = None
    wide_op: str = None  # the wide_decimal comparison
    input_sig = TypeSig.device_compute + TypeSig.decimal128
    output_sig = TypeSig.BOOLEAN

    def _result_type(self, lt, rt):
        T.common_type(lt, rt)  # raises on incomparable types
        return T.BOOLEAN

    def eval(self, ctx):
        if self._operand_type().is_wide_decimal:
            return self._eval_wide(ctx, type(self).wide_op)
        ld, rd, v = self._eval_children_promoted(ctx)
        return type(self).op(ld, rd), v


class EqualTo(BinaryComparison):
    symbol = "="
    op = staticmethod(lambda a, b: a == b)
    wide_op = "eq"


class LessThan(BinaryComparison):
    symbol = "<"
    op = staticmethod(lambda a, b: a < b)
    wide_op = "lt"


class LessThanOrEqual(BinaryComparison):
    symbol = "<="
    op = staticmethod(lambda a, b: a <= b)
    wide_op = "le"


class GreaterThan(BinaryComparison):
    symbol = ">"
    op = staticmethod(lambda a, b: a > b)
    wide_op = "gt"


class GreaterThanOrEqual(BinaryComparison):
    symbol = ">="
    op = staticmethod(lambda a, b: a >= b)
    wide_op = "ge"


class Not(Expression):
    input_sig = TypeSig.BOOLEAN + TypeSig.null
    output_sig = TypeSig.BOOLEAN

    def __init__(self, child: Expression):
        self.children = (child,)
        self.dtype = T.BOOLEAN
        self.nullable = child.nullable

    def eval(self, ctx):
        d, v = self.children[0].eval(ctx)
        return ~d, v


class And(BinaryExpression):
    """Kleene AND: false AND null = false."""
    symbol = "and"
    input_sig = TypeSig.BOOLEAN + TypeSig.null
    output_sig = TypeSig.BOOLEAN

    def _result_type(self, lt, rt):
        return T.BOOLEAN

    def eval(self, ctx):
        ld, lv = self.children[0].eval(ctx)
        rd, rv = self.children[1].eval(ctx)
        if lv is None and rv is None:
            return ld & rd, None
        lt = ld if lv is None else (ld & lv)       # definitely true
        rt = rd if rv is None else (rd & rv)
        lf = (~ld) if lv is None else ((~ld) & lv)  # definitely false
        rf = (~rd) if rv is None else ((~rd) & rv)
        return lt & rt, lf | rf | (lt & rt)


class Or(BinaryExpression):
    """Kleene OR: true OR null = true."""
    symbol = "or"
    input_sig = TypeSig.BOOLEAN + TypeSig.null
    output_sig = TypeSig.BOOLEAN

    def _result_type(self, lt, rt):
        return T.BOOLEAN

    def eval(self, ctx):
        ld, lv = self.children[0].eval(ctx)
        rd, rv = self.children[1].eval(ctx)
        if lv is None and rv is None:
            return ld | rd, None
        lt = ld if lv is None else (ld & lv)
        rt = rd if rv is None else (rd & rv)
        valid_l = torch.ones_like(ld) if lv is None else lv
        valid_r = torch.ones_like(rd) if rv is None else rv
        return lt | rt, lt | rt | (valid_l & valid_r)


class In(Expression):
    """``col IN (literals...)``: an OR of equality tests; with a null in
    the list, a row that matches no value is null."""

    def __init__(self, child: Expression, values: Sequence[Any]):
        self.children = (child,)
        self.values = tuple(values)
        self.dtype = T.BOOLEAN
        self.nullable = child.nullable or any(v is None for v in values)

    def _rebind(self):
        self.nullable = self.children[0].nullable \
            or any(v is None for v in self.values)

    def eval(self, ctx):
        d, v = self.children[0].eval(ctx)
        hit = torch.zeros_like(d, dtype=torch.bool)
        for val in self.values:
            if val is not None:
                hit = hit | (d == Literal(val, self.children[0].dtype)
                             .eval(ctx)[0])
        if any(x is None for x in self.values):
            v = _and_valid(v, hit)
        return hit, v

    def _fp_extra(self):
        return f"{self.values!r}"


class IsNull(Expression):
    def __init__(self, child: Expression):
        self.children = (child,)
        self.dtype = T.BOOLEAN
        self.nullable = False

    def eval(self, ctx):
        d, v = self.children[0].eval(ctx)
        if v is None:
            return torch.zeros_like(d, dtype=torch.bool), None
        return ~v, None


class IsNotNull(IsNull):
    def eval(self, ctx):
        d, v = self.children[0].eval(ctx)
        if v is None:
            return torch.ones_like(d, dtype=torch.bool), None
        return v, None


def _ones(ref: torch.Tensor) -> torch.Tensor:
    return torch.ones_like(ref, dtype=torch.bool)


class If(Expression):
    """``if(pred, then, else)``: a null predicate takes the else branch
    (both branches are evaluated; ``torch.where`` selects)."""

    def __init__(self, pred: Expression, then: Expression, other: Expression):
        self.children = (pred, then, other)
        if then.resolved() and other.resolved():
            self.dtype = T.common_type(then.dtype, other.dtype)
            self.nullable = pred.nullable or then.nullable or other.nullable

    def _rebind(self):
        _, then, other = self.children
        self.dtype = T.common_type(then.dtype, other.dtype)
        self.nullable = any(c.nullable for c in self.children)

    def eval(self, ctx):
        p, pv = self.children[0].eval(ctx)
        td, tv = self.children[1].eval(ctx)
        ed, ev = self.children[2].eval(ctx)
        tdt = self.dtype.torch_dtype
        cond = p if pv is None else p & pv
        data = torch.where(cond, td.to(tdt), ed.to(tdt))
        if tv is None and ev is None:
            return data, None
        tv = _ones(cond) if tv is None else tv
        ev = _ones(cond) if ev is None else ev
        return data, torch.where(cond, tv, ev)


class CaseWhen(Expression):
    """``CASE WHEN c1 THEN v1 ... ELSE e END``: the first branch whose
    condition is true (not null) wins; no ELSE gives null."""

    def __init__(self, branches: Sequence[Tuple[Expression, Expression]],
                 otherwise: Optional[Expression] = None):
        flat: List[Expression] = []
        for c, v in branches:
            flat += [c, v]
        if otherwise is not None:
            flat.append(otherwise)
        self.branches = list(branches)
        self.otherwise = otherwise
        self.children = tuple(flat)
        vals = [v for _, v in branches] + ([otherwise] if otherwise else [])
        if all(v.resolved() for v in vals):
            self._set_type(vals)
            self.nullable = self.nullable \
                or any(c.nullable for c, _ in branches)

    def _set_type(self, vals):
        dt = vals[0].dtype
        for v in vals[1:]:
            dt = T.common_type(dt, v.dtype)
        self.dtype = dt
        self.nullable = self.otherwise is None \
            or any(v.nullable for v in vals)

    def _rebind(self):
        n = len(self.branches)
        kids = self.children
        self.branches = [(kids[2 * i], kids[2 * i + 1]) for i in range(n)]
        self.otherwise = kids[2 * n] if len(kids) > 2 * n else None
        self._set_type([v for _, v in self.branches]
                       + ([self.otherwise] if self.otherwise else []))

    def eval(self, ctx):
        tdt = self.dtype.torch_dtype
        if self.otherwise is not None:
            out_d, out_v = self.otherwise.eval(ctx)
            out_d = out_d.to(tdt)
        else:
            out_d = torch.zeros(ctx.num_rows, dtype=tdt, device=ctx.device)
            out_v = torch.zeros(ctx.num_rows, dtype=torch.bool,
                                device=ctx.device)
        # last to first, so that the first matching branch wins
        for cond_e, val_e in reversed(self.branches):
            cd, cv = cond_e.eval(ctx)
            c = cd if cv is None else cd & cv
            vd, vv = val_e.eval(ctx)
            out_d = torch.where(c, vd.to(tdt), out_d)
            if vv is not None or out_v is not None:
                vv = _ones(c) if vv is None else vv
                ov = _ones(c) if out_v is None else out_v
                out_v = torch.where(c, vv, ov)
        return out_d, out_v


class Coalesce(Expression):
    """The first non-null argument; null only where every one is."""

    def __init__(self, *children: Expression):
        self.children = tuple(children)
        if all(c.resolved() for c in children):
            self._rebind()

    def _rebind(self):
        dt = self.children[0].dtype
        for c in self.children[1:]:
            dt = T.common_type(dt, c.dtype)
        self.dtype = dt
        self.nullable = all(c.nullable for c in self.children)

    def eval(self, ctx):
        tdt = self.dtype.torch_dtype
        out_d = torch.zeros(ctx.num_rows, dtype=tdt, device=ctx.device)
        out_v = torch.zeros(ctx.num_rows, dtype=torch.bool, device=ctx.device)
        for c in reversed(self.children):
            d, v = c.eval(ctx)
            if v is None:
                out_d = d.to(tdt).expand(ctx.num_rows)
                out_v = torch.ones(ctx.num_rows, dtype=torch.bool,
                                   device=ctx.device)
            else:
                out_d = torch.where(v, d.to(tdt), out_d)
                out_v = out_v | v
        return out_d, (out_v if self.nullable else None)


# ---------------------------------------------------------------------------------
# Aggregates are declared here; their buffers live in aggfns.py
# ---------------------------------------------------------------------------------

class AggregateExpression(Expression):
    """Marker base: func name + child."""

    func: str = "?"

    def __init__(self, child: Optional[Expression]):
        self.children = (child,) if child is not None else ()
        if child is not None and child.resolved():
            self._resolve()

    def _resolve(self):
        self.dtype = self.children[0].dtype
        self.nullable = True

    def _fp_extra(self):
        return f"{self.func}:{self.dtype}"


# ---------------------------------------------------------------------------------
# Binding: resolve UnresolvedColumn against a schema, rebuilding the tree
# ---------------------------------------------------------------------------------

def bind(expr: Expression, schema) -> Expression:
    """A copy of ``expr`` with columns bound to ordinals and types set."""
    if isinstance(expr, UnresolvedColumn):
        idx = schema.index_of(expr.name)
        f = schema.fields[idx]
        return BoundReference(idx, f.dtype, f.nullable, f.name)
    if not expr.children:
        return expr
    node = copy.copy(expr)
    node.children = tuple(bind(c, schema) for c in expr.children)
    if isinstance(node, (BinaryExpression, AggregateExpression)):
        node._resolve()
    elif isinstance(node, Not):
        node.nullable = node.children[0].nullable
    elif isinstance(node, Cast):
        node.nullable = node.children[0].nullable
    elif hasattr(node, "_rebind"):
        node._rebind()
    return node
