"""128-bit decimal arithmetic over two int64 limbs.

Counterpart of ``spark_rapids_tpu/ops/wide_decimal.py`` (``from_scaled64``
:39, ``add`` :46, ``neg`` :53, ``sub`` :59, ``eq``/``lt``/``le``/``gt``/
``ge`` :63-82, ``mul_pow10`` :114) and of the host reconstruction of wide
sums in ``spark_rapids_tpu/aggfns.py:131-156 finalize_host``.  A decimal
with 18 < precision <= 38 is a ``[n, 2]`` int64 tensor ``[lo, hi]`` of the
scaled two's-complement value; arithmetic is modulo 2^128, as the
reference's.

Each function has a plain PyTorch version here (int64 lane arithmetic with
the reference's carry rules) and a hand-written CUDA kernel,
``csrc/wide_decimal.cu`` (native ``__int128``): ``wide_binary`` launches
``wd_elementwise`` for every elementwise function (one launch lifts both
operands, rescales them and applies the operation), ``sum_finalize``
launches ``wd_sum_finalize``.  CUDA tensors launch the kernel or raise; CPU
tensors run the plain version.  Launches count in ``wd_kernel.launches``
and ``sum_finalize_kernel.launches``.

An operand is either narrow (an int64 ``[n]`` scaled value, sign-extended
to 128 bits) or wide (``[n, 2]`` limbs); a 0-dim, ``[1]`` or ``[1, 2]``
operand broadcasts.  ``ka``/``kb`` multiply an operand by 10^k first (the
rescaling of ``promote_physical``).  Where ``valid`` is False the output
is zero limbs (or False).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from .. import kernels

__all__ = ["from_scaled64", "add", "neg", "sub", "eq", "lt", "le", "gt",
           "ge", "mul_pow10", "wide_binary", "wide_binary_plain",
           "wd_kernel", "sum_lanes", "sum_finalize", "sum_finalize_plain",
           "sum_finalize_kernel", "limb_constant", "WIDE_LIMBS"]

WIDE_LIMBS = 2
_SIGN = -(1 << 63)
_M16 = 0xFFFF
_M32 = 0xFFFFFFFF
_OPS = {"lift": 0, "add": 1, "sub": 2, "neg": 3, "eq": 4, "lt": 5, "le": 6,
        "gt": 7, "ge": 8}
_COMPARES = ("eq", "lt", "le", "gt", "ge")


def limb_constant(v: int) -> Tuple[int, int]:
    """A Python int → its (lo, hi) int64 limbs, modulo 2^128."""
    u = v & ((1 << 128) - 1)
    lo, hi = u & ((1 << 64) - 1), u >> 64
    return (lo - (1 << 64) if lo >= (1 << 63) else lo,
            hi - (1 << 64) if hi >= (1 << 63) else hi)


# ---------------------------------------------------------------------------------
# Plain PyTorch versions (the reference's lane arithmetic)
# ---------------------------------------------------------------------------------

def _ult(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Unsigned 64-bit x < y via the sign-flip trick."""
    return (x ^ _SIGN) < (y ^ _SIGN)


def _from_scaled64(d: torch.Tensor) -> torch.Tensor:
    """``[n]`` scaled int64 → ``[n, 2]`` limbs (sign-extended)."""
    d = d.to(torch.int64)
    return torch.stack([d, d >> 63], dim=-1)


def _add(a, b):
    lo = a[..., 0] + b[..., 0]
    carry = _ult(lo, a[..., 0]).to(torch.int64)
    return torch.stack([lo, a[..., 1] + b[..., 1] + carry], dim=-1)


def _neg(a):
    lo = -a[..., 0]
    hi = ~a[..., 1] + (a[..., 0] == 0).to(torch.int64)
    return torch.stack([lo, hi], dim=-1)


def _eq(a, b):
    return (a[..., 0] == b[..., 0]) & (a[..., 1] == b[..., 1])


def _lt(a, b):
    return (a[..., 1] < b[..., 1]) | ((a[..., 1] == b[..., 1])
                                      & _ult(a[..., 0], b[..., 0]))


def _to_limbs16(a) -> List[torch.Tensor]:
    out = []
    for w in (a[..., 0], a[..., 1]):
        for k in range(4):
            out.append((w >> (16 * k)) & _M16)
    return out


def _from_cols16(cols) -> torch.Tensor:
    carry = torch.zeros_like(cols[0])
    lanes = []
    for k in range(8):
        tot = cols[k] + carry
        lanes.append(tot & _M16)
        carry = tot >> 16
    lo = lanes[0] | (lanes[1] << 16) | (lanes[2] << 32) | (lanes[3] << 48)
    hi = lanes[4] | (lanes[5] << 16) | (lanes[6] << 32) | (lanes[7] << 48)
    return torch.stack([lo, hi], dim=-1)


def _mul_pow10(a, k: int):
    """a * 10^k mod 2^128 by 16-bit schoolbook columns (reference :114)."""
    if k == 0:
        return a
    m = 10 ** k
    ml = [(m >> (16 * j)) & _M16 for j in range(8)]
    al = _to_limbs16(a)
    cols = []
    for c in range(8):
        acc = torch.zeros_like(al[0])
        for i in range(8):
            j = c - i
            if 0 <= j < 8 and ml[j]:
                acc = acc + al[i] * ml[j]
        cols.append(acc)
    return _from_cols16(cols)


def _lift(x: torch.Tensor, k: int) -> torch.Tensor:
    x = x.reshape(1) if x.dim() == 0 else x
    limbs = x if x.dim() == 2 else _from_scaled64(x)
    return _mul_pow10(limbs, k)


def wide_binary_plain(op: str, a: torch.Tensor, b: Optional[torch.Tensor],
                      ka: int = 0, kb: int = 0,
                      valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of ``wd_elementwise``: ``op`` on the lifted
    operands (``b`` None for lift and neg)."""
    x = _lift(a, ka)
    y = None if b is None else _lift(b, kb)
    if op == "lift":
        out = x
    elif op == "neg":
        out = _neg(x)
    elif op == "add":
        out = _add(x, y)
    elif op == "sub":
        out = _add(x, _neg(y))
    elif op == "eq":
        out = _eq(x, y)
    elif op == "lt":
        out = _lt(x, y)
    elif op == "le":
        out = _lt(x, y) | _eq(x, y)
    elif op == "gt":
        out = _lt(y, x)
    elif op == "ge":
        out = _lt(y, x) | _eq(x, y)
    else:
        raise ValueError(f"unknown wide decimal op {op!r}")
    if valid is not None:
        out = torch.where(valid.unsqueeze(-1) if out.dim() == 2 else valid,
                          out, torch.zeros_like(out))
    return out.contiguous()


# ---------------------------------------------------------------------------------
# Dispatch and the kernel
# ---------------------------------------------------------------------------------

def wide_binary(op: str, a: torch.Tensor, b: Optional[torch.Tensor] = None,
                ka: int = 0, kb: int = 0,
                valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``op`` in lift/add/sub/neg/eq/lt/le/gt/ge over narrow or wide
    operands, each first multiplied by 10^k: ``[n, 2]`` limbs, or a bool
    ``[n]`` for the comparisons."""
    if a.is_cuda:
        return wd_kernel(op, a, b, ka, kb, valid)
    return wide_binary_plain(op, a, b, ka, kb, valid)


def from_scaled64(d: torch.Tensor) -> torch.Tensor:
    """``[n]`` scaled int64 → ``[n, 2]`` limbs (sign-extended)."""
    return wide_binary("lift", d)


def add(a, b):
    return wide_binary("add", a, b)


def neg(a):
    return wide_binary("neg", a)


def sub(a, b):
    return wide_binary("sub", a, b)


def eq(a, b):
    return wide_binary("eq", a, b)


def lt(a, b):
    return wide_binary("lt", a, b)


def le(a, b):
    return wide_binary("le", a, b)


def gt(a, b):
    return wide_binary("gt", a, b)


def ge(a, b):
    return wide_binary("ge", a, b)


def mul_pow10(a, k: int):
    """a * 10^k modulo 2^128 (k >= 0)."""
    return wide_binary("lift", a, None, ka=k)


def _operand(x: Optional[torch.Tensor], what: str):
    """(tensor, rows, is_wide) of one kernel operand."""
    if x is None:
        return None, 0, 0
    x = x.reshape(1) if x.dim() == 0 else x
    if x.dtype != torch.int64 or not x.is_cuda or x.dim() not in (1, 2) \
            or (x.dim() == 2 and x.shape[1] != 2):
        raise ValueError(f"{what}: expected a CUDA int64 [n] or [n, 2] "
                         f"tensor, got {x.dtype} {tuple(x.shape)} on "
                         f"{x.device}")
    return x.contiguous(), x.shape[0], int(x.dim() == 2)


def wd_kernel(op: str, a, b=None, ka: int = 0, kb: int = 0,
              valid=None) -> torch.Tensor:
    """Launch ``wd_elementwise`` of ``csrc/wide_decimal.cu`` (the same
    arguments as :func:`wide_binary_plain`)."""
    if op not in _OPS or (b is None) != (op in ("lift", "neg")):
        raise ValueError(f"wide decimal op {op!r} with "
                         f"{'no' if b is None else 'a'} second operand")
    if not (0 <= ka <= 38 and 0 <= kb <= 38):
        raise ValueError("10^k rescaling takes 0 <= k <= 38")
    a, na, wa = _operand(a, "a")
    b, nb, wb = _operand(b, "b")
    n = max(na, nb)
    for m in (na, nb):
        if m not in (0, 1, n):
            raise ValueError(f"operands of {n} and {m} rows")
    if valid is not None:
        if valid.dtype != torch.bool or valid.shape != (n,) \
                or not valid.is_cuda:
            raise ValueError("valid must be a CUDA bool [n] mask")
        valid = valid.contiguous()
    dev = a.device
    out = (torch.empty(n, dtype=torch.bool, device=dev) if op in _COMPARES
           else torch.empty((n, 2), dtype=torch.int64, device=dev))
    if n == 0:
        return out
    lib = kernels.load("wide_decimal")
    rc = lib.wd_elementwise(
        _OPS[op], a.data_ptr(), na, wa, ka,
        None if b is None else b.data_ptr(), nb, wb, kb,
        None if valid is None else valid.data_ptr(), n, out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    kernels.check_launch(lib, "wd_elementwise", rc)
    wd_kernel.launches += 1
    return out


wd_kernel.launches = 0


# ---------------------------------------------------------------------------------
# Wide sums: lanes on the device, finalized on the device
# ---------------------------------------------------------------------------------

def sum_lanes(d: torch.Tensor) -> List[torch.Tensor]:
    """A decimal column's SUM contributions as int64 lanes whose sums are
    exact for 2^31 rows (reference ``aggfns.py:97-118``): a narrow column
    as [lo 32 bits, hi (signed)], a wide one as [lo0, lo1, hi0, hi1
    (signed)], 32-bit chunks of its limbs."""
    if d.dim() == 1:
        d = d.to(torch.int64)
        hi = d >> 32
        return [d - (hi << 32), hi]
    lo, hi = d[..., 0], d[..., 1]
    return [lo & _M32, (lo >> 32) & _M32, hi & _M32, hi >> 32]


def sum_finalize(lanes: Sequence[torch.Tensor], count: torch.Tensor,
                 precision: int) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """Per group, its lane sums (2 or 4, :func:`sum_lanes`) recombined into
    ``[m, 2]`` limbs; a group with no valid row, or whose total reaches
    10^precision, is null.  Returns (limbs, valid, overflowed: a bool
    [1], set when a non-empty group overflowed: ANSI mode raises on it)."""
    if count.is_cuda:
        return sum_finalize_kernel(lanes, count, precision)
    return sum_finalize_plain(lanes, count, precision)


def _shl32(x: torch.Tensor) -> torch.Tensor:
    """x * 2^32 as 128-bit limbs, x a signed int64."""
    return torch.stack([x << 32, x >> 32], dim=-1)


def _add_u64(limbs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """limbs + x, x a non-negative int64."""
    return _add(limbs, torch.stack([x, torch.zeros_like(x)], dim=-1))


def sum_finalize_plain(lanes, count, precision: int):
    """Plain PyTorch version of ``wd_sum_finalize``."""
    if len(lanes) == 2:
        lo, hi = lanes
        total = _add_u64(_shl32(hi), lo)
        fits = torch.ones_like(count, dtype=torch.bool)
    elif len(lanes) == 4:
        l0, l1, h0, h1 = lanes
        low = _add_u64(_shl32(l1), l0)          # < 2^96, non-negative
        high = _add_u64(_add_u64(_shl32(h1), h0), low[..., 1])
        # total = high * 2^64 + low[lo]; it fits 128 bits when high does
        # 64 bits
        fits = high[..., 1] == (high[..., 0] >> 63)
        total = torch.stack([low[..., 0], high[..., 0]], dim=-1)
    else:
        raise ValueError("a wide sum has 2 or 4 lanes")
    bound = 10 ** precision - 1
    up = torch.tensor(limb_constant(bound), device=count.device)
    down = torch.tensor(limb_constant(-bound), device=count.device)
    inside = fits & (_lt(total, up) | _eq(total, up)) \
        & (_lt(down, total) | _eq(down, total))
    some = count > 0
    valid = some & inside
    total = torch.where(valid.unsqueeze(-1), total, torch.zeros_like(total))
    return total.contiguous(), valid, (some & ~inside).any().reshape(1)


def sum_finalize_kernel(lanes, count, precision: int):
    """Launch ``wd_sum_finalize`` of ``csrc/wide_decimal.cu``."""
    m = count.shape[0]
    if len(lanes) not in (2, 4) or not 1 <= precision <= 38:
        raise ValueError("a wide sum has 2 or 4 lanes and precision <= 38")
    for t in list(lanes) + [count]:
        if t.dtype != torch.int64 or t.shape != (m,) or not t.is_cuda:
            raise ValueError("lanes and count are CUDA int64 [m] tensors")
    lanes = [t.contiguous() for t in lanes]
    count = count.contiguous()
    dev = count.device
    out = torch.empty((m, 2), dtype=torch.int64, device=dev)
    valid = torch.empty(m, dtype=torch.bool, device=dev)
    over = torch.zeros(1, dtype=torch.int32, device=dev)
    if m:
        lib = kernels.load("wide_decimal")
        rc = lib.wd_sum_finalize(
            len(lanes), kernels.pointer_array([t.data_ptr() for t in lanes]),
            count.data_ptr(), m, precision, out.data_ptr(), valid.data_ptr(),
            over.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        kernels.check_launch(lib, "wd_sum_finalize", rc)
        sum_finalize_kernel.launches += 1
    return out, valid, over.bool()


sum_finalize_kernel.launches = 0


# ---------------------------------------------------------------------------------
# Moving limb columns through the one-word gather kernels
# ---------------------------------------------------------------------------------

def split_wide(cols):
    """(data, valid) columns with each ``[n, 2]`` limb column split into
    two contiguous ``[n]`` columns, and the layout that
    :func:`join_wide` takes back: the gather and compaction kernels move
    1- to 8-byte elements."""
    flat, layout = [], []
    for d, v in cols:
        if d is not None and d.dim() == 2:
            flat += [(d[:, 0].contiguous(), v), (d[:, 1].contiguous(), None)]
            layout.append(2)
        else:
            flat.append((d, v))
            layout.append(1)
    return flat, layout


def join_wide(out, layout):
    """Inverse of :func:`split_wide` over the moved columns."""
    res, i = [], 0
    for k in layout:
        if k == 2:
            (lo, v), (hi, _) = out[i], out[i + 1]
            res.append((torch.stack([lo, hi], dim=1), v))
        else:
            res.append(out[i])
        i += k
    return res
