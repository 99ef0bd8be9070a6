"""Segmented window machinery over a window's sorted rows.

Counterpart of ``spark_rapids_tpu/ops/window.py``.  A window spec's rows
are sorted once by (partition keys, order keys) through the full device
sort (``ops/sort.py``, ``csrc/sort.cu``: :meth:`SortedWindowContext.order`);
over the sorted rows the partitions and their peer groups become flags
and positions (:class:`SortedWindowContext`, the reference's :35); every
window function is then an elementwise pass over the positions or a
segmented scan, computed by ``csrc/window_scan.cu``
(the context's flags and positions, scans, ranks, lag/lead) and
``csrc/window_frame.cu`` (frame bounds, framed sums and min/max).  On
CUDA tensors each wrapper launches its kernel (or raises); on CPU tensors
it runs the plain PyTorch version.

Every value here is in sorted order.  Positions are int32.  Sums run as
int64 or float64, min/max over int64 or float64 images of the column
(wider types than the input's are exact), count as int64.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Sequence, Tuple

import torch

from .. import kernels
from . import sort as S
from .topk import sortable_view

__all__ = ["SortedWindowContext", "win_context", "win_context_plain",
           "win_context_kernel", "win_flags_plain", "win_scan", "win_take",
           "win_rank", "win_shift", "frame_rows", "frame_range",
           "frame_sum", "frame_minmax", "running", "running_count",
           "partition_reduce", "full_column", "WS_MAX_KEYS"]

Value = Tuple[torch.Tensor, Optional[torch.Tensor]]

WS_MAX_KEYS = 16  # csrc/window_scan.cu WS_MAX_KEYS
_OPS = {"sum": 0, "min": 1, "max": 2}
_MODES = {"values": 0, "start_pos": 1, "end_pos": 2, "flag_count": 3}
_TYPES = {torch.int32: 0, torch.int64: 1, torch.float64: 2}
_RANKS = {"row_number": 0, "rank": 1, "dense_rank": 2, "percent_rank": 3,
          "cume_dist": 4, "ntile": 5}
_I64 = torch.iinfo(torch.int64)
_I32 = torch.iinfo(torch.int32)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check(ts, n: int) -> None:
    for t in ts:
        if t is not None and (t.shape != (n,) or not t.is_cuda
                              or not t.is_contiguous()):
            raise ValueError(f"window inputs must be contiguous CUDA [{n}] "
                             f"tensors, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")


def identity(op: str, dtype: torch.dtype):
    """The identity of ``op`` over ``dtype``."""
    if op == "sum":
        return 0
    if dtype == torch.float64:
        return float("inf") if op == "min" else float("-inf")
    info = _I32 if dtype == torch.int32 else _I64
    return info.max if op == "min" else info.min


def _bits(value, dtype: torch.dtype) -> int:
    if dtype == torch.float64:
        return struct.unpack("<q", struct.pack("<d", float(value)))[0]
    return int(value)


# ---------------------------------------------------------------------------------
# window_scan.cu: the look-back scratch, the context's flags and positions
# ---------------------------------------------------------------------------------

def _look_back(like: torch.Tensor, n: int, lib) -> torch.Tensor:
    """The look-back scratch of a call over ``n`` rows on ``like``'s
    device (the kernel clears what it needs cleared)."""
    return torch.empty(int(lib.win_scratch_bytes(n)), dtype=torch.uint8,
                       device=like.device)


def _differs(d, v):
    view = sortable_view(d)
    diff = view[1:] != view[:-1]
    if v is not None:
        a, b = v[:-1], v[1:]
        diff = (a != b) | (a & b & diff)
    return diff


def win_flags_plain(keys, npart: int, n: int, device=None):
    """(seg_start, peer_start) bool [n] over sorted keys: the first
    ``npart`` are partition keys, the rest order keys (the forward half of
    ``win_context`` in ``csrc/window_scan.cu``)."""
    seg = torch.zeros(max(n - 1, 0), dtype=torch.bool, device=device)
    peer = seg.clone()
    for c, (d, v) in enumerate(keys):
        diff = _differs(d, v)
        if c < npart:
            seg = seg | diff
        peer = peer | diff
    first = torch.ones(min(n, 1), dtype=torch.bool, device=device)
    return torch.cat([first, seg]), torch.cat([first, peer])


def win_context(keys: Sequence[Value], npart: int, n: int,
                device: torch.device):
    """A window spec's segment structure over ``n`` rows sorted by
    ``keys`` (the first ``npart`` partition keys, the rest order keys;
    none: one partition, one peer group): (seg_start, peer_start) bool and
    (seg_start_pos, seg_end_pos, peer_start_pos, peer_end_pos) int32."""
    if torch.device(device).type == "cuda":
        return win_context_kernel(keys, npart, n, device)
    return win_context_plain(keys, npart, n, device)


def win_context_plain(keys, npart: int, n: int, device=None):
    """Plain PyTorch version of ``win_context`` in
    ``csrc/window_scan.cu``: the flags, then four position scans."""
    seg, peer = win_flags_plain(keys, npart, n, device)
    i32 = torch.int32
    return (seg, peer,
            win_scan_plain(i32, "max", "start_pos", n, flags=seg),
            win_scan_plain(i32, "min", "end_pos", n, flags=seg),
            win_scan_plain(i32, "max", "start_pos", n, flags=peer),
            win_scan_plain(i32, "min", "end_pos", n, flags=peer))


def win_context_kernel(keys, npart: int, n: int, device):
    """Launch ``win_context`` of ``csrc/window_scan.cu``: a forward kernel
    (flags, start positions) and a backward one (end positions)."""
    if len(keys) > WS_MAX_KEYS:
        raise ValueError(f"a window takes at most {WS_MAX_KEYS} partition "
                         f"and order keys, got {len(keys)}")
    _check([t for kv in keys for t in kv], n)
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"win_context_kernel runs on a CUDA device, not "
                         f"{dev}")
    args = [S.key_args(d) for d, _ in keys]
    seg = torch.empty(n, dtype=torch.bool, device=dev)
    peer = torch.empty(n, dtype=torch.bool, device=dev)
    pos = [torch.empty(n, dtype=torch.int32, device=dev) for _ in range(4)]
    if n == 0:
        return (seg, peer, *pos)
    lib = kernels.load("window_scan")
    scratch = _look_back(seg, n, lib)
    P = kernels.pointer_array
    rc = lib.win_context(npart, len(keys), P([d.data_ptr() for d, _ in keys]),
                         P([_ptr(v) for _, v in keys]),
                         kernels.int_array([e for e, _ in args]),
                         kernels.int_array([k for _, k in args]), n,
                         seg.data_ptr(), peer.data_ptr(),
                         *[p.data_ptr() for p in pos], scratch.data_ptr(),
                         _stream(seg))
    kernels.check_launch(lib, "win_context", rc)
    win_context_kernel.launches += 1
    return (seg, peer, *pos)


win_context_kernel.launches = 0


# ---------------------------------------------------------------------------------
# window_scan.cu: scans
# ---------------------------------------------------------------------------------

def win_scan(dtype: torch.dtype, op: str, mode: str, n: int, *,
             vals=None, mask=None, flags=None, reset=None) -> torch.Tensor:
    """An inclusive scan of ``n`` rows, of ``dtype`` (int32, int64 or
    float64): ``mode`` "values" scans ``vals`` where ``mask`` (identity
    elsewhere) with ``op``; "flag_count" the count of ``flags``; the plain
    version also gives the positions (``win_context``'s): "start_pos" is
    the forward max of i where ``flags`` starts a group, "end_pos" the
    backward min of i where a group ends.  ``reset`` (partition starts)
    restarts the scan."""
    like = vals if vals is not None else flags
    if like.is_cuda:
        return win_scan_kernel(dtype, op, mode, n, vals, mask, flags, reset)
    return win_scan_plain(dtype, op, mode, n, vals, mask, flags, reset)


def _starts(flags: torch.Tensor) -> torch.Tensor:
    idx = torch.arange(flags.shape[0], device=flags.device)
    return torch.cummax(torch.where(flags, idx, torch.zeros_like(idx)),
                        0).values


def _segmented(x: torch.Tensor, reset: Optional[torch.Tensor], op: str,
               ident) -> torch.Tensor:
    """Inclusive segmented scan by doubling (Hillis-Steele)."""
    fn = {"sum": torch.add, "min": torch.minimum, "max": torch.maximum}[op]
    n = x.shape[0]
    f = (torch.zeros(n, dtype=torch.bool, device=x.device) if reset is None
         else reset.clone())
    d = 1
    while d < n:
        pv = torch.cat([torch.full((d,), ident, dtype=x.dtype,
                                   device=x.device), x[:-d]])
        pf = torch.cat([torch.zeros(d, dtype=torch.bool, device=x.device),
                        f[:-d]])
        x = torch.where(f, x, fn(pv, x))
        f = f | pf
        d <<= 1
    return x


def win_scan_plain(dtype, op: str, mode: str, n: int, vals=None, mask=None,
                   flags=None, reset=None) -> torch.Tensor:
    """Plain PyTorch version of ``win_scan`` in ``csrc/window_scan.cu``."""
    if mode == "start_pos":
        return _starts(flags).to(dtype)
    if mode == "end_pos":
        idx = torch.arange(n, device=flags.device)
        last = torch.cat([flags[1:], torch.ones(min(n, 1), dtype=torch.bool,
                                                device=flags.device)])
        x = torch.where(last, idx, torch.full_like(idx, n - 1))
        return torch.flip(torch.cummin(torch.flip(x, [0]), 0).values,
                          [0]).to(dtype)
    ident = identity(op, dtype)
    if mode == "flag_count":
        x = flags.to(dtype)
    else:
        x = vals.to(dtype)
        if mask is not None:
            x = torch.where(mask, x, torch.full_like(x, ident))
    return _segmented(x, reset, op, ident)


def win_scan_kernel(dtype, op: str, mode: str, n: int, vals=None, mask=None,
                    flags=None, reset=None) -> torch.Tensor:
    """Launch ``win_scan`` of ``csrc/window_scan.cu`` (one kernel)."""
    if dtype not in _TYPES:
        raise ValueError(f"window scans run over int32, int64 or float64, "
                         f"not {dtype}")
    if mode not in ("values", "flag_count"):
        raise ValueError(f"the scan kernel takes values or a flag count; "
                         f"{mode} comes from win_context")
    if vals is not None and vals.dtype != dtype:
        raise ValueError(f"scan values must be {dtype}, not {vals.dtype}")
    _check([vals, mask, flags, reset], n)
    like = vals if vals is not None else flags
    out = torch.empty(n, dtype=dtype, device=like.device)
    if n == 0:
        return out
    lib = kernels.load("window_scan")
    scratch = _look_back(out, n, lib)
    rc = lib.win_scan(_TYPES[dtype], _OPS[op], _MODES[mode], _ptr(vals),
                      _ptr(mask), _ptr(flags), _ptr(reset),
                      _bits(identity(op, dtype), dtype), n, out.data_ptr(),
                      scratch.data_ptr(), _stream(out))
    kernels.check_launch(lib, "win_scan", rc)
    win_scan_kernel.launches += 1
    return out


win_scan_kernel.launches = 0


def win_take(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``src[idx]`` (int32 positions)."""
    if src.is_cuda:
        return win_take_kernel(src, idx)
    return src[idx.long()]


def win_take_kernel(src, idx) -> torch.Tensor:
    """Launch ``win_take`` of ``csrc/window_scan.cu``."""
    n = idx.shape[0]
    _check([idx], n)
    _check([src], src.shape[0])
    if idx.dtype != torch.int32 or src.element_size() not in (1, 4, 8):
        raise ValueError("win_take takes int32 positions and 1, 4 or "
                         "8-byte elements")
    out = torch.empty(n, dtype=src.dtype, device=src.device)
    if n == 0:
        return out
    lib = kernels.load("window_scan")
    rc = lib.win_take(src.data_ptr(), src.element_size(), idx.data_ptr(), n,
                      out.data_ptr(), _stream(out))
    kernels.check_launch(lib, "win_take", rc)
    win_take_kernel.launches += 1
    return out


win_take_kernel.launches = 0


# ---------------------------------------------------------------------------------
# window_scan.cu: ranks, lag/lead
# ---------------------------------------------------------------------------------

def win_rank(fn: str, w: "SortedWindowContext", tiles: int = 1
             ) -> torch.Tensor:
    """The rank family from the context's positions: int32, float64 for
    percent_rank and cume_dist."""
    if w.seg_start_pos.is_cuda:
        return win_rank_kernel(fn, w, tiles)
    return win_rank_plain(fn, w, tiles)


def win_rank_plain(fn: str, w, tiles: int = 1) -> torch.Tensor:
    """Plain PyTorch version of ``win_rank`` in ``csrc/window_scan.cu``."""
    i = torch.arange(w.n, device=w.device, dtype=torch.int64)
    s = w.seg_start_pos.long()
    if fn == "row_number":
        return (i - s + 1).to(torch.int32)
    if fn == "rank":
        return (w.peer_start_pos.long() - s + 1).to(torch.int32)
    if fn == "dense_rank":
        return w.dense_count()
    e = w.seg_end_pos.long()
    if fn == "percent_rank":
        rows1 = (e - s).to(torch.float64)
        r = (w.peer_start_pos.long() - s).to(torch.float64)
        return torch.where(rows1 > 0, r / torch.where(rows1 > 0, rows1,
                                                      torch.ones_like(rows1)),
                           torch.zeros_like(rows1))
    if fn == "cume_dist":
        return ((w.peer_end_pos.long() - s + 1).to(torch.float64)
                / (e - s + 1).to(torch.float64))
    size = e - s + 1
    rn0 = i - s
    base, rem = size // tiles, size % tiles
    big = base + 1
    tile = torch.where(rn0 < big * rem, rn0 // big,
                       rem + (rn0 - big * rem) // torch.clamp(base, min=1))
    return (tile + 1).to(torch.int32)


def win_rank_kernel(fn: str, w, tiles: int = 1) -> torch.Tensor:
    """Launch ``win_rank`` of ``csrc/window_scan.cu``."""
    n = w.n
    dense = w.dense_count() if fn == "dense_rank" else None
    peer_end = w.peer_end_pos if fn == "cume_dist" else None
    _check([w.seg_start_pos, w.seg_end_pos, w.peer_start_pos, peer_end,
            dense], n)
    dtype = torch.float64 if fn in ("percent_rank", "cume_dist") \
        else torch.int32
    out = torch.empty(n, dtype=dtype, device=w.device)
    if n == 0:
        return out
    lib = kernels.load("window_scan")
    rc = lib.win_rank(_RANKS[fn], tiles, w.seg_start_pos.data_ptr(),
                      w.seg_end_pos.data_ptr(), w.peer_start_pos.data_ptr(),
                      _ptr(peer_end), _ptr(dense), n, out.data_ptr(),
                      _stream(out))
    kernels.check_launch(lib, "win_rank", rc)
    win_rank_kernel.launches += 1
    return out


win_rank_kernel.launches = 0


def win_shift(w: "SortedWindowContext", val: Value, offset: int,
              default: Optional[Value]) -> Value:
    """lag (offset > 0) / lead (offset < 0) of a sorted column; ``default``
    is a full column or None (null)."""
    if val[0].is_cuda:
        return win_shift_kernel(w, val, offset, default)
    return win_shift_plain(w, val, offset, default)


def win_shift_plain(w, val: Value, offset: int, default) -> Value:
    """Plain PyTorch version of ``win_shift`` in ``csrc/window_scan.cu``."""
    d, v = val
    i = torch.arange(w.n, device=w.device, dtype=torch.int64)
    src = i - offset
    in_seg = (src >= w.seg_start_pos.long()) & (src <= w.seg_end_pos.long())
    safe = torch.where(in_seg, src, i)
    out = d[safe]
    valid = in_seg if v is None else in_seg & v[safe]
    if default is not None:
        dd, dv = default
        out = torch.where(in_seg, out, dd)
        valid = torch.where(in_seg, valid, torch.ones_like(valid)
                            if dv is None else dv)
    return out, valid


def win_shift_kernel(w, val: Value, offset: int, default) -> Value:
    """Launch ``win_shift`` of ``csrc/window_scan.cu``."""
    d, v = val
    n = w.n
    dd, dv = default if default is not None else (None, None)
    _check([d, v, dd, dv, w.seg_start_pos, w.seg_end_pos], n)
    if dd is not None and dd.dtype != d.dtype:
        raise ValueError("the default must have the column's type")
    out = torch.empty_like(d)
    out_valid = torch.empty(n, dtype=torch.bool, device=d.device)
    if n == 0:
        return out, out_valid
    lib = kernels.load("window_scan")
    rc = lib.win_shift(d.data_ptr(), _ptr(v), d.element_size(), offset,
                       _ptr(dd), _ptr(dv), w.seg_start_pos.data_ptr(),
                       w.seg_end_pos.data_ptr(), n, out.data_ptr(),
                       out_valid.data_ptr(), _stream(out))
    kernels.check_launch(lib, "win_shift", rc)
    win_shift_kernel.launches += 1
    return out, out_valid


win_shift_kernel.launches = 0


# ---------------------------------------------------------------------------------
# window_frame.cu: frames
# ---------------------------------------------------------------------------------

def frame_rows(w: "SortedWindowContext", lo: Optional[int],
               hi: Optional[int]):
    """(lo_pos, hi_pos) int32 of ROWS BETWEEN lo AND hi (None:
    unbounded), clamped to the partition."""
    if w.seg_start_pos.is_cuda:
        return frame_rows_kernel(w, lo, hi)
    return frame_rows_plain(w, lo, hi)


def frame_rows_plain(w, lo, hi):
    """Plain PyTorch version of ``frame_rows`` in
    ``csrc/window_frame.cu``."""
    i = torch.arange(w.n, device=w.device, dtype=torch.int64)
    s, e = w.seg_start_pos.long(), w.seg_end_pos.long()
    a = s if lo is None else torch.maximum(i + lo, s)
    b = e if hi is None else torch.minimum(i + hi, e)
    a = torch.minimum(a, e + 1)
    b = torch.maximum(b, s - 1)
    return a.to(torch.int32), b.to(torch.int32)


def frame_rows_kernel(w, lo, hi):
    """Launch ``frame_rows`` of ``csrc/window_frame.cu``."""
    n = w.n
    _check([w.seg_start_pos, w.seg_end_pos], n)
    a = torch.empty(n, dtype=torch.int32, device=w.device)
    b = torch.empty_like(a)
    if n == 0:
        return a, b
    lib = kernels.load("window_frame")
    rc = lib.frame_rows(0 if lo is None else lo, 0 if hi is None else hi,
                        int(lo is None), int(hi is None),
                        w.seg_start_pos.data_ptr(), w.seg_end_pos.data_ptr(),
                        n, a.data_ptr(), b.data_ptr(), _stream(a))
    kernels.check_launch(lib, "frame_rows", rc)
    frame_rows_kernel.launches += 1
    return a, b


frame_rows_kernel.launches = 0


def frame_range(w: "SortedWindowContext", key: Value, lo: Optional[int],
                hi: Optional[int], descending: bool, nulls_first: bool):
    """(lo_pos, hi_pos) int32 of RANGE BETWEEN lo AND hi over the sorted
    integral order key ``key`` (int32 or int64)."""
    if key[0].is_cuda:
        return frame_range_kernel(w, key, lo, hi, descending, nulls_first)
    return frame_range_plain(w, key, lo, hi, descending, nulls_first)


_SAT = 1 << 62


def _sat_add(k: torch.Tensor, delta: int) -> torch.Tensor:
    t = k + delta  # wraps like the kernel's unsigned add
    if delta >= 0:
        return torch.where(t < k, torch.full_like(t, _SAT), t)
    return torch.where(t > k, torch.full_like(t, -_SAT), t)


def _bsearch(a: torch.Tensor, b: torch.Tensor, before) -> torch.Tensor:
    """Per row, the first position in [a, b) where ``before(position)``
    stops holding (it holds on a prefix of the range)."""
    a, b = a.clone(), b.clone()
    while True:
        live = a < b
        if not bool(live.any()):
            return a
        mid = (a + b) >> 1
        go = before(torch.where(live, mid, torch.zeros_like(mid))) & live
        a = torch.where(go, mid + 1, a)
        b = torch.where(live & ~go, mid, b)


def frame_range_plain(w, key: Value, lo, hi, descending: bool,
                      nulls_first: bool):
    """Plain PyTorch version of ``frame_range`` in
    ``csrc/window_frame.cu``."""
    d, v = key
    k = d.to(torch.int64)
    if descending:
        k = -k
    s, e = w.seg_start_pos.long(), w.seg_end_pos.long()
    vs, ve = s, e
    if v is not None:
        first = _bsearch(s, e + 1, (lambda m: ~v[m]) if nulls_first
                         else (lambda m: v[m]))
        if nulls_first:
            vs = first
        else:
            ve = first - 1
    a = s if lo is None else _bsearch(vs, ve + 1, lambda m, t=_sat_add(
        k, lo): k[m] < t)
    b = e if hi is None else _bsearch(vs, ve + 1, lambda m, t=_sat_add(
        k, hi): k[m] <= t) - 1
    if v is not None:
        a = torch.where(v, a, s if nulls_first else ve + 1)
        b = torch.where(v, b, vs - 1 if nulls_first else e)
    return a.to(torch.int32), b.to(torch.int32)


def frame_range_kernel(w, key: Value, lo, hi, descending: bool,
                       nulls_first: bool):
    """Launch ``frame_range`` of ``csrc/window_frame.cu``."""
    d, v = key
    n = w.n
    _check([d, v, w.seg_start_pos, w.seg_end_pos], n)
    if d.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"a RANGE frame's order key is int32 or int64, not "
                         f"{d.dtype}")
    a = torch.empty(n, dtype=torch.int32, device=d.device)
    b = torch.empty_like(a)
    if n == 0:
        return a, b
    lib = kernels.load("window_frame")
    rc = lib.frame_range(d.data_ptr(), d.element_size(), _ptr(v),
                         int(descending), int(nulls_first),
                         0 if lo is None else lo, 0 if hi is None else hi,
                         int(lo is None), int(hi is None),
                         w.seg_start_pos.data_ptr(), w.seg_end_pos.data_ptr(),
                         n, a.data_ptr(), b.data_ptr(), _stream(a))
    kernels.check_launch(lib, "frame_range", rc)
    frame_range_kernel.launches += 1
    return a, b


frame_range_kernel.launches = 0


def frame_sum(run: torch.Tensor, vals: Optional[torch.Tensor],
              mask: Optional[torch.Tensor], lo: torch.Tensor,
              hi: torch.Tensor) -> torch.Tensor:
    """The sum over [lo, hi] of the contributions (``vals`` where ``mask``;
    ``vals`` None: a count of ``mask``), from their partition running sum
    ``run`` (int64 or float64); where the running sum at either end is not
    finite, the frame's own sum (Spark's result for a frame after a NaN or
    an infinity).  Empty frames give 0."""
    if run.is_cuda:
        return frame_sum_kernel(run, vals, mask, lo, hi)
    return frame_sum_plain(run, vals, mask, lo, hi)


def frame_sum_plain(run, vals, mask, lo, hi) -> torch.Tensor:
    """Plain PyTorch version of ``frame_sum`` in ``csrc/window_frame.cu``."""
    n = run.shape[0]
    empty = hi < lo
    a = torch.clamp(lo.long(), 0, max(n - 1, 0))
    b = torch.clamp(hi.long(), 0, max(n - 1, 0))
    first = (torch.ones_like(run) if vals is None else vals)[a]
    if mask is not None:
        first = torch.where(mask[a], first, torch.zeros_like(first))
    out = run[b] - run[a] + first
    if vals is not None and run.is_floating_point():
        bad = ((~torch.isfinite(run[a]) | ~torch.isfinite(run[b]))
               & ~empty).nonzero().squeeze(1)
        if bad.numel():
            # the frame itself, added in row order as the kernel adds it
            # (a masked row adds +0.0, which changes no sum that starts
            # at +0.0)
            fa, length = a[bad], b[bad] - a[bad] + 1
            acc = torch.zeros(bad.numel(), dtype=run.dtype,
                              device=run.device)
            for j in range(int(length.max())):
                at = torch.clamp(fa + j, max=n - 1)
                inside = length > j
                if mask is not None:
                    inside = inside & mask[at]
                acc = acc + torch.where(inside, vals[at], 0.0)
            out[bad] = acc
    return torch.where(empty, torch.zeros_like(out), out)


def frame_sum_kernel(run, vals, mask, lo, hi) -> torch.Tensor:
    """Launch ``frame_sum`` of ``csrc/window_frame.cu``."""
    n = run.shape[0]
    _check([run, vals, mask, lo, hi], n)
    if run.dtype not in (torch.int64, torch.float64) or (
            vals is not None and vals.dtype != run.dtype):
        raise ValueError("framed sums run over int64 or float64")
    out = torch.empty_like(run)
    if n == 0:
        return out
    lib = kernels.load("window_frame")
    rc = lib.frame_sum(int(run.dtype == torch.float64), run.data_ptr(),
                       _ptr(vals), _ptr(mask), lo.data_ptr(), hi.data_ptr(),
                       n, out.data_ptr(), _stream(out))
    kernels.check_launch(lib, "frame_sum", rc)
    frame_sum_kernel.launches += 1
    return out


frame_sum_kernel.launches = 0


def frame_minmax(vals: torch.Tensor, mask: Optional[torch.Tensor],
                 op: str, lo: torch.Tensor, hi: torch.Tensor) -> Value:
    """(min or max over [lo, hi] of ``vals`` where ``mask``, whether any row
    contributed); ``vals`` int64 or float64."""
    if vals.is_cuda:
        return frame_minmax_kernel(vals, mask, op, lo, hi)
    return frame_minmax_plain(vals, mask, op, lo, hi)


def frame_minmax_plain(vals, mask, op: str, lo, hi) -> Value:
    """Plain PyTorch version of ``frame_minmax`` in
    ``csrc/window_frame.cu``: the frame's rows one offset at a time."""
    n = vals.shape[0]
    fn = torch.minimum if op == "min" else torch.maximum
    acc = torch.full_like(vals, identity(op, vals.dtype))
    anyv = torch.zeros(n, dtype=torch.bool, device=vals.device)
    if n == 0:
        return acc, anyv
    width = int((hi.long() - lo.long()).max()) + 1
    for off in range(max(width, 0)):
        j = lo.long() + off
        ok = j <= hi.long()
        jj = torch.clamp(j, 0, n - 1)
        if mask is not None:
            ok = ok & mask[jj]
        acc = torch.where(ok, fn(acc, vals[jj]), acc)
        anyv = anyv | ok
    return acc, anyv


def frame_minmax_kernel(vals, mask, op: str, lo, hi) -> Value:
    """Launch ``frame_minmax`` of ``csrc/window_frame.cu``."""
    n = vals.shape[0]
    _check([vals, mask, lo, hi], n)
    if vals.dtype not in (torch.int64, torch.float64):
        raise ValueError("framed min/max run over int64 or float64")
    out = torch.empty_like(vals)
    out_valid = torch.empty(n, dtype=torch.bool, device=vals.device)
    if n == 0:
        return out, out_valid
    lib = kernels.load("window_frame")
    rc = lib.frame_minmax(int(vals.dtype == torch.float64), int(op == "max"),
                          vals.data_ptr(), _ptr(mask),
                          _bits(identity(op, vals.dtype), vals.dtype),
                          lo.data_ptr(), hi.data_ptr(), n, out.data_ptr(),
                          out_valid.data_ptr(), _stream(out))
    kernels.check_launch(lib, "frame_minmax", rc)
    frame_minmax_kernel.launches += 1
    return out, out_valid


frame_minmax_kernel.launches = 0


def frame_first_last(vals: torch.Tensor, valid: Optional[torch.Tensor],
                     lo: torch.Tensor, hi: torch.Tensor, last: bool,
                     ignore_nulls: bool) -> Value:
    """FIRST or LAST of ``vals`` (float64 or int64) over the frames
    [lo, hi]: the value at the frame's edge, or with ``ignore_nulls`` at
    its first (last) row whose value is valid; (values, valid)."""
    if vals.is_cuda:
        return frame_first_last_kernel(vals, valid, lo, hi, last,
                                       ignore_nulls)
    return frame_first_last_plain(vals, valid, lo, hi, last, ignore_nulls)


def frame_first_last_plain(vals, valid, lo, hi, last: bool,
                           ignore_nulls: bool) -> Value:
    """Plain PyTorch version of ``frame_first_last`` in
    ``csrc/window_frame.cu`` (the reference's next/previous valid position
    scans, ``windowfns.py:321``)."""
    n = vals.shape[0]
    if n == 0:
        return vals.clone(), torch.zeros(0, dtype=torch.bool,
                                         device=vals.device)
    lo, hi = lo.long(), hi.long()
    ok = hi >= lo
    if ignore_nulls and valid is not None:
        idx = torch.arange(n, device=vals.device)
        if last:
            prev = torch.cummax(torch.where(valid, idx, -1), 0).values
            pos = prev[hi.clamp(0, n - 1)]
            ok = ok & (pos >= lo)
        else:
            nxt = torch.flip(torch.cummin(torch.flip(
                torch.where(valid, idx, n), [0]), 0).values, [0])
            pos = nxt[lo.clamp(0, n - 1)]
            ok = ok & (pos <= hi)
        pos = pos.clamp(0, n - 1)
    else:
        pos = (hi if last else lo).clamp(0, n - 1)
        if valid is not None:
            ok = ok & valid[pos]
    return torch.where(ok, vals[pos], torch.zeros_like(vals)), ok


def frame_first_last_kernel(vals, valid, lo, hi, last: bool,
                            ignore_nulls: bool) -> Value:
    """Launch ``frame_first_last`` of ``csrc/window_frame.cu``."""
    n = vals.shape[0]
    _check([vals, valid, lo, hi], n)
    if vals.dtype not in (torch.int64, torch.float64) \
            or lo.dtype != torch.int32 or hi.dtype != torch.int32:
        raise ValueError("frame_first_last takes 8-byte values and int32 "
                         "frame bounds")
    out = torch.empty_like(vals)
    ok = torch.empty(n, dtype=torch.bool, device=vals.device)
    if n == 0:
        return out, ok
    lib = kernels.load("window_frame")
    rc = lib.frame_first_last(vals.data_ptr(), _ptr(valid), lo.data_ptr(),
                              hi.data_ptr(), n, int(last), int(ignore_nulls),
                              out.data_ptr(), ok.data_ptr(), _stream(out))
    kernels.check_launch(lib, "frame_first_last", rc)
    frame_first_last_kernel.launches += 1
    return out, ok


frame_first_last_kernel.launches = 0


# ---------------------------------------------------------------------------------
# The sorted window context and the functions over it
# ---------------------------------------------------------------------------------

def full_column(val: Value, n: int) -> Value:
    """``val`` as ``n``-row columns: a literal (0-d) expanded."""
    d, v = val
    if d.dim() == 0:
        d = d.expand(n).contiguous()
    if v is not None and v.dim() == 0:
        v = v.expand(n).contiguous()
    return d, v


class SortedWindowContext:
    """A window spec's segment structure over ``n`` rows already sorted by
    (partition keys, order keys) (the reference's :35): partition and peer
    starts and their positions.  Keys are (data, valid) in that order;
    :meth:`order` gives the permutation that sorts the input."""

    def __init__(self, part_keys: List[Value], order_keys: List[Value],
                 n: int, device: torch.device):
        self.n = n
        self.device = device
        (self.seg_start, self.peer_start, self.seg_start_pos,
         self.seg_end_pos, self.peer_start_pos, self.peer_end_pos) = \
            win_context(part_keys + order_keys, len(part_keys), n, device)
        self._dense = None

    @staticmethod
    def order(part_keys: List[Value], order_keys: List[Value],
              order_asc: Sequence[bool], order_nulls_first: Sequence[bool],
              n: int, device: torch.device) -> torch.Tensor:
        """int32: the stable permutation by the partition keys (ascending,
        nulls first) and the order keys as given; keys in input order."""
        keys = [(d, v, True, True) for d, v in part_keys] + [
            (d, v, a, nf) for (d, v), a, nf in zip(order_keys, order_asc,
                                                   order_nulls_first)]
        if not keys:
            return torch.arange(n, dtype=torch.int32, device=device)
        return S.sort_keys_perm(keys, None, n)

    def full(self, val: Value) -> Value:
        """A column of the sorted rows, a literal expanded to every row."""
        return full_column(val, self.n)

    def dense_count(self) -> torch.Tensor:
        """int32: the peer groups started so far within the partition."""
        if self._dense is None:
            self._dense = win_scan(torch.int32, "sum", "flag_count", self.n,
                                   flags=self.peer_start,
                                   reset=self.seg_start)
        return self._dense


def running(w: SortedWindowContext, vals: torch.Tensor,
            mask: Optional[torch.Tensor], op: str) -> torch.Tensor:
    """The partition's inclusive running sum, min or max of ``vals`` where
    ``mask``."""
    return win_scan(vals.dtype, op, "values", w.n, vals=vals, mask=mask,
                    reset=w.seg_start)


def running_count(w: SortedWindowContext,
                  mask: Optional[torch.Tensor]) -> torch.Tensor:
    """int64: the partition's inclusive running count of ``mask`` (None:
    every row)."""
    flags = mask if mask is not None else torch.ones(
        w.n, dtype=torch.bool, device=w.device)
    return win_scan(torch.int64, "sum", "flag_count", w.n, flags=flags,
                    reset=w.seg_start)


def partition_reduce(w: SortedWindowContext, scanned: torch.Tensor
                     ) -> torch.Tensor:
    """A partition's running scan at its last row, for every row."""
    return win_take(scanned, w.seg_end_pos)
