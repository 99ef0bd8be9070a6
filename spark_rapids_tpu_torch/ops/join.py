"""Broadcast-join device phases: the dense direct-address join and the CSR
join over a build side that repeats keys.

The reference keeps these programs inside
``spark_rapids_tpu/plan/join_exec.py``: the dense path (``_dense_prefetch``
:1200, ``_dense_build_state_impl`` :1353, ``_dense_join_pair`` :1410) and
the CSR path (``_csr_match_state`` :1040, ``_semi_anti`` :690,
``_outer_join`` :697, ``_expand_rows`` :1649, ``_gather_cols`` :1904).
The port keeps them here, beside their hand-written CUDA kernels
(``csrc/dense_join.cu``, ``csrc/csr_join.cu``).  Each phase has a plain
PyTorch version of the same function in this module; the dispatching
functions (``join_key_stats``, ``build_join_table``, ``probe_join``,
``csr_build``, ``csr_probe``, ``csr_expand``, ``gather_rows``) pick by
where the tensors lie: CUDA tensors launch the kernel (or raise), CPU
tensors run the plain version.  Each kernel wrapper counts its launches in
``<wrapper>.launches``.

Keys are int32 or int64 columns (dates are int32 days), ``valid`` is a bool
mask or None, ``active`` the live-row mask or None (all rows live).  Join
types are "inner", "semi", "anti" and "left"; a null or dead probe key
matches nothing, and an anti join keeps it.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from .. import kernels
from ..batch import live_mask, upload

__all__ = ["DJ_MAX_COLS", "CJ_MAX_COLS", "JOIN_MODES", "join_key_stats",
           "build_join_table", "probe_join", "dense_join_stats",
           "dense_join_stats_plain", "dense_join_build",
           "dense_join_build_plain", "dense_join_probe",
           "dense_join_probe_plain", "csr_build", "csr_build_kernel",
           "csr_build_plain", "csr_probe", "csr_probe_kernel",
           "csr_probe_plain", "csr_expand", "csr_expand_kernel",
           "csr_expand_plain", "gather_rows", "csr_gather",
           "csr_gather_plain"]

Value = Tuple[torch.Tensor, Optional[torch.Tensor]]

DJ_MAX_COLS = 16            # csrc/dense_join.cu DJ_MAX_COLS
CJ_MAX_COLS = 16            # csrc/csr_join.cu CJ_MAX_COLS
SCAN_TILE = 4096            # csrc/csr_join.cu SCAN_TILE
RS_TILE = 4096              # csrc/csr_join.cu RS_TILE
JOIN_MODES = {"inner": 0, "semi": 1, "anti": 2, "left": 3}
_I64_MAX = torch.iinfo(torch.int64).max
_I64_MIN = torch.iinfo(torch.int64).min
_KEY_TYPES = (torch.int32, torch.int64)


def _check(t: Optional[torch.Tensor], n: int, dtypes, what: str) -> None:
    if t is None:
        return
    if t.dtype not in dtypes or t.shape != (n,) or not t.is_contiguous() \
            or not t.is_cuda:
        raise ValueError(f"{what}: expected a contiguous CUDA [{n}] tensor of "
                         f"{dtypes}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _mode(how: str) -> int:
    if how not in JOIN_MODES:
        raise ValueError(f"join type {how!r} is not one of {list(JOIN_MODES)}")
    return JOIN_MODES[how]


# ---------------------------------------------------------------------------------
# Stats: [min, max, count, duplicates] of the live, valid build keys
# ---------------------------------------------------------------------------------

def join_key_stats(keys: torch.Tensor, valid: Optional[torch.Tensor],
                   active: Optional[torch.Tensor], cap: int) -> torch.Tensor:
    """int64 [4] device tensor: min, max and number of the live valid keys
    (INT64_MAX, INT64_MIN, 0 when there are none), and how many of them
    repeat an earlier key — exact when max - min < ``cap``."""
    run = dense_join_stats if keys.is_cuda else dense_join_stats_plain
    return run(keys, valid, active, cap)


def dense_join_stats_plain(keys, valid, active, cap: int) -> torch.Tensor:
    """Plain PyTorch version of ``dense_join_stats``."""
    live = live_mask(keys.shape[0], valid, active, keys.device)
    k = keys.to(torch.int64)[live]
    if k.numel() == 0:
        return torch.tensor([_I64_MAX, _I64_MIN, 0, 0], dtype=torch.int64,
                            device=keys.device)
    marked = k[k - k.min() < cap]
    dup = marked.numel() - torch.unique(marked).numel()
    return torch.stack([k.min(), k.max(),
                        torch.tensor(k.numel(), device=keys.device),
                        torch.tensor(dup, device=keys.device)])


def dense_join_stats(keys, valid, active, cap: int) -> torch.Tensor:
    """Launch ``dense_join_stats`` of ``csrc/dense_join.cu``."""
    n = keys.shape[0]
    _check(keys, n, _KEY_TYPES, "join keys")
    _check(valid, n, (torch.bool,), "key valid")
    _check(active, n, (torch.bool,), "active")
    if cap < 1:
        raise ValueError(f"the duplicate bitmap needs a cap >= 1, got {cap}")
    out = upload(torch.tensor([_I64_MAX, _I64_MIN, 0, 0], dtype=torch.int64),
                 keys.device)
    bitmap = torch.zeros(-(-cap // 32), dtype=torch.int32, device=keys.device)
    lib = kernels.load("dense_join")
    rc = lib.dense_join_stats(keys.data_ptr(), keys.element_size(),
                              _ptr(valid), _ptr(active), n, cap,
                              bitmap.data_ptr(), out.data_ptr(),
                              _stream(keys))
    kernels.check_launch(lib, "dense_join_stats", rc)
    dense_join_stats.launches += 1
    return out


dense_join_stats.launches = 0


# ---------------------------------------------------------------------------------
# Dense build: table[key - kmin] = build row (unique keys)
# ---------------------------------------------------------------------------------

def build_join_table(keys: torch.Tensor, valid: Optional[torch.Tensor],
                     active: Optional[torch.Tensor], kmin: int, D: int
                     ) -> torch.Tensor:
    """int32 [D] table of build rows, -1 where no key.  Keys must be
    unique and lie in [kmin, kmin + D), as the stats guarantee."""
    run = dense_join_build if keys.is_cuda else dense_join_build_plain
    return run(keys, valid, active, kmin, D)


def dense_join_build_plain(keys, valid, active, kmin: int, D: int):
    """Plain PyTorch version of ``dense_join_build``."""
    live = live_mask(keys.shape[0], valid, active, keys.device)
    rows = live.nonzero().squeeze(1)
    idx = keys.to(torch.int64)[rows] - kmin
    keep = (idx >= 0) & (idx < D)
    table = torch.full((D,), -1, dtype=torch.int32, device=keys.device)
    table[idx[keep]] = rows[keep].to(torch.int32)
    return table


def dense_join_build(keys, valid, active, kmin: int, D: int):
    """Launch ``dense_join_build`` of ``csrc/dense_join.cu``."""
    n = keys.shape[0]
    _check(keys, n, _KEY_TYPES, "join keys")
    _check(valid, n, (torch.bool,), "key valid")
    _check(active, n, (torch.bool,), "active")
    if n >= 2**31:
        raise ValueError(f"the dense join table holds int32 build rows; the "
                         f"build side has {n}")
    table = torch.full((D,), -1, dtype=torch.int32, device=keys.device)
    lib = kernels.load("dense_join")
    rc = lib.dense_join_build(keys.data_ptr(), keys.element_size(),
                              _ptr(valid), _ptr(active), n, kmin, D,
                              table.data_ptr(), _stream(keys))
    kernels.check_launch(lib, "dense_join_build", rc)
    dense_join_build.launches += 1
    return table


dense_join_build.launches = 0


# ---------------------------------------------------------------------------------
# Dense probe: lookup, selection and payload gathers
# ---------------------------------------------------------------------------------

def probe_join(keys: torch.Tensor, valid: Optional[torch.Tensor],
               active: Optional[torch.Tensor], kmin: int, table: torch.Tensor,
               payload: Sequence[Value], how: str = "inner"
               ) -> Tuple[torch.Tensor, List[Value]]:
    """Probe of one batch: (bool [n] selection, [(data, valid)] of every
    payload column gathered from the matched build row).  The selection is
    the matched rows (inner, semi), the live unmatched rows (anti) or the
    live rows (left, whose unmatched rows get null payload).  Semi and anti
    take no payload.  In an inner join a payload column without a validity
    mask comes back without one: only selected rows count."""
    run = dense_join_probe if keys.is_cuda else dense_join_probe_plain
    return run(keys, valid, active, kmin, table, payload, how)


def dense_join_probe_plain(keys, valid, active, kmin: int, table, payload,
                           how: str = "inner"):
    """Plain PyTorch version of ``dense_join_probe``."""
    mode = _mode(how)
    n, D = keys.shape[0], table.shape[0]
    idx = keys.to(torch.int64) - kmin
    row_live = live_mask(n, None, active, keys.device)
    ok = row_live & (True if valid is None else valid) & (idx >= 0) \
        & (idx < D)
    bi = torch.where(ok, table[idx.clamp(0, D - 1)].to(torch.int64), -1)
    matched = bi >= 0
    sel = {0: matched, 1: matched, 2: row_live & ~matched,
           3: row_live}[mode]
    safe = bi.clamp(min=0)
    out = []
    for d, v in payload:
        if d.numel() == 0:
            data = torch.zeros(n, dtype=d.dtype, device=d.device)
        else:
            data = d[safe].masked_fill(~matched, 0)
        if mode == 3:
            vout = matched if v is None else matched & v[safe]
        else:
            vout = None if v is None else matched & v[safe]
        out.append((data, vout))
    return sel, out


def dense_join_probe(keys, valid, active, kmin: int, table, payload,
                     how: str = "inner"):
    """Launch ``dense_join_probe`` of ``csrc/dense_join.cu``."""
    mode = _mode(how)
    n, D = keys.shape[0], table.shape[0]
    _check(keys, n, _KEY_TYPES, "join keys")
    _check(valid, n, (torch.bool,), "key valid")
    _check(active, n, (torch.bool,), "active")
    _check(table, D, (torch.int32,), "join table")
    if len(payload) > DJ_MAX_COLS:
        raise ValueError(f"dense_join_probe gathers at most {DJ_MAX_COLS} "
                         f"payload columns, got {len(payload)}")
    if mode in (1, 2) and payload:
        raise ValueError(f"a {how} join gathers no payload")
    dev = keys.device
    sel = torch.empty(n, dtype=torch.bool, device=dev)
    data, vals, elems, outs, out_vals, out = [], [], [], [], [], []
    for d, v in payload:
        m = d.shape[0]
        _check(d, m, (d.dtype,), "payload")
        _check(v, m, (torch.bool,), "payload valid")
        od = torch.empty(n, dtype=d.dtype, device=dev)
        ov = None if v is None and mode != 3 else torch.empty(
            n, dtype=torch.bool, device=dev)
        data.append(d.data_ptr())
        vals.append(_ptr(v))
        elems.append(d.element_size())
        outs.append(od.data_ptr())
        out_vals.append(_ptr(ov))
        out.append((od, ov))
    lib = kernels.load("dense_join")
    rc = lib.dense_join_probe(
        keys.data_ptr(), keys.element_size(), _ptr(valid), _ptr(active), n,
        kmin, D, table.data_ptr(), mode, len(payload),
        kernels.pointer_array(data), kernels.pointer_array(vals),
        kernels.int_array(elems), kernels.pointer_array(outs),
        kernels.pointer_array(out_vals), sel.data_ptr(), _stream(keys))
    kernels.check_launch(lib, "dense_join_probe", rc)
    dense_join_probe.launches += 1
    dense_join_probe.launches_by_how[how] += 1
    return sel, out


dense_join_probe.launches = 0
dense_join_probe.launches_by_how = dict.fromkeys(JOIN_MODES, 0)


# ---------------------------------------------------------------------------------
# CSR build: per-slot counts and starts, and the build rows grouped by slot
# ---------------------------------------------------------------------------------

def csr_build(keys: torch.Tensor, valid: Optional[torch.Tensor],
              active: Optional[torch.Tensor], kmin: int, D: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(int32 [D] counts of live valid keys per slot key - kmin, int64
    [D + 1] their exclusive scan (starts; the last entry is the total),
    int32 [n] b_perm: the build rows in slot order, each slot's rows in
    build order, the rows with no slot last).  Keys must lie in
    [kmin, kmin + D)."""
    run = csr_build_kernel if keys.is_cuda else csr_build_plain
    return run(keys, valid, active, kmin, D)


def _slots_plain(keys, valid, active, kmin: int, D: int) -> torch.Tensor:
    idx = keys.to(torch.int64) - kmin
    ok = live_mask(keys.shape[0], valid, active, keys.device) \
        & (idx >= 0) & (idx < D)
    return torch.where(ok, idx, D)


def csr_build_plain(keys, valid, active, kmin: int, D: int):
    """Plain PyTorch version of ``csr_build_kernel``."""
    slots = _slots_plain(keys, valid, active, kmin, D)
    counts = torch.bincount(slots, minlength=D + 1)[:D].to(torch.int32)
    starts = torch.zeros(D + 1, dtype=torch.int64, device=keys.device)
    starts[1:] = torch.cumsum(counts, 0)
    b_perm = torch.sort(slots, stable=True).indices.to(torch.int32)
    return counts, starts, b_perm


def _scan(counts: torch.Tensor, lib) -> torch.Tensor:
    """int64 [n + 1] exclusive scan of int32 ``counts`` (csr_scan)."""
    n = counts.shape[0]
    out = torch.empty(n + 1, dtype=torch.int64, device=counts.device)
    sums = torch.empty(max(1, -(-n // SCAN_TILE)), dtype=torch.int64,
                       device=counts.device)
    rc = lib.csr_scan(counts.data_ptr(), n, out.data_ptr(), sums.data_ptr(),
                      _stream(counts))
    kernels.check_launch(lib, "csr_scan", rc)
    return out


def csr_build_kernel(keys, valid, active, kmin: int, D: int):
    """Launch the build phase of ``csrc/csr_join.cu``: slots and counts,
    the scan of the counts, and the radix passes of the stable sort."""
    n = keys.shape[0]
    _check(keys, n, _KEY_TYPES, "join keys")
    _check(valid, n, (torch.bool,), "key valid")
    _check(active, n, (torch.bool,), "active")
    if n >= 2**31 - 1 or D >= 2**31 - 1:
        raise ValueError(f"the CSR join holds int32 rows and slots; the build "
                         f"side has {n} rows over {D} slots")
    dev = keys.device
    lib = kernels.load("csr_join")
    stream = _stream(keys)
    slots = torch.empty(n, dtype=torch.int32, device=dev)
    counts = torch.zeros(D, dtype=torch.int32, device=dev)
    rc = lib.csr_slots(keys.data_ptr(), keys.element_size(), _ptr(valid),
                       _ptr(active), n, kmin, D, slots.data_ptr(),
                       counts.data_ptr(), stream)
    kernels.check_launch(lib, "csr_slots", rc)
    starts = _scan(counts, lib)
    tiles = max(1, -(-n // RS_TILE))
    hist = torch.empty(256 * tiles, dtype=torch.int32, device=dev)
    offs = torch.empty(256 * tiles + 1, dtype=torch.int64, device=dev)
    sums = torch.empty(max(1, -(-256 * tiles // SCAN_TILE)),
                       dtype=torch.int64, device=dev)
    keys_b = torch.empty_like(slots)
    vals_a = torch.empty_like(slots)
    vals_b = torch.empty_like(slots)
    k_in, v_in, k_out, v_out = slots, None, keys_b, vals_a
    for shift in range(0, max(D.bit_length(), 1), 8):
        rc = lib.csr_sort_pass(k_in.data_ptr(), _ptr(v_in), k_out.data_ptr(),
                               v_out.data_ptr(), n, shift, hist.data_ptr(),
                               offs.data_ptr(), sums.data_ptr(), stream)
        kernels.check_launch(lib, "csr_sort_pass", rc)
        k_in, v_in = k_out, v_out
        k_out = slots if k_in is keys_b else keys_b
        v_out = vals_b if v_in is vals_a else vals_a
    csr_build_kernel.launches += 1
    return counts, starts, v_in


csr_build_kernel.launches = 0


# ---------------------------------------------------------------------------------
# CSR probe: semi/anti selections, or the output counts and their offsets
# ---------------------------------------------------------------------------------

def csr_probe(keys: torch.Tensor, valid: Optional[torch.Tensor],
              active: Optional[torch.Tensor], kmin: int,
              counts: torch.Tensor, starts: torch.Tensor, how: str):
    """Semi and anti: the bool [n] selection.  Inner and left: (int32 [n]
    lo, each row's first position in b_perm, -1 without a match; int64
    [n + 1] offsets of each row's output rows, the total last)."""
    run = csr_probe_kernel if keys.is_cuda else csr_probe_plain
    return run(keys, valid, active, kmin, counts, starts, how)


def csr_probe_plain(keys, valid, active, kmin: int, counts, starts,
                    how: str):
    """Plain PyTorch version of ``csr_probe_kernel``."""
    mode = _mode(how)
    n, D = keys.shape[0], counts.shape[0]
    row_live = live_mask(n, None, active, keys.device)
    slots = _slots_plain(keys, valid, active, kmin, D)
    found = slots < D
    safe = slots.clamp(max=D - 1)
    matches = torch.where(found, counts[safe].to(torch.int64), 0)
    if mode == 1:
        return matches > 0
    if mode == 2:
        return row_live & (matches == 0)
    lo = torch.where(matches > 0, starts[safe], -1).to(torch.int32)
    cnt = torch.where(row_live, matches.clamp(min=1), 0) if mode == 3 \
        else matches
    offsets = torch.zeros(n + 1, dtype=torch.int64, device=keys.device)
    offsets[1:] = torch.cumsum(cnt, 0)
    return lo, offsets


def csr_probe_kernel(keys, valid, active, kmin: int, counts, starts,
                     how: str):
    """Launch ``csr_probe`` of ``csrc/csr_join.cu`` (and, for inner and
    left, ``csr_scan`` of the output counts)."""
    mode = _mode(how)
    n, D = keys.shape[0], counts.shape[0]
    _check(keys, n, _KEY_TYPES, "join keys")
    _check(valid, n, (torch.bool,), "key valid")
    _check(active, n, (torch.bool,), "active")
    _check(counts, D, (torch.int32,), "counts")
    _check(starts, D + 1, (torch.int64,), "starts")
    dev = keys.device
    lib = kernels.load("csr_join")
    sel = lo = cnt = None
    if mode in (1, 2):
        sel = torch.empty(n, dtype=torch.bool, device=dev)
    else:
        lo = torch.empty(n, dtype=torch.int32, device=dev)
        cnt = torch.empty(n, dtype=torch.int32, device=dev)
    rc = lib.csr_probe(keys.data_ptr(), keys.element_size(), _ptr(valid),
                       _ptr(active), n, kmin, D, counts.data_ptr(),
                       starts.data_ptr(), mode, _ptr(lo), _ptr(cnt),
                       _ptr(sel), _stream(keys))
    kernels.check_launch(lib, "csr_probe", rc)
    csr_probe_kernel.launches += 1
    if sel is not None:
        return sel
    return lo, _scan(cnt, lib)


csr_probe_kernel.launches = 0


# ---------------------------------------------------------------------------------
# CSR expansion: gather maps (pi, bi) of the output rows
# ---------------------------------------------------------------------------------

def csr_expand(offsets: torch.Tensor, lo: torch.Tensor, b_perm: torch.Tensor,
               total: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int64 [total] probe row of each output row, int32 [total] its
    build row, -1 for a left join's unmatched row).  ``total`` is
    ``offsets[-1]``, read by the caller's one fetch."""
    run = csr_expand_kernel if offsets.is_cuda else csr_expand_plain
    return run(offsets, lo, b_perm, total)


def csr_expand_plain(offsets, lo, b_perm, total: int):
    """Plain PyTorch version of ``csr_expand_kernel``."""
    n = lo.shape[0]
    cnt = offsets[1:] - offsets[:-1]
    pi = torch.repeat_interleave(torch.arange(n, device=lo.device), cnt)
    k = torch.arange(total, device=lo.device) - offsets[:-1][pi]
    first = lo.to(torch.int64)[pi]
    if b_perm.numel() == 0:  # nothing to match: every row is a miss
        return pi, torch.full((total,), -1, dtype=torch.int32,
                              device=lo.device)
    at = (first + k).clamp(0, b_perm.numel() - 1)
    bi = torch.where(first < 0, -1, b_perm.to(torch.int64)[at])
    return pi, bi.to(torch.int32)


def csr_expand_kernel(offsets, lo, b_perm, total: int):
    """Launch ``csr_expand`` of ``csrc/csr_join.cu``."""
    n = lo.shape[0]
    _check(offsets, n + 1, (torch.int64,), "offsets")
    _check(lo, n, (torch.int32,), "lo")
    _check(b_perm, b_perm.shape[0], (torch.int32,), "b_perm")
    pi = torch.empty(total, dtype=torch.int64, device=lo.device)
    bi = torch.empty(total, dtype=torch.int32, device=lo.device)
    lib = kernels.load("csr_join")
    rc = lib.csr_expand(offsets.data_ptr(), lo.data_ptr(), b_perm.data_ptr(),
                        n, pi.data_ptr(), bi.data_ptr(), _stream(lo))
    kernels.check_launch(lib, "csr_expand", rc)
    csr_expand_kernel.launches += 1
    return pi, bi


csr_expand_kernel.launches = 0


# ---------------------------------------------------------------------------------
# Gathers by a gather map
# ---------------------------------------------------------------------------------

def gather_rows(idx: torch.Tensor, cols: Sequence[Value],
                nullable: bool) -> List[Value]:
    """Each (data, valid) column's rows at ``idx`` (int64 or int32); with
    ``nullable``, idx < 0 gives a null row and every output has a
    validity mask."""
    run = csr_gather if idx.is_cuda else csr_gather_plain
    out: List[Value] = []
    for lo in range(0, len(cols), CJ_MAX_COLS):
        out += run(idx, cols[lo:lo + CJ_MAX_COLS], nullable)
    return out


def csr_gather_plain(idx, cols, nullable: bool) -> List[Value]:
    """Plain PyTorch version of ``csr_gather``."""
    ok = idx >= 0
    safe = idx.to(torch.int64).clamp(min=0)
    out = []
    for d, v in cols:
        if d.numel() == 0:
            data = torch.zeros(idx.shape[0], dtype=d.dtype, device=d.device)
            vout = torch.zeros_like(ok) if (nullable or v is not None) \
                else None
            out.append((data, vout))
            continue
        data = d[safe].masked_fill(~ok, 0)
        if v is None:
            vout = ok.clone() if nullable else None
        else:
            vout = ok & v[safe]
        out.append((data, vout))
    return out


def csr_gather(idx, cols, nullable: bool) -> List[Value]:
    """Launch ``csr_gather`` of ``csrc/csr_join.cu``."""
    n = idx.shape[0]
    _check(idx, n, (torch.int32, torch.int64), "gather map")
    if len(cols) > CJ_MAX_COLS:
        raise ValueError(f"csr_gather takes at most {CJ_MAX_COLS} columns")
    dev = idx.device
    data, vals, elems, outs, out_vals, out = [], [], [], [], [], []
    for d, v in cols:
        m = d.shape[0]
        _check(d, m, (d.dtype,), "column")
        _check(v, m, (torch.bool,), "column valid")
        if d.element_size() not in (1, 2, 4, 8):
            raise ValueError(f"csr_gather moves 1, 2, 4 or 8-byte elements, "
                             f"not {d.dtype}")
        od = torch.empty(n, dtype=d.dtype, device=dev)
        ov = None if v is None and not nullable else torch.empty(
            n, dtype=torch.bool, device=dev)
        data.append(d.data_ptr())
        vals.append(_ptr(v))
        elems.append(d.element_size())
        outs.append(od.data_ptr())
        out_vals.append(_ptr(ov))
        out.append((od, ov))
    lib = kernels.load("csr_join")
    rc = lib.csr_gather(idx.data_ptr(), idx.element_size(), n, len(cols),
                        kernels.pointer_array(data),
                        kernels.pointer_array(vals),
                        kernels.int_array(elems),
                        kernels.pointer_array(outs),
                        kernels.pointer_array(out_vals), _stream(idx))
    kernels.check_launch(lib, "csr_gather", rc)
    csr_gather.launches += 1
    return out


csr_gather.launches = 0
