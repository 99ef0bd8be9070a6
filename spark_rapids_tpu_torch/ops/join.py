"""The dense direct-address broadcast join: build-key stats, the key → build
row table, and the probe.

The reference keeps these programs inside
``spark_rapids_tpu/plan/join_exec.py`` (``_dense_prefetch`` :1200,
``_dense_build_state_impl`` :1353, ``_dense_join_pair`` :1410); the port
keeps them here, beside their hand-written CUDA kernels
(``csrc/dense_join.cu``).  Each phase has a plain PyTorch version of the
same function in this module; ``join_key_stats``, ``build_join_table`` and
``probe_join`` pick by where the tensors lie: CUDA tensors launch the
kernel (or raise), CPU tensors run the plain version.  Each kernel wrapper
counts its launches in ``<wrapper>.launches``.

Keys are int32 or int64 columns (dates are int32 days), ``valid`` is a bool
mask or None, ``active`` the live-row mask or None (all rows live).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from .. import kernels
from ..batch import live_mask, upload

__all__ = ["DJ_MAX_COLS", "join_key_stats", "build_join_table", "probe_join",
           "dense_join_stats", "dense_join_stats_plain", "dense_join_build",
           "dense_join_build_plain", "dense_join_probe",
           "dense_join_probe_plain"]

Value = Tuple[torch.Tensor, Optional[torch.Tensor]]

DJ_MAX_COLS = 16            # csrc/dense_join.cu DJ_MAX_COLS
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


# ---------------------------------------------------------------------------------
# Stats: [min, max, count] of the live, valid build keys
# ---------------------------------------------------------------------------------

def join_key_stats(keys: torch.Tensor, valid: Optional[torch.Tensor],
                   active: Optional[torch.Tensor]) -> torch.Tensor:
    """int64 [3] device tensor: min, max and number of the live valid keys
    (INT64_MAX, INT64_MIN, 0 when there are none)."""
    run = dense_join_stats if keys.is_cuda else dense_join_stats_plain
    return run(keys, valid, active)


def dense_join_stats_plain(keys, valid, active) -> torch.Tensor:
    """Plain PyTorch version of ``dense_join_stats``."""
    live = live_mask(keys.shape[0], valid, active, keys.device)
    k = keys.to(torch.int64)[live]
    if k.numel() == 0:
        return torch.tensor([_I64_MAX, _I64_MIN, 0], dtype=torch.int64,
                            device=keys.device)
    return torch.stack([k.min(), k.max(),
                        torch.tensor(k.numel(), device=keys.device)])


def dense_join_stats(keys, valid, active) -> torch.Tensor:
    """Launch ``dense_join_stats`` of ``csrc/dense_join.cu``."""
    n = keys.shape[0]
    _check(keys, n, _KEY_TYPES, "join keys")
    _check(valid, n, (torch.bool,), "key valid")
    _check(active, n, (torch.bool,), "active")
    out = upload(torch.tensor([_I64_MAX, _I64_MIN, 0], dtype=torch.int64),
                 keys.device)
    lib = kernels.load("dense_join")
    rc = lib.dense_join_stats(keys.data_ptr(), keys.element_size(),
                              _ptr(valid), _ptr(active), n, out.data_ptr(),
                              _stream(keys))
    kernels.check_launch(lib, "dense_join_stats", rc)
    dense_join_stats.launches += 1
    return out


dense_join_stats.launches = 0


# ---------------------------------------------------------------------------------
# Build: table[key - kmin] = build row, duplicates counted on the device
# ---------------------------------------------------------------------------------

def build_join_table(keys: torch.Tensor, valid: Optional[torch.Tensor],
                     active: Optional[torch.Tensor], kmin: int, D: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int32 [D] table of build rows, -1 where no key; int64 [1] count of
    live valid keys that found their slot taken).  Keys must lie in
    [kmin, kmin + D), as the stats guarantee."""
    run = dense_join_build if keys.is_cuda else dense_join_build_plain
    return run(keys, valid, active, kmin, D)


def dense_join_build_plain(keys, valid, active, kmin: int, D: int):
    """Plain PyTorch version of ``dense_join_build``: which of several rows
    with one key owns the slot is left open, as in the kernel."""
    live = live_mask(keys.shape[0], valid, active, keys.device)
    rows = live.nonzero().squeeze(1)
    idx = keys.to(torch.int64)[rows] - kmin
    keep = (idx >= 0) & (idx < D)
    rows, idx = rows[keep], idx[keep]
    table = torch.full((D,), -1, dtype=torch.int32, device=keys.device)
    table[idx] = rows.to(torch.int32)
    dup = torch.tensor([idx.numel() - torch.unique(idx).numel()],
                       dtype=torch.int64, device=keys.device)
    return table, dup


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
    dup = torch.zeros(1, dtype=torch.int64, device=keys.device)
    lib = kernels.load("dense_join")
    rc = lib.dense_join_build(keys.data_ptr(), keys.element_size(),
                              _ptr(valid), _ptr(active), n, kmin, D,
                              table.data_ptr(), dup.data_ptr(),
                              _stream(keys))
    kernels.check_launch(lib, "dense_join_build", rc)
    dense_join_build.launches += 1
    return table, dup


dense_join_build.launches = 0


# ---------------------------------------------------------------------------------
# Probe: lookup, selection and payload gathers
# ---------------------------------------------------------------------------------

def probe_join(keys: torch.Tensor, valid: Optional[torch.Tensor],
               active: Optional[torch.Tensor], kmin: int, table: torch.Tensor,
               payload: Sequence[Value]) -> Tuple[torch.Tensor, List[Value]]:
    """Inner-join probe of one batch: (bool [n] selection of the probe rows
    whose live valid key is in the table, [(data, valid)] of every payload
    column gathered from the matched build row).  A payload column without
    a validity mask comes back without one: only selected rows count."""
    run = dense_join_probe if keys.is_cuda else dense_join_probe_plain
    return run(keys, valid, active, kmin, table, payload)


def dense_join_probe_plain(keys, valid, active, kmin: int, table, payload):
    """Plain PyTorch version of ``dense_join_probe``."""
    n, D = keys.shape[0], table.shape[0]
    idx = keys.to(torch.int64) - kmin
    ok = live_mask(n, valid, active, keys.device) & (idx >= 0) & (idx < D)
    bi = torch.where(ok, table[idx.clamp(0, D - 1)].to(torch.int64), -1)
    matched = bi >= 0
    safe = bi.clamp(min=0)
    out = []
    for d, v in payload:
        if d.numel() == 0:
            out.append((torch.zeros(n, dtype=d.dtype, device=d.device),
                        None if v is None else torch.zeros_like(matched)))
            continue
        out.append((d[safe].masked_fill(~matched, 0),
                    None if v is None else matched & v[safe]))
    return matched, out


def dense_join_probe(keys, valid, active, kmin: int, table, payload):
    """Launch ``dense_join_probe`` of ``csrc/dense_join.cu``."""
    n, D = keys.shape[0], table.shape[0]
    _check(keys, n, _KEY_TYPES, "join keys")
    _check(valid, n, (torch.bool,), "key valid")
    _check(active, n, (torch.bool,), "active")
    _check(table, D, (torch.int32,), "join table")
    if len(payload) > DJ_MAX_COLS:
        raise ValueError(f"dense_join_probe gathers at most {DJ_MAX_COLS} "
                         f"payload columns, got {len(payload)}")
    dev = keys.device
    sel = torch.empty(n, dtype=torch.bool, device=dev)
    data, vals, elems, outs, out_vals, out = [], [], [], [], [], []
    for d, v in payload:
        m = d.shape[0]
        _check(d, m, (d.dtype,), "payload")
        _check(v, m, (torch.bool,), "payload valid")
        od = torch.empty(n, dtype=d.dtype, device=dev)
        ov = None if v is None else torch.empty(n, dtype=torch.bool,
                                                device=dev)
        data.append(d.data_ptr())
        vals.append(_ptr(v))
        elems.append(d.element_size())
        outs.append(od.data_ptr())
        out_vals.append(_ptr(ov))
        out.append((od, ov))
    lib = kernels.load("dense_join")
    rc = lib.dense_join_probe(
        keys.data_ptr(), keys.element_size(), _ptr(valid), _ptr(active), n,
        kmin, D, table.data_ptr(), len(payload), kernels.pointer_array(data),
        kernels.pointer_array(vals), kernels.int_array(elems),
        kernels.pointer_array(outs), kernels.pointer_array(out_vals),
        sel.data_ptr(), _stream(keys))
    kernels.check_launch(lib, "dense_join_probe", rc)
    dense_join_probe.launches += 1
    return sel, out


dense_join_probe.launches = 0
