"""Join device phases: the dense direct-address join, the CSR join over a
build side that repeats keys, and the sort-based match state of a join on
any key tuple.

The reference keeps these programs inside
``spark_rapids_tpu/plan/join_exec.py``: the dense path (``_dense_prefetch``
:1200, ``_dense_build_state_impl`` :1353, ``_dense_join_pair`` :1410) and
the CSR path (``_csr_match_state`` :1040, ``_semi_anti`` :690,
``_outer_join`` :697, ``_expand_rows`` :1649, ``_gather_cols`` :1904).
The sorted path is the reference's ``BroadcastJoinExec._match_state``
:932 with ``_float_orderable`` :1674 and the shuffled join's
``_match_state`` :626 with ``_unmatched_build_mask`` :750.
The port keeps them here, beside their hand-written CUDA kernels
(``csrc/dense_join.cu``, ``csrc/csr_join.cu``, ``csrc/sort_join.cu``).
The pairs and counts of joins that match on more than key equality (a
residual condition: ``_conditioned_probe_join`` :446; the cross product:
``_cross`` :827) run through ``csrc/cond_join.cu`` (``cond_expand``,
``cond_counts``, ``cross_pairs``).
Each phase has a plain PyTorch version of the same function in this
module; the dispatching
functions (``join_key_stats``, ``build_join_table``, ``probe_join``,
``csr_build``, ``csr_probe``, ``csr_expand``, ``gather_rows``,
``sorted_build``, ``sorted_probe``, ``unmatched_build_mask``) pick by
where the tensors lie: CUDA tensors launch the kernel (or raise), CPU
tensors run the plain version.  Each kernel wrapper counts its launches in
``<wrapper>.launches``.

The dense and CSR keys are int32 or int64 columns (dates are int32 days);
the sorted path takes a tuple of integer, date, float and dictionary-code
columns.  ``valid`` is a bool mask or None, ``active`` the live-row mask or
None (all rows live).  Join types are "inner", "semi", "anti" and "left"
(the sorted path: also "right" and "full"); a null or dead probe key
matches nothing, and an anti join keeps it.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from .. import kernels
from ..batch import live_mask, upload

__all__ = ["DJ_MAX_COLS", "CJ_MAX_COLS", "JOIN_MODES", "join_key_stats",
           "build_join_table", "probe_join", "dense_join_stats",
           "dense_join_stats_plain", "dense_join_build",
           "dense_join_build_plain", "SparseTable", "dense_layout",
           "dense_join_build_sparse", "dense_join_build_sparse_plain",
           "dense_join_probe",
           "dense_join_probe_plain", "csr_build", "csr_build_kernel",
           "csr_build_plain", "csr_probe", "csr_probe_kernel",
           "csr_probe_plain", "csr_expand", "csr_expand_kernel",
           "csr_expand_plain", "gather_rows", "csr_gather",
           "csr_gather_plain", "SJ_MAX_KEYS", "SortedBuild", "sort_image",
           "sorted_build", "sorted_build_plain", "sorted_build_kernel",
           "sorted_probe", "sorted_probe_plain", "sorted_probe_kernel",
           "unmatched_build_mask", "unmatched_build_plain",
           "unmatched_build_kernel", "partition_perm", "partition_perm_plain",
           "partition_perm_kernel", "cond_expand", "cond_expand_plain",
           "cond_expand_kernel", "cond_counts", "cond_counts_plain",
           "cond_counts_kernel", "cross_pairs", "cross_pairs_plain",
           "cross_pairs_kernel"]

Value = Tuple[torch.Tensor, Optional[torch.Tensor]]

DJ_MAX_COLS = 16            # csrc/dense_join.cu DJ_MAX_COLS
DJ_BLOCK_SLOTS = 224        # csrc/dense_join.cu DJ_BLOCK_SLOTS
DJ_RANK_TILE = 2048         # csrc/dense_join.cu DJ_RANK_TILE
# The dense layout rule (dense_layout): a direct table past DIRECT_L2_BYTES
# does not stay in the H100's 50 MB L2 beside a probe's streams
# (tools/dense_probe_bench.cu: the probe at Q3's shape with its table read
# from a 16 MB array ran 0.095 ms against 0.126 from the 60 MB table); the
# sparse layout is taken where it is at most SPARSE_L2_BYTES.
DIRECT_L2_BYTES = 16 << 20
SPARSE_L2_BYTES = 16 << 20
CJ_MAX_COLS = 16            # csrc/csr_join.cu CJ_MAX_COLS
SCAN_TILE = 4096            # csrc/csr_join.cu SCAN_TILE
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

class SparseTable(NamedTuple):
    """The sparse layout of a dense join's D slots: ``blk`` int32
    [ceil(D / 224) * 8], per 224 slots a rank word (the live slots before
    them) and 7 bitmap words; ``rows`` int32 [count], the live build rows
    in slot order."""
    blk: torch.Tensor
    rows: torch.Tensor
    D: int


DenseTable = Union[torch.Tensor, SparseTable]


def _sparse_blocks(D: int) -> int:
    return -(-D // DJ_BLOCK_SLOTS)


def dense_layout(D: int, count: int) -> str:
    """"sparse" where a direct table of ``D`` slots would not stay in L2
    and the sparse layout of ``count`` live keys would, else "direct"."""
    sparse = 32 * _sparse_blocks(D) + 4 * count
    return "sparse" if 4 * D > DIRECT_L2_BYTES and sparse <= SPARSE_L2_BYTES \
        else "direct"


def build_join_table(keys: torch.Tensor, valid: Optional[torch.Tensor],
                     active: Optional[torch.Tensor], kmin: int, D: int,
                     count: Optional[int] = None) -> DenseTable:
    """The build rows of the live valid keys by slot key - kmin: an int32
    [D] table (-1 where no key), or with ``count`` (the live valid keys,
    from the stats) the layout :func:`dense_layout` picks.  Keys must be
    unique and lie in [kmin, kmin + D), as the stats guarantee."""
    if count is None or dense_layout(D, count) == "direct":
        run = dense_join_build if keys.is_cuda else dense_join_build_plain
        return run(keys, valid, active, kmin, D)
    run = dense_join_build_sparse if keys.is_cuda \
        else dense_join_build_sparse_plain
    return run(keys, valid, active, kmin, D, count)


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


def _unpack_bits(blk: torch.Tensor) -> torch.Tensor:
    """bool [blocks, 224]: the sparse layout's bitmap, slot by slot."""
    words = blk.view(-1, 8)[:, 1:].to(torch.int64) & 0xFFFFFFFF
    shifts = torch.arange(32, device=blk.device)
    return ((words.unsqueeze(2) >> shifts) & 1).bool().reshape(
        words.shape[0], DJ_BLOCK_SLOTS)


def dense_join_build_sparse_plain(keys, valid, active, kmin: int, D: int,
                                  count: int) -> SparseTable:
    """Plain PyTorch version of ``dense_join_build_sparse``."""
    dev = keys.device
    live = live_mask(keys.shape[0], valid, active, dev)
    rows = live.nonzero().squeeze(1)
    idx = keys.to(torch.int64)[rows] - kmin
    keep = (idx >= 0) & (idx < D)
    rows, idx = rows[keep], idx[keep]
    nb = _sparse_blocks(D)
    bits = torch.zeros(nb * DJ_BLOCK_SLOTS, dtype=torch.bool, device=dev)
    bits[idx] = True
    bits = bits.view(nb, 7, 32).to(torch.int64)
    words = (bits << torch.arange(32, device=dev)).sum(2)
    words = torch.where(words >= 2**31, words - 2**32, words)
    pop = bits.sum((1, 2))
    rank = torch.cumsum(pop, 0) - pop
    blk = torch.cat([rank.unsqueeze(1), words], 1).to(torch.int32)
    placed = rows[torch.argsort(idx)].to(torch.int32)
    out = torch.zeros(count, dtype=torch.int32, device=dev)
    out[:min(count, placed.numel())] = placed[:count]
    return SparseTable(blk.reshape(-1), out, D)


def dense_join_build_sparse(keys, valid, active, kmin: int, D: int,
                            count: int) -> SparseTable:
    """Launch ``dense_join_build_sparse`` of ``csrc/dense_join.cu`` (three
    kernels: the bits, the rank words, the placed rows)."""
    n = keys.shape[0]
    _check(keys, n, _KEY_TYPES, "join keys")
    _check(valid, n, (torch.bool,), "key valid")
    _check(active, n, (torch.bool,), "active")
    if n >= 2**31 or D >= 2**31:
        raise ValueError(f"the sparse layout holds int32 build rows and "
                         f"slots; the build side has {n} rows over {D}")
    nb = _sparse_blocks(D)
    tiles = -(-nb // DJ_RANK_TILE)
    # the blocks, then the rank scan's status words, its tile counter and
    # the live rows' count: all zeroed in one fill
    words = torch.zeros(nb * 8 + 2 * tiles + 2, dtype=torch.int32,
                        device=keys.device)
    rows = torch.empty(count, dtype=torch.int32, device=keys.device)
    listed = torch.empty(count, dtype=torch.int64, device=keys.device)
    lib = kernels.load("dense_join")
    base = words.data_ptr()
    rc = lib.dense_join_build_sparse(
        keys.data_ptr(), keys.element_size(), _ptr(valid), _ptr(active), n,
        kmin, D, base, base + 4 * nb * 8, base + 4 * (nb * 8 + 2 * tiles),
        rows.data_ptr(), listed.data_ptr(), count, _stream(keys))
    kernels.check_launch(lib, "dense_join_build_sparse", rc)
    dense_join_build_sparse.launches += 1
    return SparseTable(words[:nb * 8], rows, D)


dense_join_build_sparse.launches = 0


# ---------------------------------------------------------------------------------
# Dense probe: lookup, selection and payload gathers
# ---------------------------------------------------------------------------------

def probe_join(keys: torch.Tensor, valid: Optional[torch.Tensor],
               active: Optional[torch.Tensor], kmin: int, table: DenseTable,
               payload: Sequence[Value], how: str = "inner"
               ) -> Tuple[torch.Tensor, List[Value]]:
    """Probe of one batch against either layout of
    :func:`build_join_table`: (bool [n] selection, [(data, valid)] of every
    payload column gathered from the matched build row).  The selection is
    the matched rows (inner, semi), the live unmatched rows (anti) or the
    live rows (left, whose unmatched rows get null payload).  Semi and anti
    take no payload.  In an inner join a payload column without a validity
    mask comes back without one: only selected rows count."""
    from .wide_decimal import join_wide, split_wide
    payload, layout = split_wide(payload)
    run = dense_join_probe if keys.is_cuda else dense_join_probe_plain
    sel, out = run(keys, valid, active, kmin, table, payload, how)
    return sel, join_wide(out, layout)


def _lookup_plain(table: DenseTable, idx: torch.Tensor, ok: torch.Tensor
                  ) -> torch.Tensor:
    """int64 build row of each slot ``idx`` where ``ok``, else -1."""
    if isinstance(table, SparseTable):
        nb = table.blk.shape[0] // 8
        bits = _unpack_bits(table.blk)
        flat = bits.reshape(-1)
        slot = torch.where(ok, idx, 0).clamp(0, nb * DJ_BLOCK_SLOTS - 1)
        hit = ok & flat[slot]
        # position = the block's rank + the set bits before the slot in it
        before = (torch.cumsum(bits.to(torch.int64), 1) - bits.to(
            torch.int64)).reshape(-1)
        rank = table.blk.view(nb, 8)[:, 0].to(torch.int64)
        pos = rank[slot // DJ_BLOCK_SLOTS] + before[slot]
        safe = pos.clamp(0, max(table.rows.shape[0] - 1, 0))
        got = table.rows[safe].to(torch.int64) if table.rows.numel() \
            else torch.zeros_like(safe)
        return torch.where(hit, got, -1)
    D = table.shape[0]
    return torch.where(ok, table[idx.clamp(0, D - 1)].to(torch.int64), -1)


def dense_join_probe_plain(keys, valid, active, kmin: int, table, payload,
                           how: str = "inner"):
    """Plain PyTorch version of ``dense_join_probe`` (either layout)."""
    mode = _mode(how)
    n = keys.shape[0]
    D = table.D if isinstance(table, SparseTable) else table.shape[0]
    idx = keys.to(torch.int64) - kmin
    row_live = live_mask(n, None, active, keys.device)
    ok = row_live & (True if valid is None else valid) & (idx >= 0) \
        & (idx < D)
    bi = _lookup_plain(table, idx, ok)
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
    """Launch ``dense_join_probe`` of ``csrc/dense_join.cu`` (either
    layout)."""
    mode = _mode(how)
    n = keys.shape[0]
    _check(keys, n, _KEY_TYPES, "join keys")
    _check(valid, n, (torch.bool,), "key valid")
    _check(active, n, (torch.bool,), "active")
    if isinstance(table, SparseTable):
        D = table.D
        _check(table.blk, _sparse_blocks(D) * 8, (torch.int32,),
               "sparse join blocks")
        _check(table.rows, table.rows.shape[0], (torch.int32,),
               "sparse join rows")
        direct, blk, rows = None, table.blk, table.rows
    else:
        D = table.shape[0]
        _check(table, D, (torch.int32,), "join table")
        direct, blk, rows = table, None, None
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
        kmin, D, _ptr(direct), _ptr(blk), _ptr(rows), mode, len(payload),
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
# CSR build: per-slot starts, and the build rows grouped by slot
# ---------------------------------------------------------------------------------

def csr_build(keys: torch.Tensor, valid: Optional[torch.Tensor],
              active: Optional[torch.Tensor], kmin: int, D: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int64 [D + 1] starts: the first position in b_perm of each slot
    key - kmin, so slot s holds starts[s + 1] - starts[s] live valid keys
    and the last entry is their total; int32 [n] b_perm: the build rows in
    slot order, each slot's rows in build order, the rows with no slot
    last).  Keys must lie in [kmin, kmin + D)."""
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
    counts = torch.bincount(slots, minlength=D + 1)[:D]
    starts = torch.zeros(D + 1, dtype=torch.int64, device=keys.device)
    starts[1:] = torch.cumsum(counts, 0)
    b_perm = torch.sort(slots, stable=True).indices.to(torch.int32)
    return starts, b_perm


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
    """Launch ``csr_build`` of ``csrc/csr_join.cu``: the stable one-sweep
    sort of the rows by slot and the starts of every slot."""
    n = keys.shape[0]
    _check(keys, n, _KEY_TYPES, "join keys")
    _check(valid, n, (torch.bool,), "key valid")
    _check(active, n, (torch.bool,), "active")
    if n >= 2**31 - 1 or not 1 <= D < 2**31 - 1:
        raise ValueError(f"the CSR join holds int32 rows and slots; the build "
                         f"side has {n} rows over {D} slots")
    dev = keys.device
    lib = kernels.load("csr_join")
    starts = torch.empty(D + 1, dtype=torch.int64, device=dev)
    b_perm = torch.empty(n, dtype=torch.int32, device=dev)
    nbytes = lib.csr_build_scratch(n, D)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    rc = lib.csr_build(keys.data_ptr(), keys.element_size(), _ptr(valid),
                       _ptr(active), n, kmin, D, starts.data_ptr(),
                       b_perm.data_ptr(), scratch.data_ptr(), nbytes,
                       _stream(keys))
    kernels.check_launch(lib, "csr_build", rc)
    csr_build_kernel.launches += 1
    return starts, b_perm


csr_build_kernel.launches = 0


# ---------------------------------------------------------------------------------
# CSR probe: semi/anti selections, or the output counts and their offsets
# ---------------------------------------------------------------------------------

def csr_probe(keys: torch.Tensor, valid: Optional[torch.Tensor],
              active: Optional[torch.Tensor], kmin: int,
              starts: torch.Tensor, how: str):
    """Semi and anti: the bool [n] selection.  Inner and left: (int32 [n]
    lo, each row's first position in b_perm, -1 without a match; int64
    [n + 1] offsets of each row's output rows, the total last)."""
    run = csr_probe_kernel if keys.is_cuda else csr_probe_plain
    return run(keys, valid, active, kmin, starts, how)


def csr_probe_plain(keys, valid, active, kmin: int, starts, how: str):
    """Plain PyTorch version of ``csr_probe_kernel``."""
    mode = _mode(how)
    n, D = keys.shape[0], starts.shape[0] - 1
    row_live = live_mask(n, None, active, keys.device)
    slots = _slots_plain(keys, valid, active, kmin, D)
    found = slots < D
    safe = slots.clamp(max=D - 1)
    matches = torch.where(found, starts[safe + 1] - starts[safe], 0)
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


def csr_probe_kernel(keys, valid, active, kmin: int, starts, how: str):
    """Launch ``csr_probe`` of ``csrc/csr_join.cu`` (and, for inner and
    left, ``csr_scan`` of the output counts)."""
    mode = _mode(how)
    n, D = keys.shape[0], starts.shape[0] - 1
    _check(keys, n, _KEY_TYPES, "join keys")
    _check(valid, n, (torch.bool,), "key valid")
    _check(active, n, (torch.bool,), "active")
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
                       _ptr(active), n, kmin, D, starts.data_ptr(), mode,
                       _ptr(lo), _ptr(cnt), _ptr(sel), _stream(keys))
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
                        n, total, pi.data_ptr(), bi.data_ptr(), _stream(lo))
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
    validity mask.  Wide decimal limbs move as two columns."""
    from .wide_decimal import join_wide, split_wide
    cols, layout = split_wide(cols)
    run = csr_gather if idx.is_cuda else csr_gather_plain
    out: List[Value] = []
    for lo in range(0, len(cols), CJ_MAX_COLS):
        out += run(idx, cols[lo:lo + CJ_MAX_COLS], nullable)
    return join_wide(out, layout)


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


# ---------------------------------------------------------------------------------
# Sorted path: the build stably sorted by its key tuple, probes by search
# ---------------------------------------------------------------------------------

SJ_MAX_KEYS = 8             # csrc/sort_join.cu SJ_MAX_KEYS
_SORT_MODES = {"inner": 0, "semi": 1, "anti": 2, "left": 3, "right": 3,
               "full": 3}
_I32_MIN = torch.iinfo(torch.int32).min
_I32_MAX = torch.iinfo(torch.int32).max


def _sort_columns(keys: Sequence[Value]) -> List[Value]:
    """Key columns as the kernel reads them: 4- or 8-byte integers or
    floats (booleans and narrow integers widened to int32), contiguous."""
    out = []
    for d, v in keys:
        if d.dtype in (torch.bool, torch.int8, torch.int16):
            d = d.to(torch.int32)
        if d.dtype not in (torch.int32, torch.int64, torch.float32,
                           torch.float64):
            raise TypeError(f"the sorted join takes integer, date, float and "
                            f"dictionary-code keys, not {d.dtype}")
        out.append((d.contiguous(), None if v is None else v.contiguous()))
    return out


def sort_image(d: torch.Tensor) -> torch.Tensor:
    """int64 image of a key column whose signed order is the reference's
    (``_float_orderable`` for floats: -0.0 and subnormals as +0.0, one
    NaN; integers as they are): equal images are equal join keys."""
    if d.dtype == torch.float64:
        from .hashing import f64_bit_pattern
        b = f64_bit_pattern(d)
        return torch.where(b < 0, ~b, b | _I64_MIN)
    if d.dtype == torch.float32:
        b = d.view(torch.int32)
        b = torch.where(d.abs() < 1.17549435e-38, 0, b)
        b = torch.where(torch.isnan(d), _I32_MAX, b)
        return torch.where(b < 0, ~b, b | _I32_MIN).to(torch.int64)
    return d.to(torch.int64)


class SortedBuild:
    """A sorted build side: ``words`` int64 [k, n], the key images in
    sorted order (valid rows first); ``b_perm`` int32 [n], the build row at
    each sorted position; ``n_valid`` int64 [1] on the device, the number
    of valid rows (live, no null key)."""

    def __init__(self, words: torch.Tensor, b_perm: torch.Tensor,
                 n_valid: torch.Tensor):
        self.words = words
        self.b_perm = b_perm
        self.n_valid = n_valid

    @property
    def n(self) -> int:
        return self.b_perm.shape[0]


def sorted_build(keys: Sequence[Value], active: Optional[torch.Tensor]
                 ) -> SortedBuild:
    """The build rows stably sorted by (invalid, key tuple): valid rows
    first in key order, each key's rows in build order, then the invalid
    rows (dead, or a null key) by key."""
    keys = _sort_columns(keys)
    run = sorted_build_kernel if keys[0][0].is_cuda else sorted_build_plain
    return run(keys, active)


def _row_valid(keys, active, n, device) -> torch.Tensor:
    ok = live_mask(n, None, active, device)
    for _, v in keys:
        if v is not None:
            ok = ok & v
    return ok


def sorted_build_plain(keys, active) -> SortedBuild:
    """Plain PyTorch version of ``sorted_build_kernel``."""
    n, dev = keys[0][0].shape[0], keys[0][0].device
    ok = _row_valid(keys, active, n, dev)
    perm = torch.arange(n, device=dev)
    for d, _ in reversed(keys):
        perm = perm[torch.sort(sort_image(d)[perm], stable=True).indices]
    perm = perm[torch.sort((~ok)[perm].to(torch.int8), stable=True).indices]
    words = torch.stack([sort_image(d)[perm] for d, _ in keys]) if n \
        else torch.empty((len(keys), 0), dtype=torch.int64, device=dev)
    return SortedBuild(words, perm.to(torch.int32),
                       ok.sum().to(torch.int64).reshape(1))


def _sort_key_args(keys):
    P = kernels.pointer_array
    return (len(keys), P([d.data_ptr() for d, _ in keys]),
            P([_ptr(v) for _, v in keys]),
            kernels.int_array([d.element_size() for d, _ in keys]),
            kernels.int_array([int(d.is_floating_point()) for d, _ in keys]))


def _check_sort_keys(keys, active, n):
    if not 1 <= len(keys) <= SJ_MAX_KEYS:
        raise ValueError(f"the sorted join takes 1..{SJ_MAX_KEYS} keys, got "
                         f"{len(keys)}")
    for d, v in keys:
        _check(d, n, (torch.int32, torch.int64, torch.float32, torch.float64),
               "join key")
        _check(v, n, (torch.bool,), "key valid")
    _check(active, n, (torch.bool,), "active")
    if n >= 2**31 - 1:
        raise ValueError(f"the sorted join holds int32 rows; the side has {n}")


def sorted_build_kernel(keys, active) -> SortedBuild:
    """Launch ``sort_build`` of ``csrc/sort_join.cu``."""
    n = keys[0][0].shape[0]
    _check_sort_keys(keys, active, n)
    dev = keys[0][0].device
    words = torch.empty((len(keys), n), dtype=torch.int64, device=dev)
    b_perm = torch.empty(n, dtype=torch.int32, device=dev)
    n_valid = torch.zeros(1, dtype=torch.int64, device=dev)
    lib = kernels.load("sort_join")
    nbytes = lib.sort_build_scratch(
        n, sum(d.element_size() for d, _ in keys) + 1)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    rc = lib.sort_build(*_sort_key_args(keys), _ptr(active), n,
                        words.data_ptr(), b_perm.data_ptr(),
                        n_valid.data_ptr(), scratch.data_ptr(), nbytes,
                        _stream(keys[0][0]))
    kernels.check_launch(lib, "sort_build", rc)
    sorted_build_kernel.launches += 1
    return SortedBuild(words, b_perm, n_valid)


sorted_build_kernel.launches = 0


def sorted_probe(keys: Sequence[Value], active: Optional[torch.Tensor],
                 build: SortedBuild, how: str):
    """Per probe row its match range in the sorted build: (int32 [n] lo,
    -1 without a match; int32 [n] matches, 0 for a dead or null-key row;
    then for semi and anti the bool [n] selection (anti keeps dead-key
    rows that are live), for inner, left, right and full the int64
    [n + 1] offsets of each row's output rows (an outer join's miss
    counts 1), the total last)."""
    if how not in _SORT_MODES:
        raise ValueError(f"join type {how!r} is not one of "
                         f"{list(_SORT_MODES)}")
    keys = _sort_columns(keys)
    run = sorted_probe_kernel if keys[0][0].is_cuda else sorted_probe_plain
    return run(keys, active, build, how)


def sorted_probe_plain(keys, active, build: SortedBuild, how: str):
    """Plain PyTorch version of ``sorted_probe_kernel``."""
    n, dev = keys[0][0].shape[0], keys[0][0].device
    ok = _row_valid(keys, active, n, dev)
    nv = int(build.n_valid[0])
    if len(keys) != build.words.shape[0]:
        raise ValueError("probe and build keys differ in number")
    if len(keys) == 1:
        br, pr = build.words[0, :nv], sort_image(keys[0][0])
    else:
        # dense ranks of the tuples in lexicographic order: the build's
        # stay sorted, so two searches per probe row give its range
        pw = torch.stack([sort_image(d) for d, _ in keys], 1)
        ranks = torch.unique(torch.cat([build.words[:, :nv].t(), pw]),
                             dim=0, return_inverse=True)[1]
        br, pr = ranks[:nv], ranks[nv:]
    first = torch.searchsorted(br, pr, side="left")
    last = torch.searchsorted(br, pr, side="right")
    matches = torch.where(ok, last - first, 0).to(torch.int32)
    lo = torch.where(matches > 0, first, -1).to(torch.int32)
    live = live_mask(n, None, active, dev)
    mode = _SORT_MODES[how]
    if mode == 1:
        return lo, matches, matches > 0
    if mode == 2:
        return lo, matches, live & (matches == 0)
    cnt = torch.where(live, matches.clamp(min=1), 0) if mode == 3 \
        else matches
    offsets = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    offsets[1:] = torch.cumsum(cnt, 0)
    return lo, matches, offsets


def sorted_probe_kernel(keys, active, build: SortedBuild, how: str):
    """Launch ``sort_probe`` of ``csrc/sort_join.cu`` (and, for inner and
    outer joins, ``csr_scan`` of ``csrc/csr_join.cu`` over the counts)."""
    n = keys[0][0].shape[0]
    _check_sort_keys(keys, active, n)
    if len(keys) != build.words.shape[0]:
        raise ValueError("probe and build keys differ in number")
    w = build.words
    if w.dtype != torch.int64 or w.shape != (len(keys), build.n) \
            or not w.is_cuda or not w.is_contiguous():
        raise ValueError(f"sorted keys: expected a contiguous CUDA int64 "
                         f"[{len(keys)}, {build.n}] tensor, got {w.dtype} "
                         f"{tuple(w.shape)} on {w.device}")
    dev = keys[0][0].device
    mode = _SORT_MODES[how]
    lo = torch.empty(n, dtype=torch.int32, device=dev)
    matches = torch.empty(n, dtype=torch.int32, device=dev)
    sel = cnt = None
    if mode in (1, 2):
        sel = torch.empty(n, dtype=torch.bool, device=dev)
    else:
        cnt = torch.empty(n, dtype=torch.int32, device=dev)
    lib = kernels.load("sort_join")
    rc = lib.sort_probe(*_sort_key_args(keys), _ptr(active), n,
                        build.words.data_ptr(), build.n,
                        build.n_valid.data_ptr(), mode, lo.data_ptr(),
                        matches.data_ptr(), _ptr(cnt), _ptr(sel),
                        _stream(keys[0][0]))
    kernels.check_launch(lib, "sort_probe", rc)
    sorted_probe_kernel.launches += 1
    if sel is not None:
        return lo, matches, sel
    return lo, matches, _scan(cnt, kernels.load("csr_join"))


sorted_probe_kernel.launches = 0


def unmatched_build_mask(lo: torch.Tensor, matches: torch.Tensor,
                         build: SortedBuild, active: Optional[torch.Tensor]
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(bool [nb] live build rows no probe row matched, int64 [1] their
    count on the device): a full outer join's unmatched build rows."""
    run = unmatched_build_kernel if lo.is_cuda else unmatched_build_plain
    return run(lo, matches, build, active)


def unmatched_build_plain(lo, matches, build: SortedBuild, active):
    """Plain PyTorch version of ``unmatched_build_kernel``."""
    nb, dev = build.n, build.b_perm.device
    hit_sorted = torch.zeros(nb + 1, dtype=torch.int64, device=dev)
    m = matches > 0
    hit_sorted.index_add_(0, lo[m].to(torch.int64),
                          torch.ones(int(m.sum()), dtype=torch.int64,
                                     device=dev))
    hit_sorted.index_add_(0, (lo[m] + matches[m]).to(torch.int64),
                          -torch.ones(int(m.sum()), dtype=torch.int64,
                                      device=dev))
    covered = torch.cumsum(hit_sorted[:nb], 0) > 0
    hit = torch.zeros(nb, dtype=torch.bool, device=dev)
    hit[build.b_perm.to(torch.int64)] = covered
    mask = live_mask(nb, None, active, dev) & ~hit
    return mask, mask.sum().to(torch.int64).reshape(1)


def unmatched_build_kernel(lo, matches, build: SortedBuild, active):
    """Launch ``sort_unmatched`` of ``csrc/sort_join.cu``."""
    n, nb = lo.shape[0], build.n
    _check(lo, n, (torch.int32,), "lo")
    _check(matches, n, (torch.int32,), "matches")
    _check(build.b_perm, nb, (torch.int32,), "b_perm")
    _check(active, nb, (torch.bool,), "build active")
    dev = lo.device
    hit = torch.zeros(nb, dtype=torch.uint8, device=dev)
    mask = torch.empty(nb, dtype=torch.bool, device=dev)
    count = torch.zeros(1, dtype=torch.int64, device=dev)
    lib = kernels.load("sort_join")
    rc = lib.sort_unmatched(lo.data_ptr(), matches.data_ptr(), n,
                            build.b_perm.data_ptr(), nb, _ptr(active),
                            hit.data_ptr(), mask.data_ptr(), count.data_ptr(),
                            _stream(lo))
    kernels.check_launch(lib, "sort_unmatched", rc)
    unmatched_build_kernel.launches += 1
    return mask, count


unmatched_build_kernel.launches = 0


# ---------------------------------------------------------------------------------
# Stable placement of rows by partition id
# ---------------------------------------------------------------------------------

def partition_perm(pids: torch.Tensor, nparts: int) -> torch.Tensor:
    """int32 [n]: the rows stably ordered by their partition id in
    [0, nparts] (``nparts``: a dead row), so each partition's rows form one
    contiguous run, in row order."""
    run = partition_perm_kernel if pids.is_cuda else partition_perm_plain
    return run(pids, nparts)


def partition_perm_plain(pids, nparts: int) -> torch.Tensor:
    """Plain PyTorch version of ``partition_perm_kernel``."""
    return torch.sort(pids, stable=True).indices.to(torch.int32)


def partition_perm_kernel(pids, nparts: int) -> torch.Tensor:
    """Launch ``partition_perm`` of ``csrc/csr_join.cu``: the one-sweep
    pass once per byte of ``nparts`` (one pass up to 255 partitions), the
    partition id being the digit."""
    n = pids.shape[0]
    _check(pids, n, (torch.int32,), "partition ids")
    if n >= 2**31 - 1 or not 0 <= nparts < 2**31 - 1:
        raise ValueError(f"partition placement takes int32 rows and ids; "
                         f"got {n} rows, {nparts} partitions")
    dev = pids.device
    lib = kernels.load("csr_join")
    perm = torch.empty(n, dtype=torch.int32, device=dev)
    nbytes = lib.partition_perm_scratch(n, nparts)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    rc = lib.partition_perm(pids.data_ptr(), n, nparts, perm.data_ptr(),
                            scratch.data_ptr(), nbytes, _stream(pids))
    kernels.check_launch(lib, "partition_perm", rc)
    partition_perm_kernel.launches += 1
    return perm


partition_perm_kernel.launches = 0


# ---------------------------------------------------------------------------------
# Conditioned and cross joins: candidate pairs and their surviving counts
# ---------------------------------------------------------------------------------

_I32_LIMIT = 2**31


def _pairs_fit(total: int, *sides: int) -> None:
    """Pairs and rows are int32: refuse what would wrap."""
    if total >= _I32_LIMIT or any(n >= _I32_LIMIT for n in sides):
        raise ValueError(f"{total} pairs over sides of {list(sides)} rows: "
                         f"the pair maps hold int32 indices (< 2^31)")


def cond_expand(offsets: torch.Tensor, lo: torch.Tensor, b_perm: torch.Tensor,
                total: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every candidate pair of a match state: (int32 [total] probe row,
    int32 [total] build row), probe rows in order.  ``offsets`` is the
    int64 [n + 1] running count of each probe row's matches (0 for a
    dead or null-key row; ``total`` = ``offsets[-1]``, read by the
    caller's one fetch), ``lo`` the int32 [n] start of its match range in
    the sorted build and ``b_perm`` the int32 build row at each sorted
    position."""
    _pairs_fit(total, lo.shape[0], b_perm.shape[0])
    run = cond_expand_kernel if lo.is_cuda else cond_expand_plain
    return run(offsets, lo, b_perm, total)


def cond_expand_plain(offsets, lo, b_perm, total: int):
    """Plain PyTorch version of ``cond_expand_kernel``."""
    n, dev = lo.shape[0], lo.device
    cnt = offsets[1:] - offsets[:-1]
    pi = torch.repeat_interleave(torch.arange(n, device=dev), cnt)
    k = torch.arange(total, device=dev) - offsets[:-1][pi]
    bi = b_perm.to(torch.int64)[lo.to(torch.int64)[pi] + k] if total \
        else torch.zeros(0, dtype=torch.int64, device=dev)
    return pi.to(torch.int32), bi.to(torch.int32)


def cond_expand_kernel(offsets, lo, b_perm, total: int):
    """Launch ``cond_expand`` of ``csrc/cond_join.cu``."""
    n = lo.shape[0]
    _check(offsets, n + 1, (torch.int64,), "offsets")
    _check(lo, n, (torch.int32,), "lo")
    _check(b_perm, b_perm.shape[0], (torch.int32,), "b_perm")
    pi = torch.empty(total, dtype=torch.int32, device=lo.device)
    bi = torch.empty(total, dtype=torch.int32, device=lo.device)
    lib = kernels.load("cond_join")
    rc = lib.cond_expand(offsets.data_ptr(), lo.data_ptr(),
                         b_perm.data_ptr(), n, total, pi.data_ptr(),
                         bi.data_ptr(), _stream(lo))
    kernels.check_launch(lib, "cond_expand", rc)
    cond_expand_kernel.launches += 1
    return pi, bi


cond_expand_kernel.launches = 0


def cond_counts(keep: torch.Tensor, pi: torch.Tensor, bi: torch.Tensor,
                n_probe: int, n_build: Optional[int]
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The kept pairs counted per probe row (int32 [n_probe]) and, given
    ``n_build``, per build row (int32 [n_build]; None otherwise).
    ``keep`` is bool [total]; ``pi`` is sorted."""
    _pairs_fit(keep.shape[0], n_probe, n_build or 0)
    run = cond_counts_kernel if keep.is_cuda else cond_counts_plain
    return run(keep, pi, bi, n_probe, n_build)


def cond_counts_plain(keep, pi, bi, n_probe: int, n_build: Optional[int]):
    """Plain PyTorch version of ``cond_counts_kernel``."""
    dev, k = keep.device, keep.to(torch.int32)
    pc = torch.zeros(n_probe, dtype=torch.int32, device=dev).index_add_(
        0, pi.to(torch.int64), k)
    if n_build is None:
        return pc, None
    return pc, torch.zeros(n_build, dtype=torch.int32, device=dev) \
        .index_add_(0, bi.to(torch.int64), k)


def cond_counts_kernel(keep, pi, bi, n_probe: int, n_build: Optional[int]):
    """Launch ``cond_counts`` of ``csrc/cond_join.cu``."""
    total, dev = keep.shape[0], keep.device
    _check(keep, total, (torch.bool,), "keep")
    _check(pi, total, (torch.int32,), "pi")
    _check(bi, total, (torch.int32,), "bi")
    pc = torch.zeros(n_probe, dtype=torch.int32, device=dev)
    bc = None if n_build is None else torch.zeros(n_build, dtype=torch.int32,
                                                  device=dev)
    lib = kernels.load("cond_join")
    rc = lib.cond_counts(keep.data_ptr(), pi.data_ptr(), bi.data_ptr(),
                         total, pc.data_ptr(), _ptr(bc), _stream(keep))
    kernels.check_launch(lib, "cond_counts", rc)
    cond_counts_kernel.launches += 1
    return pc, bc


cond_counts_kernel.launches = 0


def cross_pairs(n_l: int, n_r: int, device: torch.device
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cross product's pairs: (int32 j // n_r, int32 j % n_r) for
    j < n_l * n_r, left rows in order."""
    _pairs_fit(n_l * n_r, n_l, n_r)
    run = cross_pairs_kernel if device.type == "cuda" else cross_pairs_plain
    return run(n_l, n_r, device)


def cross_pairs_plain(n_l: int, n_r: int, device):
    """Plain PyTorch version of ``cross_pairs_kernel``."""
    j = torch.arange(n_l * n_r, dtype=torch.int64, device=device)
    n = max(n_r, 1)
    return (j // n).to(torch.int32), (j % n).to(torch.int32)


def cross_pairs_kernel(n_l: int, n_r: int, device):
    """Launch ``cross_pairs`` of ``csrc/cond_join.cu``."""
    pi = torch.empty(n_l * n_r, dtype=torch.int32, device=device)
    bi = torch.empty(n_l * n_r, dtype=torch.int32, device=device)
    lib = kernels.load("cond_join")
    rc = lib.cross_pairs(n_l, n_r, pi.data_ptr(), bi.data_ptr(),
                         _stream(pi))
    kernels.check_launch(lib, "cross_pairs", rc)
    cross_pairs_kernel.launches += 1
    return pi, bi


cross_pairs_kernel.launches = 0
