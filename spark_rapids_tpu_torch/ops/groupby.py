"""Aggregation reductions: the ungrouped masked reduction, the dense grid,
the dense direct-address aggregate and the hash aggregate.

Counterpart of ``spark_rapids_tpu/ops/groupby.py`` (``ungrouped_reduce``
:396, ``grid_group_reduce`` :424, ``group_reduce`` :251) and of the dense
programs of ``spark_rapids_tpu/plan/physical.py`` (:1084, :1321).  The
reference reduces each batch to partials and merges them with further
jitted programs; here every batch adds straight into ONE device
accumulator per query, which gives the same result without the
concat/re-reduce passes.

Each reduction has a hand-written CUDA kernel (``csrc/masked_reduce.cu``,
``csrc/grid_agg.cu``, ``csrc/dense_agg.cu``, ``csrc/hash_agg.cu``) and a
plain PyTorch version of the same function in this module; the
dispatching functions and accumulators pick by where the tensors lie:
CUDA tensors launch the kernel (or raise), CPU tensors run the plain
version.  Each kernel wrapper counts its launches in
``<wrapper>.launches``.

Contributions are ``((data, valid), op)`` pairs as ``aggfns`` makes them;
``data=None`` counts the live rows where ``valid`` holds.  The ops are sum,
min, max, count and the order-sensitive first, last, first_valid and
last_valid (FIRST/LAST, the reference's ``_reduce_segment`` :195 and
``_merge_scalars`` :943): the value at the first or last live row of a
group (``_valid``: the first or last row whose value is valid), where a
batch with no such row leaves the group's earlier value alone.  Their
accumulators come back as ``(value, has)`` pairs, ``has`` telling whether
any batch had such a row.  float64 sums are equal to the bit from run to
run on every path (``csrc/fixed128.cuh``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .. import kernels
from ..batch import live_mask, upload

__all__ = ["init_scalars", "ungrouped_reduce", "masked_reduce",
           "masked_reduce_plain", "GridAccumulator", "grid_group_reduce",
           "grid_agg", "grid_agg_plain", "grid_agg_fold", "GridSums",
           "grid_size", "grid_uses_shared", "query_scale", "in_query_range",
           "dense_key_stats", "dense_agg_stats", "dense_agg_stats_plain",
           "DenseAccumulator", "dense_agg_update", "dense_agg_update_plain",
           "dense_agg_check", "dense_agg_check_plain", "HashAccumulator",
           "hash_agg_update", "hash_agg_update_plain", "hash_agg_fold",
           "record_layout",
           "hash_agg_merge", "hash_agg_merge_plain", "hash_agg_reinsert",
           "MergePool", "merge_op",
           "key_word", "key_from_word", "f64_image", "f64_from_image",
           "group_ratio", "group_ratio_plain", "group_ratio_kernel",
           "GR_MAX_ROWS"]

Value = Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]

_I64_MAX = torch.iinfo(torch.int64).max
_I64_MIN = torch.iinfo(torch.int64).min
_OPCODE = {"sum": 0, "min": 1, "max": 2, "count": 3, "first": 4, "last": 5}
ORDERED_OPS = ("first", "last", "first_valid", "last_valid")
MR_MAX_BLOCKS = 4096    # the scratch's partials: blocks x MR_MAX_COLS
MR_MAX_COLS = 16        # csrc/masked_reduce.cu MR_MAX_COLS
GA_MAX_KEYS = 8         # csrc/grid_agg.cu GA_MAX_KEYS
GA_MAX_COLS = 32        # csrc/grid_agg.cu GA_MAX_COLS
GRID_SHARED_BYTES = 48 * 1024


def kernel_op(op: str, valid: Optional[torch.Tensor]):
    """The kernels' op and qualifying mask of a contribution: first/last
    pick among the live rows (their values' validity rides in a second
    buffer), first_valid/last_valid among the rows whose value is valid."""
    if op in ("first", "last"):
        return op, None
    if op in ("first_valid", "last_valid"):
        return op[:-6], valid
    return op, valid


def _column(x: Optional[torch.Tensor], n: int) -> Optional[torch.Tensor]:
    """A full, contiguous [n] column (literals evaluate to 0-dim tensors)."""
    if x is None:
        return None
    if x.dim() == 0:
        x = x.expand(n)
    return x.contiguous()


# ---------------------------------------------------------------------------------
# Ungrouped: K columns -> K scalars
# ---------------------------------------------------------------------------------

def init_scalars(specs: Sequence[Tuple[str, bool]],
                 device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The accumulator of an ungrouped aggregate: ``specs`` is one
    (op, is_f64) per buffer; returns (acc_f [K] float64, acc_i [K] int64)
    holding each op's identity.  Column j lives in acc_f[j] when float64,
    else in acc_i[j]."""
    f_init = {"sum": 0.0, "min": float("inf"), "max": float("-inf")}
    i_init = {"sum": 0, "min": _I64_MAX, "max": _I64_MIN}
    acc_f = torch.tensor([f_init.get(op, 0.0) if f else 0.0
                          for op, f in specs], dtype=torch.float64)
    acc_i = torch.tensor([0 if f else i_init.get(op, 0) for op, f in specs],
                         dtype=torch.int64)
    return upload(acc_f, device), upload(acc_i, device)


def ungrouped_reduce(contributions: List[Tuple[Value, str]],
                     active: torch.Tensor, acc_f: torch.Tensor,
                     acc_i: torch.Tensor,
                     acc_h: Optional[torch.Tensor] = None) -> None:
    """Adds one batch into an ungrouped accumulator (in place):
    masked sum/min/max of float64 or int64 contributions, counts, and
    first/last values (``acc_h`` [K] int64: per slot, whether a batch had
    a qualifying row; needed when a contribution is first or last)."""
    n = active.shape[0]
    cols = []
    for (d, v), op in contributions:
        op, v = kernel_op("count" if d is None else op, v)
        cols.append((_column(d, n), _column(v, n), op))
    if acc_h is None and any(op in ("first", "last") for _, _, op in cols):
        raise ValueError("first/last need the accumulator's has words")
    if active.is_cuda:
        masked_reduce(cols, active, acc_f, acc_i, acc_h)
    else:
        masked_reduce_plain(cols, active, acc_f, acc_i, acc_h)


def _min_f64(x: torch.Tensor) -> torch.Tensor:
    """jnp.min over float64: NaN propagates and -0.0 sorts below +0.0."""
    r = x.min()
    neg_zero = ((x == 0) & torch.signbit(x)).any()
    return torch.where(r == 0, torch.where(neg_zero, -0.0, 0.0), r)


def _max_f64(x: torch.Tensor) -> torch.Tensor:
    """jnp.max over float64: NaN propagates and +0.0 sorts above -0.0."""
    r = x.max()
    pos_zero = ((x == 0) & ~torch.signbit(x)).any()
    return torch.where(r == 0, torch.where(pos_zero, 0.0, -0.0), r)


def masked_reduce_plain(cols, active: torch.Tensor, acc_f: torch.Tensor,
                        acc_i: torch.Tensor,
                        acc_h: Optional[torch.Tensor] = None) -> None:
    """Plain PyTorch version of ``csrc/masked_reduce.cu``: ``cols`` is one
    (data, valid, op) per accumulator slot, op in
    sum/min/max/count/first/last (first/last: the value at the first or
    last row where ``active`` and ``valid`` hold, into acc_f or acc_i by
    the value's type, ``acc_h`` marking that a batch had one; an earlier
    batch's FIRST stays)."""
    if active.shape[0] == 0:
        return
    for j, (d, v, op) in enumerate(cols):
        m = active if v is None else active & v
        if op in ("first", "last"):
            rows = m.nonzero().squeeze(1)
            if rows.numel() == 0 or (op == "first" and bool(acc_h[j])):
                continue
            x = d[rows[0] if op == "first" else rows[-1]]
            (acc_f if d.dtype == torch.float64 else acc_i)[j] = x
            acc_h[j] = 1
        elif op == "count":
            acc_i[j] += m.sum()
        elif d.dtype == torch.float64:
            if op == "sum":
                acc_f[j] += torch.where(m, d, 0.0).sum()
            else:
                fill = float("inf") if op == "min" else float("-inf")
                part = torch.where(m, d, fill)
                red = _min_f64 if op == "min" else _max_f64
                acc_f[j] = red(torch.stack([acc_f[j], red(part)]))
        elif op == "sum":
            acc_i[j] += torch.where(m, d, 0).sum()
        elif op == "min":
            acc_i[j] = torch.minimum(acc_i[j],
                                     torch.where(m, d, _I64_MAX).min())
        else:
            acc_i[j] = torch.maximum(acc_i[j],
                                     torch.where(m, d, _I64_MIN).max())


def _check_column(t: torch.Tensor, n: int, dtypes, what: str) -> None:
    if t.dtype not in dtypes or t.shape != (n,) or not t.is_contiguous() \
            or not t.is_cuda:
        raise ValueError(f"{what}: expected a contiguous CUDA [{n}] tensor of "
                         f"{dtypes}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")


_MR_SCRATCH: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def _mr_scratch(device: torch.device, stream: int) -> torch.Tensor:
    """The kernel's partials and ticket for one stream, made (zeroed) once
    per process: the kernel leaves the ticket at 0 for the next call."""
    key = (device, stream)
    if key not in _MR_SCRATCH:
        _MR_SCRATCH[key] = torch.zeros(MR_MAX_BLOCKS * MR_MAX_COLS + 1,
                                       dtype=torch.int64, device=device)
    return _MR_SCRATCH[key]


def masked_reduce(cols, active: torch.Tensor, acc_f: torch.Tensor,
                  acc_i: torch.Tensor,
                  acc_h: Optional[torch.Tensor] = None) -> None:
    """Launch ``csrc/masked_reduce.cu`` on CUDA tensors (same arguments as
    :func:`masked_reduce_plain`; ``acc_h`` may be None when no column is
    first or last).  Columns go in chunks of MR_MAX_COLS, one kernel per
    chunk."""
    n = active.shape[0]
    _check_column(active, n, (torch.bool,), "active")
    picks = any(op in ("first", "last") for _, _, op in cols)
    if picks and acc_h is None:
        raise ValueError("first/last need the accumulator's has words")
    for acc, dtype in ((acc_f, torch.float64), (acc_i, torch.int64),
                       (acc_h, torch.int64)):
        if acc is not None:
            _check_column(acc, len(cols), (dtype,), "accumulator")
    if n == 0:
        return  # nothing to reduce (the plain version returns too)
    lib = kernels.load("masked_reduce")
    stream = torch.cuda.current_stream(active.device).cuda_stream
    scratch = _mr_scratch(active.device, stream)
    for lo in range(0, len(cols), MR_MAX_COLS):
        chunk = cols[lo:lo + MR_MAX_COLS]
        data, valid, ops, is_f64 = [], [], [], []
        for d, v, op in chunk:
            if d is not None:
                _check_column(d, n, (torch.float64, torch.int64), "data")
            if v is not None:
                _check_column(v, n, (torch.bool,), "valid")
            data.append(None if d is None else d.data_ptr())
            valid.append(None if v is None else v.data_ptr())
            ops.append(_OPCODE[op])
            is_f64.append(int(d is not None and d.dtype == torch.float64))
        rc = lib.masked_reduce(
            active.data_ptr(), n, len(chunk), kernels.pointer_array(data),
            kernels.pointer_array(valid), kernels.int_array(ops),
            kernels.int_array(is_f64), scratch.data_ptr(), MR_MAX_BLOCKS,
            acc_f[lo:].data_ptr(), acc_i[lo:].data_ptr(),
            None if acc_h is None else acc_h[lo:].data_ptr(), stream)
        kernels.check_launch(lib, "masked_reduce", rc)
        masked_reduce.launches += 1
        if any(op in ("first", "last") for _, _, op in chunk):
            masked_reduce.ordered_launches += 1


masked_reduce.launches = 0
masked_reduce.ordered_launches = 0  # the launches that pick FIRST/LAST


# ---------------------------------------------------------------------------------
# Grid: k dictionary-coded keys -> G = prod(d_i + 1) slots
# ---------------------------------------------------------------------------------

def grid_size(dims: Sequence[int]) -> int:
    g = 1
    for d in dims:
        g *= d + 1
    return g


def grid_uses_shared(G: int, nf: int, ni: int) -> bool:
    """True when the kernel privatizes the grid in shared memory (two
    fixed-point words per float64 column, one per int64 column and the
    presence count, per slot)."""
    return G * (2 * nf + ni + 1) * 8 <= GRID_SHARED_BYTES


FX_FAST_LO = 52             # csrc/fixed128.cuh: |x| 2^s in [2^52, 2^93)
FX_FAST_HI = 92
FX_SCALE_TOP = 73           # s = 73 - ilogb(the first call's largest |x|)


def query_scale(largest: float) -> int:
    """The query scale s that ``csrc/fixed128.cuh`` ``fx_scale_word`` makes
    (and stores as s + 2^32) from a float64 channel's largest finite
    non-zero |x|."""
    return FX_SCALE_TOP - (math.frexp(largest)[1] - 1)


def in_query_range(x: float, scale: Optional[int]) -> bool:
    """Whether finite non-zero ``x`` adds exactly at ``scale`` (an integer
    below 2^93 there), as ``fx_in_range`` decides; None (no scale yet) and
    values 2^-21 below or 2^19 above the largest |x| take the fallback."""
    if scale is None or x == 0.0 or not math.isfinite(x):
        return False
    e = math.frexp(x)[1] - 1 + scale
    return FX_FAST_LO <= e <= FX_FAST_HI


class GridSums:
    """The float64 sum state of ``csrc/grid_agg.cu``, kept across calls:
    ``q`` [G, nf, 2] each cell's exact integer at its column's query
    scale, ``fb`` [G, nf, 3] the per-call fallback words (zero between
    calls) and ``words`` [2 nf + 3] (per column its first calls' largest
    |x| bits and its scale word, then two fallback flags and a ticket),
    all zero at the start."""

    def __init__(self, G: int, nf: int, device):
        i64 = dict(dtype=torch.int64, device=device)
        self.nf = nf
        self.q = torch.zeros((G, nf, 2), **i64)
        self.fb = torch.zeros((G, nf, 3), **i64)
        self.words = torch.zeros(2 * nf + 3, **i64)
        self.calls = 0

    def regrid(self, new_slot: torch.Tensor, G: int) -> None:
        """Each old slot's integers at its new slot (no two old slots share
        one); the scales stay."""
        q = torch.zeros((G,) + self.q.shape[1:], dtype=torch.int64,
                        device=self.q.device)
        q[new_slot] = self.q
        self.q = q
        self.fb = torch.zeros((G,) + self.fb.shape[1:], dtype=torch.int64,
                              device=self.fb.device)


class GridAccumulator:
    """The per-query device accumulator of the grid path.

    ``f`` [G, nf] float64 sums, ``i`` [G, ni] int64 sums and masked counts,
    ``cnt`` [G] live rows per slot; ``sums`` the kernel's float64 sum
    state (:class:`GridSums`), whose query-scale integers fold into ``f``
    when the output is read (:meth:`values`).  ``kinds`` gives, per
    contribution, where it lands, fixed before the first batch from the
    aggregates' nullability: "f" or "i" for a column of its own, "cnt" for
    a count of every live row, which the presence count already is."""

    def __init__(self, dims: Sequence[int], kinds: Sequence[str], device):
        self.dims = tuple(dims)
        G = grid_size(self.dims)
        self.where: List[Tuple[str, Optional[int]]] = []
        nf = ni = 0
        for kind in kinds:
            if kind == "f":
                self.where.append(("f", nf))
                nf += 1
            elif kind == "i":
                self.where.append(("i", ni))
                ni += 1
            elif kind == "cnt":
                self.where.append(("cnt", None))
            else:
                raise ValueError(f"unknown accumulator column kind {kind!r}")
        self.f = torch.zeros((G, nf), dtype=torch.float64, device=device)
        self.i = torch.zeros((G, ni), dtype=torch.int64, device=device)
        self.cnt = torch.zeros(G, dtype=torch.int64, device=device)
        self.sums = GridSums(G, nf, device)

    @property
    def G(self) -> int:
        return self.cnt.shape[0]

    def route(self, contributions, n: int):
        """This batch's (f columns, i columns) in accumulator order, each a
        list of (data, valid)."""
        f_cols: List[Value] = [None] * self.f.shape[1]
        i_cols: List[Value] = [None] * self.i.shape[1]
        for c, (((d, v), op), (kind, j)) in enumerate(zip(contributions,
                                                           self.where)):
            if op != "sum":
                raise ValueError(f"the grid path only sums, not {op}")
            if kind == "cnt":
                if d is not None or v is not None:
                    raise ValueError(
                        f"contribution {c} is laid out as the presence count "
                        f"but brings a column or a validity mask")
                continue
            (f_cols if kind == "f" else i_cols)[j] = (_column(d, n),
                                                      _column(v, n))
        return f_cols, i_cols

    def regrid(self, dims: Sequence[int]) -> None:
        """Re-lay the accumulator onto larger dims (a dictionary grew past
        its padded size): each old slot's codes, NULL slots included, map
        to their new slot; the float64 sums' integers and scales move
        along."""
        dims = tuple(dims)
        old_slot = torch.arange(self.G, device=self.cnt.device)
        new_slot = torch.zeros_like(old_slot)
        mult_old = mult_new = 1
        for d_old, d_new in zip(reversed(self.dims), reversed(dims)):
            code = (old_slot // mult_old) % (d_old + 1)
            code = torch.where(code == d_old, d_new, code)  # the NULL slot
            new_slot += code * mult_new
            mult_old *= d_old + 1
            mult_new *= d_new + 1
        G = grid_size(dims)

        def move(t):
            out = torch.zeros((G,) + t.shape[1:], dtype=t.dtype,
                              device=t.device)
            return out.index_add_(0, new_slot, t)

        self.f, self.i, self.cnt = move(self.f), move(self.i), move(self.cnt)
        self.sums.regrid(new_slot, G)
        self.dims = dims

    def slot_codes(self) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """Per key, the (code, valid) of every slot, decoded arithmetically
        from the slot number."""
        slot = torch.arange(self.G, device=self.cnt.device)
        out = []
        mult = self.G
        for d in self.dims:
            mult //= d + 1
            code = (slot // mult) % (d + 1)
            out.append((torch.where(code == d, 0, code).to(torch.int32),
                        code != d))
        return out

    def fold(self) -> None:
        """The kernel's query-scale integers into ``f`` (a float64 sum is
        whole after this; the plain version adds into ``f`` directly)."""
        if self.f.is_cuda and self.sums.calls and self.f.shape[1]:
            grid_agg_fold(self.sums, self.f)

    def values(self) -> List[torch.Tensor]:
        """Per contribution, its [G] accumulated sums."""
        self.fold()
        out = []
        for kind, j in self.where:
            out.append(self.cnt if kind == "cnt"
                       else (self.f if kind == "f" else self.i)[:, j])
        return out


def grid_group_reduce(code_keys: List[Value], dims: Sequence[int],
                      contributions: List[Tuple[Value, str]],
                      active: torch.Tensor, acc: GridAccumulator) -> None:
    """Adds one batch into a grid accumulator (in place): per-slot sums of
    every contribution and the live-row count."""
    n = active.shape[0]
    if tuple(dims) != acc.dims:
        raise ValueError(f"dims {tuple(dims)} differ from the accumulator's "
                         f"{acc.dims}; regrid first")
    keys = [(_column(c, n), _column(v, n)) for c, v in code_keys]
    f_cols, i_cols = acc.route(contributions, n)
    if active.is_cuda:
        grid_agg(keys, acc.dims, f_cols, i_cols, active, acc.f, acc.i,
                 acc.cnt, acc.sums)
    else:
        grid_agg_plain(keys, acc.dims, f_cols, i_cols, active, acc.f, acc.i,
                       acc.cnt)


def _grid_ids(keys, dims, n, device) -> torch.Tensor:
    gid = torch.zeros(n, dtype=torch.int64, device=device)
    for (codes, valid), d in zip(keys, dims):
        slot = codes.to(torch.int64)
        if valid is not None:
            slot = torch.where(valid, slot, d)
        gid = gid * (d + 1) + slot
    return gid


def grid_agg_plain(keys, dims, f_cols, i_cols, active, acc_f, acc_i,
                   acc_cnt) -> None:
    """Plain PyTorch version of ``csrc/grid_agg.cu``: index_add_ of the
    masked contributions into G slots (inactive rows park in slot G)."""
    n = active.shape[0]
    G = acc_cnt.shape[0]
    gid = torch.where(active, _grid_ids(keys, dims, n, active.device), G)
    for acc, cols, zero in ((acc_f, f_cols, 0.0), (acc_i, i_cols, 0)):
        for j, (d, v) in enumerate(cols):
            if d is None:
                d = torch.ones(n, dtype=torch.int64, device=active.device)
            if v is not None:
                d = torch.where(v, d, zero)
            part = torch.zeros(G + 1, dtype=acc.dtype, device=active.device)
            acc[:, j] += part.index_add_(0, gid, d)[:G]
    part = torch.zeros(G + 1, dtype=torch.int64, device=active.device)
    acc_cnt += part.index_add_(0, gid, torch.ones_like(gid))[:G]


def grid_agg(keys, dims, f_cols, i_cols, active, acc_f, acc_i,
             acc_cnt, sums: GridSums) -> None:
    """Launch ``csrc/grid_agg.cu`` on CUDA tensors (the arguments of
    :func:`grid_agg_plain`, and ``sums``, the float64 sums' state kept
    across calls, whose integers :func:`grid_agg_fold` turns into
    ``acc_f`` when the output is read)."""
    n = active.shape[0]
    G = acc_cnt.shape[0]
    nf, ni = len(f_cols), len(i_cols)
    if not 1 <= len(keys) <= GA_MAX_KEYS or nf > GA_MAX_COLS \
            or ni > GA_MAX_COLS:
        raise ValueError(f"grid_agg takes 1..{GA_MAX_KEYS} keys and at most "
                         f"{GA_MAX_COLS} float64 and {GA_MAX_COLS} int64 "
                         f"columns, got {len(keys)}, {nf}, {ni}")
    if G != grid_size(dims) or acc_f.shape != (G, nf) \
            or acc_i.shape != (G, ni) or sums.q.shape != (G, nf, 2) \
            or sums.fb.shape != (G, nf, 3):
        raise ValueError("accumulator shapes do not match the grid")
    for acc in (acc_f, acc_i, acc_cnt, sums.q, sums.fb, sums.words):
        if not acc.is_contiguous() or not acc.is_cuda:
            raise ValueError("accumulators must be contiguous CUDA tensors")
    _check_column(active, n, (torch.bool,), "active")
    codes, code_valid = [], []
    for c, v in keys:
        _check_column(c, n, (torch.int32,), "key codes")
        codes.append(c.data_ptr())
        if v is not None:
            _check_column(v, n, (torch.bool,), "key valid")
        code_valid.append(None if v is None else v.data_ptr())

    def ptrs(cols, dtype):
        data, valid = [], []
        for d, v in cols:
            if d is not None:
                _check_column(d, n, (dtype,), "data")
            if v is not None:
                _check_column(v, n, (torch.bool,), "valid")
            data.append(None if d is None else d.data_ptr())
            valid.append(None if v is None else v.data_ptr())
        return kernels.pointer_array(data), kernels.pointer_array(valid)

    f_data, f_valid = ptrs(f_cols, torch.float64)
    i_data, i_valid = ptrs(i_cols, torch.int64)
    if n == 0:
        return
    sums.calls += 1
    lib = kernels.load("grid_agg")
    stream = torch.cuda.current_stream(active.device).cuda_stream
    rc = lib.grid_agg(
        kernels.pointer_array(codes), kernels.pointer_array(code_valid),
        kernels.int_array(list(dims)), len(keys), active.data_ptr(), n,
        f_data, f_valid, nf, i_data, i_valid, ni, acc_f.data_ptr(),
        acc_i.data_ptr(), acc_cnt.data_ptr(), sums.q.data_ptr(),
        sums.fb.data_ptr(), sums.words.data_ptr(), sums.calls, G,
        int(grid_uses_shared(G, nf, ni)), stream)
    kernels.check_launch(lib, "grid_agg", rc)
    grid_agg.launches += 1


grid_agg.launches = 0


def grid_agg_fold(sums: GridSums, acc_f: torch.Tensor) -> None:
    """Launch ``grid_agg_fold`` of ``csrc/grid_agg.cu``: every cell's
    query-scale integer into ``acc_f`` [G, nf], cleared."""
    lib = kernels.load("grid_agg")
    rc = lib.grid_agg_fold(
        sums.q.data_ptr(), acc_f.data_ptr(), sums.words.data_ptr(), sums.nf,
        acc_f.numel(), torch.cuda.current_stream(acc_f.device).cuda_stream)
    kernels.check_launch(lib, "grid_agg_fold", rc)
    grid_agg_fold.launches += 1


grid_agg_fold.launches = 0


# ---------------------------------------------------------------------------------
# Dense direct-address aggregation: a primary integral key over [kmin, kmin+D)
# plus residual keys that depend on it
# ---------------------------------------------------------------------------------

DA_MAX_KEYS = 8             # csrc/dense_agg.cu DA_MAX_KEYS
DA_MAX_CH = 16              # csrc/dense_agg.cu DA_MAX_CH
DA_SAMPLE = 1 << 18         # rows of the first batch the dependence probe sees
DA_TABLE = 1 << 19          # slots of its table per candidate
OVERFLOW_ROWS = 1 << 20     # rows outside the first domain the buffer holds
_DA_OP = {"sum": 0, "min": 1, "max": 2}
_KEY_TYPES = (torch.int32, torch.int64)


def _opt_ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def dense_key_stats(keys: Sequence[Value], cand: Sequence[bool],
                    active: Optional[torch.Tensor]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dense aggregation's stats over one batch, still on the device:
    (int64 [k, 3] min, max and count of each key's live valid values;
    int32 [k] per primary candidate, 1 when one of its values maps to two
    different key tuples, validity included, among the live rows of the
    first DA_SAMPLE rows).  ``keys`` are int32/int64 (data, valid)."""
    n = keys[0][0].shape[0]
    keys = [(_column(d, n), _column(v, n)) for d, v in keys]
    run = dense_agg_stats if keys[0][0].is_cuda else dense_agg_stats_plain
    return run(keys, cand, active)


def dense_agg_stats_plain(keys, cand, active):
    """Plain PyTorch version of ``dense_agg_stats``."""
    dev = keys[0][0].device
    n = keys[0][0].shape[0]
    stats = torch.tensor([[_I64_MAX, _I64_MIN, 0]] * len(keys),
                         dtype=torch.int64, device=dev)
    for c, (d, v) in enumerate(keys):
        x = d.to(torch.int64)[live_mask(n, v, active, dev)]
        if x.numel():
            stats[c] = torch.stack([x.min(), x.max(),
                                    torch.tensor(x.numel(), device=dev)])
    fd = torch.zeros(len(keys), dtype=torch.int32, device=dev)
    m = min(n, DA_SAMPLE)
    rows = torch.arange(m, device=dev)
    if active is not None:
        rows = rows[active[:m]]

    def tuple_ids(idx):
        """Per sampled row, the id of its (valid, value) tuple over the
        keys ``idx``."""
        cols = []
        for c in idx:
            d, v = keys[c]
            val = d[rows].to(torch.int64)
            ok = torch.ones_like(val, dtype=torch.bool) if v is None \
                else v[rows]
            cols += [ok.to(torch.int64), torch.where(ok, val, 0)]
        return torch.unique(torch.stack(cols, 1), dim=0,
                            return_inverse=True)[1]

    if rows.numel():
        every = tuple_ids(range(len(keys)))
        for c, is_cand in enumerate(cand):
            if not is_cand:
                continue
            own = tuple_ids([c])
            n_own = int(own.max()) + 1
            # two tuples under one candidate value: the candidate's distinct
            # count falls short of the full key's
            pairs = torch.unique(torch.stack([own, every], 1), dim=0)
            fd[c] = int(pairs.shape[0] > n_own)
    return stats, fd


def dense_agg_stats(keys, cand, active):
    """Launch ``dense_agg_stats`` of ``csrc/dense_agg.cu``."""
    n = keys[0][0].shape[0]
    if not 1 <= len(keys) <= DA_MAX_KEYS:
        raise ValueError(f"dense_agg_stats takes 1..{DA_MAX_KEYS} keys, got "
                         f"{len(keys)}")
    dev = keys[0][0].device
    if active is not None:
        _check_column(active, n, (torch.bool,), "active")
    for d, v in keys:
        _check_column(d, n, _KEY_TYPES, "group key")
        if v is not None:
            _check_column(v, n, (torch.bool,), "group key valid")
    stats = upload(torch.tensor([[_I64_MAX, _I64_MIN, 0]] * len(keys),
                                dtype=torch.int64), dev)
    fd = torch.zeros(len(keys), dtype=torch.int32, device=dev)
    tables = torch.full((max(sum(map(bool, cand)), 1) * DA_TABLE,), -1,
                        dtype=torch.int32, device=dev)
    lib = kernels.load("dense_agg")
    rc = lib.dense_agg_stats(
        len(keys), kernels.pointer_array([d.data_ptr() for d, _ in keys]),
        kernels.pointer_array([_opt_ptr(v) for _, v in keys]),
        kernels.int_array([d.element_size() for d, _ in keys]),
        kernels.int_array([int(bool(c)) for c in cand]), _opt_ptr(active), n,
        stats.data_ptr(), tables.data_ptr(), fd.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    kernels.check_launch(lib, "dense_agg_stats", rc)
    dense_agg_stats.launches += 1
    return stats, fd


dense_agg_stats.launches = 0


DA_EMPTY = _I64_MIN         # csrc/dense_agg.cu DA_EMPTY: an unclaimed value
DA_NO_SCALE = _I64_MIN      # csrc/dense_agg.cu DA_NO_SCALE
_DA_CONFLICT_BIT = 62       # csrc/dense_agg.cu DA_CONFLICT


def _null_bit(i: int) -> int:
    return 3 * i


def _seen_empty_bit(i: int) -> int:
    return 3 * i + 1


def _negz_bit(i: int) -> int:
    return 3 * i + 2


def dense_layout(nres: int, channels: Sequence[Tuple[str, bool]]
                 ) -> Tuple[int, int, List[int], List[int], List[int]]:
    """The dense aggregation's per-slot record (csrc/dense_agg.cu, "The
    record"): (R words a record, the state word, each residual's value
    word, each channel's word, each float64 channel's query-scale pair).
    First the state word (with residuals), the residual value words and
    one word per int64 channel; then, at an even word, a pair [low, high]
    per float64 sum (its 128-bit integer at the query's scale); then, on
    32-byte sectors, a sector [low, high, largest |x|, float64 word] per
    float64 sum (the channel's word: the per-call fallback and the float64
    part of the sum).  R is 1 or 2 words when that is all, else a multiple
    of 4, so records start on sectors."""
    state = 0 if nres else -1
    w = 1 if nres else 0
    res_off = list(range(w, w + nres))
    w += nres
    ch_off, ch_q = [0] * len(channels), [-1] * len(channels)
    for j, (_, is_f64) in enumerate(channels):
        if not is_f64:
            ch_off[j], w = w, w + 1
    f64 = [j for j, (_, is_f64) in enumerate(channels) if is_f64]
    if not f64:
        return (max(w, 1) if w <= 2 else -(-w // 4) * 4), state, res_off, \
            ch_off, ch_q
    w += w % 2
    for j in f64:
        ch_q[j], w = w, w + 2
    w = -(-w // 4) * 4
    for j in f64:
        ch_off[j], w = w, w + 4
    return w, state, res_off, ch_off, ch_q


class DenseAccumulator:
    """The per-query device state of the dense aggregation.

    Slots [0, D) hold keys kmin..kmin+D-1; slot D holds the null key.
    ``rec`` holds one record of ``R`` int64 words a slot
    (:func:`dense_layout`): each channel's accumulator (float64 sums, or
    int64 sum/min/max; a channel whose contribution has no data counts
    rows), the residual keys' claimed value words (``DA_EMPTY`` until a
    valid row claims one; a float64 residual claims its bits, -0.0 as
    +0.0) and a state word of per-residual NULL, SEEN_EMPTY and NEGZ bits
    and a CONFLICT bit, which prove that each residual depends on the
    primary.  ``present`` marks observed slots.  Rows whose key falls
    outside the domain go to the overflow buffer (``cap`` rows), which
    :meth:`widen` folds in."""

    def __init__(self, kmin: int, D: int, nres: int,
                 channels: Sequence[Tuple[str, bool]], device,
                 cap: int = OVERFLOW_ROWS,
                 res_f64: Optional[Sequence[bool]] = None):
        self.res_f64 = [False] * nres if res_f64 is None \
            else [bool(f) for f in res_f64]
        if len(self.res_f64) != nres:
            raise ValueError("res_f64 needs one flag per residual")
        if nres > DA_MAX_KEYS - 1 or len(channels) > DA_MAX_CH:
            raise ValueError(f"the dense aggregation takes at most "
                             f"{DA_MAX_KEYS - 1} residual keys and "
                             f"{DA_MAX_CH} channels")
        for op, is_f64 in channels:
            if is_f64 and op != "sum":
                raise ValueError(f"float64 {op} has no dense channel")
        self.kmin, self.D = int(kmin), int(D)
        self.channels = list(channels)
        self.nres = nres
        self.device = device
        self.cap = int(cap)
        self.R, self.state_off, self.res_off, self.ch_off, self.ch_q = \
            dense_layout(nres, self.channels)
        self._alloc(self.D)
        nch = len(self.channels)
        i64 = dict(dtype=torch.int64, device=device)
        nf = sum(f for _, f in self.channels)
        # per float64 channel: the largest |x| of the first call with one,
        # then the query scale (``DA_NO_SCALE`` until that call)
        self.fwords = upload(torch.tensor([0] * nf + [DA_NO_SCALE] * nf,
                                          dtype=torch.int64), device)
        # the kernel's per-call lists, made at the first launch
        # (``dense_agg_update``)
        self.work = None
        self.ocount = torch.zeros(1, **i64)
        self.obounds = upload(torch.tensor([_I64_MAX, _I64_MIN],
                                           dtype=torch.int64), device)
        self.okey = torch.empty(self.cap, **i64)
        self.ores = torch.empty((nres, self.cap), **i64)
        self.ores_valid = torch.empty((nres, self.cap), dtype=torch.bool,
                                      device=device)
        self.och = torch.empty((nch, self.cap), **i64)
        self.och_valid = torch.empty((nch, self.cap), dtype=torch.bool,
                                     device=device)

    @property
    def S(self) -> int:
        return self.D + 1

    def _alloc(self, D: int) -> None:
        empty = torch.zeros(self.R, dtype=torch.int64)
        for (op, is_f64), off in zip(self.channels, self.ch_off):
            if not is_f64:
                empty[off] = {"sum": 0, "count": 0, "min": _I64_MAX,
                              "max": _I64_MIN}[op]
        empty[self.res_off] = DA_EMPTY
        self.rec = upload(empty, self.device).expand(D + 1, self.R) \
            .contiguous()
        self.present = torch.zeros(D + 1, dtype=torch.uint8,
                                   device=self.device)

    @property
    def acc(self) -> List[torch.Tensor]:
        """Channel j's value in every slot (a float64 sum is whole after
        :meth:`check`, which folds its query-scale pair into its word)."""
        return self.channel_values(self.rec)

    def channel_values(self, rows: torch.Tensor) -> List[torch.Tensor]:
        """Each channel's values in the records ``rows`` ([m, R])."""
        return [rows[:, off + 3].view(torch.float64) if is_f64
                else rows[:, off]
                for off, (_, is_f64) in zip(self.ch_off, self.channels)]

    def update(self, key: Value, residuals: Sequence[Value],
               contributions: Sequence[Value],
               active: Optional[torch.Tensor]) -> None:
        """Adds one batch (in place).  ``contributions`` follow
        ``channels``; ``data=None`` counts rows where ``valid`` holds."""
        n = key[0].shape[0]
        key = (_column(key[0], n), _column(key[1], n))
        residuals = [(_column(d, n), _column(v, n)) for d, v in residuals]
        contributions = [(_column(d, n), _column(v, n))
                         for d, v in contributions]
        run = dense_agg_update if key[0].is_cuda else dense_agg_update_plain
        run(self, key, residuals, contributions, active)

    def check(self) -> torch.Tensor:
        """int64 [2] device tensor: (1 if a residual does not depend on the
        primary, else 0; the number of observed slots).  Also folds each
        float64 sum's query-scale pair into its float64 word."""
        run = dense_agg_check if self.present.is_cuda \
            else dense_agg_check_plain
        return run(self)

    def tail(self) -> torch.Tensor:
        """int64 [5] device tensor for the query's tail fetch: violation,
        n_groups, overflow rows, overflow key min and max."""
        return torch.cat([self.check(), self.ocount, self.obounds])

    def widen(self, kmin: int, D: int) -> None:
        """Re-lay the records onto [kmin, kmin + D), which contains the old
        domain: old slots land at their keys' new slots, the null slot
        stays last."""
        off = self.kmin - kmin
        if off < 0 or off + self.D > D:
            raise ValueError("the new domain must contain the old one")
        rec, present, oD = self.rec, self.present, self.D
        self._alloc(D)
        for new, old in ((self.rec, rec), (self.present, present)):
            new[off:off + oD] = old[:oD]
            new[D] = old[oD]
        self.kmin, self.D = int(kmin), int(D)

    def replay_overflow(self, count: int) -> None:
        """Adds the ``count`` buffered overflow rows (all in the widened
        domain) and empties the buffer."""
        if count > self.cap:
            raise ValueError(f"{count} overflow rows exceed the buffer's "
                             f"{self.cap}")
        rows = [(self.okey[:count].clone(), None),
                [((self.ores[i, :count].view(torch.float64)
                   if self.res_f64[i] else self.ores[i, :count]).clone(),
                  self.ores_valid[i, :count].clone())
                 for i in range(self.nres)],
                [(None if op == "count" else
                  (self.och[j, :count].view(torch.float64) if is_f64
                   else self.och[j, :count]).clone(),
                  self.och_valid[j, :count].clone())
                 for j, (op, is_f64) in enumerate(self.channels)]]
        self.ocount.zero_()
        self.obounds[0] = _I64_MAX
        self.obounds[1] = _I64_MIN
        self.update(rows[0], rows[1], rows[2], None)

    def slot_keys(self, slots: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(int64 key of every slot, or of ``slots``; its validity: False
        for the null slot)."""
        if slots is None:
            slots = torch.arange(self.S, dtype=torch.int64,
                                 device=self.device)
        return slots + self.kmin, slots < self.D

    def residual(self, i: int, rows: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(residual i's value in every slot, or in the records ``rows``:
        int64, or float64 with -0.0 where a -0.0 was seen; its validity)."""
        rows = self.rec if rows is None else rows
        word = rows[:, self.res_off[i]].contiguous()
        state = rows[:, self.state_off]
        valid = (word != DA_EMPTY) | (
            (state >> _seen_empty_bit(i)) & 1).bool()
        if not self.res_f64[i]:
            return word, valid
        value = word.view(torch.float64)
        negz = ((state >> _negz_bit(i)) & 1).bool()
        return torch.where(negz, torch.full_like(value, -0.0), value), valid

    def live_slots(self, n_groups: int) -> torch.Tensor:
        """int64 [n_groups]: the observed slots in slot order (one compact
        of the slot numbers under ``present``)."""
        from .batch_utils import compact_columns
        slots = torch.arange(self.S, dtype=torch.int64, device=self.device)
        return compact_columns([(slots, None)], self.present.bool(),
                               n_groups)[0][0]


def dense_agg_update_plain(acc: DenseAccumulator, key, residuals,
                           contributions, active) -> None:
    """Plain PyTorch version of ``dense_agg_update``: the same records,
    float64 sums added directly (the kernel's fixed-point words stay zero
    between calls), a residual word claimed by its slot's first valid row
    (the kernel's by whichever row gets there first: they differ only
    where CONFLICT is set); overflow rows land in row order (the kernel's
    atomic cursor gives no fixed order)."""
    d, v = key
    n, dev = d.shape[0], d.device
    live = torch.ones(n, dtype=torch.bool, device=dev) if active is None \
        else active
    kv = torch.ones_like(live) if v is None else v
    k64 = d.to(torch.int64)
    in_dom = live & kv & (k64 >= acc.kmin) & (k64 - acc.kmin < acc.D)
    out = live & kv & ~in_dom
    rows = in_dom | (live & ~kv)
    slot = torch.where(in_dom, k64 - acc.kmin, acc.D)
    acc.present[slot[rows]] = 1
    rec, S = acc.rec, acc.S
    for j, ((cd, cv), (op, is_f64)) in enumerate(zip(contributions,
                                                     acc.channels)):
        m = rows if cv is None else rows & cv
        x = torch.ones(n, dtype=torch.int64, device=dev) if cd is None \
            else cd
        word = acc.ch_off[j] + (3 if is_f64 else 0)
        col = rec[:, word].clone()
        if is_f64:
            col = col.view(torch.float64)
        if op in ("sum", "count"):
            col.index_add_(0, slot[m], x[m].to(col.dtype))
        else:
            col.scatter_reduce_(0, slot[m], x[m],
                                "amin" if op == "min" else "amax")
        rec[:, word] = col.view(torch.int64)
    if acc.nres:
        state = rec[:, acc.state_off].clone()

        def mark(bit: int, slots: torch.Tensor) -> None:
            flag = torch.zeros(S, dtype=torch.int64, device=dev)
            flag[slots] = 1
            state.bitwise_or_(flag << bit)

        for i, (rd, rv) in enumerate(residuals):
            ok = rows if rv is None else rows & rv
            if rv is not None:
                mark(_null_bit(i), slot[rows & ~rv])
            if acc.res_f64[i]:
                nan, zero = torch.isnan(rd), rd == 0
                bits = rd.contiguous().view(torch.int64)
                val = torch.where(zero, 0, bits)
                mark(_DA_CONFLICT_BIT, slot[ok & nan])
                mark(_negz_bit(i), slot[ok & zero & (bits < 0)])
                ok = ok & ~nan
            else:
                val = rd.to(torch.int64)
            mark(_seen_empty_bit(i), slot[ok & (val == DA_EMPTY)])
            idx = (ok & (val != DA_EMPTY)).nonzero().squeeze(1)
            word = rec[:, acc.res_off[i]].clone()
            if idx.numel():
                s, x = slot[idx], val[idx]
                first = torch.full((S,), n, dtype=torch.int64, device=dev)
                first.scatter_reduce_(0, s, idx, "amin")
                claim = (word == DA_EMPTY) & (first < n)
                word[claim] = val[first[claim]]
                mark(_DA_CONFLICT_BIT, s[x != word[s]])
            rec[:, acc.res_off[i]] = word
        rec[:, acc.state_off] = state
    o = out.nonzero().squeeze(1)
    if o.numel() == 0:
        return
    ko = k64[o]
    acc.obounds[0] = torch.minimum(acc.obounds[0], ko.min())
    acc.obounds[1] = torch.maximum(acc.obounds[1], ko.max())
    base = int(acc.ocount[0])
    acc.ocount += o.numel()
    take = max(0, min(o.numel(), acc.cap - base))
    o, dst = o[:take], slice(base, base + take)
    acc.okey[dst] = k64[o]
    for i, (rd, rv) in enumerate(residuals):
        acc.ores[i, dst] = (rd.view(torch.int64) if acc.res_f64[i]
                            else rd.to(torch.int64))[o]
        acc.ores_valid[i, dst] = True if rv is None else rv[o]
    for j, (cd, cv) in enumerate(contributions):
        acc.och_valid[j, dst] = True if cv is None else cv[o]
        if cd is not None:
            bits = cd.view(torch.int64) if cd.dtype == torch.float64 \
                else cd.to(torch.int64)
            acc.och[j, dst] = bits[o]


def dense_agg_update(acc: DenseAccumulator, key, residuals, contributions,
                     active) -> None:
    """Launch ``dense_agg_update`` of ``csrc/dense_agg.cu``."""
    d, v = key
    n = d.shape[0]
    _check_column(d, n, _KEY_TYPES, "group key")
    if v is not None:
        _check_column(v, n, (torch.bool,), "group key valid")
    if active is not None:
        _check_column(active, n, (torch.bool,), "active")
    if len(residuals) != acc.nres or len(contributions) != len(acc.channels):
        raise ValueError("residuals/contributions do not match the "
                         "accumulator's layout")
    res, res_valid, res_elem = [], [], []
    for (rd, rv), f64 in zip(residuals, acc.res_f64):
        _check_column(rd, n, (torch.float64,) if f64 else _KEY_TYPES,
                      "residual key")
        if rv is not None:
            _check_column(rv, n, (torch.bool,), "residual valid")
        res.append(rd.data_ptr())
        res_valid.append(_opt_ptr(rv))
        res_elem.append(rd.element_size())
    ch, ch_valid, ch_op, ch_f64 = [], [], [], []
    for (cd, cv), (op, is_f64) in zip(contributions, acc.channels):
        if cd is not None:
            _check_column(cd, n, (torch.float64 if is_f64 else torch.int64,),
                          "contribution")
        elif op != "count":
            raise ValueError(f"a {op} channel needs data")
        if cv is not None:
            _check_column(cv, n, (torch.bool,), "contribution valid")
        ch.append(_opt_ptr(cd))
        ch_valid.append(_opt_ptr(cv))
        ch_op.append(_DA_OP["sum" if op == "count" else op])
        ch_f64.append(int(is_f64))
    for t in (acc.rec, acc.present, acc.okey):
        if not t.is_cuda or not t.is_contiguous():
            raise ValueError("accumulators must be contiguous CUDA tensors")
    if n == 0:
        return  # no rows (and no data pointers): no launch
    nf = sum(ch_f64)
    if nf and (acc.work is None or acc.work.numel() < 2 + 2 * n * nf):
        # two counts, then the fallback and the touched lists: at most one
        # entry per live row and float64 channel each
        acc.work = torch.empty(2 + 2 * n * nf, dtype=torch.int64,
                               device=d.device)
    P, I = kernels.pointer_array, kernels.int_array
    nres = acc.nres
    lib = kernels.load("dense_agg")
    rc = lib.dense_agg_update(
        d.data_ptr(), _opt_ptr(v), d.element_size(), nres, P(res),
        P(res_valid), I(res_elem), I([int(f) for f in acc.res_f64]),
        I(acc.res_off), len(ch), P(ch), P(ch_valid), I(ch_op), I(ch_f64),
        I(acc.ch_off), I(acc.ch_q), _opt_ptr(active), n, acc.kmin, acc.D,
        acc.rec.data_ptr(), acc.R, acc.state_off, acc.present.data_ptr(),
        acc.cap, acc.ocount.data_ptr(), acc.obounds.data_ptr(),
        acc.okey.data_ptr(), P([acc.ores[i].data_ptr() for i in range(nres)]),
        P([acc.ores_valid[i].data_ptr() for i in range(nres)]),
        P([None if op == "count" else acc.och[j].data_ptr()
           for j, (op, _) in enumerate(acc.channels)]),
        P([acc.och_valid[j].data_ptr() for j in range(len(acc.channels))]),
        acc.fwords.data_ptr() if nf else None,
        _opt_ptr(acc.work) if nf else None,
        torch.cuda.current_stream(d.device).cuda_stream)
    kernels.check_launch(lib, "dense_agg_update", rc)
    dense_agg_update.launches += 1


dense_agg_update.launches = 0


def _dense_violations(acc: DenseAccumulator, rows: torch.Tensor
                      ) -> torch.Tensor:
    """bool [m]: records of ``rows`` whose residual proof failed."""
    bad = torch.zeros(rows.shape[0], dtype=torch.bool, device=rows.device)
    if not acc.nres:
        return bad
    state = rows[:, acc.state_off]
    bad |= ((state >> _DA_CONFLICT_BIT) & 1).bool()
    for i in range(acc.nres):
        seen = ((state >> _seen_empty_bit(i)) & 1).bool()
        claimed = rows[:, acc.res_off[i]] != DA_EMPTY
        null = ((state >> _null_bit(i)) & 1).bool()
        bad |= (seen & claimed) | ((seen | claimed) & null)
    return bad


def _fold_query_scale(acc: DenseAccumulator) -> None:
    """Each float64 channel's query-scale pair, converted back as
    ``fx_to_double`` does, added to its float64 word where it is not zero,
    and cleared (the plain update keeps its pairs at zero)."""
    f64 = [j for j, (_, f) in enumerate(acc.channels) if f]
    for q, j in enumerate(f64):
        scale = int(acc.fwords[len(f64) + q])
        lo, hi = acc.rec[:, acc.ch_q[j]], acc.rec[:, acc.ch_q[j] + 1]
        nz = (lo != 0) | (hi != 0)
        if scale == DA_NO_SCALE or not bool(nz.any()):
            continue
        neg = hi < 0
        nlo = ~lo + 1
        lo, hi = torch.where(neg, nlo, lo), torch.where(
            neg, ~hi + (nlo == 0).to(torch.int64), hi)
        # lo as unsigned, rounded once: its two 32-bit halves are exact
        lo_u = ((lo >> 32) & 0xFFFFFFFF).double() * 2.0 ** 32 \
            + (lo & 0xFFFFFFFF).double()
        mag = hi.double() * 2.0 ** 64 + lo_u
        half = scale // 2
        val = torch.where(neg, -mag, mag) * 2.0 ** -half \
            * 2.0 ** -(scale - half)
        word = acc.rec[:, acc.ch_off[j] + 3].view(torch.float64)
        acc.rec[:, acc.ch_off[j] + 3] = torch.where(
            nz, word + val, word).view(torch.int64)
        acc.rec[:, acc.ch_q[j]:acc.ch_q[j] + 2] = 0


def dense_agg_check_plain(acc: DenseAccumulator) -> torch.Tensor:
    """Plain PyTorch version of ``dense_agg_check``."""
    _fold_query_scale(acc)
    present = acc.present.bool()
    bad = _dense_violations(acc, acc.rec)
    return torch.stack([(present & bad).any().to(torch.int64),
                        present.sum()])


def dense_agg_check(acc: DenseAccumulator) -> torch.Tensor:
    """Launch ``dense_agg_check`` of ``csrc/dense_agg.cu``."""
    out = torch.zeros(2, dtype=torch.int64, device=acc.device)
    f64 = [j for j, (_, f) in enumerate(acc.channels) if f]
    I = kernels.int_array
    lib = kernels.load("dense_agg")
    rc = lib.dense_agg_check(
        acc.nres, I(acc.res_off), acc.rec.data_ptr(), acc.R, acc.state_off,
        acc.present.data_ptr(), acc.S, len(f64),
        I([acc.ch_q[j] for j in f64]), I([acc.ch_off[j] + 3 for j in f64]),
        acc.fwords.data_ptr() if f64 else None, out.data_ptr(),
        torch.cuda.current_stream(acc.device).cuda_stream)
    kernels.check_launch(lib, "dense_agg_check", rc)
    dense_agg_check.launches += 1
    return out


dense_agg_check.launches = 0


# ---------------------------------------------------------------------------------
# Hash aggregation: any key tuple, one open-addressing table for the stream
# ---------------------------------------------------------------------------------

HA_MAX_KEYS = 8             # csrc/hash_agg.cu HA_MAX_KEYS
HA_MAX_CH = 32              # csrc/hash_agg.cu HA_MAX_CH
HA_LOAD = 0.5               # groups per slot the table is allowed
HA_MIN_SLOTS = 1024
HA_COMPACT_SLOTS = 1 << 20  # larger tables are compacted after a count fetch
_HA_OP = {"sum": 0, "min": 1, "max": 2, "count": 3, "first": 4, "last": 5}
_F64_SIGNLESS = 0x7FFFFFFFFFFFFFFF


def f64_image(x: torch.Tensor, nan_image: int) -> torch.Tensor:
    """int64 image of float64 values, monotonic with -0.0 below +0.0, NaN
    mapped to ``nan_image``: the accumulator form of a float64 min/max
    channel (csrc/hash_agg.cu ``f64_image``)."""
    b = x.view(torch.int64)
    img = torch.where(b >= 0, b, b ^ _F64_SIGNLESS)
    return torch.where(torch.isnan(x), nan_image, img)


def f64_from_image(img: torch.Tensor) -> torch.Tensor:
    """float64 values of :func:`f64_image` images; either NaN image gives
    NaN."""
    b = torch.where(img >= 0, img, img ^ _F64_SIGNLESS)
    out = b.view(torch.float64)
    nan = (img == _I64_MIN) | (img == _I64_MAX)
    return torch.where(nan, float("nan"), out)


def key_word(data: torch.Tensor) -> torch.Tensor:
    """int64 word of a group key column: integers, dates, booleans and
    dictionary codes as they are, floats as ``topk.sortable_view`` images
    (-0.0 and +0.0 one group, every NaN one group)."""
    from .topk import sortable_view
    return sortable_view(data).to(torch.int64).contiguous()


def key_from_word(word: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`key_word` into ``dtype`` (NaN comes back as the
    canonical NaN, -0.0 as +0.0)."""
    if dtype in (torch.float64, torch.float32):
        ibits, imin, imax = ((torch.int64, _I64_MIN, _I64_MAX)
                             if dtype == torch.float64 else
                             (torch.int32, torch.iinfo(torch.int32).min,
                              torch.iinfo(torch.int32).max))
        bits = torch.where(word >= 0, word, imin - word).to(ibits)
        out = bits.view(dtype)
        return torch.where(word == imax, float("nan"), out)
    return word.to(dtype)


def _ha_init(op: str, is_f64: bool) -> float:
    if op in ORDERED_OPS:
        return 0
    if is_f64:
        if op in ("min", "max"):
            edge = float("inf") if op == "min" else float("-inf")
            return int(f64_image(torch.tensor([edge], dtype=torch.float64),
                                 0)[0])
        return 0.0
    return {"sum": 0, "count": 0, "min": _I64_MAX, "max": _I64_MIN}[op]


def record_layout(channels: Sequence[Tuple[str, bool]]):
    """The value record of ``csrc/hash_agg.cu`` for (op, is_f64) channels:
    (hot offsets, cold offsets, W, H, a fresh record's W words).  The H hot
    words, where a row adds, come first: per channel its accumulator word
    (a float64 min/max as its image), a float64 sum's query-scale pair
    [lo, hi], a FIRST/LAST row word (INT64_MAX for FIRST, -1 for LAST).
    Then the cold words (-1: none): a float64 sum's [float64 word, the
    call's largest |x|, fallback lo, hi], a FIRST/LAST value word.  W is a
    multiple of 4 past 2 words, so records start on 32-byte sectors."""
    hot, init = [], []
    for op, is_f64 in channels:
        hot.append(len(init))
        if op in ORDERED_OPS:
            init.append(_I64_MAX if op.startswith("first") else -1)
        elif is_f64 and op == "sum":
            init += [0, 0]
        else:
            init.append(int(_ha_init(op, is_f64)))
    H = len(init)
    cold = []
    for op, is_f64 in channels:
        if op in ORDERED_OPS:
            cold.append(len(init))
            init.append(0)
        elif is_f64 and op == "sum":
            cold.append(len(init))
            init += [0, 0, 0, 0]
        else:
            cold.append(-1)
    W = len(init) if len(init) <= 2 else -(-len(init) // 4) * 4
    return hot, cold, W, H, init + [0] * (W - len(init))


class HashAccumulator:
    """The per-query state of the hash aggregation: one table that every
    batch adds into.

    ``channels`` holds (op, is_f64) per contribution, op in
    sum/min/max/count and first/last/first_valid/last_valid (whose value
    columns are float64 or int64 words).  ``update`` takes each batch's
    int64 key words with their validity (:func:`key_word`), its
    contributions and its live mask.  The host keeps an upper bound on the
    number of groups (the rows added so far, or ``key_bound`` when the
    keys' domain is smaller); the table grows only when that bound could
    pass ``HA_LOAD`` of its slots, and then one fetch reads the exact group
    count first.  ``finish`` returns the groups in gid order: a large
    table's first ``groups`` after one more fetch of their count, a small
    one's under its live mask.

    On a CUDA device the table is open addressing over ``cap`` slot
    records with a dense value record per group (``csrc/hash_agg.cu``,
    :func:`record_layout`): ``recs`` [cap, stride], ``meta`` [gids,
    2 + nkeys] and ``vals`` [gids, W], where ``gids`` is the most groups
    the table may hold (``HA_LOAD`` of its slots for updates, the host's
    bound for a merge), ``fwords`` the float64 sums' query scales and the
    count of the last call's fallback list, and ``fblist`` that list (the
    next call, or :meth:`finish`, folds it).  On the CPU, or with
    ``plain=True`` on either device, the plain version keeps the groups
    dense (``hash_agg_update_plain``), with the same growth decisions and
    fetches.  ``collide`` sends every
    key to one bucket (a test of the kernel's probing)."""

    def __init__(self, nkeys: int, channels: Sequence[Tuple[str, bool]],
                 device, key_bound: Optional[int] = None,
                 collide: bool = False, plain: Optional[bool] = None,
                 pool: Optional["MergePool"] = None):
        if not 1 <= nkeys <= HA_MAX_KEYS or len(channels) > HA_MAX_CH:
            raise ValueError(f"the hash aggregation takes 1..{HA_MAX_KEYS} "
                             f"keys and at most {HA_MAX_CH} channels")
        self.nkeys = nkeys
        self.channels = list(channels)
        self.device = torch.device(device)
        self.key_bound = key_bound
        self.collide = collide
        self.kernel = self.device.type == "cuda" if plain is None \
            else not plain
        self.cap = 0
        self.bound = 0
        self.growths = 0
        self.calls = 0
        self.merging = False   # merge calls use the merge table
        self.pool = pool
        self.gids = 0          # the groups the value records have room for
        self.ops = [_HA_OP[kernel_op(op, None)[0]] for op, _ in self.channels]
        self.f64 = [int(f) for _, f in self.channels]
        self.nf = sum(1 for op, f in zip(self.ops, self.f64)
                      if f and op == _HA_OP["sum"])  # float64 sums
        # the group count and, for the kernel, its table words (zero at the
        # start: per float64 sum its largest |x| bits and scale word, the
        # count of the last call's fallback list, the group count each
        # launch starts from, a ticket, the rows of the list's call), made
        # by one fill
        words = torch.zeros(1 + (2 * self.nf + 4 if self.kernel else 0),
                            dtype=torch.int64, device=self.device)
        self.ngroups, self.fwords = words[:1], words[1:]
        self.fblist: Optional[torch.Tensor] = None
        self._c_layout = None  # the ctypes arrays of the layout, once
        self.hot, self.cold, self.W, self.H, self.fresh = \
            record_layout(self.channels)
        self.stride = 1 << self.nkeys.bit_length()  # >= 1 + nkeys

    def _limit_bound(self, n: int) -> int:
        return n if self.key_bound is None else min(n, self.key_bound)

    def _alloc_plain(self) -> None:
        """The plain version's dense, empty groups: keys [nkeys, 0], null
        bits, per channel its accumulator and (FIRST/LAST) its 0/1 "has"
        words."""
        dev = self.device
        self.keys = torch.empty((self.nkeys, 0), dtype=torch.int64,
                                device=dev)
        self.nulls = torch.empty(0, dtype=torch.int32, device=dev)
        self.acc, self.aux = [], []
        for op, is_f64 in self.channels:
            dtype = torch.float64 if is_f64 and (
                op == "sum" or op in ORDERED_OPS) else torch.int64
            self.acc.append(torch.full((0,), _ha_init(op, is_f64),
                                       dtype=dtype, device=dev))
            self.aux.append(torch.zeros(0, dtype=torch.int64, device=dev)
                            if op in ORDERED_OPS else None)

    @staticmethod
    def _slots_for(groups: int) -> int:
        need = max(HA_MIN_SLOTS, int(groups / HA_LOAD))
        return 1 << (need - 1).bit_length()

    def _records(self, cap: int, keep: int) -> None:
        """An update table of ``cap`` slots: empty slot records and value
        records for ``HA_LOAD`` of them, the first ``keep`` groups'
        records kept."""
        dev, gids = self.device, max(1, int(cap * HA_LOAD))
        meta = torch.empty((gids, 2 + self.nkeys), dtype=torch.int64,
                           device=dev)
        vals = torch.empty((gids, self.W), dtype=torch.int64, device=dev)
        if keep:
            meta[:keep] = self.meta[:keep]
            vals[:keep] = self.vals[:keep]
        self.meta, self.vals, self.gids = meta, vals, gids
        self.recs = torch.zeros(cap * self.stride, dtype=torch.int64,
                                device=dev)
        self.cap = cap

    def _reserve(self, n: int) -> None:
        """Make room for ``n`` more rows' groups: fetch the exact count and
        grow only when the host's bound says the table could fill."""
        if self.cap == 0:
            cap = self._slots_for(self._limit_bound(2 * n))
            if self.kernel:
                self._records(cap, 0)
            else:
                self._alloc_plain()
                self.cap = cap
            return
        limit = int(self.cap * HA_LOAD)
        if self._limit_bound(self.bound + n) <= limit:
            return
        from ..utils.metrics import fetch
        self.bound = int(fetch(self.ngroups)[0])
        if self._limit_bound(self.bound + n) <= limit:
            return
        self.growths += 1
        cap = self._slots_for(self._limit_bound(2 * (self.bound + n)))
        if self.kernel:
            # the count was just read: the first `bound` gids are every
            # group
            self._records(cap, self.bound)
            hash_agg_reinsert(self)
        else:
            self.cap = cap

    def update(self, words: Sequence[Value],
               contributions: Sequence[Value],
               active: Optional[torch.Tensor], n: int) -> None:
        """Adds one batch of ``n`` rows (in place)."""
        if len(words) != self.nkeys or len(contributions) != len(
                self.channels):
            raise ValueError("keys/contributions do not match the "
                             "accumulator's layout")
        if self.merging:
            raise ValueError("an accumulator takes updates or merges, not "
                             "both")
        self._reserve(n)
        self.calls += 1
        words = [(_column(d, n), _column(v, n)) for d, v in words]
        contributions = [(_column(d, n), _column(kernel_op(op, v)[1], n))
                         for (d, v), (op, _) in zip(contributions,
                                                     self.channels)]
        run = hash_agg_update if self.kernel else hash_agg_update_plain
        run(self, words, contributions, active, n)
        self.bound = self._limit_bound(self.bound + n)

    def needs_count(self) -> bool:
        """Does :meth:`finish` compact (and so need the group count)?  A
        merge table asks when the table the update's rule would size for
        its rows (twice them) passes ``HA_COMPACT_SLOTS``."""
        if self.merging:
            return self._slots_for(self._limit_bound(2 * self.bound)) \
                > HA_COMPACT_SLOTS
        return self.cap > HA_COMPACT_SLOTS

    # -- the merge table (partial buffers, hash_agg.cu's same kernels) --------
    def _reserve_merge(self, n: int) -> None:
        """Room for ``n`` more buffer rows' groups, without a fetch: the
        gid capacity is the host's bound on the groups, the slots twice it
        (load at most ``HA_LOAD``).  A table that must grow takes larger
        buffers from its pool and re-places its gids' slots."""
        bound = self._limit_bound(self.bound + n)
        if not self.merging:
            self.merging = True
            self.cap = self._slots_for(bound)
            if not self.kernel:
                self._alloc_plain()
                return
            if self.pool is None:
                self.pool = MergePool(self.device)
            self.pool.acquire(self)
            self.meta, self.vals = self.pool.dense(bound, self.nkeys, self.W,
                                                   0)
            self.recs = self.pool.records(self.cap * self.stride)
            self.gids = bound
            return
        if not self.kernel:
            return
        if bound > self.gids:
            self.meta, self.vals = self.pool.dense(bound, self.nkeys, self.W,
                                                   self.gids)
        cap = self._slots_for(bound)
        if cap > self.cap:
            self.growths += 1
            self._clear_slots()   # wider records re-placed from the gids
            self.recs = self.pool.records(cap * self.stride)
            self.cap = cap
            self.gids = max(self.gids, bound)
            hash_agg_reinsert(self)
        self.gids = max(self.gids, bound)

    def _clear_slots(self) -> None:
        """Zero (empty) the table's own slot records in the pool."""
        self.recs[:self.cap * self.stride].zero_()

    def release(self) -> None:
        """Hand a merge table's buffers back to its pool with its slots
        emptied (after :meth:`finish`; the accumulator is done)."""
        if self.merging and self.kernel and self.pool is not None \
                and self.pool.holder is self:
            self._clear_slots()
            self.pool.holder = None

    def merge(self, words: Sequence[Value], buffers: Sequence[Value],
              active: Optional[torch.Tensor], n: int) -> None:
        """Adds one batch of ``n`` partial-aggregation buffer rows (in
        place): each channel's op is its buffer's merge op
        (:func:`merge_op`) and each buffer's validity its mask (a FIRST or
        LAST buffer's: its ``has`` flag)."""
        if len(words) != self.nkeys or len(buffers) != len(self.channels):
            raise ValueError("keys/buffers do not match the accumulator's "
                             "layout")
        if self.cap and not self.merging:
            raise ValueError("an accumulator takes updates or merges, not "
                             "both")
        self._reserve_merge(n)
        self.calls += 1
        words = [(_column(d, n), _column(v, n)) for d, v in words]
        buffers = [(_column(d, n), _column(v, n)) for d, v in buffers]
        run = hash_agg_merge if self.kernel else hash_agg_merge_plain
        run(self, words, buffers, active, n)
        self.bound = self._limit_bound(self.bound + n)

    def _finish_records(self, groups: Optional[int]):
        """:meth:`finish` of the kernel's table: the float64 sums folded,
        then the first ``groups`` gids' keys and values (copied out, so a
        pool can be reused), or every gid record under the live mask
        gid < ngroups."""
        if any(f and op == "sum" for op, f in self.channels):
            hash_agg_fold(self)
        rows = self.gids if groups is None else groups
        live = None if groups is not None else (
            torch.arange(rows, device=self.device) < self.ngroups)
        meta, vals = self.meta[:rows], self.vals[:rows]
        nulls = meta[:, 1]
        if live is None:
            keys = [(meta[:, 2 + i].clone(), (nulls >> i) & 1 == 0)
                    for i in range(self.nkeys)]
        else:
            # rows past the groups hold whatever their memory held: their
            # keys become 0 and null, so no code indexes out of a
            # dictionary downstream
            keys = [(torch.where(live, meta[:, 2 + i], 0),
                     live & ((nulls >> i) & 1 == 0))
                    for i in range(self.nkeys)]
        values = []
        for (op, is_f64), hot, cold in zip(self.channels, self.hot,
                                           self.cold):
            if op in ORDERED_OPS:
                a = vals[:, cold].clone()
                x = vals[:, hot]
                values.append((a.view(torch.float64) if is_f64 else a,
                               x == _I64_MIN if op.startswith("first")
                               else x >= 0))
            elif is_f64 and op == "sum":
                values.append(vals[:, cold].clone().view(torch.float64))
            elif is_f64:
                values.append(f64_from_image(vals[:, hot]))
            else:
                values.append(vals[:, hot].clone())
        return keys, values, live

    def finish(self, groups: Optional[int] = None, compact: bool = True):
        """(per key its int64 words and validity; per channel its values —
        float64 min/max decoded from their images, FIRST/LAST as
        (value, has) pairs; the live mask or None), every list in one
        group order.  A table of more than ``HA_COMPACT_SLOTS`` slots comes
        back as its groups after one fetch of their count (or ``groups``,
        when the caller read the count in a fetch of its own); a smaller
        one, or any with ``compact=False``, comes back whole under its live
        mask, with no fetch.  The plain version's groups are dense already;
        it makes the same fetch, so counts agree."""
        from ..utils.metrics import fetch
        if self.cap == 0:
            self._reserve(0)
        if not compact or not self.needs_count():
            groups = None
        elif groups is None:
            groups = int(fetch(self.ngroups)[0])
        if self.kernel:
            return self._finish_records(groups)
        keys = [(w, (self.nulls >> i) & 1 == 0)
                for i, w in enumerate(self.keys)]
        values = []
        for (op, is_f64), a, x in zip(self.channels, self.acc, self.aux):
            if op in ORDERED_OPS:
                values.append((a, x != 0))
            else:
                values.append(f64_from_image(a) if is_f64 and op != "sum"
                              else a)
        return keys, values, None


def _tuple_matrix(words, nulls) -> torch.Tensor:
    """[n, 1 + nkeys] int64 rows (null bits, words) that identify a
    group."""
    return torch.stack([nulls.to(torch.int64)] + list(words), 1)


def hash_agg_update_plain(acc: HashAccumulator, words, contributions,
                          active, n: int) -> None:
    """Plain PyTorch version of ``hash_agg_update``: the groups stay dense
    (``acc.keys`` [nkeys, G], ``acc.nulls`` [G], ``acc.acc`` [G] per
    channel); each batch's tuples merge into them through ``torch.unique``
    and its contributions add by ``index_add_``/``scatter_reduce_``."""
    dev = acc.device
    rows = torch.arange(n, device=dev) if active is None \
        else active.nonzero().squeeze(1)
    nulls = torch.zeros(rows.numel(), dtype=torch.int32, device=dev)
    bw = []
    for i, (d, v) in enumerate(words):
        w = d[rows]
        if v is not None:
            ok = v[rows]
            w = torch.where(ok, w, 0)
            nulls |= (~ok).to(torch.int32) << i
        bw.append(w)
    old = _tuple_matrix(list(acc.keys), acc.nulls)
    G = old.shape[0]
    both = torch.cat([old, _tuple_matrix(bw, nulls)]) if bw else old
    uniq, inv = torch.unique(both, dim=0, return_inverse=True)
    groups = uniq.shape[0]
    new_acc, new_aux = [], []
    for (op, is_f64), a, x in zip(acc.channels, acc.acc, acc.aux):
        fresh = torch.full((groups,), _ha_init(op, is_f64), dtype=a.dtype,
                           device=dev)
        fresh[inv[:G]] = a
        new_acc.append(fresh)
        if x is not None:
            x_fresh = torch.zeros(groups, dtype=torch.int64, device=dev)
            x_fresh[inv[:G]] = x
            x = x_fresh
        new_aux.append(x)
    slot = inv[G:]
    for (d, v), (op, is_f64), a, has in zip(contributions, acc.channels,
                                            new_acc, new_aux):
        m = torch.ones(rows.numel(), dtype=torch.bool, device=dev) \
            if v is None else v[rows]
        s = slot[m]
        if op in ORDERED_OPS:
            if s.numel() == 0:
                continue
            # the batch's first (last) qualifying row of each group
            pos = torch.arange(rows.numel(), device=dev)[m]
            first = op.startswith("first")
            pick = torch.full((groups,), rows.numel() if first else -1,
                              dtype=torch.int64, device=dev)
            pick.scatter_reduce_(0, s, pos, "amin" if first else "amax")
            found = (pick < rows.numel()) & (pick >= 0)
            take = found & (has == 0) if first else found
            x = d[rows][pick.clamp(0, max(rows.numel() - 1, 0))]
            a.copy_(torch.where(take, x.to(a.dtype), a))
            has.copy_(torch.where(found, 1, has))
            continue
        if op == "count":
            a.index_add_(0, s, torch.ones_like(s))
            continue
        x = d[rows][m]
        if op == "sum":
            a.index_add_(0, s, x.to(a.dtype))
        else:
            if is_f64:
                x = f64_image(x, _I64_MIN if op == "min" else _I64_MAX)
            a.scatter_reduce_(0, s, x, "amin" if op == "min" else "amax")
    acc.ngroups.fill_(groups)
    acc.nulls = uniq[:, 0].to(torch.int32)
    acc.keys = uniq[:, 1:].T.contiguous()
    acc.acc = new_acc
    acc.aux = new_aux


def _check_keys(words, active, n: int) -> None:
    """The int64 key words, their masks and the live mask of ``n`` rows, as
    ``csrc/hash_agg.cu`` takes them."""
    if active is not None:
        _check_column(active, n, (torch.bool,), "active")
    for d, v in words:
        _check_column(d, n, (torch.int64,), "key word")
        if v is not None:
            _check_column(v, n, (torch.bool,), "key valid")


def _c_layout(acc: HashAccumulator):
    """The accumulator's ops, float64 flags, hot and cold offsets and fresh
    record as ctypes arrays, made once (every launch passes them)."""
    if acc._c_layout is None:
        I = kernels.int_array
        acc._c_layout = (I(acc.ops), I(acc.f64), I(acc.hot), I(acc.cold),
                         kernels.int64_array(acc.fresh))
    return acc._c_layout


def _launch_hash(acc: HashAccumulator, words, cols, active, n: int,
                 what: str) -> bool:
    """Launch ``hash_agg_update`` of ``csrc/hash_agg.cu`` (the update's and
    the merge's kernels); False when there are no rows."""
    _check_keys(words, active, n)
    data, valid = [], []
    for (d, v), (op, is_f64) in zip(cols, acc.channels):
        if op == "count":
            if d is not None:
                raise ValueError("a count channel takes no data")
        else:
            _check_column(d, n, (torch.float64 if is_f64 else torch.int64,),
                          what)
        if v is not None:
            _check_column(v, n, (torch.bool,), f"{what} valid")
        data.append(_opt_ptr(d))
        valid.append(_opt_ptr(v))
    if n == 0:
        return False
    ordered = any(op in ORDERED_OPS for op, _ in acc.channels)
    rgid = torch.empty(n, dtype=torch.int32, device=acc.device) \
        if ordered else None
    # the call's list of (group, float64 sum) pairs that took the fallback;
    # the last call's list stays until this call's first launch folds it
    fbprev = fblist = acc.fblist
    if acc.nf and (fblist is None or fblist.numel() < n * acc.nf):
        fblist = torch.empty(n * acc.nf, dtype=torch.int64,
                             device=acc.device)
        fbprev = fblist if fbprev is None else fbprev
    acc.fblist = fblist
    ops, f64, hot, cold, fresh = _c_layout(acc)
    P = kernels.pointer_array
    lib = kernels.load("hash_agg")
    rc = lib.hash_agg_update(
        acc.nkeys, P([d.data_ptr() for d, _ in words]),
        P([_opt_ptr(v) for _, v in words]), len(acc.channels), P(data),
        P(valid), ops, f64, hot, cold, acc.W, acc.H, fresh, _opt_ptr(active),
        n, acc.recs.data_ptr(), acc.stride, acc.cap, int(acc.collide),
        acc.meta.data_ptr(),
        acc.vals.data_ptr(), acc.ngroups.data_ptr(), acc.fwords.data_ptr(),
        _opt_ptr(rgid), _opt_ptr(fbprev), _opt_ptr(fblist), acc.calls,
        torch.cuda.current_stream(acc.device).cuda_stream)
    kernels.check_launch(lib, "hash_agg_update", rc)
    return True


def hash_agg_update(acc: HashAccumulator, words, contributions, active,
                    n: int) -> None:
    """Launch ``hash_agg_update`` of ``csrc/hash_agg.cu``: one batch into
    the accumulator's table."""
    if not _launch_hash(acc, words, contributions, active, n,
                        "contribution"):
        return
    hash_agg_update.launches += 1
    if any(op in ORDERED_OPS for op, _ in acc.channels):
        hash_agg_update.ordered_launches += 1


hash_agg_update.launches = 0
hash_agg_update.ordered_launches = 0  # the launches that pick FIRST/LAST


def hash_agg_fold(acc: HashAccumulator) -> None:
    """Launch ``hash_agg_fold``: every group's float64 sums' query-scale
    integers, and the last call's fallback integers, into their float64
    words (the output's fold)."""
    lib = kernels.load("hash_agg")
    ops, f64, hot, cold, _ = _c_layout(acc)
    rc = lib.hash_agg_fold(
        len(acc.channels), ops, f64, hot, cold, acc.vals.data_ptr(), acc.W,
        acc.ngroups.data_ptr(), acc.fwords.data_ptr(), acc.gids,
        torch.cuda.current_stream(acc.device).cuda_stream)
    kernels.check_launch(lib, "hash_agg_fold", rc)
    hash_agg_fold.launches += 1


hash_agg_fold.launches = 0


def merge_op(op: str) -> str:
    """The channel op that merges partial buffers of a buffer op
    (``aggfns`` ``buffers()``): FIRST/LAST pick among the partial rows
    whose ``has`` holds, so both forms merge as their ``_valid`` form;
    a count channel's partials are summed; every other op merges as
    itself."""
    if op == "count":
        return "sum"
    return op if op.endswith("_valid") or op not in ORDERED_OPS \
        else op + "_valid"


def hash_agg_merge_plain(acc: HashAccumulator, words, buffers, active,
                         n: int) -> None:
    """Plain version of ``hash_agg_merge``: the plain update with each
    buffer's validity as its mask (``hash_agg_update_plain`` picks FIRST
    and LAST among the masked rows)."""
    if any(op == "count" for op, _ in acc.channels):
        raise ValueError("a merge takes no count channel")
    hash_agg_update_plain(acc, words, buffers, active, n)


def hash_agg_merge(acc: HashAccumulator, words, buffers, active,
                   n: int) -> None:
    """Launch ``csrc/hash_agg.cu``'s kernels for a batch of partial
    buffers into the accumulator's merge table."""
    if any(op == "count" for op, _ in acc.channels):
        raise ValueError("a merge takes no count channel")
    if _launch_hash(acc, words, buffers, active, n, "buffer"):
        hash_agg_merge.launches += 1


hash_agg_merge.launches = 0


def hash_agg_reinsert(acc: HashAccumulator) -> None:
    """Launch ``hash_agg_reinsert``: every group of the table into its
    (empty) records of ``acc.cap`` slots."""
    lib = kernels.load("hash_agg")
    rc = lib.hash_agg_reinsert(
        acc.nkeys, acc.recs.data_ptr(), acc.stride, acc.cap,
        int(acc.collide), acc.meta.data_ptr(), acc.ngroups.data_ptr(),
        acc.gids, torch.cuda.current_stream(acc.device).cuda_stream)
    kernels.check_launch(lib, "hash_agg_reinsert", rc)
    hash_agg_reinsert.launches += 1


hash_agg_reinsert.launches = 0


class MergePool:
    """The device buffers of the merge tables of one final aggregate
    (``csrc/hash_agg.cu``, through :func:`hash_agg_merge`), lent to one
    :class:`HashAccumulator` at a time: slot records, all empty while no
    table holds them (a released table zeroes the slots it used, so a
    table sized for a small bucket clears no more), and the gid-indexed
    meta and value records, which a table writes as it claims groups.
    Buffers only grow."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.recs: Optional[torch.Tensor] = None
        self.meta: Optional[torch.Tensor] = None
        self.vals: Optional[torch.Tensor] = None
        self.holder: Optional[HashAccumulator] = None

    def acquire(self, acc: HashAccumulator) -> None:
        if self.holder is not None:
            raise RuntimeError("the merge pool's table is held by another "
                               "accumulator (release it first)")
        self.holder = acc

    def records(self, words: int) -> torch.Tensor:
        """At least ``words`` int64 words of empty slot records (zero)."""
        if self.recs is None or self.recs.numel() < words:
            self.recs = torch.zeros(words, dtype=torch.int64,
                                    device=self.device)
        return self.recs

    def dense(self, gids: int, nkeys: int, W: int, keep: int):
        """(meta [gids, 2 + nkeys], vals [gids, W]) int64 views; a larger
        buffer keeps the first ``keep`` records of each."""
        M, gids = 2 + nkeys, max(gids, 1)
        out = []
        for name, width in (("meta", M), ("vals", W)):
            buf = getattr(self, name)
            if buf is None or buf.numel() < gids * width:
                new = torch.empty(gids * width, dtype=torch.int64,
                                  device=self.device)
                if keep:
                    new[:keep * width].copy_(buf[:keep * width])
                setattr(self, name, new)
                buf = new
            out.append(buf[:gids * width].view(gids, width))
        return out


# ---------------------------------------------------------------------------------
# The partial aggregate's skip probe: distinct and live sampled key hashes
# ---------------------------------------------------------------------------------

GR_MAX_ROWS = 1 << 18       # csrc/group_ratio.cu GR_MAX_ROWS


def group_ratio_plain(h: torch.Tensor, active: Optional[torch.Tensor]
                      ) -> torch.Tensor:
    """Plain version of ``group_ratio_kernel``, the reference's program
    (``plan/physical.py:2019``): sort ``where(active, h, INT64_MAX)`` and
    count the adjacent distinct values below INT64_MAX."""
    big = _I64_MAX
    s = torch.sort(h if active is None else torch.where(active, h, big))[0]
    n_live = h.numel() if active is None else int(active.sum())
    first = torch.ones_like(s, dtype=torch.bool)
    first[1:] = s[1:] != s[:-1]
    n_distinct = int((first & (s != big)).sum())
    return torch.tensor([n_distinct, n_live], dtype=torch.int64,
                        device=h.device)


# one stream's scratch of csrc/group_ratio.cu: its two sets, flag words,
# ticket and set word, all -1 (their empty state) once; each call empties
# the set the call before it filled and flips the set word on the device.
# Kept for the process's life: 8.4 MB for each stream that ever called.
_GR_SCRATCH: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def group_ratio_kernel(h: torch.Tensor, active: Optional[torch.Tensor]
                       ) -> torch.Tensor:
    """Launch ``group_ratio`` of ``csrc/group_ratio.cu``: int64 [2]
    (distinct hashes, live rows) of at most ``GR_MAX_ROWS`` rows, one
    device operation a call (the stream's two sets are kept between
    calls).  A failed launch drops the stream's scratch before it
    raises."""
    n = h.shape[0]
    if n > GR_MAX_ROWS:
        raise ValueError(f"group_ratio takes at most {GR_MAX_ROWS} rows")
    _check_column(h, n, (torch.int64,), "hashes")
    if active is not None:
        _check_column(active, n, (torch.bool,), "active")
    out = torch.empty(2, dtype=torch.int64, device=h.device)
    lib = kernels.load("group_ratio")
    stream = torch.cuda.current_stream(h.device).cuda_stream
    key = (h.device, stream)
    words = _GR_SCRATCH.get(key)
    if words is None:
        words = _GR_SCRATCH.setdefault(key, torch.full(
            (int(lib.group_ratio_scratch_words()),), -1, dtype=torch.int64,
            device=h.device))
    rc = lib.group_ratio(h.data_ptr(), _opt_ptr(active), n,
                         words.data_ptr(), out.data_ptr(), stream)
    if rc != 0:
        _GR_SCRATCH.pop(key, None)
    kernels.check_launch(lib, "group_ratio", rc)
    group_ratio_kernel.launches += 1
    return out


group_ratio_kernel.launches = 0


def group_ratio(h: torch.Tensor, active: Optional[torch.Tensor]
                ) -> torch.Tensor:
    """(distinct hash values, live rows) of the sampled rows as an int64
    [2] tensor on ``h``'s device: the kernel for CUDA tensors, the plain
    version for CPU tensors."""
    h = h.contiguous()
    active = None if active is None else active.contiguous()
    if h.is_cuda:
        return group_ratio_kernel(h, active)
    return group_ratio_plain(h, active)
