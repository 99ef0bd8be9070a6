"""Aggregation reductions: the ungrouped masked reduction and the dense grid.

Counterpart of ``spark_rapids_tpu/ops/groupby.py`` (``ungrouped_reduce``
:396, ``grid_group_reduce`` :424).  The reference reduces each batch to
partials and merges them with further jitted programs; here every batch
adds straight into ONE device accumulator per query, which gives the same
result without the concat/re-reduce passes.

Each reduction has a hand-written CUDA kernel (``csrc/masked_reduce.cu``,
``csrc/grid_agg.cu``) and a plain PyTorch version of the same function in
this module.  ``ungrouped_reduce`` and ``grid_group_reduce`` pick by where
the tensors lie: CUDA tensors launch the kernel (or raise), CPU tensors run
the plain version.  Each kernel wrapper counts its launches in
``<wrapper>.launches``.

Contributions are ``((data, valid), op)`` pairs as ``aggfns`` makes them;
``data=None`` counts the live rows where ``valid`` holds.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from .. import kernels
from ..batch import upload

__all__ = ["init_scalars", "ungrouped_reduce", "masked_reduce",
           "masked_reduce_plain", "GridAccumulator", "grid_group_reduce",
           "grid_agg", "grid_agg_plain", "grid_size", "grid_uses_shared"]

Value = Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]

_I64_MAX = torch.iinfo(torch.int64).max
_I64_MIN = torch.iinfo(torch.int64).min
_OPCODE = {"sum": 0, "min": 1, "max": 2, "count": 3}
MR_THREADS = 256        # csrc/masked_reduce.cu MR_THREADS
MR_MAX_BLOCKS = 1024    # first-pass grid size cap (scratch = blocks x k)
MR_MAX_COLS = 16        # csrc/masked_reduce.cu MR_MAX_COLS
GA_MAX_KEYS = 8         # csrc/grid_agg.cu GA_MAX_KEYS
GA_MAX_COLS = 16        # csrc/grid_agg.cu GA_MAX_COLS
GRID_SHARED_BYTES = 48 * 1024


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
    acc_f = torch.tensor([f_init[op] if f else 0.0 for op, f in specs],
                         dtype=torch.float64)
    acc_i = torch.tensor([0 if f else i_init[op] for op, f in specs],
                         dtype=torch.int64)
    return upload(acc_f, device), upload(acc_i, device)


def ungrouped_reduce(contributions: List[Tuple[Value, str]],
                     active: torch.Tensor, acc_f: torch.Tensor,
                     acc_i: torch.Tensor) -> None:
    """Adds one batch into an ungrouped accumulator (in place):
    masked sum/min/max of float64 or int64 contributions, and counts."""
    n = active.shape[0]
    cols = [(_column(d, n), _column(v, n), "count" if d is None else op)
            for (d, v), op in contributions]
    if active.is_cuda:
        masked_reduce(cols, active, acc_f, acc_i)
    else:
        masked_reduce_plain(cols, active, acc_f, acc_i)


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
                        acc_i: torch.Tensor) -> None:
    """Plain PyTorch version of ``csrc/masked_reduce.cu``: ``cols`` is one
    (data, valid, op) per accumulator slot, op in sum/min/max/count."""
    if active.shape[0] == 0:
        return
    for j, (d, v, op) in enumerate(cols):
        m = active if v is None else active & v
        if op == "count":
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


def masked_reduce(cols, active: torch.Tensor, acc_f: torch.Tensor,
                  acc_i: torch.Tensor) -> None:
    """Launch ``csrc/masked_reduce.cu`` on CUDA tensors (same arguments as
    :func:`masked_reduce_plain`).  Columns go in chunks of MR_MAX_COLS,
    one launch (two CUDA kernels) per chunk."""
    n = active.shape[0]
    _check_column(active, n, (torch.bool,), "active")
    for acc, dtype in ((acc_f, torch.float64), (acc_i, torch.int64)):
        _check_column(acc, len(cols), (dtype,), "accumulator")
    lib = kernels.load("masked_reduce")
    nblocks = min(max(1, -(-n // MR_THREADS)), MR_MAX_BLOCKS)
    stream = torch.cuda.current_stream(active.device).cuda_stream
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
        k = len(chunk)
        partials = torch.empty(nblocks * k, dtype=torch.int64,
                               device=active.device)
        rc = lib.masked_reduce(
            active.data_ptr(), n, k, kernels.pointer_array(data),
            kernels.pointer_array(valid), kernels.int_array(ops),
            kernels.int_array(is_f64), partials.data_ptr(), nblocks,
            acc_f[lo:].data_ptr(), acc_i[lo:].data_ptr(), stream)
        kernels.check_launch(lib, "masked_reduce", rc)
        masked_reduce.launches += 1


masked_reduce.launches = 0


# ---------------------------------------------------------------------------------
# Grid: k dictionary-coded keys -> G = prod(d_i + 1) slots
# ---------------------------------------------------------------------------------

def grid_size(dims: Sequence[int]) -> int:
    g = 1
    for d in dims:
        g *= d + 1
    return g


def grid_uses_shared(G: int, nf: int, ni: int) -> bool:
    """True when the kernel privatizes the grid in shared memory."""
    return G * (nf + ni + 1) * 8 <= GRID_SHARED_BYTES


class GridAccumulator:
    """The per-query device accumulator of the grid path.

    ``f`` [G, nf] float64 sums, ``i`` [G, ni] int64 sums and masked counts,
    ``cnt`` [G] live rows per slot.  ``kinds`` gives, per contribution,
    where it lands, fixed before the first batch from the aggregates'
    nullability: "f" or "i" for a column of its own, "cnt" for a count of
    every live row, which the presence count already is."""

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
        to their new slot."""
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

    def values(self) -> List[torch.Tensor]:
        """Per contribution, its [G] accumulated sums."""
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
    run = grid_agg if active.is_cuda else grid_agg_plain
    run(keys, acc.dims, f_cols, i_cols, active, acc.f, acc.i, acc.cnt)


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
             acc_cnt) -> None:
    """Launch ``csrc/grid_agg.cu`` on CUDA tensors (same arguments as
    :func:`grid_agg_plain`)."""
    n = active.shape[0]
    G = acc_cnt.shape[0]
    nf, ni = len(f_cols), len(i_cols)
    if not 1 <= len(keys) <= GA_MAX_KEYS or nf > GA_MAX_COLS \
            or ni > GA_MAX_COLS:
        raise ValueError(f"grid_agg takes 1..{GA_MAX_KEYS} keys and at most "
                         f"{GA_MAX_COLS} float64 and {GA_MAX_COLS} int64 "
                         f"columns, got {len(keys)}, {nf}, {ni}")
    if G != grid_size(dims) or acc_f.shape != (G, nf) \
            or acc_i.shape != (G, ni):
        raise ValueError("accumulator shapes do not match the grid")
    for acc in (acc_f, acc_i, acc_cnt):
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
    lib = kernels.load("grid_agg")
    stream = torch.cuda.current_stream(active.device).cuda_stream
    rc = lib.grid_agg(
        kernels.pointer_array(codes), kernels.pointer_array(code_valid),
        kernels.int_array(list(dims)), len(keys), active.data_ptr(), n,
        f_data, f_valid, nf, i_data, i_valid, ni, acc_f.data_ptr(),
        acc_i.data_ptr(), acc_cnt.data_ptr(), G,
        int(grid_uses_shared(G, nf, ni)), stream)
    kernels.check_launch(lib, "grid_agg", rc)
    grid_agg.launches += 1


grid_agg.launches = 0
