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

from typing import List, Optional, Sequence, Tuple

import torch

from .. import kernels
from ..batch import live_mask, upload

__all__ = ["init_scalars", "ungrouped_reduce", "masked_reduce",
           "masked_reduce_plain", "GridAccumulator", "grid_group_reduce",
           "grid_agg", "grid_agg_plain", "grid_size", "grid_uses_shared",
           "dense_key_stats", "dense_agg_stats", "dense_agg_stats_plain",
           "DenseAccumulator", "dense_agg_update", "dense_agg_update_plain",
           "dense_agg_check", "dense_agg_check_plain", "HashAccumulator",
           "hash_agg_update", "hash_agg_update_plain", "hash_agg_rehash",
           "hash_agg_merge", "hash_agg_merge_plain", "merge_op",
           "key_word", "key_from_word", "f64_image", "f64_from_image",
           "group_ratio", "group_ratio_plain", "group_ratio_kernel",
           "GR_MAX_ROWS"]

Value = Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]

_I64_MAX = torch.iinfo(torch.int64).max
_I64_MIN = torch.iinfo(torch.int64).min
_OPCODE = {"sum": 0, "min": 1, "max": 2, "count": 3, "first": 4, "last": 5}
ORDERED_OPS = ("first", "last", "first_valid", "last_valid")
MR_THREADS = 256        # csrc/masked_reduce.cu MR_THREADS
MR_MAX_BLOCKS = 1024    # first-pass grid size cap (scratch = blocks x k)
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
    if acc_h is None:
        if any(op in ("first", "last") for _, _, op in cols):
            raise ValueError("first/last need the accumulator's has words")
        acc_h = torch.zeros_like(acc_i)
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


def masked_reduce(cols, active: torch.Tensor, acc_f: torch.Tensor,
                  acc_i: torch.Tensor,
                  acc_h: Optional[torch.Tensor] = None) -> None:
    """Launch ``csrc/masked_reduce.cu`` on CUDA tensors (same arguments as
    :func:`masked_reduce_plain`).  Columns go in chunks of MR_MAX_COLS,
    one launch (two CUDA kernels) per chunk."""
    n = active.shape[0]
    _check_column(active, n, (torch.bool,), "active")
    if acc_h is None:
        acc_h = torch.zeros_like(acc_i)
    for acc, dtype in ((acc_f, torch.float64), (acc_i, torch.int64),
                       (acc_h, torch.int64)):
        _check_column(acc, len(cols), (dtype,), "accumulator")
    if n == 0:
        return  # nothing to reduce (the plain version returns too)
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
            acc_f[lo:].data_ptr(), acc_i[lo:].data_ptr(),
            acc_h[lo:].data_ptr(), stream)
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


class GridAccumulator:
    """The per-query device accumulator of the grid path.

    ``f`` [G, nf] float64 sums, ``i`` [G, ni] int64 sums and masked counts,
    ``cnt`` [G] live rows per slot; ``fx`` [G, nf, 3] the kernel's
    fixed-point words of a call (zero between calls).  ``kinds`` gives,
    per contribution,
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
        self.fx = torch.zeros((G, nf, 3), dtype=torch.int64, device=device)

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
        self.fx = torch.zeros((G,) + self.fx.shape[1:], dtype=torch.int64,
                              device=self.fx.device)
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
    if active.is_cuda:
        grid_agg(keys, acc.dims, f_cols, i_cols, active, acc.f, acc.i,
                 acc.cnt, acc.fx)
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
             acc_cnt, fx: Optional[torch.Tensor] = None) -> None:
    """Launch ``csrc/grid_agg.cu`` on CUDA tensors (the arguments of
    :func:`grid_agg_plain`, and ``fx``, the [G, nf, 3] fixed-point words,
    zero between calls: made here when the caller keeps none)."""
    n = active.shape[0]
    G = acc_cnt.shape[0]
    nf, ni = len(f_cols), len(i_cols)
    if not 1 <= len(keys) <= GA_MAX_KEYS or nf > GA_MAX_COLS \
            or ni > GA_MAX_COLS:
        raise ValueError(f"grid_agg takes 1..{GA_MAX_KEYS} keys and at most "
                         f"{GA_MAX_COLS} float64 and {GA_MAX_COLS} int64 "
                         f"columns, got {len(keys)}, {nf}, {ni}")
    if fx is None:
        fx = torch.zeros((G, nf, 3), dtype=torch.int64, device=acc_f.device)
    if G != grid_size(dims) or acc_f.shape != (G, nf) \
            or acc_i.shape != (G, ni) or fx.shape != (G, nf, 3):
        raise ValueError("accumulator shapes do not match the grid")
    for acc in (acc_f, acc_i, acc_cnt, fx):
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
        acc_i.data_ptr(), acc_cnt.data_ptr(), fx.data_ptr(), G,
        int(grid_uses_shared(G, nf, ni)), stream)
    kernels.check_launch(lib, "grid_agg", rc)
    grid_agg.launches += 1


grid_agg.launches = 0


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


class DenseAccumulator:
    """The per-query device state of the dense aggregation.

    Slots [0, D) hold keys kmin..kmin+D-1; slot D holds the null key.
    ``acc[j]`` is channel j's [D + 1] accumulator (float64 sums, or int64
    sum/min/max; a channel whose contribution has no data counts rows);
    ``present`` marks observed slots; per residual key, ``vmin``/``vmax``
    (int64) and ``vdmin``/``vdmax`` (int32 0/1 validity) prove that it
    depends on the primary.  A float64 residual (``res_f64``) keeps the
    :func:`f64_image` of its values (-0.0 just below +0.0), and a NaN
    sets its slot's vmin and vmax to the two images no number has, which
    the check reads as a violation.  Rows whose key falls outside the
    domain go to the overflow buffer (``cap`` rows), which :meth:`widen`
    folds in."""

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
        self._alloc(self.D)
        nch = len(self.channels)
        i64 = dict(dtype=torch.int64, device=device)
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
        S, dev = D + 1, self.device
        self.acc = []
        for op, is_f64 in self.channels:
            if is_f64:
                self.acc.append(torch.zeros(S, dtype=torch.float64,
                                            device=dev))
            else:
                fill = {"sum": 0, "count": 0, "min": _I64_MAX,
                        "max": _I64_MIN}[op]
                self.acc.append(torch.full((S,), fill, dtype=torch.int64,
                                           device=dev))
        self.present = torch.zeros(S, dtype=torch.uint8, device=dev)
        r = self.nres
        self.vmin = torch.full((r, S), _I64_MAX, dtype=torch.int64,
                               device=dev)
        self.vmax = torch.full((r, S), _I64_MIN, dtype=torch.int64,
                               device=dev)
        self.vdmin = torch.ones((r, S), dtype=torch.int32, device=dev)
        self.vdmax = torch.zeros((r, S), dtype=torch.int32, device=dev)
        # the kernel's words of float64 sums, made at the first launch
        # (``dense_agg_update``)
        self.fx = None

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
        primary, else 0; the number of observed slots)."""
        run = dense_agg_check if self.present.is_cuda \
            else dense_agg_check_plain
        return run(self)

    def tail(self) -> torch.Tensor:
        """int64 [5] device tensor for the query's tail fetch: violation,
        n_groups, overflow rows, overflow key min and max."""
        return torch.cat([self.check(), self.ocount, self.obounds])

    def widen(self, kmin: int, D: int) -> None:
        """Re-lay the accumulators onto [kmin, kmin + D), which contains
        the old domain: old slots land at their keys' new slots, the null
        slot stays last."""
        off = self.kmin - kmin
        if off < 0 or off + self.D > D:
            raise ValueError("the new domain must contain the old one")
        old = (self.acc, self.present, self.vmin, self.vmax, self.vdmin,
               self.vdmax)
        oD = self.D
        self._alloc(D)
        for new, o in zip(self.acc + [self.present], old[0] + [old[1]]):
            new[off:off + oD] = o[:oD]
            new[D] = o[oD]
        for new, o in zip((self.vmin, self.vmax, self.vdmin, self.vdmax),
                          old[2:]):
            new[:, off:off + oD] = o[:, :oD]
            new[:, D] = o[:, oD]
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

    def slot_keys(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(int64 key of every slot, its validity: False for the null
        slot)."""
        slot = torch.arange(self.S, dtype=torch.int64, device=self.device)
        return slot + self.kmin, slot < self.D

    def residual(self, i: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(residual i's value in every slot: int64, or float64 decoded
        from its images; its validity)."""
        v = self.vmin[i]
        if self.res_f64[i]:
            v = f64_from_image(v)
        return v, self.vdmax[i] == 1


def dense_agg_update_plain(acc: DenseAccumulator, key, residuals,
                           contributions, active) -> None:
    """Plain PyTorch version of ``dense_agg_update``: overflow rows land in
    row order (the kernel's atomic cursor gives no fixed order)."""
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
    for j, ((cd, cv), (op, is_f64)) in enumerate(zip(contributions,
                                                     acc.channels)):
        m = rows if cv is None else rows & cv
        x = torch.ones(n, dtype=torch.int64, device=dev) if cd is None \
            else cd
        if op in ("sum", "count"):
            acc.acc[j].index_add_(0, slot[m], x[m].to(acc.acc[j].dtype))
        else:
            acc.acc[j].scatter_reduce_(0, slot[m], x[m],
                                       "amin" if op == "min" else "amax")
    for i, (rd, rv) in enumerate(residuals):
        ok = rows if rv is None else rows & rv
        if acc.res_f64[i]:
            nan = torch.isnan(rd)
            x = f64_image(rd, 0)
            lo, hi = torch.where(nan, _I64_MIN, x), torch.where(nan, _I64_MAX,
                                                                 x)
        else:
            lo = hi = rd.to(torch.int64)
        acc.vmin[i].scatter_reduce_(0, slot[ok], lo[ok], "amin")
        acc.vmax[i].scatter_reduce_(0, slot[ok], hi[ok], "amax")
        acc.vdmax[i][slot[ok]] = 1
        if rv is not None:
            acc.vdmin[i][slot[rows & ~rv]] = 0
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
    for t in acc.acc + [acc.present, acc.vmin, acc.okey]:
        if not t.is_cuda or not t.is_contiguous():
            raise ValueError("accumulators must be contiguous CUDA tensors")
    if n == 0:
        return  # no rows (and no data pointers): no launch
    S = acc.D + 1
    if acc.fx is None:
        # per float64 channel the [S, 3] words of its deterministic sums
        # (zero between calls: the kernel folds and clears them)
        acc.fx = [torch.zeros((S, 3), dtype=torch.int64, device=d.device)
                  if f64 else None for _, f64 in acc.channels]
    P = kernels.pointer_array
    nres = acc.nres
    lib = kernels.load("dense_agg")
    rc = lib.dense_agg_update(
        d.data_ptr(), _opt_ptr(v), d.element_size(), nres, P(res),
        P(res_valid), kernels.int_array(res_elem),
        kernels.int_array([int(f) for f in acc.res_f64]), len(ch), P(ch),
        P(ch_valid), kernels.int_array(ch_op), kernels.int_array(ch_f64),
        _opt_ptr(active), n, acc.kmin, acc.D, P([a.data_ptr() for a in acc.acc]),
        acc.present.data_ptr(), P([acc.vmin[i].data_ptr() for i in range(nres)]),
        P([acc.vmax[i].data_ptr() for i in range(nres)]),
        P([acc.vdmin[i].data_ptr() for i in range(nres)]),
        P([acc.vdmax[i].data_ptr() for i in range(nres)]), acc.cap,
        acc.ocount.data_ptr(), acc.obounds.data_ptr(), acc.okey.data_ptr(),
        P([acc.ores[i].data_ptr() for i in range(nres)]),
        P([acc.ores_valid[i].data_ptr() for i in range(nres)]),
        P([None if op == "count" else acc.och[j].data_ptr()
           for j, (op, _) in enumerate(acc.channels)]),
        P([acc.och_valid[j].data_ptr() for j in range(len(acc.channels))]),
        P([_opt_ptr(w) for w in acc.fx]),
        torch.cuda.current_stream(d.device).cuda_stream)
    kernels.check_launch(lib, "dense_agg_update", rc)
    dense_agg_update.launches += 1


dense_agg_update.launches = 0


def dense_agg_check_plain(acc: DenseAccumulator) -> torch.Tensor:
    """Plain PyTorch version of ``dense_agg_check``."""
    present = acc.present.bool()
    bad = torch.zeros_like(present)
    for i in range(acc.nres):
        has = acc.vdmax[i] == 1
        same = acc.vmin[i] == acc.vmax[i]
        if acc.res_f64[i]:  # -0.0 (image -1) and +0.0 (image 0) are equal
            same |= (acc.vmin[i] == -1) & (acc.vmax[i] == 0)
        bad |= has & ((acc.vdmin[i] == 0) | ~same)
    return torch.stack([(present & bad).any().to(torch.int64),
                        present.sum()])


def dense_agg_check(acc: DenseAccumulator) -> torch.Tensor:
    """Launch ``dense_agg_check`` of ``csrc/dense_agg.cu``."""
    out = torch.zeros(2, dtype=torch.int64, device=acc.device)
    nres = acc.nres
    P = kernels.pointer_array
    lib = kernels.load("dense_agg")
    rc = lib.dense_agg_check(
        nres, P([acc.vmin[i].data_ptr() for i in range(nres)]),
        P([acc.vmax[i].data_ptr() for i in range(nres)]),
        P([acc.vdmin[i].data_ptr() for i in range(nres)]),
        P([acc.vdmax[i].data_ptr() for i in range(nres)]),
        kernels.int_array([int(f) for f in acc.res_f64]),
        acc.present.data_ptr(), acc.S, out.data_ptr(),
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
HA_READY = 2                # csrc/hash_agg.cu HA_READY
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


class HashAccumulator:
    """The per-query state of the hash aggregation: one table that every
    batch adds into.

    ``channels`` holds (op, is_f64) per contribution, op in
    sum/min/max/count and first/last/first_valid/last_valid (whose value
    columns are float64 or int64 words, with one auxiliary int64 word per
    slot, ``csrc/hash_agg.cu``).  ``update`` takes each batch's int64 key
    words with
    their validity (:func:`key_word`), its contributions and its live
    mask.  The host keeps an upper bound on the number of groups (the rows
    added so far, or ``key_bound`` when the keys' domain is smaller); the
    table grows only when that bound could pass ``HA_LOAD`` of its slots,
    and then one fetch reads the exact group count first.  ``finish``
    returns the groups: a large table compacted after one more fetch of
    their count, a small one under its live mask.

    On a CUDA device the table is open addressing over ``cap`` slots
    (``csrc/hash_agg.cu``); on the CPU, or with ``plain=True`` on either
    device, the plain version keeps the groups dense
    (``hash_agg_update_plain``), with the same growth decisions and
    fetches.  ``collide`` sends every key to one bucket (a test of the
    kernel's probing)."""

    def __init__(self, nkeys: int, channels: Sequence[Tuple[str, bool]],
                 device, key_bound: Optional[int] = None,
                 collide: bool = False, plain: Optional[bool] = None):
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
        self.ngroups = torch.zeros(1, dtype=torch.int64, device=self.device)

    def _limit_bound(self, n: int) -> int:
        return n if self.key_bound is None else min(n, self.key_bound)

    def _alloc(self, cap: int):
        """(state, keys, nulls, accumulators, auxiliary words) of a table
        of ``cap`` slots: a FIRST word starts at INT64_MAX, a LAST word at
        -1; the plain version keeps its groups dense, with 0/1 "has"
        words."""
        dev = self.device
        n = cap if self.kernel else 0
        acc, aux = [], []
        for op, is_f64 in self.channels:
            init = _ha_init(op, is_f64)
            dtype = torch.float64 if is_f64 and (
                op == "sum" or op in ORDERED_OPS) else torch.int64
            acc.append(torch.full((n,), init, dtype=dtype, device=dev))
            if op not in ORDERED_OPS:
                aux.append(None)
                continue
            start = 0 if not self.kernel else (
                _I64_MAX if op.startswith("first") else -1)
            aux.append(torch.full((n,), start, dtype=torch.int64,
                                  device=dev))
        if not self.kernel:  # the plain version keeps the groups dense
            return (None, torch.empty((self.nkeys, 0), dtype=torch.int64,
                                      device=dev),
                    torch.empty(0, dtype=torch.int32, device=dev), acc, aux)
        return (torch.zeros(cap, dtype=torch.int32, device=dev),
                torch.empty((self.nkeys, cap), dtype=torch.int64, device=dev),
                torch.empty(cap, dtype=torch.int32, device=dev), acc, aux)

    def _fixed_point(self, cap: int):
        """The [cap, 3] fixed-point words of each float64 sum channel
        (None for the others)."""
        return [torch.zeros((cap, 3), dtype=torch.int64, device=self.device)
                if self.kernel and is_f64 and op == "sum" else None
                for op, is_f64 in self.channels]

    @staticmethod
    def _slots_for(groups: int) -> int:
        need = max(HA_MIN_SLOTS, int(groups / HA_LOAD))
        return 1 << (need - 1).bit_length()

    def _reserve(self, n: int) -> None:
        """Make room for ``n`` more rows' groups: fetch the exact count and
        grow only when the host's bound says the table could fill."""
        if self.cap == 0:
            self.cap = self._slots_for(self._limit_bound(2 * n))
            self.state, self.keys, self.nulls, self.acc, self.aux = \
                self._alloc(self.cap)
            self.fx = self._fixed_point(self.cap)
            return
        limit = int(self.cap * HA_LOAD)
        if self._limit_bound(self.bound + n) <= limit:
            return
        from ..utils.metrics import fetch
        self.bound = int(fetch(self.ngroups)[0])
        if self._limit_bound(self.bound + n) <= limit:
            return
        self.growths += 1
        self._grow(self._slots_for(self._limit_bound(2 * (self.bound + n))))

    def _grow(self, cap: int) -> None:
        old = (self.state, self.keys, self.nulls, self.acc, self.aux,
               self.cap)
        new = self._alloc(cap)
        if self.kernel:
            hash_agg_rehash(self, old, new, cap)
            self.state, self.keys, self.nulls, self.acc, self.aux = new
            self.fx = self._fixed_point(cap)
        self.cap = cap

    def update(self, words: Sequence[Value],
               contributions: Sequence[Value],
               active: Optional[torch.Tensor], n: int) -> None:
        """Adds one batch of ``n`` rows (in place)."""
        if len(words) != self.nkeys or len(contributions) != len(
                self.channels):
            raise ValueError("keys/contributions do not match the "
                             "accumulator's layout")
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
        """Does :meth:`finish` compact (and so need the group count)?"""
        return self.cap > HA_COMPACT_SLOTS

    def merge(self, words: Sequence[Value], buffers: Sequence[Value],
              active: Optional[torch.Tensor], n: int) -> None:
        """Adds one batch of ``n`` partial-aggregation buffer rows (in
        place): each channel's op is its buffer's merge op
        (:func:`merge_op`) and each buffer's validity its mask (a FIRST or
        LAST buffer's: its ``has`` flag)."""
        if len(words) != self.nkeys or len(buffers) != len(self.channels):
            raise ValueError("keys/buffers do not match the accumulator's "
                             "layout")
        self._reserve(n)
        self.calls += 1
        words = [(_column(d, n), _column(v, n)) for d, v in words]
        buffers = [(_column(d, n), _column(v, n)) for d, v in buffers]
        run = hash_agg_merge if self.kernel else hash_agg_merge_plain
        run(self, words, buffers, active, n)
        self.bound = self._limit_bound(self.bound + n)

    def finish(self, groups: Optional[int] = None, compact: bool = True):
        """(per key its int64 words and validity; per channel its values —
        float64 min/max decoded from their images, FIRST/LAST as
        (value, has) pairs; the live mask or None), every list in one slot
        order.  A table of more than
        ``HA_COMPACT_SLOTS`` slots is compacted to its groups after one
        fetch of their count (or to ``groups``, when the caller read the
        count in a fetch of its own); a smaller one, or any with
        ``compact=False``, comes back whole under its live mask, with no
        fetch.  The plain version's groups are
        dense already; it makes the same fetch, so counts agree."""
        from ..utils.metrics import fetch
        if self.cap == 0:
            self._reserve(0)
        if not compact or not self.needs_count():
            groups = None
        elif groups is None:
            groups = int(fetch(self.ngroups)[0])
        live = None
        words, nulls, acc = list(self.keys), self.nulls, self.acc
        has = [x for x in self.aux if x is not None]
        if self.kernel and groups is None:
            live = self.state == HA_READY
        elif self.kernel:
            from .batch_utils import compact_columns
            cols = [(w, None) for w in words] + [(nulls, None)] \
                + [(a, None) for a in acc] + [(x, None) for x in has]
            packed = [d for d, _ in compact_columns(
                cols, self.state == HA_READY, groups)]
            k = self.nkeys + 1 + len(acc)
            words, nulls, acc, has = (packed[:self.nkeys], packed[self.nkeys],
                                      packed[self.nkeys + 1:k], packed[k:])
        keys = [(w, (nulls >> i) & 1 == 0) for i, w in enumerate(words)]
        values = []
        has = iter(has)
        for (op, is_f64), a in zip(self.channels, acc):
            if op in ORDERED_OPS:
                x = next(has)
                if not self.kernel:
                    filled = x != 0
                elif op.startswith("first"):
                    filled = x == _I64_MIN
                else:
                    filled = x >= 0
                values.append((a, filled))
            else:
                values.append(f64_from_image(a) if is_f64 and op != "sum"
                              else a)
        return keys, values, live


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


def _ha_launch(acc: HashAccumulator, words, contributions, active, n: int,
               entry: str) -> None:
    """One ``csrc/hash_agg.cu`` update or merge launch after the checks."""
    if active is not None:
        _check_column(active, n, (torch.bool,), "active")
    for d, v in words:
        _check_column(d, n, (torch.int64,), "key word")
        if v is not None:
            _check_column(v, n, (torch.bool,), "key valid")
    data, valid, ops, f64 = [], [], [], []
    for (d, v), (op, is_f64) in zip(contributions, acc.channels):
        if op == "count":
            if d is not None:
                raise ValueError("a count channel takes no data")
        else:
            _check_column(d, n, (torch.float64 if is_f64 else torch.int64,),
                          "contribution")
        if v is not None:
            _check_column(v, n, (torch.bool,), "contribution valid")
        data.append(_opt_ptr(d))
        valid.append(_opt_ptr(v))
        ops.append(_HA_OP[kernel_op(op, None)[0]])
        f64.append(int(is_f64))
    if n == 0:
        return
    per_row = any(x is not None for x in acc.aux) \
        or any(x is not None for x in acc.fx)
    rslot = torch.empty(n if per_row else 0, dtype=torch.int64,
                        device=acc.device)
    P = kernels.pointer_array
    lib = kernels.load("hash_agg")
    rc = getattr(lib, entry)(
        acc.nkeys, P([d.data_ptr() for d, _ in words]),
        P([_opt_ptr(v) for _, v in words]), len(acc.channels), P(data),
        P(valid), kernels.int_array(ops), kernels.int_array(f64),
        P([a.data_ptr() for a in acc.acc]), P([_opt_ptr(x) for x in acc.aux]),
        P([_opt_ptr(x) for x in acc.fx]), _opt_ptr(active), n,
        acc.state.data_ptr(), acc.keys.data_ptr(), acc.nulls.data_ptr(),
        acc.cap, int(acc.collide), acc.ngroups.data_ptr(),
        rslot.data_ptr() if per_row else None, acc.calls,
        torch.cuda.current_stream(acc.device).cuda_stream)
    kernels.check_launch(lib, entry, rc)


def hash_agg_update(acc: HashAccumulator, words, contributions, active,
                    n: int) -> None:
    """Launch ``hash_agg_update`` of ``csrc/hash_agg.cu``."""
    _ha_launch(acc, words, contributions, active, n, "hash_agg_update")
    if n == 0:
        return
    hash_agg_update.launches += 1
    if any(x is not None for x in acc.aux):
        hash_agg_update.ordered_launches += 1


hash_agg_update.launches = 0
hash_agg_update.ordered_launches = 0  # the launches that pick FIRST/LAST


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
    """Launch ``hash_agg_merge`` of ``csrc/hash_agg.cu``."""
    if any(op == "count" for op, _ in acc.channels):
        raise ValueError("a merge takes no count channel")
    _ha_launch(acc, words, buffers, active, n, "hash_agg_merge")
    if n:
        hash_agg_merge.launches += 1


hash_agg_merge.launches = 0


# ---------------------------------------------------------------------------------
# The partial aggregate's skip probe: distinct and live sampled key hashes
# ---------------------------------------------------------------------------------

GR_MAX_ROWS = 1 << 18       # csrc/group_ratio.cu GR_MAX_ROWS
GR_SLOTS = 1 << 19          # csrc/group_ratio.cu GR_SLOTS


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


def group_ratio_kernel(h: torch.Tensor, active: Optional[torch.Tensor]
                       ) -> torch.Tensor:
    """Launch ``group_ratio`` of ``csrc/group_ratio.cu``: int64 [2]
    (distinct hashes, live rows) of at most ``GR_MAX_ROWS`` rows."""
    n = h.shape[0]
    if n > GR_MAX_ROWS:
        raise ValueError(f"group_ratio takes at most {GR_MAX_ROWS} rows")
    _check_column(h, n, (torch.int64,), "hashes")
    if active is not None:
        _check_column(active, n, (torch.bool,), "active")
    out = torch.zeros(2, dtype=torch.int64, device=h.device)
    if n == 0:
        return out
    table = torch.full((GR_SLOTS,), -1, dtype=torch.int64, device=h.device)
    lib = kernels.load("group_ratio")
    rc = lib.group_ratio(h.data_ptr(), _opt_ptr(active), n,
                         table.data_ptr(), out.data_ptr(),
                         torch.cuda.current_stream(h.device).cuda_stream)
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


def hash_agg_rehash(acc: HashAccumulator, old, new, new_cap: int) -> None:
    """Launch ``hash_agg_rehash`` of ``csrc/hash_agg.cu``: every group of
    the ``old`` table (state, keys, nulls, accumulators, cap) into the
    empty ``new`` one of ``new_cap`` slots."""
    o_state, o_keys, o_nulls, o_acc, o_aux, o_cap = old
    n_state, n_keys, n_nulls, n_acc, n_aux = new
    P = kernels.pointer_array
    lib = kernels.load("hash_agg")
    rc = lib.hash_agg_rehash(
        acc.nkeys, len(acc.channels), o_state.data_ptr(), o_keys.data_ptr(),
        o_nulls.data_ptr(), o_cap, P([a.data_ptr() for a in o_acc]),
        P([_opt_ptr(x) for x in o_aux]), n_state.data_ptr(),
        n_keys.data_ptr(), n_nulls.data_ptr(), new_cap,
        P([a.data_ptr() for a in n_acc]), P([_opt_ptr(x) for x in n_aux]),
        int(acc.collide), torch.cuda.current_stream(acc.device).cuda_stream)
    kernels.check_launch(lib, "hash_agg_rehash", rc)
    hash_agg_rehash.launches += 1


hash_agg_rehash.launches = 0
