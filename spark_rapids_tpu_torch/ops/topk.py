"""Top-k rows of a batch under a stable multi-key ORDER BY.

Counterpart of the key encoding of ``spark_rapids_tpu/ops/groupby.py``
(``sortable_view`` :43, ``sort_indices_for_keys`` :82) as
``spark_rapids_tpu/plan/exec_nodes.py:236 TopKExec`` uses it: a stable
lexsort whose first k live rows are kept.  ``topk_indices`` returns those
rows' indices; on CUDA tensors it launches ``csrc/topk.cu`` (or raises), on
CPU tensors it runs the plain version, a stable sort of the same words.

Order: per key, a null word when the key has a validity mask (nulls first:
null 0, valid 1; nulls last: the reverse), then the value word —
integers as they are, floats as ``sortable_view`` maps them (-0.0 equal to
+0.0, NaN above every number), a descending key complemented.  Ties keep
input order.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from .. import kernels

__all__ = ["TK_MAX_K", "TK_MAX_KEYS", "SortKey", "sortable_view",
           "sort_words", "topk_indices", "topk", "topk_plain"]

TK_CHUNK = 2048             # csrc/topk.cu TK_CHUNK
TK_MAX_K = TK_CHUNK // 2
TK_MAX_KEYS = 4             # csrc/topk.cu TK_MAX_KEYS
_KIND = {torch.int32: 0, torch.int64: 1, torch.float64: 2, torch.float32: 3,
         torch.bool: 4}
_I64_MAX = torch.iinfo(torch.int64).max

# (data, valid-or-None, ascending, nulls_first)
SortKey = Tuple[torch.Tensor, Optional[torch.Tensor], bool, bool]


def sortable_view(data: torch.Tensor) -> torch.Tensor:
    """int64 image of a column, monotonic in its sort order: floats as
    sign-flipped bit patterns with -0.0 folded into +0.0 and every NaN at
    the top, booleans as 0/1, integers widened."""
    if data.dtype in (torch.float64, torch.float32):
        ibits, imin, imax = ((torch.int64, torch.iinfo(torch.int64).min,
                              _I64_MAX) if data.dtype == torch.float64 else
                             (torch.int32, torch.iinfo(torch.int32).min,
                              torch.iinfo(torch.int32).max))
        z = torch.where(data == 0, torch.zeros_like(data), data)
        bits = z.view(ibits).to(torch.int64)
        view = torch.where(bits < 0, imin - bits, bits)
        return torch.where(torch.isnan(data), imax, view)
    return data.to(torch.int64)


def sort_words(keys: Sequence[SortKey]) -> List[torch.Tensor]:
    """The int64 words a row is ordered by, most significant first."""
    words = []
    for data, valid, ascending, nulls_first in keys:
        if valid is not None:
            v = valid.to(torch.int64)
            words.append(v if nulls_first else 1 - v)
        view = sortable_view(data)
        words.append(view if ascending else ~view)
    return words


def _column(x: torch.Tensor, n: int) -> torch.Tensor:
    return (x.expand(n) if x.dim() == 0 else x).contiguous()


def topk_indices(keys: Sequence[SortKey], active: Optional[torch.Tensor],
                 n: int, k: int) -> torch.Tensor:
    """int64 [k]: the indices of the first k live rows of ``n`` in key
    order (ties in row order), -1 past the last live row."""
    if not 1 <= k <= TK_MAX_K:
        raise NotImplementedError(
            f"a top-k of {k} rows is past the top-k kernel's {TK_MAX_K} "
            f"(ROADMAP.md queue 2 row 8); the planner runs such a LIMIT "
            f"over the full sort (row 8′)")
    keys = [(_column(d, n), None if v is None else _column(v, n), a, nf)
            for d, v, a, nf in keys]
    run = topk if keys[0][0].is_cuda else topk_plain
    return run(keys, active, n, k)


def topk_plain(keys, active, n: int, k: int) -> torch.Tensor:
    """Plain PyTorch version of ``csrc/topk.cu``: stable sorts from the
    least significant word up."""
    dev = keys[0][0].device
    order = torch.arange(n, device=dev)
    if active is not None:
        order = order[active]
    for w in reversed(sort_words(keys)):
        order = order[torch.sort(w[order], stable=True).indices]
    out = torch.full((k,), -1, dtype=torch.int64, device=dev)
    take = min(k, order.numel())
    out[:take] = order[:take]
    return out


def topk(keys, active, n: int, k: int) -> torch.Tensor:
    """Launch ``csrc/topk.cu`` on CUDA tensors (same arguments as
    :func:`topk_plain`)."""
    if not 1 <= len(keys) <= TK_MAX_KEYS:
        raise ValueError(f"the top-k kernel takes 1..{TK_MAX_KEYS} keys, "
                         f"got {len(keys)}")
    dev = keys[0][0].device
    for t in [active] + [x for d, v, _, _ in keys for x in (d, v)]:
        if t is None:
            continue
        if t.shape != (n,) or not t.is_cuda or not t.is_contiguous():
            raise ValueError(f"top-k inputs must be contiguous CUDA [{n}] "
                             f"tensors, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    for d, v, _, _ in keys:
        if d.dtype not in _KIND or (v is not None and v.dtype != torch.bool):
            raise ValueError(f"top-k key of type {d.dtype} is not supported")
    if active is not None and active.dtype != torch.bool:
        raise ValueError("active must be bool")
    nwords = sum(2 if v is not None else 1 for _, v, _, _ in keys)
    blocks = max(1, -(-n // TK_CHUNK))
    scratch = torch.empty(2 * blocks * k * (nwords + 1), dtype=torch.int64,
                          device=dev)
    out = torch.empty(k, dtype=torch.int64, device=dev)
    lib = kernels.load("topk")
    rc = lib.topk(
        len(keys), kernels.pointer_array([d.data_ptr() for d, _, _, _ in keys]),
        kernels.pointer_array([None if v is None else v.data_ptr()
                               for _, v, _, _ in keys]),
        kernels.int_array([_KIND[d.dtype] for d, _, _, _ in keys]),
        kernels.int_array([int(not a) for _, _, a, _ in keys]),
        kernels.int_array([int(nf) for _, _, _, nf in keys]),
        None if active is None else active.data_ptr(), n, k,
        scratch.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    kernels.check_launch(lib, "topk", rc)
    topk.launches += 1
    return out


topk.launches = 0
