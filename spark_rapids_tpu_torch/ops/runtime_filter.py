"""Build-key statistics of the runtime join filters (row 15 of the kernel
list).

The reference computes them in two jitted programs: the sort-merge join's
runtime filter (``spark_rapids_tpu/plan/join_exec.py:161
_inject_smj_filter``, stats :196-211, values :223-235) and the broadcast
join's dense prefetch (``:1200 _dense_prefetch``, :1265-1287) that feeds
dynamic partition pruning (``:1522 _inject_dpp``).  Over the live, valid
keys of one build batch, widened to int64, with every other row as
``BIG = INT64_MAX``, both sort and read: the minimum (BIG when there is no
valid key), the maximum (-BIG), the valid count, the duplicate count
(adjacent equal sorted keys below BIG) and the ascending distinct keys
below BIG, the first ``vcap`` of them, padded with BIG.

:func:`key_stats` returns them as one int64 tensor ``[HEADER + vcap]``:
``kmin, kmax, n_valid, dup, n_distinct`` (the distinct keys below BIG),
then the keys.  On CUDA tensors it launches ``csrc/key_stats.cu`` (the
sort is ``csrc/sort.cu``'s radix ``sort_perm``) or raises; on CPU tensors
it runs the plain PyTorch version, :func:`key_stats_plain`.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import kernels
from . import sort

__all__ = ["BIG", "HEADER", "in_list_capacity", "key_stats",
           "key_stats_plain", "key_stats_kernel"]

BIG = (1 << 63) - 1
HEADER = 5


def in_list_capacity(max_in_keys: int) -> int:
    """``vcap``: the reference's ``bucket_capacity(maxInKeys + 1)``, the
    power of two at or above it (at least 1,024); the +1 tells a prefix
    cut at exactly ``maxInKeys`` from a complete set of that size."""
    n = max(int(max_in_keys) + 1, 1024)
    return 1 << (n - 1).bit_length()


def key_stats(key: torch.Tensor, valid: Optional[torch.Tensor],
              active: Optional[torch.Tensor], vcap: int) -> torch.Tensor:
    """int64 ``[HEADER + vcap]``: the stats and distinct prefix of the
    int32 or int64 ``key`` over its rows that ``valid`` and ``active``
    (bool masks, None: all) keep."""
    run = key_stats_kernel if key.is_cuda else key_stats_plain
    return run(key, valid, active, vcap)


def key_stats_plain(key, valid, active, vcap: int) -> torch.Tensor:
    """Plain PyTorch version of ``csrc/key_stats.cu``: the reference's
    formulas over the BIG-filled sort."""
    dev = key.device
    d64 = key.to(torch.int64)
    ok = torch.ones(key.shape[0], dtype=torch.bool, device=dev)
    for m in (valid, active):
        if m is not None:
            ok = ok & m
    big = torch.tensor(BIG, dtype=torch.int64, device=dev)
    s = torch.sort(torch.where(ok, d64, big)).values
    head = torch.stack([
        torch.where(ok, d64, big).min() if len(s) else big,
        torch.where(ok, d64, -big).max() if len(s) else -big,
        ok.sum(),
        ((s[1:] == s[:-1]) & (s[1:] != big)).sum(),
        torch.zeros((), dtype=torch.int64, device=dev)])
    first = torch.ones_like(s, dtype=torch.bool)
    first[1:] = s[1:] != s[:-1]
    first &= s != big
    head[4] = first.sum()
    vals = torch.full((vcap,), BIG, dtype=torch.int64, device=dev)
    u = s[first][:vcap]
    vals[:len(u)] = u
    return torch.cat([head.to(torch.int64), vals])


def key_stats_kernel(key, valid, active, vcap: int) -> torch.Tensor:
    """Launch ``csrc/key_stats.cu`` around ``sort.cu``'s ``sort_perm``."""
    n = key.shape[0]
    if key.dtype not in (torch.int32, torch.int64) or not key.is_cuda \
            or not key.is_contiguous() or key.dim() != 1:
        raise ValueError("key_stats takes a contiguous CUDA int32 or int64 "
                         "[n] key")
    for m, what in ((valid, "valid"), (active, "active")):
        if m is not None and (m.dtype != torch.bool or m.shape != (n,)
                              or not m.is_cuda or not m.is_contiguous()):
            raise ValueError(f"{what} must be a contiguous CUDA bool [n] "
                             f"mask")
    if vcap < 1:
        raise ValueError("vcap must be positive")
    dev = key.device
    out = torch.empty(HEADER + vcap, dtype=torch.int64, device=dev)
    word = torch.empty(n, dtype=torch.int64, device=dev)
    ok = torch.empty(n, dtype=torch.bool, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = kernels.load("key_stats")
    rc = lib.ks_prepare(key.data_ptr(), key.element_size(),
                        None if valid is None else valid.data_ptr(),
                        None if active is None else active.data_ptr(), n,
                        word.data_ptr(), ok.data_ptr(), out.data_ptr(),
                        vcap, stream)
    kernels.check_launch(lib, "ks_prepare", rc)
    if n:
        perm = sort.sort_perm([(word, 8)], ok, n)
        tiles = torch.empty(2 * (-(-n // 1024)), dtype=torch.int64,
                            device=dev)
        rc = lib.ks_distinct(word.data_ptr(), perm.data_ptr(), n,
                             out.data_ptr(), vcap, tiles.data_ptr(), stream)
        kernels.check_launch(lib, "ks_distinct", rc)
    key_stats_kernel.launches += 1
    return out


key_stats_kernel.launches = 0
