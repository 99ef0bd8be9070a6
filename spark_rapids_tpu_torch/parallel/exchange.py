"""The mesh exchange: hash-partition rows across the devices of a mesh
(``spark_rapids_tpu/parallel/exchange.py`` counterpart).

Every shard bucketizes its live rows by destination (Spark's pmod(murmur3,
n_devices)) into fixed-capacity send buckets, ``[n_parts, bucket_cap]`` per
column (``csrc/bucketize.cu``, its plain version here); the exchange then
hands shard *d* the buckets ``buckets[s][d]`` of every shard *s* with the
transposed counts, which is what ``lax.all_to_all`` did over the
reference's mesh.  The port's mesh is a list of ``torch.device``s run shard
by shard in one process, so the swap is ``copy_`` to the destination
device: a local copy when the shards share a card, a peer copy across
cards.  Bucket capacity is fixed per call; rows past it are DROPPED and
counted in ``overflow``, which the caller checks and retries with larger
buckets (``parallel/spmd.py``), never ignores.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from .. import kernels
from ..ops import groupby
from ..ops.hashing import spark_partition_id

__all__ = ["hash_ids", "bucketize", "bucketize_plain", "bucketize_kernel",
           "exchange", "exchange_grouped_agg", "BZ_MAX_COLS",
           "BZ_MAX_PARTS"]

Value = Tuple[torch.Tensor, Optional[torch.Tensor]]

BZ_MAX_COLS = 64        # csrc/bucketize.cu BZ_MAX_COLS
BZ_MAX_PARTS = 4096     # csrc/bucketize.cu BZ_MAX_PARTS
BZ_CHUNK = 1024         # csrc/bucketize.cu BZ_CHUNK


def hash_ids(keys: Sequence[Value], n_parts: int) -> torch.Tensor:
    """Partition id per row: Spark-exact pmod(murmur3(keys, 42), n)
    (``csrc/hashing.cu`` on the card)."""
    return spark_partition_id(keys, n_parts)


def bucketize_plain(pids: torch.Tensor, active: Optional[torch.Tensor],
                    n_parts: int, bucket_cap: int,
                    arrays: Sequence[torch.Tensor]):
    """Plain version of ``bucketize_kernel``: the reference's program, a
    stable argsort of the destinations and one scatter per column."""
    n = pids.shape[0]
    dev = pids.device
    pid_s = pids.to(torch.int64)
    if active is not None:
        pid_s = torch.where(active, pid_s, n_parts)
    perm = torch.argsort(pid_s, stable=True)
    s_pid = pid_s[perm]
    s_active = s_pid < n_parts
    counts = torch.bincount(s_pid[s_active], minlength=n_parts)[:n_parts]
    offsets = torch.cumsum(counts, 0) - counts
    within = torch.arange(n, device=dev) - offsets[s_pid.clamp(0,
                                                               n_parts - 1)]
    ok = s_active & (within < bucket_cap)
    overflow = (s_active & ~ok).sum()
    dst = (s_pid * bucket_cap + within)[ok]
    out = []
    for a in arrays:
        buf = torch.zeros(n_parts * bucket_cap, dtype=a.dtype, device=dev)
        buf[dst] = a[perm][ok]
        out.append(buf.reshape(n_parts, bucket_cap))
    sent = torch.minimum(counts, torch.tensor(bucket_cap, device=dev))
    return out, sent.to(torch.int32), overflow.to(torch.int64)


def bucketize_kernel(pids: torch.Tensor, active: Optional[torch.Tensor],
                     n_parts: int, bucket_cap: int,
                     arrays: Sequence[torch.Tensor]):
    """Launch ``bucketize`` of ``csrc/bucketize.cu``: (per array its
    ``[n_parts, bucket_cap]`` buckets, int32 [n_parts] sent counts, int64
    overflow count)."""
    n = pids.shape[0]
    if not 1 <= n_parts <= BZ_MAX_PARTS or len(arrays) > BZ_MAX_COLS:
        raise ValueError(f"bucketize takes 1..{BZ_MAX_PARTS} partitions and "
                         f"at most {BZ_MAX_COLS} arrays")
    for t, what in [(pids, "pids"), (active, "active")] \
            + [(a, "array") for a in arrays]:
        if t is None:
            continue
        if t.shape != (n,) or not t.is_contiguous() or not t.is_cuda \
                or t.element_size() not in (1, 2, 4, 8):
            raise ValueError(f"{what}: expected a contiguous CUDA [{n}] "
                             f"tensor, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    if pids.dtype != torch.int32 or (active is not None
                                     and active.dtype != torch.bool):
        raise ValueError("bucketize takes int32 pids and a bool mask")
    dev = pids.device
    out = [torch.zeros((n_parts, bucket_cap), dtype=a.dtype, device=dev)
           for a in arrays]
    nblocks = -(-n // BZ_CHUNK)
    counts = torch.empty(n_parts * max(nblocks, 1), dtype=torch.int32,
                         device=dev)
    sent = torch.empty(n_parts, dtype=torch.int32, device=dev)
    overflow = torch.zeros(1, dtype=torch.int64, device=dev)
    P = kernels.pointer_array
    lib = kernels.load("bucketize")
    rc = lib.bucketize(
        pids.data_ptr(), None if active is None else active.data_ptr(), n,
        n_parts, bucket_cap, len(arrays), P([a.data_ptr() for a in arrays]),
        P([o.data_ptr() for o in out]),
        kernels.int_array([a.element_size() for a in arrays]),
        counts.data_ptr(), sent.data_ptr(), overflow.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    kernels.check_launch(lib, "bucketize", rc)
    bucketize_kernel.launches += 1
    return out, sent, overflow[0]


bucketize_kernel.launches = 0


def bucketize(pids: torch.Tensor, active: Optional[torch.Tensor],
              n_parts: int, bucket_cap: int, arrays: Sequence[torch.Tensor]):
    """Scatter rows into ``[n_parts, bucket_cap]`` send buckets.

    Returns (bucketed arrays, int32 per-bucket counts, int64 overflow
    scalar).  Rows beyond a bucket's capacity are dropped and counted in
    ``overflow``; callers must check that it is zero."""
    pids = pids.to(torch.int32).contiguous()
    active = None if active is None else active.contiguous()
    arrays = [a.contiguous() for a in arrays]
    if pids.is_cuda:
        return bucketize_kernel(pids, active, n_parts, bucket_cap, arrays)
    return bucketize_plain(pids, active, n_parts, bucket_cap, arrays)


def exchange(bucketed: Sequence[Sequence[torch.Tensor]],
             sent: Sequence[torch.Tensor],
             devices: Sequence[torch.device]):
    """Swap the bucket axis across the mesh: ``bucketed[s][k]`` is shard
    *s*'s ``[n_dev, cap]`` buckets of array *k*; shard *d* receives, per
    array, the ``[n_dev * cap]`` concatenation of ``bucketed[s][k][d]``
    over every *s* (on ``devices[d]``), and the counts ``sent[s][d]``.
    Returns (received arrays per shard, received counts per shard)."""
    n_dev = len(devices)
    recv, recv_counts = [], []
    for d, dev in enumerate(devices):
        arrays = []
        for k in range(len(bucketed[0]) if bucketed else 0):
            cap = bucketed[0][k].shape[1]
            buf = torch.empty(n_dev * cap, dtype=bucketed[0][k].dtype,
                              device=dev)
            for s in range(n_dev):
                buf[s * cap:(s + 1) * cap].copy_(bucketed[s][k][d])
            arrays.append(buf)
        counts = torch.empty(n_dev, dtype=torch.int32, device=dev)
        for s in range(n_dev):
            counts[s:s + 1].copy_(sent[s][d:d + 1])
        recv.append(arrays)
        recv_counts.append(counts)
    return recv, recv_counts


def received_active(recv_counts: torch.Tensor, bucket_cap: int
                    ) -> torch.Tensor:
    """The live mask of a shard's received ``[n_dev * cap]`` rows: lane j
    of source s is live below that source's count."""
    lane = torch.arange(bucket_cap, dtype=torch.int32,
                        device=recv_counts.device)
    return (lane[None, :] < recv_counts[:, None]).reshape(-1)


def _flat(values: Sequence[Value]) -> List[torch.Tensor]:
    """(data, validity) of each column, a missing validity as all True."""
    out = []
    for d, v in values:
        out += [d, torch.ones_like(d, dtype=torch.bool) if v is None else v]
    return out


def exchange_grouped_agg(shards, key_dtypes: Sequence[torch.dtype],
                         channels: Sequence[Tuple[str, bool]],
                         devices: Sequence[torch.device], bucket_cap: int):
    """One distributed group-by step over the mesh: per shard a local
    partial aggregation (``hash_agg.cu``), partition ids over the partial
    keys, bucketize, the exchange, and per shard the re-reduction of what
    it received with the merge ops (the reference's
    ``exchange_grouped_agg`` :82).

    ``shards``: per device (key values [(data, valid)], contributions
    [(data, valid)], a count's data None; live mask; rows).
    ``key_dtypes``: each key's dtype.  ``channels``: (op, is_f64) per
    contribution, as ``groupby.HashAccumulator`` takes them.  Returns
    (per shard (keys [(data, valid)] in their dtypes, values, live mask or
    None) of the groups whose hash range it holds; per shard its int64
    overflow count, on its device)."""
    n_dev = len(devices)
    nk = len(key_dtypes)
    parts, sent, overflow = [], [], []
    for (keys, contribs, active, n), dev in zip(shards, devices):
        acc = groupby.HashAccumulator(nk, channels, dev)
        acc.update([(groupby.key_word(d), v) for d, v in keys], contribs,
                   active, n)
        words, values, live = acc.finish()
        keys = [(groupby.key_from_word(w, dt), v)
                for (w, v), dt in zip(words, key_dtypes)]
        bufs = [v if isinstance(v, tuple) else (v, None) for v in values]
        g = keys[0][0].shape[0]
        live = torch.ones(g, dtype=torch.bool, device=dev) if live is None \
            else live
        b, s, o = bucketize(hash_ids(keys, n_dev), live, n_dev, bucket_cap,
                            _flat(keys) + _flat(bufs))
        parts.append(b)
        sent.append(s)
        overflow.append(o)
    recv, recv_counts = exchange(parts, sent, devices)
    merge = [(groupby.merge_op(op), f) for op, f in channels]
    out = []
    for arrays, counts, dev in zip(recv, recv_counts, devices):
        active = received_active(counts, bucket_cap)
        pairs = [(arrays[i], arrays[i + 1]) for i in range(0, len(arrays), 2)]
        acc = groupby.HashAccumulator(nk, merge, dev)
        acc.merge([(groupby.key_word(d), v) for d, v in pairs[:nk]],
                  pairs[nk:], active, active.shape[0])
        words, values, live = acc.finish()
        out.append(([(groupby.key_from_word(w, dt), v)
                     for (w, v), dt in zip(words, key_dtypes)], values, live))
    return out, overflow
