#!/usr/bin/env python3
"""Device times of the runtime-filter statistics and the final aggregate's
merge of one checkout of the port, for comparing two checkouts on one
CUDA card.

    python3 tools/kernel_ab.py [--root DIR] [--label NAME]

Imports ``spark_rapids_tpu_torch`` from ``--root`` (default: this
checkout), so one command can time two checkouts in turns on one card
(parent, change, change, parent), each building its kernels from its own
``csrc/``.  Times, as ``chip_smoke.py`` times them (calls queued behind a
spin kernel between one pair of CUDA events, inputs past twice the L2;
the bucket sequence one event pair a sequence, its host work included):

  * ``key_stats`` over 15,000,000 int64 keys with 0.05% of the rows live
    (Q18's runtime-filter build at SF10) and with every row live (a
    sort-merge join's filter), vcap 16,384;
  * the merge of 4,194,304 float64 sum buffer rows keyed by 15,000,000
    order keys (about 3,660,000 groups; Q18's final at SF10) in one call,
    and as 64 buckets by key % 64 (a re-partitioned final), each merged,
    finished and, where the checkout has a merge pool, released.

Prints one JSON line per measurement, in ms, with the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys
from pathlib import Path

import numpy as np


def time_ms(torch, calls, reps: int) -> float:
    """Device time per call, the calls queued behind a spin kernel."""
    for fn in calls:
        fn()
    torch.cuda.synchronize()
    cycles = 1 << 24
    while True:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for r in range(reps):
            calls[r % len(calls)]()
        queued = not start.query()
        end.record()
        end.synchronize()
        if queued:
            return start.elapsed_time(end) / reps
        cycles <<= 2
        if cycles > 1 << 32:
            raise RuntimeError("the timed calls could not be queued ahead "
                               "of the device")


def time_ms_synced(torch, fn, reps: int) -> float:
    """Device time per call, each call between its own pair of events (a
    call that waits on the device, or whose host work between launches is
    part of its cost)."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve()
                                          .parent.parent))
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    sys.path.insert(0, args.root)
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    from spark_rapids_tpu_torch.ops import groupby
    from spark_rapids_tpu_torch.ops import runtime_filter as rf
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    rng = np.random.default_rng(18)

    def emit(what, ms, **extra):
        print(json.dumps({"label": args.label, "root": args.root,
                          "what": what, "ms": ms, **extra,
                          "device": smi}), flush=True)

    n, vcap = 15_000_000, rf.in_list_capacity(10_000)
    keys = torch.from_numpy(rng.permutation(
        np.arange(1, 4 * n + 1, 4, dtype=np.int64))).to(dev)
    live = torch.from_numpy(rng.random(n) < 0.0005).to(dev)
    copies = [(keys, live), (keys.clone(), live.clone())]
    for what, act in (("key_stats_q18", True), ("key_stats_all_live",
                                                 False)):
        got = rf.key_stats(keys, None, live if act else None, vcap)
        want = rf.key_stats_plain(keys, None, live if act else None, vcap)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            print(f"kernel_ab: {what} differs from plain", file=sys.stderr)
            return 1
        emit(what, time_ms(torch, [
            lambda k=k, a=a: rf.key_stats(k, None, a if act else None, vcap)
            for k, a in copies], reps=8), live_keys=int(got[2]))
    del keys, live, copies

    m = 4 << 20
    okeys = torch.from_numpy(rng.integers(1, n + 1, m)).to(dev)
    qty = torch.from_numpy(rng.integers(1, 51, m).astype(np.float64)).to(dev)
    pooled = "pool" in inspect.signature(groupby.HashAccumulator).parameters
    pool = groupby.MergePool(dev) if pooled else None

    def merge(w, q, rows, finish):
        kw = {"pool": pool} if pooled else {}
        acc = groupby.HashAccumulator(1, [("sum", True)], dev, **kw)
        acc.merge([(w, None)], [(q, None)], None, rows)
        if finish:
            acc.finish()
        if pooled:
            acc.release()
        return acc
    acc = groupby.HashAccumulator(1, [("sum", True)], dev)
    acc.merge([(okeys, None)], [(qty, None)], None, m)
    groups = int(acc.ngroups[0])
    if pooled:
        acc.release()
    emit("merge_one_call", time_ms(torch, [lambda: merge(okeys, qty, m,
                                                         False)], reps=8),
         rows=m, groups=groups, pooled=pooled)
    bucket = okeys % 64
    order = torch.argsort(bucket, stable=True)
    sizes = torch.bincount(bucket, minlength=64).tolist()
    sk, sq = okeys[order], qty[order]
    pieces, lo = [], 0
    for size in sizes:
        pieces.append((sk[lo:lo + size], sq[lo:lo + size], size))
        lo += size

    def sequence():
        for w, q, rows in pieces:
            merge(w, q, rows, True)
    emit("merge_64_buckets", time_ms_synced(torch, sequence, reps=4),
         rows=m, groups=groups, pooled=pooled)
    return 0


if __name__ == "__main__":
    sys.exit(main())
