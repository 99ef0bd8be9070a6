#!/usr/bin/env python3
"""Device times of kernels of one checkout of the port (the
runtime-filter statistics, the final aggregate's merge, the full sort,
the sorted join, the top-k, the dense update, the ungrouped reduction and
the CSR join with the partition placement), for comparing two checkouts
on one CUDA card.

    python3 tools/kernel_ab.py [--root DIR] [--label NAME] \
        [--only key_stats,merge,sort,sort_join,topk,dense_agg,
                masked_reduce,csr_join]

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
    finished and, where the checkout has a merge pool, released;
  * ``sort`` at one S1 run's shape: 4,194,304 rows drawn as SF10's
    lineitem draws them (ship date, price, order key, part key, supplier
    key, discount), sorted by ship date, price descending and order key,
    the 6 columns gathered (images, permutation, gather), beside the
    chained ``torch.sort(stable=True)`` yardstick queued alike;
  * ``sort_join`` at one Q10-shuffled partition pair's shape: a build of
    2,500,000 order keys drawn from 15,000,000, an inner probe of 71,700
    distinct ones, the build alone too, beside ``torch.sort(stable=True)``
    + 2 ``torch.searchsorted``;
  * ``topk`` at Q3's shape (1,287,275 rows, ORDER BY a float64 revenue
    with a validity mask DESC, an int32 date), k = 10 and k = 100, over
    random input, input already in that order and reversed, queued and
    one call per event pair, beside ``torch.topk`` of the revenue key's
    image (which waits on the device: one call per event pair);
  * ``dense_agg`` (the update) at Q3's shape (4,194,304 rows, 5.2% live,
    into 15,003,036 slots: an int32 and an int64 residual, a float64 sum
    and a count) and at Q10's (765,000 rows into 1,500,000 slots: an int32
    and a float64 residual, a float64 sum), each into an accumulator that
    has seen one call, beside their PyTorch yardsticks (``index_add_`` of
    the sums; the same with ``scatter_reduce_`` of the residuals and
    ``index_fill_`` of the presence at Q10's);
  * ``masked_reduce`` at Q6's shape (4,194,304 rows, 2% live, a float64
    sum and a count) and at F1u's (5 FIRST/LAST columns, 203,181 of
    4,194,304 rows live, two with a validity mask), each beside its
    ``torch.where`` + ``sum`` of the first column;
  * ``csr_join`` at Q13's shape as ``chip_smoke.py`` times it (a left join
    of 1,500,000 customers against 15,000,000 orders, 80% live, over
    1,500,000 slots; the probe key and two build columns gathered), the
    whole join queued and one call per event pair, and each phase alone
    (build, probe with its scan, expansion, gathers); and
    ``partition_perm`` at Q18-2ph-repart's shape (4,194,304 rows into 64
    partitions).  A checkout whose CSR build also returns the counts is
    called as it expects.
Each result is first held to the checkout's plain version.

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
    ap.add_argument("--only", default="key_stats,merge,sort,sort_join,topk,"
                    "dense_agg,masked_reduce,csr_join")
    args = ap.parse_args()
    only = set(args.only.split(","))
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

    if "sort" in only and time_sort(torch, dev, emit) != 0:
        return 1
    if "sort_join" in only and time_sort_join(torch, dev, emit) != 0:
        return 1
    if "key_stats" in only and time_key_stats(torch, dev, rng, rf,
                                               emit) != 0:
        return 1
    if "merge" in only:
        time_merge(torch, dev, rng, groupby, emit)
    if "topk" in only and time_topk(torch, dev, emit) != 0:
        return 1
    if "dense_agg" in only and time_dense_agg(torch, dev, groupby,
                                              emit) != 0:
        return 1
    if "masked_reduce" in only and time_masked_reduce(torch, dev, groupby,
                                                      emit) != 0:
        return 1
    if "csr_join" in only and time_csr_join(torch, dev, emit) != 0:
        return 1
    return 0


def time_masked_reduce(torch, dev, groupby, emit) -> int:
    """The ungrouped reduction at Q6's and F1u's shapes."""
    rng = np.random.default_rng(6)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    n = 4 << 20
    x = t(rng.uniform(900.0, 105000.0, n) * 0.06)
    q6 = [x, t(rng.random(n) < 0.02)]
    day = t(rng.integers(8036, 10_600, n))
    price = t(rng.integers(90_000, 10_500_000, n))
    key = t(rng.integers(1, 60_000_000, n))
    f1u = [t(rng.random(n) < 203_181 / n), t(rng.random(n) < 0.25),
           t(rng.random(n) < 0.5)]

    def q6_cols(c):
        return [(c[0], None, "sum"), (None, None, "count")], c[1]

    def f1u_cols(c):
        return [(day, None, "first"), (price, None, "last"),
                (key, None, "last"), (key, c[1], "first"),
                (day, c[2], "last")], c[0]

    shapes = (("masked_reduce_q6", q6, q6_cols,
               [("sum", True), ("sum", False)]),
              ("masked_reduce_f1u", f1u, f1u_cols,
               [(op, False) for op in ("first", "last", "last", "first",
                                       "last")]))
    # the floor of one queued launch: a one-element add
    tiny = torch.zeros(1, device=dev)
    emit("launch_floor", time_ms(torch, [lambda: tiny.add_(1.0)], reps=64))

    def library(cols, active):
        """torch.where + sum of the first column over the live rows."""
        d = cols[0][0]
        zero = torch.zeros((), dtype=d.dtype, device=dev)
        return lambda: torch.where(active, d, zero).sum()

    for what, cols, make, specs in shapes:
        accs = []
        for fn in (groupby.masked_reduce, groupby.masked_reduce_plain):
            acc_f, acc_i = groupby.init_scalars(specs, dev)
            acc = (acc_f, acc_i, torch.zeros_like(acc_i))
            fn(*make(cols), *acc)
            accs.append(acc)
        torch.cuda.synchronize()
        (kf, ki, kh), (pf, pi, ph) = accs
        same = torch.equal(ki, pi) and torch.equal(kh, ph)
        if what == "masked_reduce_q6":  # the sums add in other orders
            same &= float((kf - pf).abs().max()) <= 1e-9 * float(
                pf.abs().max())
        else:
            same &= torch.equal(kf.view(torch.int64), pf.view(torch.int64))
        if not same:
            print(f"kernel_ab: {what} differs from plain", file=sys.stderr)
            return 1
        acc = accs[0]
        inputs = copies(cols, 8)
        live = int(make(cols)[1].sum())
        emit(what, time_ms(torch, [lambda c=c: groupby.masked_reduce(
            *make(c), *acc) for c in inputs], reps=8 * len(inputs)),
            rows=n, live=live)
        emit(f"{what}_library", time_ms(torch, [library(*make(c))
                                                for c in inputs],
                                        reps=8 * len(inputs)), rows=n)
    return 0


def time_csr_join(torch, dev, emit) -> int:
    """Q13's CSR left join, whole and by phase, and the partition
    placement of Q18-2ph-repart."""
    from spark_rapids_tpu_torch.ops import join
    rng = np.random.default_rng(7)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    nb, C = 15_000_000, 1_500_000
    ckey = t(rng.integers(1, C + 1, nb))
    okey = torch.arange(1, nb + 1, dtype=torch.int64, device=dev)
    act = t(rng.random(nb) < 0.8)
    probe = torch.arange(1, C + 1, dtype=torch.int64, device=dev)
    payload = [(okey, None), (ckey, None)]

    def build(kernel=True):
        got = (join.csr_build_kernel if kernel else join.csr_build_plain)(
            ckey, None, act, 1, C)
        return got[:-1], got[-1]  # the tables the probe takes, b_perm

    def probe_call(tables, kernel=True):
        return (join.csr_probe_kernel if kernel else join.csr_probe_plain)(
            probe, None, None, 1, *tables, "left")

    def whole(total):
        def run():
            tables, b_perm = build()
            lo, off = probe_call(tables)
            pi, bi = join.csr_expand_kernel(off, lo, b_perm, total)
            return join.csr_gather(pi, [(probe, None)], False) \
                + join.csr_gather(bi, payload, True)
        return run

    tables, b_perm = build()
    lo, off = probe_call(tables)
    total = int(off[-1])
    pi, bi = join.csr_expand_kernel(off, lo, b_perm, total)
    ptables, pperm = build(False)
    plo, poff = probe_call(ptables, False)
    ppi, pbi = join.csr_expand_plain(poff, plo, pperm, total)
    got = whole(total)()
    want = join.csr_gather_plain(ppi, [(probe, None)], False) \
        + join.csr_gather_plain(pbi, payload, True)
    torch.cuda.synchronize()
    same = torch.equal(b_perm, pperm) and torch.equal(lo, plo) \
        and torch.equal(off, poff) and torch.equal(pi, ppi) \
        and torch.equal(bi, pbi) and all(
            torch.equal(a[0], b[0]) and (a[1] is None) == (b[1] is None)
            and (a[1] is None or torch.equal(a[1], b[1]))
            for a, b in zip(got, want))
    if not same:
        print("kernel_ab: csr_join differs from plain", file=sys.stderr)
        return 1
    del ptables, pperm, plo, poff, ppi, pbi, want, got
    shape = dict(build_rows=nb, slots=C, probe_rows=C, output_rows=total)
    emit("csr_join_q13", time_ms(torch, [whole(total)], reps=8), **shape)
    emit("csr_join_q13_synced", time_ms_synced(torch, whole(total), reps=8),
         **shape)
    emit("csr_join_q13_build", time_ms(torch, [build], reps=8), **shape)
    emit("csr_join_q13_probe", time_ms(torch, [lambda: probe_call(tables)],
                                       reps=8), **shape)
    emit("csr_join_q13_expand", time_ms(torch, [
        lambda: join.csr_expand_kernel(off, lo, b_perm, total)], reps=8),
        **shape)
    emit("csr_join_q13_gather_pi", time_ms(torch, [
        lambda: join.csr_gather(pi, [(probe, None)], False)], reps=8),
        **shape)
    emit("csr_join_q13_gather_bi", time_ms(torch, [
        lambda: join.csr_gather(bi, payload, True)], reps=8), **shape)

    def library():
        k = torch.where(act, ckey, C + 1)
        sk, perm = torch.sort(k, stable=True)
        lo_ = torch.searchsorted(sk, probe)
        hi_ = torch.searchsorted(sk, probe, right=True)
        cnt = (hi_ - lo_).clamp(min=1)
        pi_ = torch.repeat_interleave(torch.arange(C, device=dev), cnt,
                                      output_size=total)
        first = torch.cumsum(cnt, 0) - cnt
        j = torch.arange(total, device=dev) - first[pi_] + lo_[pi_]
        hit = j < hi_[pi_]
        bi_ = torch.where(hit, perm[j.clamp(max=nb - 1)], -1)
        return probe[pi_], [d[bi_.clamp(min=0)] for d, _ in payload], hit
    emit("csr_join_q13_library_synced", time_ms_synced(torch, library,
                                                       reps=8), **shape)
    del tables, b_perm, lo, off, pi, bi

    n = 4 << 20
    pids = t(rng.integers(0, 64, n).astype(np.int32))
    if not torch.equal(join.partition_perm_kernel(pids, 64),
                       join.partition_perm_plain(pids, 64)):
        print("kernel_ab: partition_perm differs from plain",
              file=sys.stderr)
        return 1
    inputs = copies([pids], 8)
    emit("partition_perm_q18_repart", time_ms(torch, [
        lambda p=p: join.partition_perm_kernel(p, 64) for p, in inputs],
        reps=8 * len(inputs)), rows=n, partitions=64)
    emit("partition_perm_q18_repart_library", time_ms(torch, [
        lambda p=p: torch.sort(p, stable=True).indices for p, in inputs],
        reps=8 * len(inputs)), rows=n, partitions=64)
    return 0


def time_topk(torch, dev, emit) -> int:
    """Q3's ORDER BY revenue DESC, o_orderdate LIMIT k over its groups."""
    from spark_rapids_tpu_torch.ops import topk as topk_mod
    rng = np.random.default_rng(3)
    g = 1_287_275
    rev = rng.uniform(0.0, 8e5, g)
    odate = rng.integers(8036, 8036 + 2406, g).astype(np.int32)
    for order in ("random", "in_order", "reversed"):
        r, d = rev, odate
        if order != "random":
            r, d = np.sort(rev)[::-1], np.sort(odate)
            if order == "reversed":
                r, d = r[::-1], d[::-1]
        cols = [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                for x in (r, d)]
        cols.insert(1, torch.ones(g, dtype=torch.bool, device=dev))
        inputs = copies(cols, 8)
        for k in (10, 100):
            def call(c, k=k):
                return lambda: topk_mod.topk(
                    [(c[0], c[1], False, False), (c[2], None, True, True)],
                    None, g, k)
            got = call(cols)()
            want = topk_mod.topk_plain(
                [(cols[0], cols[1], False, False), (cols[2], None, True,
                                                    True)], None, g, k)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                print(f"kernel_ab: topk {order} k={k} differs from plain",
                      file=sys.stderr)
                return 1
            emit(f"topk_q3_{order}_k{k}", time_ms(
                torch, [call(c) for c in inputs], reps=8 * len(inputs)),
                rows=g, k=k)
            # torch.topk waits on the device: it and the kernel are timed
            # one call per event pair for the comparison
            emit(f"topk_q3_{order}_k{k}_synced", time_ms_synced(
                torch, lambda c=inputs[0]: call(c)(), reps=32), rows=g, k=k)
            image = ~topk_mod.sortable_view(cols[0])
            emit(f"topk_q3_{order}_k{k}_library_synced", time_ms_synced(
                torch, lambda x=image, k=k: torch.topk(x, k, largest=False),
                reps=32), rows=g, k=k)
    return 0


def time_dense_agg(torch, dev, groupby, emit) -> int:
    """The dense update at Q3's and Q10's shapes."""
    rng = np.random.default_rng(5)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    n, D = 4 << 20, 15_003_036
    key = t(rng.integers(1, D + 1, n).astype(np.int64))
    q3 = [key, (key % 2406 + 8036).to(torch.int32),
          torch.zeros(n, dtype=torch.int64, device=dev),
          t(rng.uniform(900.0, 105000.0, n)), t(rng.random(n) < 0.052)]
    n10, D10 = 765_000, 1_500_000
    k10 = rng.integers(1, D10 + 1, n10)
    q10 = [t(k10.astype(np.int64)), t((k10 % 1_000_000).astype(np.int32)),
           t(np.round(k10 * 0.37 - 999.99, 2)),
           t(rng.uniform(800, 100_000, n10))]

    def q3_call(update, acc, c):
        return lambda: update(acc, (c[0], None), [(c[1], None), (c[2], None)],
                              [(c[3], None), (None, None)], c[4])

    def q10_call(update, acc, c):
        return lambda: update(acc, (c[0], None), [(c[1], None), (c[2], None)],
                              [(c[3], None)], None)

    shapes = (("dense_agg_q3", q3, D, [False, False], [("sum", True),
                                                      ("count", False)],
               q3_call),
              ("dense_agg_q10_f64_residual", q10, D10, [False, True],
               [("sum", True)], q10_call))
    for what, cols, dom, res_f64, channels, call in shapes:
        accs = [groupby.DenseAccumulator(1, dom, 2, channels, dev,
                                         res_f64=res_f64) for _ in range(2)]
        call(groupby.dense_agg_update, accs[0], cols)()
        call(groupby.dense_agg_update_plain, accs[1], cols)()
        torch.cuda.synchronize()
        ka, pa = accs
        # each check folds its accumulator's float64 sums
        same = torch.equal(groupby.dense_agg_check(ka),
                           groupby.dense_agg_check_plain(pa))
        err = float((ka.acc[0] - pa.acc[0]).abs().max())
        if not (same and torch.equal(ka.present, pa.present)
                and err <= 1e-9 * 105000.0):
            print(f"kernel_ab: {what} differs from plain", file=sys.stderr)
            return 1
        inputs = copies(cols, 6 if what == "dense_agg_q3" else 8)
        emit(what, time_ms(torch, [call(groupby.dense_agg_update, ka, c)
                                   for c in inputs], reps=8 * len(inputs)),
             rows=int(cols[0].numel()), slots=dom)
        # as chip_smoke.py times them: Q3's two sums in one index_add_ of
        # rows made beforehand (dead rows add zeros at their own key)
        pairs = torch.zeros((dom + 1, 2), dtype=torch.float64, device=dev)
        target = torch.zeros(dom + 1, dtype=torch.float64, device=dev)
        present = torch.zeros(dom + 1, dtype=torch.bool, device=dev)
        lo = [torch.zeros(dom + 1, dtype=c.dtype, device=dev)
              for c in cols[1:3]]
        hi = [torch.zeros_like(x) for x in lo]

        def library(c, q3_shape=what == "dense_agg_q3"):
            if q3_shape:
                vals = torch.stack([c[3], torch.ones_like(c[3])], 1) \
                    * c[4][:, None]
                return lambda: pairs.index_add_(0, c[0], vals)

            def run():
                target.index_add_(0, c[0], c[3])
                for a, b, r in zip(lo, hi, c[1:3]):
                    a.scatter_reduce_(0, c[0], r, "amin")
                    b.scatter_reduce_(0, c[0], r, "amax")
                present.index_fill_(0, c[0], True)
            return run
        emit(f"{what}_library", time_ms(torch, [library(c) for c in inputs],
                                        reps=8 * len(inputs)),
             rows=int(cols[0].numel()), slots=dom)
    return 0


def time_key_stats(torch, dev, rng, rf, emit) -> int:
    """The runtime-filter statistics of Q18's build, and fully live."""
    n, vcap = 15_000_000, rf.in_list_capacity(10_000)
    keys = torch.from_numpy(rng.permutation(
        np.arange(1, 4 * n + 1, 4, dtype=np.int64))).to(dev)
    live = torch.from_numpy(rng.random(n) < 0.0005).to(dev)
    pairs = [(keys, live), (keys.clone(), live.clone())]
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
            for k, a in pairs], reps=8), live_keys=int(got[2]))
    return 0


def time_merge(torch, dev, rng, groupby, emit) -> None:
    """The merge of Q18's final at SF10, in one call and in 64 buckets."""
    n, m = 15_000_000, 4 << 20
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


def copies(tensors, count: int) -> list:
    """The tensors and ``count - 1`` clones: more than twice the L2 at the
    shapes below.  Each is timed once a turn, which keeps the parent's ~70
    launches a call under the stream's launch depth."""
    return [tensors] + [[t.clone() for t in tensors]
                        for _ in range(count - 1)]


def time_sort(torch, dev, emit) -> int:
    """One S1 run: images, permutation and the 6-column gather."""
    from spark_rapids_tpu_torch.models import tpch
    from spark_rapids_tpu_torch.ops import sort as sort_ops
    rng = np.random.default_rng(51)
    n = 4 << 20
    cols = [torch.from_numpy(a).to(dev) for a in (
        (8035 + rng.integers(0, 2526, n)).astype(np.int32),
        np.round(rng.uniform(900.0, 105000.0, n), 2),
        rng.integers(1, tpch.db_rows("orders", 10) + 1, n),
        rng.integers(1, tpch.db_rows("part", 10) + 1, n),
        rng.integers(1, tpch.db_rows("supplier", 10) + 1, n),
        rng.integers(0, 11, n).astype(np.float64) / 100.0)]

    def keys(c):
        return [(c[0], None, True, True), (c[1], None, False, False),
                (c[2], None, True, True)]

    def kernel(c):
        return lambda: sort_ops.gather_kernel(
            [(x, None) for x in c], sort_ops.sort_perm_kernel(
                sort_ops.sort_images_kernel(keys(c)), None, n))

    def library(c):
        def run():
            order = torch.arange(n, device=dev)
            for x, desc in ((c[2], False), (c[1], True), (c[0], False)):
                order = order[torch.sort(x[order], stable=True,
                                         descending=desc).indices]
            return [x[order] for x in c]
        return run

    got = sort_ops.sort_perm_kernel(sort_ops.sort_images_kernel(keys(cols)),
                                    None, n)
    want = sort_ops.sort_perm_plain(sort_ops.sort_images_plain(keys(cols)),
                                    None, n, dev)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        print("kernel_ab: sort differs from plain", file=sys.stderr)
        return 1
    inputs = copies(cols, 6)
    emit("sort_s1", time_ms(torch, [kernel(c) for c in inputs],
                            reps=len(inputs)), rows=n)
    emit("sort_s1_library", time_ms(torch, [library(c) for c in inputs],
                                    reps=len(inputs)), rows=n)
    return 0


def time_sort_join(torch, dev, emit) -> int:
    """One Q10-shuffled partition pair: the sorted build and an inner
    probe."""
    from spark_rapids_tpu_torch.ops import join
    rng = np.random.default_rng(8)
    nb, npr = 2_500_000, 71_700
    bk = torch.from_numpy(rng.integers(1, 15_000_001, nb)).to(dev)
    pk = torch.from_numpy(rng.choice(np.arange(1, 15_000_001), npr,
                                     replace=False)).to(dev)
    kb = join.sorted_build_kernel([(bk, None)], None)
    pb = join.sorted_build_plain([(bk, None)], None)
    ko = join.sorted_probe_kernel([(pk, None)], None, kb, "inner")
    po = join.sorted_probe_plain([(pk, None)], None, pb, "inner")
    torch.cuda.synchronize()
    if not (torch.equal(kb.b_perm, pb.b_perm) and all(
            torch.equal(x, y) for x, y in zip(ko, po))):
        print("kernel_ab: sort_join differs from plain", file=sys.stderr)
        return 1

    def kernel(b, p):
        return lambda: join.sorted_probe_kernel(
            [(p, None)], None, join.sorted_build_kernel([(b, None)], None),
            "inner")

    def build(b, p):
        return lambda: join.sorted_build_kernel([(b, None)], None)

    def library(b, p):
        def run():
            sk, perm = torch.sort(b, stable=True)
            return (torch.searchsorted(sk, p),
                    torch.searchsorted(sk, p, right=True), perm)
        return run

    inputs = copies([bk, pk], 8)
    for what, fn in (("sort_join_q10", kernel), ("sort_build_q10", build),
                     ("sort_join_q10_library", library)):
        emit(what, time_ms(torch, [fn(b, p) for b, p in inputs],
                           reps=len(inputs)), build_rows=nb,
             probe_rows=npr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
