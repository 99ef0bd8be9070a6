#!/usr/bin/env python3
"""Device times of kernels of one checkout of the port (the
runtime-filter statistics, the final aggregate's merge, the full sort,
the sorted join, the top-k, the dense update, the ungrouped reduction and
the CSR join with the partition placement), for comparing two checkouts
on one CUDA card.

    python3 tools/kernel_ab.py [--root DIR] [--label NAME] \
        [--only key_stats,merge,sort,sort_join,topk,dense_agg,
                masked_reduce,csr_join,hash_agg,grid_agg,dense_join,
                window_scan]

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
    called as it expects;
  * ``hash_agg`` (the update, into a table that has seen one call, so the
    timed calls find every group): the keys only at Q21's DISTINCT
    (l_orderkey, l_suppkey) as ``chip_smoke.py`` times it (4,194,304 rows,
    63% live, keys drawn from 15,000,000 and 100,000), a float64 sum and a
    count at Q18's shape (4,194,304 order keys drawn from 15,000,000,
    about 3,660,000 groups), F1's five FIRST/LAST channels and a count
    (4,194,304 orders by customer, 1,500,000 customers), and every row
    live into few groups of two int64 keys, a float64 sum and a count: 25
    x 7 (Q9's 175) and 2 x 2 (Q7's 4), and into one group (the worst
    contention); and Q18's shape with one value (and every 16th value) at
    1e-30, far below the query scale's range (the fallback); and
  * ``grid_agg`` at Q1's shape (4,194,304 rows, 98% live, codes over (4,
    2), seven float64 sums), into an accumulator that has seen one call;
  * ``dense_join``, the build and the probe through ``build_join_table``
    and ``probe_join`` (a checkout whose build takes the live count is
    given it, so its layout rule picks the layout): Q3's second join
    (15,003,036 slots, 9.7% live; an inner probe of one 4,194,304-row
    batch, 54% live, with 8, 4 and 8-byte payload), Q18's semi join
    (15,000,000 slots, 0.1% live; 4,194,304 probe keys) and a fully live
    build of 15,000,000 keys (the inner probe of Q3's shape); and
  * ``window_scan`` at W1's shape (60,012,150 rows in (supplier, ship
    date) order, ~600 rows a supplier): the window context of the
    (supplier, ship date) spec (``SortedWindowContext``), the running
    float64 sum reset per supplier, and the same sum over one partition
    of every row.
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
                    "dense_agg,masked_reduce,csr_join,hash_agg,grid_agg,"
                    "dense_join,window_scan")
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
    if "hash_agg" in only and time_hash_agg(torch, dev, groupby, emit) != 0:
        return 1
    if "grid_agg" in only and time_grid_agg(torch, dev, groupby, emit) != 0:
        return 1
    if "dense_join" in only and time_dense_join(torch, dev, emit) != 0:
        return 1
    if "window_scan" in only and time_window_scan(torch, dev, emit) != 0:
        return 1
    return 0


def _same_probe(torch, a, b) -> bool:
    (sa, ca), (sb, cb) = a, b
    return torch.equal(sa, sb) and all(
        torch.equal(x[0], y[0]) and (x[1] is None) == (y[1] is None)
        and (x[1] is None or torch.equal(x[1], y[1])) for x, y in zip(ca, cb))


def time_dense_join(torch, dev, emit) -> int:
    """The dense join's build and probe at Q3's, Q18's semi and a fully
    live shape, each through the checkout's build_join_table and
    probe_join."""
    from spark_rapids_tpu_torch.ops import join
    rng = np.random.default_rng(6)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    takes_count = "count" in inspect.signature(
        join.build_join_table).parameters
    n = 4 << 20
    shapes = (("dense_join_q3", 15_003_036, 0.097, "inner", 0.54),
              ("dense_join_q18_semi", 15_000_000, 0.001, "semi", None),
              ("dense_join_full_live", 15_000_000, 1.0, "inner", 0.54))
    for what, D, live, how, probe_live in shapes:
        bkeys = torch.arange(1, D + 1, dtype=torch.int64, device=dev)
        act = t(rng.random(D) < live) if live < 1 else None
        count = int(act.sum()) if act is not None else D
        extra = (count,) if takes_count else ()

        def build(a=act, extra=extra, D=D, bkeys=bkeys):
            return join.build_join_table(bkeys, None, a, 1, D, *extra)
        table = build()
        payload = [] if how == "semi" else [
            (bkeys, None),
            (t(rng.integers(8036, 8036 + 2406, D).astype(np.int32)), None),
            (torch.zeros(D, dtype=torch.int64, device=dev), None)]
        if how == "semi":
            pk = torch.arange(1, n + 1, dtype=torch.int64, device=dev)
            pa = None
        else:
            pk = t(rng.integers(1, D + 1, n).astype(np.int64))
            pa = t(rng.random(n) < probe_live)
        got = join.probe_join(pk, None, pa, 1, table, payload, how)
        plain_table = join.dense_join_build_plain(
            bkeys, None, act, 1, D)
        want = join.dense_join_probe_plain(pk, None, pa, 1, plain_table,
                                           payload, how)
        torch.cuda.synchronize()
        if not _same_probe(torch, got, want):
            print(f"kernel_ab: {what} differs from plain", file=sys.stderr)
            return 1
        del plain_table, want, got
        layout = type(table).__name__
        shape = dict(slots=D, live_build=count, probe_rows=n, how=how,
                     layout=layout)
        inputs = copies([pk] if pa is None else [pk, pa], 8)
        emit(f"{what}_probe", time_ms(torch, [
            (lambda c=c: join.probe_join(c[0], None, c[1] if len(c) > 1
                                         else None, 1, table, payload, how))
            for c in inputs], reps=8 * len(inputs)), **shape)
        builds = copies([act], 4) if act is not None else [[None]] * 4
        emit(f"{what}_build", time_ms(torch, [
            (lambda a=c[0]: build(a)) for c in builds], reps=4 * len(builds)),
            **shape)
        del table, payload, inputs, builds, bkeys, act
    return 0


def time_window_scan(torch, dev, emit) -> int:
    """W1's window context, its running sum and one partition's sum, each
    through the checkout's SortedWindowContext and win_scan_kernel."""
    from spark_rapids_tpu_torch.ops import window
    rng = np.random.default_rng(52)
    n, nsupp = 60_012_150, 100_000
    supp = torch.from_numpy(rng.integers(1, nsupp + 1, n)).to(dev)
    day = torch.from_numpy(rng.integers(8035, 8035 + 2526, n).astype(
        np.int32)).to(dev)
    order = torch.sort(supp * 4096 + day.long(), stable=True).indices
    supp, day = supp[order], day[order]
    price = torch.from_numpy(np.round(rng.uniform(900.0, 105000.0, n),
                                      2)).to(dev)
    del order
    part, ords = [(supp, None)], [(day, None)]
    w = window.SortedWindowContext(part, ords, n, dev)
    seg = w.seg_start
    flags = window.win_flags_plain(part + ords, 1, n, dev)
    ok = torch.equal(seg, flags[0]) and torch.equal(w.peer_start, flags[1])
    for name, mode, fl in (("seg_start_pos", "start_pos", flags[0]),
                           ("seg_end_pos", "end_pos", flags[0]),
                           ("peer_start_pos", "start_pos", flags[1]),
                           ("peer_end_pos", "end_pos", flags[1])):
        want = window.win_scan_plain(torch.int32, "max" if mode ==
                                     "start_pos" else "min", mode, n,
                                     flags=fl)
        ok = ok and torch.equal(getattr(w, name), want)
    del flags, want
    run = window.win_scan_kernel(torch.float64, "sum", "values", n, price,
                                 None, None, seg)
    plain = window.win_scan_plain(torch.float64, "sum", "values", n, price,
                                  None, None, seg)
    scale = window.win_scan_plain(torch.float64, "sum", "values", n,
                                  price.abs(), None, None, seg)
    torch.cuda.synchronize()
    ok = ok and float(((run - plain).abs() / scale.clamp(min=1.0)).max()) \
        <= 1e-12
    if not ok:
        print("kernel_ab: window_scan differs from plain", file=sys.stderr)
        return 1
    del run, plain, scale, w
    first = torch.zeros(n, dtype=torch.bool, device=dev)
    first[0] = True
    shape = dict(rows=n, partitions=int(seg.sum()))
    emit("window_context_w1", time_ms(torch, [
        lambda: window.SortedWindowContext(part, ords, n, dev)], reps=8),
        **shape)
    emit("window_scan_w1_running_sum", time_ms(torch, [
        lambda: window.win_scan_kernel(torch.float64, "sum", "values", n,
                                       price, None, None, seg)], reps=8),
        **shape)
    emit("window_scan_one_partition", time_ms(torch, [
        lambda: window.win_scan_kernel(torch.float64, "sum", "values", n,
                                       price, None, None, first)], reps=8),
        rows=n, partitions=1)
    emit("window_scan_w1_cumsum_library", time_ms(torch, [
        lambda: torch.cumsum(price, 0)], reps=8), rows=n)
    return 0


def _sorted_groups(torch, acc):
    """A hash accumulator's groups as (key matrix, values) in key order,
    FIRST/LAST values where their has flag holds (0 elsewhere)."""
    keys, values, live = acc.finish()
    cols = [w for w, _ in keys] + [ok.long() for _, ok in keys]
    vals = []
    for v in values:
        if isinstance(v, tuple):
            v = torch.where(v[1], v[0], torch.zeros_like(v[0])), v[1]
        vals += list(v) if isinstance(v, tuple) else [v]
    if live is not None:
        cols = [c[live] for c in cols]
        vals = [v[live] for v in vals]
    m = torch.stack(cols, 1)
    order = torch.arange(m.shape[0], device=m.device)
    for c in reversed(range(m.shape[1])):
        order = order[torch.sort(m[order, c], stable=True).indices]
    return m[order], [v[order] for v in vals]


def time_hash_agg(torch, dev, groupby, emit) -> int:
    """The hash aggregate's update at Q21's, Q18's (also with far values),
    F1's, Q9's and Q7's shapes, each against the plain version first."""
    rng = np.random.default_rng(15)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    n = 4 << 20
    rev = t(rng.uniform(900.0, 105000.0, n) * (1 - rng.integers(0, 11, n)
                                                / 100.0))
    ck = t(rng.integers(1, 1_500_001, n))
    days = t(rng.integers(8036, 10592, n))
    okey = t(rng.integers(1, 60_000_001, n))
    q21_words = [t(rng.integers(1, 15_000_001, n)),
                 t(rng.integers(1, 100_001, n))]
    q21_active = t(rng.random(n) < 0.63)
    q18_keys = t(rng.integers(1, 15_000_001, n))
    # Q18's shape with values far below the query scale's range (1e-30
    # beside ~1e5): at one row, and at every 16th row (about 250,000
    # groups take the fallback)
    far_one, far_16 = rev.clone(), rev.clone()
    far_one[n // 3] = 1e-30
    far_16[::16] = 1e-30
    shapes = [
        # name, words, contributions, channels, active, key_bound
        ("hash_agg_q21_keys", q21_words, [], [], q21_active, None),
        ("hash_agg_q18_f64_sum", [q18_keys],
         [(rev, None), (None, None)], [("sum", True), ("count", False)],
         None, n),
        ("hash_agg_q18_far_one", [q18_keys],
         [(far_one, None), (None, None)], [("sum", True), ("count", False)],
         None, n),
        ("hash_agg_q18_far_16th", [q18_keys],
         [(far_16, None), (None, None)], [("sum", True), ("count", False)],
         None, n),
        ("hash_agg_f1_first_last", [ck],
         [(days, None), (okey, None), (okey, None),
          (okey, t(rng.random(n) < 0.2)), (days, t(rng.random(n) < 0.49)),
          (None, None)],
         [("first", False), ("last", False), ("last", False),
          ("first_valid", False), ("last_valid", False), ("count", False)],
         None, 1_500_000),
        ("hash_agg_q9_groups", [t(rng.integers(0, 25, n)),
                                t(rng.integers(1992, 1999, n))],
         [(rev, None), (None, None)], [("sum", True), ("count", False)],
         None, 175),
        ("hash_agg_q7_groups", [t(rng.integers(0, 2, n)),
                                t(rng.integers(1995, 1997, n))],
         [(rev, None), (None, None)], [("sum", True), ("count", False)],
         None, 4),
        # every row in one group: the worst contention
        ("hash_agg_one_group", [t(np.zeros(n, dtype=np.int64))],
         [(rev, None), (None, None)], [("sum", True), ("count", False)],
         None, 1)]
    for what, words, contribs, channels, active, bound in shapes:
        words = [(w, None) for w in words]
        accs = []
        for plain in (False, True):
            acc = groupby.HashAccumulator(len(words), channels, dev,
                                          plain=plain, key_bound=bound)
            acc.update(words, contribs, active, n)
            accs.append(acc)
        km, kv = _sorted_groups(torch, accs[0])
        pm, pv = _sorted_groups(torch, accs[1])
        torch.cuda.synchronize()
        same = torch.equal(km, pm)
        mass = sum(float(d.abs().sum()) for (d, _), (op, f64) in zip(
            contribs, channels) if f64 and op == "sum")
        for (op, f64), a, b in zip([c for c in channels for _ in (
                (0, 1) if c[0] in groupby.ORDERED_OPS else (0,))], kv, pv):
            if f64 and op == "sum":
                same = same and float((a - b).abs().max()) <= 1e-12 * mass
            else:
                same = same and torch.equal(a, b)
        if not same:
            print(f"kernel_ab: {what} differs from plain", file=sys.stderr)
            return 1
        acc = accs[0]
        if what == "hash_agg_q21_keys":
            # as chip_smoke.py times it: the wrapper alone, over copies
            inputs = copies([w for w, _ in words] + [active], 4)
            calls = [lambda c=c: groupby.hash_agg_update(
                acc, [(c[0], None), (c[1], None)], [], c[2], n)
                for c in inputs]
            ms = time_ms(torch, calls, reps=8 * len(inputs))
        else:
            ms = time_ms(torch, [lambda: acc.update(words, contribs, active,
                                                    n)], reps=8)
        emit(what, ms, rows=n, groups=int(km.shape[0]))
        del accs, acc
    return 0


def time_grid_agg(torch, dev, groupby, emit) -> int:
    """The grid aggregate at Q1's shape, into an accumulator that has seen
    one call, against the plain version first."""
    rng = np.random.default_rng(16)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    n, dims = 4 << 20, (4, 2)
    codes = [t(rng.integers(0, 3, n).astype(np.int32)),
             t(rng.integers(0, 2, n).astype(np.int32))]
    f_data = [t(rng.uniform(1.0, 1e5, n)) for _ in range(7)]
    active = t(rng.random(n) < 0.98)
    keys = [(c, None) for c in codes]
    contribs = [((d, None), "sum") for d in f_data]
    accs = []
    for plain in (False, True):
        acc = groupby.GridAccumulator(dims, ["f"] * 7, dev)
        if plain:
            groupby.grid_agg_plain(keys, dims, [(d, None) for d in f_data],
                                   [], active, acc.f, acc.i, acc.cnt)
        else:
            groupby.grid_group_reduce(keys, dims, contribs, active, acc)
        accs.append(acc)
    kv, pv = accs[0].values(), accs[1].values()
    torch.cuda.synchronize()
    err = max(float((a - b).abs().max()) for a, b in zip(kv, pv))
    if not torch.equal(accs[0].cnt, accs[1].cnt) or \
            err > 1e-12 * float(sum(d.abs().sum() for d in f_data)):
        print("kernel_ab: grid_agg differs from plain", file=sys.stderr)
        return 1
    inputs = copies(codes + f_data + [active], 3)
    acc = accs[0]
    ms = time_ms(torch, [lambda c=c: groupby.grid_group_reduce(
        [(c[0], None), (c[1], None)], dims,
        [((d, None), "sum") for d in c[2:9]], c[9], acc) for c in inputs],
        reps=8 * len(inputs))
    emit("grid_agg_q1", ms, rows=n, slots=groupby.grid_size(dims))
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
