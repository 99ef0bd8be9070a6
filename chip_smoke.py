#!/usr/bin/env python3
"""Smoke test of spark_rapids_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``spark_rapids_tpu_torch/csrc``,
holds each against its plain PyTorch version on the card, then drives the
port's main path — TPC-H Q6 and Q1 over seeded SF10 lineitem data
(60,012,150 rows), and Q3 over SF10 lineitem, orders (15,003,036 rows) and
customer (1,500,000 rows), through ``Session.create_dataframe`` →
``collect`` — checks the results against numpy oracles and shows that each
query went through its kernels.  Prints per-query and per-kernel timings,
a ``{"kernels": [...]}`` line, the card's name and power limit, and as its
last line ``{"ok": true, "device": {...}}``.  Exits non-zero, printing no
result, when any phase fails or when no CUDA device is available.  Imports
nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

SF = 10.0                     # TPC-H scale factor of the main path
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate
L2_BYTES = 50 << 20           # H100 L2; timed inputs rotate over more
BATCH_ROWS = 4 << 20          # spark.rapids.tpu.sql.batchSizeRows default
F64_SUM_TOL = 1e-12           # kernel vs plain: |a - b| <= tol * sum |x|
QUERY_REL_TOL = 1e-9          # engine vs numpy oracle, float64 results
# blocking fetches of the reference's Q3 plan at SF10, 4,194,304-row
# batches (counted on the reference's CPU backend): the port's ceiling
Q3_REFERENCE_FETCHES = 43
Q3_ORDERS = 15_003_036        # o_orderkey 1..n at SF10: the join-2 domain
Q3_GROUPS = 1_287_275         # groups of Q3's aggregate at SF10


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


# ---------------------------------------------------------------------------------
# Timing
# ---------------------------------------------------------------------------------

def time_ms(torch, calls, reps: int) -> float:
    """Device time per call, over ``reps`` calls that cycle through
    ``calls``.  The calls are queued behind a spin kernel and timed with
    one pair of CUDA events, so the host's per-call work (ctypes
    marshalling, allocation) leaves no gap on the device; the spin is
    lengthened until every call is queued before the first one runs.
    Each call works on its own copy of the inputs and the copies together
    exceed L2, so every call reads device memory."""
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
        check(cycles <= 1 << 32, "the timed calls could not be queued "
              "ahead of the device")


def time_ms_synced(torch, calls, reps: int) -> float:
    """Device time per call for calls that wait on the device themselves
    (a count that sizes an output): each call between its own pair of
    CUDA events, so the time includes the device idling while the host
    reads the count."""
    for fn in calls:
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for r in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        calls[r % len(calls)]()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def copies_for_l2(tensors) -> list:
    """Enough copies of ``tensors`` (the first is the given one) that
    together they hold more than twice the L2."""
    size = sum(t.numel() * t.element_size() for t in tensors)
    count = max(2, -(-2 * L2_BYTES // size))
    return [tensors] + [[t.clone() for t in tensors]
                        for _ in range(count - 1)]


def sector_bytes(torch, rows, itemsize: int) -> int:
    """Bytes in the 32-byte sectors that hold ``rows`` of a column of
    ``itemsize``-byte elements: what reading those rows moves."""
    return 32 * int(torch.unique(rows * itemsize // 32).numel())


def column_bytes(torch, live, d, v) -> int:
    """Bytes read from one (data, valid) column over the live rows: the
    mask where the row is live, the data where it is also valid."""
    total = 0
    if v is not None:
        total += sector_bytes(torch, live, 1)
        live = live[v[live]]
    if d is not None:
        total += sector_bytes(torch, live, d.element_size())
    return total


def max_abs_diff(a, b) -> float:
    """The largest |a - b| over two tensors of one shape, as float64."""
    if a.numel() == 0:
        return 0.0
    return float((a.double() - b.double()).abs().max())


def _to_device(torch, device):
    return lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)


# ---------------------------------------------------------------------------------
# masked_reduce: kernel vs plain
# ---------------------------------------------------------------------------------

def masked_reduce_case(torch, n: int, seed: int, device, all_inactive=False):
    """Inputs covering every op: sums with nulls, counts, min/max over
    values with -0.0/+0.0 and with a NaN, int64 min/max."""
    rng = np.random.default_rng(seed)
    t = _to_device(torch, device)
    active = rng.random(n) < (0.0 if all_inactive else 0.5)
    zeros = rng.choice(np.array([-0.0, 0.0, 0.5, 2.0]), n)
    with_nan = rng.normal(size=n)
    with_nan[rng.integers(0, n)] = np.nan
    cols = [
        (t(rng.normal(size=n) * 1e3), t(rng.random(n) < 0.9), "sum"),
        (t(rng.integers(-10**12, 10**12, n)), None, "sum"),
        (None, t(rng.random(n) < 0.7), "count"),
        (None, None, "count"),
        (t(zeros), None, "min"),
        (t(-zeros), None, "max"),
        (t(with_nan), None, "min"),
        (t(rng.integers(-10**15, 10**15, n)), t(rng.random(n) < 0.5), "min"),
        (t(rng.integers(-10**15, 10**15, n)), None, "max"),
    ]
    return cols, t(active)


def run_masked_reduce(torch, groupby, fn, cols, active):
    specs = [(op if op != "count" else "sum",
              d is not None and d.dtype == torch.float64)
             for d, _, op in cols]
    acc_f, acc_i = groupby.init_scalars(specs, active.device)
    fn(cols, active, acc_f, acc_i)
    return acc_f, acc_i, specs


def compare_masked_reduce(torch, groupby, cols, active) -> float:
    """Kernel vs plain on the same inputs; returns the largest absolute
    difference.  int64 exact; float64 sums within F64_SUM_TOL * sum|x|;
    float64 min/max identical, NaN and the sign of zero included.  Two
    kernel runs must be bit-identical (the design is deterministic)."""
    kf, ki, specs = run_masked_reduce(torch, groupby, groupby.masked_reduce,
                                      cols, active)
    kf2, ki2, _ = run_masked_reduce(torch, groupby, groupby.masked_reduce,
                                    cols, active)
    pf, pi, _ = run_masked_reduce(torch, groupby, groupby.masked_reduce_plain,
                                  cols, active)
    torch.cuda.synchronize()
    check(torch.equal(kf.view(torch.int64), kf2.view(torch.int64))
          and torch.equal(ki, ki2), "masked_reduce is not deterministic")
    worst = 0.0
    kf, ki, pf, pi = (x.cpu().numpy() for x in (kf, ki, pf, pi))
    for j, ((d, v, op), (_, is_f64)) in enumerate(zip(cols, specs)):
        if not is_f64:
            check(ki[j] == pi[j], f"masked_reduce col {j} ({op}): int64 "
                  f"{ki[j]} != {pi[j]}")
            continue
        a, b = kf[j], pf[j]
        if op == "sum":
            m = active if v is None else active & v
            scale = float(torch.where(m, d.abs(), 0.0).sum())
            err = abs(a - b)
            check(err <= F64_SUM_TOL * scale, f"masked_reduce col {j}: sum "
                  f"{a!r} vs {b!r} (tolerance {F64_SUM_TOL} x {scale})")
            worst = max(worst, err)
        else:
            same = (np.isnan(a) and np.isnan(b)) or (
                a == b and np.signbit(a) == np.signbit(b))
            check(same, f"masked_reduce col {j} ({op}): {a!r} vs {b!r}")
    return worst


# ---------------------------------------------------------------------------------
# grid_agg: kernel vs plain
# ---------------------------------------------------------------------------------

def grid_case(torch, n, dims, nf, seed, device, all_inactive=False):
    """Keys with NULLs (the extra slot of each dimension), float64 columns
    (one with nulls), an int64 sum and a masked count."""
    rng = np.random.default_rng(seed)
    t = _to_device(torch, device)
    keys = [(t(rng.integers(0, d, n).astype(np.int32)),
             t(rng.random(n) < 0.9)) for d in dims]
    f_cols = [(t(rng.normal(size=n) * 10.0 ** (j % 4)),
               t(rng.random(n) < 0.8) if j == 0 else None)
              for j in range(nf)]
    i_cols = [(t(rng.integers(-10**12, 10**12, n)), None),
              (None, t(rng.random(n) < 0.6))]
    active = t(rng.random(n) < (0.0 if all_inactive else 0.7))
    return keys, f_cols, i_cols, active


def run_grid(torch, fn, dims, keys, f_cols, i_cols, active, G):
    dev = active.device
    acc_f = torch.zeros((G, len(f_cols)), dtype=torch.float64, device=dev)
    acc_i = torch.zeros((G, len(i_cols)), dtype=torch.int64, device=dev)
    acc_c = torch.zeros(G, dtype=torch.int64, device=dev)
    fn(keys, dims, f_cols, i_cols, active, acc_f, acc_i, acc_c)
    return acc_f, acc_i, acc_c


def compare_grid(torch, groupby, dims, keys, f_cols, i_cols, active) -> float:
    """Kernel vs plain; int64 and counts exact, float64 per slot within
    F64_SUM_TOL * sum|x| of the slot (f64 atomics add in no fixed
    order).  Returns the largest absolute float64 difference."""
    G = groupby.grid_size(dims)
    kf, ki, kc = run_grid(torch, groupby.grid_agg, dims, keys, f_cols,
                          i_cols, active, G)
    pf, pi, pc = run_grid(torch, groupby.grid_agg_plain, dims, keys, f_cols,
                          i_cols, active, G)
    absf = [(d.abs(), v) for d, v in f_cols]
    sf, _, _ = run_grid(torch, groupby.grid_agg_plain, dims, keys, absf, [],
                        active, G)
    torch.cuda.synchronize()
    check(torch.equal(kc, pc), "grid_agg presence counts differ")
    check(torch.equal(ki, pi), "grid_agg int64 sums/counts differ")
    err = (kf - pf).abs()
    check(bool((err <= F64_SUM_TOL * sf).all()),
          f"grid_agg float64 sums differ by up to {float(err.max())}")
    return float(err.max()) if err.numel() else 0.0


def check_kernels(torch, groupby, device) -> dict:
    """Phase 3: every kernel against its plain version; returns the
    largest float64 difference per kernel."""
    worst = {"masked_reduce": 0.0, "grid_agg": 0.0}
    for n in (1, 1000, BATCH_ROWS + 17):
        cols, active = masked_reduce_case(torch, n, n, device)
        worst["masked_reduce"] = max(worst["masked_reduce"],
                                     compare_masked_reduce(torch, groupby,
                                                           cols, active))
    cols, active = masked_reduce_case(torch, 1000, 7, device,
                                      all_inactive=True)
    compare_masked_reduce(torch, groupby, cols, active)
    print("check masked_reduce: n in (1, 1000, 4194321) and all-inactive: "
          f"ok, max |sum err| {worst['masked_reduce']:.3e} "
          f"(tolerance {F64_SUM_TOL} x sum|x|)")
    for dims, nf, shared in (((4, 2), 7, True), ((63, 63), 2, False)):
        G = groupby.grid_size(dims)
        check(groupby.grid_uses_shared(G, nf, 2) == shared,
              f"G={G}: expected the {'shared' if shared else 'global'} "
              f"variant")
        for n in (1, 1000, BATCH_ROWS + 17):
            case = grid_case(torch, n, dims, nf, n + G, device)
            worst["grid_agg"] = max(worst["grid_agg"],
                                    compare_grid(torch, groupby, dims, *case))
        case = grid_case(torch, 1000, dims, nf, 3, device, all_inactive=True)
        compare_grid(torch, groupby, dims, *case)
        print(f"check grid_agg G={G} ({'shared' if shared else 'global'} "
              f"variant): n in (1, 1000, 4194321) and all-inactive: ok")
    print(f"check grid_agg: max |f64 err| {worst['grid_agg']:.3e} "
          f"(tolerance {F64_SUM_TOL} x per-slot sum|x|)")
    return worst


# ---------------------------------------------------------------------------------
# dense_join: kernel vs plain
# ---------------------------------------------------------------------------------

def join_case(torch, n_build, n_probe, seed, device, dup=False,
              all_inactive=False):
    """A build side of unique int64 keys (a few null, a mask), optionally
    one repeated key, and a probe side whose int64 keys hit, miss (below
    and above the domain) and are null; payload of 8, 4 and 1-byte
    columns, one with nulls."""
    rng = np.random.default_rng(seed)
    t = _to_device(torch, device)
    bkeys = (rng.permutation(n_build) * 3 + 1000).astype(np.int64)
    if dup and n_build > 2:
        bkeys[1] = bkeys[0]
    bvalid = rng.random(n_build) < 0.95
    bactive = rng.random(n_build) < (0.0 if all_inactive else 0.7)
    if dup and n_build > 2:
        bvalid[:2] = bactive[:2] = True
    span = max(3 * n_build, 1)
    pkeys = rng.integers(900, 1000 + span + 100, n_probe).astype(np.int64)
    payload = [(t(rng.integers(-10**12, 10**12, n_build)),
                t(rng.random(n_build) < 0.9)),
               (t(rng.integers(0, 10**6, n_build).astype(np.int32)), None),
               (t(rng.random(n_build) < 0.5), None)]
    return ((t(bkeys), t(bvalid), t(bactive)),
            (t(pkeys), t(rng.random(n_probe) < 0.95),
             t(rng.random(n_probe) < 0.8)), payload)


def compare_dense_join(torch, join, build, probe, payload) -> int:
    """Stats exact; the table exact where keys are unique (a repeated
    key's slot holds one of its rows) and the duplicate count exact; the
    probe on the kernel's table exact, selection, data and validity.
    Returns the duplicate count and the largest difference of the probe's
    outputs."""
    bk, bv, ba = build
    ks, ps = join.dense_join_stats(*build), join.dense_join_stats_plain(*build)
    torch.cuda.synchronize()
    check(torch.equal(ks, ps), f"dense_join stats {ks.tolist()} vs "
          f"{ps.tolist()}")
    kmin, kmax, count = ks.tolist()
    if count == 0:
        return 0, 0.0
    D = kmax - kmin + 1
    kt, kd = join.dense_join_build(bk, bv, ba, kmin, D)
    pt, pd = join.dense_join_build_plain(bk, bv, ba, kmin, D)
    torch.cuda.synchronize()
    check(torch.equal(kd, pd), f"dense_join duplicates {kd.item()} vs "
          f"{pd.item()}")
    differ = (kt != pt).nonzero().squeeze(1)
    if differ.numel():
        rows = kt[differ].long()
        check(bool((rows >= 0).all()) and torch.equal(
            bk[rows] - kmin, differ), "dense_join table differs at a slot "
              "that is not a repeated key's")
        check(kd.item() > 0, "dense_join tables differ with unique keys")
    ksel, kcols = join.dense_join_probe(*probe, kmin, kt, payload)
    psel, pcols = join.dense_join_probe_plain(*probe, kmin, kt, payload)
    torch.cuda.synchronize()
    check(torch.equal(ksel, psel), "dense_join probe selections differ")
    err = max_abs_diff(ksel, psel)
    for j, ((kd_, kv_), (pd_, pv_)) in enumerate(zip(kcols, pcols)):
        check(torch.equal(kd_, pd_), f"dense_join payload {j} data differs")
        check((kv_ is None) == (pv_ is None)
              and (kv_ is None or torch.equal(kv_, pv_)),
              f"dense_join payload {j} validity differs")
        err = max(err, max_abs_diff(kd_, pd_))
        if kv_ is not None:
            err = max(err, max_abs_diff(kv_, pv_))
    return kd.item(), err


# ---------------------------------------------------------------------------------
# dense_agg: kernel vs plain
# ---------------------------------------------------------------------------------

def dense_agg_case(torch, n, seed, device, kmin, D, span, violate=False,
                   all_inactive=False):
    """Primary int64 keys over ``span`` values from kmin - span//8 (some
    null, some outside [kmin, kmin + D)), an int32 residual that depends
    on the key (or, with ``violate``, does not), a nullable int64
    residual, a float64 sum with nulls, an int64 min and a count."""
    rng = np.random.default_rng(seed)
    t = _to_device(torch, device)
    key = rng.integers(kmin - span // 8, kmin - span // 8 + span, n)
    r1 = (key % 1000).astype(np.int32)
    if violate:
        r1[rng.integers(0, n)] += 1
    r2 = key * 7
    r2_valid = (key % 5) != 0
    keys = [(t(key.astype(np.int64)), t(rng.random(n) < 0.97)),
            (t(r1), None), (t(r2.astype(np.int64)), t(r2_valid))]
    contribs = [(t(rng.normal(size=n) * 1e3), t(rng.random(n) < 0.9)),
                (t(rng.integers(-10**12, 10**12, n)), None),
                (None, None)]
    channels = [("sum", True), ("min", False), ("count", False)]
    active = t(rng.random(n) < (0.0 if all_inactive else 0.6))
    return keys, contribs, channels, active


def run_dense_agg(torch, groupby, update, kmin, D, keys, contribs,
                  channels, active, cap):
    acc = groupby.DenseAccumulator(kmin, D, len(keys) - 1, channels,
                                   active.device, cap=cap)
    update(acc, keys[0], keys[1:], contribs, active)
    return acc


def _overflow_rows(torch, acc):
    """The buffered overflow rows as one sorted int64 matrix (key,
    residuals and their validity, contribution bits and validity)."""
    n = min(int(acc.ocount.item()), acc.cap)
    cols = [acc.okey[:n]] + [acc.ores[i, :n] for i in range(acc.nres)] \
        + [acc.ores_valid[i, :n].long() for i in range(acc.nres)] \
        + [acc.och_valid[j, :n].long() for j in range(len(acc.channels))] \
        + [acc.och[j, :n] for j, (op, _) in enumerate(acc.channels)
           if op != "count"]
    m = torch.stack(cols, 1)
    for c in reversed(range(m.shape[1])):
        m = m[torch.sort(m[:, c], stable=True).indices]
    return m


def compare_dense_agg(torch, groupby, kmin, D, keys, contribs, channels,
                      active, cap=1 << 12) -> float:
    """Stats and the dependence probe exact; after one update, presence,
    int64 channels, residual channels, overflow count and bounds exact,
    the buffered overflow rows equal as a set (the kernel's atomic cursor
    orders them freely) when they fit, float64 sums per slot within
    F64_SUM_TOL x sum|x|; the violation check exact.  Returns the largest
    float64 difference."""
    cand = [True, True, False]
    ks, kf = groupby.dense_agg_stats(keys, cand, active)
    ps, pf = groupby.dense_agg_stats_plain(keys, cand, active)
    torch.cuda.synchronize()
    check(torch.equal(ks, ps) and torch.equal(kf, pf),
          f"dense_agg stats {ks.tolist()} {kf.tolist()} vs {ps.tolist()} "
          f"{pf.tolist()}")
    ka = run_dense_agg(torch, groupby, groupby.dense_agg_update, kmin, D,
                       keys, contribs, channels, active, cap)
    pa = run_dense_agg(torch, groupby, groupby.dense_agg_update_plain, kmin,
                       D, keys, contribs, channels, active, cap)
    absf = [(c[0].abs() if f else c[0], c[1])
            for c, (_, f) in zip(contribs, channels)]
    sa = run_dense_agg(torch, groupby, groupby.dense_agg_update_plain, kmin,
                       D, keys, absf, channels, active, cap)
    torch.cuda.synchronize()
    check(torch.equal(ka.present, pa.present), "dense_agg presence differs")
    for name in ("vmin", "vmax", "vdmin", "vdmax", "ocount", "obounds"):
        check(torch.equal(getattr(ka, name), getattr(pa, name)),
              f"dense_agg {name} differs")
    worst = 0.0
    for j, (_, is_f64) in enumerate(channels):
        if not is_f64:
            check(torch.equal(ka.acc[j], pa.acc[j]),
                  f"dense_agg int64 channel {j} differs")
            continue
        err = (ka.acc[j] - pa.acc[j]).abs()
        check(bool((err <= F64_SUM_TOL * sa.acc[j]).all()),
              f"dense_agg float64 channel {j} differs by up to "
              f"{float(err.max())}")
        worst = max(worst, float(err.max()))
    if ka.ocount.item() <= cap:
        check(torch.equal(_overflow_rows(torch, ka),
                          _overflow_rows(torch, pa)),
              "dense_agg overflow rows differ")
    check(torch.equal(groupby.dense_agg_check(ka),
                      groupby.dense_agg_check_plain(pa)),
          "dense_agg violation check differs")
    return worst


# ---------------------------------------------------------------------------------
# topk: kernel vs plain
# ---------------------------------------------------------------------------------

def topk_case(torch, n, seed, device):
    """Float64 keys with NaN, +-0.0, +-inf, ties and nulls; int32 keys with
    ties; a live mask."""
    rng = np.random.default_rng(seed)
    t = _to_device(torch, device)
    x = rng.choice(np.array([-0.0, 0.0, 1.5, -2.25, np.nan, np.inf,
                             -np.inf, 3.0]), n)
    x[: n // 2] = rng.normal(size=n // 2)
    return ([(t(x), t(rng.random(n) < 0.9), False, False),
             (t(rng.integers(0, 50, n).astype(np.int32)), None, True, True),
             (t(rng.random(n) < 0.5), t(rng.random(n) < 0.8), True, False)],
            t(rng.random(n) < 0.8))


def compare_topk(torch, topk_mod, keys, active, n, k) -> float:
    """The selected row numbers exact; returns their largest difference."""
    got = topk_mod.topk(keys, active, n, k)
    want = topk_mod.topk_plain(keys, active, n, k)
    torch.cuda.synchronize()
    check(torch.equal(got, want), f"topk n={n} k={k}: {got[:8].tolist()} "
          f"vs {want[:8].tolist()}")
    return max_abs_diff(got, want)


# ---------------------------------------------------------------------------------
# compact: kernel vs plain
# ---------------------------------------------------------------------------------

def compact_case(torch, n, seed, device, live):
    rng = np.random.default_rng(seed)
    t = _to_device(torch, device)
    cols = [(t(rng.integers(-10**15, 10**15, n)), t(rng.random(n) < 0.8)),
            (t(rng.integers(-10**6, 10**6, n).astype(np.int32)), None),
            (t(rng.integers(-999, 999, n).astype(np.int16)),
             t(rng.random(n) < 0.5)),
            (t(rng.random(n) < 0.5), None),
            (t(rng.normal(size=n)), None)]
    return cols, t(rng.random(n) < live)


def compare_compact(torch, batch_utils, cols, active) -> float:
    """Every column's data and validity exact; returns their largest
    difference."""
    n_live = int(active.sum())
    got = batch_utils.compact_kernel(cols, active, n_live)
    want = batch_utils.compact_plain(cols, active, n_live)
    torch.cuda.synchronize()
    err = 0.0
    for j, ((gd, gv), (wd, wv)) in enumerate(zip(got, want)):
        check(torch.equal(gd, wd), f"compact column {j} data differs")
        check((gv is None) == (wv is None)
              and (gv is None or torch.equal(gv, wv)),
              f"compact column {j} validity differs")
        err = max(err, max_abs_diff(gd, wd))
        if gv is not None:
            err = max(err, max_abs_diff(gv, wv))
    return err


def check_new_kernels(torch, join, groupby, topk_mod, batch_utils,
                      device) -> dict:
    """The join, dense-aggregate, top-k and compaction kernels against
    their plain versions on edge cases; returns the largest difference
    per kernel."""
    worst = {"dense_join": 0.0, "dense_agg": 0.0, "topk": 0.0,
             "compact": 0.0}
    for nb, npr, seed, kw in ((0, 100, 1, {}), (1, 1, 2, {}),
                              (1000, 5000, 3, {}),
                              (1000, 5000, 4, {"all_inactive": True}),
                              (200_003, BATCH_ROWS + 17, 5, {})):
        _, err = compare_dense_join(torch, join, *join_case(
            torch, nb, npr, seed, device, **kw))
        worst["dense_join"] = max(worst["dense_join"], err)
    dups, err = compare_dense_join(torch, join, *join_case(
        torch, 1000, 100, 6, device, dup=True))
    worst["dense_join"] = max(worst["dense_join"], err)
    check(dups == 1, f"dense_join reported {dups} repeated keys, not 1")
    print("check dense_join: build 0/1/1000/200003 rows (one all-inactive), "
          "probe up to 4194321 rows with null, missing and out-of-domain "
          "keys: ok; a repeated build key reported: ok")
    kmin, D = 10_000, 4096
    cases = [(0, {}, 1 << 12), (1, {}, 1 << 12), (5000, {}, 1 << 12),
             (5000, {"all_inactive": True}, 1 << 12),
             (BATCH_ROWS + 17, {}, 1 << 20)]
    for n, kw, cap in cases:
        case = dense_agg_case(torch, n, n + 7, device, kmin, D, D, **kw)
        worst["dense_agg"] = max(worst["dense_agg"],
                                 compare_dense_agg(torch, groupby, kmin, D,
                                                   *case, cap=cap))
    # an overflow buffer filled exactly, then one row too many
    n_out = None
    for seed in range(20):
        case = dense_agg_case(torch, 2000, 100 + seed, device, kmin, D,
                              D * 2)
        ref = run_dense_agg(torch, groupby, groupby.dense_agg_update_plain,
                            kmin, D, *case, 1 << 20)
        n_out = int(ref.ocount.item())
        if n_out > 1:
            break
    for cap in (n_out, n_out - 1):
        compare_dense_agg(torch, groupby, kmin, D, *case, cap=cap)
        acc = run_dense_agg(torch, groupby, groupby.dense_agg_update, kmin,
                            D, *case, cap)
        check(int(acc.ocount.item()) == n_out, "dense_agg overflow count")
    case = dense_agg_case(torch, 5000, 9, device, kmin, D, D, violate=True)
    compare_dense_agg(torch, groupby, kmin, D, *case)
    acc = run_dense_agg(torch, groupby, groupby.dense_agg_update, kmin, D,
                        *case, 1 << 12)
    check(groupby.dense_agg_check(acc)[0].item() == 1,
          "dense_agg missed a violation")
    print(f"check dense_agg: n in (0, 1, 5000, 4194321) and all-inactive, "
          f"null and out-of-domain keys, an overflow buffer filled with "
          f"{n_out} rows and overflowed by one, a violation: ok, max |f64 "
          f"err| {worst['dense_agg']:.3e} (tolerance {F64_SUM_TOL} x "
          f"per-slot sum|x|)")
    for n, k in ((1, 1), (1000, 10), (5000, 1024), (1_300_001, 10),
                 (1_300_001, 1000)):
        keys, active = topk_case(torch, n, n + k, device)
        worst["topk"] = max(worst["topk"], compare_topk(
            torch, topk_mod, keys, active, n, k))
    keys, active = topk_case(torch, 3000, 8, device)
    worst["topk"] = max(worst["topk"], compare_topk(
        torch, topk_mod, keys, torch.zeros_like(active), 3000, 10))
    print("check topk: n up to 1300001, k in (1, 10, 1000, 1024), NaN, "
          "+-0.0, +-inf, nulls first and last, ties, all-inactive: ok")
    for n, live in ((0, 0.5), (1, 1.0), (4097, 0.5), (5000, 0.0),
                    (BATCH_ROWS + 17, 0.3), (Q3_ORDERS + 1, 0.08)):
        cols, active = compact_case(torch, n, n + 1, device, live)
        worst["compact"] = max(worst["compact"], compare_compact(
            torch, batch_utils, cols, active))
    print(f"check compact: n in (0, 1, 4097, 5000 all-inactive, 4194321, "
          f"{Q3_ORDERS + 1}), 1/2/4/8-byte columns with validity: ok")
    return worst


# ---------------------------------------------------------------------------------
# The main path: TPC-H Q6 and Q1 at SF10
# ---------------------------------------------------------------------------------

def rel_err(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-300)


def check_q6(rows, want) -> float:
    check(len(rows) == 1 and len(rows[0]) == 1, f"Q6 shape {rows!r}")
    got = rows[0][0]
    check(got is not None and rel_err(got, want) <= QUERY_REL_TOL,
          f"Q6 revenue {got!r} vs oracle {want!r}")
    return rel_err(got, want)


def check_q1(rows, want) -> float:
    check(len(rows) == len(want), f"Q1 has {len(rows)} groups, oracle "
          f"{len(want)}")
    worst = 0.0
    for got, ref in zip(rows, want):
        check(got[:2] == ref[:2] and got[-1] == ref[-1],
              f"Q1 keys/count {got[:2]}/{got[-1]} vs {ref[:2]}/{ref[-1]}")
        for a, b in zip(got[2:-1], ref[2:-1]):
            worst = max(worst, rel_err(a, b))
            check(rel_err(a, b) <= QUERY_REL_TOL, f"Q1 {got[:2]}: {a!r} vs "
                  f"{b!r}")
    return worst


def check_q3(rows, want) -> float:
    check(len(rows) == len(want) == 10, f"Q3 has {len(rows)} rows, oracle "
          f"{len(want)}")
    worst = 0.0
    for got, ref in zip(rows, want):
        check(got[:3] == ref[:3], f"Q3 keys {got[:3]} vs {ref[:3]}")
        worst = max(worst, rel_err(got[3], ref[3]))
        check(rel_err(got[3], ref[3]) <= QUERY_REL_TOL,
              f"Q3 {got[:3]}: revenue {got[3]!r} vs {ref[3]!r}")
    return worst


def launch_counts(counters) -> dict:
    """Per kernel source, the launches of its wrappers so far."""
    return {name: sum(fn.launches for fn in fns)
            for name, fns in counters.items()}


def run_query(torch, sess, df_fn, checker, want, name, counters):
    """One cold and three warm runs; returns the per-run measurements and
    the kernel launches each run made.  ``counters`` maps each kernel the
    query must launch to its wrappers."""
    runs = []
    for i in range(4):
        before = launch_counts(counters)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        rows = df_fn().collect()
        end.record()
        end.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        stats = sess.last_query_stats()
        err = checker(rows, want)
        after = launch_counts(counters)
        launches = {k: after[k] - before[k] for k in counters}
        idle = [k for k, v in launches.items() if v == 0]
        check(not idle, f"{name} run {i} launched {idle} no time")
        runs.append({"run": "cold" if i == 0 else f"warm{i}",
                     "wall_ms": wall, "device_ms": start.elapsed_time(end),
                     "upload_ms": stats.upload_ms(),
                     "upload_bytes": stats.upload_bytes,
                     "syncs": stats.blocking_fetches,
                     "kernel_launches": launches, "max_rel_err": err})
        print(f"query {name} {runs[-1]['run']}: " + json.dumps(runs[-1]))
    return runs


# ---------------------------------------------------------------------------------
# Kernel timings at the main path's shapes
# ---------------------------------------------------------------------------------

def time_kernels(torch, groupby, device, launches, worst) -> list:
    """Each kernel, its plain version and the library call at the main
    path's batch shape, on the same inputs.  The kernel is first held
    against its plain version on those inputs; ``bound_ms`` counts the
    bytes that these inputs make the function move."""
    n = BATCH_ROWS
    rng = np.random.default_rng(5)
    t = _to_device(torch, device)
    out, moved = [], []

    # masked_reduce at Q6's shape: a float64 sum column and a count,
    # under Q6's ~2% live rows
    x = t(rng.uniform(900.0, 105000.0, n) * 0.06)
    active = t(rng.random(n) < 0.02)
    cols = [(x, None, "sum"), (None, None, "count")]
    err = compare_masked_reduce(torch, groupby, cols, active)
    acc_f, acc_i = groupby.init_scalars([("sum", True), ("sum", False)],
                                        device)
    inputs = copies_for_l2([x, active])

    def call(fn, xc, ac):
        return lambda: fn([(xc, None, "sum"), (None, None, "count")], ac,
                          acc_f, acc_i)

    ms = time_ms(torch, [call(groupby.masked_reduce, *c) for c in inputs],
                 reps=8 * len(inputs))
    plain_ms = time_ms(torch, [call(groupby.masked_reduce_plain, *c)
                               for c in inputs], reps=4 * len(inputs))
    zero = torch.zeros((), dtype=torch.float64, device=device)
    lib_ms = time_ms(torch, [(lambda xc=xc, ac=ac:
                              torch.where(ac, xc, zero).sum())
                             for xc, ac in inputs], reps=8 * len(inputs))
    live = active.nonzero().squeeze(1)
    nbytes = n + sum(column_bytes(torch, live, d, v) for d, v, _ in cols) \
        + 2 * 8 * len(cols)
    out.append({"name": "masked_reduce", "route": "cuda",
                "source": "spark_rapids_tpu_torch/csrc/masked_reduce.cu",
                "replaces": "spark_rapids_tpu/ops/groupby.py:396",
                "launches": launches["masked_reduce"],
                "max_abs_err": max(err, worst["masked_reduce"]),
                "ms": ms, "plain_ms": plain_ms,
                "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                "bound_by": "bytes", "library_ms": lib_ms})
    moved.append((nbytes, int(live.numel())))

    # grid_agg at Q1's shape: two code columns, dims (4, 2), seven float64
    # sums; the counts fold into the presence count
    dims = (4, 2)
    G = groupby.grid_size(dims)
    codes = [t(rng.integers(0, 3, n).astype(np.int32)),
             t(rng.integers(0, 2, n).astype(np.int32))]
    f_data = [t(rng.uniform(1.0, 1e5, n)) for _ in range(7)]
    active = t(rng.random(n) < 0.98)
    keys = [(c, None) for c in codes]
    f_cols = [(d, None) for d in f_data]
    err = compare_grid(torch, groupby, dims, keys, f_cols, [], active)
    acc_f = torch.zeros((G, 7), dtype=torch.float64, device=device)
    acc_i = torch.zeros((G, 0), dtype=torch.int64, device=device)
    acc_c = torch.zeros(G, dtype=torch.int64, device=device)
    inputs = copies_for_l2(codes + f_data + [active])

    def call(fn, c0, c1, *rest):
        *fs, ac = rest
        return lambda: fn([(c0, None), (c1, None)], dims,
                          [(d, None) for d in fs], [], ac, acc_f, acc_i,
                          acc_c)

    ms = time_ms(torch, [call(groupby.grid_agg, *c) for c in inputs],
                 reps=8 * len(inputs))
    plain_ms = time_ms(torch, [call(groupby.grid_agg_plain, *c)
                               for c in inputs], reps=2 * len(inputs))
    target = torch.zeros((G + 1, 8), dtype=torch.float64, device=device)
    lib_calls = []
    for c0, c1, *rest in inputs:
        *fs, ac = rest
        gid = torch.where(ac, c0.long() * (dims[1] + 1) + c1.long(), G)
        vals = torch.stack(fs + [torch.ones(n, dtype=torch.float64,
                                            device=device)], dim=1)
        lib_calls.append(lambda gid=gid, vals=vals:
                         target.index_add_(0, gid, vals))
    lib_ms = time_ms(torch, lib_calls, reps=8 * len(inputs))
    live = active.nonzero().squeeze(1)
    nbytes = n + sum(column_bytes(torch, live, d, v)
                     for d, v in keys + f_cols) + 2 * 8 * G * (7 + 1)
    out.append({"name": "grid_agg", "route": "cuda",
                "source": "spark_rapids_tpu_torch/csrc/grid_agg.cu",
                "replaces": "spark_rapids_tpu/ops/groupby.py:424",
                "launches": launches["grid_agg"],
                "max_abs_err": max(err, worst["grid_agg"]),
                "ms": ms, "plain_ms": plain_ms,
                "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                "bound_by": "bytes", "library_ms": lib_ms})
    moved.append((nbytes, int(live.numel())))
    for k, (nbytes, live_rows) in zip(out, moved):
        print(f"kernel {k['name']}: {k['ms']:.4f} ms at n={n}, "
              f"{live_rows} live rows (bound {k['bound_ms']:.4f} ms "
              f"for {nbytes} B, plain {k['plain_ms']:.4f} ms, "
              f"library {k['library_ms']:.4f} ms), max |err| vs plain "
              f"{k['max_abs_err']:.3e}, {k['launches']} launches on the "
              f"main path")
    return out


def _row(name, launches, err, ms, plain_ms, nbytes, lib_ms, replaces):
    return {"name": name, "route": "cuda",
            "source": f"spark_rapids_tpu_torch/csrc/{name}.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": lib_ms}


def time_new_kernels(torch, join, groupby, topk_mod, batch_utils, device,
                     launches, worst) -> list:
    """dense_join (probe), dense_agg (update), topk and compact at Q3's
    SF10 shapes, with their plain versions and a library yardstick, each
    first held against its plain version on the same inputs."""
    rng = np.random.default_rng(6)
    t = _to_device(torch, device)
    n = BATCH_ROWS
    out, notes = [], []

    # dense_join probe: join 2 -- a 15,003,036-slot table over the
    # (customer x orders) build side (~9.7% live), payload o_orderkey,
    # o_orderdate, o_shippriority; probe one lineitem batch, ~54% live
    D = Q3_ORDERS
    bkeys = torch.arange(1, D + 1, dtype=torch.int64, device=device)
    bactive = t(rng.random(D) < 0.097)
    table, _ = join.dense_join_build(bkeys, None, bactive, 1, D)
    payload = [(bkeys, None),
               (t(rng.integers(8036, 8036 + 2406, D).astype(np.int32)),
                None), (torch.zeros(D, dtype=torch.int64, device=device),
                        None)]
    pk = t(rng.integers(1, D + 1, n).astype(np.int64))
    pa = t(rng.random(n) < 0.54)
    _, err = compare_dense_join(torch, join, (bkeys, None, bactive),
                                (pk, None, pa), payload)
    inputs = copies_for_l2([pk, pa])

    def probe_call(fn, k, a):
        return lambda: fn(k, None, a, 1, table, payload)

    ms = time_ms(torch, [probe_call(join.dense_join_probe, *c)
                         for c in inputs], reps=8 * len(inputs))
    plain_ms = time_ms(torch, [probe_call(join.dense_join_probe_plain, *c)
                               for c in inputs], reps=2 * len(inputs))

    def lib_call(k, a):
        def run():
            bi = table.index_select(0, torch.where(a, k - 1, 0))
            safe = bi.clamp(min=0)
            return [d.index_select(0, safe) for d, _ in payload]
        return run

    lib_ms = time_ms(torch, [lib_call(*c) for c in inputs],
                     reps=8 * len(inputs))
    live = pa.nonzero().squeeze(1)
    slot = pk[live] - 1
    bi = table[slot].long()
    hit = bi[bi >= 0]
    nbytes = n + sector_bytes(torch, live, 8) + sector_bytes(torch, slot, 4) \
        + sum(sector_bytes(torch, hit, d.element_size()) for d, _ in payload) \
        + n * (1 + sum(d.element_size() for d, _ in payload))
    out.append(_row("dense_join", launches, max(err, worst["dense_join"]),
                    ms, plain_ms, nbytes, lib_ms,
                    "spark_rapids_tpu/plan/join_exec.py:1410"))
    notes.append(f"n={n} probe rows, {live.numel()} live, {hit.numel()} "
                 f"matched, table {D} slots")
    del table, payload, bkeys, bactive, inputs

    # dense_agg update: one lineitem batch of join 2's output, ~5.2% live,
    # key l_orderkey, residuals o_orderdate (int32) and o_shippriority,
    # a float64 revenue sum and a row count, into the widened domain of
    # 15,003,036 slots
    D = Q3_ORDERS
    key = t(rng.integers(1, Q3_ORDERS + 1, n).astype(np.int64))
    date = (key % 2406 + 8036).to(torch.int32)
    prio = torch.zeros(n, dtype=torch.int64, device=device)
    rev = t(rng.uniform(900.0, 105000.0, n))
    act = t(rng.random(n) < 0.052)
    channels = [("sum", True), ("count", False)]
    keys = [(key, None), (date, None), (prio, None)]
    err = compare_dense_agg(torch, groupby, 1, D, keys,
                            [(rev, None), (None, None)], channels, act,
                            cap=1 << 20)
    acc = groupby.DenseAccumulator(1, D, 2, channels, device)
    pacc = groupby.DenseAccumulator(1, D, 2, channels, device)
    inputs = copies_for_l2([key, date, prio, rev, act])

    def agg_call(fn, a, k, d, p, r, m):
        return lambda: fn(a, (k, None), [(d, None), (p, None)],
                          [(r, None), (None, None)], m)

    ms = time_ms(torch, [agg_call(groupby.dense_agg_update, acc, *c)
                         for c in inputs], reps=8 * len(inputs))
    plain_ms = time_ms_synced(torch, [agg_call(
        groupby.dense_agg_update_plain, pacc, *c) for c in inputs],
        reps=2 * len(inputs))
    # the sums of the function (revenue and count) in one index_add_: dead
    # rows add zeros at their own key, so no slot collects every dead row
    target = torch.zeros((D, 2), dtype=torch.float64, device=device)
    lib_calls = []
    for k, _, _, r, m in inputs:
        vals = torch.stack([r, torch.ones_like(r)], 1) * m[:, None]
        lib_calls.append(lambda k=k, vals=vals: target.index_add_(
            0, k - 1, vals))
    lib_ms = time_ms(torch, lib_calls, reps=8 * len(inputs))
    # the sum, the count and the presence byte change at every live row:
    # read and write of their slot sectors; each residual's vmin, vmax
    # (int64) and vdmax (int32) are read, and written only when a row
    # changes them, which these repeated calls never do
    live = act.nonzero().squeeze(1)
    slots = key[live] - 1
    nbytes = n + sum(sector_bytes(torch, live, x.element_size())
                     for x in (key, date, prio, rev)) \
        + 2 * (2 * sector_bytes(torch, slots, 8)
               + sector_bytes(torch, slots, 1)) \
        + 2 * (2 * sector_bytes(torch, slots, 8)
               + sector_bytes(torch, slots, 4))
    out.append(_row("dense_agg", launches, max(err, worst["dense_agg"]), ms,
                    plain_ms, nbytes, lib_ms,
                    "spark_rapids_tpu/plan/physical.py:1321"))
    notes.append(f"n={n} rows, {live.numel()} live, {D} slots")
    del acc, pacc, target, inputs, lib_calls

    # topk: Q3's ORDER BY revenue DESC, o_orderdate LIMIT 10 over its
    # 1,287,275 groups
    g = Q3_GROUPS
    rev = t(rng.uniform(0.0, 8e5, g))
    rvalid = torch.ones(g, dtype=torch.bool, device=device)
    odate = t(rng.integers(8036, 8036 + 2406, g).astype(np.int32))
    k = 10
    keys = [(rev, rvalid, False, False), (odate, None, True, True)]
    err = compare_topk(torch, topk_mod, keys, None, g, k)
    inputs = copies_for_l2([rev, rvalid, odate])

    def topk_call(fn, r, v, d):
        return lambda: fn([(r, v, False, False), (d, None, True, True)],
                          None, g, k)

    ms = time_ms(torch, [topk_call(topk_mod.topk, *c) for c in inputs],
                 reps=8 * len(inputs))
    plain_ms = time_ms_synced(torch, [topk_call(topk_mod.topk_plain, *c)
                                      for c in inputs], reps=2 * len(inputs))
    composite = [~topk_mod.sortable_view(r) for r, _, _ in inputs]
    lib_ms = time_ms_synced(torch, [(lambda c=c: torch.topk(
        c, k, largest=False)) for c in composite], reps=8 * len(inputs))
    nbytes = g * (8 + 1 + 4) + k * 8
    out.append(_row("topk", launches, max(err, worst["topk"]), ms, plain_ms,
                    nbytes, lib_ms, "spark_rapids_tpu/plan/exec_nodes.py:236"))
    notes.append(f"n={g} rows, k={k}")
    del inputs, composite

    # compact: Q3's aggregate output, 15,003,037 slots (the domain and the
    # null key's slot) of which ~1.29 M observed; l_orderkey, o_orderdate,
    # o_shippriority, revenue + validity
    S = Q3_ORDERS + 1
    present = torch.zeros(S, dtype=torch.bool, device=device)
    present[t(rng.choice(S - 1, Q3_GROUPS, replace=False))] = True
    cols = [(torch.arange(S, dtype=torch.int64, device=device), None),
            (t(rng.integers(8036, 8036 + 2406, S).astype(np.int32)), None),
            (torch.zeros(S, dtype=torch.int64, device=device), None),
            (t(rng.uniform(0.0, 8e5, S)), present.clone())]
    err = compare_compact(torch, batch_utils, cols, present)
    inputs = copies_for_l2([present] + [x for d, v in cols
                                        for x in (d, v) if x is not None])

    def compact_call(fn, m, c0, c1, c2, c3, v3):
        return lambda: fn([(c0, None), (c1, None), (c2, None), (c3, v3)], m,
                          Q3_GROUPS)

    ms = time_ms(torch, [compact_call(batch_utils.compact_kernel, *c)
                         for c in inputs], reps=8 * len(inputs))
    plain_ms = time_ms_synced(torch, [compact_call(
        batch_utils.compact_plain, *c) for c in inputs],
        reps=2 * len(inputs))
    lib_ms = time_ms_synced(torch, [(lambda c=c: [x[c[0]] for x in c[1:]])
                                    for c in inputs], reps=2 * len(inputs))
    live = present.nonzero().squeeze(1)
    nbytes = S + sum(sector_bytes(torch, live, d.element_size())
                     for d, _ in cols) + sector_bytes(torch, live, 1) \
        + Q3_GROUPS * (8 + 4 + 8 + 8 + 1)
    out.append(_row("compact", launches, max(err, worst["compact"]), ms,
                    plain_ms, nbytes, lib_ms,
                    "spark_rapids_tpu/ops/batch_utils.py:280"))
    notes.append(f"n={S} slots, {Q3_GROUPS} live, 4 columns")
    # the calls that wait on the device themselves, timed by time_ms_synced
    synced = {("dense_agg", "plain"), ("topk", "plain"), ("topk", "library"),
              ("compact", "plain"), ("compact", "library")}

    def mark(row, which):
        return "\u2020" if (row["name"], which) in synced else ""

    for row, note in zip(out, notes):
        print(f"kernel {row['name']}: {row['ms']:.4f} ms at {note} (bound "
              f"{row['bound_ms']:.4f} ms, plain {row['plain_ms']:.4f} ms"
              f"{mark(row, 'plain')}, library {row['library_ms']:.4f} ms"
              f"{mark(row, 'library')}), max |err| vs plain "
              f"{row['max_abs_err']:.3e}, {row['launches']} launches on the "
              f"main path")
    print("\u2020 the call waits on the device itself: timed one call per "
          "event pair")
    return out


# ---------------------------------------------------------------------------------

def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: FAIL: torch is not importable ({e})",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: FAIL: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    try:
        from spark_rapids_tpu_torch import Session, kernels
        from spark_rapids_tpu_torch.models import tpch
        from spark_rapids_tpu_torch.ops import batch_utils, groupby, join
        from spark_rapids_tpu_torch.ops import topk as topk_mod
    except ImportError as e:
        print(f"chip_smoke: FAIL: the port is not importable ({e})",
              file=sys.stderr)
        return 2
    if any(m == "jax" or m.startswith(("jax.", "spark_rapids_tpu."))
           or m == "spark_rapids_tpu" for m in sys.modules):
        print("chip_smoke: FAIL: JAX or the JAX package got imported",
              file=sys.stderr)
        return 2
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
        device = torch.device("cuda", 0)
        kind = torch.cuda.get_device_name(0)
        print(f"device: {smi}")
        print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
              f"python {sys.version.split()[0]}")

        t0 = time.perf_counter()
        built = kernels.build()
        each = ", ".join(f"{k} {v:.1f} s" for k, v in built.items())
        print(f"build: {time.perf_counter() - t0:.1f} s ({each})")
        for name in kernels.KERNELS:
            log = kernels.build_log(name)
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"ptxas {name}: {line.strip()}")

        worst = check_kernels(torch, groupby, device)
        worst.update(check_new_kernels(torch, join, groupby, topk_mod,
                                       batch_utils, device))

        t0 = time.perf_counter()
        data = tpch.gen_lineitem_arrays(SF)
        n_rows = len(data["l_quantity"])
        check(n_rows == int(tpch.LINEITEM_ROWS_PER_SF * SF),
              f"SF{SF:g} lineitem has {n_rows} rows")
        print(f"datagen: {n_rows} rows in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        orders, cust = tpch.gen_orders_arrays(SF), tpch.gen_customer_arrays(SF)
        check(len(orders["o_orderkey"]) == Q3_ORDERS
              and len(cust["c_custkey"]) == 1_500_000,
              f"SF{SF:g} orders/customer have {len(orders['o_orderkey'])}/"
              f"{len(cust['c_custkey'])} rows")
        print(f"datagen orders + customer: {len(orders['o_orderkey'])} + "
              f"{len(cust['c_custkey'])} rows in "
              f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        q6_want, q1_want = tpch.q6_numpy(data), tpch.q1_numpy(data)
        q3_want = tpch.q3_numpy(cust, orders, data)
        print(f"oracles: {time.perf_counter() - t0:.1f} s")
        sess = Session.get_or_create(device="cuda")
        info = sess.device_info()
        print(f"session device: {info.name}, "
              f"{info.memory_bytes / 2**30:.1f} GiB, power limit "
              f"{info.power_limit}")
        df = sess.create_dataframe(data)
        cdf, odf = sess.create_dataframe(cust), sess.create_dataframe(orders)

        counters = {
            "masked_reduce": [groupby.masked_reduce],
            "grid_agg": [groupby.grid_agg],
            "dense_join": [join.dense_join_stats, join.dense_join_build,
                           join.dense_join_probe],
            "dense_agg": [groupby.dense_agg_stats, groupby.dense_agg_update,
                          groupby.dense_agg_check],
            "topk": [topk_mod.topk], "compact": [batch_utils.compact_kernel]}
        paths = [("q6", lambda: tpch.q6(df), check_q6, q6_want,
                  ("masked_reduce",)),
                 ("q1", lambda: tpch.q1(df), check_q1, q1_want,
                  ("grid_agg",)),
                 ("q3", lambda: tpch.q3(cdf, odf, df), check_q3, q3_want,
                  ("dense_join", "dense_agg", "topk", "compact"))]
        runs_of, launches, per_wrapper = {}, {}, {}
        for name, df_fn, checker, want, used in paths:
            mine = {k: counters[k] for k in used}
            for fns in mine.values():  # counts from 0 just before the path
                for fn in fns:
                    fn.launches = 0
            runs_of[name] = run_query(torch, sess, df_fn, checker, want,
                                      name, mine)
            launches.update(launch_counts(mine))  # read just after it
            per_wrapper.update({fn.__name__: fn.launches
                                for fns in mine.values() for fn in fns})
        q6_runs, q1_runs, q3_runs = (runs_of[k] for k in ("q6", "q1", "q3"))
        check(all(launches.values()), f"a kernel of the main path was never "
              f"launched: {launches}")
        print("main path launches per kernel wrapper: "
              + json.dumps(per_wrapper))
        fetches = max(r["syncs"] for r in q3_runs)
        check(fetches <= Q3_REFERENCE_FETCHES, f"Q3 made {fetches} blocking "
              f"fetches, more than the reference's {Q3_REFERENCE_FETCHES}")
        for name, runs in (("q6", q6_runs), ("q1", q1_runs), ("q3", q3_runs)):
            warm = runs[1:]
            med = {k: statistics.median(r[k] for r in warm)
                   for k in ("wall_ms", "upload_ms", "device_ms")}
            print(f"query {name} warm median: wall {med['wall_ms']:.2f} ms, "
                  f"upload {med['upload_ms']:.2f} ms, device span "
                  f"{med['device_ms']:.2f} ms, syncs {warm[-1]['syncs']}, "
                  f"{warm[-1]['kernel_launches']} kernel launches per query")

        del df, cdf, odf, sess
        table = time_kernels(torch, groupby, device, launches, worst)
        table += time_new_kernels(torch, join, groupby, topk_mod,
                                  batch_utils, device, launches, worst)
        torch.cuda.synchronize()
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": table}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
