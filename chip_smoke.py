#!/usr/bin/env python3
"""Smoke test of spark_rapids_tpu_torch on one CUDA card.

    python3 chip_smoke.py [--checks-only]

Builds the hand-written CUDA kernels from ``spark_rapids_tpu_torch/csrc``,
holds each against its plain PyTorch version on the card (``--checks-only``
stops there), then drives the port's main path through
``Session.create_dataframe`` → ``collect``: TPC-H Q6 and Q1 over seeded
SF10 lineitem data (60,012,150 rows), Q3 over SF10 lineitem, orders
(15,003,036 rows) and customer (1,500,000 rows), Q4, Q13, Q18 and Q21
over the reference suite's gen_db tables at SF10 (lineitem 60,012,150,
orders 15,000,000, customer 1,500,000, supplier 100,000 rows), and Q10
over the same tables in the reference's two configurations: the defaults,
where the second join's staged side flips it to a broadcast join, and
AQE off, where it joins 8 hash partition pairs.  It checks
the results against numpy oracles and shows that each query went through
its kernels.  Prints per-query and per-kernel timings, a
``{"kernels": [...]}`` line, the card's name and power limit, and as its
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
# the reference suite's gen_db shapes at SF10 (Q4, Q13, Q18, Q21)
DB_ORDERS = 15_000_000
DB_CUSTOMERS = 1_500_000
DB_SUPPLIERS = 100_000
DB_LINEITEM = 60_012_150
DB_COLUMNS = {"lineitem": ["l_orderkey", "l_partkey", "l_suppkey",
                           "l_quantity", "l_commitdate", "l_receiptdate",
                           "l_returnflag", "l_extendedprice", "l_discount",
                           "l_shipdate"],
              "orders": ["o_orderkey", "o_custkey", "o_orderstatus",
                         "o_totalprice", "o_orderdate", "o_orderpriority"],
              # every column: Q10's first join builds the side the
              # reference does only if customer is estimated at the full
              # width of its table, as the reference's is
              "customer": None,
              "supplier": ["s_suppkey", "s_name", "s_nationkey"],
              "partsupp": None, "nation": None}
DB_PARTSUPP = 8_000_000
Q11_TABLES = ("partsupp", "supplier", "nation")
DB_QUERIES = {"q4": ("orders", "lineitem"), "q13": ("customer", "orders"),
              "q11": Q11_TABLES,
              "q18": ("orders", "lineitem", "customer"),
              "q21": ("lineitem", "orders", "supplier"),
              "q10": ("customer", "orders", "lineitem")}
# Q10 with AQE off: the reference's blocking fetches for the same plan
# (tools/fetch_budget.py at SF1 with 400,000-row batches, which cut
# lineitem into the 15 batches it has at SF10): the port's ceiling
Q10_SHUFFLED_REFERENCE_FETCHES = 53
# blocking fetch ceilings of the slice-5 paths at SF10: the reference's
# count for the same plan (tools/fetch_budget.py at SF1 with 400,000-row
# batches, which give lineitem the 15 batches it has at SF10)
SLICE5_FETCH_CEILINGS = {"s1": (33, "the reference's count"),
                         "w1": (4, "the reference's count")}


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
    """Stats exact, the duplicate count included; where the keys are
    unique, the table exact and the probe on it exact for every join type
    (inner and left with the payload, semi and anti without): selection,
    data and validity.  Returns the duplicate count and the largest
    difference of the probe's outputs."""
    bk, bv, ba = build
    cap = 1 << 26
    ks = join.dense_join_stats(*build, cap)
    ps = join.dense_join_stats_plain(*build, cap)
    torch.cuda.synchronize()
    check(torch.equal(ks, ps), f"dense_join stats {ks.tolist()} vs "
          f"{ps.tolist()}")
    kmin, kmax, count, dups = ks.tolist()
    if count == 0 or dups:
        return dups, 0.0
    D = kmax - kmin + 1
    kt = join.dense_join_build(bk, bv, ba, kmin, D)
    pt = join.dense_join_build_plain(bk, bv, ba, kmin, D)
    torch.cuda.synchronize()
    check(torch.equal(kt, pt), "dense_join tables differ")
    err = 0.0
    for how in ("inner", "semi", "anti", "left"):
        pay = payload if how in ("inner", "left") else []
        ksel, kcols = join.dense_join_probe(*probe, kmin, kt, pay, how)
        psel, pcols = join.dense_join_probe_plain(*probe, kmin, kt, pay, how)
        torch.cuda.synchronize()
        check(torch.equal(ksel, psel), f"dense_join {how} selections differ")
        err = max(err, max_abs_diff(ksel, psel))
        for j, ((kd_, kv_), (pd_, pv_)) in enumerate(zip(kcols, pcols)):
            check(torch.equal(kd_, pd_),
                  f"dense_join {how} payload {j} data differs")
            check((kv_ is None) == (pv_ is None)
                  and (kv_ is None or torch.equal(kv_, pv_)),
                  f"dense_join {how} payload {j} validity differs")
            err = max(err, max_abs_diff(kd_, pd_))
            if kv_ is not None:
                err = max(err, max_abs_diff(kv_, pv_))
    return 0, err


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
    check(dups == 1, f"dense_join reported {dups} repeated keys, not 1")
    print("check dense_join: build 0/1/1000/200003 rows (one all-inactive), "
          "probe up to 4194321 rows with null, missing and out-of-domain "
          "keys, inner/semi/anti/left: ok; a repeated build key counted "
          "exactly: ok")
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
# csr_join: kernel vs plain
# ---------------------------------------------------------------------------------

def csr_case(torch, n_build, n_probe, span, seed, device, all_inactive=False):
    """Build keys over ``span`` values (repeated about n_build / span times,
    some null, a live mask), probe keys that hit, miss (below and above the
    domain) and are null, and a payload of 8, 4 and 1-byte columns."""
    rng = np.random.default_rng(seed)
    t = _to_device(torch, device)
    bkeys = rng.integers(1000, 1000 + span, n_build).astype(np.int64)
    build = (t(bkeys), t(rng.random(n_build) < 0.95),
             t(rng.random(n_build) < (0.0 if all_inactive else 0.8)))
    pkeys = rng.integers(990, 1010 + span, n_probe).astype(np.int64)
    probe = (t(pkeys), t(rng.random(n_probe) < 0.95),
             t(rng.random(n_probe) < 0.8))
    payload = [(t(rng.integers(-10**12, 10**12, n_build)),
                t(rng.random(n_build) < 0.9)),
               (t(rng.integers(0, 10**6, n_build).astype(np.int32)), None),
               (t(rng.random(n_build) < 0.5), None)]
    return build, probe, payload


def _same_values(torch, a, b, what: str) -> float:
    """Exact equality of two lists of (data, valid); their largest
    difference (0.0 when equal)."""
    err = 0.0
    for j, ((ad, av), (bd, bv)) in enumerate(zip(a, b)):
        check(torch.equal(ad, bd), f"{what} column {j} data differs")
        check((av is None) == (bv is None)
              and (av is None or torch.equal(av, bv)),
              f"{what} column {j} validity differs")
        err = max(err, max_abs_diff(ad, bd))
    return err


def compare_csr_join(torch, join, build, probe, payload) -> float:
    """The build (counts, starts, b_perm: the stable order makes the
    permutation unique), every probe mode, the expansion and the gathers
    exact against the plain versions; returns the largest difference."""
    bk, bv, ba = build
    st = join.dense_join_stats_plain(bk, bv, ba, 1 << 26).tolist()
    kmin, D = (st[0], st[1] - st[0] + 1) if st[2] else (0, 1)
    kb = join.csr_build_kernel(bk, bv, ba, kmin, D)
    pb = join.csr_build_plain(bk, bv, ba, kmin, D)
    torch.cuda.synchronize()
    for name, x, y in zip(("counts", "starts", "b_perm"), kb, pb):
        check(torch.equal(x, y), f"csr_join build {name} differs")
    counts, starts, b_perm = kb
    err = 0.0
    for how in ("semi", "anti"):
        ks = join.csr_probe_kernel(*probe, kmin, counts, starts, how)
        ps = join.csr_probe_plain(*probe, kmin, counts, starts, how)
        torch.cuda.synchronize()
        check(torch.equal(ks, ps), f"csr_join {how} selections differ")
    for how in ("inner", "left"):
        klo, koff = join.csr_probe_kernel(*probe, kmin, counts, starts, how)
        plo, poff = join.csr_probe_plain(*probe, kmin, counts, starts, how)
        torch.cuda.synchronize()
        check(torch.equal(klo, plo) and torch.equal(koff, poff),
              f"csr_join {how} probe differs")
        total = int(koff[-1])
        kpi, kbi = join.csr_expand_kernel(koff, klo, b_perm, total)
        ppi, pbi = join.csr_expand_plain(koff, klo, b_perm, total)
        torch.cuda.synchronize()
        check(torch.equal(kpi, ppi) and torch.equal(kbi, pbi),
              f"csr_join {how} expansion differs")
        for idx, nullable in ((kbi, how == "left"), (kpi, False)):
            cols = payload if idx is kbi else [(probe[0], probe[1])]
            err = max(err, _same_values(
                torch, join.csr_gather(idx, cols, nullable),
                join.csr_gather_plain(idx, cols, nullable),
                f"csr_join {how} gather"))
    return err


def check_csr_join(torch, join, device) -> float:
    worst = 0.0
    for nb, npr, span, seed, kw in ((0, 100, 10, 1, {}), (1, 1, 1, 2, {}),
                                    (3000, 5000, 50, 3, {}),
                                    (3000, 5000, 50, 4,
                                     {"all_inactive": True}),
                                    (5000, 2000, 1, 5, {}),
                                    (2_000_003, BATCH_ROWS + 17, 600_000, 6,
                                     {})):
        worst = max(worst, compare_csr_join(torch, join, *csr_case(
            torch, nb, npr, span, seed, device, **kw)))
    print("check csr_join: build 0/1/3000/5000 (one key)/2000003 rows (one "
          "all-inactive), probe up to 4194321 rows with null, missing and "
          "out-of-domain keys; build, semi/anti/inner/left probe, "
          "expansion and gathers exact: ok")
    return worst


# ---------------------------------------------------------------------------------
# hash_agg: kernel vs plain
# ---------------------------------------------------------------------------------

def hash_case(torch, n, seed, device, groups=None):
    """Key words of every kind (int64, date, bool, dictionary codes, the
    float64 image of -0.0/+0.0/NaN keys), each with nulls, or two int64
    keys over ``groups`` pairs; contributions with nulls and NaN."""
    from spark_rapids_tpu_torch.ops import groupby
    rng = np.random.default_rng(seed)
    t = _to_device(torch, device)
    if groups is None:
        fk = rng.choice(np.array([-0.0, 0.0, 1.5, np.nan, -2.0]), n)
        raw = [rng.integers(-50, 50, n), rng.integers(9000, 9030, n)
               .astype(np.int32), rng.random(n) < 0.5,
               rng.integers(0, 40, n).astype(np.int32), fk]
        words = [(groupby.key_word(t(r)), t(rng.random(n) < 0.9))
                 for r in raw]
    else:
        words = [(t(rng.integers(0, groups, n)), None),
                 (t(rng.integers(0, 7, n)), None)]
    x = rng.normal(size=n) * 1e3
    x[rng.random(n) < 0.001] = np.nan
    z = rng.choice(np.array([-0.0, 0.0, 3.0, -1.0]), n)
    contribs = [(t(x), t(rng.random(n) < 0.9)), (t(rng.integers(
        -10**12, 10**12, n)), None), (t(z), None), (t(x), None),
        (t(rng.integers(-10**15, 10**15, n)), t(rng.random(n) < 0.8)),
        (None, t(rng.random(n) < 0.7))]
    channels = [("sum", True), ("sum", False), ("min", True), ("max", True),
                ("max", False), ("count", False)]
    return words, contribs, channels, t(rng.random(n) < 0.8)


def _hash_groups(torch, acc):
    """The accumulator's groups as (key matrix, values) sorted by key, the
    kernel's live slots compacted by mask."""
    keys, values, live = acc.finish()
    cols = [w for w, _ in keys] + [ok.long() for _, ok in keys]
    if live is not None:
        cols = [c[live] for c in cols]
        values = [v[live] for v in values]
    m = torch.stack(cols, 1)
    order = torch.arange(m.shape[0], device=m.device)
    for c in reversed(range(m.shape[1])):
        order = order[torch.sort(m[order, c], stable=True).indices]
    return m[order], [v[order] for v in values]


def run_hash_agg(torch, groupby, case, batch, plain, collide=False,
                 abs_values=False):
    words, contribs, channels, active = case
    if abs_values:
        contribs = [(d.abs() if d is not None and d.dtype == torch.float64
                     else d, v) for d, v in contribs]
    acc = groupby.HashAccumulator(len(words), channels, active.device,
                                  collide=collide, plain=plain)
    n = active.shape[0]
    for lo in range(0, max(n, 1), batch):
        sl = slice(lo, lo + batch)
        acc.update([(d[sl], None if v is None else v[sl]) for d, v in words],
                   [(None if d is None else d[sl],
                     None if v is None else v[sl]) for d, v in contribs],
                   active[sl], len(active[sl]))
    return acc


def compare_hash_agg(torch, groupby, case, batch, collide=False) -> float:
    """Groups (keys and null bits) exact, int64 channels and counts exact,
    float64 min/max exact to the bit (NaN included), float64 sums within
    F64_SUM_TOL x the group's sum|x|.  Returns the largest float64 sum
    difference."""
    kacc = run_hash_agg(torch, groupby, case, batch, False, collide)
    pacc = run_hash_agg(torch, groupby, case, batch, True)
    sacc = run_hash_agg(torch, groupby, case, batch, True, abs_values=True)
    check(kacc.cap == pacc.cap, "hash_agg grew differently from the plain "
          "version")
    km, kv = _hash_groups(torch, kacc)
    pm, pv = _hash_groups(torch, pacc)
    _, sv = _hash_groups(torch, sacc)
    torch.cuda.synchronize()
    check(torch.equal(km, pm), f"hash_agg groups differ ({km.shape[0]} vs "
          f"{pm.shape[0]})")
    worst = 0.0
    for j, ((op, f64), a, b, s) in enumerate(zip(case[2], kv, pv, sv)):
        if f64 and op == "sum":
            nan = torch.isnan(b)
            check(torch.equal(torch.isnan(a), nan), f"hash_agg channel {j} "
                  f"NaN sums differ")
            err = (a - b).abs()[~nan]
            top = float(err.max()) if err.numel() else 0.0
            check(bool((err <= F64_SUM_TOL * s[~nan]).all()),
                  f"hash_agg channel {j} sums differ by up to {top}")
            worst = max(worst, top)
        elif f64:
            check(torch.equal(a.view(torch.int64), b.view(torch.int64)),
                  f"hash_agg channel {j} ({op}) differs")
        else:
            check(torch.equal(a, b), f"hash_agg channel {j} ({op}) differs")
    return worst


def check_hash_agg(torch, groupby, device) -> float:
    worst = 0.0
    for n, batch, seed, groups, collide in (
            (0, 1, 1, None, False), (1, 1, 2, None, False),
            (5000, 5000, 3, None, False), (20_000, 1000, 4, None, False),
            (3000, 3000, 5, 200, True),
            (BATCH_ROWS + 17, BATCH_ROWS + 17, 6, 1_000_000, False)):
        case = hash_case(torch, n, seed, device, groups)
        worst = max(worst, compare_hash_agg(torch, groupby, case, batch,
                                            collide))
    case = hash_case(torch, 5000, 7, device)
    case = case[:3] + (torch.zeros_like(case[3]),)
    compare_hash_agg(torch, groupby, case, 5000)
    print(f"check hash_agg: n in (0, 1, 5000, 20000 in 1000-row batches "
          f"with growth, 4194321), all-inactive, every key kind with nulls, "
          f"-0.0/+0.0 and NaN keys and values, 1400 keys forced into one "
          f"bucket: ok, max |f64 err| {worst:.3e} (tolerance "
          f"{F64_SUM_TOL} x per-group sum|x|)")
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


def check_rows(name: str):
    """A checker for rows that must equal the oracle's: strings, integers
    and dates exact, floats within QUERY_REL_TOL."""
    def checker(rows, want) -> float:
        check(len(rows) == len(want), f"{name} has {len(rows)} rows, oracle "
              f"{len(want)}")
        worst = 0.0
        for got, ref in zip(rows, want):
            check(len(got) == len(ref), f"{name} row {got} vs {ref}")
            for a, b in zip(got, ref):
                if isinstance(b, float):
                    check(a is not None and rel_err(a, b) <= QUERY_REL_TOL,
                          f"{name} {got} vs {ref}")
                    worst = max(worst, rel_err(a, b))
                else:
                    check(a == b, f"{name} {got} vs {ref}")
        return worst
    return checker


def _days(a: np.ndarray) -> np.ndarray:
    return a.astype("datetime64[D]").astype(np.int64).astype(np.int32) \
        if a.dtype.kind == "M" else a


def check_device_columns(name: str, exact_floats: bool):
    """A checker for ``to_device_arrays`` results against an oracle dict
    ``{column: (data, valid)}`` or ``{column: data}``: validity equal,
    integers and dates equal, floats equal (``exact_floats``) or within
    QUERY_REL_TOL where valid."""
    def checker(out, want) -> float:
        check(set(out) == set(want), f"{name} columns {sorted(out)}")
        worst = 0.0
        for c, w in want.items():
            wd, wv = w if isinstance(w, tuple) else (w, None)
            wd = _days(wd)
            gd, gv = out[c]
            gd = gd.cpu().numpy()
            check(gd.shape == wd.shape, f"{name}.{c}: {gd.shape[0]} rows, "
                  f"oracle {wd.shape[0]}")
            ok = np.ones(len(wd), dtype=bool) if wv is None else wv
            got_ok = np.ones(len(gd), dtype=bool) if gv is None \
                else gv.cpu().numpy()
            check(np.array_equal(got_ok, ok), f"{name}.{c}: nulls differ")
            if wd.dtype.kind == "f" and not exact_floats:
                err = np.abs(gd[ok] - wd[ok]) / np.maximum(np.abs(wd[ok]),
                                                           1e-300)
                e = float(err.max()) if err.size else 0.0
                check(e <= QUERY_REL_TOL, f"{name}.{c}: rel err {e:.3e}")
                worst = max(worst, e)
            else:
                check(np.array_equal(gd[ok], wd[ok]),
                      f"{name}.{c} differs from the oracle")
        return worst
    return checker


class ModeCounter:
    """The launches of ``dense_join_probe`` in the given join types, as one
    counter with the wrappers' ``launches`` interface."""

    def __init__(self, fn, modes):
        self.fn, self.modes = fn, modes
        self.__name__ = f"{fn.__name__}[{'/'.join(modes)}]"

    @property
    def launches(self) -> int:
        return sum(self.fn.launches_by_how[m] for m in self.modes)

    @launches.setter
    def launches(self, value: int) -> None:
        check(value == 0, "a mode counter only resets")
        for m in self.modes:
            self.fn.launches_by_how[m] = 0


def launch_counts(counters) -> dict:
    """Per kernel source, the launches of its wrappers so far."""
    return {name: sum(fn.launches for fn in fns)
            for name, fns in counters.items()}


def collect(df):
    return df.collect()


def to_device(df):
    return df.to_device_arrays()


def run_query(torch, sess, df_fn, checker, want, name, counters,
              result=collect):
    """One cold and three warm runs; returns the per-run measurements and
    the kernel launches each run made.  Syncs and upload bytes count every
    query the path runs (Q11 runs two: its total, then the rest); upload
    ms is the last query's.  ``counters`` maps each kernel the
    query must launch to its wrappers; ``result`` ends the query (rows on
    the host, or ``to_device_arrays``, whose tensors the checker reads
    after the timed span)."""
    from spark_rapids_tpu_torch.utils.metrics import QueryStats
    runs = []
    for i in range(4):
        before = launch_counts(counters)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        with QueryStats.scoped() as path_stats:  # every query of the path
            rows = result(df_fn())
        end.record()
        end.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        stats = sess.last_query_stats()
        err = checker(rows, want)
        out_rows = len(rows) if isinstance(rows, list) else (
            next(iter(rows.values()))[0].shape[0] if rows else 0)
        del rows
        after = launch_counts(counters)
        launches = {k: after[k] - before[k] for k in counters}
        idle = [k for k, v in launches.items() if v == 0]
        check(not idle, f"{name} run {i} launched {idle} no time")
        runs.append({"run": "cold" if i == 0 else f"warm{i}",
                     "wall_ms": wall, "device_ms": start.elapsed_time(end),
                     "upload_ms": stats.upload_ms(),
                     "upload_bytes": path_stats.upload_bytes,
                     "syncs": path_stats.blocking_fetches,
                     "kernel_launches": launches, "max_rel_err": err,
                     "output_rows": out_rows})
        print(f"query {name} {runs[-1]['run']}: " + json.dumps(runs[-1]))
    return runs


def profile_query(torch, df_fn, name: str, top: int = 8,
                  result=collect) -> None:
    """One more warm run under ``torch.profiler`` (CUDA activity only):
    the device time of its kernels and copies by name, and the share of
    the run's device span that none of them covers (the device idle
    share)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start.record()
        result(df_fn())
        end.record()
        end.synchronize()
    span = start.elapsed_time(end)
    events = [(getattr(e, "device_time_total", None)
               or getattr(e, "cuda_time_total", 0.0), e.count, e.key)
              for e in prof.key_averages()]
    events = sorted((e for e in events if e[0] > 0), reverse=True)
    busy = sum(us for us, _, _ in events) / 1e3
    if not events:
        print(f"profile {name}: the profiler recorded no device time")
        return
    print(f"profile {name}: span {span:.2f} ms, kernels and copies "
          f"{busy:.2f} ms, idle share {max(0.0, 1 - busy / span):.3f}")
    for us, count, key in events[:top]:
        print(f"profile {name}:   {us / 1e3:9.3f} ms  {count:5d} x  "
              f"{key[:90]}")


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
    table = join.dense_join_build(bkeys, None, bactive, 1, D)
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


def time_slice3_kernels(torch, join, groupby, device, launches,
                        worst) -> list:
    """The dense join's semi probe, the CSR join and the hash aggregate at
    the shapes Q18, Q13 and Q21 give them at SF10, each first held against
    its plain version on the same inputs."""
    rng = np.random.default_rng(7)
    t = _to_device(torch, device)
    n = BATCH_ROWS
    out, notes = [], []

    # dense_join semi probe: Q18's orders batch (o_orderkey 1..) against
    # the table of the orders whose quantity passes 300 (~0.1% of the
    # 15,000,000-slot domain)
    D = DB_ORDERS
    bkeys = torch.arange(1, D + 1, dtype=torch.int64, device=device)
    table = join.dense_join_build(bkeys, None, t(rng.random(D) < 0.001), 1, D)
    pk = torch.arange(1, n + 1, dtype=torch.int64, device=device)
    ksel, _ = join.dense_join_probe(pk, None, None, 1, table, [], "semi")
    psel, _ = join.dense_join_probe_plain(pk, None, None, 1, table, [],
                                          "semi")
    torch.cuda.synchronize()
    check(torch.equal(ksel, psel), "dense_join semi probe differs at Q18's "
          "shape")
    inputs = copies_for_l2([pk])
    ms = time_ms(torch, [(lambda k=k: join.dense_join_probe(
        k, None, None, 1, table, [], "semi")) for k, in inputs],
        reps=8 * len(inputs))
    plain_ms = time_ms(torch, [(lambda k=k: join.dense_join_probe_plain(
        k, None, None, 1, table, [], "semi")) for k, in inputs],
        reps=2 * len(inputs))
    lib_ms = time_ms(torch, [(lambda k=k: table.index_select(0, k - 1) >= 0)
                             for k, in inputs], reps=8 * len(inputs))
    nbytes = n * 8 + sector_bytes(torch, pk - 1, 4) + n
    row = _row("dense_join", launches, max_abs_diff(ksel, psel), ms,
               plain_ms, nbytes, lib_ms,
               "spark_rapids_tpu/plan/join_exec.py:1410")
    row.update(name="dense_join_semi",
               launches=launches["dense_join_semi"])
    out.append(row)
    notes.append(f"n={n} probe rows, {int(ksel.sum())} matched, table {D} "
                 f"slots")
    del table, bkeys, inputs

    # csr_join: Q13's left join — build the orders that are not urgent
    # (15,000,000 rows, ~80% live, o_custkey over 1,500,000 slots), probe
    # the 1,500,000 customers, expand, gather o_orderkey and o_custkey
    nb, C = DB_ORDERS, DB_CUSTOMERS
    ckey = t(rng.integers(1, C + 1, nb))
    okey = torch.arange(1, nb + 1, dtype=torch.int64, device=device)
    act = t(rng.random(nb) < 0.8)
    probe = torch.arange(1, C + 1, dtype=torch.int64, device=device)
    payload = [(okey, None), (ckey, None)]

    def join_call(build, probe_keys, total, expand, gather):
        def run():
            counts, starts, b_perm = build(ckey, None, act, 1, C)
            lo, off = (join.csr_probe_kernel if build is join.csr_build_kernel
                       else join.csr_probe_plain)(probe_keys, None, None, 1,
                                                  counts, starts, "left")
            pi, bi = expand(off, lo, b_perm, total)
            return gather(pi, [(probe_keys, None)], False) + gather(
                bi, payload, True)
        return run

    counts, starts, b_perm = join.csr_build_kernel(ckey, None, act, 1, C)
    lo, off = join.csr_probe_kernel(probe, None, None, 1, counts, starts,
                                    "left")
    total = int(off[-1])
    kernel = join_call(join.csr_build_kernel, probe, total,
                       join.csr_expand_kernel, join.csr_gather)
    plain = join_call(join.csr_build_plain, probe, total,
                      join.csr_expand_plain, join.csr_gather_plain)
    err = _same_values(torch, kernel(), plain(), "csr_join at Q13's shape")
    ms = time_ms(torch, [kernel], reps=8)
    plain_ms = time_ms_synced(torch, [plain], reps=2)

    def library():
        k = torch.where(act, ckey, C + 1)
        sk, perm = torch.sort(k, stable=True)
        lo_ = torch.searchsorted(sk, probe)
        hi_ = torch.searchsorted(sk, probe, right=True)
        cnt = (hi_ - lo_).clamp(min=1)
        pi = torch.repeat_interleave(torch.arange(C, device=device), cnt,
                                     output_size=total)
        first = torch.cumsum(cnt, 0) - cnt
        j = torch.arange(total, device=device) - first[pi] + lo_[pi]
        hit = j < hi_[pi]
        bi = torch.where(hit, perm[j.clamp(max=nb - 1)], -1)
        return probe[pi], [d[bi.clamp(min=0)] for d, _ in payload], hit

    lib_ms = time_ms_synced(torch, [library], reps=8)
    # the function's inputs once (build keys and mask, probe keys, the
    # two build columns at the matched rows, by sector) and its outputs
    # (three int64 columns and two validity masks per output row); the
    # counts, starts, permutation and gather maps are its own scratch
    bi = b_perm[:int(starts[-1])]
    nbytes = nb * (8 + 1) + C * 8 + 2 * sector_bytes(torch, bi, 8) \
        + total * (3 * 8 + 2)
    out.append(_row("csr_join", launches, max(err, worst["csr_join"]), ms,
                    plain_ms, nbytes, lib_ms,
                    "spark_rapids_tpu/plan/join_exec.py:1040"))
    notes.append(f"build {nb} rows ({int(act.sum())} live) over {C} slots, "
                 f"probe {C} rows, {total} output rows, 3 columns gathered")
    del ckey, okey, act, payload, counts, starts, b_perm, lo, off, bi

    # hash_agg: Q21's DISTINCT (l_orderkey, l_suppkey) on one lineitem
    # batch, ~2/3 live, into a table that holds the batch's groups
    words = [(t(rng.integers(1, DB_ORDERS + 1, n)), None),
             (t(rng.integers(1, DB_SUPPLIERS + 1, n)), None)]
    active = t(rng.random(n) < 0.63)
    kacc = groupby.HashAccumulator(2, [], device)
    kacc.update(words, [], active, n)
    pacc = groupby.HashAccumulator(2, [], device, plain=True)
    pacc.update(words, [], active, n)
    km, _ = _hash_groups(torch, kacc)
    pm, _ = _hash_groups(torch, pacc)
    torch.cuda.synchronize()
    check(torch.equal(km, pm), "hash_agg differs at Q21's shape")
    groups = km.shape[0]
    inputs = copies_for_l2([w for w, _ in words] + [active])
    ms = time_ms(torch, [(lambda a=a, b=b, m=m: groupby.hash_agg_update(
        kacc, [(a, None), (b, None)], [], m, n)) for a, b, m in inputs],
        reps=8 * len(inputs))
    plain_ms = time_ms_synced(torch, [(lambda a=a, b=b, m=m:
                                       groupby.hash_agg_update_plain(
                                           pacc, [(a, None), (b, None)], [],
                                           m, n)) for a, b, m in inputs],
                              reps=2)

    def unique_call(a, b, m):
        def run():
            keys = torch.stack([a[m], b[m]], 1)
            _, inv = torch.unique(keys, dim=0, return_inverse=True)
            return torch.zeros(keys.shape[0], dtype=torch.int64,
                               device=device).index_add_(
                0, inv, torch.ones_like(inv))
        return run

    lib_ms = time_ms_synced(torch, [unique_call(*c) for c in inputs],
                            reps=2 * len(inputs))
    live = int(active.sum())
    # the mask, each live row's two key words, and the sectors of every
    # group's slot in the state, the null bits and both key columns (read:
    # the timed calls find every group)
    slots = (kacc.state == groupby.HA_READY).nonzero().squeeze(1)
    nbytes = n + sector_bytes(torch, active.nonzero().squeeze(1), 8) * 2 \
        + 2 * sector_bytes(torch, slots, 4) \
        + 2 * sector_bytes(torch, slots, 8)
    out.append(_row("hash_agg", launches, worst["hash_agg"], ms, plain_ms,
                    nbytes, lib_ms, "spark_rapids_tpu/ops/groupby.py:251"))
    notes.append(f"n={n} rows, {live} live, {groups} groups in "
                 f"{kacc.cap} slots (every group present: the repeated "
                 f"calls find, never claim)")
    synced = {("csr_join", "plain"), ("csr_join", "library"),
              ("hash_agg", "plain"), ("hash_agg", "library")}
    for row, note in zip(out, notes):
        mark = {w: "†" if (row["name"], w) in synced else ""
                for w in ("plain", "library")}
        nbytes = round(row["bound_ms"] * 1e-3 * HBM_BYTES_PER_S)
        print(f"kernel {row['name']}: {row['ms']:.4f} ms at {note} (bound "
              f"{row['bound_ms']:.4f} ms for {nbytes} B, plain "
              f"{row['plain_ms']:.4f} ms"
              f"{mark['plain']}, library {row['library_ms']:.4f} ms"
              f"{mark['library']}), max |err| vs plain "
              f"{row['max_abs_err']:.3e}, {row['launches']} launches on the "
              f"main path")
    return out



# ---------------------------------------------------------------------------------
# hashing, sort_join and dense_agg's float residuals: kernels vs plain
# ---------------------------------------------------------------------------------

def hash_columns_case(torch, n, seed, device):
    """One column of every hashable type (bool, int8, int16, int32,
    int64, float32, float64) with nulls and the edge values: int extremes,
    -0.0, NaN, +-inf and subnormals."""
    rng = np.random.default_rng(seed)
    t = _to_device(torch, device)
    cols = [rng.random(n) < 0.5]
    for dt in (np.int8, np.int16, np.int32, np.int64):
        info = np.iinfo(dt)
        x = rng.integers(info.min, info.max, n, endpoint=True, dtype=dt)
        x[:min(n, 2)] = [info.min, info.max][:min(n, 2)]
        cols.append(x)
    for dt in (np.float32, np.float64):
        tiny = np.finfo(dt).tiny
        edge = np.array([0.0, -0.0, np.nan, np.inf, -np.inf, tiny / 2,
                         -tiny / 4, tiny], dtype=dt)
        x = rng.normal(scale=1e6, size=n).astype(dt)
        x[:min(n, len(edge))] = edge[:min(n, len(edge))]
        cols.append(x)
    return [(t(c), t(rng.random(n) < 0.9)) for c in cols]


def check_hashing(torch, hashing, device) -> float:
    """Every column alone and all of them folded, murmur3 and xxhash64,
    bit-exact; partition ids and counts under a live mask for 1, 8, 200
    and 4096 partitions."""
    for n, seed in ((1, 1), (5000, 2), (BATCH_ROWS + 17, 3)):
        cols = hash_columns_case(torch, n, seed, device)
        active = _to_device(torch, device)(
            np.random.default_rng(seed).random(n) < 0.7)
        for keys in [[c] for c in cols] + [cols]:
            for algo in ("murmur3", "xxhash64"):
                kh = hashing.hash_rows_kernel(keys, None, algo, 42, 0)[0]
                ph = hashing.hash_rows_plain(keys, None, algo, 42, 0)[0]
                torch.cuda.synchronize()
                check(torch.equal(kh, ph), f"{algo} hash differs over "
                      f"{len(keys)} column(s) of n={n}")
        for nparts in (1, 8, 200, 4096):
            for algo in ("murmur3", "xxhash64"):
                kc = torch.zeros(nparts + 1, dtype=torch.int64, device=device)
                pc = torch.zeros_like(kc)
                kp = hashing.hash_rows_kernel(cols[3:5], active, algo, 42,
                                              nparts, kc)[1]
                pp = hashing.hash_rows_plain(cols[3:5], active, algo, 42,
                                             nparts, pc)[1]
                torch.cuda.synchronize()
                check(torch.equal(kp, pp) and torch.equal(kc, pc),
                      f"{algo} partition ids or counts differ ({nparts} "
                      f"partitions, n={n})")
    print("check hashing: bool/int8/int16/int32/int64/float32/float64 with "
          "nulls, int extremes, -0.0, NaN, +-inf and subnormals, alone and "
          "folded, n up to 4194321: murmur3 and xxhash64 bit-exact; "
          "partition ids and counts for 1/8/200/4096 partitions: ok")
    return 0.0


def sort_case(torch, n, seed, device, kind, span=50):
    """Keys of one kind with nulls and a live mask: integers over
    ``span`` values, floats drawn from -0.0/+0.0/NaN/+-inf/subnormal and
    a few numbers, or an (int64, float64) pair."""
    rng = np.random.default_rng(seed)
    t = _to_device(torch, device)

    def col(k):
        if k in ("int64", "int32"):
            return rng.integers(-span, span, n).astype(k)
        dt = np.dtype(k)
        vals = np.array([-0.0, 0.0, np.nan, np.inf, -np.inf,
                         np.finfo(dt).tiny / 2, 1.5, -2.25, 1e30],
                        dtype=dt)
        return rng.choice(vals, n)
    kinds = ["int64", "float64"] if kind == "two" else [kind]
    keys = [(t(col(k)), t(rng.random(n) < 0.95)) for k in kinds]
    return keys, t(rng.random(n) < 0.85)


def check_sort_join(torch, join, device) -> float:
    """The sorted build (b_perm, n_valid, sorted images), the probe in
    every mode and the unmatched build rows exact against the plain
    versions; and the partition placement that reuses csr_join's radix
    pass."""
    for nb, npr, kind, seed in ((0, 100, "int64", 1), (1, 1, "int32", 2),
                                (3000, 5000, "int64", 3),
                                (3000, 5000, "int32", 4),
                                (3000, 5000, "float64", 5),
                                (3000, 5000, "float32", 6),
                                (3000, 5000, "two", 7),
                                (2_500_003, 71_700, "int64", 8)):
        bkeys, bact = sort_case(torch, nb, seed, device, kind,
                                span=max(50, nb // 4))
        pkeys, pact = sort_case(torch, npr, seed + 100, device, kind,
                                span=max(50, nb // 4))
        kb = join.sorted_build_kernel(bkeys, bact)
        pb = join.sorted_build_plain(bkeys, bact)
        torch.cuda.synchronize()
        check(torch.equal(kb.n_valid, pb.n_valid), f"sort_join n_valid "
              f"{kb.n_valid.tolist()} vs {pb.n_valid.tolist()} ({kind})")
        check(torch.equal(kb.b_perm, pb.b_perm), f"sort_join b_perm differs "
              f"({kind}, n={nb})")
        check(torch.equal(kb.words, pb.words), f"sort_join sorted images "
              f"differ ({kind})")
        for how in ("inner", "full", "semi", "anti"):
            ko = join.sorted_probe_kernel(pkeys, pact, kb, how)
            po = join.sorted_probe_plain(pkeys, pact, pb, how)
            torch.cuda.synchronize()
            for name, x, y in zip(("lo", "matches", "selection/offsets"),
                                  ko, po):
                check(torch.equal(x, y), f"sort_join {how} probe {name} "
                      f"differs ({kind}, n={nb}/{npr})")
        lo, m, _ = ko
        km, kc = join.unmatched_build_kernel(lo, m, kb, bact)
        pm, pc = join.unmatched_build_plain(lo, m, pb, bact)
        torch.cuda.synchronize()
        check(torch.equal(km, pm) and torch.equal(kc, pc),
              f"sort_join unmatched build rows differ ({kind})")
    rng = np.random.default_rng(9)
    for n, nparts in ((0, 8), (1, 8), (BATCH_ROWS + 17, 8),
                      (100_000, 300)):
        pids = _to_device(torch, device)(
            rng.integers(0, nparts + 1, n).astype(np.int32))
        kp = join.partition_perm_kernel(pids, nparts)
        pp = join.partition_perm_plain(pids, nparts)
        torch.cuda.synchronize()
        check(torch.equal(kp, pp), f"partition placement differs "
              f"(n={n}, {nparts} partitions)")
    print("check sort_join: build 0/1/3000/2500003 rows, int64/int32/"
          "float64/float32 keys with -0.0/+0.0, NaN, +-inf, subnormals, "
          "nulls and dead rows, and an (int64, float64) key pair: b_perm, "
          "n_valid, sorted images, inner/full/semi/anti probes and the "
          "unmatched build rows exact; partition placement (8 and 300 "
          "partitions) exact: ok")
    return 0.0


def check_dense_agg_f64(torch, groupby, device) -> float:
    """A float64 residual (a string-code residual beside it) on the dense
    aggregate: -0.0/+0.0 under one key, a NaN under another, nulls; the
    residual channels, presence and the violation check exact, the
    decoded residuals equal bit for bit."""
    worst = 0.0
    for n, seed, nan in ((1, 1, False), (5000, 2, False), (5000, 3, True),
                         (BATCH_ROWS + 17, 4, False)):
        rng = np.random.default_rng(seed)
        t = _to_device(torch, device)
        key = rng.integers(0, 4096, n).astype(np.int64)
        bal = (key * 0.25 - 300.0).astype(np.float64)
        zero = key % 64 == 0
        bal[zero] = rng.choice(np.array([0.0, -0.0]), int(zero.sum()))
        if nan:  # every row of one key whose residual is not null
            bal[key == key[(key % 7) != 3][0]] = np.nan
        res = [(t((key % 1000).astype(np.int32)), None),
               (t(bal), t((key % 7) != 3))]
        contrib = [(t(rng.normal(size=n) * 1e3), None)]
        active = t(rng.random(n) < 0.8)
        accs = []
        for update in (groupby.dense_agg_update,
                       groupby.dense_agg_update_plain):
            acc = groupby.DenseAccumulator(0, 4096, 2, [("sum", True)],
                                           device, res_f64=[False, True])
            update(acc, (t(key), None), res, contrib, active)
            accs.append(acc)
        ka, pa = accs
        torch.cuda.synchronize()
        for name in ("present", "vmin", "vmax", "vdmin", "vdmax"):
            check(torch.equal(getattr(ka, name), getattr(pa, name)),
                  f"dense_agg float residual {name} differs (n={n})")
        kc, pc = groupby.dense_agg_check(ka), groupby.dense_agg_check_plain(
            pa)
        check(torch.equal(kc, pc), "dense_agg float residual check differs")
        check(int(kc[0]) == int(nan and n > 1), f"dense_agg float residual "
              f"violation {int(kc[0])} with{'' if nan else 'out'} a NaN")
        kv, pv = ka.residual(1)[0], pa.residual(1)[0]
        check(torch.equal(kv.view(torch.int64), pv.view(torch.int64)),
              "dense_agg decoded float residuals differ")
        worst = max(worst, max_abs_diff(ka.acc[0], pa.acc[0]))
    print("check dense_agg float residuals: -0.0/+0.0 under one key, a NaN, "
          "nulls, n up to 4194321: channels, check and decoded values "
          "exact: ok")
    return worst


def time_slice4_kernels(torch, hashing, join, groupby, device, launches,
                        worst) -> list:
    """hashing, sort_join and dense_agg's float residual channels at the
    shapes Q10 gives them at SF10, each first held against its plain
    version on the same inputs."""
    rng = np.random.default_rng(8)
    t = _to_device(torch, device)
    n = BATCH_ROWS
    out, notes = [], []

    # hashing: the murmur3 partition id of one lineitem batch's l_orderkey
    # for the shuffled join's exchange, a third of the rows live ('R')
    keys = [(t(rng.integers(1, DB_ORDERS + 1, n)), None)]
    active = t(rng.random(n) < 1 / 3)
    kc = torch.zeros(9, dtype=torch.int64, device=device)
    pc = torch.zeros_like(kc)
    kp = hashing.hash_rows_kernel(keys, active, "murmur3", 42, 8, kc,
                                  want_hash=False)[1]
    pp = hashing.hash_rows_plain(keys, active, "murmur3", 42, 8, pc)[1]
    torch.cuda.synchronize()
    check(torch.equal(kp, pp) and torch.equal(kc, pc),
          "hashing differs at Q10's shape")
    inputs = copies_for_l2([keys[0][0], active])
    counts = torch.zeros(9, dtype=torch.int64, device=device)
    ms = time_ms(torch, [(lambda k=k, a=a: hashing.hash_rows_kernel(
        [(k, None)], a, "murmur3", 42, 8, counts, want_hash=False))
        for k, a in inputs], reps=8 * len(inputs))
    plain_ms = time_ms_synced(torch, [(
        lambda k=k, a=a: hashing.hash_rows_plain(
            [(k, None)], a, "murmur3", 42, 8, counts)) for k, a in inputs],
        reps=2 * len(inputs))
    # the key and the live mask read once, the id written once
    row = _row("hashing", launches, 0.0, ms, plain_ms, n * (8 + 1 + 4), None,
               "spark_rapids_tpu/ops/hashing.py:190")
    out.append(row)
    notes.append(f"n={n} int64 keys, {int(active.sum())} live, 8 "
                 f"partitions (no PyTorch call computes murmur3)")
    del keys, active, inputs

    # sort_join: one Q10-shuffled partition pair — the build is the
    # partition's ~2.5 M returned lineitems (l_orderkey), the probe its
    # ~71.7 K orders of the quarter (o_orderkey, unique)
    nb, npr = 2_500_000, 71_700
    bk = t(rng.integers(1, DB_ORDERS + 1, nb))
    pk = t(rng.choice(np.arange(1, DB_ORDERS + 1), npr, replace=False))
    kb = join.sorted_build_kernel([(bk, None)], None)
    pb = join.sorted_build_plain([(bk, None)], None)
    ko = join.sorted_probe_kernel([(pk, None)], None, kb, "inner")
    po = join.sorted_probe_plain([(pk, None)], None, pb, "inner")
    torch.cuda.synchronize()
    check(torch.equal(kb.b_perm, pb.b_perm) and all(
        torch.equal(x, y) for x, y in zip(ko, po)),
        "sort_join differs at Q10's pair shape")
    matched = int(ko[1].sum())

    def kernel_call(b, p):
        return lambda: join.sorted_probe_kernel(
            [(p, None)], None, join.sorted_build_kernel([(b, None)], None),
            "inner")

    # one call launches ~55 kernels (a 5-launch radix pass per key byte):
    # each copy once keeps the queue under the stream's launch depth
    inputs = copies_for_l2([bk, pk])
    ms = time_ms(torch, [kernel_call(b, p) for b, p in inputs],
                 reps=len(inputs))
    plain_ms = time_ms_synced(torch, [lambda b=b, p=p: join.sorted_probe_plain(
        [(p, None)], None, join.sorted_build_plain([(b, None)], None),
        "inner") for b, p in inputs[:2]], reps=2)

    def library(b, p):
        def run():
            sk, perm = torch.sort(b, stable=True)
            return (torch.searchsorted(sk, p),
                    torch.searchsorted(sk, p, right=True), perm)
        return run

    lib_ms = time_ms(torch, [library(b, p) for b, p in inputs],
                     reps=len(inputs))
    hit = ko[1] > 0
    # build keys and probe keys read once; sorted images, b_perm, lo and
    # matches written once; the matched images read by sector
    nbytes = nb * 8 + npr * 8 + nb * (8 + 4) + npr * 8 \
        + sector_bytes(torch, ko[0][hit].to(torch.int64), 8)
    out.append(_row("sort_join", launches, 0.0, ms, plain_ms, nbytes, lib_ms,
                    "spark_rapids_tpu/plan/join_exec.py:626"))
    notes.append(f"build {nb} int64 keys, probe {npr} keys, {matched} "
                 f"matches (library: torch.sort(stable=True) + two "
                 f"torch.searchsorted)")
    del bk, pk, kb, pb, ko, po, inputs

    # dense_agg with a float64 residual: Q10's GROUP BY (c_custkey over
    # 1,500,000 slots, residuals c_name codes and c_acctbal) over the
    # ~765 K joined rows of one query, one float64 sum
    n10, D = 765_000, DB_CUSTOMERS
    key = rng.integers(1, D + 1, n10)
    res = [(t((key % 1_000_000).astype(np.int32)), None),
           (t(np.round(key * 0.37 - 999.99, 2)), None)]
    vol = t(rng.uniform(800, 100_000, n10))
    tk = t(key.astype(np.int64))
    accs = []
    for update in (groupby.dense_agg_update, groupby.dense_agg_update_plain):
        acc = groupby.DenseAccumulator(1, D, 2, [("sum", True)], device,
                                       res_f64=[False, True])
        update(acc, (tk, None), res, [(vol, None)], None)
        accs.append(acc)
    torch.cuda.synchronize()
    check(torch.equal(accs[0].vmin, accs[1].vmin)
          and torch.equal(accs[0].vmax, accs[1].vmax),
          "dense_agg float residual channels differ at Q10's shape")
    err = max_abs_diff(accs[0].acc[0], accs[1].acc[0])
    kacc = accs[0]
    inputs = copies_for_l2([tk, res[0][0], res[1][0], vol])
    ms = time_ms(torch, [(lambda k=k, a=a, b=b, v=v: groupby.dense_agg_update(
        kacc, (k, None), [(a, None), (b, None)], [(v, None)], None))
        for k, a, b, v in inputs], reps=8 * len(inputs))
    pacc = accs[1]
    plain_ms = time_ms_synced(torch, [(
        lambda k=k, a=a, b=b, v=v: groupby.dense_agg_update_plain(
            pacc, (k, None), [(a, None), (b, None)], [(v, None)], None))
        for k, a, b, v in inputs[:2]], reps=2)
    sums = torch.zeros(D + 1, dtype=torch.float64, device=device)
    lib_ms = time_ms(torch, [(lambda k=k, v=v: sums.index_add_(0, k - 1, v))
                             for k, _, _, v in inputs], reps=8 * len(inputs))
    slots = tk - 1
    # key, two residuals and the value read once; per row the sectors of
    # its slot in the sum, presence and the four words of each residual
    nbytes = n10 * (8 + 4 + 8 + 8) + sector_bytes(torch, slots, 8) * 5 \
        + sector_bytes(torch, slots, 1) + sector_bytes(torch, slots, 4) * 4
    row = _row("dense_agg", launches, max(err, worst["dense_agg"]), ms,
               plain_ms, nbytes, lib_ms,
               "spark_rapids_tpu/plan/physical.py:1321")
    row["name"] = "dense_agg_f64_residual"
    out.append(row)
    notes.append(f"{n10} rows over {D} slots, an int32 and a float64 "
                 f"residual, one float64 sum (library: index_add_ of the "
                 f"sum)")
    synced = {("hashing", "plain"), ("sort_join", "plain"),
              ("dense_agg_f64_residual", "plain")}
    for row, note in zip(out, notes):
        mark = {w: "†" if (row["name"], w) in synced else ""
                for w in ("plain", "library")}
        nbytes = round(row["bound_ms"] * 1e-3 * HBM_BYTES_PER_S)
        lib = "none" if row["library_ms"] is None \
            else f"{row['library_ms']:.4f} ms"
        print(f"kernel {row['name']}: {row['ms']:.4f} ms at {note} (bound "
              f"{row['bound_ms']:.4f} ms for {nbytes} B, plain "
              f"{row['plain_ms']:.4f} ms{mark['plain']}, library {lib}), "
              f"max |err| vs plain {row['max_abs_err']:.3e}, "
              f"{row['launches']} launches on the main path")
    return out

# ---------------------------------------------------------------------------------
# the full device sort (sort.cu), the window scans (window_scan.cu) and
# frames (window_frame.cu)
# ---------------------------------------------------------------------------------

SORT_KINDS = ("int8", "int16", "int32", "date", "int64", "float32", "float64",
              "bool", "codes")


def sort_key_column(rng, kind: str, n: int, span: int = 40):
    """One key column of ``kind`` with ties, and for floats -0.0/+0.0, NaN
    and +-inf."""
    if kind in ("int8", "int16", "int32", "int64"):
        return rng.integers(-span, span, n).astype(kind)
    if kind in ("date", "codes"):
        return rng.integers(0, span, n).astype(np.int32)
    if kind == "bool":
        return rng.random(n) < 0.5
    dt = np.dtype(kind)
    vals = np.array([-0.0, 0.0, np.nan, np.inf, -np.inf, 1.5, -2.25, 1e30,
                     3.0, -7.0], dtype=dt)
    return rng.choice(vals, n)


def _same(torch, a, b) -> bool:
    """Equal values (NaN equal to NaN) of one shape and type."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())
    return torch.equal(a, b)


def check_sort(torch, sort_ops, device) -> float:
    """sort.cu against its plain versions: the images of every key type
    (asc/desc, nulls first/last, NaN, +-0.0, ties), the permutation with
    and without a live mask (exact), constant keys (every pass skipped),
    several keys, the range key and the gather."""
    rng = np.random.default_rng(51)
    t = _to_device(torch, device)
    cases = []
    for n in (0, 1, 5000, 300_001):
        for kind in SORT_KINDS:
            for asc, nf in ((True, True), (False, True), (True, False),
                            (False, False)):
                cases.append((n, [(kind, asc, nf, 0.9)], n % 2 == 1))
    cases += [(300_001, [("int64", True, True, 1.0),
                         ("float64", False, False, 0.8),
                         ("int32", True, False, 1.0)], True),
              (300_001, [("date", True, True, 1.0),
                         ("float64", False, False, 1.0),
                         ("int64", True, True, 1.0)], False),
              (BATCH_ROWS, [("date", True, True, 1.0),
                            ("float64", False, False, 1.0),
                            ("int64", True, True, 1.0)], False)]
    for n, spec, masked in cases:
        keys = []
        for kind, asc, nf, frac in spec:
            d = t(sort_key_column(rng, kind, n, span=max(40, n // 50)))
            v = None if frac >= 1.0 else t(rng.random(n) < frac)
            keys.append((d, v, asc, nf))
        active = t(rng.random(n) < 0.8) if masked else None
        kw = sort_ops.sort_images_kernel(keys)
        pw = sort_ops.sort_images_plain(keys)
        torch.cuda.synchronize()
        check(len(kw) == len(pw) and all(
            a[1] == b[1] and torch.equal(a[0], b[0])
            for a, b in zip(kw, pw)), f"sort images differ ({spec}, n={n})")
        kp = sort_ops.sort_perm_kernel(kw, active, n)
        pp = sort_ops.sort_perm_plain(pw, active, n, device)
        torch.cuda.synchronize()
        check(torch.equal(kp, pp), f"sort permutation differs ({spec}, "
              f"n={n}, live mask {masked})")
        d, v, asc, nf = keys[0]
        kr = sort_ops.range_key_kernel(d, v, asc, nf, kp)
        pr = sort_ops.range_key_plain(d, v, asc, nf, kp)
        cols = [(d, v)] + [(k[0], k[1]) for k in keys[1:]]
        kg = sort_ops.gather_kernel(cols, kp)
        pg = sort_ops.gather_plain(cols, kp)
        torch.cuda.synchronize()
        check(torch.equal(kr, pr), f"range key differs ({spec}, n={n})")
        check(all(_same(torch, a[0], b[0]) and (
            (a[1] is None and b[1] is None) or torch.equal(a[1], b[1]))
            for a, b in zip(kg, pg)), f"sort gather differs ({spec})")
    # constant keys: every pass skips on the device, the order stays
    n = 100_000
    keys = [(t(np.full(n, 7, dtype=np.int64)), None, True, True),
            (t(np.full(n, 3, dtype=np.int32)), None, False, True)]
    kp = sort_ops.sort_perm_kernel(sort_ops.sort_images_kernel(keys), None, n)
    torch.cuda.synchronize()
    check(torch.equal(kp, torch.arange(n, dtype=torch.int32, device=device)),
          "a sort over constant keys moved rows")
    print("check sort: images, permutation, range key and gather exact "
          "over int8/int16/int32/date/int64/float32/float64/bool/code keys, "
          "asc/desc x nulls first/last, NaN/+-0.0/+-inf, ties, live masks, "
          "0/1/5000/300001/4194304 rows, three-key sorts, constant keys "
          "(every pass skipped): ok")
    return 0.0


class _Ctx:
    """A window context's positions, for holding each function's kernel
    against its plain version on the same positions."""

    def __init__(self, torch, window, seg, peer, n, device, scan):
        i32 = torch.int32
        self.n, self.device = n, device
        self.seg_start, self.peer_start = seg, peer
        self.seg_start_pos = scan(i32, "max", "start_pos", n, flags=seg)
        self.seg_end_pos = scan(i32, "min", "end_pos", n, flags=seg)
        self.peer_start_pos = scan(i32, "max", "start_pos", n, flags=peer)
        self.peer_end_pos = scan(i32, "min", "end_pos", n, flags=peer)
        self._dense = scan(i32, "sum", "flag_count", n, flags=peer,
                           reset=seg)

    def dense_count(self):
        return self._dense


def _kw(fn):
    """A scan wrapper that takes win_scan's keyword arguments."""
    return lambda dtype, op, mode, n, vals=None, mask=None, flags=None, \
        reset=None: fn(dtype, op, mode, n, vals, mask, flags, reset)


def window_case(torch, rng, n, device, parts, days, nulls):
    """Sorted (partition, order) keys: int64 partitions with nulls, int32
    order keys with ties and nulls, rows sorted by (partition, order)."""
    t = _to_device(torch, device)
    part = np.sort(rng.integers(0, parts, n)).astype(np.int64)
    day = rng.integers(0, days, n).astype(np.int32)
    order = np.lexsort((day, part))
    part, day = part[order], day[order]
    pv = t(rng.random(n) < 0.98) if nulls else None
    dv = t(rng.random(n) < 0.9) if nulls else None
    return (t(part), pv), (t(day), dv)


def check_window(torch, window, device) -> float:
    """window_scan.cu and window_frame.cu against their plain versions on
    the same sorted keys: flags and positions exact, integer scans exact,
    float64 sums within 1e-12 x the running sum of |x|, min/max exact
    (NaN included), ranks, lag/lead with and without defaults, take, ROWS
    and RANGE bounds (asc/desc, nulls first/last, saturating deltas),
    framed sums and min/max."""
    rng = np.random.default_rng(52)
    t = _to_device(torch, device)
    worst = 0.0
    for n, parts, days, nulls in ((1, 1, 1, False), (5000, 40, 90, True),
                                  (300_001, 500, 2526, True),
                                  (BATCH_ROWS, 7000, 2526, False)):
        (pd, pv), (dd, dv) = window_case(torch, rng, n, device, parts, days,
                                         nulls)
        keys = [(pd, pv), (dd, dv)]
        kseg, kpeer = window.win_flags_kernel(keys, 1, n)
        pseg, ppeer = window.win_flags_plain(keys, 1, n, device)
        torch.cuda.synchronize()
        check(torch.equal(kseg, pseg) and torch.equal(kpeer, ppeer),
              f"window flags differ (n={n})")
        kw = _Ctx(torch, window, kseg, kpeer, n, device,
                  _kw(window.win_scan_kernel))
        pw = _Ctx(torch, window, kseg, kpeer, n, device,
                  _kw(window.win_scan_plain))
        torch.cuda.synchronize()
        for a in ("seg_start_pos", "seg_end_pos", "peer_start_pos",
                  "peer_end_pos", "_dense"):
            check(torch.equal(getattr(kw, a), getattr(pw, a)),
                  f"window positions {a} differ (n={n})")
        x64 = t(rng.integers(-1000, 1000, n).astype(np.int64))
        xf = rng.uniform(-1e4, 1e4, n)
        xf[rng.random(n) < 0.001] = np.nan
        xf = t(xf)
        m = t(rng.random(n) < 0.9)
        for dtype, x in ((torch.int64, x64), (torch.float64, xf)):
            for op in ("sum", "min", "max"):
                for mask, reset in ((m, kseg), (None, kseg), (m, None)):
                    k = window.win_scan_kernel(dtype, op, "values", n, x,
                                               mask, None, reset)
                    p = window.win_scan_plain(dtype, op, "values", n, x,
                                              mask, None, reset)
                    torch.cuda.synchronize()
                    if dtype == torch.float64 and op == "sum":
                        fin = ~torch.isnan(p)
                        absx = torch.where(torch.isnan(x), torch.zeros_like(
                            x), x.abs())
                        scale = window.win_scan_plain(
                            dtype, "sum", "values", n, absx, mask, None,
                            reset)
                        err = float(((k - p).abs()[fin] / torch.clamp(
                            scale[fin], min=1.0)).max()) if n else 0.0
                        check(err <= F64_SUM_TOL and torch.equal(
                            torch.isnan(k), torch.isnan(p)),
                            f"window float sum scan off by {err:.3e}")
                        worst = max(worst, err)
                    else:
                        check(_same(torch, k, p), f"window {op} scan over "
                              f"{dtype} differs (n={n})")
        kt = window.win_take_kernel(x64, kw.seg_end_pos)
        check(torch.equal(kt, x64[kw.seg_end_pos.long()]),
              "window take differs")
        for fn in ("row_number", "rank", "dense_rank", "percent_rank",
                   "cume_dist", "ntile"):
            for tiles in ((1, 3, 7) if fn == "ntile" else (1,)):
                k = window.win_rank_kernel(fn, kw, tiles)
                p = window.win_rank_plain(fn, kw, tiles)
                torch.cuda.synchronize()
                check(torch.equal(k, p), f"window {fn} differs (n={n})")
        for val in ((xf, None), (x64, m), (dd, dv)):
            for off in (1, 2, -1, -3):
                for dflt in (None, (torch.full_like(val[0], 5), None),
                             (val[0].flip(0).contiguous(), m)):
                    k = window.win_shift_kernel(kw, val, off, dflt)
                    p = window.win_shift_plain(kw, val, off, dflt)
                    torch.cuda.synchronize()
                    check(torch.equal(k[1], p[1]) and _same(
                        torch, torch.where(k[1], k[0], torch.zeros_like(
                            k[0])), torch.where(p[1], p[0],
                                                torch.zeros_like(p[0]))),
                        f"window lag/lead {off} differs (n={n})")
        frames = []
        for lo, hi in ((-6, 0), (None, 0), (-3, None), (2, 5), (None, None),
                       (-(1 << 39), 1 << 39)):
            frames.append(("rows", lo, hi, None, None) + (
                window.frame_rows_kernel(kw, lo, hi),
                window.frame_rows_plain(kw, lo, hi)))
        for key in ((dd, dv), (dd.to(torch.int64), dv)):
            for desc, nf in ((False, True), (True, False), (False, False),
                             (True, True)):
                for lo, hi in ((-30, 0), (None, 5), (-(1 << 62), 3),
                               (0, None), (1, 2)):
                    frames.append(("range", lo, hi, desc, nf) + (
                        window.frame_range_kernel(kw, key, lo, hi, desc, nf),
                        window.frame_range_plain(kw, key, lo, hi, desc, nf)))
        for kind, lo, hi, desc, nf, (ka, kb), (pa, pb) in frames:
            torch.cuda.synchronize()
            check(torch.equal(ka, pa) and torch.equal(kb, pb),
                  f"window {kind} frame bounds ({lo}, {hi}, desc {desc}, "
                  f"nulls first {nf}) differ (n={n})")
        for kind, lo, hi, desc, nf, (a, b), _ in frames[:8]:
            run = window.win_scan_kernel(torch.int64, "sum", "values", n,
                                         x64, m, None, kseg)
            cnt = window.win_scan_kernel(torch.int64, "sum", "flag_count", n,
                                         None, None, m, kseg)
            for vals, r in ((x64, run), (None, cnt)):
                k = window.frame_sum_kernel(r, vals, m, a, b)
                p = window.frame_sum_plain(r, vals, m, a, b)
                torch.cuda.synchronize()
                check(torch.equal(k, p), f"framed sum differs ({kind} "
                      f"{lo},{hi})")
            runf = window.win_scan_kernel(torch.float64, "sum", "values", n,
                                          xf, m, None, kseg)
            k = window.frame_sum_kernel(runf, xf, m, a, b)
            p = window.frame_sum_plain(runf, xf, m, a, b)
            torch.cuda.synchronize()
            check(_same(torch, k, p), "framed float sum differs")
            if kind == "rows" and lo is not None and hi is not None \
                    and hi - lo < 16:
                for vals in (x64, xf):
                    for op in ("min", "max"):
                        k = window.frame_minmax_kernel(vals, m, op, a, b)
                        p = window.frame_minmax_plain(vals, m, op, a, b)
                        torch.cuda.synchronize()
                        check(torch.equal(k[1], p[1]) and _same(
                            torch, k[0], p[0]), f"framed {op} differs "
                            f"({lo},{hi})")
    print(f"check window: flags, positions, int64 scans, ranks, ntile, "
          f"lag/lead, take, ROWS/RANGE bounds, framed sums and min/max "
          f"exact; float64 sum scans within {worst:.3e} x the running "
          f"sum of |x| (1/5000/300001/4194304 rows, nulls, NaN): ok")
    return worst


def _passes_run(torch, words) -> int:
    """Radix passes sort.cu runs over these words: a byte whose digit is
    the same in every row is skipped."""
    run = 0
    for w, nbytes in words:
        u = w ^ (-(1 << 63)) if nbytes == 8 else w
        for b in range(nbytes):
            d = (u >> (8 * b)) & 255
            run += int(d.min() != d.max())
    return run


def time_slice5_kernels(torch, sort_ops, window, device, launches, worst,
                        lineitem) -> list:
    """sort (one S1 run: 4,194,304 lineitem rows by ship date, price desc,
    order key, and the gather of its 6 columns), window_scan (W1's running
    revenue: a segmented sum over 60,012,150 rows in supplier order) and
    window_frame (W1's 30-day RANGE bounds and framed sum over the same
    rows), each first held against its plain version on the same inputs."""
    t = _to_device(torch, device)
    out, notes = [], []

    # sort: the first batch of S1's input, one run
    n = BATCH_ROWS
    cols = [t(_days(lineitem[c][:n])) for c in
            ("l_shipdate", "l_extendedprice", "l_orderkey", "l_partkey",
             "l_suppkey", "l_discount")]
    keys = [(cols[0], None, True, True), (cols[1], None, False, False),
            (cols[2], None, True, True)]
    gcols = [(c, None) for c in cols]
    kp = sort_ops.sort_perm_kernel(sort_ops.sort_images_kernel(keys), None, n)
    pw = sort_ops.sort_images_plain(keys)
    pp = sort_ops.sort_perm_plain(pw, None, n, device)
    kg = sort_ops.gather_kernel(gcols, kp)
    torch.cuda.synchronize()
    check(torch.equal(kp, pp) and all(torch.equal(a, b[0][pp.long()])
                                      for (a, _), b in zip(kg, gcols)),
          "sort differs at S1's run shape")
    passes = _passes_run(torch, pw)
    total = sum(b for _, b in pw)

    def kernel_call(c):
        k = [(c[0], None, True, True), (c[1], None, False, False),
             (c[2], None, True, True)]
        return lambda: sort_ops.gather_kernel(
            [(x, None) for x in c], sort_ops.sort_perm_kernel(
                sort_ops.sort_images_kernel(k), None, n))

    def plain_call(c):
        k = [(c[0], None, True, True), (c[1], None, False, False),
             (c[2], None, True, True)]
        return lambda: sort_ops.gather_plain(
            [(x, None) for x in c], sort_ops.sort_perm_plain(
                sort_ops.sort_images_plain(k), None, n, device))

    def library_call(c):
        def run():
            order = torch.arange(n, device=device)
            for x, desc in ((c[2], False), (c[1], True), (c[0], False)):
                order = order[torch.sort(x[order], stable=True,
                                         descending=desc).indices]
            return [x[order] for x in c]
        return run

    inputs = copies_for_l2(cols)
    # one call launches ~70 kernels: each copy once keeps the queue under
    # the stream's launch depth
    ms = time_ms(torch, [kernel_call(c) for c in inputs], reps=len(inputs))
    plain_ms = time_ms_synced(torch, [plain_call(c) for c in inputs[:2]],
                              reps=2)
    lib_ms = time_ms_synced(torch, [library_call(c) for c in inputs[:2]],
                            reps=2)
    # keys read once (4 + 8 + 8 B), the three images written once, per
    # radix pass that runs the word and the row number read and written
    # (24 B), per word its gather (8 B read at a row, 8 written), the
    # permutation written (4 B) and the 6 columns gathered (read and
    # written once, 40 B each way)
    nbytes = n * (20 + 24 + 24 * passes + 16 * len(pw) + 4 + 80)
    out.append(_row("sort", launches, 0.0, ms, plain_ms, nbytes, lib_ms,
                    "spark_rapids_tpu/plan/exec_nodes.py:219"))
    notes.append(f"n={n} rows, 3 keys (date asc, float64 desc, int64 asc), "
                 f"{passes} of {total} radix passes run, 6 columns gathered "
                 f"(library: torch.sort(stable=True) chained over the keys "
                 f"and the gathers)")
    del cols, keys, gcols, kp, pp, kg, inputs

    # W1's rows in (supplier, ship date) order, on the device
    m = len(lineitem["l_suppkey"])
    supp = t(lineitem["l_suppkey"])
    date = t(_days(lineitem["l_shipdate"]))
    price = t(lineitem["l_extendedprice"])
    perm = sort_ops.sort_perm_kernel(sort_ops.sort_images_kernel(
        [(supp, None, True, True), (date, None, True, True)]), None, m)
    (supp, _), (date, _), (price, _) = sort_ops.gather_kernel(
        [(supp, None), (date, None), (price, None)], perm)
    del perm
    w = window.SortedWindowContext([(supp, None)], [(date, None)], m,
                                   device)
    seg = w.seg_start

    # window_scan: the running revenue (a float64 sum reset per supplier)
    k = window.win_scan_kernel(torch.float64, "sum", "values", m, price,
                               None, None, seg)
    p = window.win_scan_plain(torch.float64, "sum", "values", m, price,
                              None, None, seg)
    scale = window.win_scan_plain(torch.float64, "sum", "values", m,
                                  price.abs(), None, None, seg)
    torch.cuda.synchronize()
    err = float(((k - p).abs() / torch.clamp(scale, min=1.0)).max())
    check(err <= F64_SUM_TOL, f"window_scan running sum off by {err:.3e}")
    del k, p, scale
    ms = time_ms(torch, [lambda: window.win_scan_kernel(
        torch.float64, "sum", "values", m, price, None, None, seg)], reps=8)
    plain_ms = time_ms_synced(torch, [lambda: window.win_scan_plain(
        torch.float64, "sum", "values", m, price, None, None, seg)], reps=2)
    lib_ms = time_ms_synced(torch, [lambda: torch.cumsum(price, 0)], reps=8)
    # values (8 B) and reset flags (1 B) read, the sums (8 B) written
    out.append(_row("window_scan", launches, max(err, worst["window_scan"]),
                    ms, plain_ms, m * 17, lib_ms,
                    "spark_rapids_tpu/ops/window.py:159"))
    notes.append(f"{m} rows, {int(seg.sum())} partitions, a float64 sum "
                 f"reset per partition (library: torch.cumsum of the same "
                 f"column, unsegmented)")

    # window_frame: RANGE -30..0 days and the framed revenue
    run = window.win_scan_kernel(torch.float64, "sum", "values", m, price,
                                 None, None, seg)
    ka, kb = window.frame_range_kernel(w, (date, None), -30, 0, False, True)
    pa, pb = window.frame_range_plain(w, (date, None), -30, 0, False, True)
    ks = window.frame_sum_kernel(run, price, None, ka, kb)
    ps = window.frame_sum_plain(run, price, None, pa, pb)
    torch.cuda.synchronize()
    check(torch.equal(ka, pa) and torch.equal(kb, pb) and torch.equal(ks, ps),
          "window_frame differs at W1's shape")
    width = float((kb.long() - ka.long() + 1).double().mean())
    del pa, pb, ps

    def frame_call(fn_range, fn_sum):
        return lambda: fn_sum(run, price, None, *fn_range(
            w, (date, None), -30, 0, False, True))
    ms = time_ms(torch, [frame_call(window.frame_range_kernel,
                                    window.frame_sum_kernel)], reps=8)
    plain_ms = time_ms_synced(torch, [frame_call(window.frame_range_plain,
                                                 window.frame_sum_plain)],
                              reps=1)
    # the key (4 B) and the partition bounds (8 B) read, lo/hi written and
    # read again (16 B), the running sum at hi and lo and the value at lo
    # by sector, the sum written (8 B)
    nbytes = m * (4 + 8 + 16 + 8) + sector_bytes(torch, kb.long(), 8) \
        + 2 * sector_bytes(torch, ka.long(), 8)
    out.append(_row("window_frame", launches, 0.0, ms, plain_ms, nbytes, None,
                    "spark_rapids_tpu/ops/window.py:214"))
    notes.append(f"{m} rows, RANGE -30..0 days over an int32 key, mean "
                 f"frame {width:.2f} rows (no PyTorch call computes a "
                 f"framed sum)")
    del ka, kb, ks, run, w, seg, supp, date, price
    for row, note in zip(out, notes):
        nbytes = round(row["bound_ms"] * 1e-3 * HBM_BYTES_PER_S)
        lib = "none" if row["library_ms"] is None \
            else f"{row['library_ms']:.4f} ms"
        lib = lib if row["library_ms"] is None else lib + " †"
        print(f"kernel {row['name']}: {row['ms']:.4f} ms at {note} (bound "
              f"{row['bound_ms']:.4f} ms for {nbytes} B, plain "
              f"{row['plain_ms']:.4f} ms †, library {lib}), max |err| vs "
              f"plain {row['max_abs_err']:.3e}, {row['launches']} launches "
              f"on the main path")
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
        from spark_rapids_tpu_torch.ops import (batch_utils, groupby, hashing,
                                                join, window)
        from spark_rapids_tpu_torch.ops import sort as sort_ops
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
        worst["csr_join"] = check_csr_join(torch, join, device)
        worst["hash_agg"] = check_hash_agg(torch, groupby, device)
        worst["hashing"] = check_hashing(torch, hashing, device)
        worst["sort_join"] = check_sort_join(torch, join, device)
        worst["dense_agg"] = max(worst["dense_agg"], check_dense_agg_f64(
            torch, groupby, device))
        worst["sort"] = check_sort(torch, sort_ops, device)
        worst["window_scan"] = check_window(torch, window, device)
        worst["window_frame"] = worst["window_scan"]
        if "--checks-only" in sys.argv[1:]:
            print("chip_smoke: every kernel matches its plain version; "
                  "--checks-only stops before the main path")
            return 0

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
        db = tpch.gen_db_arrays(SF, columns=DB_COLUMNS)
        rows = {t: len(next(iter(db[t].values()))) for t in db}
        check(rows == {"customer": DB_CUSTOMERS, "supplier": DB_SUPPLIERS,
                       "orders": DB_ORDERS, "lineitem": DB_LINEITEM,
                       "nation": 25, "partsupp": DB_PARTSUPP},
              f"SF{SF:g} gen_db tables have {rows} rows")
        sf1 = tpch.gen_db_arrays(1.0, tables=Q11_TABLES)
        print(f"datagen gen_db (nation, customer, supplier, partsupp, "
              f"orders, lineitem): {rows} rows, and Q11's tables at SF1, in "
              f"{time.perf_counter() - t0:.1f} s")
        took = {}
        t0 = time.perf_counter()
        q6_want, q1_want = tpch.q6_numpy(data), tpch.q1_numpy(data)
        q3_want = tpch.q3_numpy(cust, orders, data)
        took["q6, q1, q3"] = time.perf_counter() - t0
        db_want = {}
        for q, tabs in DB_QUERIES.items():
            t1 = time.perf_counter()
            db_want[q] = getattr(tpch, f"{q}_numpy")(*(db[t] for t in tabs))
            took[q] = time.perf_counter() - t1
        t1 = time.perf_counter()
        db_want["q11_sf1"] = tpch.q11_numpy(*(sf1[t] for t in Q11_TABLES))
        took["q11_sf1"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        s1_want = tpch.sort_lineitem_numpy(db["lineitem"])
        took["s1"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        w1_want = tpch.supplier_history_numpy(db["lineitem"])
        took["w1"] = time.perf_counter() - t1
        print(f"oracle rows: Q11 {len(db_want['q11'])} at SF{SF:g}, "
              f"{len(db_want['q11_sf1'])} at SF1; W1 "
              f"{len(w1_want['rn'][0])}")
        print(f"oracles: {time.perf_counter() - t0:.1f} s ("
              + ", ".join(f"{k} {v:.1f} s" for k, v in took.items()) + ")")
        sess = Session.get_or_create(device="cuda")
        info = sess.device_info()
        print(f"session device: {info.name}, "
              f"{info.memory_bytes / 2**30:.1f} GiB, power limit "
              f"{info.power_limit}")
        df = sess.create_dataframe(data)
        cdf, odf = sess.create_dataframe(cust), sess.create_dataframe(orders)
        dbf = {t: sess.create_dataframe(cols) for t, cols in db.items()}
        # Q10-shuffled: the same tables on a session with AQE off
        shuf = Session({"spark.rapids.tpu.sql.aqe.enabled": False},
                       device="cuda")
        sbf = {t: shuf.create_dataframe(db[t]) for t in DB_QUERIES["q10"]}
        q11f = {t: sess.create_dataframe(sf1[t]) for t in Q11_TABLES}

        counters = {
            "masked_reduce": [groupby.masked_reduce],
            "grid_agg": [groupby.grid_agg],
            "dense_join": [join.dense_join_stats, join.dense_join_build,
                           join.dense_join_probe],
            "dense_agg": [groupby.dense_agg_stats, groupby.dense_agg_update,
                          groupby.dense_agg_check],
            "topk": [topk_mod.topk], "compact": [batch_utils.compact_kernel],
            "dense_join_semi": [ModeCounter(join.dense_join_probe,
                                            ("semi", "anti"))],
            "csr_join": [join.csr_build_kernel, join.csr_probe_kernel,
                         join.csr_expand_kernel, join.csr_gather,
                         join.partition_perm_kernel],
            "hash_agg": [groupby.hash_agg_update, groupby.hash_agg_rehash],
            "hashing": [hashing.hash_rows_kernel],
            "sort_join": [join.sorted_build_kernel, join.sorted_probe_kernel,
                          join.unmatched_build_kernel],
            "sort": [sort_ops.sort_images_kernel, sort_ops.sort_perm_kernel,
                     sort_ops.range_key_kernel, sort_ops.gather_kernel],
            "window_scan": [window.win_flags_kernel, window.win_scan_kernel,
                            window.win_take_kernel, window.win_rank_kernel,
                            window.win_shift_kernel],
            "window_frame": [window.frame_rows_kernel,
                             window.frame_range_kernel,
                             window.frame_sum_kernel,
                             window.frame_minmax_kernel]}
        paths = [("q6", lambda: tpch.q6(df), check_q6, q6_want,
                  ("masked_reduce",)),
                 ("q1", lambda: tpch.q1(df), check_q1, q1_want,
                  ("grid_agg",)),
                 ("q3", lambda: tpch.q3(cdf, odf, df), check_q3, q3_want,
                  ("dense_join", "dense_agg", "topk", "compact")),
                 # every join launches dense_join's stats kernel
                 ("q4", lambda: tpch.q4(dbf["orders"], dbf["lineitem"]),
                  check_rows("Q4"), db_want["q4"],
                  ("csr_join", "dense_join", "grid_agg")),
                 # Q13's ORDER BY (no LIMIT) is the full device sort
                 ("q13", lambda: tpch.q13(dbf["customer"], dbf["orders"]),
                  check_rows("Q13"), db_want["q13"],
                  ("csr_join", "dense_join", "dense_agg", "sort",
                   "compact")),
                 ("q18", lambda: tpch.q18(dbf["orders"], dbf["lineitem"],
                                          dbf["customer"]),
                  check_rows("Q18"), db_want["q18"],
                  ("dense_agg", "dense_join", "dense_join_semi", "topk",
                   "compact")),
                 ("q21", lambda: tpch.q21(dbf["lineitem"], dbf["orders"],
                                          dbf["supplier"]),
                  check_rows("Q21"), db_want["q21"],
                  ("hash_agg", "dense_agg", "dense_join",
                   "dense_join_semi", "compact")),
                 # customer x orders broadcasts (orders build, repeated
                 # o_custkey: CSR); the second join flips to the dense path
                 ("q10_flip", lambda: tpch.q10(dbf["customer"],
                                               dbf["orders"],
                                               dbf["lineitem"]),
                  check_rows("Q10-flip"), db_want["q10"],
                  ("dense_join", "csr_join", "dense_agg", "topk")),
                 ("q10_shuffled", lambda: tpch.q10(sbf["customer"],
                                                   sbf["orders"],
                                                   sbf["lineitem"]),
                  check_rows("Q10-shuffled"), db_want["q10"],
                  ("hashing", "sort_join", "csr_join", "dense_join",
                   "dense_agg", "topk")),
                 # the global ORDER BY: 15 runs and 15 ranges
                 ("s1", lambda: tpch.sort_lineitem(dbf["lineitem"]),
                  check_device_columns("S1", exact_floats=True), s1_want,
                  ("sort",)),
                 # two window specs, each one sort of every row; the filter
                 # above them compacts
                 ("w1", lambda: tpch.supplier_history(dbf["lineitem"]),
                  check_device_columns("W1", exact_floats=False), w1_want,
                  ("sort", "window_scan", "window_frame", "compact")),
                 # the stock value total, then the HAVING and the sort
                 ("q11", lambda: tpch.q11(dbf["partsupp"], dbf["supplier"],
                                          dbf["nation"]),
                  check_rows("Q11"), db_want["q11"],
                  ("dense_join", "masked_reduce", "dense_agg", "sort")),
                 ("q11_sf1", lambda: tpch.q11(q11f["partsupp"],
                                              q11f["supplier"],
                                              q11f["nation"]),
                  check_rows("Q11-SF1"), db_want["q11_sf1"],
                  ("dense_join", "masked_reduce", "dense_agg", "sort"))]
        device_paths = {"s1", "w1"}
        runs_of, launches, per_wrapper = {}, {}, {}
        for name, df_fn, checker, want, used in paths:
            mine = {k: counters[k] for k in used}
            for fns in mine.values():  # counts from 0 just before the path
                for fn in fns:
                    fn.launches = 0
            runs_of[name] = run_query(
                torch, shuf if name == "q10_shuffled" else sess, df_fn,
                checker, want, name, mine,
                to_device if name in device_paths else collect)
            if name.startswith("q10"):
                ctx = (shuf if name == "q10_shuffled" else
                       sess).last_exec_context()
                flips = sum(m.values.get("aqeShuffleToBroadcast", 0)
                            for m in ctx.metrics.values())
                print(f"query {name}: aqeShuffleToBroadcast {flips:g}")
                check(flips == (name == "q10_flip"), f"{name} flipped "
                      f"{flips:g} times")
            # read just after it; a kernel several paths launch sums them
            for k, v in launch_counts(mine).items():
                launches[k] = launches.get(k, 0) + v
            for fns in mine.values():
                for fn in fns:
                    per_wrapper[fn.__name__] = \
                        per_wrapper.get(fn.__name__, 0) + fn.launches
        q3_runs = runs_of["q3"]
        check(all(launches.values()), f"a kernel of the main path was never "
              f"launched: {launches}")
        print("main path launches per kernel wrapper: "
              + json.dumps(per_wrapper))
        fetches = max(r["syncs"] for r in q3_runs)
        check(fetches <= Q3_REFERENCE_FETCHES, f"Q3 made {fetches} blocking "
              f"fetches, more than the reference's {Q3_REFERENCE_FETCHES}")
        fetches = max(r["syncs"] for r in runs_of["q10_shuffled"])
        check(fetches <= Q10_SHUFFLED_REFERENCE_FETCHES, f"Q10-shuffled made "
              f"{fetches} blocking fetches, more than the reference's "
              f"{Q10_SHUFFLED_REFERENCE_FETCHES}")
        for name, (ceiling, why) in SLICE5_FETCH_CEILINGS.items():
            fetches = max(r["syncs"] for r in runs_of[name])
            check(fetches <= ceiling, f"{name} made {fetches} blocking "
                  f"fetches, more than {ceiling} ({why})")
        del s1_want, w1_want
        for name, df_fn, *_ in paths:
            profile_query(torch, df_fn, name, result=to_device
                          if name in device_paths else collect)
        for name, runs in runs_of.items():
            warm = runs[1:]
            med = {k: statistics.median(r[k] for r in warm)
                   for k in ("wall_ms", "upload_ms", "device_ms")}
            print(f"query {name} warm median: wall {med['wall_ms']:.2f} ms, "
                  f"upload {med['upload_ms']:.2f} ms, device span "
                  f"{med['device_ms']:.2f} ms, syncs {warm[-1]['syncs']}, "
                  f"{warm[-1]['kernel_launches']} kernel launches per query")

        del df, cdf, odf, dbf, sbf, q11f, sess, shuf
        table = time_kernels(torch, groupby, device, launches, worst)
        table += time_new_kernels(torch, join, groupby, topk_mod,
                                  batch_utils, device, launches, worst)
        table += time_slice3_kernels(torch, join, groupby, device, launches,
                                     worst)
        table += time_slice4_kernels(torch, hashing, join, groupby, device,
                                     launches, worst)
        table += time_slice5_kernels(torch, sort_ops, window, device,
                                     launches, worst, db["lineitem"])
        check(sorted({r["source"] for r in table}) == sorted(
            f"spark_rapids_tpu_torch/csrc/{k}.cu" for k in kernels.KERNELS),
            "the kernels line misses a kernel source")
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
