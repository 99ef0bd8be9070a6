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
AQE off, where it joins 8 hash partition pairs; the lineitem sort (S1),
the per-supplier window history (W1) and Q11 (at SF10 and SF1); and the
rest of TPC-H at SF10 (Q2, Q5, Q7, Q8, Q9, Q12, Q14, Q15, Q16, Q17, Q19,
Q20, Q22) with Q21 in its EXISTS form (conditioned semi and anti joins
through ``csrc/cond_join.cu``), plus a small cross join and a small
existence join; the decimal and FIRST/LAST paths; and the eighth slice's:
Q1 over a seeded 1% lineitem sample (``csrc/sample.cu``), X1 and X1o
(explodes of an orders table whose lists hold each order's lineitem
quantities, ``csrc/explode.cu``) and the subquery forms of Q18 (IN), Q16
(NOT IN) and Q22 (a scalar subquery); and the ninth slice's: the
reference suite's 22 queries over SF10 parquet that the port's
``tpch.gen_db`` writes into ``build/tpch_parquet/``, read through
``Session.read_parquet`` with the file cache on, as ``bench.py`` reads
them, with the runtime join filters of ``csrc/key_stats.cu``.  It checks the results against numpy oracles and shows
that each query went through its kernels.  Prints per-query and per-kernel timings, a
``{"kernels": [...]}`` line, the card's name and power limit, and as its
last line ``{"ok": true, "device": {...}}``.  Exits non-zero, printing no
result, when any phase fails or when no CUDA device is available.  Imports
nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import os
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
                           "l_shipdate", "l_shipmode", "l_tax",
                           "l_linestatus"],
              "orders": ["o_orderkey", "o_custkey", "o_orderstatus",
                         "o_totalprice", "o_orderdate", "o_orderpriority"],
              # every column: Q10's first join builds the side the
              # reference does only if customer is estimated at the full
              # width of its table, as the reference's is
              "customer": None,
              "supplier": ["s_suppkey", "s_name", "s_nationkey",
                           "s_acctbal"],
              "partsupp": None, "nation": None, "part": None,
              "region": None}
DB_PART = 2_000_000
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
# slice 6: the rest of TPC-H and Q21 in its EXISTS form at SF10, each with
# the kernels it must launch at the least (the cold run adds every other
# kernel it launched), and two small joins of the new join types
REST_QUERIES = ("q2", "q5", "q7", "q8", "q9", "q12", "q14", "q15", "q16",
                "q17", "q19", "q20", "q22", "q21_exists")
REST_REQUIRE = {"q21_exists": ("cond_join", "sort_join", "hashing"),
                "x_cross": ("cond_join",), "x_exists": ("cond_join",)}
# blocking fetch ceilings: the reference's count for the same plan
# (tools/fetch_budget.py at SF1 with 400,000-row batches, which give
# lineitem the 15 batches it has at SF10, and the broadcast threshold
# scaled to SF1); Q11 at SF1 in 4,194,304-row batches: the reference's 7
_REF = "the reference's count"
REST_FETCH_CEILINGS = {
    "q2": (12, _REF), "q5": (7, _REF), "q7": (86, _REF), "q8": (26, _REF),
    "q9": (77, _REF), "q12": (29, _REF), "q14": (18, _REF),
    "q15": (9, _REF), "q16": (9, _REF), "q17": (45, _REF), "q19": (2, _REF),
    "q20": (42, _REF), "q22": (53, _REF), "q21_exists": (1062, _REF),
    "q11_sf1": (7, "the reference's count at SF1, 4,194,304-row batches")}
# slice 7: decimal money columns and FIRST/LAST at SF10, each with the
# kernels it must launch at the least
SLICE7_QUERIES = ("q1_dec", "q6_dec", "q18_dec", "f1", "f1u", "w2")
SLICE7_REQUIRE = {
    "q1_dec": ("grid_agg", "wide_decimal"),
    "q6_dec": ("masked_reduce", "wide_decimal"),
    "q18_dec": ("hash_agg", "wide_decimal", "dense_join_semi", "topk"),
    "f1": ("hash_agg", "hash_agg_first_last"),
    "f1u": ("masked_reduce", "masked_reduce_first_last"),
    "w2": ("sort", "window_scan", "window_frame", "window_first_last")}
# blocking fetch ceilings: the reference's count for the same plan
# (tools/fetch_budget.py at SF1 with 400,000-row batches); Q6-dec's
# reference count is 0 because it reads its wide sum's limbs to the host
# without counting (spark_rapids_tpu/aggfns.py:139 np.asarray), so its
# ceiling counts that read; the reference cannot run Q18-dec (its HAVING
# reads a host-finalized wide sum), so Q18-dec's ceiling is the
# reference's count for Q18's plan over float columns
SLICE7_FETCH_CEILINGS = {
    "q1_dec": (2, _REF), "q6_dec": (1, "the reference's uncounted read"),
    "q18_dec": (37, "the reference's count for Q18's plan"),
    "f1": (5, _REF), "f1u": (1, _REF), "w2": (2, _REF)}
# slice 8: the sample, explodes and subqueries at SF10, each with the
# kernels it must launch at the least
SLICE8_REQUIRE = {
    "q1_sample": ("sample", "grid_agg"),
    "x1": ("explode", "compact", "grid_agg"),
    "x1o": ("explode",),
    "q18_in": ("dense_agg", "dense_join_semi", "topk"),
    "q16_notin": ("dense_join_semi",),
    "q22_scalar": ("masked_reduce",)}
# blocking fetch ceilings: the reference's count for the same plan
# (tools/fetch_budget.py at SF1 with 400,000-row batches, which give
# lineitem the 15 batches and orders the 4 it has at SF10)
SLICE8_FETCH_CEILINGS = {
    "q1_sample": (2, _REF), "x1": (6, _REF), "x1o": (5, _REF),
    "q18_in": (37, _REF), "q16_notin": (12, _REF),
    "q22_scalar": (6, _REF)}


# slice 9: the reference suite's 22 queries over SF10 parquet files that
# the port's gen_db writes (uncompressed: the reader's snappy decoder is
# plain Python), read as bench.py reads them: fileCache.enabled, the
# cross-query cache off; a query whose scans get runtime join filters
# must launch key_stats
PARQUET_DIR = "build/tpch_parquet"
PARQUET_SETTINGS = {"spark.rapids.tpu.sql.fileCache.enabled": True}
# blocking fetch ceilings of the parquet forms: the reference's count for
# the same plan over parquet (tools/fetch_budget.py --parquet at SF1 with
# 400,000-row batches, which give lineitem the 15 batches it has at SF10)
SLICE9_FETCH_CEILINGS = {f"pq_{q}": (n, _REF) for q, n in (
    ("q1", 2), ("q2", 12), ("q3", 40), ("q4", 8), ("q5", 6), ("q6", 1),
    ("q7", 54), ("q8", 26), ("q9", 37), ("q10", 44), ("q11", 10),
    ("q12", 203), ("q13", 9), ("q14", 18), ("q15", 9), ("q16", 9),
    ("q17", 44), ("q18", 36), ("q19", 2), ("q20", 42), ("q21", 73),
    ("q22", 6))}


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
              result=collect, require=None, on_run=None):
    """One cold and three warm runs; returns the per-run measurements and
    the kernel launches each run made.  Syncs and upload bytes count every
    query the path runs (Q11 runs two: its total, then the rest); upload
    ms is the last query's.  ``counters`` maps each kernel the
    query must launch to its wrappers; ``result`` ends the query (rows on
    the host, or ``to_device_arrays``, whose tensors the checker reads
    after the timed span).  With ``require``, ``counters`` holds every
    kernel: the cold run must launch each required one, and every later
    run each kernel the cold run launched.  ``on_run(i)`` is called after
    run ``i``."""
    from spark_rapids_tpu_torch.utils.metrics import QueryStats
    runs = []
    watched = list(counters)
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
        if require is not None and i == 0:
            watched = [k for k, v in launches.items() if v]
            missing = sorted(set(require) - set(watched))
            check(not missing, f"{name} launched {missing} no time")
        launches = {k: launches[k] for k in watched}
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
        if on_run is not None:
            on_run(i)
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


def check_dense_agg_deterministic(torch, groupby, device) -> None:
    """float64 sums of the dense aggregate are bit for bit the same in
    every run (TPC-H Q15 compares a recomputed sum with a collected one):
    three kernel runs of three batches into fresh accumulators agree to the
    bit, and each stays within F64_SUM_TOL x sum |x| of the plain version
    per slot; infinities and NaN give the plain version's specials."""
    rng = np.random.default_rng(15)
    t = _to_device(torch, device)
    D, n = 100_000, BATCH_ROWS
    batches = []
    for b in range(3):
        key = rng.integers(0, D, n)
        val = np.round(rng.uniform(900.0, 105000.0, n), 2) * (
            1 - rng.integers(0, 11, n) / 100.0)
        if b == 1:  # magnitudes far apart, and the specials, in some slots
            val[:1000] = rng.choice(np.array([1e300, -1e300, 1e-300, 3.0,
                                              -0.0]), 1000)
            val[1000:1010] = [np.inf, -np.inf, np.nan, np.inf, 1.0, np.nan,
                              -np.inf, 2.0, np.inf, 4.0]
        batches.append(((t(key), None), [(t(val), None)],
                        t(rng.random(n) < 0.9)))
    runs = []
    for update in (groupby.dense_agg_update, groupby.dense_agg_update,
                   groupby.dense_agg_update, groupby.dense_agg_update_plain):
        acc = groupby.DenseAccumulator(0, D, 0, [("sum", True)], device)
        for key, contrib, active in batches:
            update(acc, key, [], contrib, active)
        runs.append(acc.acc[0])
    scale = torch.zeros(D + 1, dtype=torch.float64, device=device)
    for key, contrib, active in batches:
        live = active & torch.isfinite(contrib[0][0])
        scale.index_add_(0, key[0][live], contrib[0][0][live].abs())
    torch.cuda.synchronize()
    for r in runs[1:3]:
        check(torch.equal(r.view(torch.int64), runs[0].view(torch.int64)),
              "dense_agg float64 sums differ between two runs")
    k, p = runs[0], runs[3]
    special = ~torch.isfinite(p)
    check(torch.equal(torch.isnan(k), torch.isnan(p)) and torch.equal(
        k[special & ~torch.isnan(p)], p[special & ~torch.isnan(p)]),
        "dense_agg float64 sums: infinities or NaN differ from plain")
    fin = ~special
    err = float(((k[fin] - p[fin]).abs() / scale[fin].clamp(min=1e-300))
                .max())
    check(err <= F64_SUM_TOL, f"dense_agg float64 sums off by {err:.3e}")
    print(f"check dense_agg float64 sums: 3 runs of 3 batches of {n} rows "
          f"equal bit for bit, specials as plain, max rel err {err:.3e}: ok")


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
# Slice 6: cond_join (conditioned, existence and cross joins) and the rest of
# TPC-H
# ---------------------------------------------------------------------------------

def _cond_case(torch, rng, device, counts, n_build, lo=None):
    """A match state on the device from per-probe candidate counts: each
    probe row's range starts at ``lo`` (random where not given) in a
    random build permutation."""
    n_probe = len(counts)
    if lo is None:
        lo = rng.integers(0, max(n_build - int(counts.max(initial=0)), 1),
                          n_probe)
    offsets = np.concatenate(([0], np.cumsum(counts))).astype(np.int64)
    t = _to_device(torch, device)
    return (t(offsets), t(lo.astype(np.int32)),
            t(rng.permutation(n_build).astype(np.int32)), int(offsets[-1]))


def check_cond_join(torch, join, device) -> float:
    """cond_expand, cond_counts and cross_pairs against their plain
    versions on random cases: zero candidates, probes that are all
    inactive (a sorted probe under an all-false mask), a build row that
    every probe matches, one probe row with millions of candidates, and
    pair counts past 2^24.  Every output is exact."""
    rng = np.random.default_rng(66)
    n_probe, n_build = 1 << 20, 700_000
    cases = {
        "random": _cond_case(torch, rng, device, np.where(
            rng.random(n_probe) < 0.8, rng.integers(0, 7, n_probe), 0),
            n_build),
        "zero candidates": _cond_case(torch, rng, device,
                                      np.zeros(n_probe, dtype=np.int64),
                                      n_build),
        "one build row for every probe": _cond_case(
            torch, rng, device, np.ones(n_probe, dtype=np.int64), n_build,
            lo=np.full(n_probe, 12345)),
        "one heavy probe row": _cond_case(
            torch, rng, device, np.where(np.arange(n_probe) == 777,
                                         n_build, 0), n_build,
            lo=np.zeros(n_probe, dtype=np.int64)),
        "past 2^24 pairs": _cond_case(
            torch, rng, device, np.full(1 << 22, 5, dtype=np.int64),
            3_000_000),
    }
    # all-inactive probes through the sorted probe of the main path
    keys = _to_device(torch, device)(rng.integers(0, 1000, n_build))
    state = join.sorted_build([(keys, None)], None)
    probe = _to_device(torch, device)(rng.integers(0, 1000, n_probe))
    lo, _, offsets = join.sorted_probe(
        [(probe, None)], torch.zeros(n_probe, dtype=torch.bool,
                                     device=device), state, "inner")
    torch.cuda.synchronize()
    cases["all-inactive probes"] = (offsets, lo, state.b_perm,
                                    int(offsets[-1]))
    for what, (offsets, lo, b_perm, total) in cases.items():
        kp, kb = join.cond_expand_kernel(offsets, lo, b_perm, total)
        pp, pb = join.cond_expand_plain(offsets, lo, b_perm, total)
        keep = torch.rand(total, device=device) < 0.5
        kc = join.cond_counts_kernel(keep, kp, kb, lo.shape[0],
                                     b_perm.shape[0])
        pc = join.cond_counts_plain(keep, pp, pb, lo.shape[0],
                                    b_perm.shape[0])
        ks = join.cond_counts_kernel(keep, kp, kb, lo.shape[0], None)
        torch.cuda.synchronize()
        check(torch.equal(kp, pp) and torch.equal(kb, pb),
              f"cond_expand differs ({what}, {total} pairs)")
        check(torch.equal(kc[0], pc[0]) and torch.equal(kc[1], pc[1])
              and torch.equal(ks[0], pc[0]) and ks[1] is None,
              f"cond_counts differs ({what}, {total} pairs)")
    for n_l, n_r in ((0, 5), (7, 0), (1, 1), (5, 25), (3000, 6000)):
        k = join.cross_pairs_kernel(n_l, n_r, device)
        p = join.cross_pairs_plain(n_l, n_r, device)
        torch.cuda.synchronize()
        check(torch.equal(k[0], p[0]) and torch.equal(k[1], p[1]),
              f"cross_pairs differs ({n_l} x {n_r})")
    print(f"cond_join: kernels equal their plain versions on "
          f"{len(cases)} match states (up to "
          f"{max(c[3] for c in cases.values())} pairs) and 5 cross "
          f"products (up to 18,000,000 pairs)")
    return 0.0


def _row_of(source, name, per_wrapper, err, ms, plain_ms, nbytes, lib_ms,
            replaces):
    """A kernels-line row for wrapper ``name`` of ``csrc/<source>.cu``:
    its main-path launches are those of ``<name>_kernel``."""
    row = _row(name, {name: per_wrapper.get(f"{name}_kernel", 0)}, err, ms,
               plain_ms, nbytes, lib_ms, replaces)
    row["source"] = f"spark_rapids_tpu_torch/csrc/{source}.cu"
    return row


def time_slice6_kernels(torch, join, device, per_wrapper, worst,
                        lineitem) -> list:
    """cond_expand and cond_counts at the shape of one of Q21-exists's
    sub-partition pairs at SF10 (the late lineitems of 1/128 of the
    orders probing all of those orders' lines: about 312,000 probe rows,
    470,000 build rows and 1.5 M candidate pairs; the pair keeps the
    lines of another supplier), and cross_pairs at the small cross join's
    shape (5 x 25), each first held against its plain version."""
    t = _to_device(torch, device)
    out, notes = [], []
    okey, skey = lineitem["l_orderkey"], lineitem["l_suppkey"]
    sub = okey % 128 == 0
    late = sub & (lineitem["l_receiptdate"] > lineitem["l_commitdate"])
    bkey, bsupp = t(okey[sub]), t(skey[sub])
    pkey, psupp = t(okey[late]), t(skey[late])
    state = join.sorted_build([(bkey, None)], None)
    lo, _, offsets = join.sorted_probe([(pkey, None)], None, state, "inner")
    total = int(offsets[-1])
    n_p, n_b = pkey.shape[0], bkey.shape[0]
    b_perm = state.b_perm
    kp, kb = join.cond_expand_kernel(offsets, lo, b_perm, total)
    pp, pb = join.cond_expand_plain(offsets, lo, b_perm, total)
    keep = psupp[kp.long()] != bsupp[kb.long()]
    kc, _ = join.cond_counts_kernel(keep, kp, kb, n_p, None)
    pc, _ = join.cond_counts_plain(keep, pp, pb, n_p, None)
    torch.cuda.synchronize()
    check(torch.equal(kp, pp) and torch.equal(kb, pb) and torch.equal(kc, pc),
          "cond_join differs at Q21-exists's pair shape")
    inputs = copies_for_l2([offsets, lo, b_perm])
    ms = time_ms(torch, [lambda o=o, a=a, b=b: join.cond_expand_kernel(
        o, a, b, total) for o, a, b in inputs], reps=4 * len(inputs))
    plain_ms = time_ms_synced(torch, [lambda: join.cond_expand_plain(
        offsets, lo, b_perm, total)], reps=4)
    cnt = (offsets[1:] - offsets[:-1])
    rows = torch.arange(n_p, device=device)
    lib_ms = time_ms_synced(torch, [lambda: torch.repeat_interleave(
        rows, cnt)], reps=4)
    # offsets (8 B) and lo (4 B) per probe row; b_perm by sector at the
    # pairs' build positions; pi and bi written (8 B a pair)
    at = lo.long()[kp.long()] + (torch.arange(total, device=device)
                                 - offsets[:-1][kp.long()])
    nbytes = 8 * (n_p + 1) + 4 * n_p + sector_bytes(torch, at, 4) \
        + 8 * total
    out.append(_row_of("cond_join", "cond_expand", per_wrapper, 0.0, ms,
                       plain_ms, nbytes, lib_ms,
                       "spark_rapids_tpu/plan/join_exec.py:446"))
    notes.append(f"{n_p} probe rows, {n_b} build rows, {total} candidate "
                 f"pairs (library: torch.repeat_interleave of the probe "
                 f"rows, pi only)")
    del at
    inputs = copies_for_l2([keep, kp, kb])
    ms = time_ms(torch, [lambda k=k, a=a, b=b: join.cond_counts_kernel(
        k, a, b, n_p, None) for k, a, b in inputs], reps=4 * len(inputs))
    plain_ms = time_ms_synced(torch, [lambda: join.cond_counts_plain(
        keep, kp, kb, n_p, None)], reps=4)
    pl, kk = kp.long(), keep.int()
    lib_ms = time_ms(torch, [lambda: torch.zeros(
        n_p, dtype=torch.int32, device=device).index_add_(0, pl, kk)],
        reps=8)
    # keep (1 B), pi and bi (4 B each) per pair, the counts written
    out.append(_row_of("cond_join", "cond_counts", per_wrapper, 0.0, ms,
                       plain_ms, 9 * total + 4 * n_p, lib_ms,
                       "spark_rapids_tpu/plan/join_exec.py:500"))
    notes.append(f"{total} pairs, {int(keep.sum())} kept, counted per "
                 f"probe row (library: index_add_ into zeros)")
    n_l, n_r = 5, 25
    ms = time_ms(torch, [lambda: join.cross_pairs_kernel(n_l, n_r, device)],
                 reps=64)
    plain_ms = time_ms(torch, [lambda: join.cross_pairs_plain(
        n_l, n_r, device)], reps=64)
    a, b = (torch.arange(n, device=device) for n in (n_l, n_r))
    lib_ms = time_ms(torch, [lambda: torch.cartesian_prod(a, b)], reps=64)
    out.append(_row_of("cond_join", "cross_pairs", per_wrapper, 0.0, ms,
                       plain_ms, 8 * n_l * n_r, lib_ms,
                       "spark_rapids_tpu/plan/join_exec.py:827"))
    notes.append(f"{n_l} x {n_r} rows (the small cross join; library: "
                 f"torch.cartesian_prod)")
    for row, note in zip(out, notes):
        nbytes = round(row["bound_ms"] * 1e-3 * HBM_BYTES_PER_S)
        print(f"kernel {row['name']}: {row['ms']:.4f} ms at {note} (bound "
              f"{row['bound_ms']:.4f} ms for {nbytes} B, plain "
              f"{row['plain_ms']:.4f} ms †, library "
              f"{row['library_ms']:.4f} ms), max |err| vs plain "
              f"{row['max_abs_err']:.3e}, {row['launches']} launches on the "
              f"main path")
    return out


def check_sorted_rows(name: str):
    """Rows as a multiset (sorted), exact: a join's output order is not
    specified."""
    def checker(rows, want) -> float:
        key = lambda r: tuple((0, x) if x is None else (1, x)  # noqa: E731
                              for x in r)
        check(sorted(rows, key=key) == sorted(want, key=key),
              f"{name}: {len(rows)} rows differ from the oracle's "
              f"{len(want)}")
        return 0.0
    return checker


def small_join_oracles(db) -> dict:
    """The small cross join (region x nation) and existence join (nation
    to the suppliers with a balance over 9,990) in numpy."""
    r, n, s = db["region"], db["nation"], db["supplier"]
    cross = [(int(rk), str(rn), int(nk), str(nn), int(nr))
             for rk, rn in zip(r["r_regionkey"], r["r_name"])
             for nk, nn, nr in zip(n["n_nationkey"], n["n_name"],
                                   n["n_regionkey"])]
    rich = set(s["s_nationkey"][s["s_acctbal"] > 9990.0].tolist())
    exists = [(int(nk), str(nn), int(nr), int(nk) in rich)
              for nk, nn, nr in zip(n["n_nationkey"], n["n_name"],
                                    n["n_regionkey"])]
    return {"x_cross": cross, "x_exists": exists}


# ---------------------------------------------------------------------------------

# ---------------------------------------------------------------------------------
# Slice 7: wide decimals, FIRST/LAST, reproducible float sums
# ---------------------------------------------------------------------------------

class AttrCounter:
    """A wrapper's launches that took one of its code paths (an integer
    attribute beside its ``launches``), with the ``launches`` interface."""

    def __init__(self, fn, attr):
        self.fn, self.attr = fn, attr
        self.__name__ = f"{fn.__name__}[{attr}]"

    @property
    def launches(self) -> int:
        return getattr(self.fn, self.attr)

    @launches.setter
    def launches(self, value: int) -> None:
        check(value == 0, "an attribute counter only resets")
        setattr(self.fn, self.attr, 0)


I64_MIN, I64_MAX = -(1 << 63), (1 << 63) - 1


def wide_case(torch, n, seed, device):
    """Seeded limbs with carries, INT64_MIN limbs and +-(10^38 - 1), a
    narrow operand, a null mask."""
    from spark_rapids_tpu_torch.batch import wide_limbs
    rng = np.random.default_rng(seed)
    t = _to_device(torch, device)
    a = rng.integers(I64_MIN, I64_MAX, (n, 2), dtype=np.int64, endpoint=True)
    b = rng.integers(I64_MIN, I64_MAX, (n, 2), dtype=np.int64, endpoint=True)
    edge = wide_limbs([0, 1, -1, I64_MIN, I64_MAX, 10 ** 38 - 1, -(10 ** 38 - 1),
                   (1 << 64) - 1, 1 << 64, -(1 << 127), (1 << 127) - 1])
    m = min(n, len(edge))
    a[:m], b[:m] = edge[:m], edge[::-1][:m]
    a[m:2 * m, 0], b[m:2 * m, 0] = -1, 1          # carries out of lo
    a[2 * m:3 * m, 0] = b[2 * m:3 * m, 0] = I64_MIN
    b[3 * m:4 * m] = a[3 * m:4 * m]               # equal pairs
    narrow = rng.integers(-10 ** 17, 10 ** 17, n)
    return t(a), t(b), t(narrow), t(rng.random(n) < 0.9)


def check_wide_decimal(torch, wd, device) -> float:
    """wide_decimal.cu against its plain version, bit for bit: every
    elementwise op over wide and narrow operands, rescaled by 10^k up to
    k = 20, a broadcast literal, null masks; the wide-sum finalize over 2
    and 4 lanes with overflowing and empty groups."""
    cases = 0
    for n, seed in ((0, 1), (1, 2), (37, 3), (1 << 20, 4)):
        a, b, narrow, valid = wide_case(torch, n, seed, device)
        for op in ("add", "sub", "eq", "lt", "le", "gt", "ge"):
            for x, y, ka, kb, v in ((a, b, 0, 0, None), (a, b, 0, 0, valid),
                                    (narrow, b, 2, 0, None),
                                    (a, narrow, 0, 20, valid),
                                    (a, b[:1], 1, 3, None)):
                if n == 0 and y.shape[0] == 0 and y is not b:
                    continue
                if y.shape[0] == 0 and n:
                    continue
                got = wd.wd_kernel(op, x, y, ka, kb, v)
                want = wd.wide_binary_plain(op, x, y, ka, kb, v)
                torch.cuda.synchronize()
                check(torch.equal(got, want), f"wide_decimal {op} differs "
                      f"(n={n}, k={ka}/{kb})")
                cases += 1
        for op, x, k in (("neg", a, 0), ("lift", narrow, 0),
                         ("lift", a, 7), ("lift", narrow, 20),
                         ("lift", a, 20)):
            got = wd.wd_kernel(op, x, None, k, 0, None)
            check(torch.equal(got, wd.wide_binary_plain(op, x, None, k)),
                  f"wide_decimal {op} (k={k}) differs")
            cases += 1
    from spark_rapids_tpu_torch.batch import wide_limbs
    rng = np.random.default_rng(8)
    t = _to_device(torch, device)
    for lanes_of, precision in ((lambda: wd.sum_lanes(t(rng.integers(
            I64_MIN, I64_MAX, 200_000))), 22),
            (lambda: wd.sum_lanes(t(wide_limbs([int(x) * 10 ** 17 for x in
                                            rng.integers(-10 ** 18, 10 ** 18,
                                                         200_000)]))), 36)):
        lanes = lanes_of()
        g = t(rng.integers(0, 1000, 200_000))
        sums = [torch.zeros(1000, dtype=torch.int64, device=device)
                .index_add_(0, g, x) for x in lanes]
        count = torch.bincount(g, minlength=1000)
        count[::97] = 0
        got = wd.sum_finalize_kernel(sums, count, precision)
        want = wd.sum_finalize_plain(sums, count, precision)
        torch.cuda.synchronize()
        check(all(torch.equal(x, y) for x, y in zip(got, want)),
              f"wide sum finalize differs ({len(lanes)} lanes)")
        check(bool((~got[1]).any()), "no overflowing group was drawn")
    print(f"check wide_decimal: {cases} elementwise cases bit-exact (carries, "
          f"INT64_MIN limbs, +-(10^38 - 1), 10^k up to k = 20, a broadcast "
          f"operand, null masks), wide-sum finalize over 2 and 4 lanes with "
          f"overflowing and empty groups bit-exact: ok")
    return 0.0


def _fl_groups(torch, acc):
    """The accumulator's groups sorted by key: (keys, [(value, has) or
    values])."""
    keys, values, live = acc.finish()
    word, ok = keys[0]
    if live is not None:
        word, ok = word[live], ok[live]
        values = [(v[0][live], v[1][live]) if isinstance(v, tuple)
                  else v[live] for v in values]
    key = torch.where(ok, word, I64_MIN)
    order = torch.sort(key).indices
    return key[order], [(v[0][order], v[1][order]) if isinstance(v, tuple)
                        else v[order] for v in values]


def check_first_last(torch, groupby, window, device) -> float:
    """FIRST/LAST kernels against their plain versions, exact: the
    ungrouped picks of masked_reduce.cu over batches of which the first is
    empty; hash_agg.cu's per-slot picks over batches that grow the table
    (a rehash), with all-null groups, an empty batch and keys forced into
    one bucket; window_frame.cu frame_first_last in its four modes over
    empty and all-null frames; and frame_sum over a column with NaN and
    infinities (direct sums)."""
    rng = np.random.default_rng(21)
    t = _to_device(torch, device)
    # ungrouped
    specs = [("first", False), ("last", False), ("first", True),
             ("last", True), ("last", False)]
    accs = []
    for fn in (groupby.masked_reduce, groupby.masked_reduce_plain):
        acc_f, acc_i = groupby.init_scalars(specs, device)
        acc_h = torch.zeros_like(acc_i)
        accs.append((acc_f, acc_i, acc_h))
    for b, n in enumerate((1000, 0, BATCH_ROWS, 5000)):
        ints, floats = t(rng.integers(I64_MIN, I64_MAX, n)), t(rng.normal(
            size=n))
        valid = t(rng.random(n) < 0.01)
        active = t(rng.random(n) < (0.0 if b == 0 else 0.02))
        cols = [(ints, None, "first"), (ints, None, "last"),
                (floats, valid, "first"), (floats, valid, "last"),
                (ints, valid, "last")]
        for (fn, acc) in zip((groupby.masked_reduce,
                              groupby.masked_reduce_plain), accs):
            fn(cols, active, *acc)
    torch.cuda.synchronize()
    check(all(torch.equal(x.view(torch.int64), y.view(torch.int64))
              for x, y in zip(accs[0], accs[1])),
          "masked_reduce first/last differs")
    # grouped, with growth
    cases, grew = 0, False
    for n, batch, groups, collide in ((20_000, 1000, 5000, False),
                                      (3000, 500, 300, True),
                                      (BATCH_ROWS, BATCH_ROWS // 4,
                                       1_000_000, False)):
        keys = rng.integers(0, groups, n)
        valid = (rng.random(n) < 0.3) & (keys % 7 != 0)  # all-null groups
        active = rng.random(n) < 0.7
        active[:batch] = False                            # an empty batch
        ints, floats = rng.integers(I64_MIN, I64_MAX, n), rng.normal(size=n)
        words = [(t(keys), t(rng.random(n) < 0.97))]
        contribs = [(t(ints), None), (t(ints), None), (t(floats), t(valid)),
                    (t(floats), t(valid)), (t(ints), t(valid)),
                    (t(floats), None), (None, None)]
        channels = [("first", False), ("last", False),
                    ("first_valid", True), ("last_valid", True),
                    ("first_valid", False), ("sum", True), ("count", False)]
        case = (words, contribs, channels, t(active))
        kacc = run_hash_agg(torch, groupby, case, batch, False, collide)
        pacc = run_hash_agg(torch, groupby, case, batch, True)
        grew = grew or kacc.growths > 0
        kk, kv = _fl_groups(torch, kacc)
        pk, pv = _fl_groups(torch, pacc)
        torch.cuda.synchronize()
        check(torch.equal(kk, pk), "hash_agg first/last groups differ")
        for j, (a, b) in enumerate(zip(kv, pv)):
            if isinstance(a, tuple):
                check(torch.equal(a[1], b[1]) and torch.equal(
                    a[0][a[1]].view(torch.int64), b[0][b[1]].view(
                        torch.int64)), f"hash_agg first/last channel {j} "
                      f"differs")
            elif channels[j][0] == "count":
                check(torch.equal(a, b), "hash_agg count differs")
        cases += 1
    check(grew, "no first/last case grew the table")
    # windowed
    n = 300_000
    part = np.sort(rng.integers(0, 3000, n))
    seg_start = np.searchsorted(part, part, side="left")
    seg_end = np.searchsorted(part, part, side="right") - 1
    lo = np.maximum(np.arange(n) + rng.integers(-8, 2, n), seg_start)
    hi = np.minimum(np.arange(n) + rng.integers(-2, 8, n), seg_end)
    valid = rng.random(n) < 0.25
    valid[part % 11 == 0] = False                         # all-null frames
    vals = t(rng.integers(I64_MIN, I64_MAX, n))
    lo_t, hi_t = t(lo.astype(np.int32)), t(hi.astype(np.int32))
    for last in (False, True):
        for ign in (False, True):
            got = window.frame_first_last_kernel(vals, t(valid), lo_t, hi_t,
                                                 last, ign)
            want = window.frame_first_last_plain(vals, t(valid), lo_t, hi_t,
                                                 last, ign)
            torch.cuda.synchronize()
            check(torch.equal(got[1], want[1]) and torch.equal(
                got[0][got[1]], want[0][want[1]]),
                f"frame_first_last (last={last}, ignore_nulls={ign}) "
                f"differs")
    x = rng.uniform(-100, 100, 20_000)
    x[rng.choice(20_000, 30, replace=False)] = rng.choice(
        np.array([np.nan, np.inf, -np.inf]), 30)
    p20 = np.sort(rng.integers(0, 40, 20_000))
    xs = t(x)
    run = torch.zeros_like(xs)
    for s, e in zip(*(np.flatnonzero(np.r_[True, p20[1:] != p20[:-1]]),
                      np.r_[np.flatnonzero(p20[1:] != p20[:-1]), 19_999])):
        run[s:e + 1] = torch.cumsum(xs[s:e + 1], 0)
    s20 = np.searchsorted(p20, p20, side="left")
    e20 = np.searchsorted(p20, p20, side="right") - 1
    a20 = t(np.maximum(np.arange(20_000) - 3, s20).astype(np.int32))
    b20 = t(np.minimum(np.arange(20_000) + 1, e20).astype(np.int32))
    got = window.frame_sum_kernel(run, xs, None, a20, b20)
    want = window.frame_sum_plain(run, xs, None, a20, b20)
    torch.cuda.synchronize()
    check(torch.equal(got.view(torch.int64), want.view(torch.int64)),
          "frame_sum over NaN and infinities differs")
    print(f"check first/last: masked_reduce over 4 batches (the first empty), "
          f"hash_agg over {cases} cases with growth, all-null groups, an "
          f"empty batch and one bucket, frame_first_last in 4 modes over "
          f"{n} rows with empty and all-null frames, frame_sum over NaN "
          f"and infinities: exact: ok")
    return 0.0


def check_float_sums_deterministic(torch, groupby, device) -> None:
    """float64 sums of hash_agg.cu and grid_agg.cu are equal to the bit
    over 3 runs of 3 batches (magnitudes far apart, infinities and NaN in
    some slots) and within F64_SUM_TOL x the slot's sum |x| of the plain
    version, as check_dense_agg_deterministic holds dense_agg.cu."""
    rng = np.random.default_rng(16)
    t = _to_device(torch, device)
    n, D = BATCH_ROWS, 100_000
    batches = []
    for b in range(3):
        key = rng.integers(0, D, n)
        val = np.round(rng.uniform(900.0, 105000.0, n), 2) * (
            1 - rng.integers(0, 11, n) / 100.0)
        if b == 1:
            val[:1000] = rng.choice(np.array([1e300, -1e300, 1e-300, 3.0,
                                              -0.0]), 1000)
            val[1000:1006] = [np.inf, -np.inf, np.nan, 1.0, np.nan, 2.0]
        c0 = rng.integers(0, 3, n).astype(np.int32)
        c1 = rng.integers(0, 5, n).astype(np.int32)
        batches.append((t(key), t(val), t(rng.random(n) < 0.9), t(c0),
                        t(c1), t((c0.astype(np.int64) * 6 + c1))))
    for name in ("hash_agg", "grid_agg"):
        runs = []
        for plain in (False, False, False, True):
            if name == "hash_agg":
                acc = groupby.HashAccumulator(1, [("sum", True)], device,
                                              plain=plain)
                for key, val, act, *_ in batches:
                    acc.update([(key, None)], [(val, None)], act, n)
                keys, values, live = acc.finish()
                word, sums = keys[0][0], values[0]
                if live is not None:
                    word, sums = word[live], sums[live]
                order = torch.sort(word).indices
                slot, sums = word[order], sums[order]
            else:
                acc = groupby.GridAccumulator((3, 5), ["f"], device)
                for _, val, act, c0, c1, _ in batches:
                    keys = [(c0, None), (c1, None)]
                    if plain:
                        groupby.grid_agg_plain(keys, (3, 5), [(val, None)],
                                               [], act, acc.f, acc.i,
                                               acc.cnt)
                    else:
                        groupby.grid_agg(keys, (3, 5), [(val, None)], [],
                                         act, acc.f, acc.i, acc.cnt, acc.fx)
                slot, sums = torch.arange(acc.G, device=device), acc.f[:, 0]
            runs.append((slot, sums.clone()))
        scale = torch.zeros(max(D, 24), dtype=torch.float64, device=device)
        for key, val, act, _, _, gid in batches:
            live = act & torch.isfinite(val)
            at = key if name == "hash_agg" else gid
            scale.index_add_(0, at[live], val[live].abs())
        torch.cuda.synchronize()
        for w, r in runs[1:3]:
            check(torch.equal(w, runs[0][0]) and torch.equal(
                r.view(torch.int64), runs[0][1].view(torch.int64)),
                f"{name} float64 sums differ between two runs")
        (slot, k), (pslot, p) = runs[0], runs[3]
        check(torch.equal(slot, pslot), f"{name}: groups differ from plain")
        check(torch.equal(torch.isnan(k), torch.isnan(p)),
              f"{name}: NaN sums differ from plain")
        fin = torch.isfinite(p)
        inf = ~fin & ~torch.isnan(p)
        check(torch.equal(k[inf], p[inf]),
              f"{name}: infinite sums differ from plain")
        s = scale[slot][fin].clamp(min=1e-300)
        err = float(((k[fin] - p[fin]).abs() / s).max()) if fin.any() \
            else 0.0
        check(err <= F64_SUM_TOL, f"{name} float64 sums off by {err:.3e} "
              f"x sum|x|")
        print(f"check {name} float64 sums: 3 runs of 3 batches of {n} rows "
              f"equal bit for bit, specials as plain, max rel err vs plain "
              f"{err:.3e} x sum|x|: ok")


def _row7(name, source, launches, err, ms, plain_ms, nbytes, replaces):
    return {"name": name, "route": "cuda",
            "source": f"spark_rapids_tpu_torch/csrc/{source}.cu",
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": None}


def time_slice7_kernels(torch, groupby, window, wd, device, per_wrapper,
                        db) -> list:
    """The slice-7 kernels at the main path's shapes, each first held
    against its plain version on the same inputs: the wide compare of
    Q18-dec's HAVING and the wide-sum finalize over its groups (every
    distinct l_orderkey at SF10), masked_reduce's FIRST/LAST over an F1u
    batch, hash_agg's FIRST/LAST over an F1 batch into a table that holds
    its customers, and frame_first_last over W2's sorted lineitem.  No
    PyTorch call computes any of them (no 128-bit integers, no FIRST/LAST
    reduction): library_ms is null."""
    t = _to_device(torch, device)
    li, orders = db["lineitem"], db["orders"]
    out, notes = [], []
    # Q18-dec: per order, the DECIMAL(22, 2) sum of l_quantity
    qty = np.bincount(li["l_orderkey"], weights=np.round(
        li["l_quantity"] * 100)).astype(np.int64)
    qty = qty[np.bincount(li["l_orderkey"]) > 0]
    m = len(qty)
    lanes = wd.sum_lanes(t(qty))
    count = t(np.full(m, 4, dtype=np.int64))
    limbs, _, _ = wd.sum_finalize_kernel(lanes, count, 22)
    lit = torch.tensor(300, dtype=torch.int64, device=device)
    got = wd.wd_kernel("gt", limbs, lit, 0, 2)
    want = wd.wide_binary_plain("gt", limbs, lit, 0, 2)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "wide compare differs at Q18-dec's shape")
    inputs = copies_for_l2([limbs])
    ms = time_ms(torch, [lambda x=x[0]: wd.wd_kernel("gt", x, lit, 0, 2)
                         for x in inputs], reps=4 * len(inputs))
    plain_ms = time_ms(torch, [lambda: wd.wide_binary_plain(
        "gt", limbs, lit, 0, 2)], reps=4)
    out.append(_row7("wide_decimal", "wide_decimal",
                     per_wrapper.get("wd_kernel", 0), 0.0, ms, plain_ms,
                     17 * m, "spark_rapids_tpu/ops/wide_decimal.py:72"))
    notes.append(f"{m} groups, DECIMAL(22, 2) > 300 (Q18-dec's HAVING)")
    got = wd.sum_finalize_kernel(lanes, count, 22)
    want = wd.sum_finalize_plain(lanes, count, 22)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, want)),
          "wide sum finalize differs at Q18-dec's shape")
    inputs = copies_for_l2(lanes + [count])
    ms = time_ms(torch, [lambda x=x: wd.sum_finalize_kernel(x[:2], x[2], 22)
                         for x in inputs], reps=4 * len(inputs))
    # the plain version uploads its bounds from the host: one call per
    # event pair
    plain_ms = time_ms_synced(torch, [lambda: wd.sum_finalize_plain(
        lanes, count, 22)], reps=4)
    out.append(_row7("wide_sum_finalize", "wide_decimal",
                     per_wrapper.get("sum_finalize_kernel", 0), 0.0, ms,
                     plain_ms, 41 * m, "spark_rapids_tpu/aggfns.py:131"))
    notes.append(f"{m} groups of 2 lanes and a count into DECIMAL(22, 2) "
                 f"limbs and validity")
    del limbs, lanes, count, inputs, got, want
    # F1u: one lineitem batch, the lines shipped from 1998-08-01 live
    n = min(BATCH_ROWS, len(orders["o_orderkey"]))
    ship = li["l_shipdate"][:n]
    day = ship.astype("datetime64[D]").astype(np.int64)
    active = t(ship >= np.datetime64("1998-08-01"))
    key = t(li["l_orderkey"][:n])
    price = t(np.round(li["l_extendedprice"][:n] * 100).astype(np.int64))
    returned = t(li["l_returnflag"][:n] == "R")
    finished = t(li["l_linestatus"][:n] == "F")
    cols = [(t(day), None, "first"), (price, None, "last"),
            (key, None, "last"), (key, returned, "first"),
            (t(day), finished, "last")]
    specs = [(op, False) for *_, op in cols]
    results = []
    for fn in (groupby.masked_reduce, groupby.masked_reduce_plain):
        acc_f, acc_i = groupby.init_scalars(specs, device)
        acc_h = torch.zeros_like(acc_i)
        fn(cols, active, acc_f, acc_i, acc_h)
        results.append((acc_i, acc_h))
    torch.cuda.synchronize()
    check(torch.equal(results[0][0], results[1][0])
          and torch.equal(results[0][1], results[1][1]),
          "masked_reduce first/last differs at F1u's shape")

    # the accumulators are made once: uploading new ones would wait for
    # pinned host memory inside the timed calls
    acc_f, acc_i = groupby.init_scalars(specs, device)
    acc_h = torch.zeros_like(acc_i)
    inputs = copies_for_l2([active, returned, finished])
    ms = time_ms(torch, [lambda a=a, r=r, f=f: groupby.masked_reduce(
        [cols[0], cols[1], cols[2], (key, r, "first"),
         (cols[4][0], f, "last")], a, acc_f, acc_i, acc_h)
        for a, r, f in inputs], reps=4 * len(inputs))
    plain_ms = time_ms_synced(torch, [lambda: groupby.masked_reduce_plain(
        cols, active, acc_f, acc_i, acc_h)], reps=4)
    out.append(_row7("masked_reduce_first_last", "masked_reduce",
                     per_wrapper.get("masked_reduce[ordered_launches]", 0),
                     0.0, ms, plain_ms, 3 * n + 5 * 8,
                     "spark_rapids_tpu/ops/groupby.py:333"))
    notes.append(f"{n} rows, {int(active.sum())} live, 5 FIRST/LAST "
                 f"columns (the active and 2 validity masks read, one value "
                 f"per column)")
    del inputs
    # F1: one orders batch into a table that holds every customer
    ck = t(orders["o_custkey"][:n])
    odate = t(orders["o_orderdate"][:n].astype("datetime64[D]").astype(
        np.int64))
    tprice = t(np.round(orders["o_totalprice"][:n] * 100).astype(np.int64))
    okey = t(orders["o_orderkey"][:n])
    urgent = t(orders["o_orderpriority"][:n] == "1-URGENT")
    filled = t(orders["o_orderstatus"][:n] == "F")
    contribs = [(odate, None), (tprice, None), (okey, None), (okey, urgent),
                (odate, filled), (None, None)]
    channels = [("first", False), ("last", False), ("last", False),
                ("first_valid", False), ("last_valid", False),
                ("count", False)]
    accs = []
    for plain in (False, True):
        acc = groupby.HashAccumulator(1, channels, device, plain=plain,
                                      key_bound=len(db["customer"][
                                          "c_custkey"]))
        for _ in range(2):  # the second call finds every group in place
            acc.update([(ck, None)], contribs, None, n)
        accs.append(acc)
    kk, kv = _fl_groups(torch, accs[0])
    pk, pv = _fl_groups(torch, accs[1])
    torch.cuda.synchronize()
    check(torch.equal(kk, pk) and all(
        torch.equal(a[1], b[1]) and torch.equal(a[0][a[1]], b[0][b[1]])
        if isinstance(a, tuple) else torch.equal(a, b)
        for a, b in zip(kv, pv)), "hash_agg first/last differs at F1's "
        "shape")
    groups = int(kk.shape[0])
    ms = time_ms(torch, [lambda: accs[0].update([(ck, None)], contribs,
                                                None, n)], reps=8)
    plain_ms = time_ms_synced(torch, [lambda: accs[1].update(
        [(ck, None)], contribs, None, n)], reps=2)
    # per row its key, 4 values and 2 masks; per group its state, key,
    # null bits, and 5 accumulators and 4 words, read and written
    nbytes = n * (8 + 4 * 8 + 2) + 2 * groups * (4 + 8 + 4 + 5 * 8 + 4 * 8)
    out.append(_row7("hash_agg_first_last", "hash_agg",
                     per_wrapper.get("hash_agg_update[ordered_launches]", 0),
                     0.0, ms, plain_ms, nbytes,
                     "spark_rapids_tpu/ops/groupby.py:195"))
    notes.append(f"{n} orders into {groups} customer groups, F1's 5 "
                 f"FIRST/LAST channels and the count")
    del accs, contribs
    # the repaired float64 sums on the hash path: one lineitem batch's
    # revenue per order (Q3's aggregate shape, but on the hash table)
    okeys = t(li["l_orderkey"][:n])
    rev = t(li["l_extendedprice"][:n] * (1 - li["l_discount"][:n]))
    contribs = [(rev, None), (None, None)]
    accs = []
    for plain in (False, True):
        # the same n rows every call: at most n groups, so the timed calls
        # never fetch the group count
        acc = groupby.HashAccumulator(1, [("sum", True), ("count", False)],
                                      device, plain=plain, key_bound=n)
        acc.update([(okeys, None)], contribs, None, n)
        accs.append(acc)
    kk, kv = _fl_groups(torch, accs[0])
    pk, pv = _fl_groups(torch, accs[1])
    torch.cuda.synchronize()
    err = float((kv[0] - pv[0]).abs().max())
    check(torch.equal(kk, pk) and torch.equal(kv[1], pv[1])
          and err <= F64_SUM_TOL * float(rev.abs().sum()),
          "hash_agg float64 sums differ at the timing shape")
    groups = int(kk.shape[0])
    ms = time_ms(torch, [lambda: accs[0].update([(okeys, None)], contribs,
                                                None, n)], reps=8)
    plain_ms = time_ms_synced(torch, [lambda: accs[1].update(
        [(okeys, None)], contribs, None, n)], reps=2)
    out.append(_row7("hash_agg_f64_sum", "hash_agg",
                     per_wrapper.get("hash_agg_update", 0), err, ms,
                     plain_ms, n * 16 + 2 * groups * (4 + 8 + 4 + 8 + 8),
                     "spark_rapids_tpu/ops/groupby.py:251"))
    notes.append(f"{n} lineitems into {groups} order groups, one float64 "
                 f"sum (the fixed point: a largest-|x| pass, the adds, a "
                 f"fold over the table) and a count")
    del accs, contribs
    # W2: the whole lineitem in supplier order, ROWS -6..0, LAST ignoring
    # nulls of the returned lines' prices
    order = np.argsort(li["l_suppkey"], kind="stable")
    supp = li["l_suppkey"][order]
    nn = len(supp)
    s_start = np.searchsorted(supp, supp, side="left").astype(np.int32)
    i = np.arange(nn, dtype=np.int32)
    lo = t(np.maximum(i - 6, s_start))
    hi = t(i)
    vals = t(li["l_extendedprice"][order])
    valid = t(li["l_returnflag"][order] == "R")
    del order, supp, s_start, i
    got = window.frame_first_last_kernel(vals, valid, lo, hi, True, True)
    want = window.frame_first_last_plain(vals, valid, lo, hi, True, True)
    torch.cuda.synchronize()
    check(torch.equal(got[1], want[1]) and torch.equal(
        got[0][got[1]], want[0][want[1]]),
        "frame_first_last differs at W2's shape")
    del got, want
    ms = time_ms(torch, [lambda: window.frame_first_last_kernel(
        vals, valid, lo, hi, True, True)], reps=8)
    plain_ms = time_ms(torch, [lambda: window.frame_first_last_plain(
        vals, valid, lo, hi, True, True)], reps=2)
    # values at the picked rows at most (8 B), validity and the bounds
    # read, value and validity written
    out.append(_row7("frame_first_last", "window_frame",
                     per_wrapper.get("frame_first_last_kernel", 0), 0.0, ms,
                     plain_ms, nn * (8 + 1 + 4 + 4 + 8 + 1),
                     "spark_rapids_tpu/windowfns.py:321"))
    notes.append(f"{nn} rows in supplier order, ROWS -6..0, LAST ignoring "
                 f"nulls")
    for row, note in zip(out, notes):
        nbytes = round(row["bound_ms"] * 1e-3 * HBM_BYTES_PER_S)
        print(f"kernel {row['name']}: {row['ms']:.4f} ms at {note} (bound "
              f"{row['bound_ms']:.4f} ms for {nbytes} B, plain "
              f"{row['plain_ms']:.4f} ms, no library call), max |err| vs "
              f"plain {row['max_abs_err']:.3e}, {row['launches']} launches "
              f"on the main path")
    return out


# ---------------------------------------------------------------------------------
# Slice 8: the sample's keep mask and the explode
# ---------------------------------------------------------------------------------

# Random123's known-answer vectors for threefry2x32 with 20 rounds:
# (key, counter) -> output
THREEFRY_KAT = (((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
                ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF),
                 (0x1CB996FC, 0xBB002BE7)),
                ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3),
                 (0xC4923A9C, 0x483DF7A0)))


def _words(torch, a, device):
    """uint32 words (numpy) as the int32 tensor of their bits."""
    return torch.from_numpy(np.asarray(a, dtype=np.uint32).view(
        np.int32)).to(device)


def check_sample(torch, sample_ops, device) -> None:
    """The sample kernel against its plain version: threefry on the
    known-answer vectors and on random words, then keep masks for
    negative, large and ordinary seeds, several batch indexes, odd and
    even sizes, a batch with a selection, padding rows past num_rows, and
    fractions 0 and 1.  Every mask is bit-exact."""
    for key, (x0, x1), want in THREEFRY_KAT:
        o0, o1 = sample_ops.threefry2x32_kernel(
            key, _words(torch, [x0], device), _words(torch, [x1], device))
        got = (int(o0.cpu().numpy().view(np.uint32)[0]),
               int(o1.cpu().numpy().view(np.uint32)[0]))
        check(got == want, f"threefry kernel {got} vs Random123 {want}")
        p0, p1 = sample_ops.threefry2x32_plain(
            key, torch.tensor([x0]), torch.tensor([x1]))
        check((int(p0[0]), int(p1[0])) == want,
              "threefry plain differs from Random123")
    rng = np.random.default_rng(81)
    w = rng.integers(0, 1 << 32, (2, 1 << 20), dtype=np.uint64)
    key = (int(w[0, 0]), int(w[1, 0]))
    k0, k1 = sample_ops.threefry2x32_kernel(
        key, _words(torch, w[0], device), _words(torch, w[1], device))
    p0, p1 = sample_ops.threefry2x32_plain(
        key, torch.from_numpy(w[0].astype(np.int64)).to(device),
        torch.from_numpy(w[1].astype(np.int64)).to(device))
    torch.cuda.synchronize()
    check(torch.equal(k0.to(torch.int64) & sample_ops.M32, p0)
          and torch.equal(k1.to(torch.int64) & sample_ops.M32, p1),
          "threefry kernel differs from plain on random words")
    cases = 0
    for seed in (0, 42, 2 ** 31 - 1, 2 ** 40 + 7, -1, -(2 ** 63)):
        for idx in (0, 3, 14):
            for n, cap, frac, with_sel in (
                    (BATCH_ROWS, BATCH_ROWS, 0.01, False),
                    (1001, 1001, 0.5, True), (1000, 1024, 0.3, False),
                    (777, 4096, 0.7, True), (5000, 5000, 0.0, False),
                    (5000, 5000, 1.0, True), (0, 16, 0.5, False)):
                sel = torch.from_numpy(rng.random(n) < 0.6).to(device) \
                    if with_sel else None
                k = sample_ops.batch_key(seed, idx)
                got = sample_ops.sample_mask_kernel(k, frac, sel, n, cap,
                                                    device)
                want = sample_ops.sample_mask_plain(k, frac, sel, n, cap,
                                                    device)
                torch.cuda.synchronize()
                check(torch.equal(got, want), f"sample mask differs (seed "
                      f"{seed}, batch {idx}, {n} of {cap} rows, fraction "
                      f"{frac}, sel {with_sel})")
                check(not bool(got[n:].any()), "a padding row became live")
                if frac == 0.0:
                    check(not bool(got.any()), "fraction 0 kept a row")
                if frac == 1.0:
                    check(torch.equal(got[:n], sel), "fraction 1 dropped a "
                          "live row")
                cases += 1
    print(f"check sample: threefry equals Random123's 3 known answers and "
          f"plain on 2^20 random words; {cases} keep masks (6 seeds incl. "
          f"-1, -2^63 and 2^40+7, 3 batch indexes, sel, padding, fractions "
          f"0 and 1) equal plain bit for bit: ok")


def explode_case(torch, rng, device, lens, null_frac=0.0, elem_null=0.0,
                 outer=False):
    """A batch of lists of the given lengths (a ``null_frac`` of them null,
    holding no element), elements float64 with an ``elem_null`` share of
    nulls, and siblings of every width: int64 with nulls, int32 (a date),
    int16, bool, float64, and the two limb columns of a wide decimal."""
    n = len(lens)
    null = rng.random(n) < null_frac
    lens = np.where(null, 0, lens).astype(np.int64)
    out_lens = np.maximum(lens, 1) if outer else lens
    starts = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(out_lens, out=starts[1:])
    offs = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lens, out=offs[1:])
    t = _to_device(torch, device)
    e = int(offs[-1])
    values = t(rng.standard_normal(e))
    values_valid = t(rng.random(e) >= elem_null) if elem_null else None
    cols = [(t(rng.integers(-9, 9, n)), t(rng.random(n) < 0.9)),
            (t(rng.integers(0, 9000, n).astype(np.int32)), None),
            (t(rng.integers(0, 99, n).astype(np.int16)), None),
            (t(rng.random(n) < 0.5), t(rng.random(n) < 0.5)),
            (t(rng.standard_normal(n)), None),
            (t(rng.integers(-1 << 62, 1 << 62, n)), None),  # wide limbs
            (t(rng.integers(-1 << 62, 1 << 62, n)), None)]
    return (t(starts), t(offs) if outer else None, values, values_valid,
            cols, int(starts[-1]))


def check_explode(torch, generate, device) -> None:
    """The explode kernel against its plain version, every output exact:
    random lists with null lists and null elements, with and without
    OUTER, cut into chunks that split lists; every list empty (OUTER);
    every list null under OUTER; one list longer than a chunk; more
    sibling columns than one launch takes."""
    rng = np.random.default_rng(82)
    chunk = 4096
    cases = {
        "random": explode_case(torch, rng, device,
                               rng.integers(0, 9, 20_000), 0.05, 0.1),
        "random, outer": explode_case(torch, rng, device,
                                      rng.integers(0, 9, 20_000), 0.05, 0.1,
                                      outer=True),
        "every list empty, outer": explode_case(
            torch, rng, device, np.zeros(10_000, dtype=np.int64),
            outer=True),
        "every list null, outer": explode_case(
            torch, rng, device, rng.integers(1, 5, 10_000), 1.0,
            outer=True),
        "one list longer than a chunk": explode_case(
            torch, rng, device, np.where(np.arange(3000) == 1234,
                                         3 * chunk + 17, 1), 0.0, 0.05),
        "one long list, outer": explode_case(
            torch, rng, device, np.where(np.arange(3000) == 5,
                                         2 * chunk + 1, 0), 0.0, 0.0,
            outer=True)}
    for what, (starts, eoffs, values, vv, cols, total) in cases.items():
        for lo in range(0, total, chunk):
            m = min(chunk, total - lo)
            flat = cols + cols[:2] * 6  # 18 columns: two launches
            got = generate.explode_kernel(starts, eoffs, lo, m, values, vv,
                                          flat, True)
            want = generate.explode_plain(starts, eoffs, lo, m, values, vv,
                                          flat, True)
            torch.cuda.synchronize()
            check(torch.equal(got[0][0], want[0][0])
                  and torch.equal(got[0][1], want[0][1]),
                  f"explode elements differ ({what}, rows {lo}+{m})")
            for (gd, gv), (wd_, wv) in zip(got[1], want[1]):
                check(torch.equal(gd, wd_) and (gv is None) == (wv is None)
                      and (gv is None or torch.equal(gv, wv)),
                      f"explode siblings differ ({what}, rows {lo}+{m})")
    print(f"check explode: {len(cases)} batches (null lists, null elements, "
          f"every list empty or null under OUTER, a list longer than a "
          f"chunk) in chunks of {chunk} rows, 18 sibling columns of 1-8 "
          f"bytes, equal plain exactly: ok")


def sample_batches(torch, sample_ops, n_rows: int, device) -> np.ndarray:
    """The rows Q1-sample keeps: per lineitem batch, the kernel's keep
    mask held to the plain version's bit for bit (launches outside the
    counted runs); returns the plain masks as one host array."""
    from spark_rapids_tpu_torch.models import tpch
    parts = []
    for idx, off in enumerate(range(0, n_rows, BATCH_ROWS)):
        m = min(BATCH_ROWS, n_rows - off)
        key = sample_ops.batch_key(tpch.Q1_SAMPLE_SEED, idx)
        got = sample_ops.sample_mask_kernel(key, tpch.Q1_SAMPLE_FRACTION,
                                            None, m, m, device)
        want = sample_ops.sample_mask_plain(key, tpch.Q1_SAMPLE_FRACTION,
                                            None, m, m, device)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"Q1-sample batch {idx}: the "
              f"kernel's keep mask differs from the plain version's")
        parts.append(want.cpu().numpy())
    return np.concatenate(parts)


# the card's peak rate for 32-bit integer instructions outside the tensor
# cores, taken as the H100 SXM's non-tensor float32 peak rate
INT32_OPS_PER_S = 67e12


def time_slice8_kernels(torch, sample_ops, generate, batch_utils, device,
                        per_wrapper, db, x1_lists, x1o_lists) -> list:
    """The slice-8 kernels at the main path's shapes, each first held
    against its plain version on the same inputs: the sample's keep mask
    over one Q1-sample lineitem batch (4,194,304 rows, no selection), and
    the explode of X1o's first chunk (the first 4,194,304 orders with
    OUTER, their element values and o_orderkey).  Library yardsticks:
    ``torch.rand`` in float64 and a compare (another generator: a
    yardstick, not an equivalent), and ``repeat_interleave`` with
    ``index_select``.  Also times the host compaction of an X1 batch
    (row 3-rest, host half: one fetch of the mask and numpy filters; not
    a kernel, so not in the kernels line)."""
    from spark_rapids_tpu_torch.batch import (ColumnBatch, DeviceColumn,
                                              Field, HostListColumn,
                                              HostStringColumn, Schema)
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.models import tpch
    out = []
    n = BATCH_ROWS
    key = sample_ops.batch_key(tpch.Q1_SAMPLE_SEED, 0)
    frac = tpch.Q1_SAMPLE_FRACTION
    got = sample_ops.sample_mask_kernel(key, frac, None, n, n, device)
    want = sample_ops.sample_mask_plain(key, frac, None, n, n, device)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "sample mask differs at Q1-sample's shape")
    ms = time_ms(torch, [lambda: sample_ops.sample_mask_kernel(
        key, frac, None, n, n, device)], reps=32)
    plain_ms = time_ms(torch, [lambda: sample_ops.sample_mask_plain(
        key, frac, None, n, n, device)], reps=4)
    lib_ms = time_ms(torch, [lambda: torch.rand(
        n, dtype=torch.float64, device=device) < frac], reps=32)
    ops_ms = sample_ops.OPS_PER_ROW * n / INT32_OPS_PER_S * 1e3
    bytes_ms = n / HBM_BYTES_PER_S * 1e3  # the mask written, no sel read
    out.append({"name": "sample_mask", "route": "cuda",
                "source": "spark_rapids_tpu_torch/csrc/sample.cu",
                "replaces": "spark_rapids_tpu/plan/exec_nodes.py:310",
                "launches": per_wrapper.get("sample_mask_kernel", 0),
                "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": max(ops_ms, bytes_ms),
                "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
                "library_ms": lib_ms})
    print(f"kernel sample_mask: {ms:.4f} ms at {n} rows, fraction {frac} "
          f"(bound {max(ops_ms, bytes_ms):.4f} ms: "
          f"{sample_ops.OPS_PER_ROW * n} integer ops {ops_ms:.4f} ms, {n} B "
          f"{bytes_ms:.4f} ms; plain {plain_ms:.4f} ms, torch.rand float64 "
          f"and a compare {lib_ms:.4f} ms), bit-exact vs plain, "
          f"{out[-1]['launches']} launches on the main path")
    del got, want
    # X1o's first chunk: the first batch of orders, OUTER
    t = _to_device(torch, device)
    lists = x1o_lists
    offs = lists.offsets[:n + 1]
    lens = np.diff(offs)
    out_lens = np.maximum(lens, 1)
    starts_h = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(out_lens, out=starts_h[1:])
    m = n
    p_cnt = int(np.searchsorted(starts_h, m - 1, side="right"))
    inputs = copies_for_l2([t(starts_h), t(offs - offs[0]),
                            t(lists.values[offs[0]:offs[-1]]),
                            t(db["orders"]["o_orderkey"][:n])])
    s_, e_, v_, k_ = inputs[0]
    got = generate.explode_kernel(s_, e_, 0, m, v_, None, [(k_, None)], True)
    want = generate.explode_plain(s_, e_, 0, m, v_, None, [(k_, None)], True)
    torch.cuda.synchronize()
    check(torch.equal(got[0][0], want[0][0])
          and torch.equal(got[0][1], want[0][1])
          and torch.equal(got[1][0][0], want[1][0][0]),
          "explode differs at X1o's shape")
    del got, want
    ms = time_ms(torch, [lambda x=x: generate.explode_kernel(
        x[0], x[1], 0, m, x[2], None, [(x[3], None)], True)
        for x in inputs], reps=4 * len(inputs))
    # repeat_interleave sizes its output from the device: one call per
    # event pair
    plain_ms = time_ms_synced(torch, [lambda: generate.explode_plain(
        s_, e_, 0, m, v_, None, [(k_, None)], True)], reps=4)
    cnt = t(out_lens)
    total = int(starts_h[-1])
    ar = torch.arange(n, device=device)
    lib_ms = time_ms(torch, [lambda: k_.index_select(
        0, torch.repeat_interleave(ar, cnt, output_size=total)[:m])],
        reps=8)
    # per row the element (8 B read, 8 written), its validity (1 B) and
    # o_orderkey written (8 B); per parent the starts, the offsets and
    # o_orderkey read once (24 B)
    nbytes = m * (8 + 8 + 1 + 8) + p_cnt * 24
    out.append({"name": "explode", "route": "cuda",
                "source": "spark_rapids_tpu_torch/csrc/explode.cu",
                "replaces": "spark_rapids_tpu/plan/exec_nodes.py:466",
                "launches": per_wrapper.get("explode_kernel", 0),
                "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                "bound_by": "bytes", "library_ms": lib_ms})
    print(f"kernel explode: {ms:.4f} ms at X1o's first chunk ({m} rows of "
          f"{p_cnt} orders, OUTER, one int64 sibling; bound "
          f"{out[-1]['bound_ms']:.4f} ms for {nbytes} B, plain "
          f"{plain_ms:.4f} ms, repeat_interleave + index_select "
          f"{lib_ms:.4f} ms), exact vs plain, {out[-1]['launches']} "
          f"launches on the main path")
    del inputs, s_, e_, v_, k_, cnt, ar
    # row 3-rest, host half: compacting one X1 batch (the year's orders
    # live) with its priority strings and quantity lists on the host
    o = db["orders"]
    lo_d, hi_d = (np.datetime64(d) for d in tpch.X1_YEAR)
    live = (o["o_orderdate"][:n] >= lo_d) & (o["o_orderdate"][:n] < hi_d)
    batch = ColumnBatch(
        Schema([Field("o_orderkey", T.INT64), Field("o_orderpriority",
                                                    T.STRING),
                Field("o_qty", T.array(T.FLOAT64))]),
        [DeviceColumn(T.INT64, t(o["o_orderkey"][:n])),
         HostStringColumn(o["o_orderpriority"][:n]),
         HostListColumn(x1_lists[:n])], n, t(live))
    torch.cuda.synchronize()
    reps, t0 = 4, time.perf_counter()
    for _ in range(reps):
        packed = batch_utils.compact(batch)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / reps
    check(packed.num_rows == int(live.sum()), "host compaction lost rows")
    print(f"host compaction (row 3-rest, host half): {host_ms:.4f} ms per "
          f"X1 batch ({n} orders, {int(live.sum())} live; one fetch of the "
          f"{n}-byte mask, then the priority strings and the quantity "
          f"lists filtered with numpy; host clock)")
    return out


def check_key_stats(torch, rf, device) -> None:
    """key_stats (row 15) against its plain version on the card: an empty
    build, all keys null, one key, exactly maxInKeys and maxInKeys + 1
    distinct keys (the IN list's edge), negative keys, the int64 extremes
    (INT64_MAX as a valid key too), int32 and date keys, a live mask, and
    a 15,000,000-row build.  The stats and the distinct prefix must be
    equal."""
    vcap = rf.in_list_capacity(10_000)
    rng = np.random.default_rng(15)
    i64 = np.iinfo(np.int64)
    cases = [
        ("empty", np.zeros(0, np.int64), None, None),
        ("all null", rng.integers(0, 99, 1000), np.zeros(1000, bool), None),
        ("one key", np.array([42], np.int64), None, None),
        ("maxInKeys distinct", rng.permutation(np.repeat(
            np.arange(10_000, dtype=np.int64) * 7 - 30_000, 3)), None, None),
        ("maxInKeys + 1 distinct", rng.permutation(
            np.arange(10_001, dtype=np.int64)), None, None),
        ("negative", -rng.integers(1, 1 << 40, 50_000), None, None),
        ("int64 extremes", np.array([i64.max, i64.min, 0, i64.max, -1,
                                     i64.min + 1, i64.max - 1], np.int64),
         None, None),
        ("int32", rng.integers(-(1 << 31), (1 << 31) - 1, 200_000,
                               dtype=np.int32), rng.random(200_000) < .9,
         None),
        ("date", (rng.integers(8000, 10500, 300_000)).astype(np.int32),
         None, rng.random(300_000) < .3),
        ("15 M rows", rng.permutation(np.arange(1, 15_000_001,
                                                dtype=np.int64)),
         rng.random(15_000_000) < .999, rng.random(15_000_000) < .0005)]
    for name, key, valid, active in cases:
        k = torch.from_numpy(np.ascontiguousarray(key)).to(device)
        v = None if valid is None else torch.from_numpy(valid).to(device)
        a = None if active is None else torch.from_numpy(active).to(device)
        got = rf.key_stats_kernel(k, v, a, vcap)
        want = rf.key_stats_plain(k, v, a, vcap)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"key_stats differs from plain on "
              f"{name}: {got[:rf.HEADER].tolist()} vs "
              f"{want[:rf.HEADER].tolist()}")
    print(f"key_stats: equal to plain on {len(cases)} cases (empty, all "
          f"null, one key, 10,000 and 10,001 distinct, negative, int64 "
          f"extremes, int32, date, 15,000,000 rows)")


def time_slice9_kernels(torch, rf, device, per_wrapper) -> list:
    """key_stats at Q18's largest runtime-filter build at SF10: the
    15,000,000 orders (o_orderkey) under the selection of the orders whose
    quantity passes 300 (about 0.05% live), vcap 16,384 (maxInKeys
    10,000).  Library yardstick: the live keys' ``torch.aminmax`` and
    ``torch.unique(sorted=True)``."""
    n = 15_000_000
    vcap = rf.in_list_capacity(10_000)
    rng = np.random.default_rng(18)
    t = _to_device(torch, device)
    inputs = copies_for_l2([t(np.arange(1, n + 1, dtype=np.int64)),
                            t(rng.random(n) < 0.0005)])
    k0, a0 = inputs[0]
    got = rf.key_stats_kernel(k0, None, a0, vcap)
    want = rf.key_stats_plain(k0, None, a0, vcap)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "key_stats differs at Q18's shape")
    live = int(got[2])
    ms = time_ms(torch, [lambda x=x: rf.key_stats_kernel(x[0], None, x[1],
                                                         vcap)
                         for x in inputs], reps=4 * len(inputs))
    # the plain version reads its boolean-indexed sizes on the host
    plain_ms = time_ms_synced(torch, [lambda: rf.key_stats_plain(
        k0, None, a0, vcap)], reps=4)

    def library():
        sel = k0[a0]
        return torch.aminmax(sel), torch.unique(sel, sorted=True)
    lib_ms = time_ms_synced(torch, [library], reps=4)
    # the key (8 B) and the live mask (1 B) read once, the stats and the
    # distinct prefix written once
    nbytes = n * 9 + (rf.HEADER + vcap) * 8
    out = [{"name": "key_stats", "route": "cuda",
            "source": "spark_rapids_tpu_torch/csrc/key_stats.cu",
            "replaces": "spark_rapids_tpu/plan/join_exec.py:161",
            "launches": per_wrapper.get("key_stats_kernel", 0),
            "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": lib_ms}]
    print(f"kernel key_stats: {ms:.4f} ms at {n} rows, {live} live "
          f"(bound {out[0]['bound_ms']:.4f} ms for {nbytes} B; plain "
          f"{plain_ms:.4f} ms, aminmax + unique of the live keys "
          f"{lib_ms:.4f} ms), exact vs plain, {out[0]['launches']} launches "
          f"on the main path")
    return out


def scan_report(sess) -> dict:
    """Scan rows, row groups read and total, and runtime predicates of the
    last collect's file scans."""
    ctx = sess.last_exec_context()
    out = {"scan_rows": 0, "row_groups_read": 0, "row_groups_total": 0,
           "runtime_predicates": 0}
    for op, m in ctx.metrics.items():
        if op.startswith("ScanExec"):
            out["scan_rows"] += int(m.values.get("numOutputRows", 0))
            out["row_groups_read"] += int(m.values.get("rowGroupsRead", 0))
            out["row_groups_total"] += int(m.values.get("rowGroupsTotal", 0))
            out["runtime_predicates"] += int(
                m.values.get("runtimePredicates", 0))
    return out


def check_f1(out, want) -> float:
    """F1's device columns, sorted by o_custkey (the hash aggregate's
    output order is not specified), against the oracle exactly."""
    order = out["o_custkey"][0].argsort()
    sorted_out = {c: (d[order], None if v is None else v[order])
                  for c, (d, v) in out.items()}
    return check_device_columns("F1", exact_floats=True)(sorted_out, want)


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
        from spark_rapids_tpu_torch.batch import numpy_column
        from spark_rapids_tpu_torch.models import tpch
        from spark_rapids_tpu_torch.ops import (batch_utils, groupby, hashing,
                                                join, window)
        from spark_rapids_tpu_torch.ops import wide_decimal as wd
        from spark_rapids_tpu_torch.ops import generate
        from spark_rapids_tpu_torch.ops import runtime_filter as rf
        from spark_rapids_tpu_torch.ops import sample as sample_ops
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
        check_dense_agg_deterministic(torch, groupby, device)
        worst["sort"] = check_sort(torch, sort_ops, device)
        worst["window_scan"] = check_window(torch, window, device)
        worst["window_frame"] = worst["window_scan"]
        worst["cond_join"] = check_cond_join(torch, join, device)
        worst["wide_decimal"] = check_wide_decimal(torch, wd, device)
        check_first_last(torch, groupby, window, device)
        check_float_sums_deterministic(torch, groupby, device)
        check_sample(torch, sample_ops, device)
        check_explode(torch, generate, device)
        check_key_stats(torch, rf, device)
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
                       "nation": 25, "partsupp": DB_PARTSUPP,
                       "part": DB_PART, "region": 5},
              f"SF{SF:g} gen_db tables have {rows} rows")
        sf1 = tpch.gen_db_arrays(1.0, tables=Q11_TABLES)
        print(f"datagen gen_db (every table): {rows} rows, and Q11's "
              f"tables at SF1, in "
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
        for q in REST_QUERIES:
            t1 = time.perf_counter()
            db_want[q] = getattr(tpch, f"{q}_numpy")(
                *(db[t] for t in tpch.QUERY_TABLES[q]))
            took[q] = time.perf_counter() - t1
        db_want.update(small_join_oracles(db))
        dec = {t: tpch.decimal_columns(db[t], tpch.MONEY_COLUMNS[t])
               for t in ("lineitem", "orders", "customer")}
        for q, fn in (("q1_dec", lambda: tpch.q1_dec_numpy(db["lineitem"])),
                      ("q6_dec", lambda: [(tpch.q6_dec_numpy(
                          db["lineitem"]),)]),
                      ("q18_dec", lambda: tpch.q18_dec_numpy(
                          db["orders"], db["lineitem"], db["customer"])),
                      ("f1", lambda: tpch.f1_numpy(db["orders"])),
                      ("f1u", lambda: tpch.f1u_numpy(db["lineitem"])),
                      ("w2", lambda: tpch.w2_numpy(db["lineitem"]))):
            t1 = time.perf_counter()
            db_want[q] = fn()
            took[q] = time.perf_counter() - t1
        # slice 8: the lists of X1 and X1o, the rows the sample keeps (the
        # kernel's mask held to the plain one on every batch), the oracles
        t1 = time.perf_counter()
        orders_cols = {c: db["orders"][c] for c in
                       ("o_orderkey", "o_orderdate", "o_orderpriority")}
        # lineitem in l_orderkey order: one stable sort on the card
        order = torch.sort(torch.from_numpy(db["lineitem"]["l_orderkey"])
                           .to(device), stable=True).indices.cpu().numpy()
        x1_lists = tpch.order_quantities(db["orders"], db["lineitem"],
                                         order=order)
        x1o_lists = tpch.order_quantities(db["orders"], db["lineitem"],
                                          null_frac=0.01, empty_frac=0.01,
                                          order=order)
        del order
        x1_table = dict(orders_cols, o_qty=x1_lists)
        x1o_table = {"o_orderkey": db["orders"]["o_orderkey"],
                     "o_qty": x1o_lists}
        took["x1 lists"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        keep = sample_batches(torch, sample_ops, DB_LINEITEM, device)
        db_want["q1_sample"] = tpch.q1_sample_numpy(db["lineitem"], keep)
        took["q1_sample"] = time.perf_counter() - t1
        print(f"q1_sample: the kernel's keep mask equals the plain one on "
              f"all {-(-DB_LINEITEM // BATCH_ROWS)} batches; "
              f"{int(keep.sum())} of {DB_LINEITEM} rows kept")
        del keep
        for q, fn in (("x1", lambda: tpch.x1_numpy(db["orders"],
                                                   db["lineitem"])),
                      ("x1o", lambda: tpch.x1o_numpy(x1o_table, x1o_lists)),
                      ("q18_in", lambda: db_want["q18"]),
                      ("q16_notin", lambda: db_want["q16"]),
                      ("q22_scalar", lambda: db_want["q22"])):
            t1 = time.perf_counter()
            db_want[q] = fn()
            took[q] = time.perf_counter() - t1
        # slice 9: the same tables as the files gen_db writes (orders with
        # its constant o_shippriority, which the in-memory paths leave out)
        full = dict(db, orders=dict(db["orders"], o_shippriority=np.zeros(
            DB_ORDERS, dtype=np.int64)))
        pq_want = {}
        for q in tpch.SUITE_QUERIES:
            t1 = time.perf_counter()
            pq_want[q] = db_want[q] if q in db_want else (
                tpch.q6_numpy(full["lineitem"]) if q == "q6"
                else tpch.query_oracle(q, full))
            took[f"pq_{q}"] = time.perf_counter() - t1
        print("oracle rows: " + ", ".join(
            f"{q} {len(db_want[q])}" for q in REST_QUERIES))
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
        ddf = {t: sess.create_dataframe(cols) for t, cols in dec.items()}
        q11f = {t: sess.create_dataframe(sf1[t]) for t in Q11_TABLES}
        x1f = sess.create_dataframe(x1_table)
        x1of = sess.create_dataframe(x1o_table)

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
                             window.frame_minmax_kernel],
            "cond_join": [join.cond_expand_kernel, join.cond_counts_kernel,
                          join.cross_pairs_kernel],
            "wide_decimal": [wd.wd_kernel, wd.sum_finalize_kernel],
            "hash_agg_first_last": [AttrCounter(groupby.hash_agg_update,
                                                "ordered_launches")],
            "masked_reduce_first_last": [AttrCounter(groupby.masked_reduce,
                                                     "ordered_launches")],
            "window_first_last": [window.frame_first_last_kernel],
            "sample": [sample_ops.sample_mask_kernel],
            "explode": [generate.explode_kernel],
            "key_stats": [rf.key_stats_kernel]}
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
        # slice 6: every kernel counted from 0 before each path
        from spark_rapids_tpu_torch.sql import functions as F
        rest = [(q, (lambda q=q: getattr(tpch, q)(
            *(dbf[t] for t in tpch.QUERY_TABLES[q]))),
            check_rows(q.upper()), db_want[q]) for q in REST_QUERIES]
        rest += [("x_cross", lambda: dbf["region"].cross_join(dbf["nation"]),
                  check_sorted_rows("cross join"), db_want["x_cross"]),
                 ("x_exists", lambda: tpch.conditioned_join(
                     dbf["nation"], dbf["supplier"],
                     [("n_nationkey", "s_nationkey")], "existence",
                     F.col("s_acctbal") > 9990.0),
                  check_sorted_rows("existence join"),
                  db_want["x_exists"])]
        for name, df_fn, checker, want in rest:
            for fns in counters.values():
                for fn in fns:
                    fn.launches = 0
            runs_of[name] = run_query(torch, sess, df_fn, checker, want,
                                      name, counters,
                                      require=REST_REQUIRE.get(name, ()))
            for k, v in launch_counts(counters).items():
                launches[k] = launches.get(k, 0) + v
            for fns in counters.values():
                for fn in fns:
                    if fn.launches:
                        per_wrapper[fn.__name__] = \
                            per_wrapper.get(fn.__name__, 0) + fn.launches
            paths.append((name, df_fn, checker, want, ()))
        # slice 7: decimal money columns and FIRST/LAST, every kernel
        # counted from 0 before each
        slice7 = [
            ("q1_dec", lambda: tpch.q1_dec(ddf["lineitem"]),
             check_rows("Q1-dec"), collect),
            ("q6_dec", lambda: tpch.q6_dec(ddf["lineitem"]),
             check_rows("Q6-dec"), collect),
            ("q18_dec", lambda: tpch.q18_dec(ddf["orders"], ddf["lineitem"],
                                             ddf["customer"]),
             check_rows("Q18-dec"), collect),
            ("f1", lambda: tpch.f1(ddf["orders"]), check_f1, to_device),
            ("f1u", lambda: tpch.f1u(ddf["lineitem"]), check_rows("F1u"),
             collect),
            ("w2", lambda: tpch.w2(dbf["lineitem"]),
             check_device_columns("W2", exact_floats=True), to_device)]
        for name, df_fn, checker, result in slice7:
            for fns in counters.values():
                for fn in fns:
                    fn.launches = 0
            runs_of[name] = run_query(torch, sess, df_fn, checker,
                                      db_want[name], name, counters, result,
                                      require=SLICE7_REQUIRE[name])
            for k, v in launch_counts(counters).items():
                launches[k] = launches.get(k, 0) + v
            for fns in counters.values():
                for fn in fns:
                    if fn.launches:
                        per_wrapper[fn.__name__] = \
                            per_wrapper.get(fn.__name__, 0) + fn.launches
            paths.append((name, df_fn, checker, db_want[name], ()))
            if result is to_device:
                device_paths.add(name)
        # slice 8: the sample, explodes and subqueries, every kernel counted
        # from 0 before each
        slice8 = [
            ("q1_sample", lambda: tpch.q1_sample(dbf["lineitem"]),
             check_q1, collect),
            ("x1", lambda: tpch.x1(x1f), check_rows("X1"), collect),
            ("x1o", lambda: tpch.x1o(x1of),
             check_device_columns("X1o", exact_floats=True), to_device),
            ("q18_in", lambda: tpch.q18_in(dbf["orders"], dbf["lineitem"],
                                           dbf["customer"]),
             check_rows("Q18-in"), collect),
            ("q16_notin", lambda: tpch.q16_notin(
                dbf["partsupp"], dbf["supplier"], dbf["part"]),
             check_rows("Q16-notin"), collect),
            ("q22_scalar", lambda: tpch.q22_scalar(dbf["customer"],
                                                   dbf["orders"]),
             check_rows("Q22-scalar"), collect)]
        for name, df_fn, checker, result in slice8:
            for fns in counters.values():
                for fn in fns:
                    fn.launches = 0
            runs_of[name] = run_query(torch, sess, df_fn, checker,
                                      db_want[name], name, counters, result,
                                      require=SLICE8_REQUIRE[name])
            for k, v in launch_counts(counters).items():
                launches[k] = launches.get(k, 0) + v
            for fns in counters.values():
                for fn in fns:
                    if fn.launches:
                        per_wrapper[fn.__name__] = \
                            per_wrapper.get(fn.__name__, 0) + fn.launches
            paths.append((name, df_fn, checker, db_want[name], ()))
            if result is to_device:
                device_paths.add(name)
        # slice 9: the 22 queries over SF10 parquet written by the port's
        # gen_db, every kernel counted from 0 before each
        t1 = time.perf_counter()
        ppaths = tpch.gen_db(SF, PARQUET_DIR, data=full)
        mib = sum(os.path.getsize(p) for p in ppaths.values()) / 2**20
        print(f"gen_db SF{SF:g}: {mib:.0f} MiB of uncompressed parquet "
              f"written by the port in {time.perf_counter() - t1:.1f} s")
        psess = Session(PARQUET_SETTINGS, device="cuda")
        pdf = {t: psess.read_parquet(p) for t, p in ppaths.items()}
        special = {"q1": check_q1, "q3": check_q3, "q6": check_q6}
        filtered = []
        for q, tabs in tpch.SUITE_QUERIES.items():
            name = f"pq_{q}"
            for fns in counters.values():
                for fn in fns:
                    fn.launches = 0
            df_fn = (lambda tabs=tabs, q=q: getattr(tpch, q)(
                *(pdf[t] for t in tabs)))
            checker = special.get(q, check_rows(f"{q.upper()}-parquet"))
            reports = []
            runs_of[name] = run_query(
                torch, psess, df_fn, checker, pq_want[q], name, counters,
                collect, require=(),
                on_run=lambda i: reports.append(scan_report(psess)))
            scans = reports[0]
            print(f"query {name} cold scans (last collect): "
                  + json.dumps(scans))
            launched = runs_of[name][0]["kernel_launches"].get("key_stats", 0)
            check(launched or not scans["runtime_predicates"],
                  f"{name} pushed runtime filters without key_stats")
            if launched:
                filtered.append(q)
            for k, v in launch_counts(counters).items():
                launches[k] = launches.get(k, 0) + v
            for fns in counters.values():
                for fn in fns:
                    if fn.launches:
                        per_wrapper[fn.__name__] = \
                            per_wrapper.get(fn.__name__, 0) + fn.launches
            # profiled now, while the file cache still holds its scans
            profile_query(torch, df_fn, name)
        check(filtered, "no parquet query launched key_stats")
        print(f"runtime join filters (key_stats launched): {filtered}")
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
        for name, (ceiling, why) in list(SLICE5_FETCH_CEILINGS.items()) \
                + list(REST_FETCH_CEILINGS.items()) \
                + list(SLICE7_FETCH_CEILINGS.items()) \
                + list(SLICE8_FETCH_CEILINGS.items()) \
                + list(SLICE9_FETCH_CEILINGS.items()):
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

        del df, cdf, odf, dbf, sbf, q11f, ddf, dec, x1f, x1of, sess, shuf
        del pdf, psess
        table = time_kernels(torch, groupby, device, launches, worst)
        table += time_new_kernels(torch, join, groupby, topk_mod,
                                  batch_utils, device, launches, worst)
        table += time_slice3_kernels(torch, join, groupby, device, launches,
                                     worst)
        table += time_slice4_kernels(torch, hashing, join, groupby, device,
                                     launches, worst)
        table += time_slice5_kernels(torch, sort_ops, window, device,
                                     launches, worst, db["lineitem"])
        table += time_slice6_kernels(torch, join, device, per_wrapper,
                                     worst, db["lineitem"])
        table += time_slice7_kernels(torch, groupby, window, wd, device,
                                     per_wrapper, db)
        table += time_slice8_kernels(
            torch, sample_ops, generate, batch_utils, device, per_wrapper,
            db, numpy_column(x1_lists)[1], numpy_column(x1o_lists)[1])
        table += time_slice9_kernels(torch, rf, device, per_wrapper)
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
