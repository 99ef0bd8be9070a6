#!/usr/bin/env python3
"""Smoke test of spark_rapids_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``spark_rapids_tpu_torch/csrc``,
holds each against its plain PyTorch version on the card, then drives the
port's main path (TPC-H Q6 and Q1 through ``Session.create_dataframe`` →
``collect``) on seeded SF10 lineitem data (60,012,150 rows), checks the
results against numpy oracles and shows that each query went through its
kernel.  Prints per-query and per-kernel timings, a ``{"kernels": [...]}``
line, the card's name and power limit, and as its last line
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result,
when any phase fails or when no CUDA device is available.  Imports nothing
of JAX or of the JAX package.
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


def run_query(torch, sess, df_fn, checker, want, name, kernel_fn):
    """One cold and three warm runs; returns the per-run measurements and
    the kernel launches the runs made."""
    runs = []
    for i in range(4):
        before = kernel_fn.launches
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
        launches = kernel_fn.launches - before
        check(launches > 0, f"{name} run {i} launched {kernel_fn.__name__} "
              f"no time")
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
        from spark_rapids_tpu_torch.ops import groupby
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

        t0 = time.perf_counter()
        data = tpch.gen_lineitem_arrays(SF)
        n_rows = len(data["l_quantity"])
        check(n_rows == int(tpch.LINEITEM_ROWS_PER_SF * SF),
              f"SF{SF:g} lineitem has {n_rows} rows")
        print(f"datagen: {n_rows} rows in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        q6_want, q1_want = tpch.q6_numpy(data), tpch.q1_numpy(data)
        print(f"oracles: {time.perf_counter() - t0:.1f} s")
        sess = Session.get_or_create(device="cuda")
        info = sess.device_info()
        print(f"session device: {info.name}, "
              f"{info.memory_bytes / 2**30:.1f} GiB, power limit "
              f"{info.power_limit}")
        df = sess.create_dataframe(data)

        groupby.masked_reduce.launches = 0
        groupby.grid_agg.launches = 0
        q6_runs = run_query(torch, sess, lambda: tpch.q6(df), check_q6,
                            q6_want, "q6", groupby.masked_reduce)
        q1_runs = run_query(torch, sess, lambda: tpch.q1(df), check_q1,
                            q1_want, "q1", groupby.grid_agg)
        launches = {"masked_reduce": groupby.masked_reduce.launches,
                    "grid_agg": groupby.grid_agg.launches}
        check(all(launches.values()), f"a kernel of the main path was never "
              f"launched: {launches}")
        for name, runs in (("q6", q6_runs), ("q1", q1_runs)):
            warm = runs[1:]
            med = {k: statistics.median(r[k] for r in warm)
                   for k in ("wall_ms", "upload_ms", "device_ms")}
            print(f"query {name} warm median: wall {med['wall_ms']:.2f} ms, "
                  f"upload {med['upload_ms']:.2f} ms, device span "
                  f"{med['device_ms']:.2f} ms, syncs {warm[-1]['syncs']}, "
                  f"{warm[-1]['kernel_launches']} kernel launches per query")

        table = time_kernels(torch, groupby, device, launches, worst)
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
