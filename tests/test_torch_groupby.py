"""The port's reductions (plain PyTorch versions of its CUDA kernels) held
against the JAX package's ``ungrouped_reduce`` and ``grid_group_reduce`` on
identical seeded inputs.  int64 results and counts exact; float64 sums
within rel 1e-12 (the two sum in different orders); min/max identical,
NaN and the sign of zero included."""

import datetime
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spark_rapids_tpu  # noqa: F401  (enables jax x64)
from spark_rapids_tpu.ops import groupby as jg
from spark_rapids_tpu_torch.ops import groupby as tg

CPU = torch.device("cpu")
REL = 1e-12


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _ungrouped_case(n, seed, all_inactive=False):
    """(data, valid, op) numpy columns; data None is a count."""
    rng = np.random.default_rng(seed)
    zeros = rng.choice(np.array([-0.0, 0.0, 0.5, 2.0]), n)
    with_nan = rng.normal(size=n)
    with_nan[rng.integers(0, n)] = np.nan
    active = rng.random(n) < (0.0 if all_inactive else 0.6)
    cols = [
        (rng.normal(size=n) * 1e3, rng.random(n) < 0.9, "sum"),
        (rng.integers(-10**12, 10**12, n), None, "sum"),
        (None, rng.random(n) < 0.7, "sum"),
        (None, None, "sum"),
        (zeros, None, "min"),
        (-zeros, None, "max"),
        (with_nan, None, "max"),
        (rng.normal(size=n), rng.random(n) < 0.5, "min"),
        (rng.integers(-10**15, 10**15, n), rng.random(n) < 0.5, "min"),
        (rng.integers(-10**15, 10**15, n), None, "max"),
    ]
    return cols, active


def _reference_scalars(cols, active):
    """The JAX package's contract: counts are int64 indicator sums."""
    contribs = []
    for d, v, op in cols:
        if d is None:
            ind = np.ones(len(active), np.int64) if v is None \
                else v.astype(np.int64)
            contribs.append(((jnp.asarray(ind), None), op))
        else:
            contribs.append(((_j(d), _j(v)), op))
    return [np.asarray(x) for x, _ in jg.ungrouped_reduce(
        contribs, jnp.asarray(active))]


def _port_scalars(cols, active):
    specs = [(op, d is not None and d.dtype == np.float64)
             for d, _, op in cols]
    acc_f, acc_i = tg.init_scalars(specs, CPU)
    tg.ungrouped_reduce([((_t(d), _t(v)), op) for d, v, op in cols],
                        _t(active), acc_f, acc_i)
    return [(acc_f if f else acc_i)[j].item()
            for j, (_, f) in enumerate(specs)]


def _same(a, b, op):
    if isinstance(b, float) or np.issubdtype(np.asarray(a).dtype,
                                             np.floating):
        a, b = float(a), float(b)
        if np.isnan(a) or np.isnan(b):
            return np.isnan(a) and np.isnan(b)
        if op == "sum":
            return abs(a - b) <= REL * max(abs(a), 1.0)
        return a == b and np.signbit(a) == np.signbit(b)
    return int(a) == int(b)


@pytest.mark.parametrize("n,seed,all_inactive", [
    (1, 1, False), (1000, 2, False), (5003, 3, False), (1000, 4, True)])
def test_ungrouped_reduce_matches_reference(n, seed, all_inactive):
    cols, active = _ungrouped_case(n, seed, all_inactive)
    want = _reference_scalars(cols, active)
    got = _port_scalars(cols, active)
    # with no live row, min/max give the op's identity in both packages
    for j, ((_, _, op), a, b) in enumerate(zip(cols, want, got)):
        assert _same(a, b, op), (j, op, a, b)


def test_ungrouped_reduce_accumulates_across_batches():
    cols, active = _ungrouped_case(4000, 9)
    specs = [(op, d is not None and d.dtype == np.float64)
             for d, _, op in cols]
    acc_f, acc_i = tg.init_scalars(specs, CPU)
    for lo in range(0, 4000, 1500):
        sl = slice(lo, lo + 1500)
        tg.ungrouped_reduce(
            [((_t(None if d is None else d[sl]),
               _t(None if v is None else v[sl])), op) for d, v, op in cols],
            _t(active[sl]), acc_f, acc_i)
    whole = _port_scalars(cols, active)
    for j, (_, f) in enumerate(specs):
        got = (acc_f if f else acc_i)[j].item()
        assert _same(got, whole[j], cols[j][2]), (j, got, whole[j])


def _at_offset(a, offset):
    """``a`` as a torch view ``offset`` elements into a larger tensor (a
    data_ptr off the 16-byte alignment the kernel's wide loads want)."""
    if a is None:
        return None
    t = torch.from_numpy(np.ascontiguousarray(a))
    y = torch.zeros(t.shape[0] + offset, dtype=t.dtype)
    y[offset:] = t
    return y[offset:]


def _edge_batches(shape):
    """The batches of one of masked_reduce.cu's risky shapes, each as
    (cols, active)."""
    if shape in ("n15", "n16", "n17"):
        return [_ungrouped_case(int(shape[1:]), 40)]
    cols, active = _ungrouped_case(4000, 41)
    if shape == "one_word":  # every live row in rows 32..47
        return [(cols, np.arange(4000) // 16 == 2)]
    if shape == "empty_between":
        empty = [(None if d is None else d[:0], None if v is None else v[:0],
                  op) for d, v, op in cols]
        return [_ungrouped_case(3001, 42), (empty, active[:0]),
                (cols, active)]
    dead, _ = _ungrouped_case(1000, 43, all_inactive=True)
    return [(dead, np.zeros(1000, bool)), (cols, active)]  # all_dead


@pytest.mark.parametrize("shape", ["n15", "n16", "n17", "one_word",
                                   "empty_between", "all_dead"])
@pytest.mark.parametrize("offset", [0, 3])
def test_ungrouped_reduce_edge_batches_match_reference(shape, offset):
    """The shapes the kernel handles apart (a partial 16-row unit, a live
    word, an empty and an all-dead batch, every tensor a view at an odd
    storage offset), batch by batch into one accumulator, against the
    reference over the batches' rows together."""
    batches = _edge_batches(shape)
    cols = [(None if d is None else np.concatenate([b[0][j][0]
                                                   for b in batches]),
             None if v is None else np.concatenate([b[0][j][1]
                                                   for b in batches]), op)
            for j, (d, v, op) in enumerate(batches[-1][0])]
    active = np.concatenate([a for _, a in batches])
    want = _reference_scalars(cols, active)
    specs = [(op, d is not None and d.dtype == np.float64)
             for d, _, op in cols]
    acc_f, acc_i = tg.init_scalars(specs, CPU)
    for bcols, bactive in batches:
        tg.ungrouped_reduce(
            [((_at_offset(d, offset + 1), _at_offset(v, offset + 2)), op)
             for d, v, op in bcols], _at_offset(bactive, offset), acc_f,
            acc_i)
    for j, ((_, _, op), (_, f)) in enumerate(zip(cols, specs)):
        got = (acc_f if f else acc_i)[j].item()
        assert _same(want[j], got, op), (j, op, want[j], got)


def _grid_case(n, dims, seed, all_inactive=False):
    rng = np.random.default_rng(seed)
    keys = [(rng.integers(0, d, n).astype(np.int32), rng.random(n) < 0.85)
            for d in dims]
    contribs = [
        ((rng.normal(size=n) * 100, rng.random(n) < 0.8), "sum"),
        ((rng.uniform(1, 1e5, n), None), "sum"),
        ((rng.integers(-10**12, 10**12, n), None), "sum"),
        ((None, rng.random(n) < 0.6), "sum"),   # masked count
        ((None, None), "sum"),                  # count of live rows
    ]
    active = rng.random(n) < (0.0 if all_inactive else 0.7)
    return keys, contribs, active


def _reference_grid(keys, dims, contribs, active):
    jc = []
    for (d, v), op in contribs:
        if d is None:
            d = np.ones(len(active), np.int64) if v is None \
                else v.astype(np.int64)
            v = None
        jc.append(((_j(d), _j(v)), op))
    ok, ov, n_groups, _ = jg.grid_group_reduce(
        [(_j(c), _j(v)) for c, v in keys], list(dims), jc,
        jnp.asarray(active))
    g = int(n_groups)
    return ([(np.asarray(c)[:g], np.asarray(v)[:g]) for c, v in ok],
            [np.asarray(d)[:g] for d, _ in ov])


def _kinds(contribs):
    """The accumulator layout of numpy contributions: an unmasked count is
    the presence count."""
    return ["cnt" if d is None and v is None
            else "f" if d is not None and d.dtype == np.float64 else "i"
            for (d, v), _ in contribs]


def _port_grid(keys, dims, contribs, active):
    tc = [((_t(d), _t(v)), op) for (d, v), op in contribs]
    acc = tg.GridAccumulator(dims, _kinds(contribs), CPU)
    tg.grid_group_reduce([(_t(c), _t(v)) for c, v in keys], dims, tc,
                         _t(active), acc)
    return acc


def _port_groups(acc):
    obs = (acc.cnt > 0).numpy()
    keys = [(c.numpy()[obs], v.numpy()[obs]) for c, v in acc.slot_codes()]
    return keys, [v.numpy()[obs] for v in acc.values()]


@pytest.mark.parametrize("dims", [(4, 2), (63, 63)],
                         ids=["G15", "G4096"])
@pytest.mark.parametrize("n,all_inactive", [(1, False), (3001, False),
                                            (3001, True)])
def test_grid_group_reduce_matches_reference(dims, n, all_inactive):
    keys, contribs, active = _grid_case(n, dims, n + dims[0], all_inactive)
    want_keys, want_vals = _reference_grid(keys, dims, contribs, active)
    got_keys, got_vals = _port_groups(_port_grid(keys, dims, contribs,
                                                 active))
    for (wc, wv), (gc, gv) in zip(want_keys, got_keys):
        np.testing.assert_array_equal(gv, wv)
        np.testing.assert_array_equal(gc[gv], wc[wv])
    for w, g in zip(want_vals, got_vals):
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=REL, atol=0)
        else:
            np.testing.assert_array_equal(g, w)


def test_grid_uses_shared_memory_for_small_grids_only():
    assert tg.grid_uses_shared(tg.grid_size((4, 2)), 7, 0)
    assert not tg.grid_uses_shared(tg.grid_size((63, 63)), 2, 2)


def test_regrid_keeps_groups_when_dictionaries_grow():
    """A batch with dims (2, 1) then one with dims (4, 2) equals both
    batches reduced at (4, 2) directly; NULL keys move to the new extra
    slot."""
    k1, c1, a1 = _grid_case(800, (2, 1), 11)
    k2, c2, a2 = _grid_case(900, (4, 2), 12)
    tc1 = [((_t(d), _t(v)), op) for (d, v), op in c1]
    tc2 = [((_t(d), _t(v)), op) for (d, v), op in c2]
    acc = tg.GridAccumulator((2, 1), _kinds(c1), CPU)
    tg.grid_group_reduce([(_t(c), _t(v)) for c, v in k1], (2, 1), tc1,
                         _t(a1), acc)
    acc.regrid((4, 2))
    tg.grid_group_reduce([(_t(c), _t(v)) for c, v in k2], (4, 2), tc2,
                         _t(a2), acc)
    cat = lambda x, y: None if x is None else np.concatenate([x, y])  # noqa
    keys = [(cat(ca, cb), cat(va, vb)) for (ca, va), (cb, vb)
            in zip(k1, k2)]
    contribs = [((cat(d1, d2), cat(v1, v2)), op) for ((d1, v1), op),
                ((d2, v2), _) in zip(c1, c2)]
    whole = _port_grid(keys, (4, 2), contribs, np.concatenate([a1, a2]))
    np.testing.assert_array_equal(acc.cnt.numpy(), whole.cnt.numpy())
    for a, b in zip(acc.values(), whole.values()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=REL, atol=0)


def test_grid_layout_follows_the_aggregates_nullability():
    """Counts of a non-nullable child fold into the presence count; counts
    of a nullable one, and every sum, get a column of their own."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.aggfns import Average, Count, CountStar, Sum
    from spark_rapids_tpu_torch.exprs import BoundReference
    from spark_rapids_tpu_torch.plan.physical import AggregateExec

    key = BoundReference(0, T.STRING, False, "k")
    dense = BoundReference(1, T.FLOAT64, False, "x")
    nullable = BoundReference(2, T.INT64, True, "y")
    agg = AggregateExec(None, [("k", key)], [
        ("s", Sum(dense)), ("a", Average(nullable)), ("c", Count(nullable)),
        ("n", CountStar())])
    assert agg._grid_layout() == ["f", "cnt", "f", "i", "i", "cnt"]
    acc = tg.GridAccumulator((4,), agg._grid_layout(), CPU)
    assert acc.f.shape == (5, 2) and acc.i.shape == (5, 2)


def test_presence_count_channel_refuses_a_mask():
    n = 50
    keys = [(_t(np.arange(n, dtype=np.int32) % 3), None)]
    active = _t(np.ones(n, dtype=bool))
    acc = tg.GridAccumulator((4,), ["cnt"], CPU)
    tg.grid_group_reduce(keys, (4,), [((None, None), "sum")], active, acc)
    np.testing.assert_array_equal(acc.values()[0].numpy(),
                                  np.bincount(np.arange(n) % 3, minlength=5))
    mask = _t(np.arange(n) % 2 == 0)
    with pytest.raises(ValueError, match="presence count"):
        tg.grid_group_reduce(keys, (4,), [((None, mask), "sum")], active,
                             acc)


# ---------------------------------------------------------------------------------
# Dense direct-address aggregation (csrc/dense_agg.cu's plain versions),
# Session-level against the JAX package's dense paths
# ---------------------------------------------------------------------------------

import spark_rapids_tpu as jsrt  # noqa: E402
from spark_rapids_tpu.sql import functions as JF  # noqa: E402
import spark_rapids_tpu_torch as tsrt  # noqa: E402
from spark_rapids_tpu_torch.sql import functions as TF  # noqa: E402

DENSE_SETTINGS = {"spark.rapids.tpu.sql.batchSizeRows": 1000}


def _sessions(settings=DENSE_SETTINGS):
    return jsrt.Session(settings), tsrt.Session(settings, device="cpu")


def _row_key(row):
    return tuple((x is None, x if x is not None else 0) for x in row)


def _assert_same_groups(got, want):
    """Rows in any order; ints, dates and None exact, floats within REL."""
    got, want = sorted(got, key=_row_key), sorted(want, key=_row_key)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            if isinstance(b, float) and a is not None:
                assert abs(a - b) <= REL * max(abs(b), 1.0), (g, w)
            else:
                assert a == b, (g, w)


def _run_both(query, data, settings=DENSE_SETTINGS):
    jsess, tsess = _sessions(settings)
    want = query(JF, jsess.create_dataframe(data)).collect()
    got = query(TF, tsess.create_dataframe(data)).collect()
    return got, want, tsess


def _dense_data(n=5000, seed=21):
    rng = np.random.default_rng(seed)
    key = rng.integers(100, 900, n).astype(object)
    key[rng.random(n) < 0.03] = None
    x = rng.normal(size=n).astype(object)
    x[rng.random(n) < 0.1] = None
    return {"k": key, "x": x,
            "q": rng.integers(-10**6, 10**6, n).astype(np.int64),
            "f": rng.random(n) < 0.8}


def _agg_query(F, df):
    return (df.where(F.col("f"))
              .group_by("k")
              .agg(F.sum(F.col("x")).alias("sx"), F.sum(F.col("q")).alias("sq"),
                   F.min(F.col("q")).alias("lo"), F.max(F.col("q")).alias("hi"),
                   F.count(F.col("x")).alias("cx"), F.avg(F.col("q")).alias("aq"),
                   F.count_star().alias("n")))


def test_dense_single_key_aggregate_matches_reference():
    """One integral key with nulls, a selection mask, every dense buffer
    op, 5 batches: the single-key dense path (reference ``_try_dense_
    grouped`` :1084) through the same kernel with no residual channels."""
    got, want, tsess = _run_both(_agg_query, _dense_data())
    assert any(r[0] is None for r in got)
    _assert_same_groups(got, want)
    metrics = tsess.last_exec_context().metrics
    assert any(m.values.get("aggDensePath") for m in metrics.values())


def test_dense_multi_key_aggregate_matches_reference():
    """A primary key with residual keys that depend on it (a date, a
    nullable int, a string and a boolean), as TPC-H Q3 groups (l_orderkey,
    o_orderdate, o_shippriority); the narrower residuals must not become
    the primary."""
    rng = np.random.default_rng(22)
    n, groups = 6000, 700
    gid = rng.integers(0, groups, n)
    day = (np.datetime64("1994-01-01")
           + rng.integers(0, 900, groups).astype("timedelta64[D]"))[gid]
    prio = rng.integers(0, 3, groups).astype(object)
    prio[rng.random(groups) < 0.2] = None
    name = np.array([f"n{g % 40}" for g in range(groups)])
    data = {"k": (gid * 7 + 11).astype(np.int64), "day": day,
            "prio": prio[gid], "name": name[gid], "flag": gid % 3 == 0,
            "x": rng.uniform(0, 100, n)}

    def q(F, df):
        return (df.group_by("k", "day", "prio", "name", "flag")
                  .agg(F.sum(F.col("x")).alias("s"),
                       F.count_star().alias("n")))

    got, want, _ = _run_both(q, data)
    _assert_same_groups(got, want)


def test_dense_keys_outside_the_first_batch_widen_the_domain():
    """Later batches carry keys below and above the first batch's padded
    domain: they wait in the overflow buffer and the domain widens once at
    the tail."""
    rng = np.random.default_rng(23)
    first = rng.integers(50_000, 50_100, 1000)
    later = rng.integers(0, 120_000, 4000)
    key = np.concatenate([first, later]).astype(np.int64)
    data = {"k": key, "x": rng.normal(size=len(key)),
            "day": np.datetime64("1995-01-01")
            + (key % 97).astype("timedelta64[D]")}

    def q(F, df):
        return df.group_by("k", "day").agg(F.sum(F.col("x")).alias("s"),
                                            F.count_star().alias("n"))

    got, want, tsess = _run_both(q, data)
    _assert_same_groups(got, want)
    metrics = tsess.last_exec_context().metrics
    assert any(m.values.get("aggDenseWidened") for m in metrics.values())
    assert tsess.last_query_stats().blocking_fetches == 4


def test_dense_residual_violation_raises():
    """A residual that takes two values under one primary key no longer
    raises: the first batch's probe rejects it as the primary's dependent
    when it shows there, the violation check when only a later batch shows
    it, and either way every batch replays into the hash aggregation,
    whose groups equal the reference's (its sort path)."""
    n = 3000
    k = np.arange(n, dtype=np.int64) % 500
    ok = {"k": k, "r": k * 2, "x": np.ones(n)}
    late = dict(ok, r=np.where(np.arange(n) < 2000, k * 2, k * 2 + 1))
    early = dict(ok, r=np.arange(n, dtype=np.int64) % 7)

    def q(F, df):
        return df.group_by("k", "r").agg(F.sum(F.col("x")).alias("s"),
                                         F.count_star().alias("n"))

    for data, groups, path in ((ok, 500, "aggDensePath"),
                               (late, 1000, "aggHashPath"),
                               (early, 3000, "aggHashPath")):
        got, want, tsess = _run_both(q, data)
        _assert_same_groups(got, want)
        assert len(got) == groups
        metrics = tsess.last_exec_context().metrics
        assert any(m.values.get(path) for m in metrics.values())


def test_dense_overflow_buffer_fills_and_overflows():
    """The plain update appends out-of-domain rows to the buffer; a full
    buffer keeps counting, which the aggregate turns into a raise."""
    acc = tg.DenseAccumulator(10, 4, 1, [("sum", True), ("count", False)],
                              CPU, cap=3)
    key = torch.tensor([10, 2, 13, 99, 5], dtype=torch.int64)
    res = torch.tensor([1, 2, 3, 4, 5], dtype=torch.int32)
    x = torch.tensor([1.0, 2.0, 3.0, 4.0, 5.0], dtype=torch.float64)
    acc.update((key, None), [(res, None)], [(x, None), (None, None)], None)
    viol, groups, n_over, lo, hi = acc.tail().tolist()
    assert (viol, groups, n_over, lo, hi) == (0, 2, 3, 2, 99)
    assert acc.okey[:3].tolist() == [2, 99, 5]
    acc.widen(2, 128)
    acc.replay_overflow(n_over)
    assert acc.check().tolist() == [0, 5]
    keys, valid = acc.slot_keys()
    live = acc.present.bool()
    assert keys[live].tolist() == [2, 5, 10, 13, 99]
    assert acc.acc[0][live].tolist() == [2.0, 5.0, 1.0, 3.0, 4.0]
    acc.update((torch.tensor([500, 600, 700, 800]), None),
               [(torch.zeros(4, dtype=torch.int32), None)],
               [(torch.ones(4, dtype=torch.float64), None), (None, None)],
               None)
    assert acc.tail().tolist()[2] == 4  # over the buffer's 3 rows
    with pytest.raises(ValueError, match="exceed"):
        acc.replay_overflow(4)


def test_dense_stats_probe_matches_the_reference_candidates():
    """The exact dependence probe flags a candidate exactly when the
    reference's sampled distinct counts reject it: with a primary,
    a dependent date and a constant, only the primary passes."""
    n = 4000
    rng = np.random.default_rng(24)
    k = rng.integers(0, 800, n).astype(np.int64)
    day = (k % 300).astype(np.int32)
    zero = np.zeros(n, dtype=np.int64)
    keys = [(_t(k), None), (_t(day), None), (_t(zero), None)]
    stats, fd = tg.dense_key_stats(keys, [True, True, True], None)
    assert fd.tolist() == [0, 1, 1]
    assert stats[0].tolist() == [int(k.min()), int(k.max()), n]
    assert stats[2].tolist() == [0, 0, n]
    # dependence holds both ways for a one-to-one residual
    keys[1] = (_t((k * 3 % 1000).astype(np.int32)), None)
    assert tg.dense_key_stats(keys, [True, True, False],
                              None)[1].tolist() == [0, 0, 0]


def test_dense_kernel_wrappers_refuse_cpu_tensors():
    keys = [(torch.zeros(4, dtype=torch.int64), None)]
    with pytest.raises(ValueError, match="CUDA"):
        tg.dense_agg_stats(keys, [True], None)
    acc = tg.DenseAccumulator(0, 4, 0, [("sum", False)], CPU, cap=2)
    with pytest.raises(ValueError, match="CUDA"):
        tg.dense_agg_update(acc, keys[0], [],
                            [(torch.zeros(4, dtype=torch.int64), None)], None)
    assert tg.dense_agg_stats.launches == tg.dense_agg_update.launches == 0


# ---------------------------------------------------------------------------------
# Hash aggregation (csrc/hash_agg.cu's plain version) against the JAX
# package's sort-based group_reduce, and at the Session level
# ---------------------------------------------------------------------------------

def _hash_case(n, seed):
    """Keys of every kind the hash path takes — int64, date (int32 days),
    bool, dictionary codes (int32) and float64 with -0.0/+0.0 and NaN —
    each with nulls; contributions with nulls and NaN values."""
    rng = np.random.default_rng(seed)
    fkey = rng.choice(np.array([-0.0, 0.0, 1.5, np.nan, -2.0, np.inf]), n)
    keys = [(rng.integers(-3, 3, n).astype(np.int64), rng.random(n) < 0.9),
            (rng.integers(9000, 9004, n).astype(np.int32), None),
            (rng.random(n) < 0.5, rng.random(n) < 0.95),
            (rng.integers(0, 5, n).astype(np.int32), rng.random(n) < 0.9),
            (fkey, rng.random(n) < 0.9)]
    xs = rng.normal(size=n)
    xs[rng.random(n) < 0.01] = np.nan
    zeros = rng.choice(np.array([-0.0, 0.0, 2.5, -1.0]), n)
    contribs = [(xs, rng.random(n) < 0.9, "sum", True),
                (rng.integers(-10**12, 10**12, n), None, "sum", False),
                (zeros, rng.random(n) < 0.9, "min", True),
                (zeros, None, "max", True),
                (xs, None, "max", True),
                (rng.integers(-10**15, 10**15, n), rng.random(n) < 0.8,
                 "min", False),
                (rng.integers(-10**15, 10**15, n), None, "max", False),
                (None, rng.random(n) < 0.7, "count", False)]
    return keys, contribs, rng.random(n) < 0.8


def _group_key(row_keys):
    """A hashable group identity: None for null, floats with -0.0 as 0.0
    and every NaN as one value."""
    out = []
    for v in row_keys:
        if v is None:
            out.append(None)
        elif isinstance(v, float) and np.isnan(v):
            out.append("nan")
        elif isinstance(v, float):
            out.append(v + 0.0)
        elif isinstance(v, (str, datetime.date)):
            out.append(v)
        else:
            out.append(int(v))
    return tuple(out)


def _reference_hash_groups(keys, contribs, active):
    jkeys = [(_j(d), _j(v)) for d, v in keys]
    jcon = []
    for d, v, op, _ in contribs:
        if op == "count":
            ind = np.ones(len(active), np.int64) if v is None \
                else v.astype(np.int64)
            jcon.append(((jnp.asarray(ind), None), "sum"))
        else:
            jcon.append(((_j(d), _j(v)), op))
    out_keys, out_vals, n_groups, _ = jg.group_reduce(jkeys, jcon,
                                                      jnp.asarray(active))
    g = int(n_groups)
    keys = [(np.asarray(d)[:g].tolist(),
             [True] * g if v is None else np.asarray(v)[:g].tolist())
            for d, v in out_keys]
    vals = [np.asarray(d)[:g].tolist() for d, _ in out_vals]
    return {_group_key([x if ok else None for x, ok in
                        ((d[i], v[i]) for d, v in keys)]):
            [c[i] for c in vals] for i in range(g)}


def _port_hash_groups(keys, contribs, active, batch):
    acc = tg.HashAccumulator(len(keys), [(op, f) for _, _, op, f in
                                         contribs], CPU)
    n = len(active)
    for lo in range(0, n, batch):
        sl = slice(lo, lo + batch)
        words = [(tg.key_word(_t(d[sl])), _t(None if v is None else v[sl]))
                 for d, v in keys]
        acc.update(words, [(_t(None if d is None else d[sl]),
                            _t(None if v is None else v[sl]))
                           for d, v, _, _ in contribs],
                   _t(active[sl]), len(active[sl]))
    kv, values, live = acc.finish()
    assert live is None
    dtypes = [torch.from_numpy(np.asarray(d[:1])).dtype for d, _ in keys]
    cols = [(tg.key_from_word(w, dt).tolist(), ok.tolist())
            for (w, ok), dt in zip(kv, dtypes)]
    vals = [v.tolist() for v in values]
    rows = {_group_key([x if ok else None for x, ok in
                        ((d[i], v[i]) for d, v in cols)]):
            [c[i] for c in vals] for i in range(kv[0][0].shape[0])}
    return rows, acc


@pytest.mark.parametrize("n,seed,batch", [(1, 31, 1), (4000, 32, 4000),
                                          (6000, 33, 700)])
def test_hash_aggregate_matches_group_reduce(n, seed, batch):
    """Every key kind and null, -0.0/+0.0 as one group and NaN keys as one
    group, sum/count/min/max with NaN values, in one batch and in many
    (the plain version keeps the same growth decisions as the kernel)."""
    keys, contribs, active = _hash_case(n, seed)
    want = _reference_hash_groups(keys, contribs, active)
    got, _ = _port_hash_groups(keys, contribs, active, batch)
    assert got.keys() == want.keys()
    for k, vals in want.items():
        for a, b, (_, _, op, _) in zip(got[k], vals, contribs):
            assert _same(a, b, "sum" if op in ("sum", "count") else op), \
                (k, op, a, b)


def test_hash_table_grows_with_exact_counts():
    """The host's bound on the groups (rows so far) passes the load limit
    after a few batches: one fetch reads the exact count, and the table
    grows only when that count needs it; the key domain's bound (a
    boolean and a dictionary) keeps a small table from growing at all."""
    from spark_rapids_tpu_torch.utils.metrics import QueryStats
    rng = np.random.default_rng(34)
    acc = tg.HashAccumulator(1, [("count", False)], CPU)
    with QueryStats.scoped() as st:
        for _ in range(6):
            k = _t(rng.integers(0, 10**9, 1000).astype(np.int64))
            acc.update([(k, None)], [(None, None)], None, 1000)
    assert acc.cap == 16384 and acc.growths == 1 and st.blocking_fetches == 1
    small = tg.HashAccumulator(2, [("count", False)], CPU, key_bound=3 * 8)
    with QueryStats.scoped() as st:
        for _ in range(50):
            w = [(_t(rng.integers(0, 2, 1000).astype(np.int64)), None),
                 (_t(rng.integers(0, 7, 1000).astype(np.int64)), None)]
            small.update(w, [(None, None)], None, 1000)
    assert small.cap == tg.HA_MIN_SLOTS and st.blocking_fetches == 0
    assert small.finish()[1][0].sum().item() == 50_000


def _hash_data(n=5000, seed=35):
    rng = np.random.default_rng(seed)
    name = np.array([f"s{x}" for x in rng.integers(0, 300, n)], dtype=object)
    name[rng.random(n) < 0.05] = None
    fk = rng.choice(np.array([-0.0, 0.0, 0.25, np.nan, 7.0]), n).astype(
        object)
    fk[rng.random(n) < 0.05] = None
    x = rng.normal(size=n)
    x[rng.random(n) < 0.01] = np.nan
    return {"name": name, "fk": fk, "b": rng.random(n) < 0.5,
            "day": np.datetime64("1995-01-01")
            + rng.integers(0, 4, n).astype("timedelta64[D]"),
            "i": rng.integers(-5, 5, n).astype(np.int64), "x": x,
            "z": rng.choice(np.array([-0.0, 0.0, 1.0]), n)}


@pytest.mark.parametrize("keys", [("name",), ("fk",), ("b", "day"),
                                  ("name", "i"), ("fk", "b", "name")])
def test_hash_path_matches_reference(keys):
    """Groupings no dense path and no grid takes (string keys past
    gridMaxGroups, floating keys, boolean and date keys) with every
    aggregate and float64 min/max over NaN and signed zeros: the port's
    hash path against the reference's sort path, through both Sessions."""
    settings = dict(DENSE_SETTINGS, **{
        "spark.rapids.tpu.sql.agg.gridMaxGroups": 64})

    def q(F, df):
        return (df.where(F.col("i") > -4).group_by(*keys)
                  .agg(F.sum(F.col("x")).alias("sx"),
                       F.min(F.col("z")).alias("lo"),
                       F.max(F.col("x")).alias("hi"),
                       F.max(F.col("i")).alias("mi"),
                       F.count(F.col("x")).alias("cx"),
                       F.count_star().alias("n")))

    got, want, tsess = _run_both(q, _hash_data(), settings)
    got = sorted(got, key=lambda r: _group_key(r[:len(keys)]).__repr__())
    want = sorted(want, key=lambda r: _group_key(r[:len(keys)]).__repr__())
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert _group_key(g[:len(keys)]) == _group_key(w[:len(keys)])
        for a, b, op in zip(g[len(keys):], w[len(keys):],
                            ("sum", "min", "max", "max", "sum", "sum")):
            assert (a is None) == (b is None), (g, w)
            if a is not None:
                assert _same(a, b, op), (g, w)
    metrics = tsess.last_exec_context().metrics
    assert any(m.values.get("aggHashPath") for m in metrics.values())


def test_hash_kernel_wrappers_refuse_cpu_tensors():
    acc = tg.HashAccumulator(1, [("count", False)], CPU)
    acc._reserve(4)
    with pytest.raises(ValueError, match="CUDA"):
        tg.hash_agg_update(acc, [(torch.zeros(4, dtype=torch.int64), None)],
                           [(None, None)], None, 4)
    assert tg.hash_agg_update.launches == tg.hash_agg_fold.launches == 0


@pytest.mark.parametrize("cols", [("name",), ("fk",), ("name", "i"),
                                  ("fk", "b", "day")])
def test_distinct_matches_reference(cols):
    """DISTINCT groups on every column: string columns on the grid, the
    rest on the dense path or the hash aggregate; -0.0/+0.0 and NaN are
    one value each, null is a value."""
    def q(F, df):
        return df.select(*cols).distinct()

    got, want, _ = _run_both(q, _hash_data())
    assert len(got) == len(want)
    assert sorted(map(_group_key, got), key=repr) == sorted(
        map(_group_key, want), key=repr)


# ---------------------------------------------------------------------------------
# Float residual keys on the dense path (TPC-H Q10's c_acctbal)
# ---------------------------------------------------------------------------------

def _nan_marked(rows):
    """NaN as a float no row holds, so the rows sort and compare."""
    return [tuple(1e300 if isinstance(x, float) and x != x else x
                  for x in r) for r in rows]


@pytest.mark.parametrize("case", ["equal", "signed_zero", "nan",
                                  "null_group", "null_mixed", "float32"])
def test_dense_float_residuals_match_reference(case):
    """A primary key with a string and a float residual, as Q10 groups
    (c_custkey, c_name, c_acctbal): equal values per key stay on the dense
    path (-0.0 and +0.0 are one value, and the residual keeps the
    reference's -0.0); a NaN residual, or a key whose residual is null in
    some rows only, replays every batch into the hash aggregation; a key
    whose residual is null in every row keeps a null residual."""
    rng = np.random.default_rng(31)
    n, groups = 5000, 600
    gid = rng.integers(0, groups, n)
    bal = np.round(rng.uniform(-999.99, 9999.99, groups), 2)
    bal[:6] = [0.0, -0.0, 0.0, -0.0, 5.5, -5.5]
    res = bal[gid].astype(object)
    if case == "signed_zero":  # keys 0 and 1 see both zeros
        res[gid == 0] = rng.choice(np.array([0.0, -0.0]), (gid == 0).sum())
        res[gid == 1] = rng.choice(np.array([0.0, -0.0]), (gid == 1).sum())
    if case == "nan":
        res[np.flatnonzero(gid == 7)[:1]] = np.nan
    if case == "null_group":
        res[gid == 9] = None
    if case == "null_mixed":
        res[np.flatnonzero(gid == 9)[:1]] = None
    if case == "float32":
        res = np.array([np.float32(x) for x in res])
    data = {"k": (gid * 3 + 5).astype(np.int64),
            "name": np.array([f"Customer#{g:09d}" for g in gid]),
            "bal": res, "x": rng.uniform(0, 100, n)}

    def q(F, df):
        return (df.group_by("k", "name", "bal")
                  .agg(F.sum(F.col("x")).alias("s"),
                       F.count_star().alias("n")))

    got, want, tsess = _run_both(q, data)
    _assert_same_groups(_nan_marked(got), _nan_marked(want))
    path = "aggHashPath" if case in ("nan", "null_mixed") else "aggDensePath"
    metrics = tsess.last_exec_context().metrics
    assert any(m.values.get(path) for m in metrics.values()), path
    if path == "aggDensePath":
        sign = {r[0]: np.signbit(r[2]) for r in want if r[2] is not None}
        assert all(np.signbit(r[2]) == sign[r[0]] for r in got
                   if r[2] is not None)


def test_dense_float_residual_plain_channels():
    """The plain update keeps a float64 residual as images: -0.0 and +0.0
    are one value whose residual decodes to -0.0, two values are a
    violation, and a NaN is one too."""
    def run(values):
        acc = tg.DenseAccumulator(0, 2, 1, [("count", False)],
                                  torch.device("cpu"), res_f64=[True])
        keys = torch.zeros(len(values), dtype=torch.int64)
        acc.update((keys, None),
                   [(torch.tensor(values, dtype=torch.float64), None)],
                   [(None, None)], None)
        return acc.check().tolist(), acc.residual(0)[0][0].item()

    (viol, groups), v = run([0.0, -0.0, 0.0])
    assert (viol, groups) == (0, 1) and v == 0.0 and np.signbit(v)
    assert run([2.5, 2.5])[0][0] == 0 and run([2.5, 2.5])[1] == 2.5
    assert run([2.5, 3.0])[0][0] == 1
    assert run([2.5, float("nan")])[0][0] == 1
    assert run([float("nan")])[0][0] == 1


# ---------------------------------------------------------------------------------
# The dense records (one per slot: claimed residual words and state bits)
# against the JAX package's min/max residual channels
# ---------------------------------------------------------------------------------

_I64 = np.iinfo(np.int64)


def _layout_case(case):
    """(data, the path the port must take): a primary key over 300 groups,
    a residual ``r`` and a float sum, 5 batches."""
    rng = np.random.default_rng(41)
    n, groups = 5000, 300
    gid = rng.integers(0, groups, n)
    if case == "widen_replay":  # later batches reach past the first's span
        gid = np.concatenate([rng.integers(140, 160, 1000),
                              rng.integers(0, groups, n - 1000)])
    per = (gid * 5 - 700).astype(np.int64)
    per[gid % 3 == 0] = _I64.min
    per[gid % 3 == 1] = _I64.max
    r = per.astype(object)
    path = "aggDensePath"
    if case in ("signed_zero", "nan"):
        r = np.round(gid * 0.5 - 40.0, 1)
        zero = np.flatnonzero(gid == 80)  # one key sees both zeros
        r[zero] = rng.choice(np.array([0.0, -0.0]), len(zero))
        r[zero[:2]] = [0.0, -0.0]
        if case == "nan":
            r[np.flatnonzero(gid == 9)[:1]] = np.nan
            path = "aggHashPath"
    if case == "null_mixed":
        r[np.flatnonzero(gid == 12)[:1]] = None
        path = "aggHashPath"
    if case == "two_values":  # INT64_MIN beside another value of one key
        r[np.flatnonzero(gid == 30)[:1]] = 7
        path = "aggHashPath"
    return {"k": (gid * 11 + 3).astype(np.int64), "r": r,
            "x": rng.uniform(-50, 50, n)}, path


@pytest.mark.parametrize("case", ["int64_extremes", "signed_zero", "nan",
                                  "null_mixed", "two_values",
                                  "widen_replay"])
def test_dense_records_match_reference(case):
    """The plain dense update over the record layout, Session against
    Session: int64 residuals at INT64_MIN (the unclaimed word's pattern)
    and INT64_MAX stay on the dense path with their values; -0.0 and +0.0
    under one key are one value that decodes to -0.0; a NaN, a null beside
    valid rows and two values under one key each send the query to the
    hash aggregation; a domain widened at the tail replays its overflow
    rows into the same records."""
    data, path = _layout_case(case)

    def q(F, df):
        return df.group_by("k", "r").agg(F.sum(F.col("x")).alias("s"),
                                          F.count_star().alias("n"))

    got, want, tsess = _run_both(q, data)
    _assert_same_groups(_nan_marked(got), _nan_marked(want))
    metrics = tsess.last_exec_context().metrics
    assert any(m.values.get(path) for m in metrics.values()), path
    if case == "widen_replay":
        assert any(m.values.get("aggDenseWidened") for m in metrics.values())
    if case == "signed_zero":
        zero = [r for r in got if r[0] == 80 * 11 + 3]
        assert len(zero) == 1 and np.signbit(zero[0][1])


def test_dense_records_decode_claimed_words():
    """The plain update's records directly: a claimed word decodes to its
    value whatever its bits, INT64_MIN rows set SEEN_EMPTY instead of
    claiming, a residual that is null in every row stays null, and
    SEEN_EMPTY beside a claimed word is a violation."""
    acc = tg.DenseAccumulator(0, 4, 2, [("count", False)], CPU)
    key = torch.tensor([0, 0, 1, 1, 2, 3], dtype=torch.int64)
    r0 = torch.tensor([_I64.min, _I64.min, _I64.max, _I64.max, -1, 5])
    r1 = torch.tensor([1, 1, 2, 2, 3, 4], dtype=torch.int32)
    r1_valid = torch.tensor([True, True, True, True, True, False])
    acc.update((key, None), [(r0, None), (r1, r1_valid)], [(None, None)],
               None)
    assert acc.check().tolist() == [0, 4]
    value, valid = acc.residual(0)
    assert value[:4].tolist() == [_I64.min, _I64.max, -1, 5]
    assert valid[:4].tolist() == [True] * 4 and not valid[4]
    assert acc.residual(1)[1][:4].tolist() == [True, True, True, False]
    assert acc.acc[0][:4].tolist() == [2, 2, 1, 1]
    acc.update((torch.tensor([0]), None),
               [(torch.tensor([3]), None),
                (torch.tensor([1], dtype=torch.int32), None)],
               [(None, None)], None)
    assert acc.check().tolist() == [1, 4]


def test_dense_check_folds_query_scale_pairs():
    """The plain check folds each float64 sum's 128-bit query-scale pair
    into its float64 word as the kernel's tail does, and clears it: a
    negative pair, a pair whose low word has its top bit set, a zero pair
    beside a -0.0 word (left as it is), and a channel whose scale was
    never set (left as it is)."""
    acc = tg.DenseAccumulator(0, 3, 0, [("sum", True), ("sum", True)], CPU)
    q0, q1 = acc.ch_q
    w0, w1 = acc.ch_off[0] + 3, acc.ch_off[1] + 3
    acc.present[:] = 1
    acc.fwords[2] = 20                      # channel 0's scale; 1 has none

    def word(v):  # an unsigned 64-bit word as int64
        return v - 2 ** 64 if v >= 2 ** 63 else v

    neg = -(2 ** 70 + 2 ** 20)              # -(2^50 + 1) at scale 20
    acc.rec[0, q0] = word(neg & (2 ** 64 - 1))
    acc.rec[0, q0 + 1] = neg >> 64
    acc.rec[1, q0] = word(2 ** 63 + 2 ** 20)  # 2^43 + 1: low's top bit set
    acc.rec[:, w0] = torch.tensor([0.5, 0.25, -0.0, 0.0],
                                  dtype=torch.float64).view(torch.int64)
    acc.rec[0, q1] = 12345
    acc.rec[:, w1] = torch.tensor([1.0, 2.0, 3.0, 4.0],
                                  dtype=torch.float64).view(torch.int64)
    assert acc.check().tolist() == [0, 4]
    got = acc.acc[0].tolist()
    assert got[:2] == [-(2.0 ** 50 + 0.5), 2.0 ** 43 + 1.25]
    assert str(got[2]) == "-0.0"
    assert acc.rec[:, q0:q0 + 2].eq(0).all()
    assert acc.acc[1].tolist() == [1.0, 2.0, 3.0, 4.0]
    assert int(acc.rec[0, q1]) == 12345


# -- the redesigned grid and hash aggregates: edge shapes and host logic ------

def _far_floats(rng, n, specials=True):
    """Values near 1 with 1e-30 and 1e30 among them (and the specials):
    the values the kernels' query scale leaves to their fallback."""
    x = rng.normal(size=n)
    pick = rng.random(n)
    x[pick < 0.05] = 1e-30
    x[pick > 0.95] = 1e30
    x[:6] = [np.inf, -np.inf, np.nan, 1e30, 2.0 ** -1074, 0.0] if specials \
        else [1e30, 1e-30, -1e-30, 1e30, 2.0 ** -1074, 0.0]
    return x


def _grid_edge(shape):
    """(keys, dims, contribs, active) of grid_agg.cu's risky shapes that the
    plain version reaches."""
    rng = np.random.default_rng(61)
    n = 3000
    if shape == "one_slot":          # dims (0,): every key null, G = 1
        keys = [(np.zeros(n, np.int32), np.zeros(n, bool))]
        dims = (0,)
    else:
        dims = (4, 2)
        keys = [(rng.integers(0, d, n).astype(np.int32),
                 rng.random(n) < 0.8) for d in dims]
    contribs = [((rng.integers(-10**12, 10**12, n), None), "sum"),
                ((None, rng.random(n) < 0.6), "sum"), ((None, None), "sum")]
    if shape != "int64_only":
        # the reference's grid is a one-hot product, which spreads a NaN
        # or an infinity to every slot: specials are held to numpy below
        x = _far_floats(rng, n, specials=False) if shape == "far_floats" \
            else rng.normal(size=n) * 100
        contribs = [((x, rng.random(n) < 0.9), "sum")] + contribs
    active = rng.random(n) < (0.0 if shape == "all_dead" else 0.7)
    return keys, dims, contribs, active


@pytest.mark.parametrize("shape", ["one_slot", "int64_only", "far_floats",
                                   "all_dead"])
def test_grid_group_reduce_edges_match_reference(shape):
    """The grid's plain version on the kernel's risky shapes (one slot,
    int64 channels only, float values outside any query scale's range with
    infinities and NaN, every row dead) against the reference's
    grid_group_reduce."""
    keys, dims, contribs, active = _grid_edge(shape)
    want_keys, want_vals = _reference_grid(keys, dims, contribs, active)
    got_keys, got_vals = _port_groups(_port_grid(keys, dims, contribs,
                                                 active))
    for (wc, wv), (gc, gv) in zip(want_keys, got_keys):
        np.testing.assert_array_equal(gv, wv)
        np.testing.assert_array_equal(gc[gv], wc[wv])
    for w, g in zip(want_vals, got_vals):
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=REL, atol=0)
        else:
            np.testing.assert_array_equal(g, w)


def test_grid_specials_match_numpy():
    """Infinities and NaN in a float64 sum stay in their own slots (numpy's
    per-slot sums): +inf, -inf, both (NaN), NaN, and finite slots."""
    rng = np.random.default_rng(66)
    n = 2000
    codes = rng.integers(0, 4, n).astype(np.int32)
    x = rng.normal(size=n)
    for code, vals in ((0, [np.inf]), (1, [-np.inf]), (2, [np.inf, -np.inf]),
                       (3, [np.nan])):
        at = np.flatnonzero(codes == code)[:len(vals)]
        x[at] = vals
    codes[codes == 3] = np.where(rng.random((codes == 3).sum()) < 0.5, 3, 4)
    dims = (5,)
    active = np.ones(n, bool)
    acc = _port_grid([(codes, None)], dims, [((x, None), "sum")], active)
    want = np.zeros(6)
    with np.errstate(invalid="ignore"):
        np.add.at(want, codes, x)
    got = acc.values()[0].numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    fin = np.isfinite(want)
    np.testing.assert_array_equal(got[~fin & ~np.isnan(want)],
                                  want[~fin & ~np.isnan(want)])
    np.testing.assert_allclose(got[fin], want[fin], rtol=REL, atol=1e-12)


def test_grid_views_at_an_odd_offset_match_aligned_columns():
    """Keys, values and masks as views at odd storage offsets (the kernel
    reads them a row at a time) give the reference's grid_group_reduce
    over the aligned columns."""
    keys, dims, contribs, active = _grid_edge("plain")
    want_keys, want_vals = _reference_grid(keys, dims, contribs, active)

    def off(a, k):
        if a is None:
            return None
        t = torch.from_numpy(np.concatenate([a[:k], a]))[k:]
        assert t.storage_offset() == k
        return t

    tc = [((off(d, 1), off(v, 3)), op) for (d, v), op in contribs]
    acc = tg.GridAccumulator(dims, _kinds(contribs), CPU)
    tg.grid_group_reduce([(off(c, 1), off(v, 5)) for c, v in keys], dims,
                         tc, off(active, 7), acc)
    got_keys, got_vals = _port_groups(acc)
    for (wc, wv), (gc, gv) in zip(want_keys, got_keys):
        np.testing.assert_array_equal(gv, wv)
        np.testing.assert_array_equal(gc[gv], wc[wv])
    for w, g in zip(want_vals, got_vals):
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=REL, atol=0)
        else:
            np.testing.assert_array_equal(g, w)


def test_grid_sums_regrid_move_integers_and_keep_scales():
    """A regrid moves each slot's query-scale integers to its new slot and
    keeps the scales; the fallback words start empty."""
    acc = tg.GridAccumulator((2, 1), ["f", "i", "f"], CPU)
    q = torch.arange(acc.G * 2 * 2, dtype=torch.int64).view(acc.G, 2, 2)
    acc.sums.q.copy_(q)
    acc.sums.words[2:4] = torch.tensor([40, 41])
    acc.sums.fb.fill_(7)
    acc.regrid((4, 2))
    slot = lambda c0, c1: c0 * 3 + c1  # noqa: E731 (dims (4, 2))
    moved = {(0, 0): slot(0, 0), (0, 1): slot(0, 2), (1, 0): slot(1, 0),
             (1, 1): slot(1, 2), (2, 0): slot(4, 0), (2, 1): slot(4, 2)}
    for (c0, c1), new in moved.items():
        assert torch.equal(acc.sums.q[new], q[c0 * 2 + c1])
    assert int(acc.sums.q.abs().sum()) == int(q.abs().sum())
    assert acc.sums.words[2:4].tolist() == [40, 41]
    assert acc.sums.words[:2].tolist() == [0, 0]
    assert int(acc.sums.fb.abs().sum()) == 0 and acc.sums.fb.shape[0] == 15


@pytest.mark.parametrize("largest", [1.0, 104_949.5, 3e-300, 1e300, 0.07])
def test_query_scale_and_fallback_rule(largest):
    """The scale from a channel's largest |x| puts that |x| at 2^73; values
    from 2^-21 to just under 2^20 of it (ilogb within [-21, 19] of its) add
    exactly, as integers below 2^93; anything else, no scale, zero and the
    specials take the fallback."""
    from fractions import Fraction
    s = tg.query_scale(largest)
    e = math.frexp(largest)[1] - 1
    assert 73 <= math.log2(largest) + s < 74
    for k, inside in ((-22, False), (-21, True), (0, True), (19, True),
                      (20, False)):
        x = math.ldexp(1.5, e + k)
        if not math.isfinite(x) or x == 0.0:
            continue
        assert tg.in_query_range(x, s) == inside, (k, x)
        assert tg.in_query_range(-x, s) == inside
        if inside:
            y = Fraction(x) * Fraction(2) ** s
            assert y.denominator == 1 and abs(y) < 2 ** 93
    for x in (0.0, math.inf, -math.inf, math.nan):
        assert not tg.in_query_range(x, s)
    assert not tg.in_query_range(largest, None)


def test_query_scale_sums_are_exact():
    """Integers at the query scale add exactly: their sum, scaled back, is
    the exact rational sum of the values (the kernels' sums do not depend
    on the order)."""
    from fractions import Fraction
    rng = np.random.default_rng(62)
    x = np.round(rng.uniform(900.0, 105_000.0, 5000), 2) * (
        1 - rng.integers(0, 11, 5000) / 100.0)
    s = tg.query_scale(float(np.abs(x).max()))
    assert all(tg.in_query_range(float(v), s) for v in x)
    total = sum(int(Fraction(float(v)) * 2 ** s) for v in x)
    assert Fraction(total, 2 ** s) == sum(Fraction(float(v)) for v in x)
    shuffled = sum(int(Fraction(float(v)) * 2 ** s)
                   for v in rng.permutation(x))
    assert shuffled == total


@pytest.mark.parametrize("channels,hot,cold,W,H", [
    ([], [], [], 0, 0),
    ([("sum", True), ("count", False)], [0, 2], [3, -1], 8, 3),
    ([("count", False)], [0], [-1], 1, 1),
    ([("min", True), ("max", False)], [0, 1], [-1, -1], 2, 2),
    ([("first", False), ("last", False), ("last", False),
      ("first_valid", False), ("last_valid", False), ("count", False)],
     [0, 1, 2, 3, 4, 5], [6, 7, 8, 9, 10, -1], 12, 6),
    ([("sum", False), ("sum", True), ("first_valid", True)],
     [0, 1, 3], [-1, 4, 8], 12, 4)])
def test_record_layout(channels, hot, cold, W, H):
    """hash_agg.cu's value record: the hot words first (a float64 sum's
    query-scale pair takes two), then the cold words, W a multiple of 4
    past 2 words; a fresh record holds each word's identity."""
    h, c, w, hh, init = tg.record_layout(channels)
    assert (h, c, w, hh) == (hot, cold, W, H)
    assert len(init) == W
    for (op, f), at in zip(channels, h):
        if op in tg.ORDERED_OPS:
            assert init[at] == (tg._I64_MAX if op.startswith("first")
                                else -1)
        elif op == "min" and not f:
            assert init[at] == tg._I64_MAX
        elif op == "min":
            assert init[at] == int(tg.f64_image(
                torch.tensor([math.inf], dtype=torch.float64), 0)[0])
        elif op == "max" and not f:
            assert init[at] == tg._I64_MIN
        else:
            assert init[at] == 0
    assert all(x == 0 for x in init[H:])


@pytest.mark.parametrize("channels,nf", [
    ([("sum", True), ("count", False)], 1),
    ([("sum", False), ("min", True), ("max", True), ("first", True)], 0),
    ([("sum", True), ("last_valid", True), ("sum", True)], 2)],
    ids=["q18", "no_float_sum", "two_float_sums"])
def test_hash_table_words_follow_the_float64_sums(channels, nf):
    """The kernel's table words (made with the group count, by one fill)
    hold, per float64 sum, its largest |x| and scale word, then the
    fallback list's count, the launch's starting group count, a ticket and
    the rows of the list's call, all zero; only float64 sums count (a
    call's fallback list has room for n of each)."""
    acc = tg.HashAccumulator(1, channels, CPU, plain=False)
    assert acc.nf == nf
    assert acc.fwords.tolist() == [0] * (2 * nf + 4)


def test_update_table_growth_keeps_groups():
    """An update table grows into empty slot records and value records for
    HA_LOAD of its slots, keeping the first `bound` groups' records (the
    count was just read), with the scales untouched."""
    acc = tg.HashAccumulator(2, [("sum", True), ("count", False)], CPU,
                             plain=False)
    acc._records(2048, 0)
    assert acc.gids == 1024 and acc.recs.shape == (2048 * acc.stride,)
    assert acc.stride == 4 and int(acc.recs.abs().sum()) == 0
    acc.meta.copy_(torch.arange(acc.meta.numel()).view(acc.meta.shape))
    acc.vals.copy_(torch.arange(acc.vals.numel()).view(acc.vals.shape))
    meta, vals = acc.meta.clone(), acc.vals.clone()
    acc.recs.fill_(5)
    acc._records(8192, 300)
    assert acc.cap == 8192 and acc.gids == 4096
    assert torch.equal(acc.meta[:300], meta[:300])
    assert torch.equal(acc.vals[:300], vals[:300])
    assert int(acc.recs.abs().sum()) == 0
    assert acc.fwords.tolist() == [0] * 6
    assert acc.fresh == [0] * 8


def _hash_edge(shape):
    """(keys, contribs, active, batch) of hash_agg.cu's risky shapes that
    the plain version reaches."""
    keys, contribs, active = _hash_case(6000, 63)
    n = len(active)
    rng = np.random.default_rng(64)
    if shape == "n17":
        keys, contribs, active = _hash_case(17, 65)
        return keys, contribs, active, 5
    if shape == "all_dead":
        return keys, contribs, np.zeros(n, bool), 2000
    if shape == "one_group":
        return [(np.zeros(n, np.int64), None)], contribs, active, 6000
    if shape == "eight_keys":
        keys = [(rng.integers(0, 3, n).astype(np.int64),
                 rng.random(n) < 0.9) for _ in range(8)]
        return keys, contribs, active, 1500
    x = _far_floats(rng, n)                      # far_floats
    contribs = [(x, rng.random(n) < 0.9, "sum", True),
                (x, None, "min", True), (x, None, "max", True),
                (None, None, "count", False)]
    return [(rng.integers(0, 40, n).astype(np.int64), None)], contribs, \
        active, 2000


@pytest.mark.parametrize("shape", ["n17", "all_dead", "one_group",
                                   "eight_keys", "far_floats"])
def test_hash_aggregate_edges_match_group_reduce(shape):
    """The hash aggregate's plain version on the kernel's risky shapes (17
    rows in batches of 5, every row dead, one group for every row, 8 keys,
    float values outside any query scale's range with infinities and NaN)
    against the reference's group_reduce."""
    keys, contribs, active, batch = _hash_edge(shape)
    want = _reference_hash_groups(keys, contribs, active)
    got, _ = _port_hash_groups(keys, contribs, active, batch)
    assert got.keys() == want.keys()
    for k, vals in want.items():
        for a, b, (_, _, op, _) in zip(got[k], vals, contribs):
            if isinstance(b, float) and math.isinf(b):
                assert a == b, (k, op, a, b)
            else:
                assert _same(a, b, "sum" if op in ("sum", "count") else op), \
                    (k, op, a, b)


def test_table_output_masks_rows_past_the_groups():
    """A small table comes back whole under its live mask (gid < ngroups):
    the rows past the groups, whose records were never written, come back
    with key words 0 and null, so no garbage code reaches a dictionary."""
    acc = tg.HashAccumulator(2, [("count", False), ("max", False)], CPU,
                             plain=False)
    acc._records(1024, 0)
    acc.meta.fill_(-123456789)
    acc.meta[:3, 1] = torch.tensor([0, 1, 2])
    acc.meta[:3, 2:] = torch.tensor([[5, 6], [7, 8], [9, 10]])
    acc.vals.zero_()
    acc.ngroups.fill_(3)
    keys, values, live = acc._finish_records(None)
    assert live.tolist() == [True] * 3 + [False] * (acc.gids - 3)
    (w0, v0), (w1, v1) = keys
    assert w0[:3].tolist() == [5, 7, 9] and w1[:3].tolist() == [6, 8, 10]
    assert v0[:3].tolist() == [True, False, True]
    assert v1[:3].tolist() == [True, True, False]
    assert int(w0[3:].abs().sum()) == 0 and int(w1[3:].abs().sum()) == 0
    assert not bool(v0[3:].any()) and not bool(v1[3:].any())
