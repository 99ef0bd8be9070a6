"""Joins that match on more than key equality (ROADMAP queue 2 row
7′-rest): residual conditions on every join type, existence joins and
cross joins, held against the JAX package's DataFrame over the same
logical ``Join``, broadcast and shuffled; and the plain versions of
``csrc/cond_join.cu``'s three wrappers against numpy.  Rows are compared
as multisets (sorted), exactly: the cases carry integers, strings and
nulls only.  The port runs on the CPU here (its kernels' plain
versions)."""

import inspect

import numpy as np
import pytest
import torch

import spark_rapids_tpu as jsrt
import spark_rapids_tpu.plan.logical as JL
from spark_rapids_tpu import exprs as JE
from spark_rapids_tpu.sql import functions as JF
from spark_rapids_tpu.sql.dataframe import DataFrame as JDF
from spark_rapids_tpu.utils.metrics import QueryStats as JStats
import spark_rapids_tpu_torch as tsrt
import spark_rapids_tpu_torch.plan.logical as TL
from spark_rapids_tpu_torch import exprs as TE
from spark_rapids_tpu_torch.ops import join
from spark_rapids_tpu_torch.sql import functions as TF
from spark_rapids_tpu_torch.sql.dataframe import DataFrame as TDF
from spark_rapids_tpu_torch.utils.metrics import QueryStats as TStats

PACKAGES = {"jax": (jsrt, JL, JE, JF, JDF, JStats),
            "torch": (tsrt, TL, TE, TF, TDF, TStats)}
CONFIGS = {
    "broadcast": {"spark.rapids.tpu.sql.batchSizeRows": 64,
                  "spark.rapids.tpu.join.denseMinProbeRows": 0},
    "shuffled": {"spark.rapids.tpu.sql.batchSizeRows": 64,
                 "spark.rapids.tpu.sql.autoBroadcastJoinThreshold": -1},
}
HOWS = ["inner", "left", "semi", "anti", "existence", "right", "full",
        "cross"]


def _key(row):
    return tuple((0, x) if x is None else (1, x) for x in row)


def _sides():
    """Two seeded sides: keys over 40 values (10% null), payloads over
    100 (10% null), a string column; 300 and 200 rows."""
    rng = np.random.default_rng(5)

    def side(n, pre):
        k = rng.integers(0, 40, n).astype(object)
        k[rng.random(n) < 0.1] = None
        v = rng.integers(0, 100, n).astype(object)
        v[rng.random(n) < 0.1] = None
        s = rng.choice(np.array(["x", "y", "z"], dtype=object), n)
        return {f"{pre}k": k, f"{pre}v": v, f"{pre}s": s,
                f"{pre}id": np.arange(n, dtype=np.int64)}
    return side(300, "a"), side(200, "b")


def _run(pkg, settings, left, right, how, on, condition, using=()):
    """Rows of the join in package ``pkg`` and its blocking fetches."""
    srt, L, E, F, DF, Stats = PACKAGES[pkg]
    sess = srt.Session(settings) if pkg == "jax" \
        else srt.Session(settings, device="cpu")
    lp = sess.create_dataframe(left)._plan
    rp = sess.create_dataframe(right)._plan
    node = L.Join(lp, rp, [E.UnresolvedColumn(a) for a, _ in on],
                  [E.UnresolvedColumn(b) for _, b in on], how=how,
                  condition=None if condition is None
                  else condition(F).expr)
    if using:
        node.using = list(using)
    with Stats.scoped() as st:
        rows = DF(node, sess).collect()
    return sorted(rows, key=_key), st.blocking_fetches


@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("how", HOWS)
def test_join_type_matches_reference(how, config):
    """Every join type with the residual ``av < bv`` (a cross join: with
    no condition), broadcast and over 8 hash partition pairs: the rows
    equal the reference's, at no more blocking fetches."""
    left, right = _sides()
    on = [] if how == "cross" else [("ak", "bk")]
    cond = None if how == "cross" else \
        (lambda F: F.col("av") < F.col("bv"))
    want, jfetch = _run("jax", CONFIGS[config], left, right, how, on, cond)
    got, tfetch = _run("torch", CONFIGS[config], left, right, how, on, cond)
    assert got == want and got
    assert tfetch <= jfetch


@pytest.mark.parametrize("config", list(CONFIGS))
def test_existence_join_without_condition_matches_reference(config):
    """An existence join without a condition: every left row and its key
    match flag (the CSR probe's semi mode broadcast, the sorted probe's
    over partition pairs), against the reference."""
    left, right = _sides()
    want, jfetch = _run("jax", CONFIGS[config], left, right, "existence",
                        [("ak", "bk")], None)
    got, tfetch = _run("torch", CONFIGS[config], left, right, "existence",
                       [("ak", "bk")], None)
    assert got == want and len(got) == 300
    assert tfetch <= jfetch


def _reference_case_tables():
    return ({"k": np.array(["a", "a", "b"], dtype=object),
             "v": np.array([5, 15, 25], dtype=np.int64)},
            {"k": np.array(["a", "b"], dtype=object),
             "lim": np.array([10, 30], dtype=np.int64)})


@pytest.mark.parametrize("how, want", [
    ("inner", [("a", 5, 10), ("b", 25, 30)]),
    ("left", [("a", 5, 10), ("a", 15, None), ("b", 25, 30)]),
    ("semi", [("a", 5), ("b", 25)]),
    ("anti", [("a", 15)]),
])
def test_reference_join_test_cases(how, want):
    """The reference's own cases (``tests/test_join.py:212-262``): USING
    string keys with ``v < lim``; the condition takes part in the
    matching, so the left join pads the row it fails.  The reference runs
    its conditioned outer USING join on the CPU; the port's device join
    coalesces the USING keys itself, and the rows agree."""
    left, right = _reference_case_tables()
    cond = lambda F: F.col("v") < F.col("lim")  # noqa: E731
    for pkg in ("jax", "torch"):
        got, _ = _run(pkg, CONFIGS["broadcast"], left, right, how,
                      [("k", "k")], cond, using=["k"])
        assert got == sorted(want, key=_key), pkg


# ---------------------------------------------------------------------------------
# The plain versions of cond_join.cu's wrappers against numpy
# ---------------------------------------------------------------------------------

def _match_state(rng, n_probe, n_build, p_active, max_hit):
    """A random match state: each active probe row matches a range of
    0..max_hit sorted build positions."""
    counts = np.where(rng.random(n_probe) < p_active,
                      rng.integers(0, max_hit + 1, n_probe), 0)
    lo = rng.integers(0, max(n_build - max_hit, 1), n_probe)
    counts = np.minimum(counts, n_build - lo)
    offsets = np.concatenate(([0], np.cumsum(counts)))
    b_perm = rng.permutation(n_build).astype(np.int32)
    return offsets, lo.astype(np.int32), b_perm


@pytest.mark.parametrize("case", ["random", "no_candidates", "all_inactive",
                                  "one_build_row_for_all", "one_heavy_row"])
def test_cond_expand_and_counts_plain(case):
    rng = np.random.default_rng(11)
    n_probe, n_build = 500, 300
    if case == "one_build_row_for_all":
        offsets = np.arange(n_probe + 1)
        lo = np.full(n_probe, 7, dtype=np.int32)
        b_perm = rng.permutation(n_build).astype(np.int32)
    elif case == "one_heavy_row":
        counts = np.zeros(n_probe, dtype=np.int64)
        counts[123] = n_build
        offsets = np.concatenate(([0], np.cumsum(counts)))
        lo = np.zeros(n_probe, dtype=np.int32)
        b_perm = rng.permutation(n_build).astype(np.int32)
    else:
        offsets, lo, b_perm = _match_state(
            rng, n_probe, n_build,
            {"random": 0.8, "no_candidates": 0.0,
             "all_inactive": 0.0}[case], 6)
    total = int(offsets[-1])
    pi, bi = join.cond_expand(torch.from_numpy(offsets),
                              torch.from_numpy(lo), torch.from_numpy(b_perm),
                              total)
    cnt = np.diff(offsets)
    want_pi = np.repeat(np.arange(n_probe), cnt)
    want_bi = b_perm[np.repeat(lo, cnt) + (np.arange(total)
                                            - np.repeat(offsets[:-1], cnt))]
    assert pi.dtype == bi.dtype == torch.int32
    np.testing.assert_array_equal(pi.numpy(), want_pi)
    np.testing.assert_array_equal(bi.numpy(), want_bi)
    keep = rng.random(total) < 0.5
    t_off = torch.from_numpy(offsets)
    pc, bc = join.cond_counts(torch.from_numpy(keep), pi, bi, n_probe,
                              n_build, t_off)
    np.testing.assert_array_equal(
        pc.numpy(), np.bincount(want_pi[keep], minlength=n_probe))
    np.testing.assert_array_equal(
        bc.numpy(), np.bincount(want_bi[keep], minlength=n_build))
    pc2, bc2 = join.cond_counts(torch.from_numpy(keep), pi, bi, n_probe,
                                None, t_off)
    assert bc2 is None and torch.equal(pc2, pc)
    if case == "one_build_row_for_all":
        assert bc.numpy()[b_perm[7]] == keep.sum()


def _counts_state(case, rng):
    """(offsets, lo, b_perm, keep) of the shapes the device counts split
    on: a hot key, long runs of probe rows with no candidates, few pairs,
    and keep all false or all true."""
    n_probe, n_build = 4000, 6000
    counts = np.zeros(n_probe, dtype=np.int64)
    if case == "hot_key":
        counts[1234] = 5003
        counts[rng.integers(0, n_probe, 50)] += 3
    elif case == "empty_runs":
        counts[[0, 1999, 2000, 3999]] = [7, 1, 40, 2]
    elif case == "few_pairs":
        counts[[17, 18]] = [3, 2]
    else:
        counts = rng.integers(0, 5, n_probe)
    lo = np.minimum(rng.integers(0, n_build, n_probe),
                    n_build - counts).astype(np.int32)
    offsets = np.concatenate(([0], np.cumsum(counts)))
    b_perm = rng.permutation(n_build).astype(np.int32)
    total = int(offsets[-1])
    keep = {"keep_none": np.zeros(total, dtype=bool),
            "keep_all": np.ones(total, dtype=bool)}.get(
        case, rng.random(total) < 0.5)
    return offsets, lo, b_perm, keep


@pytest.mark.parametrize("case", ["hot_key", "empty_runs", "few_pairs",
                                  "keep_none", "keep_all"])
def test_cond_counts_by_ranges_plain(case):
    """The plain expansion and counts on a hot key and on empty probe
    ranges, called as the main path calls them (with the probe rows'
    ranges, which the kernel counts by): equal to ``index_add_`` by pi and
    to numpy, with and without build counts."""
    rng = np.random.default_rng(["hot_key", "empty_runs", "few_pairs",
                                 "keep_none", "keep_all"].index(case) + 40)
    offsets, lo, b_perm, keep = _counts_state(case, rng)
    n_probe, n_build, total = len(lo), len(b_perm), int(offsets[-1])
    t_off = torch.from_numpy(offsets)
    pi, bi = join.cond_expand(t_off, torch.from_numpy(lo),
                              torch.from_numpy(b_perm), total)
    cnt = np.diff(offsets)
    want_pi = np.repeat(np.arange(n_probe), cnt)
    want_bi = b_perm[np.repeat(lo, cnt) + (np.arange(total)
                                            - np.repeat(offsets[:-1], cnt))]
    np.testing.assert_array_equal(pi.numpy(), want_pi)
    np.testing.assert_array_equal(bi.numpy(), want_bi)
    t_keep = torch.from_numpy(keep)
    pc, bc = join.cond_counts(t_keep, pi, bi, n_probe, n_build, t_off)
    alone, none = join.cond_counts(t_keep, pi, bi, n_probe, None, t_off)
    want_pc = np.bincount(want_pi[keep], minlength=n_probe)
    assert pc.dtype == torch.int32 and none is None
    np.testing.assert_array_equal(pc.numpy(), want_pc)
    np.testing.assert_array_equal(alone.numpy(), want_pc)
    np.testing.assert_array_equal(
        bc.numpy(), np.bincount(want_bi[keep], minlength=n_build))
    index_add = torch.zeros(n_probe, dtype=torch.int32).index_add_(
        0, pi.long(), t_keep.int())
    assert torch.equal(pc, index_add)
    # each probe row's count is the kept pairs of its range
    run = np.concatenate(([0], np.cumsum(keep)))
    np.testing.assert_array_equal(pc.numpy(),
                                  run[offsets[1:]] - run[offsets[:-1]])
    if case == "hot_key":
        assert int(pc[1234]) == int(keep[offsets[1234]:
                                         offsets[1235]].sum())


def test_device_cond_counts_needs_offsets():
    """The kernel counts by the probe rows' ranges: it takes ``offsets``
    (int64 [n_probe + 1]) where the plain version takes pi, and refuses
    the int32 probe rows in their place."""
    params = list(inspect.signature(join.cond_counts_kernel).parameters)
    assert params[:3] == ["keep", "offsets", "bi"] and "pi" not in params
    with pytest.raises(ValueError, match="offsets"):
        join.cond_counts_kernel(torch.zeros(3, dtype=torch.bool),
                                torch.zeros(3, dtype=torch.int32),
                                torch.zeros(3, dtype=torch.int32), 1, None)


@pytest.mark.parametrize("n_l, n_r", [(0, 5), (5, 0), (1, 1), (7, 13),
                                      (300, 41)])
def test_cross_pairs_plain(n_l, n_r):
    pi, bi = join.cross_pairs(n_l, n_r, torch.device("cpu"))
    grid_l, grid_r = np.meshgrid(np.arange(n_l), np.arange(n_r),
                                 indexing="ij")
    np.testing.assert_array_equal(pi.numpy(), grid_l.reshape(-1))
    np.testing.assert_array_equal(bi.numpy(), grid_r.reshape(-1))


def test_pair_counts_past_int32_raise():
    """Pairs are int32 indices: a count that would wrap is refused."""
    with pytest.raises(ValueError, match="int32"):
        join.cross_pairs(1 << 16, 1 << 16, torch.device("cpu"))
    with pytest.raises(ValueError, match="int32"):
        join.cond_expand(torch.zeros(2, dtype=torch.int64),
                         torch.zeros(1, dtype=torch.int32),
                         torch.zeros(1, dtype=torch.int32), 1 << 31)
