"""Broadcast joins through both packages' Sessions on the same numpy dicts:
the port's dense inner join (plain PyTorch versions of csrc/dense_join.cu
on the CPU) against the JAX package's BroadcastJoinExec.  Joins without
ORDER BY leave row order open, so rows compare as sorted lists; values are
exact (the joins move values, they compute none)."""

import numpy as np
import pytest
import torch

import spark_rapids_tpu as jsrt
from spark_rapids_tpu.sql import functions as JF
from spark_rapids_tpu.utils.metrics import QueryStats as JStats
import spark_rapids_tpu_torch as tsrt
from spark_rapids_tpu_torch.ops import join as tj
from spark_rapids_tpu_torch.sql import functions as TF

SETTINGS = {"spark.rapids.tpu.sql.batchSizeRows": 1024,
            "spark.rapids.tpu.join.denseMinProbeRows": 0}


@pytest.fixture(scope="module")
def sessions():
    return jsrt.Session(SETTINGS), tsrt.Session(SETTINGS, device="cpu")


def _dims(seed=11, n=400, null_keys=True):
    """A dimension table with unique keys 1000..1000+n (shuffled, a few
    null) and a fact table whose keys hit, miss and are null."""
    rng = np.random.default_rng(seed)
    dk = (1000 + rng.permutation(n)).astype(object)
    if null_keys:
        dk[rng.random(n) < 0.05] = None
    dim = {"d_key": dk,
           "d_val": rng.integers(-50, 50, n).astype(np.int64),
           "d_day": np.datetime64("1995-01-01")
           + rng.integers(0, 300, n).astype("timedelta64[D]"),
           "d_w": rng.normal(size=n)}
    m = 5000
    fk = rng.integers(900, 1000 + n + 100, m).astype(object)
    if null_keys:
        fk[rng.random(m) < 0.05] = None
    fact = {"f_key": fk, "f_x": rng.normal(size=m),
            "f_q": rng.integers(0, 100, m).astype(np.int64)}
    return dim, fact


def _rows(sessions, dim, fact, q, settings=None):
    """(reference rows, reference fetches, port rows, port fetches,
    explains) of ``q(F, dim_df, fact_df)``."""
    jsess, tsess = sessions
    out = []
    for sess, F, stats in ((jsess, JF, JStats), (tsess, TF, None)):
        df = q(F, sess.create_dataframe(dim), sess.create_dataframe(fact))
        if stats is not None:
            with stats.scoped() as st:
                rows = df.collect()
            fetches = st.blocking_fetches
        else:
            rows = df.collect()
            fetches = sess.last_query_stats().blocking_fetches
        out += [rows, fetches, df.explain_string()]
    return out


def _key(row):
    return tuple((x is None, x if x is not None else 0) for x in row)


@pytest.mark.parametrize("fact_filter", [False, True])
def test_inner_join_with_masks_and_null_keys_matches_reference(
        sessions, fact_filter):
    dim, fact = _dims()

    def q(F, d, f):
        d = d.where(F.col("d_val") > -30)
        if fact_filter:
            f = f.where(F.col("f_q") < 70)
        return f.join(d, [("f_key", "d_key")])

    jrows, jf, jexp, trows, tf, texp = _rows(sessions, dim, fact, q)
    assert sorted(trows, key=_key) == sorted(jrows, key=_key)
    assert texp.splitlines()[2:] == jexp.splitlines()[2:]
    assert tf <= jf


def test_join_on_column_names_builds_the_smaller_side(sessions):
    """``on=name`` drops the right copy of the key; the smaller side
    builds wherever it sits."""
    dim, fact = _dims(seed=12, null_keys=False)
    dim = {"k": dim["d_key"].astype(np.int64), "d_val": dim["d_val"]}
    fact = {"k": np.where(fact["f_key"] == None, 0,  # noqa: E711
                          fact["f_key"]).astype(np.int64),
            "f_q": fact["f_q"]}
    for order in ("dim_left", "dim_right"):
        def q(F, d, f):
            return d.join(f, "k") if order == "dim_left" else f.join(d, "k")

        jrows, _, _, trows, _, _ = _rows(sessions, dim, fact, q)
        assert trows and sorted(trows) == sorted(jrows)


def test_join_then_dense_aggregate_matches_reference(sessions):
    dim, fact = _dims(seed=13)

    def q(F, d, f):
        return (f.join(d, [("f_key", "d_key")])
                 .group_by("f_key", "d_day")
                 .agg(F.sum(F.col("f_x") * F.col("d_w")).alias("s"),
                      F.count_star().alias("n")))

    jrows, jf, _, trows, tf, _ = _rows(sessions, dim, fact, q)
    jrows, trows = sorted(jrows, key=_key), sorted(trows, key=_key)
    assert len(trows) == len(jrows)
    for a, b in zip(trows, jrows):
        assert a[:2] == b[:2] and a[3] == b[3]
        assert abs(a[2] - b[2]) <= 1e-12 * max(abs(b[2]), 1.0)
    assert tf <= jf


def test_duplicate_build_keys_raise(sessions):
    """A build side that repeats a key no longer raises: the stats fetch
    counts the duplicates and the join takes the CSR path, whose rows
    equal the reference's (its ``_csr_match_state``)."""
    jsess, tsess = sessions
    rows = []
    for sess, F in ((jsess, JF), (tsess, TF)):
        d = sess.create_dataframe({"k": np.array([1, 2, 2, 3], dtype=np.int64),
                                   "v": np.array([10, 20, 21, 30],
                                                 dtype=np.int64)})
        f = sess.create_dataframe({"k2": np.arange(10, dtype=np.int64)})
        rows.append(sorted(f.join(d, [("k2", "k")]).collect()))
    assert rows[1] == rows[0] == [(1, 1, 10), (2, 2, 20), (2, 2, 21),
                                  (3, 3, 30)]
    metrics = tsess.last_exec_context().metrics
    assert any(m.values.get("joinCsrPath") for m in metrics.values())


@pytest.mark.parametrize("how", ["left", "semi", "anti", "full"])
def test_joins_other_than_inner_raise(sessions, how):
    """Left outer, semi and anti joins now run (dense path here: unique
    build keys) and equal the reference; a full outer join still needs
    the shuffled join and raises."""
    jsess, tsess = sessions
    rows = []
    for sess in (jsess, tsess):
        d = sess.create_dataframe({"k": np.arange(5, dtype=np.int64),
                                   "w": np.arange(5, dtype=np.int64) * 7})
        f = sess.create_dataframe({"k": np.arange(10, dtype=np.int64)})
        if sess is tsess and how == "full":
            with pytest.raises(NotImplementedError, match="row 7"):
                f.join(d, "k", how=how).collect()
            return
        rows.append(sorted(f.join(d, "k", how=how).collect(), key=_key))
    assert rows[1] == rows[0]
    assert len(rows[1]) == {"left": 10, "semi": 5, "anti": 5}[how]


def test_unported_join_shapes_raise(sessions):
    _, tsess = sessions
    d = tsess.create_dataframe({"a": np.arange(5, dtype=np.int64),
                                "b": np.arange(5, dtype=np.int64),
                                "w": np.arange(5, dtype=np.float64)})
    f = tsess.create_dataframe({"a2": np.arange(9, dtype=np.int64),
                                "b2": np.arange(9, dtype=np.int64),
                                "x": np.arange(9, dtype=np.float64)})
    with pytest.raises(NotImplementedError, match="2 keys.*6′"):
        f.join(d, [("a2", "a"), ("b2", "b")]).collect()
    with pytest.raises(NotImplementedError, match="double key.*6′"):
        f.join(d, [("x", "w")]).collect()
    narrow = tsrt.Session({**SETTINGS,
                           "spark.rapids.tpu.join.denseDomainCap": 3},
                          device="cpu")
    d2 = narrow.create_dataframe({"a": np.arange(5, dtype=np.int64)})
    f2 = narrow.create_dataframe({"a": np.arange(9, dtype=np.int64)})
    with pytest.raises(NotImplementedError, match="denseDomainCap.*6′"):
        f2.join(d2, "a").collect()
    default = tsrt.Session(device="cpu")
    d3 = default.create_dataframe({"a": np.arange(5, dtype=np.int64)})
    f3 = default.create_dataframe({"a": np.arange(9, dtype=np.int64)})
    with pytest.raises(NotImplementedError, match="denseMinProbeRows.*6′"):
        f3.join(d3, "a").collect()


def test_join_phases_plain_versions():
    """The plain versions of the three dense_join entry points on one
    crafted input: stats under the masks with the duplicate counted, the
    table, and the probe's selection and gathers for every join type."""
    keys = torch.tensor([5, 7, 7, 9, 4, 6], dtype=torch.int64)
    valid = torch.tensor([True, True, True, True, False, True])
    active = torch.tensor([True, True, True, True, True, False])
    assert tj.join_key_stats(keys, valid, active, 64).tolist() == [5, 9, 4, 1]
    uniq = active & (torch.arange(6) != 2)
    assert tj.join_key_stats(keys, valid, uniq, 64).tolist() == [5, 9, 3, 0]
    table = tj.build_join_table(keys, valid, uniq, 5, 5)
    assert table.tolist() == [0, -1, 1, -1, 3]
    probe = torch.tensor([9, 5, 8, 100, 7], dtype=torch.int32)
    pvalid = torch.tensor([True, True, True, True, False])
    pay = torch.arange(10, 16, dtype=torch.float64)
    pay_valid = torch.tensor([True, False, True, True, True, True])
    sel, cols = tj.probe_join(probe, None, None, 5, table,
                              [(pay, pay_valid), (keys, None)])
    assert sel.tolist() == [True, True, False, False, True]
    assert cols[0][0][sel].tolist() == [13.0, 10.0, 11.0]
    assert cols[0][1][sel].tolist() == [True, True, False]
    assert cols[1][1] is None and cols[1][0][sel].tolist() == [9, 5, 7]
    semi, none = tj.probe_join(probe, pvalid, None, 5, table, [], "semi")
    assert semi.tolist() == [True, True, False, False, False] and none == []
    anti, _ = tj.probe_join(probe, pvalid, None, 5, table, [], "anti")
    assert anti.tolist() == [False, False, True, True, True]
    left, cols = tj.probe_join(probe, pvalid, None, 5, table,
                               [(keys, None)], "left")
    assert left.tolist() == [True] * 5
    assert cols[0][1].tolist() == [True, True, False, False, False]
    assert cols[0][0].tolist() == [9, 5, 0, 0, 0]


def test_join_kernel_wrappers_refuse_cpu_tensors():
    keys = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA"):
        tj.dense_join_stats(keys, None, None, 8)
    with pytest.raises(ValueError, match="CUDA"):
        tj.dense_join_build(keys, None, None, 0, 1)
    with pytest.raises(ValueError, match="CUDA"):
        tj.dense_join_probe(keys, None, None, 0,
                            torch.full((1,), -1, dtype=torch.int32), [])
    with pytest.raises(ValueError, match="CUDA"):
        tj.csr_build_kernel(keys, None, None, 0, 1)
    with pytest.raises(ValueError, match="CUDA"):
        tj.csr_probe_kernel(keys, None, None, 0,
                            torch.zeros(1, dtype=torch.int32),
                            torch.zeros(2, dtype=torch.int64), "semi")
    with pytest.raises(ValueError, match="CUDA"):
        tj.csr_expand_kernel(torch.zeros(5, dtype=torch.int64),
                             torch.zeros(4, dtype=torch.int32),
                             torch.zeros(4, dtype=torch.int32), 0)
    with pytest.raises(ValueError, match="CUDA"):
        tj.csr_gather(keys, [(keys, None)], True)
    assert tj.dense_join_stats.launches == tj.dense_join_build.launches \
        == tj.dense_join_probe.launches == 0
    assert tj.csr_build_kernel.launches == tj.csr_probe_kernel.launches \
        == tj.csr_expand_kernel.launches == tj.csr_gather.launches == 0


def test_filters_above_a_join_push_down_like_the_reference(sessions):
    """A filter over the join: a one-side conjunct moves to its side, a
    range on the join key is mirrored onto the other side's key, and a
    disjunction across sides leaves each side the OR of its own branches
    (the disjunction itself stays above the join); the placement and the
    rows equal the reference's."""
    dim, fact = _dims(seed=14)

    def q(F, d, f):
        either = (((F.col("f_q") < 30) & (F.col("d_w") > 0.5))
                  | ((F.col("f_q") > 80) & (F.col("d_val") < 0)))
        return (f.join(d, [("f_key", "d_key")])
                 .where((F.col("f_key") < 1200) & (F.col("d_val") > -20)
                        & either))

    jrows, jf, jexp, trows, tf, texp = _rows(sessions, dim, fact, q)
    assert trows and sorted(trows, key=_key) == sorted(jrows, key=_key)
    assert texp.splitlines()[2:] == jexp.splitlines()[2:]
    lines = texp.splitlines()
    assert lines[2].startswith("* Filter [Or") and lines[3] == "  * Join inner"
    assert "LessThan[None](UnresolvedColumn[d_key]()" in texp  # mirrored
    assert sum("Or[None](LessThan[None](UnresolvedColumn[f_q]()" in ln
               for ln in lines[4:]) == 1  # the fact side's derived OR
    assert tf <= jf


# ---------------------------------------------------------------------------------
# Semi, anti and left outer joins; the CSR path for repeated build keys
# ---------------------------------------------------------------------------------

def _check_path(tsess, path: str) -> None:
    metrics = tsess.last_exec_context().metrics
    assert any(m.values.get(path) for m in metrics.values()), path


@pytest.mark.parametrize("how", ["semi", "anti", "left"])
@pytest.mark.parametrize("fact_filter", [False, True])
def test_dense_semi_anti_left_match_reference(sessions, how, fact_filter):
    """Unique build keys (a few null, a build-side filter), a probe side
    whose keys hit, miss and are null, with and without a probe-side
    filter: the dense path's semi, anti and left modes against the
    reference's ``_dense_join_pair``, rows exact, no more fetches."""
    dim, fact = _dims(seed=15)

    def q(F, d, f):
        d = d.where(F.col("d_val") > -30)
        if fact_filter:
            f = f.where(F.col("f_q") < 70)
        return f.join(d, [("f_key", "d_key")], how=how)

    jrows, jf, jexp, trows, tf, texp = _rows(sessions, dim, fact, q)
    assert trows and sorted(trows, key=_key) == sorted(jrows, key=_key)
    assert texp.splitlines()[2:] == jexp.splitlines()[2:]
    assert tf <= jf
    _check_path(sessions[1], "joinDensePath")


def _repeated(seed: int, n_build: int = 3000, n_probe: int = 4000,
              span: int = 60):
    """A build side whose int64 keys repeat heavily (``span`` values over
    ``n_build`` rows, some null) and a probe side whose keys hit, miss
    and are null; strings ride on both sides."""
    rng = np.random.default_rng(seed)
    bk = rng.integers(100, 100 + span, n_build).astype(object)
    bk[rng.random(n_build) < 0.05] = None
    build = {"b_key": bk, "b_val": rng.integers(-99, 99, n_build),
             "b_name": np.array([f"n{x % 13}" for x in range(n_build)]),
             "b_x": rng.normal(size=n_build)}
    pk = rng.integers(90, 100 + span + 10, n_probe).astype(object)
    pk[rng.random(n_probe) < 0.05] = None
    probe = {"p_key": pk, "p_q": rng.integers(0, 100, n_probe),
             "p_tag": np.array([f"t{x % 7}" for x in range(n_probe)])}
    return build, probe


@pytest.mark.parametrize("how", ["inner", "left", "semi", "anti"])
@pytest.mark.parametrize("case", ["repeated", "empty_build", "no_match"])
def test_csr_join_matches_reference(sessions, how, case):
    """Repeated build keys take the CSR path in both packages: counts and
    starts over the key domain, a stable build permutation, and for inner
    and left the expansion into gather maps.  Null keys on both sides, a
    probe-side filter, an empty build side and a probe side that matches
    nothing; string columns on both sides ride as dictionary codes."""
    build, probe = _repeated(seed=16)
    if case == "no_match":
        probe["p_key"] = np.where(probe["p_key"] == None, None,  # noqa: E711
                                  10_000 + np.arange(len(probe["p_key"])))

    def q(F, b, p):
        if case == "empty_build":
            b = b.where(F.col("b_val") > 1000)
        return (p.where(F.col("p_q") < 80)
                 .join(b, [("p_key", "b_key")], how=how))

    jrows, jf, jexp, trows, tf, texp = _rows(sessions, build, probe, q)
    assert sorted(trows, key=_key) == sorted(jrows, key=_key)
    assert texp.splitlines()[2:] == jexp.splitlines()[2:]
    assert tf <= jf
    if case == "repeated":
        assert trows
        _check_path(sessions[1], "joinCsrPath")


def test_csr_inner_join_with_the_left_side_building(sessions):
    """An inner join whose smaller side is on the left builds there: the
    CSR output lists the build side's columns first."""
    build, probe = _repeated(seed=17, n_build=500)

    def q(F, b, p):
        return b.join(p, [("b_key", "p_key")])

    jrows, jf, _, trows, tf, _ = _rows(sessions, build, probe, q)
    assert trows and sorted(trows, key=_key) == sorted(jrows, key=_key)
    assert tf <= jf


@pytest.mark.parametrize("kind", ["unique", "one_repeat", "all_repeat"])
def test_duplicate_count_is_exact(kind):
    """The stats' duplicate word is exact: n_valid minus the distinct live
    valid keys, under a validity and a live mask."""
    rng = np.random.default_rng(18)
    n = 2000
    keys = {"unique": rng.permutation(n) + 50,
            "one_repeat": np.concatenate([rng.permutation(n - 1) + 50,
                                          [60]]),
            "all_repeat": np.full(n, 77)}[kind].astype(np.int64)
    valid = rng.random(n) < 0.9
    active = rng.random(n) < 0.8
    valid[keys == 60] = active[keys == 60] = True  # both copies of 60 live
    live = keys[valid & active]
    want = [live.min(), live.max(), len(live), len(live) - len(
        np.unique(live))]
    got = tj.join_key_stats(torch.from_numpy(keys), torch.from_numpy(valid),
                            torch.from_numpy(active), 1 << 20)
    assert got.tolist() == want
    assert want[3] == {"unique": 0, "one_repeat": 1,
                       "all_repeat": len(live) - 1}[kind]


def test_csr_phases_plain_versions():
    """The CSR build groups live rows by slot in build order, the probe
    gives each row its range and count, and the expansion lists every
    (probe row, build row) pair, -1 for a left join's miss."""
    keys = torch.tensor([7, 5, 7, 9, 7, 5], dtype=torch.int64)
    valid = torch.tensor([True, True, True, True, False, True])
    counts, starts, b_perm = tj.csr_build(keys, valid, None, 5, 5)
    assert counts.tolist() == [2, 0, 2, 0, 1]
    assert starts.tolist() == [0, 2, 2, 4, 4, 5]
    assert b_perm[:5].tolist() == [1, 5, 0, 2, 3]
    probe = torch.tensor([7, 8, 5, 11], dtype=torch.int32)
    active = torch.tensor([True, True, True, False])
    lo, offsets = tj.csr_probe(probe, None, active, 5, counts, starts,
                               "left")
    assert lo.tolist() == [2, -1, 0, -1]
    assert offsets.tolist() == [0, 2, 3, 5, 5]
    pi, bi = tj.csr_expand(offsets, lo, b_perm, 5)
    assert pi.tolist() == [0, 0, 1, 2, 2]
    assert bi.tolist() == [0, 2, -1, 1, 5]
    assert tj.csr_probe(probe, None, active, 5, counts, starts,
                        "anti").tolist() == [False, True, False, False]
    out = tj.gather_rows(bi, [(keys, valid)], nullable=True)
    assert out[0][0].tolist() == [7, 7, 0, 5, 5]
    assert out[0][1].tolist() == [True, True, False, True, True]
