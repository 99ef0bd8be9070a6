"""Joins through both packages' Sessions on the same numpy dicts: the
port's broadcast joins (dense, CSR and sorted paths) and its shuffled
sort-merge join with the runtime broadcast flip (plain PyTorch versions of
csrc/dense_join.cu, csr_join.cu, sort_join.cu and hashing.cu on the CPU)
against the JAX package's BroadcastJoinExec and SortMergeJoinExec.  Joins
without ORDER BY leave row order open, so rows compare as sorted lists;
values are exact (the joins move values, they compute none)."""

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
    """Left outer, semi and anti joins run (dense path here: unique build
    keys), and so does a full outer join, which broadcasts neither side
    and plans the shuffled join; all equal the reference."""
    jsess, tsess = sessions
    rows = []
    for sess in (jsess, tsess):
        d = sess.create_dataframe({"k": np.arange(5, dtype=np.int64),
                                   "w": np.arange(5, dtype=np.int64) * 7})
        f = sess.create_dataframe({"k": np.arange(10, dtype=np.int64)})
        rows.append(sorted(f.join(d, "k", how=how).collect(), key=_key))
    assert rows[1] == rows[0]
    assert len(rows[1]) == {"left": 10, "semi": 5, "anti": 5, "full": 10}[how]
    if how == "full":
        _check_path(tsess, "numOutputBatches")
        assert any(k.startswith("SortMergeJoinExec") for k in
                   tsess.last_exec_context().metrics)


def test_unported_join_shapes_raise(sessions):
    """The shapes that raised before the sorted broadcast path (row 6″) —
    two keys, a float key, a key domain over denseDomainCap, a probe
    estimated under denseMinProbeRows — now run and equal the reference;
    what is still queued (cross joins, the HOST and ICI shuffle
    transports) raises, naming its row or item."""
    jsess, tsess = sessions
    d = {"a": np.arange(5, dtype=np.int64), "b": np.arange(5, dtype=np.int64),
         "w": np.arange(5, dtype=np.float64)}
    f = {"a2": np.arange(9, dtype=np.int64) % 6,
         "b2": np.arange(9, dtype=np.int64) % 4,
         "x": np.arange(9, dtype=np.float64)}
    narrow = {**SETTINGS, "spark.rapids.tpu.join.denseDomainCap": 3}
    for settings, on, path in (
            (SETTINGS, [("a2", "a"), ("b2", "b")], "joinSortedPath"),
            (SETTINGS, [("x", "w")], "joinSortedPath"),
            (narrow, [("a2", "a")], "joinSortedPath"),
            ({}, [("a2", "a")], "joinSortedPath")):
        rows = []
        for sess in (jsrt.Session(settings),
                     tsrt.Session(settings, device="cpu")):
            rows.append(sorted(sess.create_dataframe(f).join(
                sess.create_dataframe(d), on).collect(), key=_key))
        assert rows[1] == rows[0] and rows[1], on
        _check_path(sess, path)
    d4 = tsess.create_dataframe(d)
    f4 = tsess.create_dataframe(f)
    with pytest.raises(NotImplementedError, match="cross join.*7′"):
        f4.cross_join(d4).collect()
    for mode in ("HOST", "ICI"):
        shuffled = tsrt.Session({
            "spark.rapids.tpu.sql.autoBroadcastJoinThreshold": -1,
            "spark.rapids.tpu.shuffle.mode": mode}, device="cpu")
        with pytest.raises(NotImplementedError, match="item 10"):
            shuffled.create_dataframe(f).join(
                shuffled.create_dataframe(d), [("a2", "a")]).collect()


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


# ---------------------------------------------------------------------------------
# The sorted path (row 6″), the shuffled join and its flip (row 7′)
# ---------------------------------------------------------------------------------

HOWS = ["inner", "left", "right", "full", "semi", "anti"]
SHUFFLED = {"spark.rapids.tpu.sql.batchSizeRows": 1024,
            "spark.rapids.tpu.sql.autoBroadcastJoinThreshold": 2000}


def _sides(seed: int, n_left: int = 900, n_right: int = 1300, span: int = 80):
    """Two sides whose int64 keys repeat on both, miss on both and are
    null on both, with a second key, a float key with -0.0/+0.0 and NaN,
    string keys and string payloads."""
    rng = np.random.default_rng(seed)

    def side(n, p):
        k = rng.integers(0, span, n).astype(object)
        k[rng.random(n) < 0.05] = None
        fk = rng.choice(np.array([-0.0, 0.0, 1.5, np.nan, -2.25, 7.0]), n)
        return {f"{p}k": k, f"{p}k2": rng.integers(0, 3, n).astype(np.int64),
                f"{p}f": fk,
                f"{p}s": np.array([f"s{x}" for x in rng.integers(0, 40, n)]),
                f"{p}v": rng.integers(-99, 99, n).astype(np.int64),
                f"{p}name": np.array([f"n{x % 11}" for x in range(n)])}
    return side(n_left, "l_"), side(n_right, "r_")


def _both(settings, left, right, q):
    """(reference rows, reference fetches, port rows, port fetches, port
    session) of ``q(F, left_df, right_df)``."""
    jsess = jsrt.Session(settings)
    tsess = tsrt.Session(settings, device="cpu")
    out = []
    for sess, F in ((jsess, JF), (tsess, TF)):
        df = q(F, sess.create_dataframe(left), sess.create_dataframe(right))
        with JStats.scoped() as st:
            rows = df.collect()
        fetches = st.blocking_fetches if sess is jsess \
            else sess.last_query_stats().blocking_fetches
        out += [sorted((_canon(r) for r in rows), key=repr), fetches]
    return out + [tsess]


def _canon(row):
    """A row with NaN as a marker, so rows holding NaN compare equal."""
    return tuple("NaN" if isinstance(x, float) and x != x else x
                 for x in row)


@pytest.mark.parametrize("aqe", [True, False])
@pytest.mark.parametrize("how", HOWS)
def test_shuffled_join_matches_reference(how, aqe):
    """No side fits the lowered threshold: both packages plan a sort-merge
    join over two shuffle exchanges.  With AQE on, a legal build side
    whose staged rows fit flips to a broadcast join (a full join has none
    and stays shuffled); with it off, 8 partition pairs join through the
    sorted match state.  Repeated, missing and null keys on both sides;
    rows equal the reference's at no more fetches."""
    left, right = _sides(21)
    settings = dict(SHUFFLED, **{"spark.rapids.tpu.sql.aqe.enabled": aqe,
                                 "spark.rapids.tpu.sql."
                                 "autoBroadcastJoinThreshold": 20000})

    def q(F, lf, rf):
        # estimated at half its 900 rows, the filtered left side keeps a
        # fifth: staged, it fits the threshold its estimate does not
        lf = lf.where(F.col("l_v") > 60)
        return lf.join(rf, [("l_k", "r_k")], how=how)

    jrows, jf, trows, tf, tsess = _both(settings, left, right, q)
    assert trows == jrows and trows
    assert tf <= jf
    # only inner and right joins may build the left side
    flipped = aqe and how in ("inner", "right")
    metrics = tsess.last_exec_context().metrics
    assert sum(m.values.get("aqeShuffleToBroadcast", 0)
               for m in metrics.values()) == int(flipped)
    if not flipped:
        assert sum(m.values.get("numOutputBatches", 0) for k, m in
                   metrics.items() if k.startswith("ShuffleExchange")) == 16


@pytest.mark.parametrize("how", HOWS)
@pytest.mark.parametrize("case", ["empty_left", "empty_right",
                                  "one_partition"])
def test_shuffled_join_edge_sides_match_reference(how, case):
    """An empty side (every partition empty) and keys that all hash to one
    partition (seven of eight partitions empty on both sides): the
    exchanges still yield 8 batches each and the pairs stay aligned."""
    left, right = _sides(22, 300, 400)
    if case == "one_partition":
        for side, p in ((left, "l_"), (right, "r_")):
            side[f"{p}k"] = np.where(side[f"{p}k"] == None, None,  # noqa
                                     7).astype(object)
    settings = dict(SHUFFLED, **{"spark.rapids.tpu.sql.aqe.enabled": False})

    def q(F, lf, rf):
        if case == "empty_left":
            lf = lf.where(F.col("l_v") > 1000)
        if case == "empty_right":
            rf = rf.where(F.col("r_v") > 1000)
        return lf.join(rf, [("l_k", "r_k")], how=how)

    jrows, jf, trows, tf, tsess = _both(settings, left, right, q)
    assert trows == jrows
    assert tf <= jf


@pytest.mark.parametrize("key", ["two_keys", "float", "string"])
def test_multi_key_float_and_string_shuffled_joins(key):
    """Two keys (int64, int64), a float key (-0.0 = +0.0, NaN = NaN) and a
    string key, whose codes must come from one dictionary shared by both
    exchanges and the join.  (A full join's rows hold the inner join's;
    the reference compiles a float key's programs slowly, so it runs one
    join type.)"""
    left, right = _sides(23)
    settings = dict(SHUFFLED, **{"spark.rapids.tpu.sql.aqe.enabled": False})
    on = {"two_keys": [("l_k", "r_k"), ("l_k2", "r_k2")],
          "float": [("l_f", "r_f")], "string": [("l_s", "r_s")]}[key]
    for how in (("full",) if key == "float" else ("inner", "full", "anti")):
        jrows, jf, trows, tf, _ = _both(
            settings, left, right,
            lambda F, lf, rf: lf.join(rf, on, how=how))
        assert trows == jrows, how
        assert trows or how == "anti", how
        assert tf <= jf


@pytest.mark.parametrize("how", ["full", "right", "inner"])
def test_using_keys_coalesce_in_right_and_full_joins(how):
    """A USING join keeps one key column; in right and full joins it is
    the left value where there is one, else the right (null only where
    both are)."""
    left, right = _sides(24, 200, 300)
    for settings in (SHUFFLED, {"spark.rapids.tpu.sql.batchSizeRows": 1024}):
        for on in (["k"], ["s"], ["k", "s"]):
            lt = {"k": left["l_k"], "s": left["l_s"], "lv": left["l_v"]}
            rt = {"k" if "k" in on else "rk": right["r_k"],
                  "s" if "s" in on else "rs": right["r_s"],
                  "rv": right["r_v"]}
            jrows, jf, trows, tf, _ = _both(
                settings, lt, rt,
                lambda F, lf, rf: lf.join(rf, on, how=how))
            assert trows == jrows and trows, (on, settings)
            assert tf <= jf


@pytest.mark.parametrize("how", HOWS)
def test_oversized_partition_pairs_split_by_xxhash64(how):
    """Pairs over batchSizeRows split into subPartitions sub-pairs by
    xxhash64 of the keys; equal keys still meet, so rows equal the
    reference's."""
    left, right = _sides(25, 1500, 1800, span=400)
    settings = {"spark.rapids.tpu.sql.batchSizeRows": 256,
                "spark.rapids.tpu.sql.autoBroadcastJoinThreshold": 2000,
                "spark.rapids.tpu.sql.aqe.enabled": False,
                "spark.rapids.tpu.sql.join.subPartitions": 4}
    jrows, jf, trows, tf, tsess = _both(
        settings, left, right,
        lambda F, lf, rf: lf.join(rf, [("l_k", "r_k")], how=how))
    assert trows == jrows and trows
    metrics = tsess.last_exec_context().metrics
    assert sum(m.values.get("subPartitionedPairs", 0)
               for m in metrics.values()) > 0


def test_flip_reads_the_exact_size_only_when_the_bound_does_not_fit():
    """``staged_fits`` bounds the staged rows by their count first: a
    threshold the bound fits costs no fetch, one only the exact live count
    fits costs one, as does one neither fits; and a query whose staged
    bound fits flips at no more fetches than the same join planned as a
    broadcast."""
    from spark_rapids_tpu_torch.batch import ColumnBatch, DeviceColumn, \
        Field, Schema
    from spark_rapids_tpu_torch.config import TpuConf
    from spark_rapids_tpu_torch.plan.exchange_exec import ShuffleExchangeExec
    from spark_rapids_tpu_torch.plan.physical import ExecContext, TpuExec
    from spark_rapids_tpu_torch.utils.metrics import QueryStats
    from spark_rapids_tpu_torch import types as T

    schema = Schema([Field("k", T.INT64, False)])
    sel = torch.arange(1000) % 4 == 0

    class Batches(TpuExec):
        output_schema = schema

        def execute(self, ctx):
            yield ColumnBatch(schema, [DeviceColumn(
                T.INT64, torch.arange(1000))], 1000)
            yield ColumnBatch(schema, [DeviceColumn(
                T.INT64, torch.arange(1000))], 1000, sel)

    ctx = ExecContext(TpuConf(), torch.device("cpu"))
    for threshold, fits, fetches in ((16000, True, 0), (10000, True, 1),
                                     (9000, False, 1)):
        ex = ShuffleExchangeExec(Batches(), [], 8, {})
        with QueryStats.scoped() as st:
            assert ex.staged_fits(ctx, threshold) == fits
        assert st.blocking_fetches == fetches, threshold

    left, right = _sides(26, 2000, 2500)

    def q(F, lf, rf):
        # both sides are bare scans: estimated at their tables' full row
        # width, staged at the columns the query keeps
        return lf.join(rf, [("l_k", "r_k")]).select("l_k", "l_name", "r_v")

    # the flipped join knows no probe estimate, so the dense gate's
    # denseMinProbeRows does not apply to it: take it off the planned one
    base = {"spark.rapids.tpu.sql.batchSizeRows": 1024,
            "spark.rapids.tpu.join.denseMinProbeRows": 0}
    out = {}
    for name, threshold in (("flip", 100_000), ("broadcast", 1 << 30)):
        settings = dict(base, **{
            "spark.rapids.tpu.sql.autoBroadcastJoinThreshold": threshold})
        jrows, jf, trows, tf, tsess = _both(
            settings, {"l_k": left["l_k"], "l_name": left["l_name"],
                       **{f"l_x{i}": left["l_v"] for i in range(4)}},
            right, q)
        assert trows == jrows and trows and tf <= jf
        metrics = tsess.last_exec_context().metrics
        out[name] = (sum(m.values.get("aqeShuffleToBroadcast", 0)
                         for m in metrics.values()), tf)
    assert out["flip"][0] == 1 and out["broadcast"][0] == 0
    assert out["flip"][1] == out["broadcast"][1]


def _reference_node(settings, left, right, on, cls):
    from spark_rapids_tpu.plan import join_exec as RJ
    js = jsrt.Session(settings)
    df = js.create_dataframe(left).join(js.create_dataframe(right), on)

    def find(n):
        if isinstance(n, getattr(RJ, cls)):
            return n
        for c in list(getattr(n, "children", None) or []) + [
                getattr(n, "root", None)]:
            if c is not None and (r := find(c)) is not None:
                return r
        return None
    return find(js._plan_physical(df._plan))


@pytest.mark.parametrize("key", ["int64", "int32", "float64", "float32",
                                 "two_keys"])
def test_sorted_match_state_matches_reference(key):
    """sort_join's plain version against the reference's match state on the
    same build and probe: matches and b_perm exact and lo exact wherever a
    row matches (the single-key sorted broadcast path, ``_match_state``
    :932); for two keys the reference's union kernel orders groups by hash,
    so each probe row's matched build rows (b_perm[lo:lo + matches]) must
    be the same rows in the same order."""
    from spark_rapids_tpu.batch import from_numpy as jfrom_numpy
    rng = np.random.default_rng(27)
    nb, npr = 700, 900
    if key.startswith("float"):
        vals = np.array([-0.0, 0.0, np.nan, 1.5, -3.0, np.inf, -np.inf,
                         1e-310 if key == "float64" else 1e-40, 2.5],
                        dtype=key)
        bk = rng.choice(vals, nb)
        pk = rng.choice(np.append(vals, np.array([99.5], dtype=key)), npr)
    else:
        dt = np.int32 if key == "int32" else np.int64
        bk = rng.integers(-50, 50, nb).astype(dt)
        pk = rng.integers(-60, 60, npr).astype(dt)
    build = {"bk": bk, "bk2": rng.integers(0, 3, nb).astype(np.int64)}
    probe = {"pk": pk, "pk2": rng.integers(0, 3, npr).astype(np.int64)}
    on = [("pk", "bk")] + ([("pk2", "bk2")] if key == "two_keys" else [])
    settings = {"spark.rapids.tpu.join.denseMinProbeRows": 10**9,
                "spark.rapids.tpu.sql.autoBroadcastJoinThreshold":
                    -1 if key == "two_keys" else 1 << 30}
    node = _reference_node(settings, probe, build, on,
                           "SortMergeJoinExec" if key == "two_keys"
                           else "BroadcastJoinExec")
    lo_r, m_r, perm_r = (np.asarray(x) for x in node._match_state(
        jfrom_numpy(probe), jfrom_numpy(build), probe_side=0))
    keys = [("bk", "pk")] + ([("bk2", "pk2")] if key == "two_keys" else [])
    state = tj.sorted_build([(torch.from_numpy(build[b]), None)
                             for b, _ in keys], None)
    lo, m, _ = tj.sorted_probe([(torch.from_numpy(probe[p]), None)
                                for _, p in keys], None, state, "inner")
    lo, m, perm = lo.numpy(), m.numpy(), state.b_perm.numpy()
    np.testing.assert_array_equal(m, m_r[:npr])
    hit = m > 0
    assert hit.any() and not hit.all()
    if key == "two_keys":
        for i in np.flatnonzero(hit):
            np.testing.assert_array_equal(perm[lo[i]:lo[i] + m[i]],
                                          perm_r[lo_r[i]:lo_r[i] + m[i]])
    else:
        np.testing.assert_array_equal(lo[hit], lo_r[:npr][hit])
        nv = int(state.n_valid[0])
        np.testing.assert_array_equal(perm[:nv], perm_r[:nv])


def test_sorted_phases_plain_versions():
    """The sorted build under a validity and a live mask, every probe mode,
    and the unmatched build rows of a full join."""
    keys = torch.tensor([7, 5, 7, 9, 7, 5, 3], dtype=torch.int64)
    valid = torch.tensor([True, True, True, True, False, True, True])
    active = torch.tensor([True, True, True, True, True, True, False])
    st = tj.sorted_build([(keys, valid)], active)
    assert int(st.n_valid[0]) == 5
    assert st.b_perm.tolist()[:5] == [1, 5, 0, 2, 3]
    assert st.words[0, :5].tolist() == [5, 5, 7, 7, 9]
    probe = torch.tensor([7, 8, 5, 11, 9], dtype=torch.int32)
    pact = torch.tensor([True, True, True, False, True])
    lo, m, offsets = tj.sorted_probe([(probe, None)], pact, st, "full")
    assert lo.tolist() == [2, -1, 0, -1, 4] and m.tolist() == [2, 0, 2, 0, 1]
    assert offsets.tolist() == [0, 2, 3, 5, 5, 6]
    assert tj.sorted_probe([(probe, None)], pact, st, "inner")[2].tolist() \
        == [0, 2, 2, 4, 4, 5]
    assert tj.sorted_probe([(probe, None)], pact, st, "semi")[2].tolist() \
        == [True, False, True, False, True]
    assert tj.sorted_probe([(probe, None)], pact, st, "anti")[2].tolist() \
        == [False, True, False, False, False]
    mask, count = tj.unmatched_build_mask(lo, m, st, active)
    assert mask.tolist() == [False] * 4 + [True, False, False]
    assert count.tolist() == [1]
    fl = torch.tensor([-0.0, float("nan"), 0.0, 1e-310, 2.0],
                      dtype=torch.float64)
    st = tj.sorted_build([(fl, None)], None)
    _, m, _ = tj.sorted_probe([(torch.tensor([0.0, float("nan")],
                                             dtype=torch.float64), None)],
                              None, st, "inner")
    assert m.tolist() == [3, 1]  # -0.0, +0.0 and the subnormal; one NaN


def test_sorted_join_kernel_wrappers_refuse_cpu_tensors():
    keys = [(torch.zeros(4, dtype=torch.int64), None)]
    st = tj.sorted_build(keys, None)
    with pytest.raises(ValueError, match="CUDA"):
        tj.sorted_build_kernel(keys, None)
    with pytest.raises(ValueError, match="CUDA"):
        tj.sorted_probe_kernel(keys, None, st, "inner")
    with pytest.raises(ValueError, match="CUDA"):
        tj.unmatched_build_kernel(torch.zeros(4, dtype=torch.int32),
                                  torch.zeros(4, dtype=torch.int32), st, None)
    with pytest.raises(ValueError, match="CUDA"):
        tj.partition_perm_kernel(torch.zeros(4, dtype=torch.int32), 8)
    assert tj.sorted_build_kernel.launches == \
        tj.sorted_probe_kernel.launches == \
        tj.unmatched_build_kernel.launches == \
        tj.partition_perm_kernel.launches == 0


@pytest.mark.parametrize("how", ["right", "full"])
def test_filters_above_outer_joins_stay_like_the_reference(how):
    """A conjunct over a side that a right or full join null-extends stays
    above the join (pushing it would drop the null-extended rows' filter
    and keep rows it removes); the filters' placement and the rows equal
    the reference's.  (The reference prunes an unnarrowed scan under a
    filter with a Project; the port narrows the scan itself.)"""
    left, right = _sides(28, 300, 400)

    def q(F, lf, rf):
        return (lf.join(rf, [("l_k", "r_k")], how=how)
                  .where((F.col("l_v") > 0) & (F.col("r_v") < 50))
                  .select("l_k", "l_v", "r_v"))

    settings = {"spark.rapids.tpu.sql.batchSizeRows": 1024}
    jrows, jf, trows, tf, _ = _both(settings, left, right, q)
    assert trows == jrows and trows
    assert tf <= jf
    jsess, tsess = jsrt.Session(settings), tsrt.Session(settings, device="cpu")
    exps = [[ln.strip() for ln in q(
        F, s.create_dataframe(left), s.create_dataframe(right))
        .explain_string().splitlines() if "Filter" in ln or "Join" in ln]
        for s, F in ((jsess, JF), (tsess, TF))]
    assert exps[1] == exps[0]
    assert exps[1][0].startswith("* Filter") and exps[1][1].startswith(
        "* Join")
