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
    _, tsess = sessions
    d = tsess.create_dataframe({"k": np.array([1, 2, 2, 3], dtype=np.int64)})
    f = tsess.create_dataframe({"k2": np.arange(10, dtype=np.int64)})
    with pytest.raises(NotImplementedError, match="repeats a key.*6′"):
        f.join(d, [("k2", "k")]).collect()


@pytest.mark.parametrize("how", ["left", "semi", "anti", "full"])
def test_joins_other_than_inner_raise(sessions, how):
    _, tsess = sessions
    d = tsess.create_dataframe({"k": np.arange(5, dtype=np.int64)})
    f = tsess.create_dataframe({"k": np.arange(10, dtype=np.int64)})
    with pytest.raises(NotImplementedError, match="row 7"):
        f.join(d, "k", how=how).collect()


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
    crafted input: stats under the masks, a duplicate counted, the probe's
    selection and gathers."""
    keys = torch.tensor([5, 7, 7, 9, 4, 6], dtype=torch.int64)
    valid = torch.tensor([True, True, True, True, False, True])
    active = torch.tensor([True, True, True, True, True, False])
    assert tj.join_key_stats(keys, valid, active).tolist() == [5, 9, 4]
    table, dup = tj.build_join_table(keys, valid, active, 5, 5)
    assert int(dup[0]) == 1
    assert table[[0, 1, 3, 4]].tolist() == [0, -1, -1, 3]
    assert int(table[2]) in (1, 2)
    table, dup = tj.build_join_table(keys, valid, active & (torch.arange(6)
                                                            != 2), 5, 5)
    assert int(dup[0]) == 0
    probe = torch.tensor([9, 5, 8, 100, 7], dtype=torch.int32)
    pay = torch.arange(10, 16, dtype=torch.float64)
    pay_valid = torch.tensor([True, False, True, True, True, True])
    sel, cols = tj.probe_join(probe, None, None, 5, table,
                              [(pay, pay_valid), (keys, None)])
    assert sel.tolist() == [True, True, False, False, True]
    assert cols[0][0][sel].tolist() == [13.0, 10.0, 11.0]
    assert cols[0][1][sel].tolist() == [True, True, False]
    assert cols[1][1] is None and cols[1][0][sel].tolist() == [9, 5, 7]


def test_join_kernel_wrappers_refuse_cpu_tensors():
    keys = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA"):
        tj.dense_join_stats(keys, None, None)
    with pytest.raises(ValueError, match="CUDA"):
        tj.dense_join_build(keys, None, None, 0, 1)
    with pytest.raises(ValueError, match="CUDA"):
        tj.dense_join_probe(keys, None, None, 0,
                            torch.full((1,), -1, dtype=torch.int32), [])
    assert tj.dense_join_stats.launches == tj.dense_join_build.launches \
        == tj.dense_join_probe.launches == 0


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
