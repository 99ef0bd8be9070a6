"""Arithmetic over aggregate calls inside ``agg`` in the port
(``sql/dataframe.py _decompose_agg_exprs``) against the JAX reference's
DataFrame on the same numpy inputs: ratios, differences and literals over
aggregates, a repeated aggregate computed once, grouped and ungrouped
forms, through the single-pass and the partial/final aggregate, and the
two analysis errors with the reference's messages.  Rows compare as
multisets, floats within rel 1e-12 (the packages sum in different
orders); plans by their explain strings."""

import numpy as np
import pytest

import spark_rapids_tpu as jsrt
from spark_rapids_tpu.sql import functions as JF
import spark_rapids_tpu_torch as tsrt
from spark_rapids_tpu_torch.sql import functions as TF

REL = 1e-12
SPLIT = {"spark.rapids.tpu.sql.agg.singleProcessComplete": False}


def _key(row):
    return tuple((0, 0) if x is None else (1, x) for x in row)


def _same_rows(got, want):
    got, want = sorted(got, key=_key), sorted(want, key=_key)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(b, float) and a is not None:
                assert abs(a - b) <= REL * max(abs(b), 1e-300), (g, w)
            else:
                assert a == b, (g, w)


def _table(seed=20240607, n=3000):
    rng = np.random.default_rng(seed)
    w = rng.integers(-20, 20, n).astype(object)
    w[rng.random(n) < 0.05] = None
    return {"k": rng.integers(0, 23, n), "j": rng.integers(0, 3, n),
            "v": rng.uniform(0, 100, n), "w": w}


def _both(build, settings=None):
    """(reference DataFrame, port DataFrame) of ``build(df, F)``."""
    t = _table()
    jdf = jsrt.Session(dict(settings or {})).create_dataframe(t)
    tdf = tsrt.Session(dict(settings or {}), device="cpu").create_dataframe(t)
    return build(jdf, JF), build(tdf, TF)


def _compare(build, settings=None):
    jq, tq = _both(build, settings)
    _same_rows(tq.collect(), jq.collect())
    assert tq.columns == jq.columns
    assert tq.explain_string().splitlines()[2:] == \
        jq.explain_string().splitlines()[2:]
    return tq


def _ratios(df, F):
    return df.group_by("k").agg(
        (F.sum(F.col("v")) / F.count(F.col("w"))).alias("per"),
        (F.sum(F.col("w")) * 1.0 / F.count_star()).alias("mean_w"))


def _differences(df, F):
    return df.group_by("k", "j").agg(
        (F.max(F.col("v")) - F.min(F.col("v"))).alias("spread"),
        (F.max(F.col("w")) - F.min(F.col("w"))).alias("wspread"))


def _literals(df, F):
    return df.group_by("k").agg(
        (F.sum(F.col("v")) * 0.2).alias("fifth"),
        (F.lit(1.5) + F.avg(F.col("v")) * 2.0).alias("scaled"),
        F.count(F.col("w")).alias("n"))


def _repeated(df, F):
    return df.group_by("k").agg(
        F.max(F.col("v")).alias("mx"),
        (F.max(F.col("v")) - F.min(F.col("v"))).alias("spread"),
        (F.min(F.col("v")) + F.max(F.col("v"))).alias("both"))


def _grouping_column_in_expression(df, F):
    return df.group_by("k").agg(
        (F.sum(F.col("v")) + F.col("k")).alias("plus_key"))


def _ungrouped(df, F):
    return df.agg((F.sum(F.col("v")) / F.count_star()).alias("mean"),
                  (F.max(F.col("w")) - F.min(F.col("w"))).alias("spread"),
                  F.sum(F.col("w")).alias("s"))


CASES = [_ratios, _differences, _literals, _repeated,
         _grouping_column_in_expression, _ungrouped]


@pytest.mark.parametrize("build", CASES, ids=lambda f: f.__name__[1:])
def test_decomposed_aggregates_match_reference(build):
    _compare(build)


@pytest.mark.parametrize("build", CASES, ids=lambda f: f.__name__[1:])
def test_decomposed_aggregates_partial_final(build):
    _compare(build, SPLIT)


def test_repeated_aggregate_computed_once():
    tq = _compare(_repeated)
    agg = [ln for ln in tq.explain_string().splitlines()
           if "Aggregate" in ln][0]
    # mx, spread and both read one max and one min
    assert agg.strip().endswith("aggs=[__agg0, __agg1]")


def test_plain_calls_build_no_projection():
    _, tq = _both(lambda df, F: df.group_by("k").agg(
        F.sum(F.col("v")).alias("s")))
    assert tq.explain_string().splitlines()[2].lstrip("* ").startswith(
        "Aggregate")


@pytest.mark.parametrize("build", [
    lambda df, F: df.group_by("k").agg((F.col("v") * 2.0).alias("x")),
    lambda df, F: df.agg(F.lit(3).alias("three")),
], ids=["row_expression", "literal"])
def test_no_aggregate_raises_like_reference(build):
    msgs = []
    for df, F in zip((jsrt.Session({}).create_dataframe(_table(n=10)),
                      tsrt.Session({}, device="cpu").create_dataframe(
                          _table(n=10))), (JF, TF)):
        with pytest.raises(ValueError) as e:
            build(df, F)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert "at least one aggregate" in msgs[1]


def test_stray_column_raises_like_reference():
    msgs = []
    for df, F in zip((jsrt.Session({}).create_dataframe(_table(n=10)),
                      tsrt.Session({}, device="cpu").create_dataframe(
                          _table(n=10))), (JF, TF)):
        with pytest.raises(ValueError) as e:
            df.group_by("k").agg(
                (F.sum(F.col("v")) + F.col("w")).alias("bad"))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert "non-grouping column(s) ['w']" in msgs[1]
