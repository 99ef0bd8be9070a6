"""Scalar and IN/NOT-IN subqueries of the port (``plan/subquery.py``)
against the JAX reference's: the cases of ``tests/test_subquery_dpp.py``
(scalar, IN, NOT IN with its null semantics, IN inside an OR as an
existence join) built the same way in both packages over the same numpy
inputs, and the subquery forms of TPC-H Q18 (IN), Q16 (NOT IN) and Q22
(a scalar subquery) at SF 0.01 against the explicit forms, the reference
and the numpy oracles.  Rows are compared exactly (floats within rel
1e-12: the packages sum in different orders); the port makes no more
blocking fetches than the reference for the same plan, subqueries
included.  The port runs on the CPU (its kernels' plain versions).  The
DPP cases wait for a file scan (ROADMAP queue 2 row 15)."""

import numpy as np
import pytest

import spark_rapids_tpu as jsrt
from spark_rapids_tpu.sql import functions as JF
from spark_rapids_tpu.utils.metrics import QueryStats as JStats
import spark_rapids_tpu_torch as tsrt
from spark_rapids_tpu_torch.models import tpch
from spark_rapids_tpu_torch.sql import functions as TF
from spark_rapids_tpu_torch.utils.metrics import QueryStats as TStats

REL = 1e-12
DB_SF = 0.01
SETTINGS = {"spark.rapids.tpu.sql.batchSizeRows": 16384,
            "spark.rapids.tpu.join.denseMinProbeRows": 0}


def _key(row):
    return tuple((0, 0) if x is None else (1, x) for x in row)


def _same_rows(got, want, ordered=True):
    if not ordered:
        got, want = sorted(got, key=_key), sorted(want, key=_key)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(b, float) and a is not None:
                assert abs(a - b) <= REL * max(abs(b), 1e-300), (g, w)
            else:
                assert a == b, (g, w)


def _both(build, settings=None):
    """``build(session, functions)`` in both packages: (reference rows,
    reference fetches, port rows, port fetches)."""
    jsess = jsrt.Session(settings or {})
    tsess = tsrt.Session(settings or {}, device="cpu")
    with JStats.scoped() as js:
        jrows = build(jsess, JF).collect()
    with TStats.scoped() as ts:
        trows = build(tsess, TF).collect()
    return jrows, js.blocking_fetches, trows, ts.blocking_fetches


def _uniform(seed, n, hi):
    return np.random.default_rng(seed).uniform(0, hi, n)


def _filter_by_scalar(s, F):
    df = s.create_dataframe({"k": np.arange(100, dtype=np.int64),
                             "v": _uniform(1, 100, 100.0)})
    avg = F.scalar_subquery(df.agg(F.avg(F.col("v")).alias("a")))
    return df.filter(F.col("v") > avg)


def _scalar_in_projection(s, F):
    df = s.create_dataframe({"v": _uniform(2, 50, 10.0)})
    mx = F.scalar_subquery(df.agg(F.max(F.col("v")).alias("m")))
    return df.select((F.col("v") / mx).alias("frac"))


def _nested_scalar(s, F):
    df = s.create_dataframe({"v": _uniform(3, 64, 10.0)})
    inner = F.scalar_subquery(df.agg(F.min(F.col("v")).alias("m")))
    mid = df.filter(F.col("v") > inner)
    outer = F.scalar_subquery(mid.agg(F.avg(F.col("v")).alias("a")))
    return df.filter(F.col("v") > outer).agg(F.count_star().alias("n"))


def _empty_scalar_is_null(s, F):
    df = s.create_dataframe({"v": np.array([1.0, 2.0])})
    none = df.filter(F.col("v") > 100.0)
    mx = F.scalar_subquery(none.agg(F.max(F.col("v")).alias("m")))
    return df.filter(F.col("v") > mx)


def _scalar_in_aggregate(s, F):
    df = s.create_dataframe({"k": np.arange(40, dtype=np.int64) % 7,
                             "v": _uniform(4, 40, 5.0)})
    mx = F.scalar_subquery(df.agg(F.max(F.col("v")).alias("m")))
    return df.group_by("k").agg(F.sum(F.col("v") / mx).alias("s")) \
        .sort("k")


SCALAR_CASES = {"filter_by_scalar": _filter_by_scalar,
                "scalar_in_projection": _scalar_in_projection,
                "nested_scalar": _nested_scalar,
                "empty_scalar_is_null": _empty_scalar_is_null,
                "scalar_in_aggregate": _scalar_in_aggregate}


@pytest.mark.parametrize("case", sorted(SCALAR_CASES))
def test_scalar_subquery_matches_reference(case):
    jrows, jf, trows, tf = _both(SCALAR_CASES[case])
    _same_rows(trows, jrows, ordered=False)
    assert tf <= jf
    if case == "empty_scalar_is_null":
        assert trows == []  # a NULL comparison keeps no row


def test_multi_row_scalar_raises():
    s = tsrt.Session(device="cpu")
    df = s.create_dataframe({"v": np.array([1.0, 2.0])})
    bad = TF.scalar_subquery(df.select("v"))
    with pytest.raises(ValueError, match="scalar subquery"):
        df.filter(TF.col("v") > bad).collect()


def _in_tables(s, sub_keys, n=300, seed=5, hi=50):
    rng = np.random.default_rng(seed)
    df = s.create_dataframe({"k": rng.integers(0, hi, n),
                             "v": rng.uniform(0, 1, n)})
    keys = np.empty(len(sub_keys), dtype=object)
    keys[:] = sub_keys
    sub = s.create_dataframe({"sk": keys})
    return df, sub


IN_KEYS = [1, 5, 9, 13, 44]


def _in_semi(s, F):
    df, sub = _in_tables(s, IN_KEYS)
    return df.filter(F.col("k").isin_subquery(sub.select("sk")))


def _not_in_anti(s, F):
    df, sub = _in_tables(s, IN_KEYS)
    return df.filter(~F.col("k").isin_subquery(sub.select("sk")))


def _not_in_with_null(s, F):
    df, sub = _in_tables(s, IN_KEYS + [None])
    return df.filter(~F.col("k").isin_subquery(sub.select("sk")))


def _not_in_empty(s, F):
    df, sub = _in_tables(s, IN_KEYS)
    none = sub.filter(F.col("sk") > 1000).select("sk")
    return df.filter(~F.col("k").isin_subquery(none))


def _in_with_extra_conjunct(s, F):
    df, sub = _in_tables(s, IN_KEYS)
    return df.filter(F.col("k").isin_subquery(sub.select("sk"))
                     & (F.col("v") > 0.5))


def _not_in_large(s, F):
    # past 1,024 distinct values: a null-aware anti join, not a literal list
    df, sub = _in_tables(s, list(range(0, 4000, 3)), n=2000, hi=4000)
    return df.filter(~F.col("k").isin_subquery(sub.select("sk")))


def _not_in_null_probe_keys(s, F):
    k = np.empty(6, dtype=object)
    k[:] = [1, None, 2, 3, None, 9]
    df = s.create_dataframe({"k": k})
    sub = s.create_dataframe({"sk": np.array([2, 7], dtype=np.int64)})
    return df.filter(~F.col("k").isin_subquery(sub))


def _in_inside_or(s, F):
    rng = np.random.default_rng(6)
    df = s.create_dataframe({"k": rng.integers(0, 40, 300),
                             "v": rng.uniform(0, 1, 300)})
    sub = s.create_dataframe({"sk": np.array([3, 7, 11], dtype=np.int64)})
    return df.filter(F.col("k").isin_subquery(sub.select("sk"))
                     | (F.col("v") > 0.9))


def _two_in_subqueries_in_or(s, F):
    rng = np.random.default_rng(7)
    df = s.create_dataframe({"a": rng.integers(0, 30, 200),
                             "b": rng.integers(0, 30, 200)})
    s1 = s.create_dataframe({"x": np.array([1, 2], dtype=np.int64)})
    s2 = s.create_dataframe({"y": np.array([25, 28], dtype=np.int64)})
    return df.filter(F.col("a").isin_subquery(s1)
                     | F.col("b").isin_subquery(s2))


IN_CASES = {"in_semi": _in_semi, "not_in_anti": _not_in_anti,
            "not_in_with_null": _not_in_with_null,
            "not_in_empty": _not_in_empty,
            "in_with_extra_conjunct": _in_with_extra_conjunct,
            "not_in_large": _not_in_large,
            "not_in_null_probe_keys": _not_in_null_probe_keys,
            "in_inside_or": _in_inside_or,
            "two_in_subqueries_in_or": _two_in_subqueries_in_or}


@pytest.mark.parametrize("case", sorted(IN_CASES))
def test_in_subquery_matches_reference(case):
    jrows, jf, trows, tf = _both(IN_CASES[case])
    _same_rows(trows, jrows, ordered=False)
    assert tf <= jf
    if case == "not_in_with_null":
        assert trows == []  # NOT IN over a set with a NULL keeps no row
    if case == "not_in_null_probe_keys":
        assert sorted(trows) == [(1,), (3,), (9,)]
    if case in ("in_inside_or", "two_in_subqueries_in_or"):
        assert all(len(r) == 2 for r in trows)  # the exists column drops


def test_in_subquery_plans_as_the_reference():
    """The resolved plans explain the same: a semi join, and an existence
    join under a Project for an IN inside an OR."""
    from spark_rapids_tpu.plan.subquery import resolve_subqueries as jres
    from spark_rapids_tpu_torch.plan.subquery import \
        resolve_subqueries as tres
    for case in (_in_semi, _in_inside_or, _not_in_large):
        jsess = jsrt.Session()
        tsess = tsrt.Session(device="cpu")
        jdf, tdf = case(jsess, JF), case(tsess, TF)
        jplan = jres(jdf._plan, jsess._collect_rows)
        tplan = tres(tdf._plan, tsess._collect_rows)
        from spark_rapids_tpu.plan.overrides import explain_plan as jexp
        from spark_rapids_tpu_torch.plan.overrides import \
            explain_plan as texp
        assert texp(tplan).splitlines()[2:] == \
            jexp(jplan).splitlines()[2:]


def test_negated_in_disjunction_raises():
    s = tsrt.Session(device="cpu")
    df = s.create_dataframe({"k": np.arange(10, dtype=np.int64)})
    sub = s.create_dataframe({"s": np.array([1], dtype=np.int64)})
    with pytest.raises(NotImplementedError, match="negated IN"):
        df.filter((~TF.col("k").isin_subquery(sub))
                  | (TF.col("k") > 100)).collect()


def test_in_subquery_outside_a_filter_raises():
    s = tsrt.Session(device="cpu")
    df = s.create_dataframe({"k": np.arange(10, dtype=np.int64)})
    sub = s.create_dataframe({"s": np.array([1], dtype=np.int64)})
    with pytest.raises(NotImplementedError, match="top-level filter"):
        df.select(TF.col("k").isin_subquery(sub).alias("x")).collect()


def test_in_subquery_reaches_the_device_path():
    """to_device_arrays resolves subqueries too (reference session.py:525)."""
    s = tsrt.Session(device="cpu")
    df, sub = _in_tables(s, IN_KEYS)
    out = df.filter(TF.col("k").isin_subquery(sub.select("sk"))) \
        .to_device_arrays()
    k = np.random.default_rng(5).integers(0, 50, 300)
    assert sorted(out["k"][0].tolist()) == sorted(
        x for x in k.tolist() if x in IN_KEYS)


@pytest.fixture(scope="module")
def db():
    return tpch.gen_db_arrays(DB_SF)


# subquery form, its explicit form, the tables, the oracle
FORMS = {"q18_in": ("q18", ("orders", "lineitem", "customer")),
         "q16_notin": ("q16", ("partsupp", "supplier", "part")),
         "q22_scalar": ("q22", ("customer", "orders"))}


@pytest.mark.parametrize("form", sorted(FORMS))
def test_subquery_form_matches_explicit_reference_and_oracle(db, form):
    explicit, tables = FORMS[form]
    jsess = jsrt.Session(SETTINGS)
    tsess = tsrt.Session(SETTINGS, device="cpu")
    body = getattr(tpch, form)
    with JStats.scoped() as js:
        jrows = body(*(jsess.create_dataframe(db[t]) for t in tables),
                     functions=JF).collect()
    with TStats.scoped() as ts:
        trows = body(*(tsess.create_dataframe(db[t])
                       for t in tables)).collect()
    plain = getattr(tpch, explicit)(*(tsess.create_dataframe(db[t])
                                      for t in tables)).collect()
    want = getattr(tpch, f"{explicit}_numpy")(*(db[t] for t in tables))
    _same_rows(trows, jrows)
    _same_rows(trows, want)
    _same_rows(trows, plain)
    assert len(trows) > 0 or form == "q22_scalar"
    assert ts.blocking_fetches <= js.blocking_fetches
