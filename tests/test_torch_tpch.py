"""TPC-H Q6 and Q1 end to end through both packages' Sessions on the same
numpy dict: ~50k rows in 8192-row batches, so every aggregate accumulates
across batches.  Keys and counts exact; float64 within rel 1e-9, because
the two packages sum in different orders.  The port runs on the CPU here
(its kernels' plain versions)."""

import datetime

import numpy as np
import pytest

import spark_rapids_tpu as jsrt
from spark_rapids_tpu.models import tpch as jtpch
from spark_rapids_tpu.sql import functions as JF
from spark_rapids_tpu.utils.metrics import QueryStats as JStats
import spark_rapids_tpu_torch as tsrt
from spark_rapids_tpu_torch.models import tpch
from spark_rapids_tpu_torch.sql import functions as TF

SETTINGS = {"spark.rapids.tpu.sql.batchSizeRows": 8192}
REL = 1e-9


@pytest.fixture(scope="module")
def data():
    return tpch.gen_lineitem_arrays(0, rows=50_000)


@pytest.fixture(scope="module")
def sessions():
    return jsrt.Session(SETTINGS), tsrt.Session(SETTINGS, device="cpu")


def _run_both(sessions, data, jq, tq):
    """(reference rows, reference syncs, port rows, port syncs, explains)"""
    jsess, tsess = sessions
    jdf = jq(jsess.create_dataframe(data))
    with JStats.scoped() as st:
        jrows = jdf.collect()
    tdf = tq(tsess.create_dataframe(data))
    trows = tdf.collect()
    return (jrows, st.blocking_fetches, trows,
            tsess.last_query_stats().blocking_fetches,
            jdf.explain_string(), tdf.explain_string())


def _assert_rows_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(b, float) and a is not None:
                assert abs(a - b) <= REL * max(abs(b), 1e-300), (g, w)
            else:
                assert a == b, (g, w)


def _placement(explain: str):
    return explain.splitlines()[2:]


@pytest.mark.parametrize("query", ["q6", "q1"])
def test_query_matches_reference(sessions, data, query):
    jq, tq = getattr(jtpch, query), getattr(tpch, query)
    jrows, jsyncs, trows, tsyncs, jexp, texp = _run_both(sessions, data,
                                                         jq, tq)
    _assert_rows_close(trows, jrows)
    assert _placement(texp) == _placement(jexp)
    assert tsyncs <= jsyncs


def test_queries_match_numpy_oracles(sessions, data):
    _, tsess = sessions
    df = tsess.create_dataframe(data)
    got6 = tpch.q6(df).collect()
    assert abs(got6[0][0] - tpch.q6_numpy(data)) <= REL * tpch.q6_numpy(data)
    _assert_rows_close(tpch.q1(df).collect(), tpch.q1_numpy(data))


def test_q6_with_no_qualifying_row_is_null(sessions, data):
    def q(F):
        def run(df):
            return (df.where(F.col("l_quantity") < 0)
                      .agg(F.sum(F.col("l_extendedprice")
                                 * F.col("l_discount")).alias("revenue"),
                           F.count_star().alias("n")))
        return run
    jrows, _, trows, _, _, _ = _run_both(sessions, data, q(JF), q(TF))
    assert jrows == trows == [(None, 0)]


def _nulls_dict():
    rng = np.random.default_rng(3)
    n = 3000
    k = rng.choice(np.array(["x", "y", "z"], dtype=object), n)
    k[rng.random(n) < 0.1] = None
    v = rng.normal(size=n).astype(object)
    v[rng.random(n) < 0.2] = None
    w = rng.integers(-50, 50, n).astype(object)
    w[rng.random(n) < 0.3] = None
    day = np.datetime64("1995-01-01") + rng.integers(0, 100, n).astype(
        "timedelta64[D]")
    return {"k": k, "v": v, "w": w, "day": day}


def test_null_keys_and_values_match_reference(sessions):
    data = _nulls_dict()
    cut = datetime.date(1995, 3, 1)

    def q(F):
        def run(df):
            return (df.where(F.col("day") < cut)
                      .group_by("k")
                      .agg(F.sum(F.col("v")).alias("sv"),
                           F.avg(F.col("v") * 2).alias("av"),
                           F.sum(F.col("w")).alias("sw"),
                           F.count(F.col("v")).alias("cv"),
                           F.count_star().alias("n"))
                      .sort("k"))
        return run
    jrows, _, trows, _, jexp, texp = _run_both(sessions, data, q(JF), q(TF))
    assert trows[0][0] is None  # NULL keys group together, sorted first
    _assert_rows_close(trows, jrows)
    assert _placement(texp) == _placement(jexp)


def test_ungrouped_min_max_with_nulls_match_reference(sessions):
    data = _nulls_dict()

    def q(F):
        def run(df):
            return df.agg(F.min(F.col("v")).alias("lo"),
                          F.max(F.col("w")).alias("hi"),
                          F.min(F.col("day")).alias("first_day"),
                          F.avg(F.col("w")).alias("aw"))
        return run
    jrows, _, trows, _, _, _ = _run_both(sessions, data, q(JF), q(TF))
    _assert_rows_close(trows, jrows)


def test_grouped_aggregation_off_the_grid_is_not_ported(sessions, data):
    """Keys neither the string grid nor the dense path takes (an integral
    key now groups on the dense path: tests/test_torch_groupby.py) need
    the sort-based path, which raises."""
    _, tsess = sessions
    df = tsess.create_dataframe(data)
    with pytest.raises(NotImplementedError, match="item 4"):
        df.group_by("l_tax").agg(TF.sum(TF.col("l_quantity"))).collect()
    with pytest.raises(NotImplementedError, match="item 4"):
        df.group_by("l_returnflag").agg(TF.max(TF.col("l_tax"))).collect()


def test_scan_uploads_only_the_columns_the_query_reads(sessions, data):
    _, tsess = sessions
    tpch.q6(tsess.create_dataframe(data)).collect()
    # shipdate int32, discount, quantity, extendedprice float64
    assert tsess.last_query_stats().upload_bytes == 50_000 * (4 + 3 * 8)


Q3_SF = 0.02   # lineitem 120,024 rows, orders 30,005, customer 3,000
Q3_SETTINGS = {"spark.rapids.tpu.sql.batchSizeRows": 32768,
               "spark.rapids.tpu.join.denseMinProbeRows": 0}


@pytest.fixture(scope="module")
def q3_tables():
    return (tpch.gen_customer_arrays(Q3_SF), tpch.gen_orders_arrays(Q3_SF),
            tpch.gen_lineitem_arrays(Q3_SF))


def test_q3_matches_reference_and_oracle(q3_tables):
    """TPC-H Q3 (two dense broadcast joins, the 3-key dense aggregate, the
    top-10) through both packages: rows equal (revenue within rel 1e-9),
    the same explain placement, no more blocking fetches than the
    reference, and the numpy oracle."""
    cust, orders, li = q3_tables
    assert len(li["l_orderkey"]) == 120_024
    jsess, tsess = jsrt.Session(Q3_SETTINGS), \
        tsrt.Session(Q3_SETTINGS, device="cpu")
    jdf = jtpch.q3(*(jsess.create_dataframe(t) for t in q3_tables))
    with JStats.scoped() as st:
        jrows = jdf.collect()
    tdf = tpch.q3(*(tsess.create_dataframe(t) for t in q3_tables))
    trows = tdf.collect()
    assert len(trows) == 10
    _assert_rows_close(trows, jrows)
    _assert_rows_close(trows, tpch.q3_numpy(cust, orders, li))
    assert _placement(tdf.explain_string()) == _placement(
        jdf.explain_string())
    assert tsess.last_query_stats().blocking_fetches <= st.blocking_fetches
    metrics = tsess.last_exec_context().metrics
    assert any(m.values.get("aggDensePath") for m in metrics.values())


def test_string_predicates_match_reference(sessions):
    """Boolean predicates over one string column, nulls included, are
    evaluated on the host per distinct value (plan/stringpred.py)."""
    data = _nulls_dict()

    def q(F):
        def run(df):
            return (df.where((~(F.col("k") == "x") & (F.col("k") >= "y"))
                             | (F.col("k") < "y"))
                      .agg(F.count_star().alias("n"),
                           F.sum(F.col("w")).alias("sw")))
        return run
    jrows, jf, trows, tf, jexp, texp = _run_both(sessions, data, q(JF),
                                                 q(TF))
    assert trows == jrows
    assert _placement(texp) == _placement(jexp)
    assert tf <= jf
