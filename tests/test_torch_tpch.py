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


@pytest.mark.parametrize("case", ["float_key", "max_over_string_group",
                                  "first"])
def test_grouped_aggregation_off_the_grid_is_not_ported(sessions, data,
                                                         case):
    """Groupings neither the string grid nor the dense path takes — a
    floating key, a float64 max over a string group, and (since row 4′ is
    ported) a FIRST over a string group — run on the hash aggregation and
    equal the reference's sort path."""
    jsess, tsess = sessions
    key, agg = {"float_key": ("l_tax", "sum"),
                "max_over_string_group": ("l_returnflag", "max"),
                "first": ("l_returnflag", "first")}[case]
    col = "l_quantity" if agg == "sum" else "l_tax"
    rows = []
    for sess, F in ((tsess, TF), (jsess, JF)):
        df = sess.create_dataframe(data)
        rows.append(sorted(df.group_by(key).agg(
            getattr(F, agg)(F.col(col)).alias("v"),
            F.count_star().alias("n")).collect()))
    _assert_rows_close(rows[0], rows[1])
    metrics = tsess.last_exec_context().metrics
    assert any(m.values.get("aggHashPath") for m in metrics.values())


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


# ---------------------------------------------------------------------------------
# Q4, Q13, Q18 and Q21 over the reference suite's gen_db data
# ---------------------------------------------------------------------------------

from spark_rapids_tpu.models import tpch_suite  # noqa: E402

DB_SF = 0.01   # lineitem 60,012, orders 15,000, customer 1,500, supplier 100
DB_SETTINGS = {"spark.rapids.tpu.sql.batchSizeRows": 16384,
               "spark.rapids.tpu.join.denseMinProbeRows": 0}
DB_QUERIES = {"q4": ("orders", "lineitem"), "q13": ("customer", "orders"),
              "q18": ("orders", "lineitem", "customer"),
              "q21": ("lineitem", "orders", "supplier")}


@pytest.fixture(scope="module")
def db():
    return tpch.gen_db_arrays(DB_SF)


@pytest.mark.parametrize("query", list(DB_QUERIES))
def test_suite_query_matches_reference_and_oracle(db, query):
    """The four queries of this slice (semi, anti and left outer joins, the
    CSR join, the hash aggregate, DISTINCT, HAVING, the device ORDER BY
    and a LIMIT over the host sort) through both packages on the same
    gen_db arrays in 16,384-row batches: rows equal the reference's
    ``run_q*`` and the numpy oracle, at no more blocking fetches."""
    tables = DB_QUERIES[query]
    jsess = jsrt.Session(DB_SETTINGS)
    tsess = tsrt.Session(DB_SETTINGS, device="cpu")
    jdfs = {t: jsess.create_dataframe(db[t]) for t in tables}
    with JStats.scoped() as st:
        jrows = getattr(tpch_suite, f"run_{query}")(jdfs)
    trows = getattr(tpch, query)(*(tsess.create_dataframe(db[t])
                                   for t in tables)).collect()
    want = getattr(tpch, f"{query}_numpy")(*(db[t] for t in tables))
    assert trows
    _assert_rows_close(trows, jrows)
    _assert_rows_close(trows, want)
    assert tsess.last_query_stats().blocking_fetches <= st.blocking_fetches


def test_gen_db_arrays_match_reference_parquet(tmp_path):
    """Every column of every table equals what the reference suite's
    gen_db writes, over several 1,000-row chunks."""
    pq = pytest.importorskip("pyarrow.parquet")
    sf = 0.002
    paths = tpch_suite.gen_db(sf, str(tmp_path), chunk=1000)
    mine = tpch.gen_db_arrays(sf, chunk=1000)
    for t in tpch.DB_TABLES:
        ref = pq.read_table(paths[t])
        assert ref.column_names == list(mine[t])
        for c in ref.column_names:
            got = mine[t][c]
            want = ref.column(c).to_numpy()
            if got.dtype.kind == "M":
                want = np.asarray(want, dtype="datetime64[D]")
            elif got.dtype.kind == "U":
                want = want.astype(str)
            np.testing.assert_array_equal(got, want, err_msg=f"{t}.{c}")
    picked = tpch.gen_db_arrays(sf, tables=("lineitem",), chunk=1000,
                                columns={"lineitem": ["l_orderkey"]})
    np.testing.assert_array_equal(picked["lineitem"]["l_orderkey"],
                                  mine["lineitem"]["l_orderkey"])
    assert list(picked) == ["lineitem"]


# ---------------------------------------------------------------------------------
# Q10: the shuffled sort-merge join and its runtime broadcast flip
# ---------------------------------------------------------------------------------

# the broadcast threshold scaled from SF10 to DB_SF, so each side of the
# second join is estimated over it as at SF10 (and the first still fits)
Q10_SETTINGS = dict(DB_SETTINGS, **{
    "spark.rapids.tpu.sql.autoBroadcastJoinThreshold": 268_435})


@pytest.mark.parametrize("config", ["flip", "shuffled"])
def test_q10_matches_reference_and_oracle(db, config):
    """TPC-H Q10 in the reference's two configurations: with AQE on, the
    second join's staged left side fits and it flips to a broadcast join
    (``aqeShuffleToBroadcast`` = 1); with AQE off, it joins 8 hash
    partition pairs.  Rows equal the reference's ``run_q10`` and
    ``q10_numpy`` (c_acctbal rides the dense aggregate as a float
    residual), at no more blocking fetches."""
    settings = dict(Q10_SETTINGS, **{
        "spark.rapids.tpu.sql.aqe.enabled": config == "flip"})
    tables = ("customer", "orders", "lineitem")
    jsess = jsrt.Session(settings)
    tsess = tsrt.Session(settings, device="cpu")
    jdfs = {t: jsess.create_dataframe(db[t]) for t in tables}
    with JStats.scoped() as st:
        jrows = tpch_suite.run_q10(jdfs)
    trows = tpch.q10(*(tsess.create_dataframe(db[t])
                       for t in tables)).collect()
    want = tpch.q10_numpy(*(db[t] for t in tables))
    assert len(trows) == 20
    _assert_rows_close(trows, jrows)
    _assert_rows_close(trows, want)
    assert tsess.last_query_stats().blocking_fetches <= st.blocking_fetches
    metrics = tsess.last_exec_context().metrics
    values = lambda name: sum(m.values.get(name, 0)  # noqa: E731
                              for m in metrics.values())
    assert values("aqeShuffleToBroadcast") == int(config == "flip")
    assert values("aggDensePath") == 1
    exchanged = sum(m.values.get("numOutputBatches", 0)
                    for k, m in metrics.items()
                    if k.startswith("ShuffleExchangeExec"))
    assert exchanged == (0 if config == "flip" else 16)


# ---------------------------------------------------------------------------------
# The full sort (S1), the window history (W1) and Q11
# ---------------------------------------------------------------------------------

def _device_columns_close(got: dict, want: dict):
    """Port device columns against the reference's or the oracle's:
    validity, integers and dates equal; floats within REL."""
    assert set(got) == set(want)
    for c, w in want.items():
        wd, wv = w if isinstance(w, tuple) else (w, None)
        wd, wv = np.asarray(wd), None if wv is None else np.asarray(wv)
        if wd.dtype.kind == "M":
            wd = wd.astype("datetime64[D]").astype(np.int64).astype(np.int32)
        gd, gv = got[c]
        gd = gd.numpy()
        ok = np.ones(len(wd), dtype=bool) if wv is None else wv
        gok = np.ones(len(gd), dtype=bool) if gv is None else gv.numpy()
        np.testing.assert_array_equal(gok, ok, err_msg=c)
        if wd.dtype.kind == "f":
            np.testing.assert_allclose(gd[ok], wd[ok], rtol=REL, atol=0,
                                       err_msg=c)
        else:
            np.testing.assert_array_equal(gd[ok], wd[ok], err_msg=c)


@pytest.mark.parametrize("path", ["sort_lineitem", "supplier_history"])
def test_sort_and_window_paths_match_reference_and_oracle(db, path):
    """S1 (the lineitem ORDER BY, out-of-core in 16,384-row batches: 4
    runs) and W1 (two window specs, filtered above them) through both
    packages' ``to_device_arrays``: S1's columns equal the reference's and
    the oracle's exactly, W1's within REL for floats, at no more blocking
    fetches than the reference."""
    from spark_rapids_tpu.sql.window import Window as JW
    jsess = jsrt.Session(DB_SETTINGS)
    tsess = tsrt.Session(DB_SETTINGS, device="cpu")
    body = getattr(tpch, path)
    extra = {} if path == "sort_lineitem" else {"window": JW}
    jdf = body(jsess.create_dataframe(db["lineitem"]), functions=JF, **extra)
    with JStats.scoped() as st:
        jout = jdf.to_device_arrays()
    tout = body(tsess.create_dataframe(db["lineitem"])).to_device_arrays()
    _device_columns_close(tout, {c: (np.asarray(d), None if v is None
                                     else np.asarray(v))
                                 for c, (d, v) in jout.items()})
    _device_columns_close(tout, getattr(tpch, f"{path}_numpy")(
        db["lineitem"]))
    assert tsess.last_query_stats().blocking_fetches <= st.blocking_fetches
    tdf = body(tsess.create_dataframe(db["lineitem"]))
    assert tdf.explain_string().splitlines()[2:] == \
        jdf.explain_string().splitlines()[2:]
    metrics = tsess.last_exec_context().metrics
    if path == "supplier_history":
        assert sum(m.values.get("numOutputBatches", 0)
                   for m in metrics.values()) == 2   # one per Window node


def test_q11_matches_reference_and_oracle(db):
    """TPC-H Q11 (partsupp joined to the German suppliers, the total, the
    HAVING and the ORDER BY through the full sort) against ``run_q11`` and
    ``q11_numpy``, at no more blocking fetches than the reference: the two
    broadcast joins' build stats ride one fetch in each of its queries."""
    from spark_rapids_tpu_torch.utils.metrics import QueryStats as TStats
    tables = ("partsupp", "supplier", "nation")
    jsess = jsrt.Session(DB_SETTINGS)
    tsess = tsrt.Session(DB_SETTINGS, device="cpu")
    with JStats.scoped() as st:
        jrows = tpch_suite.run_q11({t: jsess.create_dataframe(db[t])
                                    for t in tables})
    with TStats.scoped() as both:
        tdf = tpch.q11(*(tsess.create_dataframe(db[t]) for t in tables))
        trows = tdf.collect()
    assert trows
    _assert_rows_close(trows, jrows)
    _assert_rows_close(trows, tpch.q11_numpy(*(db[t] for t in tables)))
    assert tsess.last_query_stats().blocking_fetches <= st.blocking_fetches
    assert both.blocking_fetches <= st.blocking_fetches
