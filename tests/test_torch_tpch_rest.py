"""The rest of TPC-H through both packages on the same ``gen_db_arrays``
data: Q2, Q5, Q7, Q8, Q9, Q12, Q14, Q15, Q16, Q17, Q19, Q20 and Q22 as the
reference suite's ``run_q*`` write them, and Q21 in its EXISTS form (the
same logical plan built in both packages: conditioned semi and anti
joins).  Each query's rows equal the reference's and the numpy oracle's
(ints, strings and dates exactly, floats within rel 1e-9: the packages sum
in different orders), and the port makes no more blocking fetches than the
reference, counted over every query a body runs (Q15 and Q22 collect a
constant first).  The port runs on the CPU here (its kernels' plain
versions), at SF 0.01 in 16,384-row batches, so lineitem spans four
batches and every aggregate accumulates across them."""

import pytest

import spark_rapids_tpu as jsrt
import spark_rapids_tpu.plan.logical as JL
from spark_rapids_tpu.models import tpch_suite
from spark_rapids_tpu.sql import functions as JF
from spark_rapids_tpu.utils.metrics import QueryStats as JStats
import spark_rapids_tpu_torch as tsrt
from spark_rapids_tpu_torch.models import tpch
from spark_rapids_tpu_torch.utils.metrics import QueryStats as TStats

DB_SF = 0.01   # lineitem 60,012, orders 15,000, part 2,000, supplier 100
SETTINGS = {"spark.rapids.tpu.sql.batchSizeRows": 16384,
            "spark.rapids.tpu.join.denseMinProbeRows": 0}
REL = 1e-9
QUERIES = ["q2", "q5", "q7", "q8", "q9", "q12", "q14", "q15", "q16", "q17",
           "q19", "q20", "q22", "q21_exists"]


@pytest.fixture(scope="module")
def db():
    return tpch.gen_db_arrays(DB_SF)


def _assert_rows_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(b, float) and a is not None:
                assert abs(a - b) <= REL * max(abs(b), 1e-300), (g, w)
            else:
                assert a == b, (g, w)


def _run(query, tables, settings=SETTINGS):
    """(reference rows, reference fetches, port rows, port fetches)."""
    names = tpch.QUERY_TABLES[query]
    jsess = jsrt.Session(settings)
    tsess = tsrt.Session(settings, device="cpu")
    with JStats.scoped() as js:
        if query == "q21_exists":
            jrows = tpch.q21_exists(*(jsess.create_dataframe(tables[t])
                                      for t in names),
                                    functions=JF, logical=JL).collect()
        else:
            jrows = getattr(tpch_suite, f"run_{query}")(
                {t: jsess.create_dataframe(tables[t]) for t in names})
    with TStats.scoped() as ts:
        trows = getattr(tpch, query)(*(tsess.create_dataframe(tables[t])
                                       for t in names)).collect()
    return jrows, js.blocking_fetches, trows, ts.blocking_fetches


@pytest.mark.parametrize("query", QUERIES)
def test_query_matches_reference_and_oracle(db, query):
    jrows, jfetch, trows, tfetch = _run(query, db)
    want = getattr(tpch, f"{query}_numpy")(*(db[t] for t in
                                             tpch.QUERY_TABLES[query]))
    _assert_rows_close(trows, jrows)
    _assert_rows_close(trows, want)
    assert tfetch <= jfetch
    if query not in ("q22",):
        assert trows   # the data leaves rows in every other result


def test_q22_with_customers_without_orders(db):
    """At SF 0.01 every customer above the average balance has an order,
    so Q22 keeps no row; with orders cut to their first 3,000 rows the
    anti join keeps customers in every country code group."""
    tables = dict(db, orders={c: a[:3000] for c, a in db["orders"].items()})
    jrows, jfetch, trows, tfetch = _run("q22", tables)
    want = tpch.q22_numpy(tables["customer"], tables["orders"])
    assert len(trows) == len(tpch.Q22_CODES)
    _assert_rows_close(trows, jrows)
    _assert_rows_close(trows, want)
    assert tfetch <= jfetch


def test_q21_exists_plans_conditioned_joins_as_the_reference(db):
    """Q21-exists with the broadcast threshold scaled from SF10 to SF 0.01:
    both packages place the same plan and pick the same join operators
    (the two conditioned joins as sort-merge joins over four shuffle
    exchanges, the orders semi join and the supplier join broadcast)."""
    settings = dict(SETTINGS, **{
        "spark.rapids.tpu.sql.autoBroadcastJoinThreshold": 268_435})
    tsess = tsrt.Session(settings, device="cpu")
    jsess = jsrt.Session(settings)
    names = tpch.QUERY_TABLES["q21_exists"]
    tdf = tpch.q21_exists(*(tsess.create_dataframe(db[t]) for t in names))
    jdf = tpch.q21_exists(*(jsess.create_dataframe(db[t]) for t in names),
                          functions=JF, logical=JL)
    assert tdf.explain_string().splitlines()[2:] == \
        jdf.explain_string().splitlines()[2:]
    _assert_rows_close(tdf.collect(), jdf.collect())
    kinds = ("SortMergeJoinExec", "BroadcastJoinExec", "ShuffleExchangeExec")

    def operators(sess):
        names = [k.split("@")[0] for k in sess.last_exec_context().metrics]
        return {k: names.count(k) for k in kinds}
    assert operators(tsess) == operators(jsess) == {
        "SortMergeJoinExec": 2, "BroadcastJoinExec": 2,
        "ShuffleExchangeExec": 4}
