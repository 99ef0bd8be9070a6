"""``DataFrame.cache()`` / ``persist()`` / ``unpersist()`` (``plan/logical.py
Cache``, ``plan/exec_nodes.py CacheExec``), ``Column.between`` and
``DataFrame.count()`` in the port, against the JAX reference's DataFrame on
the same numpy inputs: a cached child runs once across two actions and
within one plan that reads it twice; ``unpersist()`` frees the batches;
the explain strings show ``InMemoryCache [lazy]`` and then
``[materialized]`` as the reference's do; filter pushdown and column
pruning stop at the cache, whose child is optimized on its own; a cached plan under a semi join and inside IN
and scalar subqueries; ``between`` over int, float, date and string
columns with nulls; ``count()`` as an int.  The port runs on the CPU."""

import datetime
import gc

import numpy as np
import pytest

import spark_rapids_tpu as jsrt
from spark_rapids_tpu.sql import functions as JF
import spark_rapids_tpu_torch as tsrt
from spark_rapids_tpu_torch.batch import ColumnBatch
from spark_rapids_tpu_torch.plan import logical as TL
from spark_rapids_tpu_torch.sql import functions as TF
from spark_rapids_tpu_torch.utils.metrics import QueryStats as TStats

SETTINGS = {"spark.rapids.tpu.sql.batchSizeRows": 64}


@pytest.fixture(autouse=True)
def _release_reference_caches():
    """The reference's ``Cache`` nodes hold spill-catalog handles until the
    garbage collector takes them (they sit in reference cycles): collect
    after each test, so later tests in this process find the catalog
    empty."""
    yield
    gc.collect()


def _table(n=300, seed=3):
    rng = np.random.default_rng(seed)
    s = np.array(["apple", "fig", "kiwi", "lime", "pear"],
                 dtype=object)[rng.integers(0, 5, n)]
    s[rng.random(n) < 0.1] = None
    v = rng.integers(-40, 40, n).astype(object)
    v[rng.random(n) < 0.1] = None
    x = rng.uniform(-5.0, 5.0, n).astype(object)
    x[rng.random(n) < 0.1] = None
    d = (np.datetime64("1999-01-01")
         + rng.integers(0, 400, n).astype("timedelta64[D]")).astype(object)
    d[rng.random(n) < 0.1] = None
    return {"k": rng.integers(0, 20, n), "v": v, "x": x, "d": d, "s": s}


def _sessions():
    return jsrt.Session(dict(SETTINGS)), tsrt.Session(dict(SETTINGS),
                                                      device="cpu")


def _key(row):
    return tuple((x is None, x if x is not None else 0) for x in row)


def _same(got, want):
    assert sorted(got, key=_key) == sorted(want, key=_key)


def test_child_runs_once_across_two_actions():
    jsess, tsess = _sessions()
    outs = []
    for sess, F in ((jsess, JF), (tsess, TF)):
        c = sess.create_dataframe(_table()).filter(F.col("k") < 10).cache()
        agg = c.group_by("k").agg(F.count_star().alias("n"))
        with TStats.scoped() as st:
            outs.append((c.count(), agg.collect()))
    assert outs[1][0] == outs[0][0] and isinstance(outs[1][0], int)
    _same(outs[1][1], outs[0][1])
    assert (st.cache_materializations, st.cache_replays) == (1, 1)


def test_child_runs_once_within_one_plan():
    """A plan that reads the cache twice (a self join) runs the child
    once; a second action replays both reads."""
    jsess, tsess = _sessions()
    rows = []
    for sess, F in ((jsess, JF), (tsess, TF)):
        c = sess.create_dataframe(_table()).select("k", "v").cache()
        other = c.select(F.col("k").alias("k2"), F.col("v").alias("v2"))
        q = c.join(other, on=[("k", "k2")]).agg(
            F.count_star().alias("n"), F.sum(F.col("v2")).alias("s"))
        with TStats.scoped() as st:
            rows.append(q.collect())
            assert q.collect() == rows[-1]
    assert rows[1] == rows[0]
    assert (st.cache_materializations, st.cache_replays) == (1, 3)


def test_unpersist_frees_the_batches():
    _, tsess = _sessions()
    df = tsess.create_dataframe(_table())
    c = df.filter(TF.col("k") > 3).cache()
    assert c._plan.materialized is None
    n = c.count()
    batches = c._plan.materialized
    assert batches and all(isinstance(b, ColumnBatch) for b in batches)
    assert sum(b.num_rows for b in batches) == n
    # the batches were compacted when they were cached
    assert all(b.sel is None for b in batches)
    assert c.unpersist() is c and c._plan.materialized is None
    with TStats.scoped() as st:
        assert c.count() == n
    assert st.cache_materializations == 1
    assert df.unpersist() is df  # a frame that is not cached: nothing


def test_cached_batches_are_device_batches_not_spill_handles():
    """A difference from the reference (ROADMAP.md queue 3): its cache
    registers the batches in the spill catalog (``memory/spill.py``) and
    holds handles; the port holds the batches themselves until that
    catalog is ported (item 3)."""
    jsess, tsess = _sessions()
    jc = jsess.create_dataframe(_table()).cache()
    tc = tsess.create_dataframe(_table()).cache()
    assert jc.count() == tc.count()
    assert all(type(h).__name__ == "SpillableBatch"
               for h in jc._plan.materialized)
    assert all(isinstance(b, ColumnBatch) for b in tc._plan.materialized)


def test_explain_shows_lazy_then_materialized():
    jsess, tsess = _sessions()
    plans = []
    for sess, F in ((jsess, JF), (tsess, TF)):
        c = sess.create_dataframe(_table()).filter(F.col("k") < 5) \
            .select("k", "s").cache()
        q = c.filter(F.col("s") == "fig")
        before = q.explain_string().splitlines()[2:]
        q.collect()
        plans.append((before, q.explain_string().splitlines()[2:]))
    assert plans[1] == plans[0]
    assert any("InMemoryCache [lazy]" in ln for ln in plans[1][0])
    assert any("InMemoryCache [materialized]" in ln for ln in plans[1][1])


def test_pushdown_and_pruning_stop_at_the_cache(tmp_path):
    """Over parquet: the filter above the cache stays above it, and the
    cached scan reads every column with no pushed predicate, as the
    reference plans it."""
    pa = pytest.importorskip("pyarrow")
    pq = pytest.importorskip("pyarrow.parquet")
    t = _table()
    path = str(tmp_path / "t.parquet")
    pq.write_table(pa.table({"k": t["k"], "v": pa.array(list(t["v"])),
                             "s": pa.array(list(t["s"]))}), path)
    jsess, tsess = _sessions()
    out = []
    for sess, F in ((jsess, JF), (tsess, TF)):
        c = sess.read_parquet(path).cache()
        q = c.filter(F.col("k") == 7).select("v")
        plan = q.explain_string().splitlines()[2:]
        out.append((plan, q.collect()))
    assert out[1][0] == out[0][0]
    scans = [ln for ln in out[1][0] if "Scan parquet" in ln]
    assert scans and all("cols=[" not in ln and "pushdown=[" not in ln
                         for ln in scans)
    _same(out[1][1], out[0][1])


def test_cached_child_is_optimized_on_its_own(tmp_path):
    """Over parquet: a cached child is optimized against its own whole
    output when the cache is made, so its scan reads the columns and takes
    the predicate of the child alone; the filter above the cache stays
    above it.  The rows equal the reference's, whose cached child scans
    every column."""
    pa = pytest.importorskip("pyarrow")
    pq = pytest.importorskip("pyarrow.parquet")
    t = _table()
    path = str(tmp_path / "t.parquet")
    pq.write_table(pa.table({"k": t["k"], "v": pa.array(list(t["v"])),
                             "s": pa.array(list(t["s"]))}), path)
    jsess, tsess = _sessions()
    out = []
    for sess, F in ((jsess, JF), (tsess, TF)):
        c = (sess.read_parquet(path).filter(F.col("k") > 3)
             .select("k", "v").cache())
        q = c.filter(F.col("k") == 7).select("v")
        out.append((q.explain_string().splitlines()[2:], q.collect()))
    scans = [ln.strip(" *!") for ln in out[1][0] if "Scan parquet" in ln]
    assert len(scans) == 1
    assert scans[0].endswith(" cols=['k', 'v'] pushdown=[('k', '>')]]")
    above = out[1][0][:[i for i, ln in enumerate(out[1][0])
                        if "InMemoryCache" in ln][0]]
    assert any("Filter" in ln for ln in above)
    _same(out[1][1], out[0][1])


def test_cached_plan_under_a_semi_join_and_in_subqueries():
    jsess, tsess = _sessions()
    outs = []
    for sess, F in ((jsess, JF), (tsess, TF)):
        t = sess.create_dataframe(_table())
        keys = t.filter(F.col("v") > 20).select(
            F.col("k").alias("hot")).distinct().cache()
        semi = t.join(keys, on=[("k", "hot")], how="semi") \
            .select("k", "v").collect()
        inq = t.filter(F.col("k").isin_subquery(keys)).select("k").collect()
        top = keys.agg(F.max(F.col("hot")).alias("m"))
        scal = t.filter(F.col("k") == F.scalar_subquery(top)) \
            .select("k", "v").collect()
        outs.append((semi, inq, scal))
    for got, want in zip(outs[1], outs[0]):
        assert got
        _same(got, want)


@pytest.mark.parametrize("column,low,high", [
    ("v", -10, 10), ("x", -1.5, 2.5),
    ("d", datetime.date(1999, 3, 1), datetime.date(1999, 9, 30)),
    ("s", "b", "l")])
def test_between_matches_reference(column, low, high):
    jsess, tsess = _sessions()
    out = []
    for sess, F in ((jsess, JF), (tsess, TF)):
        df = sess.create_dataframe(_table())
        kept = df.filter(F.col(column).between(low, high)) \
            .select("k", column).collect()
        flag = df.select("k", F.col(column).between(low, high)
                         .alias("b")).collect()
        out.append((kept, flag))
    for got, want in zip(out[1], out[0]):
        _same(got, want)
    assert out[1][0] and any(r[1] is None for r in out[1][1])


def test_count_is_an_int_equal_to_the_reference():
    jsess, tsess = _sessions()
    counts = []
    for sess, F in ((jsess, JF), (tsess, TF)):
        df = sess.create_dataframe(_table())
        counts.append([df.count(), df.filter(F.col("k") > 100).count(),
                       df.select("k").distinct().count()])
    assert counts[1] == counts[0]
    assert all(type(n) is int for n in counts[1])
    assert counts[1][1] == 0


def test_cache_node_describes_itself_as_the_reference_does():
    node = TL.Cache(TL.Limit(TL.LogicalScan(None, None, "x"), 1))
    assert node.node_desc() == "InMemoryCache [lazy]"
    node.materialized = []
    assert node.node_desc() == "InMemoryCache [lazy]"  # nothing cached
    node.materialized = [object()]
    assert node.node_desc() == "InMemoryCache [materialized]"
    node.unpersist()
    assert node.materialized is None
