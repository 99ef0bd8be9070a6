"""Scan pushdown in the port against the reference, on the same parquet
files: predicate extraction (``plan/pushdown.py extract_predicates``),
row-group pruning (``io/parquet.py prune_row_groups``: the kept groups),
the exact host filter (``_exact_filter_mask``: the kept rows), the
narrowed and predicated scans the planners build (explain strings), and
the decoded-file cache with its device tier.  The cases are those of
``tests/test_pushdown.py``, run through both packages."""

import datetime
import os

import numpy as np
import pytest

pa = pytest.importorskip("pyarrow")
pq = pytest.importorskip("pyarrow.parquet")

import spark_rapids_tpu as jsrt  # noqa: E402
from spark_rapids_tpu import exprs as JE  # noqa: E402
from spark_rapids_tpu.io.parquet import ParquetSource as JSource  # noqa: E402
from spark_rapids_tpu.io.parquet import prune_row_groups as jprune  # noqa: E402
from spark_rapids_tpu.plan.pushdown import \
    extract_predicates as jextract  # noqa: E402
from spark_rapids_tpu.sql import functions as JF  # noqa: E402
import spark_rapids_tpu_torch as tsrt  # noqa: E402
from spark_rapids_tpu_torch import exprs as TE  # noqa: E402
from spark_rapids_tpu_torch.io import filecache  # noqa: E402
from spark_rapids_tpu_torch.io.parquet import ParquetSource  # noqa: E402
from spark_rapids_tpu_torch.io.parquet import open_file, prune_row_groups  # noqa: E402
from spark_rapids_tpu_torch.plan.pushdown import extract_predicates  # noqa: E402
from spark_rapids_tpu_torch.sql import functions as TF  # noqa: E402
from spark_rapids_tpu_torch.utils.metrics import QueryStats  # noqa: E402

D0 = datetime.date(1994, 1, 1)


@pytest.fixture(scope="module")
def pq_path(tmp_path_factory):
    """10,000 rows in 1,000-row groups: ``a`` sorted, ``b`` uniform, ``c``
    100 strings, ``d`` int32 mod 500, ``e`` dates with nulls, ``f`` floats
    with nulls."""
    d = tmp_path_factory.mktemp("pushdown")
    path = str(d / "data.parquet")
    n = 10_000
    rng = np.random.default_rng(7)
    nulls = rng.random(n) < 0.1
    pq.write_table(pa.table({
        "a": pa.array(np.arange(n, dtype=np.int64)),
        "b": pa.array(rng.uniform(0, 1, n)),
        "c": pa.array([f"s{i % 100}" for i in range(n)]),
        "d": pa.array(np.arange(n, dtype=np.int32) % 500),
        "e": pa.array([None if z else D0 + datetime.timedelta(days=i // 10)
                       for i, z in enumerate(nulls)], pa.date32()),
        "f": pa.array([None if z else float(x) for x, z in
                       zip(rng.integers(0, 50, n), nulls[::-1])]),
    }), path, row_group_size=1000)
    return path


EXPRESSIONS = {
    "simple compare": lambda F, E: (F.col("a") > 5).expr,
    "conjunction": lambda F, E: ((F.col("a") > 5)
                                 & (F.col("b") <= 1.5)).expr,
    "flipped literal": lambda F, E: E.LessThan(E.Literal(5),
                                               E.UnresolvedColumn("a")),
    "disjunction": lambda F, E: ((F.col("a") > 5)
                                 | (F.col("b") <= 1.5)).expr,
    "in": lambda F, E: F.col("a").isin([1, 2]).expr,
    "isnotnull": lambda F, E: F.col("a").is_not_null().expr,
    "date and string": lambda F, E: ((F.col("e") >= D0)
                                     & (F.col("c") == "s5")
                                     & (F.col("e") < F.col("a"))).expr,
    "null literal": lambda F, E: (F.col("a") == F.lit(None)).expr,
    "nested and": lambda F, E: (((F.col("a") >= 1) & (F.col("d") < 3))
                                & (F.lit(7) <= F.col("b"))).expr,
}


@pytest.mark.parametrize("case", list(EXPRESSIONS))
def test_extract_predicates_matches_reference(case):
    make = EXPRESSIONS[case]
    assert extract_predicates(make(TF, TE)) == jextract(make(JF, JE))


PREDICATES = {
    "a >= 8000": [("a", ">=", 8000)],
    "a < 1500": [("a", "<", 1500)],
    "a == 4500": [("a", "==", 4500)],
    "no stats match": [("b", ">=", 0.0)],
    "contradiction": [("a", ">", 10**9)],
    "string ==": [("c", "==", "s5")],
    "string range": [("c", ">", "s9"), ("c", "<=", "s95")],
    "in": [("a", "in", [3, 7_500, None])],
    "empty in": [("a", "in", [])],
    "isnotnull": [("e", "isnotnull", None)],
    "not equal": [("a", "!=", 5)],
    "dates": [("e", ">=", D0 + datetime.timedelta(days=500)),
              ("e", "<", D0 + datetime.timedelta(days=700))],
    "incomparable literal": [("a", "<", "x")],
    "float with nulls": [("f", "<", 10.0), ("a", "<=", 6000)],
    "unknown column": [("zz", ">", 1), ("a", "<", 2000)],
}


@pytest.mark.parametrize("case", list(PREDICATES))
def test_prune_row_groups_keeps_the_reference_groups(pq_path, case):
    preds = PREDICATES[case]
    assert prune_row_groups(open_file(pq_path), preds) == \
        jprune(pq.ParquetFile(pq_path), preds)


def _port_rows(tables):
    out = []
    for t in tables:
        cols = []
        for c in t.columns:
            if isinstance(c, tuple):
                data, valid = c
                vals = data.tolist()
                ok = [True] * len(vals) if valid is None else valid.tolist()
            else:
                vals = list(c.data)
                ok = [True] * len(vals) if c.valid is None \
                    else c.valid.tolist()
            cols.append([v if k else None for v, k in zip(vals, ok)])
        out += list(zip(*cols))
    return out


def _ref_rows(tables):
    out = []
    for t in tables:
        cols = []
        for name in t.column_names:
            col = t.column(name)
            if pa.types.is_date32(col.type):
                col = col.cast(pa.int32())
            cols.append(col.to_pylist())
        out += list(zip(*cols))
    return out


@pytest.mark.parametrize("case", list(PREDICATES))
def test_exact_filter_keeps_the_reference_rows(pq_path, case):
    """Both sources with the predicates pushed and the exact host filter
    on: the same rows in the same batches (a conjunct the filter cannot
    apply exactly turns it off in both)."""
    preds = PREDICATES[case]
    mine = ParquetSource(pq_path, predicates=preds, batch_rows=1500,
                         num_threads=0)
    ref = JSource(pq_path, predicates=preds, batch_rows=1500, num_threads=0)
    assert _port_rows(mine()) == _ref_rows(ref())


QUERIES = {
    "project": lambda F, df: df.select((F.col("a") + 1).alias("x")),
    "filter then select": lambda F, df: df.where(F.col("b") > 0.5)
    .select("a"),
    "aggregate": lambda F, df: df.group_by("d").agg(
        F.sum(F.col("a")).alias("s")).sort("d"),
    "range": lambda F, df: df.where((F.col("a") >= 9995)).select("a"),
    "empty": lambda F, df: df.where(F.col("a") > 10**9).select("a"),
    "string and date": lambda F, df: df.where(
        (F.col("c") == "s7") & (F.col("e") >= D0)).select("a", "e"),
    "through a projection": lambda F, df: df.select(
        "a", (F.col("b") * 2).alias("b2")).where(F.col("a") < 1200),
    "limit blocks": lambda F, df: df.limit(5000).where(F.col("a") > 4500)
    .select("a"),
}


@pytest.mark.parametrize("case", list(QUERIES))
def test_planned_scans_match_reference(pq_path, case):
    """The same logical query in both packages: the same explain string
    (narrowed columns and pushed predicates on the scan), the same rows
    and the same scan rows."""
    settings = {"spark.rapids.tpu.sql.batchSizeRows": 3000}
    jsess = jsrt.Session(settings)
    tsess = tsrt.Session(settings, device="cpu")
    jdf = QUERIES[case](JF, jsess.read_parquet(pq_path))
    tdf = QUERIES[case](TF, tsess.read_parquet(pq_path))
    assert tdf.explain_string().splitlines()[2:] == \
        jdf.explain_string().splitlines()[2:]
    assert sorted(tdf.collect()) == sorted(jdf.collect())

    def scan_rows(sess):
        return sorted(int(m.values.get("numOutputRows", 0))
                      for op, m in sess.last_exec_context().metrics.items()
                      if op.startswith("ScanExec"))
    assert scan_rows(tsess) == scan_rows(jsess)


class TestFileCache:
    def test_cache_hit_same_result(self, pq_path):
        filecache.clear_file_cache()
        src = ParquetSource(pq_path, columns=["a"], cache_bytes=1 << 30)
        t1, t2 = list(src()), list(src())
        assert [t.num_rows for t in t1] == [t.num_rows for t in t2]
        assert all(a is b for a, b in zip(t1, t2))
        assert filecache.get_file_cache(1 << 30).hits >= 1

    def test_predicates_key_their_own_entries(self, pq_path):
        filecache.clear_file_cache()
        base = ParquetSource(pq_path, columns=["a"], cache_bytes=1 << 30,
                             num_threads=0)
        low = base.with_pushdown(None, [("a", "<", 2500)])
        assert sum(t.num_rows for t in base()) == 10_000
        assert sum(t.num_rows for t in low()) == 2_500
        assert sum(t.num_rows for t in base()) == 10_000

    def test_cache_disabled_by_default(self, pq_path):
        src = tsrt.Session(device="cpu").read_parquet(pq_path)._plan.source
        assert src.cache_bytes == 0

    def test_eviction_under_budget(self):
        c = filecache.FileCache(max_bytes=100)

        class Big:
            nbytes = 8000
        c.put(("k",), [Big()])
        assert c.get(("k",)) is None  # too big to cache

    def test_mtime_invalidation(self, tmp_path):
        path = str(tmp_path / "f.parquet")
        pq.write_table(pa.table({"x": pa.array([1, 2, 3])}), path)
        src = ParquetSource(path, cache_bytes=1 << 30)
        filecache.clear_file_cache()
        assert sum(t.num_rows for t in src()) == 3
        pq.write_table(pa.table({"x": pa.array([1, 2, 3, 4])}), path)
        os.utime(path, (0, 0))  # force an mtime change
        assert sum(t.num_rows for t in ParquetSource(
            path, cache_bytes=1 << 30)()) == 4

    def test_device_tier_serves_repeated_scans(self, pq_path):
        """With fileCache.enabled (and its device tier, on by default) a
        repeated identical scan uploads nothing and gives the same rows;
        another predicate is another entry."""
        filecache.clear_file_cache()
        sess = tsrt.Session({"spark.rapids.tpu.sql.fileCache.enabled": True},
                            device="cpu")
        df = sess.read_parquet(pq_path)

        def run(q):
            with QueryStats.scoped() as st:
                rows = q.collect()
            return rows, st.upload_bytes
        q = df.where(TF.col("a") < 3000).select("a", "b")
        cold, cold_bytes = run(q)
        warm, warm_bytes = run(q)
        assert cold == warm and cold_bytes > 0 and warm_bytes == 0
        _, other_bytes = run(df.where(TF.col("a") < 2000).select("a", "b"))
        assert other_bytes > 0


class TestPrefetch:
    def test_prefetch_yields_all_batches(self, pq_path):
        src = ParquetSource(pq_path, batch_rows=1000, num_threads=4)
        assert sum(t.num_rows for t in src()) == 10_000

    def test_prefetch_propagates_errors(self, tmp_path):
        path = str(tmp_path / "bad.parquet")
        with open(path, "wb") as f:
            f.write(b"not parquet")
        with pytest.raises(ValueError):
            list(ParquetSource(path, num_threads=4)())

    def test_no_prefetch_mode(self, pq_path):
        src = ParquetSource(pq_path, batch_rows=1000, num_threads=0)
        assert sum(t.num_rows for t in src()) == 10_000

    def test_abandoned_iterator_stops_the_producer(self, pq_path):
        it = ParquetSource(pq_path, batch_rows=100, num_threads=1)(
            prefetch_depth=1)
        assert next(it).num_rows == 100
        it.close()


def test_reader_batch_bytes_clamp_rows_as_reference(pq_path):
    """``reader.batchSizeBytes`` caps a scan's batch rows by the schema's
    planning width, in both packages."""
    settings = {"spark.rapids.tpu.sql.reader.batchSizeBytes": 64_000}
    t = tsrt.Session(settings, device="cpu").read_parquet(pq_path)
    j = jsrt.Session(settings).read_parquet(pq_path)
    assert t._plan.source.batch_rows == j._plan.source.batch_rows < 10_000


def test_unported_options_raise(pq_path):
    with pytest.raises(NotImplementedError, match="ROADMAP.md item 9"):
        ParquetSource(pq_path, _skip_rows={pq_path: np.array([1])})
    with pytest.raises(ValueError, match="ROADMAP.md item 3"):
        tsrt.Session({"spark.rapids.tpu.sql.cache.enabled": True},
                     device="cpu")
