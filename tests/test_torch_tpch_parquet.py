"""The reference suite's 22 TPC-H queries over parquet, as ``bench.py``
runs them: the reference's ``gen_db`` files read by both packages
(``read_parquet`` per table, ``fileCache.enabled``), every query through
the reference's ``run_q*`` and the port's body.  Each query's rows equal
the reference's and the numpy oracle's (floats within rel 1e-9); the port
makes no more blocking fetches than the reference; both plan the same
scans (explain strings equal, narrowed columns and pushed predicates
included) and read the same scan rows, runtime join filters included.
The same queries over the port's own ``gen_db`` files (its writer) give
the oracle's rows.  SF 0.01 in 16,384-row batches: lineitem spans four
batches."""

import gc
import re

import pytest

pq = pytest.importorskip("pyarrow.parquet")

import spark_rapids_tpu as jsrt  # noqa: E402
from spark_rapids_tpu.models import tpch_suite  # noqa: E402
from spark_rapids_tpu.sql.dataframe import DataFrame as JDF  # noqa: E402
from spark_rapids_tpu.utils.metrics import QueryStats as JStats  # noqa: E402
import spark_rapids_tpu_torch as tsrt  # noqa: E402
from spark_rapids_tpu_torch.io import filecache  # noqa: E402
from spark_rapids_tpu_torch.models import tpch  # noqa: E402
from spark_rapids_tpu_torch.sql.dataframe import DataFrame as TDF  # noqa: E402
from spark_rapids_tpu_torch.utils.metrics import QueryStats as TStats  # noqa: E402

SF = 0.01
SETTINGS = {"spark.rapids.tpu.sql.batchSizeRows": 16384,
            "spark.rapids.tpu.join.denseMinProbeRows": 0,
            "spark.rapids.tpu.sql.fileCache.enabled": True}
REL = 1e-9
# plans that differ for reasons outside the scan (ROADMAP.md queue 3): the
# reference moves string predicates out of residual join conditions (Q7,
# Q19), and its Q22 average differs from the port's in the last bit, which
# its literal shows
SCAN_LINES_ONLY = ("q7", "q19", "q22")
# Q21 caches its late pairs (InMemoryCache), whose scan only the port
# narrows to the columns it reads; else its plan equals the reference's
CACHED = ("q21",)


@pytest.fixture(autouse=True)
def _release_reference_caches():
    """The reference's ``Cache`` nodes hold spill-catalog handles until the
    garbage collector takes them (they sit in reference cycles): collect
    after each test, so later tests in this process find the catalog
    empty."""
    yield
    gc.collect()


@pytest.fixture(scope="module")
def ref_files(tmp_path_factory):
    return tpch_suite.gen_db(SF, str(tmp_path_factory.mktemp("refdb")))


@pytest.fixture(scope="module")
def db():
    return tpch.gen_db_arrays(SF)


def _assert_rows_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(b, float) and a is not None:
                assert abs(a - b) <= REL * max(abs(b), 1e-300), (g, w)
            else:
                assert a == b, (g, w)


def _explained(monkeypatch, cls, plans):
    """Record every collected DataFrame's explain string."""
    collect = cls.collect

    def spy(self):
        plans.append(self.explain_string().splitlines()[2:])
        return collect(self)
    monkeypatch.setattr(cls, "collect", spy)


def _scan_lines(plan):
    return sorted(ln.strip(" *!") for ln in plan if "Scan parquet" in ln)


def _unpruned_under_cache(plan):
    """Explain lines with the column list taken off every scan under an
    InMemoryCache: the reference never optimizes below a cache, the port
    optimizes a cached child on its own (``DataFrame.cache``), so its
    scans there read only the columns they need."""
    out, cache_at = [], None
    for ln in plan:
        indent = len(ln) - len(ln.lstrip(" "))
        if cache_at is not None and indent <= cache_at:
            cache_at = None
        if "InMemoryCache" in ln and cache_at is None:
            cache_at = indent
        elif cache_at is not None and "Scan parquet" in ln:
            ln = re.sub(r" cols=\[[^\]]*\]", "", ln)
        out.append(ln)
    return out


def _scan_rows(sess):
    return sorted(int(m.values.get("numOutputRows", 0))
                  for op, m in sess.last_exec_context().metrics.items()
                  if op.startswith("ScanExec"))


@pytest.mark.parametrize("query", list(tpch.SUITE_QUERIES))
def test_query_over_parquet_matches_reference(ref_files, db, query,
                                              monkeypatch):
    jsess = jsrt.Session(SETTINGS)
    tsess = tsrt.Session(SETTINGS, device="cpu")
    jplans, tplans = [], []
    _explained(monkeypatch, JDF, jplans)
    _explained(monkeypatch, TDF, tplans)
    tables = tpch_suite.TABLES[query]
    with JStats.scoped() as js:
        jrows = tpch_suite.QUERIES[query][0](
            {t: jsess.read_parquet(ref_files[t]) for t in tables})
    with TStats.scoped() as ts:
        trows = tpch.run_query(query, {t: tsess.read_parquet(ref_files[t])
                                       for t in tables})
    _assert_rows_close(trows, jrows)
    _assert_rows_close(trows, tpch.query_oracle(query, db))
    assert ts.blocking_fetches <= js.blocking_fetches
    assert len(tplans) == len(jplans)
    for tp, jp in zip(tplans, jplans):
        if query in CACHED:
            unpruned = _unpruned_under_cache(tp)
            assert unpruned != tp
            tp = unpruned
        if query in SCAN_LINES_ONLY:
            assert _scan_lines(tp) == _scan_lines(jp)
        else:
            assert tp == jp
    tscan, jscan = _scan_rows(tsess), _scan_rows(jsess)
    # the port never opens the probe side of an empty inner build (Q17 at
    # this scale), which the reference reads under an empty IN list
    assert [r for r in tscan if r] == [r for r in jscan if r]


def test_queries_over_the_ports_own_files(tmp_path, db):
    """``models/tpch.gen_db`` writes the same tables with the port's
    writer (pyarrow's row groups); read back, every query gives the
    oracle's rows, with the runtime filters on and off."""
    paths = tpch.gen_db(SF, str(tmp_path))
    md = pq.ParquetFile(paths["lineitem"]).metadata
    assert md.num_rows == tpch.db_rows("lineitem", SF)
    filecache.clear_file_cache()
    for dpp in (True, False):
        sess = tsrt.Session(dict(SETTINGS, **{
            "spark.rapids.tpu.sql.dpp.enabled": dpp}), device="cpu")
        dfs = {t: sess.read_parquet(p) for t, p in paths.items()}
        for query in tpch.SUITE_QUERIES:
            _assert_rows_close(tpch.run_query(query, dfs),
                               tpch.query_oracle(query, db))
