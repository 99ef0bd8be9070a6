"""The partial/final aggregate split in the port (row 5'):
``sql.agg.singleProcessComplete=false`` plans a grouped aggregate as
partial → ShuffleExchangeExec(coalesce_output) → final, as the reference's
``_plan_aggregate`` does.  The partial samples its first batch
(``csrc/group_ratio.cu``; its plain version here) and passes rows through
unreduced when the distinct/live ratio of the sampled key hashes passes
``sql.agg.skipPartialAggRatio``; the final merges buffers with their merge
ops (``hash_agg.cu``'s merge entry) and re-partitions by
``xxhash64(keys) % n`` (``hashing.cu``) when its groups outgrow
``sql.batchSizeBytes``.

Every query runs through both packages on the same numpy data: rows (ints,
strings and dates exactly, float64 within rel 1e-9: the packages sum in
different orders), the aggregate and exchange nodes' explain strings, the
``skippedPartialAgg`` decisions and the blocking fetches (the port's at
most the reference's).  The plain versions of the new kernels are held
against the JAX programs they replace.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import spark_rapids_tpu as jsrt
from spark_rapids_tpu.models import tpch_suite
from spark_rapids_tpu.ops import groupby as jgroupby
from spark_rapids_tpu.ops import hashing as jhashing
from spark_rapids_tpu.sql import functions as JF
from spark_rapids_tpu.utils.metrics import QueryStats as JStats
import spark_rapids_tpu_torch as tsrt
from spark_rapids_tpu_torch.models import tpch
from spark_rapids_tpu_torch.ops import groupby, hashing
from spark_rapids_tpu_torch.plan.overrides import apply_overrides
from spark_rapids_tpu_torch.sql import functions as TF
from spark_rapids_tpu_torch.utils.metrics import QueryStats as TStats

REL = 1e-9
TWO_PHASE = {"spark.rapids.tpu.sql.agg.singleProcessComplete": "false"}


def _key(r):
    return tuple((x is None, x if x is not None else 0) for x in r)


def _assert_rows_equal(got, want, ordered=False):
    if not ordered:
        got, want = sorted(got, key=_key), sorted(want, key=_key)
    assert len(got) == len(want), f"{len(got)} vs {len(want)} rows"
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if a is None or b is None:
                assert a is None and b is None, (g, w)
            elif isinstance(b, float):
                assert abs(a - b) <= REL * max(1.0, abs(b)), (g, w)
            else:
                assert a == b, (g, w)


def _metric(sess, name):
    ctx = sess.last_exec_context()
    return sum(ms.values.get(name, 0) for ms in ctx.metrics.values())


def _descs(node, want=("Aggregate", "ShuffleExchange")):
    """The explain strings of the aggregate and exchange nodes, top down."""
    out = []
    if any(w in type(node).__name__ for w in want):
        out.append(node.node_desc())
    for c in node.children:
        out += _descs(c, want)
    return out


def _both(build, tables, settings):
    """Run ``build(F, dfs)`` through both packages: (port rows, reference
    rows, port session, reference session, port fetches, reference
    fetches, port df, reference df)."""
    tsess = tsrt.Session(dict(settings), device="cpu")
    jsess = jsrt.Session(dict(settings))
    tdf = build(TF, {k: tsess.create_dataframe(v) for k, v in tables.items()})
    jdf = build(JF, {k: jsess.create_dataframe(v) for k, v in tables.items()})
    with JStats.scoped() as js:
        want = jdf.collect()
    with TStats.scoped() as ts:
        got = tdf.collect()
    return (got, want, tsess, jsess, ts.blocking_fetches, js.blocking_fetches,
            tdf, jdf)


def _check(build, tables, settings=TWO_PHASE):
    got, want, tsess, jsess, tf, jf, tdf, jdf = _both(build, tables,
                                                      settings)
    _assert_rows_equal(got, want)
    assert _metric(tsess, "skippedPartialAgg") == _metric(
        jsess, "skippedPartialAgg")
    assert _descs(apply_overrides(tdf._plan, tsess.conf())) == _descs(
        jsess._plan_physical(jdf._plan))
    assert tf <= jf
    return got, tsess


@pytest.fixture
def rng():
    return np.random.default_rng(19980902)


# ---------------------------------------------------------------------------------
# TPC-H Q1, Q3, Q10, Q18 with the split
# ---------------------------------------------------------------------------------

@pytest.fixture(scope="module")
def db():
    return tpch.gen_db_arrays(0.01)


@pytest.mark.parametrize("query,skips", [("q1", 0), ("q3", 1), ("q10", 1),
                                         ("q18", 1)])
def test_tpch_two_phase_matches_reference(db, query, skips):
    """Q1's four groups reduce: no skip.  Q3 and Q10 group by an order or
    a customer key, and Q18 lineitem by orderkey: ``gen_db_arrays`` draws
    lineitem's orderkeys in no order, so few repeat among the first
    batch's sampled rows, and the partial passes its rows through."""
    settings = {**TWO_PHASE, "spark.rapids.tpu.sql.batchSizeRows": 16384}
    names = tpch.SUITE_QUERIES[query]
    tsess, jsess = tsrt.Session(settings, device="cpu"), jsrt.Session(
        settings)
    with JStats.scoped() as js:
        want = getattr(tpch_suite, f"run_{query}")(
            {t: jsess.create_dataframe(db[t]) for t in names})
    with TStats.scoped() as ts:
        got = tpch.run_query(query, {t: tsess.create_dataframe(db[t])
                                     for t in names})
    _assert_rows_equal(got, want, ordered=True)
    _assert_rows_equal(got, tpch.query_oracle(query, db), ordered=True)
    assert (_metric(tsess, "skippedPartialAgg"),
            _metric(jsess, "skippedPartialAgg")) == (skips, skips)
    assert ts.blocking_fetches <= js.blocking_fetches


def test_tpch_explain_strings_match_reference(db):
    """Q3's and Q18's aggregate and exchange nodes as the reference plans
    them (``TpuHashAggregate [partial] ...``)."""
    import spark_rapids_tpu.sql.dataframe as jd
    import spark_rapids_tpu_torch.sql.dataframe as td
    for query in ("q3", "q18"):
        names = tpch.SUITE_QUERIES[query]
        tsess = tsrt.Session(TWO_PHASE, device="cpu")
        jsess = jsrt.Session(TWO_PHASE)
        seen = {}

        def grab(key):
            def collect(self):
                seen[key] = self
                return []
            return collect
        jc, tc = jd.DataFrame.collect, td.DataFrame.collect
        jd.DataFrame.collect, td.DataFrame.collect = grab("j"), grab("t")
        try:
            getattr(tpch_suite, f"run_{query}")(
                {t: jsess.create_dataframe(db[t]) for t in names})
            tpch.run_query(query, {t: tsess.create_dataframe(db[t])
                                   for t in names})
        finally:
            jd.DataFrame.collect, td.DataFrame.collect = jc, tc
        want = _descs(jsess._plan_physical(seen["j"]._plan))
        assert any("[partial]" in d for d in want)
        assert _descs(apply_overrides(seen["t"]._plan, tsess.conf())) == want


def test_single_process_complete_stays_one_pass(db):
    sess = tsrt.Session(device="cpu")
    df = tpch.q1(sess.create_dataframe(db["lineitem"]))
    descs = _descs(apply_overrides(df._plan, sess.conf()))
    assert descs and all("[complete]" in d for d in descs)


# ---------------------------------------------------------------------------------
# The skip probe and the buffers
# ---------------------------------------------------------------------------------

def _grouped(F, d):
    return d["t"].group_by("k").agg(
        F.sum(F.col("v")).alias("s"), F.count(F.col("v")).alias("c"),
        F.avg(F.col("v")).alias("a"), F.min(F.col("w")).alias("mn"),
        F.max(F.col("w")).alias("mx"), F.count_star().alias("n"))


@pytest.mark.parametrize("case", ["unique", "few", "nulls", "half",
                                  "filtered", "all_filtered"])
def test_skip_decision_matches_reference(rng, case):
    n = 5000
    k = {"unique": rng.permutation(n), "few": rng.integers(0, 7, n),
         "nulls": rng.integers(0, 4000, n), "half": rng.integers(0, 1500, n),
         "filtered": rng.permutation(n),
         "all_filtered": rng.permutation(n)}[case].astype(object)
    if case == "nulls":
        k[rng.random(n) < 0.5] = None
    v = rng.uniform(-10, 10, n).astype(object)
    v[rng.random(n) < 0.1] = None
    t = {"k": k if case == "nulls" else k.astype(np.int64), "v": v,
         "w": rng.integers(-100, 100, n), "f": rng.integers(0, 4, n)}

    def q(F, d):
        df = d["t"]
        if case == "filtered":
            df = df.filter(F.col("f") == 0)
        elif case == "all_filtered":
            df = df.filter(F.col("f") > 9)
        return _grouped(F, {"t": df})
    _check(q, {"t": t}, {**TWO_PHASE,
                         "spark.rapids.tpu.sql.batchSizeRows": 2048})


def test_string_keys_shared_dictionary(rng):
    """String keys through the split: the partial and the final share one
    dictionary, so codes stay comparable across the exchange, on the grid
    and on the hash path (high cardinality passes through)."""
    n = 4000
    few = np.array(["MAIL", "SHIP", "AIR", None], dtype=object)
    many = np.array([f"cust#{i:05d}" for i in rng.permutation(n)],
                    dtype=object)
    t = {"a": few[rng.integers(0, 4, n)], "b": many,
         "v": rng.uniform(0, 1, n)}
    for keys in (["a"], ["b"], ["a", "b"]):
        _check(lambda F, d: d["t"].group_by(*keys).agg(
            F.sum(F.col("v")).alias("s"), F.count_star().alias("n")),
            {"t": t}, {**TWO_PHASE,
                       "spark.rapids.tpu.sql.batchSizeRows": 1024})


def test_ratio_one_never_skips(rng):
    n = 3000
    t = {"k": rng.permutation(n), "v": rng.uniform(0, 1, n),
         "w": rng.integers(0, 9, n)}
    got, sess = _check(_grouped, {"t": t}, {
        **TWO_PHASE, "spark.rapids.tpu.sql.agg.skipPartialAggRatio": 1.0})
    assert _metric(sess, "skippedPartialAgg") == 0


def test_first_last_through_the_split(rng):
    """FIRST/LAST buffers (value, has) merge in stream order: one batch
    and one partition keep the order, so the answers are exact."""
    n = 3000
    v = rng.uniform(0, 1, n).astype(object)
    v[rng.random(n) < 0.3] = None
    t = {"k": rng.integers(0, 40, n), "v": v}
    settings = {**TWO_PHASE, "spark.rapids.tpu.sql.shuffle.partitions": 1}
    _check(lambda F, d: d["t"].group_by("k").agg(
        F.first(F.col("v")).alias("f"),
        F.first(F.col("v"), ignore_nulls=True).alias("fv"),
        F.last(F.col("v")).alias("l"),
        F.last(F.col("v"), ignore_nulls=True).alias("lv")), {"t": t},
        settings)


def test_repartition_fallback_matches_reference(rng):
    """A buffer row limit of a few hundred rows: the partial emits several
    times and the final re-partitions its groups into
    ``agg.repartitionBuckets`` disjoint buckets; the answers stay exact."""
    n = 20000
    t = {"k": rng.integers(0, 6000, n), "v": rng.uniform(0, 1, n),
         "w": rng.integers(-9, 9, n)}
    settings = {**TWO_PHASE, "spark.rapids.tpu.sql.batchSizeBytes": 8192,
                "spark.rapids.tpu.sql.batchSizeRows": 4096,
                "spark.rapids.tpu.sql.agg.skipPartialAggRatio": 1.0,
                "spark.rapids.tpu.sql.shuffle.partitions": 2}
    got, sess = _check(_grouped, {"t": t}, settings)
    assert _metric(sess, "aggRepartitions") > 0
    assert _metric(sess, "partialAggEmits") > 0


def test_repartition_bucket_past_the_limit_raises(rng):
    """One key per bucket cannot be split further: a bucket past the limit
    raises instead of answering from a truncated table."""
    n = 6000
    t = {"k": rng.integers(0, 3000, n), "v": rng.uniform(0, 1, n)}
    sess = tsrt.Session({**TWO_PHASE,
                         "spark.rapids.tpu.sql.batchSizeBytes": 256,
                         "spark.rapids.tpu.sql.agg.repartitionBuckets": 2,
                         "spark.rapids.tpu.sql.agg.skipPartialAggRatio": 1.0,
                         "spark.rapids.tpu.sql.shuffle.partitions": 1},
                        device="cpu")
    df = sess.create_dataframe(t).group_by("k").agg(
        TF.sum(TF.col("v")).alias("s"))
    with pytest.raises(RuntimeError, match="re-partition bucket"):
        df.collect()


# ---------------------------------------------------------------------------------
# The plain versions of the new kernels against the JAX programs
# ---------------------------------------------------------------------------------

@pytest.mark.parametrize("rows,distinct,dead", [
    (0, 1, 0.0), (1, 1, 0.0), (1000, 10, 0.0), (5000, 4000, 0.2),
    (1 << 18, 1 << 17, 0.5), (3000, 3000, 1.0)])
def test_group_ratio_plain_matches_reference_program(rows, distinct, dead):
    """(distinct, live) of the sampled 32-bit murmur3 hashes, exactly as
    the reference's sort-and-adjacent-distinct program counts them."""
    rng = np.random.default_rng(rows + distinct)
    keys = rng.integers(0, distinct, rows)
    active = rng.random(rows) >= dead
    jh = jhashing.hash_columns([(jnp.asarray(keys), None)]).astype(jnp.int64)
    big = jnp.int64(np.iinfo(np.int64).max)
    s = jnp.sort(jnp.where(jnp.asarray(active), jh, big))
    first = jnp.concatenate([jnp.ones((1,), bool), s[1:] != s[:-1]])
    want = [int(jnp.sum(first & (s != big))), int(active.sum())]
    th = hashing.hash_columns([(torch.from_numpy(keys), None)])
    assert np.array_equal(np.asarray(jh), th.numpy())
    got = groupby.group_ratio(th, torch.from_numpy(active))
    assert got.tolist() == want


@pytest.mark.parametrize("n", [1, 2, 7, 64, 1000])
def test_xxhash64_mod_plain_matches_reference(rng, n):
    """``xxhash64(keys, 42) % n`` of the UNSIGNED hash as int32, bit for
    bit with the reference's ``_split_by_key_hash`` ids, for int64, int32,
    float64 and nullable keys."""
    rows = 3000
    a = rng.integers(-2**63, 2**63 - 1, rows, dtype=np.int64)
    b = rng.integers(-2**31, 2**31 - 1, rows).astype(np.int32)
    c = rng.uniform(-1e9, 1e9, rows)
    c[::13] = np.nan
    c[::17] = -0.0
    bv = rng.random(rows) < 0.8
    jkeys = [(jnp.asarray(a), None), (jnp.asarray(b), jnp.asarray(bv)),
             (jnp.asarray(c), None)]
    want = (jhashing.xxhash64_columns(jkeys) % jnp.uint64(n)).astype(
        jnp.int32)
    tkeys = [(torch.from_numpy(a), None),
             (torch.from_numpy(b), torch.from_numpy(bv)),
             (torch.from_numpy(c), None)]
    active = torch.from_numpy(rng.random(rows) < 0.9)
    counts = torch.zeros(n + 1, dtype=torch.int64)
    got = hashing.xxhash64_mod(tkeys, n, active, counts=counts)
    assert np.array_equal(np.where(active.numpy(), np.asarray(want), n),
                          got.numpy())
    assert counts.tolist() == np.bincount(got.numpy(),
                                          minlength=n + 1).tolist()


def test_merge_ops_plain_match_reference_group_reduce(rng):
    """Buffer rows re-reduced with their merge ops: the hash aggregation's
    plain merge against the reference's ``group_reduce`` (``_merge_fn``):
    int64 sums, counts (summed), int64 and float64 min and max exactly,
    float64 sums within 1e-12 of the exact sum (the port sums in 128-bit
    fixed point, the reference in its sorted order)."""
    n = 4000
    k = rng.integers(0, 300, n)
    kv = rng.random(n) < 0.95
    cols = [(rng.integers(-2**40, 2**40, n), "sum"),
            (rng.integers(0, 50, n), "sum"),
            (rng.integers(-10**6, 10**6, n), "min"),
            (rng.uniform(-1e6, 1e6, n), "max"),
            (rng.uniform(-1e6, 1e6, n), "sum")]
    valid = [rng.random(n) < 0.9 for _ in cols]
    active = rng.random(n) < 0.97
    ok, ov, _, gmask = jgroupby.group_reduce(
        [(jnp.asarray(k), jnp.asarray(kv))],
        [((jnp.asarray(d), jnp.asarray(v)), op)
         for (d, op), v in zip(cols, valid)], jnp.asarray(active))
    def at(v, i):
        v = None if v is None else np.asarray(v)
        return True if v is None or v.ndim == 0 else bool(v[i])
    sel = np.asarray(gmask)
    want = {}
    for i in np.nonzero(sel)[0]:
        key = int(ok[0][0][i]) if at(ok[0][1], i) else None
        want[key] = [(np.asarray(d)[i].item(), at(v, i)) for d, v in ov]
    acc = groupby.HashAccumulator(
        1, [(op, d.dtype == np.float64) for d, op in cols], "cpu")
    acc.merge([(groupby.key_word(torch.from_numpy(k)),
                torch.from_numpy(kv))],
              [(torch.from_numpy(d), torch.from_numpy(v))
               for (d, _), v in zip(cols, valid)],
              torch.from_numpy(active), n)
    keys, values, live = acc.finish()
    got = {}
    for i in range(keys[0][0].shape[0]):
        if live is not None and not bool(live[i]):
            continue
        key = int(keys[0][0][i]) if bool(keys[0][1][i]) else None
        got[key] = [float(x[i]) if x.dtype == torch.float64 else int(x[i])
                    for x in values]
    assert set(got) == set(want)
    for key, row in want.items():
        for j, ((w, has), g, (d, op)) in enumerate(zip(row, got[key], cols)):
            if not has:
                continue   # a buffer no valid row reached: its identity
            if op == "sum" and d.dtype == np.float64:
                assert abs(g - w) <= 1e-12 * max(1.0, abs(w))
            else:
                assert g == w, (key, j)


def _merged(acc):
    """{key: per channel its value, or (value, has)} of a finished
    accumulator's live groups."""
    keys, values, live = acc.finish()
    out = {}
    for i in range(keys[0][0].shape[0]):
        if live is not None and not bool(live[i]):
            continue
        key = int(keys[0][0][i]) if bool(keys[0][1][i]) else None
        out[key] = [tuple(x[i].item() for x in v) if isinstance(v, tuple)
                    else v[i].item() for v in values]
    return out


def test_merges_through_one_pool_equal_fresh_tables():
    """A final aggregate lends one merge pool to each stream's table in
    turn: streams of different sizes and groups, one of them merged in
    three calls, each released before the next, give what fresh tables
    give, and a table refuses an update once it has merged."""
    rng = np.random.default_rng(31)
    channels = [("sum", True), ("sum", False), ("min", False), ("max", True),
                ("first_valid", True), ("last_valid", False)]
    pool = groupby.MergePool("cpu")
    for n, groups, batch in ((3000, 2000, 3000), (500, 7, 200),
                             (5000, 4000, 1700)):
        k = groupby.key_word(torch.from_numpy(rng.integers(0, groups, n)))
        kv = torch.from_numpy(rng.random(n) < 0.97)
        bufs = [(torch.from_numpy(rng.normal(size=n)), None),
                (torch.from_numpy(rng.integers(-99, 99, n)), None),
                (torch.from_numpy(rng.integers(-99, 99, n)),
                 torch.from_numpy(rng.random(n) < 0.8)),
                (torch.from_numpy(rng.normal(size=n)), None),
                (torch.from_numpy(rng.normal(size=n)),
                 torch.from_numpy(rng.random(n) < 0.5)),
                (torch.from_numpy(rng.integers(-99, 99, n)),
                 torch.from_numpy(rng.random(n) < 0.5))]
        active = torch.from_numpy(rng.random(n) < 0.95)
        got = []
        for p in (pool, None):
            acc = groupby.HashAccumulator(1, channels, "cpu", pool=p)
            for lo in range(0, n, batch):
                sl = slice(lo, lo + batch)
                acc.merge([(k[sl], kv[sl])],
                          [(d[sl], None if v is None else v[sl])
                           for d, v in bufs], active[sl],
                          int(active[sl].shape[0]))
            got.append(_merged(acc))
            acc.release()
            with pytest.raises(ValueError, match="updates or merges"):
                acc.update([(k, kv)], [(d, v) for d, v in bufs], active, n)
        assert got[0].keys() == got[1].keys()
        for key in got[0]:
            for a, b in zip(got[0][key], got[1][key]):
                assert a == b or (a != a and b != b), (key, a, b)
    assert pool.holder is None


def test_merge_refuses_a_count_channel():
    acc = groupby.HashAccumulator(1, [("count", False)], "cpu")
    with pytest.raises(ValueError, match="count"):
        acc.merge([(torch.zeros(2, dtype=torch.int64), None)],
                  [(torch.ones(2, dtype=torch.int64), None)], None, 2)


def test_merge_op_names():
    assert groupby.merge_op("count") == "sum"
    assert groupby.merge_op("sum") == "sum"
    assert groupby.merge_op("first") == "first_valid"
    assert groupby.merge_op("last_valid") == "last_valid"


def test_new_kernels_refuse_cpu_tensors():
    with pytest.raises((ValueError, RuntimeError)):
        groupby.group_ratio_kernel(torch.zeros(4, dtype=torch.int64), None)
    with pytest.raises((ValueError, RuntimeError)):
        hashing.xxhash64_mod_kernel([(torch.zeros(4, dtype=torch.int64),
                                      None)], 4)


def test_concat_of_codes_of_different_dictionaries():
    """Row 3-rest's dictionary half: batches whose string codes come from
    different dictionaries concatenate into their union dictionary (a
    device remap of each batch's codes), strings and nulls preserved."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.batch import (ColumnBatch, DictStringColumn,
                                              Field, Schema)
    from spark_rapids_tpu_torch.ops import batch_utils
    schema = Schema([Field("s", T.STRING, True)])
    a = np.array(["MAIL", "AIR", "SHIP"], dtype=object)
    b = np.array(["TRUCK", "AIR", "RAIL", "MAIL"], dtype=object)
    ca = torch.tensor([2, 0, 1, 1], dtype=torch.int32)
    cb = torch.tensor([0, 3, 2, 1, 0], dtype=torch.int32)
    vb = torch.tensor([True, True, False, True, True])
    out = batch_utils.concat_batches([
        ColumnBatch(schema, [DictStringColumn(ca, None, a)], 4),
        ColumnBatch(schema, [DictStringColumn(cb, vb, b)], 5)])
    col = out.columns[0]
    got = [None if col.valid is not None and not bool(col.valid[i])
           else col.dictionary[int(col.codes[i])] for i in range(9)]
    assert got == ["SHIP", "MAIL", "AIR", "AIR", "TRUCK", "MAIL", None,
                   "AIR", "TRUCK"]
    assert len(set(col.dictionary.tolist())) == len(col.dictionary) == 5


@pytest.mark.parametrize("shape", ["one_group", "far_floats", "all_dead"])
def test_merge_edges_match_reference_group_reduce(shape):
    """The plain merge on the hash kernel's risky shapes (every buffer row
    in one group, float64 sum buffers far outside any query scale's range,
    every row dead) against the reference's ``group_reduce`` with the same
    merge ops."""
    rng = np.random.default_rng(92)
    n = 3000
    k = np.zeros(n, np.int64) if shape == "one_group" \
        else rng.integers(0, 200, n)
    kv = rng.random(n) < 0.95
    x = rng.uniform(-1e6, 1e6, n)
    if shape == "far_floats":
        pick = rng.random(n)
        x[pick < 0.05] = 1e-30
        x[pick > 0.95] = 1e30
    cols = [(rng.integers(-2**40, 2**40, n), "sum"),
            (rng.integers(-10**6, 10**6, n), "min"),
            (rng.uniform(-1e6, 1e6, n), "max"), (x, "sum")]
    valid = [rng.random(n) < 0.9 for _ in cols]
    active = rng.random(n) < (0.0 if shape == "all_dead" else 0.97)
    ok, ov, _, gmask = jgroupby.group_reduce(
        [(jnp.asarray(k), jnp.asarray(kv))],
        [((jnp.asarray(d), jnp.asarray(v)), op)
         for (d, op), v in zip(cols, valid)], jnp.asarray(active))

    def at(v, i):
        v = None if v is None else np.asarray(v)
        return True if v is None or v.ndim == 0 else bool(v[i])
    want = {}
    for i in np.nonzero(np.asarray(gmask))[0]:
        key = int(ok[0][0][i]) if at(ok[0][1], i) else None
        want[key] = [(np.asarray(d)[i].item(), at(v, i)) for d, v in ov]
    acc = groupby.HashAccumulator(
        1, [(op, d.dtype == np.float64) for d, op in cols], "cpu")
    for lo in range(0, n, 1100):
        sl = slice(lo, lo + 1100)
        acc.merge([(groupby.key_word(torch.from_numpy(k[sl])),
                    torch.from_numpy(kv[sl]))],
                  [(torch.from_numpy(d[sl]), torch.from_numpy(v[sl]))
                   for (d, _), v in zip(cols, valid)],
                  torch.from_numpy(active[sl]), len(k[sl]))
    keys, values, live = acc.finish()
    got = {}
    for i in range(keys[0][0].shape[0]):
        if live is not None and not bool(live[i]):
            continue
        key = int(keys[0][0][i]) if bool(keys[0][1][i]) else None
        got[key] = [float(v[i]) if v.dtype == torch.float64 else int(v[i])
                    for v in values]
    assert set(got) == set(want)
    for key, row in want.items():
        for j, ((w, has), g, (d, op)) in enumerate(zip(row, got[key], cols)):
            if not has:
                continue
            if op == "sum" and d.dtype == np.float64:
                assert abs(g - w) <= 1e-12 * max(1.0, abs(w)), (key, j)
            else:
                assert g == w, (key, j)
