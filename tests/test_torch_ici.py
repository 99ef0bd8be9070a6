"""shuffle.mode=ICI in the port: plan fragments run shard by shard over a
device mesh (``parallel/spmd.py``), the exchange a bucketize and a swap of
the bucket axis (``parallel/exchange.py``).

The reference runs its fragments as one ``shard_map`` program over the 8
virtual CPU devices of the conftest; the port runs over
``Session.set_mesh(["cpu"] * 8)``.  The cases of the reference's
``tests/test_ici.py`` run through both packages on the same numpy data:
rows equal as multisets (ints, strings and dates exactly, float64 within
rel 1e-9: the packages sum in different orders), and equal to the port's
own single-process CACHE_ONLY rows.  The kernels' plain versions
(``bucketize``, the exchange, ``exchange_grouped_agg``) are held against
the JAX functions and numpy, and the TPC-H queries the reference lowers
whole (Q1, Q3, Q10, Q18) against the reference, the numpy oracles and the
reference's blocking fetch count.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import spark_rapids_tpu as jsrt
from spark_rapids_tpu.models import tpch_suite
from spark_rapids_tpu.parallel import exchange as jexchange
from spark_rapids_tpu.sql import functions as JF
from spark_rapids_tpu.utils.metrics import QueryStats as JStats
import spark_rapids_tpu_torch as tsrt
from spark_rapids_tpu_torch.models import tpch
from spark_rapids_tpu_torch.parallel import exchange as texchange
from spark_rapids_tpu_torch.parallel import spmd
from spark_rapids_tpu_torch.sql import functions as TF
from spark_rapids_tpu_torch.utils.metrics import QueryStats as TStats

REL = 1e-9
MESH = ["cpu"] * 8
ICI = {"spark.rapids.tpu.shuffle.mode": "ICI"}
NO_BROADCAST = {"spark.rapids.tpu.sql.autoBroadcastJoinThreshold": -1}


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


def _port(settings=None, mesh=MESH):
    s = tsrt.Session(dict(settings or {}), device="cpu")
    s.set_mesh(mesh)
    return s


def _run(build, tables, settings=None, reference=True):
    """(port ICI rows, port CACHE_ONLY rows, reference ICI rows or None):
    ``build(F, dfs)`` makes the query over {name: DataFrame}."""
    settings = dict(settings or {})
    out = []
    for extra in (ICI, {}):
        sess = _port({**settings, **extra})
        out.append(build(TF, {k: sess.create_dataframe(v)
                              for k, v in tables.items()}).collect())
    if reference:
        jsess = jsrt.Session({**settings, **ICI})
        out.append(build(JF, {k: jsess.create_dataframe(v)
                              for k, v in tables.items()}).collect())
    else:
        out.append(None)
    return out


def _check(build, tables, settings=None, reference=True):
    got, single, ref = _run(build, tables, settings, reference)
    _assert_rows_equal(got, single)
    if ref is not None:
        _assert_rows_equal(got, ref)
    return got


@pytest.fixture
def rng():
    return np.random.default_rng(20240607)


def _tables(rng, no=400, nl=2500, null_keys=False):
    lk = rng.integers(0, no + 60, nl).astype(object)  # some match nothing
    if null_keys:
        lk[::17] = None
    orders = {"o_orderkey": np.arange(no, dtype=np.int64),
              "o_custkey": rng.integers(0, 37, no),
              "o_flag": rng.integers(0, 2, no)}
    items = {"l_orderkey": lk if null_keys else lk.astype(np.int64),
             "l_price": rng.uniform(1.0, 1000.0, nl),
             "l_qty": rng.integers(1, 50, nl)}
    return {"orders": orders, "items": items}


# ---------------------------------------------------------------------------------
# The reference's test_ici.py cases
# ---------------------------------------------------------------------------------

def test_ici_grouped_agg(rng):
    n = 6000
    t = {"k": rng.integers(0, 61, n), "v": rng.uniform(0, 100, n),
         "w": rng.integers(-5, 5, n)}
    _check(lambda F, d: d["t"].group_by("k").agg(
        F.sum(F.col("v")).alias("s"), F.count(F.col("v")).alias("c"),
        F.avg(F.col("v")).alias("a"), F.min(F.col("w")).alias("mn"),
        F.max(F.col("w")).alias("mx")), {"t": t})


def test_ici_string_group_keys(rng):
    n = 3000
    cats = np.array(["alpha", "beta", "gamma", "delta", None], dtype=object)
    t = {"k": cats[np.arange(n) % 5], "v": rng.uniform(0, 10, n)}
    _check(lambda F, d: d["t"].group_by("k").agg(
        F.sum(F.col("v")).alias("s")), {"t": t})


@pytest.mark.parametrize("how", ["inner", "left", "right", "full",
                                 "left_semi", "left_anti"])
def test_ici_join_types(rng, how):
    _check(lambda F, d: d["orders"].join(
        d["items"], [("o_orderkey", "l_orderkey")], how),
        _tables(rng, null_keys=True), NO_BROADCAST)


def test_ici_q3_shape(rng):
    """join + filter + group-by + order-by: the fragment is join .. final
    aggregate, the sort runs above it (exact ordered comparison)."""
    def q(F, d):
        return (d["orders"].join(d["items"], [("o_orderkey", "l_orderkey")],
                                 "inner")
                .filter(F.col("o_flag") == 1).group_by("o_custkey")
                .agg(F.sum(F.col("l_price")).alias("rev"),
                     F.count(F.col("l_qty")).alias("cnt"))
                .sort(F.col("rev").desc()))
    got, single, ref = _run(q, _tables(rng), NO_BROADCAST)
    _assert_rows_equal(got, single, ordered=True)
    _assert_rows_equal(got, ref, ordered=True)


def test_ici_residual_condition_inner(rng):
    _check(lambda F, d: d["orders"].join(
        d["items"], [("o_orderkey", "l_orderkey")], "inner")
        .filter(F.col("l_price") > F.col("o_custkey") * 10.0),
        _tables(rng), NO_BROADCAST)


def test_ici_string_predicate_leaf(rng):
    """A host string predicate below the aggregate: the stage runs
    single-process as a leaf, the exchange still runs on the mesh."""
    n = 2000
    cats = np.array(["BUILDING", "MACHINERY", "AUTOMOBILE"], dtype=object)
    t = {"seg": cats[np.arange(n) % 3], "k": rng.integers(0, 9, n),
         "v": rng.uniform(0, 10, n)}
    with TStats.scoped() as st:
        _check(lambda F, d: d["t"].filter(F.col("seg") == "BUILDING")
               .group_by("k").agg(F.sum(F.col("v")).alias("s")), {"t": t})
    assert st.ici_fragments == 1


def test_ici_two_fragments(rng):
    """A limit between a shuffled join and an aggregation: the limit does
    not lower, so the join fragment runs first, the limit single-process,
    then the aggregation as a second fragment (a leaf never swallows an
    exchange)."""
    def q(F, d):
        return (d["orders"].join(d["items"], [("o_orderkey", "l_orderkey")],
                                 "inner").limit(100000)
                .group_by("o_custkey")
                .agg(F.sum(F.col("l_price")).alias("rev")))
    with TStats.scoped() as st:
        _check(q, _tables(rng, no=200, nl=1200), NO_BROADCAST)
    assert st.ici_fragments == 2


def test_ici_two_fragments_union(rng):
    """The reference's case as written: a union of two aggregations.  A
    union does not lower, so each aggregation runs as its own mesh
    fragment."""
    n = 2000
    t = {"k": rng.integers(0, 11, n), "v": rng.uniform(0, 5, n)}

    def q(F, d):
        d1 = d["t"].group_by("k").agg(F.sum(F.col("v")).alias("s"))
        d2 = d["t"].group_by("k").agg(F.min(F.col("v")).alias("s"))
        return d1.union(d2)
    with TStats.scoped() as st:
        got = _check(q, {"t": t})
    assert len(got) == 22
    # the reference's run does not count in the port's stats
    assert st.ici_fragments == 2


def test_ici_host_predicate_above_join(rng):
    """A host string predicate over a shuffled join's output."""
    tables = _tables(rng, no=200, nl=1200)
    tables["orders"]["o_seg"] = np.array(
        ["BUILDING", "MACHINERY"] * 100, dtype=object)
    _check(lambda F, d: d["orders"].join(
        d["items"], [("o_orderkey", "l_orderkey")], "inner")
        .filter(F.col("o_seg") == "BUILDING").group_by("o_custkey")
        .agg(F.sum(F.col("l_price")).alias("rev")), tables, NO_BROADCAST)


def _overflow_table(rng):
    n = 4000
    return {"t": {"k": rng.integers(0, 500, n), "v": rng.uniform(0, 1, n)}}


def test_ici_bucket_overflow_detected(rng):
    """~500 rows a device, ~400 groups sent to 8 destinations: buckets of
    2, 8 and 32 rows (the first run and two 4x retries) all overflow, and
    the query raises naming the conf — never a short answer."""
    sess = _port({**ICI, "spark.rapids.tpu.shuffle.ici.bucketRows": 2})
    df = sess.create_dataframe(_overflow_table(rng)["t"]).group_by("k").agg(
        TF.sum(TF.col("v")).alias("s"))
    with pytest.raises(spmd.ICICapacityOverflow, match="bucketRows"):
        df.collect()


def test_ici_bucket_overflow_transparent_recovery(rng):
    """A bucket one notch too small does not surface: the fragment runs
    again at 4x capacities and answers as CACHE_ONLY does."""
    tables = _overflow_table(rng)
    with TStats.scoped() as st:
        got, single, ref = _run(
            lambda F, d: d["t"].group_by("k").agg(
                F.sum(F.col("v")).alias("s")), tables,
            {"spark.rapids.tpu.shuffle.ici.bucketRows": 32})
    assert st.ici_retries == 1
    _assert_rows_equal(got, single)
    _assert_rows_equal(got, ref)


def test_ici_join_overflow_retried(rng):
    """A join expansion past ``joinOutputRows`` is retried the same way."""
    tables = _tables(rng)
    # ten keys: ~100,000 output rows, each key's on one shard, against a
    # first capacity of 1,024 rows (the capacity ladder's floor), then 4x
    # per retry
    tables["orders"]["o_orderkey"] %= 10
    tables["items"]["l_orderkey"] %= 10
    with TStats.scoped() as st:
        _check(lambda F, d: d["orders"].join(
            d["items"], [("o_orderkey", "l_orderkey")], "inner"), tables,
            {**NO_BROADCAST, "spark.rapids.tpu.shuffle.ici.joinOutputRows":
             64, "spark.rapids.tpu.shuffle.ici.overflowRetries": 5},
            reference=False)
    assert st.ici_retries >= 1


def test_ici_exchange_never_silently_degrades():
    """An exchange reached by the single-process executor under ICI raises
    unless shuffle.ici.fallback is set."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.config import TpuConf
    from spark_rapids_tpu_torch.exprs import BoundReference
    from spark_rapids_tpu_torch.plan.exchange_exec import ShuffleExchangeExec
    from spark_rapids_tpu_torch.plan.physical import ExecContext
    sess = _port()
    scan = sess.create_dataframe({"x": np.array([1, 2, 3])})
    from spark_rapids_tpu_torch.plan.overrides import apply_overrides
    phys = apply_overrides(scan._plan, sess.conf())
    exch = ShuffleExchangeExec(phys, [BoundReference(0, T.INT64, False, "x")],
                               4, {})
    ctx = ExecContext(TpuConf(ICI), torch.device("cpu"))
    with pytest.raises(RuntimeError, match="ICI"):
        list(exch.execute(ctx))
    ctx = ExecContext(TpuConf({**ICI,
                               "spark.rapids.tpu.shuffle.ici.fallback": True}),
                      torch.device("cpu"))
    assert sum(b.num_rows for b in exch.execute(ctx)) == 3


def test_ici_avg_and_compound_aggs(rng):
    """The reference's aggregates with their arithmetic in a projection
    above them (the form the port ran before it split ``agg``'s
    expressions; ``test_ici_avg_and_compound_aggs_as_written`` runs the
    reference's own)."""
    n = 3000
    t = {"k": rng.integers(0, 23, n), "v": rng.uniform(0, 100, n)}
    _check(lambda F, d: d["t"].group_by("k").agg(
        F.sum(F.col("v")).alias("s"), F.max(F.col("v")).alias("mx"),
        F.min(F.col("v")).alias("mn"), F.avg(F.col("v")).alias("a"))
        .select(F.col("k"), (F.col("s") * 0.2).alias("fifth"),
                (F.col("mx") - F.col("mn")).alias("spread"), F.col("a")),
        {"t": t})


def test_ici_avg_and_compound_aggs_as_written(rng):
    """The reference's case as written: ``sum(v) * 0.2`` and ``max - min``
    inside ``agg``, split into an aggregate of plain calls and a
    projection above it."""
    n = 3000
    t = {"k": rng.integers(0, 23, n), "v": rng.uniform(0, 100, n)}
    with TStats.scoped() as st:
        got = _check(lambda F, d: d["t"].group_by("k").agg(
            (F.sum(F.col("v")) * 0.2).alias("fifth"),
            (F.max(F.col("v")) - F.min(F.col("v"))).alias("spread")),
            {"t": t})
    assert len(got) == 23
    assert st.ici_fragments == 1


@pytest.mark.parametrize("how", ["inner", "left", "left_semi", "left_anti"])
def test_ici_broadcast_join_types(rng, how):
    """Broadcast joins on the mesh: the build side goes whole to every
    device; the aggregate above still exchanges."""
    def q(F, d):
        joined = d["items"].join(d["orders"], [("l_orderkey", "o_orderkey")],
                                 how)
        key = "l_qty" if how in ("left_semi", "left_anti") else "o_custkey"
        return joined.group_by(key).agg(F.sum(F.col("l_price")).alias("rev"))
    _check(q, _tables(rng, null_keys=True))


def test_ici_broadcast_right_outer(rng):
    """how=right builds the (small) left side."""
    _check(lambda F, d: d["orders"].join(
        d["items"], [("o_orderkey", "l_orderkey")], "right")
        .group_by("l_qty").agg(F.count(F.col("l_price")).alias("c")),
        _tables(rng))


def _with_condition(F, joined):
    joined._plan.condition = (F.col("o_custkey") * 30.0
                              < F.col("l_price")).expr
    return joined


@pytest.mark.parametrize("how", ["left", "left_semi", "left_anti"])
def test_ici_conditioned_noninner_join(rng, how):
    """Non-inner joins with a residual condition do not lower (the
    condition takes part in the matching); they run single-process while
    the exchanges below them still run on the mesh."""
    _check(lambda F, d: _with_condition(F, d["orders"].join(
        d["items"], [("o_orderkey", "l_orderkey")], how)),
        _tables(rng, null_keys=True),
        {**NO_BROADCAST, "spark.rapids.tpu.shuffle.ici.fallback": True})


@pytest.mark.parametrize("how", ["left", "left_semi", "left_anti"])
def test_ici_conditioned_broadcast_noninner(rng, how):
    _check(lambda F, d: _with_condition(F, d["items"].join(
        d["orders"], [("l_orderkey", "o_orderkey")], how)),
        _tables(rng, null_keys=True))


def test_ici_existence_join_runs_single_process(rng):
    def q(F, d):
        sub = d["orders"].filter(F.col("o_flag") == 1).select("o_orderkey")
        return d["items"].filter(F.col("l_orderkey").isin_subquery(sub)
                                 | (F.col("l_price") > 900.0))
    _check(q, _tables(rng), NO_BROADCAST)


# ---------------------------------------------------------------------------------
# TPC-H on the mesh
# ---------------------------------------------------------------------------------

@pytest.fixture(scope="module")
def db():
    return tpch.gen_db_arrays(0.01)


@pytest.mark.parametrize("query", ["q1", "q3", "q10", "q18"])
def test_tpch_on_the_mesh(db, query):
    """The queries the reference lowers whole with ici.fallback=false:
    rows equal the reference's and the oracle's; one fragment each; the
    port's blocking fetches at most the reference's."""
    settings = {"spark.rapids.tpu.sql.batchSizeRows": 16384, **ICI}
    names = tpch.SUITE_QUERIES[query]
    jsess = jsrt.Session(settings)
    with JStats.scoped() as js:
        want = getattr(tpch_suite, f"run_{query}")(
            {t: jsess.create_dataframe(db[t]) for t in names})
    sess = _port(settings)
    with TStats.scoped() as ts:
        got = tpch.run_query(query, {t: sess.create_dataframe(db[t])
                                     for t in names})
    _assert_rows_equal(got, want, ordered=True)
    _assert_rows_equal(got, tpch.query_oracle(query, db), ordered=True)
    assert ts.ici_fragments == 1
    assert ts.blocking_fetches <= js.blocking_fetches


def test_tpch_q3_overflow_retry_returns_every_row(db):
    """Q3 with buckets far too small: retried, never short."""
    settings = {"spark.rapids.tpu.sql.batchSizeRows": 16384, **ICI,
                "spark.rapids.tpu.shuffle.ici.bucketRows": 4,
                "spark.rapids.tpu.shuffle.ici.overflowRetries": 6}
    sess = _port(settings)
    with TStats.scoped() as ts:
        got = tpch.run_query("q3", {t: sess.create_dataframe(db[t])
                                    for t in tpch.SUITE_QUERIES["q3"]})
    assert ts.ici_retries >= 1
    _assert_rows_equal(got, tpch.query_oracle("q3", db), ordered=True)


def test_ici_mesh_of_one_device(db):
    """``ici_mesh()`` of a CPU session: its one device."""
    sess = tsrt.Session({"spark.rapids.tpu.sql.batchSizeRows": 16384, **ICI},
                        device="cpu")
    assert sess.ici_mesh() == [torch.device("cpu")]
    got = tpch.run_query("q3", {t: sess.create_dataframe(db[t])
                                for t in tpch.SUITE_QUERIES["q3"]})
    _assert_rows_equal(got, tpch.query_oracle("q3", db), ordered=True)


# ---------------------------------------------------------------------------------
# The distributed aggregate step
# ---------------------------------------------------------------------------------

def test_distributed_agg_collect_matches_reference(db):
    """``distributed_agg_collect``: lineitem grouped by (returnflag,
    linestatus) in one distributed step over the 8-shard mesh."""
    from jax.sharding import Mesh
    from spark_rapids_tpu.parallel import distributed as jdist
    from spark_rapids_tpu_torch.parallel import distributed as tdist
    li = {k: db["lineitem"][k] for k in ("l_returnflag", "l_linestatus",
                                         "l_quantity", "l_extendedprice")}
    flag = (li["l_returnflag"] == "R").astype(np.int64)
    num = {"flag": flag, "status": (li["l_linestatus"] == "F").astype(
        np.int64), "q": li["l_quantity"], "p": li["l_extendedprice"]}

    def q(F, df):
        return df.group_by("flag", "status").agg(
            F.sum(F.col("q")).alias("sq"), F.avg(F.col("p")).alias("ap"),
            F.count_star().alias("n"))
    import pyarrow as pa
    jsess = jsrt.Session({"spark.rapids.tpu.sql.agg.singleProcessComplete":
                          "false"})
    jdf = q(JF, jsess.create_dataframe(num))
    want = jdist.distributed_agg_collect(
        jdf, Mesh(np.array(jax.devices()), ("data",)), pa.table(num))
    sess = tsrt.Session({"spark.rapids.tpu.sql.agg.singleProcessComplete":
                         "false"}, device="cpu")
    got = tdist.distributed_agg_collect(q(TF, sess.create_dataframe(num)),
                                        MESH, num)
    _assert_rows_equal(got, want)
    # string keys ride as codes of one dictionary
    got_s = tdist.distributed_agg_collect(
        q(TF, sess.create_dataframe(li).select(
            TF.col("l_returnflag").alias("flag"),
            TF.col("l_linestatus").alias("status"),
            TF.col("l_quantity").alias("q"),
            TF.col("l_extendedprice").alias("p"))), MESH, li)
    want_s = q(TF, sess.create_dataframe(li).select(
        TF.col("l_returnflag").alias("flag"),
        TF.col("l_linestatus").alias("status"),
        TF.col("l_quantity").alias("q"),
        TF.col("l_extendedprice").alias("p"))).collect()
    _assert_rows_equal(got_s, want_s)


# ---------------------------------------------------------------------------------
# The plain versions of the mesh kernels
# ---------------------------------------------------------------------------------

BUCKET_CASES = [
    # (rows, n_parts, bucket_cap, dead share)
    (1000, 8, 256, 0.1),      # no overflow
    (1000, 8, 64, 0.0),       # overflow in most buckets
    (3000, 64, 16, 0.3),      # 64 destinations
    (512, 4, 128, 0.0),       # every bucket exactly full
    (700, 4, 128, 0.0),       # the last bucket full and overflowing
    (300, 8, 32, 1.0),        # every row dead
    (0, 8, 32, 0.0),          # an empty batch
]


@pytest.mark.parametrize("rows,n_parts,cap,dead", BUCKET_CASES)
def test_bucketize_plain_matches_reference(rows, n_parts, cap, dead):
    rng = np.random.default_rng(rows + n_parts)
    if (rows, cap) in ((512, 128), (700, 128)):
        pids = np.repeat(np.arange(n_parts), -(-rows // n_parts))[:rows]
        pids = rng.permutation(pids)
    else:
        pids = rng.integers(0, n_parts, rows)
    pids = pids.astype(np.int32)
    active = rng.random(rows) >= dead
    arrays = [rng.integers(-2**62, 2**62, rows), rng.integers(
        -2**31, 2**31 - 1, rows).astype(np.int32), rng.uniform(-1, 1, rows),
        rng.random(rows) < 0.5]
    jb, js, jo = jexchange.bucketize(jnp.asarray(pids), jnp.asarray(active),
                                     n_parts, cap,
                                     [jnp.asarray(a) for a in arrays])
    tb, ts, to = texchange.bucketize(torch.from_numpy(pids),
                                     torch.from_numpy(active), n_parts, cap,
                                     [torch.from_numpy(a) for a in arrays])
    assert np.array_equal(np.asarray(js), ts.numpy())
    assert int(jo) == int(to)
    for j, t, a in zip(jb, tb, arrays):
        assert t.dtype == torch.from_numpy(a).dtype
        assert np.array_equal(np.asarray(j), t.numpy())
    # every live row within capacity lands, none is clamped into a slot
    kept = int(ts.sum())
    assert kept + int(to) == int(active.sum())


LIMIT_CASES = [
    # (rows, n_parts, bucket_cap, destinations)
    (500, 1, 64, "uniform"),       # one destination
    (3000, 256, 8, "uniform"),     # the most destinations of one byte
    (3000, 257, 8, "uniform"),     # one past it
    (5000, 4096, 2, "uniform"),    # BZ_MAX_PARTS
    (400, 8, 0, "uniform"),        # no capacity: every live row overflows
    (600, 8, 100, "one"),          # one destination takes every row
    (600, 8, 1000, "one"),         # ... and keeps them all
]


@pytest.mark.parametrize("rows,n_parts,cap,dest", LIMIT_CASES)
def test_bucketize_plain_matches_reference_at_the_limits(rows, n_parts, cap,
                                                         dest):
    """The plain bucketize against the JAX package's at the destination
    counts and capacities the kernel's paths turn on."""
    rng = np.random.default_rng(rows * 7 + n_parts + cap)
    pids = (rng.integers(0, n_parts, rows) if dest == "uniform"
            else np.full(rows, n_parts - 3)).astype(np.int32)
    active = rng.random(rows) >= 0.2
    arrays = [rng.integers(-2**62, 2**62, rows),
              rng.integers(-2**15, 2**15, rows).astype(np.int16),
              rng.uniform(-1, 1, rows), rng.random(rows) < 0.5]
    jb, js, jo = jexchange.bucketize(jnp.asarray(pids), jnp.asarray(active),
                                     n_parts, cap,
                                     [jnp.asarray(a) for a in arrays])
    tb, ts, to = texchange.bucketize(torch.from_numpy(pids),
                                     torch.from_numpy(active), n_parts, cap,
                                     [torch.from_numpy(a) for a in arrays])
    assert np.array_equal(np.asarray(js), ts.numpy())
    assert int(jo) == int(to)
    for j, t in zip(jb, tb):
        assert tuple(t.shape) == (n_parts, cap)
        assert np.array_equal(np.asarray(j), t.numpy())
    assert int(ts.sum()) + int(to) == int(active.sum())
    if cap == 0:
        assert int(to) == int(active.sum())


def test_exchange_swaps_the_bucket_axis():
    """Shard d receives buckets[s][d] of every shard s, in source order,
    with the transposed counts (``lax.all_to_all`` over the mesh)."""
    n_dev, cap = 4, 3
    bucketed = [[torch.arange(s * 100, s * 100 + n_dev * cap).reshape(
        n_dev, cap)] for s in range(n_dev)]
    sent = [torch.tensor([s, d, 1, 2], dtype=torch.int32)[:n_dev]
            for s, d in zip(range(n_dev), range(n_dev))]
    recv, counts = texchange.exchange(bucketed, sent, [torch.device("cpu")]
                                      * n_dev)
    for d in range(n_dev):
        want = torch.cat([bucketed[s][0][d] for s in range(n_dev)])
        assert torch.equal(recv[d][0], want)
        assert counts[d].tolist() == [int(sent[s][d]) for s in range(n_dev)]


def test_exchange_grouped_agg_matches_numpy(rng):
    """One distributed group-by step over 8 shards equals a numpy
    group-by of all rows (sums exact in fixed point, counts exact)."""
    n, n_dev = 5000, 8
    k = rng.integers(0, 300, n)
    v = rng.uniform(-5, 5, n)
    shards = []
    per = -(-n // n_dev)
    for s in range(n_dev):
        ks = torch.from_numpy(k[s * per:(s + 1) * per])
        vs = torch.from_numpy(v[s * per:(s + 1) * per])
        m = ks.shape[0]
        shards.append(([(ks, None)], [(vs, None), (None, None)],
                       torch.ones(m, dtype=torch.bool), m))
    out, overflow = texchange.exchange_grouped_agg(
        shards, [torch.int64], [("sum", True), ("count", False)],
        [torch.device("cpu")] * n_dev, bucket_cap=400)
    assert sum(int(o) for o in overflow) == 0
    got = {}
    for (keys, values, live) in out:
        sel = torch.ones_like(keys[0][0], dtype=torch.bool) if live is None \
            else live
        for kk, s, c in zip(keys[0][0][sel].tolist(),
                            values[0][sel].tolist(), values[1][sel].tolist()):
            assert kk not in got  # each key on exactly one shard
            got[kk] = (s, c)
    for kk in np.unique(k):
        sel = k == kk
        assert got[int(kk)][1] == int(sel.sum())
        assert abs(got[int(kk)][0] - v[sel].sum()) <= 1e-12 * np.abs(
            v[sel]).sum() + 1e-300


def test_mesh_kernels_refuse_cpu_tensors():
    with pytest.raises(ValueError):
        texchange.bucketize_kernel(torch.zeros(4, dtype=torch.int32), None,
                                   2, 4, [torch.zeros(4)])
