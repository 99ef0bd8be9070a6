"""The window operator of the port (``windowfns.py``, ``ops/window.py``,
``plan/window_exec.py``) against the JAX package's ``Session``, on the CPU
(the port's plain versions).

Every window function, under every frame kind ``device_support_reason``
puts on the device, over nullable partition and order keys with ties:
integers, dates and ranks exact; float sums and averages within 1e-12 x
the column's sum of |x|, which bounds the running sum of |x| that the
reference's prefix-difference error follows; min/max exact.  Both packages
emit rows in the window's sorted order, so rows compare in order."""

import numpy as np
import pytest

import spark_rapids_tpu as jsrt
from spark_rapids_tpu.sql import functions as JF
from spark_rapids_tpu.sql.window import Window as JW
from spark_rapids_tpu.utils.metrics import QueryStats as JStats
import spark_rapids_tpu_torch as tsrt
from spark_rapids_tpu_torch.sql import functions as TF
from spark_rapids_tpu_torch.sql.window import Window as TW

SETTINGS = {"spark.rapids.tpu.sql.batchSizeRows": 256}
REL = 1e-12


def table(n: int = 700, seed: int = 11) -> dict:
    """g: int64 partitions with nulls; t: int32 order key with ties and
    nulls; d: dates; x: float64 with nulls; i: int64 with nulls."""
    rng = np.random.default_rng(seed)

    def nullable(vals, frac, kind):
        return np.array([None if rng.random() < frac else kind(v)
                         for v in vals], dtype=object)
    return {
        "g": nullable(rng.integers(0, 9, n), 0.05, int),
        "t": nullable(rng.integers(-20, 20, n), 0.1, int).astype(object),
        "d": (np.datetime64("1996-03-01")
              + rng.integers(0, 60, n).astype("timedelta64[D]")),
        "x": nullable(np.round(rng.uniform(-100, 100, n), 3), 0.1, float),
        "i": nullable(rng.integers(-50, 50, n), 0.1, int),
        "k": np.arange(n, dtype=np.int64),
    }


@pytest.fixture(scope="module")
def data():
    return table()


@pytest.fixture(scope="module")
def sessions():
    return jsrt.Session(SETTINGS), tsrt.Session(SETTINGS, device="cpu")


def _tolerance(data) -> float:
    xs = [abs(v) for v in data["x"] if v is not None]
    xs += [abs(v) for v in data["i"] if v is not None]
    return REL * max(sum(xs), 1.0)


def _compare(got, want, tol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(b, float) and a is not None:
                assert abs(a - b) <= tol, (g, w)
            else:
                assert a == b, (g, w)


def _run(sessions, data, build):
    """(port rows, reference rows, port fetches, reference fetches,
    explains)."""
    jsess, tsess = sessions
    jdf = build(jsess.create_dataframe(data), JF, JW)
    tdf = build(tsess.create_dataframe(data), TF, TW)
    with JStats.scoped() as st:
        want = jdf.collect()
    got = tdf.collect()
    return (got, want, tsess.last_query_stats().blocking_fetches,
            st.blocking_fetches, tdf.explain_string(), jdf.explain_string())


def _spec(W, F, desc=False, nulls_last=False):
    o = F.col("t")
    o = (o.desc() if not nulls_last else o.desc_nulls_first()) if desc \
        else (o.asc_nulls_last() if nulls_last else o.asc())
    return W.partition_by("g").order_by(o, "k")


def _frames(W):
    up, uf = W.unboundedPreceding, W.unboundedFollowing
    return {
        "unbounded": lambda s: s.rows_between(up, uf),
        "running_rows": lambda s: s.rows_between(up, 0),
        "running_range": lambda s: s,             # the default frame
        "rows_-2_1": lambda s: s.rows_between(-2, 1),
        "rows_2_5": lambda s: s.rows_between(2, 5),      # empty at the end
        "rows_-3_uf": lambda s: s.rows_between(-3, uf),
        "rows_up_2": lambda s: s.rows_between(up, 2),
    }


AGGS = ("sum", "count", "count_star", "avg", "min", "max")


def _agg(F, name, col):
    if name == "count_star":
        return F.count_star()
    return getattr(F, name)(F.col(col))


@pytest.mark.parametrize("frames", [
    ("unbounded",), ("running_rows", "running_range"),
    ("rows_-2_1", "rows_2_5"), ("rows_-3_uf", "rows_up_2")])
def test_aggregates_over_frames_match_reference(sessions, data, frames):
    """sum, count, count(*), avg, min and max of a float and an int column
    over each frame kind."""
    def build(df, F, W):
        cols = []
        for frame in frames:
            spec = _frames(W)[frame](_spec(W, F))
            cols += [_agg(F, agg, col).over(spec).alias(f"{agg}_{col}_{frame}")
                     for agg in AGGS for col in ("x", "i")]
        return df.select("g", "t", "k", "x", *cols)
    got, want, tf, jf, texp, jexp = _run(sessions, data, build)
    _compare(got, want, _tolerance(data))
    assert tf <= jf
    assert texp.splitlines()[2:] == jexp.splitlines()[2:]


RANGE_FRAMES = {"range_-3_0": (-3, 0), "range_1_2": (1, 2),
                "range_up_2": (None, 2), "range_-2_uf": (-2, None),
                "range_0_0": (0, 0)}


@pytest.mark.parametrize("order,frames", [
    ("asc", tuple(RANGE_FRAMES)), ("desc", ("range_-3_0", "range_-2_uf")),
    ("asc_nulls_last", ("range_1_2", "range_up_2")),
    ("desc_nulls_first", ("range_0_0", "range_-3_0"))])
def test_range_frames_match_reference(sessions, data, order, frames):
    """Bounded RANGE frames over one nullable int order key: lower and
    upper bounds of key + delta within the partition, a null key's frame
    is its partition's null rows, empty frames give null (count 0)."""
    def build(df, F, W):
        up, uf = W.unboundedPreceding, W.unboundedFollowing
        o = {"asc": F.col("t").asc(), "desc": F.col("t").desc(),
             "asc_nulls_last": F.col("t").asc_nulls_last(),
             "desc_nulls_first": F.col("t").desc_nulls_first()}[order]
        cols = []
        for name in frames:
            lo, hi = RANGE_FRAMES[name]
            spec = W.partition_by("g").order_by(o).range_between(
                up if lo is None else lo, uf if hi is None else hi)
            cols += [F.sum(F.col("i")).over(spec).alias(f"s{name}"),
                     F.max(F.col("x")).over(spec).alias(f"m{name}")]
            if order == "asc":
                cols += [F.count(F.col("x")).over(spec).alias(f"c{name}"),
                         F.avg(F.col("x")).over(spec).alias(f"a{name}")]
        return df.select("g", "t", "k", *cols)
    got, want, tf, jf, _, _ = _run(sessions, data, build)
    _compare(got, want, _tolerance(data))
    assert tf <= jf


def test_range_frame_over_a_date_key(sessions, data):
    def build(df, F, W):
        spec = W.partition_by("g").order_by("d").range_between(-5, 0)
        return df.select("g", "d", "k",
                         F.sum(F.col("x")).over(spec).alias("s"),
                         F.min(F.col("i")).over(spec).alias("m"))
    got, want, *_ = _run(sessions, data, build)
    _compare(got, want, _tolerance(data))


RANKS = ("row_number", "rank", "dense_rank", "percent_rank", "cume_dist")


@pytest.mark.parametrize("desc", [False, True])
def test_ranking_functions_match_reference(sessions, data, desc):
    """Ranks count peers (ties on t), not rows; a null order key is one
    peer group; ntile's first buckets take the extra rows."""
    def build(df, F, W):
        spec = W.partition_by("g").order_by(F.col("t").desc() if desc
                                            else F.col("t"))
        return df.select("g", "t", "k",
                         *(getattr(F, fn)().over(spec).alias(fn)
                           for fn in RANKS),
                         F.ntile(4).over(spec).alias("ntile"))
    got, want, tf, jf, _, _ = _run(sessions, data, build)
    _compare(got, want, 1e-15)
    assert tf <= jf


def test_lag_and_lead_match_reference(sessions, data):
    """Past a partition's edge: the default, else null."""
    def build(df, F, W):
        spec = _spec(W, F)
        return df.select("g", "t", "k",
                         F.lag("x", 1).over(spec).alias("lag1"),
                         F.lag("i", 2, 0).over(spec).alias("lag2_default"),
                         F.lead("x", 1).over(spec).alias("lead1"),
                         F.lead("i", 3, -1).over(spec).alias("lead3_default"),
                         F.lag("d", 1).over(spec).alias("lag_date"))
    got, want, *_ = _run(sessions, data, build)
    _compare(got, want, 0.0)


def test_spec_chain_and_with_column_match_reference(sessions, data):
    """Two specs are two Window nodes; the second sorts the first's output
    order, so row_number under ties follows it in both packages.  A
    filter above the windows stays there."""
    def build(df, F, W):
        wa = W.partition_by("g").order_by("t")
        wb = W.partition_by("t").order_by(F.col("x").desc())
        return (df.select("g", "t", "x", "k",
                          F.row_number().over(wa).alias("ra"),
                          F.sum(F.col("x")).over(wb).alias("sb"),
                          F.row_number().over(wb).alias("rb"))
                .with_column("rc", F.rank().over(wa))
                .where(F.col("k") > 100))
    got, want, tf, jf, texp, jexp = _run(sessions, data, build)
    _compare(got, want, _tolerance(data))
    assert tf <= jf
    assert texp.splitlines()[2:] == jexp.splitlines()[2:]


def test_window_without_order_or_partition(sessions, data):
    def build(df, F, W):
        return df.select("k", F.sum(F.col("i")).over(
            W.partition_by("g")).alias("s"), F.row_number().over(
            W.order_by("k")).alias("r"))
    got, want, *_ = _run(sessions, data, build)
    _compare(got, want, 0.0)


def test_to_device_arrays_of_a_window(sessions, data):
    jsess, tsess = sessions
    out = {}
    for F, W, sess in ((JF, JW, jsess), (TF, TW, tsess)):
        df = sess.create_dataframe(data)
        out[sess is tsess] = df.select(
            "k", F.dense_rank().over(_spec(W, F)).alias("r")) \
            .to_device_arrays()
    for c in ("k", "r"):
        np.testing.assert_array_equal(out[True][c][0].numpy(),
                                      np.asarray(out[False][c][0]))
    assert out[True]["r"][0].dtype.is_signed and out[True]["r"][1] is None


def test_unported_windows_raise(sessions):
    """A string partition key (the reference places the window on the
    CPU) raises naming the CPU operators of item 6; a windowed SUM of a
    decimal raises naming item 7 (FIRST/LAST over a window, which raised
    naming queue 2 row 4, are ported: test_torch_first_last.py);
    to_device_arrays refuses a string column."""
    import decimal
    _, tsess = sessions
    df = tsess.create_dataframe({"s": np.array(["a", "b", "a"]),
                                 "x": np.arange(3, dtype=np.int64),
                                 "m": np.array([decimal.Decimal("1.5")] * 3,
                                               dtype=object)})
    with pytest.raises(NotImplementedError, match="item 6"):
        df.select("x", TF.row_number().over(
            TW.partition_by("s").order_by("x")).alias("r")).collect()
    with pytest.raises(NotImplementedError, match="item 7"):
        df.select("x", TF.sum(TF.col("m")).over(
            TW.order_by("x")).alias("f")).collect()
    assert df.select("x", TF.first(TF.col("x")).over(
        TW.order_by("x")).alias("f")).collect() == [(0, 0), (1, 0), (2, 0)]
    with pytest.raises(TypeError, match="host-carried"):
        df.to_device_arrays()


# ---------------------------------------------------------------------------------
# The window context and the scans against the reference's functions
# ---------------------------------------------------------------------------------

def _context_keys(case: str, n: int, rng):
    """(partition keys, order keys) as numpy (data, valid) pairs."""
    part = rng.integers(0, 12, n).astype(np.int64)
    pvalid = rng.random(n) < 0.9
    day = rng.integers(-5, 5, n).astype(np.int32)
    dvalid = rng.random(n) < 0.85
    if case == "nullable":
        return [(part, pvalid)], [(day, dvalid)]
    if case == "float_nan":
        x = rng.choice([-1.5, 0.0, 2.25, np.nan, np.inf, -np.inf], n)
        return [(part, None)], [(x, rng.random(n) < 0.9), (day, None)]
    if case == "no_partition":
        return [], [(day, dvalid)]
    return [], []


@pytest.mark.parametrize("case", ["nullable", "float_nan", "no_partition",
                                  "no_keys"])
def test_window_context_plain_matches_reference(case):
    """The two-pass window context (its plain version: the flags and four
    position scans) over the rows in the reference's sorted order: flags
    and positions equal the reference ``SortedWindowContext``'s, with null
    keys and float keys with NaN and infinities."""
    import jax.numpy as jnp
    import torch
    from spark_rapids_tpu.ops import window as JWIN
    from spark_rapids_tpu_torch.ops import window as TWIN
    rng = np.random.default_rng(61)
    n = 3000
    part, order = _context_keys(case, n, rng)

    def jx(keys):
        return [(jnp.asarray(d), None if v is None else jnp.asarray(v))
                for d, v in keys]
    ref = JWIN.SortedWindowContext(jx(part), jx(order), [False] * len(order),
                                   [True] * len(order),
                                   jnp.ones(n, dtype=bool))
    perm = np.asarray(ref.perm)

    def sorted_keys(keys):
        return [(torch.from_numpy(d[perm]),
                 None if v is None else torch.from_numpy(v[perm]))
                for d, v in keys]
    got = TWIN.win_context(sorted_keys(part) + sorted_keys(order), len(part),
                           n, torch.device("cpu"))
    names = ("seg_start", "peer_start", "seg_start_pos", "seg_end_pos",
             "peer_start_pos", "peer_end_pos")
    for name, value in zip(names, got):
        assert np.array_equal(value.numpy(), np.asarray(getattr(ref, name))), \
            name
    w = TWIN.SortedWindowContext(sorted_keys(part), sorted_keys(order), n,
                                 torch.device("cpu"))
    for name, value in zip(names, got):
        assert torch.equal(getattr(w, name), value), name


@pytest.mark.parametrize("op", ["sum", "min", "max"])
@pytest.mark.parametrize("dtype", ["int64", "float64"])
@pytest.mark.parametrize("shape", ["one_partition", "single_rows"])
def test_running_scans_match_reference(shape, dtype, op):
    """A running scan whose one partition spans every row, and one whose
    partitions are single rows, against the reference's ``running_sum``
    and ``running_minmax``: integers and min/max exact, float sums within
    1e-12 x the column's sum of |x| (the reference's sums are differences
    of one prefix sum over every row, whose error follows that sum)."""
    import jax.numpy as jnp
    import torch
    from spark_rapids_tpu.ops import window as JWIN
    from spark_rapids_tpu_torch.ops import window as TWIN
    rng = np.random.default_rng(62)
    n = 20_000
    part = np.zeros(n, dtype=np.int64) if shape == "one_partition" \
        else np.arange(n, dtype=np.int64)
    x = rng.integers(-1000, 1000, n) if dtype == "int64" \
        else rng.uniform(-1e4, 1e4, n)
    m = rng.random(n) < 0.9
    ref = JWIN.SortedWindowContext([(jnp.asarray(part), None)], [], [], [],
                                   jnp.ones(n, dtype=bool))
    assert np.array_equal(np.asarray(ref.perm), np.arange(n))
    if op == "sum":
        want = np.asarray(JWIN.running_sum(
            ref, jnp.where(jnp.asarray(m), jnp.asarray(x), 0)))
    else:
        want = np.asarray(JWIN.running_minmax(ref, jnp.asarray(x),
                                              jnp.asarray(m), op))
    w = TWIN.SortedWindowContext([(torch.from_numpy(part), None)], [], n,
                                 torch.device("cpu"))
    got = TWIN.running(w, torch.from_numpy(x), torch.from_numpy(m),
                       op).numpy()
    if op != "sum":
        # a partition whose rows are all masked holds the op's identity
        # in both; compare where a row contributed
        seen = np.asarray(JWIN.running_sum(ref, jnp.asarray(m.astype(
            np.int64)))) > 0
        assert np.array_equal(got[seen], want[seen])
    elif dtype == "int64":
        assert np.array_equal(got, want)
    else:
        assert np.all(np.abs(got - want) <= REL * np.abs(x[m]).sum())
    count = TWIN.running_count(w, torch.from_numpy(m)).numpy()
    assert np.array_equal(count, np.asarray(JWIN.running_sum(
        ref, jnp.asarray(m.astype(np.int64)))))
