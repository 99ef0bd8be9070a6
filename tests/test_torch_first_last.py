"""FIRST and LAST in the port (grouped on the hash path, ungrouped,
windowed) against the JAX package's ``Session`` on the CPU, and the plain
versions of the extended kernels (``masked_reduce.cu``, ``hash_agg.cu``,
``window_frame.cu frame_first_last``) against numpy.

The reference's TestFirstLastIgnoreNulls cases run with
``batchSizeRows`` = 4, so the picks cross batches, empty and fully
filtered batches included.  Values are exact: FIRST/LAST copy them."""

import datetime
from decimal import Decimal

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

import spark_rapids_tpu as jsrt
from spark_rapids_tpu.sql import functions as JF
from spark_rapids_tpu.sql.window import Window as JW
from spark_rapids_tpu.utils.metrics import QueryStats as JStats
import spark_rapids_tpu_torch as tsrt
from spark_rapids_tpu_torch.batch import DecimalArray
from spark_rapids_tpu_torch.models import tpch
from spark_rapids_tpu_torch.ops import groupby as tg
from spark_rapids_tpu_torch.ops import window as tw
from spark_rapids_tpu_torch.sql import functions as TF
from spark_rapids_tpu_torch.sql.window import Window as TW

SMALL = {"spark.rapids.tpu.sql.batchSizeRows": 4}


def _sessions(settings):
    return jsrt.Session(settings), tsrt.Session(settings, device="cpu")


def _kv():
    return {"k": np.array([1, 1, 1, 2, 2, 3]),
            "v": np.array([None, 10, 20, None, None, 7], dtype=object)}


def _frames(sessions, data):
    jsess, tsess = sessions
    jd = {k: pa.array(list(v), type=pa.int64()) if v.dtype == object else v
          for k, v in data.items()}
    return jsess.create_dataframe(jd), tsess.create_dataframe(data)


def _grouped(jdf, tdf, build):
    got = dict((r[0], r[1:]) for r in build(tdf, TF).collect())
    want = dict((r[0], r[1:]) for r in build(jdf, JF).collect())
    assert got == want
    return {k: v[0] for k, v in got.items()}


# ---------------------------------------------------------------------------------
# The reference's TestFirstLastIgnoreNulls, in 4-row batches
# ---------------------------------------------------------------------------------

def test_first_ignore_nulls():
    jdf, tdf = _frames(_sessions(SMALL), _kv())
    got = _grouped(jdf, tdf, lambda df, F: df.group_by("k").agg(
        F.first(F.col("v"), ignore_nulls=True).alias("f")))
    assert got == {1: 10, 2: None, 3: 7}


def test_last_ignore_nulls():
    jdf, tdf = _frames(_sessions(SMALL), _kv())
    got = _grouped(jdf, tdf, lambda df, F: df.group_by("k").agg(
        F.last(F.col("v"), ignore_nulls=True).alias("l")))
    assert got[1] == 20 and got[3] == 7


def test_first_keep_nulls():
    jdf, tdf = _frames(_sessions(SMALL), _kv())
    got = _grouped(jdf, tdf, lambda df, F: df.group_by("k").agg(
        F.first(F.col("v")).alias("f")))
    assert got[1] is None and got[3] == 7


def test_ungrouped_first_ignore_nulls():
    jdf, tdf = _frames(_sessions(SMALL), {
        "v": np.array([None, None, 5, 9], dtype=object)})

    def q(df, F):
        return df.agg(F.first(F.col("v"), ignore_nulls=True).alias("f"),
                      F.last(F.col("v"), ignore_nulls=True).alias("l"))
    assert q(tdf, TF).collect() == q(jdf, JF).collect() == [(5, 9)]


def test_first_across_batches_with_empty_batch():
    """The first batch is filtered out entirely: its padding must not
    win."""
    jsess, tsess = _sessions(SMALL)
    data = {"k": np.array([0, 0, 0, 0, 1, 1, 1, 1]),
            "v": np.array([100, 101, 102, 103, 7, 8, 9, 10])}

    def q(df, F):
        return df.where(F.col("k") == 1).agg(F.first(F.col("v")).alias("f"),
                                             F.last(F.col("v")).alias("l"))
    got = q(tsess.create_dataframe(data), TF).collect()
    assert got == q(jsess.create_dataframe(pd.DataFrame(data)),
                    JF).collect() == [(7, 10)]


def test_first_all_rows_filtered():
    jsess, tsess = _sessions(SMALL)
    data = {"k": np.zeros(8, dtype=np.int64), "v": np.arange(8)}

    def q(df, F):
        return df.where(F.col("k") == 1).agg(F.first(F.col("v")).alias("f"))
    assert q(tsess.create_dataframe(data), TF).collect() == \
        q(jsess.create_dataframe(pd.DataFrame(data)), JF).collect() \
        == [(None,)]


# ---------------------------------------------------------------------------------
# Grouped, ungrouped and windowed, with nulls drawn, against the reference
# ---------------------------------------------------------------------------------

def _typed_table(n=900, seed=23):
    """k: int64 groups (a null key too); i: int64, d: dates, x: float64,
    m: DECIMAL(12, 2), each with nulls; o: an order key."""
    rng = np.random.default_rng(seed)

    def nulls(frac):
        return rng.random(n) >= frac
    cents = rng.integers(-10**9, 10**9, n)
    mv = nulls(0.3)
    port = {"k": np.array([None if rng.random() < 0.03 else int(x)
                           for x in rng.integers(0, 40, n)], dtype=object),
            "i": np.array([int(x) if ok else None for x, ok in zip(
                rng.integers(-10**12, 10**12, n), nulls(0.3))],
                dtype=object),
            "d": np.array([datetime.date(1995, 1, 1)
                           + datetime.timedelta(days=int(x)) if ok else None
                           for x, ok in zip(rng.integers(0, 900, n),
                                            nulls(0.3))], dtype=object),
            "x": np.array([float(x) if ok else None for x, ok in zip(
                np.round(rng.normal(size=n) * 1e3, 3), nulls(0.3))],
                dtype=object),
            "m": DecimalArray(np.where(mv, cents, 0), 12, 2, mv),
            "o": np.arange(n, dtype=np.int64)}
    ref = {c: v for c, v in port.items() if c != "m"}
    ref["k"] = pa.array(list(port["k"]), type=pa.int64())
    ref["i"] = pa.array(list(port["i"]), type=pa.int64())
    ref["x"] = pa.array(list(port["x"]), type=pa.float64())
    ref["d"] = pa.array(list(port["d"]), type=pa.date32())
    ref["m"] = pa.array([Decimal(int(c)).scaleb(-2) if ok else None
                         for c, ok in zip(cents, mv)],
                        type=pa.decimal128(12, 2))
    return ref, port


@pytest.fixture(scope="module")
def typed():
    settings = {"spark.rapids.tpu.sql.batchSizeRows": 128}
    jsess, tsess = _sessions(settings)
    ref, port = _typed_table()
    return jsess.create_dataframe(pa.table(ref)), \
        tsess.create_dataframe(port)


def _aggs(F):
    out = []
    for c in ("i", "d", "x", "m"):
        for fn in (F.first, F.last):
            for ign in (False, True):
                out.append(fn(F.col(c), ignore_nulls=ign).alias(
                    f"{fn.__name__}_{c}_{int(ign)}"))
    return out


def test_grouped_first_last_every_type_on_hash_path(typed):
    jdf, tdf = typed
    tq = tdf.group_by("k").agg(*_aggs(TF), TF.count_star().alias("n"))
    got = sorted(tq.collect(), key=lambda r: (r[0] is None, r[0] or 0))
    want = sorted(jdf.group_by("k").agg(*_aggs(JF),
                                        JF.count_star().alias("n"))
                  .collect(), key=lambda r: (r[0] is None, r[0] or 0))
    assert got == want
    metrics = tdf.session.last_exec_context().metrics
    assert sum(m.values.get("aggHashPath", 0) for m in metrics.values()) == 1


def test_ungrouped_first_last_every_type(typed):
    jdf, tdf = typed
    got = tdf.where(TF.col("o") >= 333).agg(*_aggs(TF)).collect()
    assert got == jdf.where(JF.col("o") >= 333).agg(*_aggs(JF)).collect()


def test_first_last_of_a_string_raises_naming_item_6():
    tsess = tsrt.Session(SMALL, device="cpu")
    df = tsess.create_dataframe({"k": np.array([1, 1, 2]),
                                 "s": np.array(["a", "b", "c"])})
    with pytest.raises(NotImplementedError, match="item 6"):
        df.group_by("k").agg(TF.first(TF.col("s")).alias("f")).collect()


FRAMES = {
    "rows_back": lambda W, w: w.rows_between(-3, 0),
    "rows_ahead": lambda W, w: w.rows_between(0, 2),
    "rows_around": lambda W, w: w.rows_between(-2, 2),
    "running_rows": lambda W, w: w.rows_between(W.unboundedPreceding, 0),
    "running_range": lambda W, w: w,
    "whole": lambda W, w: w.rows_between(W.unboundedPreceding,
                                         W.unboundedFollowing),
    "range_back": lambda W, w: w.range_between(-5, 0),
    "range_around": lambda W, w: w.range_between(-3, 3),
}


@pytest.mark.parametrize("frame", list(FRAMES))
def test_windowed_first_last_every_frame(typed, frame):
    jdf, tdf = typed

    def q(df, F, W):
        w = FRAMES[frame](W, W.partition_by("k").order_by("i"))
        cols = [fn(F.col(c), ignore_nulls=ign).over(w).alias(
            f"{fn.__name__}_{c}_{int(ign)}")
            for c in ("x", "m", "d") for fn in (F.first, F.last)
            for ign in (False, True)]
        return df.select("k", "i", "o", *cols)
    assert q(tdf, TF, TW).collect() == q(jdf, JF, JW).collect()


# ---------------------------------------------------------------------------------
# F1, F1u and W2 at SF 0.01 against the reference and the oracles
# ---------------------------------------------------------------------------------

DB_SETTINGS = {"spark.rapids.tpu.sql.batchSizeRows": 16384,
               "spark.rapids.tpu.join.denseMinProbeRows": 0}


@pytest.fixture(scope="module")
def db():
    return tpch.gen_db_arrays(0.01, tables=("orders", "lineitem"))


def _decimal_table(data, table):
    """(reference dict with pyarrow decimals, port dict with
    DecimalArrays) of one gen_db table's money columns."""
    names = tpch.MONEY_COLUMNS[table]
    port = tpch.decimal_columns(data, names)
    ref = dict(port)
    for n in names:
        ref[n] = pa.array([Decimal(int(c)).scaleb(-2)
                           for c in port[n].unscaled],
                          type=pa.decimal128(12, 2))
    return ref, port


def test_f1_matches_reference_and_oracle(db):
    jsess, tsess = _sessions(DB_SETTINGS)
    ref, port = _decimal_table(db["orders"], "orders")
    with JStats.scoped() as st:
        want = sorted(tpch.f1(jsess.create_dataframe(ref), JF).collect())
    tq = tpch.f1(tsess.create_dataframe(port))
    got = sorted(tq.collect())
    assert got == want
    assert tsess.last_query_stats().blocking_fetches <= st.blocking_fetches
    out = tpch.f1(tsess.create_dataframe(port)).to_device_arrays()
    order = np.argsort(out["o_custkey"][0].numpy())
    for c, (wd, wv) in tpch.f1_numpy(db["orders"]).items():
        d, v = out[c]
        d = d.numpy()[order]
        ok = np.ones(len(d), bool) if v is None else v.numpy()[order]
        wok = np.ones(len(wd), bool) if wv is None else wv
        np.testing.assert_array_equal(ok, wok, err_msg=c)
        np.testing.assert_array_equal(d[ok], wd[wok], err_msg=c)
    assert tq.explain_string().splitlines()[2:] == tpch.f1(
        jsess.create_dataframe(ref), JF).explain_string().splitlines()[2:]


def test_f1u_matches_reference_and_oracle(db):
    jsess, tsess = _sessions(DB_SETTINGS)
    ref, port = _decimal_table(db["lineitem"], "lineitem")
    with JStats.scoped() as st:
        want = tpch.f1u(jsess.create_dataframe(ref), JF).collect()
    got = tpch.f1u(tsess.create_dataframe(port)).collect()
    assert got == want == tpch.f1u_numpy(db["lineitem"])
    assert tsess.last_query_stats().blocking_fetches <= st.blocking_fetches
    # a cutoff that no line passes: every value null, the count 0
    late = datetime.date(2030, 1, 1)
    assert tpch.f1u(tsess.create_dataframe(port), cutoff=late).collect() \
        == tpch.f1u(jsess.create_dataframe(ref), JF, cutoff=late).collect() \
        == [(None, None, None, None, None, 0)]


def test_w2_matches_reference_and_oracle(db):
    jsess, tsess = _sessions(DB_SETTINGS)
    jdf = tpch.w2(jsess.create_dataframe(db["lineitem"]), functions=JF,
                  window=JW)
    with JStats.scoped() as st:
        jout = jdf.to_device_arrays()
    tdf = tpch.w2(tsess.create_dataframe(db["lineitem"]))
    tout = tdf.to_device_arrays()
    assert tsess.last_query_stats().blocking_fetches <= st.blocking_fetches
    want = tpch.w2_numpy(db["lineitem"])
    assert list(tout) == list(want)
    for c, (wd, wv) in want.items():
        d, v = (x if x is None else x.numpy() for x in tout[c])
        jd, jv = (x if x is None else np.asarray(x) for x in jout[c])
        ok = np.ones(len(d), bool) if v is None else v
        for od, ov in ((wd, wv), (jd[:len(d)], None if jv is None
                                  else jv[:len(d)])):
            ook = np.ones(len(od), bool) if ov is None else ov
            np.testing.assert_array_equal(ok, ook, err_msg=c)
            np.testing.assert_array_equal(d[ok], od[ook], err_msg=c)
    assert tdf.explain_string().splitlines()[2:] == \
        jdf.explain_string().splitlines()[2:]


# ---------------------------------------------------------------------------------
# The extended kernels' plain versions against numpy
# ---------------------------------------------------------------------------------

def _first_last_np(vals, valid, active, last):
    rows = np.flatnonzero(active & valid)
    if not len(rows):
        return None
    return vals[rows[-1] if last else rows[0]]


def test_masked_reduce_plain_first_last_across_batches():
    """Ungrouped first/last over batches, the first ones with no
    qualifying row: an earlier batch's FIRST stays, LAST moves on."""
    rng = np.random.default_rng(4)
    specs = [("first", False), ("last", False), ("first", True),
             ("last", True)]
    acc_f, acc_i = tg.init_scalars(specs, torch.device("cpu"))
    acc_h = torch.zeros_like(acc_i)
    seen = {s: None for s in range(4)}
    for b in range(6):
        n = 50
        ints = rng.integers(-10**15, 10**15, n)
        floats = rng.normal(size=n)
        valid = rng.random(n) < 0.5
        active = rng.random(n) < (0.0 if b < 2 else 0.3)
        cols = [(torch.from_numpy(ints), torch.from_numpy(valid), op)
                for op in ("first", "last")]
        cols += [(torch.from_numpy(floats), torch.from_numpy(valid), op)
                 for op in ("first", "last")]
        tg.masked_reduce_plain(cols, torch.from_numpy(active), acc_f, acc_i,
                               acc_h)
        for j, (vals, op) in enumerate(((ints, "first"), (ints, "last"),
                                        (floats, "first"),
                                        (floats, "last"))):
            x = _first_last_np(vals, valid, active, op == "last")
            if x is not None and (op == "last" or seen[j] is None):
                seen[j] = x
    for j in range(4):
        acc = acc_f if j >= 2 else acc_i
        assert bool(acc_h[j]) == (seen[j] is not None)
        assert acc[j].item() == seen[j]


def test_hash_agg_plain_first_last_across_batches():
    """Grouped first/last/first_valid/last_valid over batches into the
    plain hash accumulator, against numpy over the concatenated rows."""
    rng = np.random.default_rng(9)
    channels = [("first", False), ("last", False), ("first_valid", True),
                ("last_valid", True)]
    acc = tg.HashAccumulator(1, channels, "cpu")
    keys, vals, fvals, valid, act = [], [], [], [], []
    for b in range(5):
        n = 200
        k = rng.integers(0, 30, n)
        v = rng.integers(-10**12, 10**12, n)
        f = rng.normal(size=n)
        ok = rng.random(n) < 0.4
        a = rng.random(n) < (0.0 if b == 0 else 0.5)
        acc.update([(torch.from_numpy(k), None)],
                   [(torch.from_numpy(v), None), (torch.from_numpy(v), None),
                    (torch.from_numpy(f), torch.from_numpy(ok)),
                    (torch.from_numpy(f), torch.from_numpy(ok))],
                   torch.from_numpy(a), n)
        for lst, x in ((keys, k), (vals, v), (fvals, f), (valid, ok),
                       (act, a)):
            lst.append(x)
    k, v, f, ok, a = (np.concatenate(x) for x in (keys, vals, fvals, valid,
                                                   act))
    (words, _), values, _ = acc.finish()[0][0], acc.finish()[1], None
    for g, key in enumerate(words.tolist()):
        m = a & (k == key)
        rows, vrows = np.flatnonzero(m), np.flatnonzero(m & ok)
        assert values[0][0][g].item() == v[rows[0]]
        assert values[1][0][g].item() == v[rows[-1]]
        assert bool(values[2][1][g]) == bool(len(vrows))
        if len(vrows):
            assert values[2][0][g].item() == f[vrows[0]]
            assert values[3][0][g].item() == f[vrows[-1]]


@pytest.mark.parametrize("last", [False, True])
@pytest.mark.parametrize("ignore_nulls", [False, True])
def test_frame_first_last_plain_matches_numpy(last, ignore_nulls):
    rng = np.random.default_rng(17)
    n = 400
    vals = rng.integers(-10**9, 10**9, n)
    valid = rng.random(n) < 0.35
    lo = rng.integers(0, n, n)
    hi = np.clip(lo + rng.integers(-3, 40, n), 0, n - 1)  # some empty
    out, ok = tw.frame_first_last_plain(
        torch.from_numpy(vals), torch.from_numpy(valid),
        torch.from_numpy(lo.astype(np.int32)),
        torch.from_numpy(hi.astype(np.int32)), last, ignore_nulls)
    for i in range(n):
        frame = np.arange(lo[i], hi[i] + 1)
        if ignore_nulls:
            frame = frame[valid[frame]]
            pos = (frame[-1] if last else frame[0]) if len(frame) else None
            want_ok = pos is not None
        else:
            pos = (hi[i] if last else lo[i]) if len(frame) else None
            want_ok = pos is not None and bool(valid[pos])
        assert bool(ok[i]) == want_ok
        if want_ok:
            assert out[i].item() == vals[pos]


@pytest.mark.parametrize("shape", ["one_group", "n17", "dead_batches",
                                   "growth"])
def test_hash_agg_plain_first_last_edges(shape):
    """Grouped first/last/first_valid/last_valid on the hash kernel's risky
    shapes, into the plain accumulator, against numpy over the
    concatenated rows: one group for every row, 17 rows in batches of 5,
    batches with every row dead between live ones, and a table that grows
    (its groups' picks carried across the growth)."""
    rng = np.random.default_rng(91)
    channels = [("first", False), ("last", False), ("first_valid", True),
                ("last_valid", True)]
    acc = tg.HashAccumulator(1, channels, "cpu")
    sizes = {"one_group": [300] * 4, "n17": [5, 5, 5, 2],
             "dead_batches": [200] * 5, "growth": [700] * 6}[shape]
    keys, vals, fvals, valid, act = [], [], [], [], []
    for b, n in enumerate(sizes):
        k = np.zeros(n, np.int64) if shape == "one_group" \
            else rng.integers(0, 10**9 if shape == "growth" else 30, n)
        v = rng.integers(-10**12, 10**12, n)
        f = rng.normal(size=n)
        ok = rng.random(n) < 0.4
        a = rng.random(n) < (0.0 if shape == "dead_batches" and b % 2
                             else 0.6)
        acc.update([(torch.from_numpy(k), None)],
                   [(torch.from_numpy(v), None), (torch.from_numpy(v), None),
                    (torch.from_numpy(f), torch.from_numpy(ok)),
                    (torch.from_numpy(f), torch.from_numpy(ok))],
                   torch.from_numpy(a), n)
        for lst, x in ((keys, k), (vals, v), (fvals, f), (valid, ok),
                       (act, a)):
            lst.append(x)
    if shape == "growth":
        assert acc.growths >= 1
    k, v, f, ok, a = (np.concatenate(x) for x in (keys, vals, fvals, valid,
                                                   act))
    out_keys, values, _ = acc.finish()
    words = out_keys[0][0]
    assert sorted(words.tolist()) == sorted(set(k[a].tolist()))
    for g, key in enumerate(words.tolist()):
        m = a & (k == key)
        rows, vrows = np.flatnonzero(m), np.flatnonzero(m & ok)
        assert values[0][0][g].item() == v[rows[0]]
        assert values[1][0][g].item() == v[rows[-1]]
        assert bool(values[2][1][g]) == bool(len(vrows))
        assert bool(values[3][1][g]) == bool(len(vrows))
        if len(vrows):
            assert values[2][0][g].item() == f[vrows[0]]
            assert values[3][0][g].item() == f[vrows[-1]]
