"""ORDER BY ... LIMIT k through both packages' Sessions: the port's TopKExec
(the plain version of csrc/topk.cu on the CPU) against the JAX package's
TopKExec, on keys with NaN, -0.0/+0.0, nulls and ties, over several
batches.  Rows compare exactly and in order: the top-k is stable."""

import math

import numpy as np
import pytest
import torch

import spark_rapids_tpu as jsrt
from spark_rapids_tpu.sql import functions as JF
import spark_rapids_tpu_torch as tsrt
from spark_rapids_tpu_torch.ops import topk as tk
from spark_rapids_tpu_torch.sql import functions as TF

SETTINGS = {"spark.rapids.tpu.sql.batchSizeRows": 700}


@pytest.fixture(scope="module")
def sessions():
    return jsrt.Session(SETTINGS), tsrt.Session(SETTINGS, device="cpu")


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(31)
    n = 2500
    x = rng.choice(np.array([-0.0, 0.0, 1.5, -2.25, np.nan, np.inf,
                             -np.inf, 3.0]), n)
    x = x.astype(object)
    x[rng.random(n) < 0.1] = None
    g = rng.integers(0, 5, n).astype(object)
    g[rng.random(n) < 0.1] = None
    return {"x": x, "g": g, "i": np.arange(n, dtype=np.int64),
            "day": np.datetime64("1995-01-01")
            + rng.integers(0, 4, n).astype("timedelta64[D]"),
            "keep": rng.random(n) < 0.9}


def _same(a, b):
    if isinstance(a, float) and isinstance(b, float):
        return (math.isnan(a) and math.isnan(b)) or (
            a == b and math.copysign(1, a) == math.copysign(1, b))
    return a == b


ORDERS = {
    "x_desc_day": lambda F: [F.col("x").desc(), F.col("day")],
    "g_asc_x_asc": lambda F: [F.col("g"), F.col("x")],
    "day_desc_g_desc": lambda F: [F.col("day").desc(), F.col("g").desc()],
    "x_asc_nulls_last": lambda F: [_nulls_last(F, "x"), F.col("i").desc()],
}


def _nulls_last(F, name):
    order = F.col(name).asc()
    order.nulls_first = False
    return order


@pytest.mark.parametrize("k", [1, 10, 97])
@pytest.mark.parametrize("order", sorted(ORDERS))
def test_topk_matches_reference(sessions, data, order, k):
    jsess, tsess = sessions
    got, want = [
        sess.create_dataframe(data).where(F.col("keep"))
        .sort(*ORDERS[order](F)).limit(k).collect()
        for sess, F in ((tsess, TF), (jsess, JF))]
    assert len(got) == len(want) == k
    for g, w in zip(got, want):
        assert all(_same(a, b) for a, b in zip(g, w)), (g, w)


def test_topk_past_the_live_rows_returns_them_all(sessions):
    jsess, tsess = sessions
    d = {"v": np.array([3.0, -0.0, np.nan, 1.0]), "i": np.arange(4)}
    got, want = [sess.create_dataframe(d).sort(F.col("v").desc())
                 .limit(10).collect() for sess, F in ((tsess, TF),
                                                       (jsess, JF))]
    assert len(got) == 4
    assert all(_same(a, b) for g, w in zip(got, want) for a, b in zip(g, w))


def test_sortable_view_orders_floats_like_spark():
    x = torch.tensor([np.nan, np.inf, 1.0, 0.0, -0.0, -1e-300, -np.inf],
                     dtype=torch.float64)
    v = tk.sortable_view(x).tolist()
    assert v[0] > v[1] > v[2] > v[3] == v[4] > v[5] > v[6]
    x32 = x.to(torch.float32)
    v32 = tk.sortable_view(x32).tolist()
    assert v32[0] > v32[1] > v32[2] > v32[3] == v32[4] > v32[6]


def test_topk_limits():
    keys = [(torch.zeros(5), None, True, True)]
    with pytest.raises(NotImplementedError, match="row 8"):
        tk.topk_indices(keys, None, 5, tk.TK_MAX_K + 1)
    assert tk.topk_indices(keys, torch.tensor([0, 1, 0, 1, 1],
                                              dtype=torch.bool),
                           5, 4).tolist() == [1, 3, 4, -1]
    with pytest.raises(ValueError, match="CUDA"):
        tk.topk(keys, None, 5, 2)
    assert tk.topk.launches == 0


def test_topk_over_a_dense_aggregate_with_string_keys(sessions):
    """The top-k gathers dictionary-coded string columns too: ORDER BY an
    aggregate over (integral key, string key) groups."""
    jsess, tsess = sessions
    rng = np.random.default_rng(32)
    k = rng.integers(0, 300, 2000).astype(np.int64)
    d = {"k": k, "name": np.array([f"c{x % 17}" for x in k]),
         "x": rng.normal(size=2000)}
    got, want = [sess.create_dataframe(d).group_by("k", "name")
                 .agg(F.sum(F.col("x")).alias("s"))
                 .sort(F.col("s").desc(), F.col("k")).limit(7).collect()
                 for sess, F in ((tsess, TF), (jsess, JF))]
    assert [r[:2] for r in got] == [r[:2] for r in want]
    assert all(abs(a[2] - b[2]) <= 1e-12 * max(abs(b[2]), 1.0)
               for a, b in zip(got, want))


def test_limit_without_a_device_sort_is_not_ported(sessions):
    """A LIMIT over no device ORDER BY now runs (``LimitExec``): over a
    scan it takes the first rows, over a host ORDER BY on a string key the
    first rows of the host sort, as the reference does."""
    jsess, tsess = sessions
    data = {"i": np.arange(10, dtype=np.int64)[::-1].copy(),
            "s": np.array(list("jihgfedcba"))}
    rows = []
    for sess in (tsess, jsess):
        df = sess.create_dataframe(data)
        rows.append((df.limit(3).collect(), df.sort("s").limit(3).collect()))
    assert rows[0] == rows[1]
    assert rows[0][1] == [(0, "a"), (1, "b"), (2, "c")]


@pytest.mark.parametrize("k", [100, 1000])
def test_topk_across_many_batches_keeps_earlier_ties(k):
    """LIMIT over 4 keys with few distinct values across 14 batches of 150
    rows: most rows tie in every key, so the rows kept are decided by input
    order, which the running top must keep when it joins only each batch's
    winners.  A string column from a joined dimension table rides along
    (string ORDER BY keys run on the host, in both packages)."""
    rng = np.random.default_rng(33)
    n = 2000
    b = rng.integers(0, 3, n).astype(object)
    b[rng.random(n) < 0.1] = None
    x = rng.choice(np.array([-0.0, 0.0, 1.5, np.nan]), n).astype(object)
    x[rng.random(n) < 0.1] = None
    fact = {"g": rng.integers(0, 5, n), "b": b, "x": x,
            "day": np.datetime64("1995-01-01")
            + rng.integers(0, 2, n).astype("timedelta64[D]"),
            "i": np.arange(n, dtype=np.int64)}
    dim = {"g": np.arange(5), "name": np.array(["e", "d", "c", "b", "a"])}
    settings = {"spark.rapids.tpu.sql.batchSizeRows": 150}
    sessions = (jsrt.Session(settings), tsrt.Session(settings, device="cpu"))
    got, want = [
        sess.create_dataframe(fact).join(sess.create_dataframe(dim), "g")
        .sort(F.col("g").desc(), _nulls_last(F, "b"), F.col("x").desc(),
              F.col("day")).limit(k).collect()
        for sess, F in zip(sessions[::-1], (TF, JF))]
    assert len(got) == len(want) == k
    for g, w in zip(got, want):
        assert all(_same(a, c) for a, c in zip(g, w)), (g, w)
