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
    _, tsess = sessions
    df = tsess.create_dataframe({"i": np.arange(10, dtype=np.int64),
                                 "s": np.array(list("abcdefghij"))})
    with pytest.raises(NotImplementedError, match="item 7"):
        df.limit(3).collect()
    with pytest.raises(NotImplementedError, match="item 7"):
        df.sort("s").limit(3).collect()  # a string key sorts on the host
