"""Window sums over a float column that holds NaN and +-infinity.

The port's bounded frames take a frame's sum as the difference of the
partition's running sum, except where that running sum is not finite at
the frame's ends: there the frame is summed directly, which is Spark's
per-frame result (``csrc/window_frame.cu frame_sum``).  Every frame is held
against a per-frame numpy oracle; the reference's prefix difference turns
every frame after the first NaN into NaN, so it is held against the port
only on the frames before that row."""

import math

import numpy as np
import pytest

import spark_rapids_tpu as jsrt
from spark_rapids_tpu.sql import functions as JF
from spark_rapids_tpu.sql.window import Window as JW
import spark_rapids_tpu_torch as tsrt
from spark_rapids_tpu_torch.sql import functions as TF
from spark_rapids_tpu_torch.sql.window import Window as TW

SETTINGS = {"spark.rapids.tpu.sql.batchSizeRows": 128}
REL = 1e-12


def _table(n=600, seed=31):
    rng = np.random.default_rng(seed)
    x = np.round(rng.uniform(-100, 100, n), 3)
    at = rng.choice(n, 12, replace=False)
    x[at[:4]] = np.nan
    x[at[4:8]] = np.inf
    x[at[8:]] = -np.inf
    return {"g": rng.integers(0, 6, n), "t": rng.integers(0, 80, n),
            "k": np.arange(n, dtype=np.int64), "x": x}


FRAMES = {"rows": lambda W: W.partition_by("g").order_by("t", "k")
          .rows_between(-2, 1),
          "range": lambda W: W.partition_by("g").order_by("t")
          .range_between(-3, 0)}


def _frame_sum(vals):
    s = 0.0
    for v in vals:
        s += v
    return s


@pytest.mark.parametrize("frame", list(FRAMES))
def test_window_sum_with_nan_and_inf_sums_each_frame(frame):
    data = _table()
    tsess = tsrt.Session(SETTINGS, device="cpu")
    jsess = jsrt.Session(SETTINGS)

    def q(df, F, W):
        w = FRAMES[frame](W)
        return df.select("g", "t", "k", "x",
                         F.sum(F.col("x")).over(w).alias("s"))
    got = q(tsess.create_dataframe(data), TF, TW).collect()
    # the per-frame oracle over the rows in (g, t, k) order
    g, t, k, x = (np.array([r[i] for r in got]) for i in range(4))
    assert np.array_equal(k[np.lexsort((k, t, g))], k)
    tol = REL * np.nansum(np.abs(np.where(np.isfinite(x), x, 0.0)))
    sums = [r[4] for r in got]
    for i in range(len(got)):
        part = np.flatnonzero(g == g[i])
        if frame == "rows":
            lo, hi = max(i - 2, part[0]), min(i + 1, part[-1])
        else:
            peers = part[(t[part] >= t[i] - 3) & (t[part] <= t[i])]
            lo, hi = peers[0], peers[-1]
        want = _frame_sum(x[lo:hi + 1])
        if math.isnan(want):
            assert math.isnan(sums[i]), (i, sums[i])
        elif math.isinf(want):
            assert sums[i] == want, (i, sums[i], want)
        else:
            assert abs(sums[i] - want) <= tol, (i, sums[i], want)
    # the reference, on the frames that end before its first non-finite row
    ref = q(jsess.create_dataframe(data), JF, JW).collect()
    assert [r[:4] for r in ref][:10] == [r[:4] for r in got][:10]
    first_bad = int(np.flatnonzero(~np.isfinite(x))[0])
    reach = 1 if frame == "rows" else 0
    checked = 0
    for i in range(len(got)):
        if i + reach < first_bad:
            assert abs(sums[i] - ref[i][4]) <= tol
            checked += 1
    assert checked > 10
