"""The full device sort of the port (``ops/sort.py``, ``plan/exec_nodes.py
SortExec``) against the JAX package, on the CPU (the port's plain versions;
the reference as its own tests run it).

The permutation must equal the reference's ``sort_indices_for_keys``
exactly, for every key type, asc and desc, nulls first and last, with NaN,
-0.0/+0.0, ties and dead rows; the range key must order rows as
``_range_key_fn`` does; ``SortExec`` must give the reference's rows in
order, in-core and out-of-core (``batchSizeRows`` = 500 forces the range
partitioner, with ties straddling runs), at no more blocking fetches."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spark_rapids_tpu as jsrt
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.exprs import BoundReference as JBound
from spark_rapids_tpu.ops import groupby as jgroupby
from spark_rapids_tpu.plan import exec_nodes as jexec
from spark_rapids_tpu.sql import functions as JF
from spark_rapids_tpu.utils.metrics import QueryStats as JStats
import spark_rapids_tpu_torch as tsrt
from spark_rapids_tpu_torch.ops import sort as S
from spark_rapids_tpu_torch.plan.exec_nodes import sample_bounds
from spark_rapids_tpu_torch.sql import functions as TF

KINDS = ("int8", "int16", "int32", "date", "int64", "float32", "float64",
         "bool", "codes")
ORDERS = [(True, True), (False, True), (True, False), (False, False)]
_JTYPE = {"int8": JT.INT8, "int16": JT.INT16, "int32": JT.INT32,
          "date": JT.DATE, "int64": JT.INT64, "float32": JT.FLOAT32,
          "float64": JT.FLOAT64, "bool": JT.BOOLEAN, "codes": JT.INT32}


def key_column(rng, kind: str, n: int, span: int = 6) -> np.ndarray:
    """A key with many ties; floats draw -0.0/+0.0, NaN and +-inf."""
    if kind in ("int8", "int16", "int32", "int64"):
        return rng.integers(-span, span, n).astype(kind)
    if kind in ("date", "codes"):
        return rng.integers(0, span, n).astype(np.int32)
    if kind == "bool":
        return rng.random(n) < 0.5
    vals = np.array([-0.0, 0.0, np.nan, np.inf, -np.inf, 1.5, -2.25, 3.0],
                    dtype=kind)
    return rng.choice(vals, n)


def reference_perm(cols, valids, active, asc, nf) -> np.ndarray:
    keys = [(jnp.asarray(c), None if v is None else jnp.asarray(v))
            for c, v in zip(cols, valids)]
    perm = jgroupby.sort_indices_for_keys(
        keys, jnp.asarray(active), [not a for a in asc], list(nf))
    return np.asarray(perm)


def port_perm(cols, valids, active, asc, nf, n) -> np.ndarray:
    keys = [(torch.from_numpy(c), None if v is None else torch.from_numpy(v),
             a, f) for c, v, a, f in zip(cols, valids, asc, nf)]
    act = None if active is None else torch.from_numpy(active)
    return S.sort_perm(S.sort_images(keys), act, n).numpy()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("asc,nf", ORDERS)
def test_single_key_permutation_equals_reference(kind, asc, nf):
    rng = np.random.default_rng(KINDS.index(kind) * 4
                                + ORDERS.index((asc, nf)))
    n = 700
    col = key_column(rng, kind, n)
    valid = rng.random(n) < 0.8
    active = rng.random(n) < 0.85
    want = reference_perm([col], [valid], active, [asc], [nf])
    got = port_perm([col], [valid], active, [asc], [nf], n)
    np.testing.assert_array_equal(got, want)
    # no validity mask and no live mask
    want = reference_perm([col], [None], np.ones(n, bool), [asc], [nf])
    got = port_perm([col], [None], None, [asc], [nf], n)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", range(6))
def test_multi_key_permutation_equals_reference(seed):
    """Three or four keys of drawn types, directions and null orders."""
    rng = np.random.default_rng(100 + seed)
    n = 900
    k = 3 + seed % 2
    kinds = [KINDS[i] for i in rng.integers(0, len(KINDS), k)]
    orders = [ORDERS[i] for i in rng.integers(0, 4, k)]
    cols = [key_column(rng, kd, n, span=3) for kd in kinds]
    valids = [rng.random(n) < 0.9 if i % 2 == 0 else None
              for i in range(k)]
    active = rng.random(n) < 0.9
    asc = [a for a, _ in orders]
    nf = [f for _, f in orders]
    want = reference_perm(cols, valids, active, asc, nf)
    got = port_perm(cols, valids, active, asc, nf, n)
    np.testing.assert_array_equal(got, want)


def test_images_fold_small_keys_and_split_wide_ones():
    """A key of at most 4 bytes is one 5-byte word; an 8-byte key with
    nulls is a flag word above its view."""
    n = 4
    d32 = torch.tensor([3, -1, 0, 2], dtype=torch.int32)
    d64 = torch.tensor([3, -1, 0, 2], dtype=torch.int64)
    v = torch.tensor([True, False, True, True])
    words = S.sort_images([(d32, v, True, True), (d64, v, False, False),
                           (d64, None, True, True)])
    assert [b for _, b in words] == [5, 1, 8, 8]
    assert words[0][0].tolist() == [(1 << 32) + 3 + (1 << 31),
                                    (-1 + (1 << 31)), (1 << 32) + (1 << 31),
                                    (1 << 32) + 2 + (1 << 31)]
    assert words[1][0].tolist() == [0, 1, 0, 0]
    assert words[2][0].tolist() == [~3, ~-1, ~0, ~2]
    assert S.sort_perm([], None, n).tolist() == [0, 1, 2, 3]


@pytest.mark.parametrize("kind", ["int32", "int64", "float64", "float32",
                                  "date"])
@pytest.mark.parametrize("asc,nf", ORDERS)
def test_range_key_orders_like_the_reference(kind, asc, nf):
    """The range key of every valid row equals ``_range_key_fn``'s view;
    nulls sit at the end the order puts them (int64 extremes here, the
    key type's extremes there)."""
    rng = np.random.default_rng(7)
    n = 300
    col = key_column(rng, kind, n, span=50)
    valid = rng.random(n) < 0.8
    fn = jexec._range_key_fn(JBound(0, _JTYPE[kind], True), not asc, nf)
    want = np.asarray(fn(((jnp.asarray(col), jnp.asarray(valid)),)))
    perm = torch.from_numpy(rng.permutation(n).astype(np.int32))
    got = S.range_key(torch.from_numpy(col), torch.from_numpy(valid), asc,
                      nf, perm).numpy()
    p = perm.numpy()
    want = want[p]
    ok = valid[p]
    np.testing.assert_array_equal(got[ok], want[ok].astype(np.int64))
    sentinel = np.iinfo(np.int64).min if nf else np.iinfo(np.int64).max
    assert (got[~ok] == sentinel).all()


def test_gather_and_sample_bounds():
    d = torch.arange(10, dtype=torch.int64) * 3
    v = torch.arange(10) % 3 != 0
    perm = torch.tensor([9, 0, 4, 4], dtype=torch.int32)
    (gd, gv), = S.gather_columns([(d, v)], perm)
    assert gd.tolist() == [27, 0, 12, 12]
    assert gv.tolist() == [False, False, True, True]
    keys = [np.arange(0, 1000, 2), np.arange(1, 1000, 2), np.array([5] * 7)]
    bounds = sample_bounds(keys, 4)
    assert bounds[0][0] is None and bounds[-1][1] is None
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    assert sample_bounds([np.array([], dtype=np.int64)], 3) == [(None, None)]


def test_sort_wrappers_refuse_cpu_tensors():
    d = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA"):
        S.sort_images_kernel([(d, None, True, True)])
    with pytest.raises(ValueError, match="CUDA"):
        S.sort_perm_kernel([(d, 8)], None, 4)
    with pytest.raises(ValueError, match="CUDA"):
        S.range_key_kernel(d, None, True, True)
    with pytest.raises(ValueError, match="CUDA"):
        S.gather_kernel([(d, None)], torch.zeros(4, dtype=torch.int32))
    assert S.sort_perm_kernel.launches == 0
    assert S.gather_kernel.launches == 0


# ---------------------------------------------------------------------------------
# SortExec through both Sessions
# ---------------------------------------------------------------------------------

def sort_table(n: int, seed: int = 3) -> dict:
    """Keys with ties that straddle batches, nulls, and float edges."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 20, n).astype(np.int64)
    f = rng.choice(np.array([-0.0, 0.0, 1.5, -2.0, np.inf, np.nan, 7.25]),
                   n)
    x = np.arange(n, dtype=np.int64)
    kn = np.array([None if rng.random() < 0.1 else int(v) for v in k],
                  dtype=object)
    return {"k": k, "f": f, "x": x, "kn": kn,
            "d": (np.datetime64("1995-01-01")
                  + rng.integers(0, 30, n).astype("timedelta64[D]"))}


def _rows_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            if isinstance(b, float) and math.isnan(b):
                assert isinstance(a, float) and math.isnan(a), (g, w)
            else:
                assert a == b, (g, w)


ORDER_BYS = {
    "int": lambda F: ["k", "x"],
    "float_desc_then_int": lambda F: [F.col("f").desc(), F.col("k")],
    "nullable_nulls_last": lambda F: [F.col("kn").desc(), "d"],
    "date_then_float": lambda F: ["d", F.col("f").desc(), F.col("k").desc()],
    "ties_only": lambda F: ["k"],
}


@pytest.mark.parametrize("order,batch_rows", [
    (o, 500) for o in ORDER_BYS] + [("int", 1 << 20),
                                    ("date_then_float", 1 << 20)])
def test_sort_exec_matches_reference(order, batch_rows):
    """The same rows in the same order as the reference, out-of-core (500-
    row batches: 8 runs, ranges cut on the primary key) and in-core, at no
    more blocking fetches."""
    data = sort_table(3700)
    settings = {"spark.rapids.tpu.sql.batchSizeRows": batch_rows}
    jsess = jsrt.Session(settings)
    tsess = tsrt.Session(settings, device="cpu")
    jdf = jsess.create_dataframe(data).sort(*ORDER_BYS[order](JF))
    tdf = tsess.create_dataframe(data).sort(*ORDER_BYS[order](TF))
    with JStats.scoped() as st:
        want = jdf.collect()
    got = tdf.collect()
    _rows_equal(got, want)
    assert tsess.last_query_stats().blocking_fetches <= st.blocking_fetches


def test_out_of_core_sort_after_a_filter_and_to_device_arrays():
    """Filtered runs (live rows first, their count riding the range keys'
    fetch), handed over on the device."""
    data = sort_table(5000, seed=9)
    settings = {"spark.rapids.tpu.sql.batchSizeRows": 500}
    jsess = jsrt.Session(settings)
    tsess = tsrt.Session(settings, device="cpu")
    jdf = (jsess.create_dataframe(data).where(JF.col("k") > 3)
           .sort(JF.col("f").desc(), "k"))
    tdf = (tsess.create_dataframe(data).where(TF.col("k") > 3)
           .sort(TF.col("f").desc(), "k"))
    with JStats.scoped() as st:
        want = jdf.to_device_arrays()
    got = tdf.to_device_arrays()
    assert set(got) == set(want)
    for c in want:
        w, g = np.asarray(want[c][0]), got[c][0].numpy()
        np.testing.assert_array_equal(g, w)
    # one fetch for every run's range key, one for the compaction
    assert tsess.last_query_stats().blocking_fetches <= min(
        2, st.blocking_fetches)


def test_string_sort_keys_stay_on_the_host_sort():
    """An ORDER BY on a string key is placed on the CPU, as the reference
    places it, and gives its rows."""
    rng = np.random.default_rng(4)
    data = {"s": rng.choice(np.array(["b", "a", "c"]), 50),
            "x": np.arange(50, dtype=np.int64)}
    jsess, tsess = jsrt.Session({}), tsrt.Session({}, device="cpu")
    jdf = jsess.create_dataframe(data).sort("s", JF.col("x").desc())
    tdf = tsess.create_dataframe(data).sort("s", TF.col("x").desc())
    assert tdf.collect() == jdf.collect()
    assert tdf.explain_string().splitlines()[2:] == \
        jdf.explain_string().splitlines()[2:]


def test_decimal_columns_raise_naming_row_12():
    import decimal
    tsess = tsrt.Session({}, device="cpu")
    with pytest.raises(NotImplementedError, match="row 12"):
        tsess.create_dataframe({"p": np.array([decimal.Decimal("1.5")],
                                              dtype=object)})


def test_limit_past_the_top_k_runs_the_full_sort():
    """ORDER BY ... LIMIT k with k over the top-k kernel's 1,024 rows, or
    more keys than it takes, is the full sort and a LIMIT."""
    data = sort_table(3000, seed=5)
    jsess, tsess = jsrt.Session({}), tsrt.Session({}, device="cpu")
    for F, sess in ((JF, jsess), (TF, tsess)):
        df = sess.create_dataframe(data)
        out = (df.sort("k", F.col("x").desc()).limit(1500).collect(),
               df.sort("k", "d", F.col("f").desc(), "x", "kn").limit(9)
               .collect())
        if sess is jsess:
            want = out
        else:
            got = out
    _rows_equal(got[0], want[0])
    _rows_equal(got[1], want[1])
