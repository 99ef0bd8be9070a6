"""Decimals in the port against the JAX package, on the CPU.

The same numpy integers go to both packages: the reference gets pyarrow
``decimal128`` tables (built from the unscaled integers' bytes), the port
``DecimalArray``s or ``decimal.Decimal`` object arrays.  Covered: every
case of the reference's ``tests/test_decimal.py`` classes
TestDecimalPromotion, TestWideDecimalSum and TestWideDecimalDevice
(exact), the plain versions of ``ops/wide_decimal.py`` against the JAX
functions bit for bit, the on-device wide-sum finalize against exact
Python integers, pyarrow's decimal inference, and TPC-H Q1, Q6 and Q18
over DECIMAL(12, 2) money columns against the reference, the exact
oracles and the reference's fetch count.  Decimal results are exact;
decimal averages (doubles) within rel 1e-9."""

import collections
from decimal import Decimal

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

import spark_rapids_tpu as jsrt
from spark_rapids_tpu.ops import wide_decimal as jwd
from spark_rapids_tpu.sql import functions as JF
from spark_rapids_tpu.utils.metrics import QueryStats as JStats
import spark_rapids_tpu_torch as tsrt
from spark_rapids_tpu_torch.batch import DecimalArray, numpy_column, \
    wide_limbs
from spark_rapids_tpu_torch.models import tpch
from spark_rapids_tpu_torch.ops import wide_decimal as twd
from spark_rapids_tpu_torch.sql import functions as TF

REL = 1e-9
I64_MIN, I64_MAX = -(1 << 63), (1 << 63) - 1


def ref_decimal(unscaled, precision: int, scale: int, valid=None):
    """A pyarrow decimal128 array from unscaled ints (or int64 limbs)."""
    u = np.asarray(unscaled)
    limbs = u if u.ndim == 2 else (
        wide_limbs([int(x) for x in u]) if u.dtype == object
        else np.stack([u.astype(np.int64), u.astype(np.int64) >> 63], 1))
    mask = None if valid is None else pa.py_buffer(
        np.packbits(np.asarray(valid, bool), bitorder="little").tobytes())
    return pa.Array.from_buffers(
        pa.decimal128(precision, scale), len(limbs),
        [mask, pa.py_buffer(np.ascontiguousarray(limbs, np.int64).tobytes())])


def both_columns(unscaled, precision, scale, valid=None):
    """(reference column, port column) of the same decimal values."""
    u = np.asarray(unscaled)
    port = u if u.ndim == 2 or u.dtype != object else wide_limbs(
        [int(x) for x in u])
    return (ref_decimal(unscaled, precision, scale, valid),
            DecimalArray(port, precision, scale, valid))


def _unscaled(rows, scale):
    vals = [0 if r is None else int(Decimal(r).scaleb(scale)) for r in rows]
    return np.array(vals, dtype=np.int64), np.array(
        [r is not None for r in rows])


@pytest.fixture(scope="module")
def sessions():
    return (jsrt.Session({}), tsrt.Session({}, device="cpu"))


def _both(sessions, cols):
    """DataFrames over the same columns: ``cols`` maps a name to a plain
    numpy array or to (reference column, port column)."""
    jsess, tsess = sessions
    j = pa.table({k: v[0] if isinstance(v, tuple) else v
                  for k, v in cols.items()})
    t = {k: v[1] if isinstance(v, tuple) else v for k, v in cols.items()}
    return jsess.create_dataframe(j), tsess.create_dataframe(t)


def _promo(sessions, rows, scale=2, precision=5):
    u, ok = _unscaled(rows, scale)
    return _both(sessions, {
        "d": both_columns(u, precision, scale, None if ok.all() else ok),
        "i": np.arange(len(rows), dtype=np.int32)})


def _rows_equal(jdf, tdf):
    got, want = tdf.collect(), jdf.collect()
    assert got == want
    return got


# ---------------------------------------------------------------------------------
# The reference's TestDecimalPromotion
# ---------------------------------------------------------------------------------

def test_decimal_eq_int_literal(sessions):
    j, t = _promo(sessions, ["1.00", "2.00", "2.50", None])
    got = _rows_equal(j.where(JF.col("d") == 2), t.where(TF.col("d") == 2))
    assert [r[1] for r in got] == [1]


def test_decimal_lt_int_literal(sessions):
    j, t = _promo(sessions, ["1.00", "2.00", "2.50", "3.00"])
    got = _rows_equal(j.where(JF.col("d") < 3), t.where(TF.col("d") < 3))
    assert sorted(r[1] for r in got) == [0, 1, 2]


def test_decimal_divide_int(sessions):
    j, t = _promo(sessions, ["1.50", "3.00"])
    got = _rows_equal(j.select((JF.col("d") / 2).alias("h")),
                      t.select((TF.col("d") / 2).alias("h")))
    assert [r[0] for r in got] == [0.75, 1.5]


def test_decimal_divide_decimal(sessions):
    j, t = _promo(sessions, ["1.50", "3.00"])
    got = _rows_equal(j.select((JF.col("d") / JF.col("d")).alias("r")),
                      t.select((TF.col("d") / TF.col("d")).alias("r")))
    assert [r[0] for r in got] == [1.0, 1.0]


def test_mixed_scale_add(sessions):
    j, t = _both(sessions, {"a": both_columns([15], 5, 1),
                            "b": both_columns([25], 5, 2)})
    got = _rows_equal(j.select((JF.col("a") + JF.col("b")).alias("s")),
                      t.select((TF.col("a") + TF.col("b")).alias("s")))
    assert got[0][0] == Decimal("1.75")


def test_mixed_scale_compare(sessions):
    j, t = _both(sessions, {"a": both_columns([15, 20], 5, 1),
                            "b": both_columns([150, 201], 6, 2)})
    got = _rows_equal(j.where(JF.col("a") == JF.col("b")),
                      t.where(TF.col("a") == TF.col("b")))
    assert len(got) == 1 and got[0][0] == Decimal("1.5")


def test_decimal_plus_int_column(sessions):
    j, t = _promo(sessions, ["1.00", "2.00", "3.00"])
    got = _rows_equal(j.select((JF.col("d") + JF.col("i")).alias("s")),
                      t.select((TF.col("d") + TF.col("i")).alias("s")))
    assert [r[0] for r in got] == [Decimal("1.00"), Decimal("3.00"),
                                   Decimal("5.00")]


def test_decimal_mul_int(sessions):
    j, t = _promo(sessions, ["1.25", "2.00"])
    got = _rows_equal(j.select((JF.col("d") * 4).alias("m")),
                      t.select((TF.col("d") * 4).alias("m")))
    assert [r[0] for r in got] == [Decimal("5.00"), Decimal("8.00")]


def test_decimal_compare_float(sessions):
    j, t = _promo(sessions, ["1.25", "2.00"])
    got = _rows_equal(j.where(JF.col("d") > 1.5), t.where(TF.col("d") > 1.5))
    assert [r[0] for r in got] == [Decimal("2.00")]


def test_decimal_in_list(sessions):
    j, t = _promo(sessions, ["1.00", "2.00", "3.00"])
    got = _rows_equal(j.where(JF.col("d").isin([1, 3])),
                      t.where(TF.col("d").isin([1, 3])))
    assert sorted(r[1] for r in got) == [0, 2]


def test_null_propagation(sessions):
    j, t = _promo(sessions, ["1.00", None])
    got = _rows_equal(j.select((JF.col("d") + 1).alias("s")),
                      t.select((TF.col("d") + 1).alias("s")))
    assert got[0][0] == Decimal("2.00") and got[1][0] is None


# ---------------------------------------------------------------------------------
# The reference's TestWideDecimalSum
# ---------------------------------------------------------------------------------

def _wide_sum_table(sessions, vals, precision=15, scale=2):
    u, ok = _unscaled(vals, scale)
    return _both(sessions, {
        "k": np.array([i % 3 for i in range(len(vals))], dtype=np.int64),
        "d": both_columns(u, precision, scale, None if ok.all() else ok)})


def test_grouped_wide_sum_exact(sessions):
    j, t = _wide_sum_table(sessions, ["9999999999999.99"] * 600)
    got = dict(t.group_by("k").agg(TF.sum(TF.col("d")).alias("s")).collect())
    want = dict(j.group_by("k").agg(JF.sum(JF.col("d")).alias("s"))
                .collect())
    each = Decimal("9999999999999.99")
    assert got == want == {0: each * 200, 1: each * 200, 2: each * 200}


def test_ungrouped_wide_sum(sessions):
    j, t = _wide_sum_table(sessions, ["123456789012345.67", "-0.67", None],
                           precision=17)
    got = _rows_equal(j.agg(JF.sum(JF.col("d")).alias("s")),
                      t.agg(TF.sum(TF.col("d")).alias("s")))
    assert got[0][0] == Decimal("123456789012345.00")


def test_result_precision_is_spark(sessions):
    _, t = _wide_sum_table(sessions, ["1.00"])
    f = t.agg(TF.sum(TF.col("d")).alias("s")).schema.fields[0]
    assert f.dtype.precision == 25 and f.dtype.scale == 2


def test_two_phase_wide_sum_raises():
    """The reference's partial/final split (row 5′) raised here until the
    distribution slice ported it: a wide SUM's int64 lanes now merge as
    sum buffers in the final, and the split's rows equal the one-pass
    plan's, exactly."""
    u, _ = _unscaled(["8888888888888.88"] * 90, 2)
    data = {"k": np.arange(90) % 3, "d": DecimalArray(u, 15, 2)}
    rows = []
    for complete in (False, True):
        sess = tsrt.Session({
            "spark.rapids.tpu.sql.agg.singleProcessComplete": complete},
            device="cpu")
        rows.append(sorted(sess.create_dataframe(data).group_by("k").agg(
            TF.sum(TF.col("d")).alias("s")).collect()))
    assert rows[0] == rows[1]
    assert [r[1] for r in rows[0]] == [Decimal("266666666666666.40")] * 3


@pytest.mark.parametrize("ansi", [False, True])
def test_wide_sum_overflow_is_null_or_raises_under_ansi(ansi):
    """A SUM past its 38 digits is null, or under ANSI mode raises, in
    both packages (the port finalizes on the device)."""
    settings = {"spark.rapids.tpu.sql.ansi.enabled": ansi}
    big = np.array([9 * 10 ** 37, 9 * 10 ** 37, 5], dtype=object)
    j, t = _both((jsrt.Session(settings), tsrt.Session(settings,
                                                        device="cpu")),
                 {"k": np.array([0, 0, 1]), "d": both_columns(big, 38, 0)})
    outs = []
    for df, F in ((j, JF), (t, TF)):
        q = df.group_by("k").agg(F.sum(F.col("d")).alias("s"))
        if ansi:
            with pytest.raises(OverflowError):
                q.collect()
        else:
            outs.append(sorted(q.collect()))
    if not ansi:
        assert outs[0] == outs[1] == [(0, None), (1, Decimal(5))]


# ---------------------------------------------------------------------------------
# The reference's TestWideDecimalDevice
# ---------------------------------------------------------------------------------

def _wide_device_table(sessions, n=500, seed=7):
    rng = np.random.default_rng(seed)
    ints = [int(x) * 31 for x in rng.integers(-10**18, 10**18, n)]
    valid = np.ones(n, dtype=bool)
    valid[3] = False
    ints[3] = 0
    vals = [None if not ok else Decimal(v).scaleb(-2)
            for v, ok in zip(ints, valid)]
    k = rng.integers(0, 5, n)
    j, t = _both(sessions, {
        "a": both_columns(np.array(ints, dtype=object), 25, 2, valid),
        "b": both_columns(np.full(n, 150, np.int64), 25, 2),
        "k": k})
    return j, t, vals, k


def test_wide_add_sub_on_device(sessions):
    j, t, vals, _ = _wide_device_table(sessions)
    q = t.select((TF.col("a") + TF.col("b")).alias("s"),
                 (TF.col("a") - TF.col("b")).alias("d"))
    assert "!" not in q.explain_string().split("\n")[2]
    got = _rows_equal(j.select((JF.col("a") + JF.col("b")).alias("s"),
                               (JF.col("a") - JF.col("b")).alias("d")), q)
    for (gs, gd), v in zip(got, vals):
        if v is None:
            assert gs is None and gd is None
        else:
            assert gs == v + Decimal("1.50") and gd == v - Decimal("1.50")


def test_wide_compare_filter(sessions):
    j, t, vals, _ = _wide_device_table(sessions)
    got = _rows_equal(j.filter(JF.col("a") > JF.col("b")),
                      t.filter(TF.col("a") > TF.col("b")))
    assert len(got) == sum(1 for v in vals
                           if v is not None and v > Decimal("1.5"))
    got = _rows_equal(j.filter(JF.col("a") <= JF.lit(Decimal("0.00"))),
                      t.filter(TF.col("a") <= TF.lit(Decimal("0.00"))))
    assert len(got) == sum(1 for v in vals if v is not None and v <= 0)


def test_wide_grouped_sum_exact(sessions):
    j, t, vals, k = _wide_device_table(sessions)
    got = dict(t.group_by("k").agg(TF.sum(TF.col("a")).alias("s")).collect())
    want = collections.defaultdict(Decimal)
    for v, kk in zip(vals, k.tolist()):
        if v is not None:
            want[kk] += v
    assert got == dict(want) == dict(
        j.group_by("k").agg(JF.sum(JF.col("a")).alias("s")).collect())


def test_wide_ungrouped_sum_and_literal(sessions):
    j, t, vals, _ = _wide_device_table(sessions)
    got = _rows_equal(j.agg(JF.sum(JF.col("a")).alias("s")),
                      t.agg(TF.sum(TF.col("a")).alias("s")))
    assert got[0][0] == sum(v for v in vals if v is not None)


def test_wide_group_key_raises_naming_item_6(sessions):
    """The reference groups decimal128 keys on the CPU; the port has no
    CPU aggregate, so it raises, naming ROADMAP item 6."""
    j, t, _, _ = _wide_device_table(sessions, n=100)
    jq = j.group_by("b").agg(JF.count_star().alias("c"))
    tq = t.group_by("b").agg(TF.count_star().alias("c"))
    assert "decimal128 grouping keys" in jq.explain_string()
    assert tq.explain_string().splitlines()[2:] == \
        jq.explain_string().splitlines()[2:]
    with pytest.raises(NotImplementedError, match="item 6"):
        tq.collect()


def test_wide_join_and_sort_keys_raise(sessions):
    j, t, _, _ = _wide_device_table(sessions, n=50)
    with pytest.raises(NotImplementedError, match="item 6"):
        t.join(t.select(TF.col("b").alias("b2")),
               on=[("b", "b2")]).collect()
    with pytest.raises(NotImplementedError, match="item 7"):
        t.sort("a").collect()


# ---------------------------------------------------------------------------------
# ops/wide_decimal.py: plain versions against the JAX functions, bit for bit
# ---------------------------------------------------------------------------------

def _limb_cases(seed=3, n=4000):
    rng = np.random.default_rng(seed)
    a = rng.integers(I64_MIN, I64_MAX, (n, 2), dtype=np.int64,
                     endpoint=True)
    b = rng.integers(I64_MIN, I64_MAX, (n, 2), dtype=np.int64,
                     endpoint=True)
    edge = [0, 1, -1, I64_MIN, I64_MAX, 10 ** 38 - 1, -(10 ** 38 - 1),
            (1 << 64) - 1, 1 << 64, -(1 << 64), (1 << 127) - 1, -(1 << 127)]
    e = wide_limbs(edge)
    # carries: lo limbs that wrap when added
    a[:len(edge)], b[:len(edge)] = e, e[::-1]
    a[len(edge):2 * len(edge), 0] = -1
    b[len(edge):2 * len(edge), 0] = 1
    a[2 * len(edge):3 * len(edge), 0] = I64_MIN
    b[2 * len(edge):3 * len(edge), 0] = I64_MIN
    b[3 * len(edge):4 * len(edge)] = a[3 * len(edge):4 * len(edge)]
    return a, b


@pytest.mark.parametrize("op", ["add", "sub", "eq", "lt", "le", "gt", "ge"])
def test_wide_binary_plain_is_bit_exact(op):
    a, b = _limb_cases()
    want = np.asarray(getattr(jwd, op)(jnp.asarray(a), jnp.asarray(b)))
    got = getattr(twd, op)(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(got.numpy(), want)


def test_neg_and_from_scaled64_are_bit_exact():
    a, _ = _limb_cases()
    np.testing.assert_array_equal(twd.neg(torch.from_numpy(a)).numpy(),
                                  np.asarray(jwd.neg(jnp.asarray(a))))
    d = np.concatenate([a[:, 0], [I64_MIN, I64_MAX, 0, -1]])
    np.testing.assert_array_equal(
        twd.from_scaled64(torch.from_numpy(d)).numpy(),
        np.asarray(jwd.from_scaled64(jnp.asarray(d))))


@pytest.mark.parametrize("k", [0, 1, 2, 7, 18, 19, 20])
def test_mul_pow10_is_bit_exact(k):
    a, _ = _limb_cases(seed=k)
    np.testing.assert_array_equal(
        twd.mul_pow10(torch.from_numpy(a), k).numpy(),
        np.asarray(jwd.mul_pow10(jnp.asarray(a), k)))


def test_fused_rescale_equals_separate_steps():
    """One ``wide_binary`` launch lifts and rescales both operands: the
    same bits as the reference's promote-then-add."""
    rng = np.random.default_rng(11)
    narrow = rng.integers(-10**17, 10**17, 300)
    a, _ = _limb_cases(n=300)
    got = twd.wide_binary("add", torch.from_numpy(narrow),
                          torch.from_numpy(a), ka=3, kb=1).numpy()
    want = jwd.add(jwd.mul_pow10(jwd.from_scaled64(jnp.asarray(narrow)), 3),
                   jwd.mul_pow10(jnp.asarray(a), 1))
    np.testing.assert_array_equal(got, np.asarray(want))


def _exact(limbs):
    lo = int(limbs[0]) & ((1 << 64) - 1)
    v = (int(limbs[1]) << 64) | lo
    return v - (1 << 128) if v >= (1 << 127) else v


@pytest.mark.parametrize("wide_in", [False, True])
def test_sum_finalize_is_exact_with_overflow_nulls(wide_in):
    """Lane sums of seeded rows (narrow: 2 lanes, wide: 4) against exact
    Python sums: groups past 10^precision and empty groups are null, and
    the overflow flag is set only by a non-empty group."""
    rng = np.random.default_rng(5)
    groups, n = 40, 5000
    g = rng.integers(0, groups, n)
    if wide_in:
        vals = [int(x) * 10**17 for x in rng.integers(-10**18, 10**18, n)]
        vals[:3] = [10**37, 10**37, -(10**37)]
        col = torch.from_numpy(wide_limbs(vals))
        precision = 36
    else:
        vals = [int(x) for x in rng.integers(I64_MIN, I64_MAX, n)]
        col = torch.tensor(vals, dtype=torch.int64)
        precision = 22
    lanes = twd.sum_lanes(col)
    gt = torch.from_numpy(g)
    sums = [torch.zeros(groups, dtype=torch.int64).index_add_(0, gt, x)
            for x in lanes]
    count = torch.bincount(gt, minlength=groups)
    count[7] = 0  # an empty group
    out, valid, over = twd.sum_finalize(sums, count, precision)
    exact = collections.defaultdict(int)
    for v, k in zip(vals, g.tolist()):
        exact[k] += v
    any_over = False
    for k in range(groups):
        fits = abs(exact[k]) < 10 ** precision
        any_over |= not fits and k != 7
        assert bool(valid[k]) == (fits and k != 7)
        if valid[k]:
            assert _exact(out[k].tolist()) == exact[k]
    assert bool(over[0]) == any_over


def test_pyarrow_decimal_inference():
    cases = [["1.5", "0.25"], ["-123.4", "5"], ["1E+3", "2.5"],
             ["0.001", "-0"], ["12345678901234567890.5"], ["1.50", None],
             ["0"], ["100"], ["-99.999", "0.1"]]
    for rows in cases:
        vals = [None if r is None else Decimal(r) for r in rows]
        dt, data, valid = numpy_column(np.array(vals, dtype=object))
        want = pa.array(vals).type
        assert (dt.precision, dt.scale) == (want.precision, want.scale)
        ints = [0 if v is None else int(v.scaleb(dt.scale)) for v in vals]
        got = [_exact(r) for r in data] if data.ndim == 2 else list(data)
        assert got == ints


def test_decimal_casts_match_reference(sessions):
    u, ok = _unscaled(["-12.345", "7.005", None, "0.004"], 3)
    j, t = _both(sessions, {"d": both_columns(u, 9, 3, ok)})
    from spark_rapids_tpu.types import decimal as jdec
    from spark_rapids_tpu_torch.types import decimal as tdec
    from spark_rapids_tpu_torch import types as TT
    from spark_rapids_tpu import types as JT
    for jt, tt in ((jdec(9, 2), tdec(9, 2)), (jdec(12, 5), tdec(12, 5)),
                   (JT.FLOAT64, TT.FLOAT64), (JT.INT64, TT.INT64)):
        _rows_equal(j.select(JF.col("d").cast(jt).alias("c")),
                    t.select(TF.col("d").cast(tt).alias("c")))


# ---------------------------------------------------------------------------------
# TPC-H Q1, Q6 and Q18 over decimal money columns
# ---------------------------------------------------------------------------------

DB_SF = 0.01
DB_SETTINGS = {"spark.rapids.tpu.sql.batchSizeRows": 16384,
               "spark.rapids.tpu.join.denseMinProbeRows": 0}


@pytest.fixture(scope="module")
def dec_db():
    db = tpch.gen_db_arrays(DB_SF, tables=("customer", "orders",
                                           "lineitem"))
    jsess = jsrt.Session(DB_SETTINGS)
    tsess = tsrt.Session(DB_SETTINGS, device="cpu")
    jdf, tdf = {}, {}
    for table in ("customer", "orders", "lineitem"):
        names = tpch.MONEY_COLUMNS[table]
        port = tpch.decimal_columns(db[table], names)
        ref = {k: ref_decimal(v.unscaled, 12, 2) if k in names else v
               for k, v in port.items()}
        jdf[table] = jsess.create_dataframe(ref)
        tdf[table] = tsess.create_dataframe(port)
    return db, jdf, tdf, tsess


def _close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            if isinstance(b, float):
                assert abs(a - b) <= REL * abs(b), (g, w)
            else:
                assert a == b, (g, w)


def _operators(df):
    """The plan's operators, every one on the device, without the column
    pruning projections: the reference prunes the semi join's output with
    a Project above it, the port prunes the scan below it (since PR 3's
    Q18)."""
    lines = df.explain_string().splitlines()[2:]
    assert all(ln.lstrip().startswith("*") for ln in lines), lines
    return [ln.strip() for ln in lines if "* Project [o_orderkey" not in ln]


@pytest.mark.parametrize("query", ["q1_dec", "q6_dec"])
def test_q1_q6_dec_match_reference_and_oracle(dec_db, query):
    db, jdf, tdf, tsess = dec_db
    body = getattr(tpch, query)
    with JStats.scoped() as st:
        jrows = body(jdf["lineitem"], JF).collect()
    tq = body(tdf["lineitem"])
    trows = tq.collect()
    want = getattr(tpch, f"{query}_numpy")(db["lineitem"])
    _close(trows, jrows)
    _close(trows, want if query == "q1_dec" else [(want,)])
    assert tq.explain_string().splitlines()[2:] == \
        body(jdf["lineitem"], JF).explain_string().splitlines()[2:]
    # the reference reads its wide sums' limbs to the host once per
    # aggregate without counting the fetch (aggfns.py:139 np.asarray)
    assert tsess.last_query_stats().blocking_fetches <= \
        st.blocking_fetches + 1


def test_q18_dec_matches_oracle_and_reference_plan(dec_db):
    """The reference cannot run Q18-dec: its HAVING reads the wide sum,
    which the reference finalizes on the host into a host column its
    device filter does not read (ROADMAP queue 3).  The port's rows are
    held against the exact oracle and its aggregate against the
    reference's; the plans are the same."""
    db, jdf, tdf, tsess = dec_db
    tq = tpch.q18_dec(tdf["orders"], tdf["lineitem"], tdf["customer"])
    trows = tq.collect()
    assert trows == tpch.q18_dec_numpy(db["orders"], db["lineitem"],
                                       db["customer"])
    assert len(trows) > 10
    jq = tpch.q18_dec(jdf["orders"], jdf["lineitem"], jdf["customer"], JF)
    assert _operators(tq) == _operators(jq)
    agg = [df.group_by("l_orderkey").agg(F.sum(F.col("l_quantity"))
                                         .alias("qty"))
           for df, F in ((jdf["lineitem"], JF), (tdf["lineitem"], TF))]
    assert sorted(agg[1].collect()) == sorted(agg[0].collect())
