"""Explode (``GenerateExec``, ``ops/generate.py``) and the port's list
columns against the JAX reference.  The cases of
``tests/test_collect_explode.py`` that need no collect_list run in both
packages over the same data: the port's list column is built from the
same offsets and values as the ``pa.ListArray`` the reference is given.
Covered: null and empty lists and null elements, with and without OUTER;
siblings of every ported type (dictionary strings and narrow and wide
decimals among them); output split into ``batchSizeRows`` chunks; explode
after a filter (the list and string columns compacted on the host); X1
and X1o at SF 0.01 against the reference and the numpy oracles;
``collect()`` of an unexploded ARRAY column; the CPU tagging of string,
decimal and nested elements, where the port raises.  Rows are compared
exactly (as multisets where the order is not specified); the port makes
no more blocking fetches than the reference.  The plain explode is also
held against a numpy explode.  The port runs on the CPU."""

import datetime
import decimal

import numpy as np
import pyarrow as pa
import pytest
import torch

import spark_rapids_tpu as jsrt
from spark_rapids_tpu.sql import functions as JF
from spark_rapids_tpu.utils.metrics import QueryStats as JStats
import spark_rapids_tpu_torch as tsrt
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.batch import DecimalArray, ListArray
from spark_rapids_tpu_torch.models import tpch
from spark_rapids_tpu_torch.ops import generate
from spark_rapids_tpu_torch.sql import functions as TF
from spark_rapids_tpu_torch.utils.metrics import QueryStats as TStats

REL = 1e-12


def _pa_list(lists: ListArray, pa_type=None):
    """The reference's input: a ``pa.ListArray`` from the same offsets,
    values and validity."""
    mask = None if lists.valid is None else pa.array(~lists.valid)
    vmask = None if lists.elem_valid is None else ~lists.elem_valid
    values = pa.array(lists.values, type=pa_type, mask=vmask)
    return pa.ListArray.from_arrays(
        pa.array(lists.offsets.astype(np.int32)), values, mask=mask)


def _key(row):
    return tuple((0, 0) if x is None else (1, x) for x in row)


def _same(got, want, ordered=False):
    if not ordered:
        got, want = sorted(got, key=_key), sorted(want, key=_key)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w), (g, w)
        for a, b in zip(g, w):
            if isinstance(b, float) and a is not None:
                assert abs(a - b) <= REL * max(abs(b), 1e-300), (g, w)
            else:
                assert a == b, (g, w)


def _both(port_cols, ref_cols, build, settings=None, ordered=False):
    """``build(df, functions)`` over the port's and the reference's
    tables: asserts equal rows and the port's fetches within the
    reference's; returns the port's rows."""
    jsess = jsrt.Session(settings or {})
    tsess = tsrt.Session(settings or {}, device="cpu")
    with JStats.scoped() as js:
        jrows = build(jsess.create_dataframe(ref_cols), JF).collect()
    with TStats.scoped() as ts:
        trows = build(tsess.create_dataframe(port_cols), TF).collect()
    _same(trows, jrows, ordered)
    assert ts.blocking_fetches <= js.blocking_fetches
    return trows


def _objects(lists):
    out = np.empty(len(lists), dtype=object)
    out[:] = lists
    return out


def _lists(offsets, values, valid=None, elem_valid=None):
    return ListArray(np.asarray(offsets), np.asarray(values), valid=valid,
                     elem_valid=elem_valid)


def test_explode_from_lists_drops_empty_and_null_lists():
    arr = _objects([[10, 20], [], None])
    ids = np.array([1, 2, 3], dtype=np.int64)
    ref = {"id": ids, "arr": pa.array([[10, 20], [], None],
                                       type=pa.list_(pa.int64()))}
    got = _both({"id": ids, "arr": arr}, ref,
                lambda df, F: df.explode("arr", out_name="x"))
    assert sorted(got) == [(1, 10), (1, 20)]
    outer = _both({"id": ids, "arr": arr}, ref,
                  lambda df, F: df.explode("arr", out_name="x", outer=True))
    assert (2, None) in outer and (3, None) in outer and len(outer) == 4


@pytest.mark.parametrize("outer", [False, True])
def test_explode_outer_and_element_nulls(outer):
    # the null list spans no element; the zero in values sits under a null
    lists = _lists([0, 2, 2, 2, 3], [7, 0, 9],
                   valid=np.array([True, False, True, True]),
                   elem_valid=np.array([True, False, True]))
    k = np.array([1, 2, 3, 4], dtype=np.int64)
    got = _both({"k": k, "arr": lists}, {"k": k, "arr": _pa_list(lists)},
                lambda df, F: df.explode("arr", out_name="v", outer=outer))
    want = [(1, 7), (1, None), (4, 9)] + ([(2, None), (3, None)]
                                          if outer else [])
    assert sorted(got, key=_key) == sorted(want, key=_key)


def _sibling_tables(n=40, seed=3):
    """Siblings of every ported type beside a list column: ints of every
    width, floats, bool, date, timestamp, a narrow and a wide decimal, a
    string, with nulls."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 4, n)
    offs = np.concatenate([[0], np.cumsum(lens)])
    values = rng.integers(-50, 50, int(offs[-1]))
    valid = rng.random(n) < 0.9
    lens = np.where(valid, lens, 0)
    offs = np.concatenate([[0], np.cumsum(lens)])
    values = values[:int(offs[-1])]
    lists = _lists(offs, values, valid=valid)
    nulls = rng.random(n) < 0.2
    i64 = _objects([None if z else int(x) for z, x in
                    zip(nulls, rng.integers(-9, 9, n))])
    dates = np.datetime64("1995-01-01") + rng.integers(
        0, 900, n).astype("timedelta64[D]")
    stamps = np.datetime64("2001-01-01T00:00:00", "us") + rng.integers(
        0, 10 ** 9, n).astype("timedelta64[us]")
    cents = rng.integers(-10 ** 6, 10 ** 6, n)
    big = rng.integers(-10 ** 15, 10 ** 15, n) * 1000
    strs = np.array([f"s{i % 7}" for i in range(n)])
    port = {"i8": rng.integers(-100, 100, n).astype(np.int8),
            "i16": rng.integers(-1000, 1000, n).astype(np.int16),
            "i32": rng.integers(-10 ** 6, 10 ** 6, n).astype(np.int32),
            "i64": i64, "f32": rng.standard_normal(n).astype(np.float32),
            "f64": rng.standard_normal(n), "b": rng.random(n) < 0.5,
            "d": dates, "ts": stamps,
            "dec": DecimalArray(cents, 12, 2),
            "wide": DecimalArray(big, 30, 2), "s": strs, "arr": lists}
    ref = dict(port)
    ref["dec"] = pa.array([decimal.Decimal(int(c)).scaleb(-2)
                           for c in cents], type=pa.decimal128(12, 2))
    ref["wide"] = pa.array([decimal.Decimal(int(c)).scaleb(-2)
                            for c in big], type=pa.decimal128(30, 2))
    ref["arr"] = _pa_list(lists)
    return port, ref


@pytest.mark.parametrize("outer", [False, True])
def test_explode_gathers_siblings_of_every_type(outer):
    port, ref = _sibling_tables()
    got = _both(port, ref, lambda df, F: df.explode("arr", out_name="v",
                                                    outer=outer))
    lens = np.diff(port["arr"].offsets)
    assert len(got) == int((np.maximum(lens, 1) if outer else lens).sum())


def test_explode_gathers_dictionary_codes():
    """A computed string (a substring, carried as dictionary codes) beside
    the list: gathered on the device as codes."""
    port, ref = _sibling_tables(60, seed=4)
    build = (lambda df, F: df.with_column(
        "c", F.substring(F.col("s"), 1, 1)).select("c", "k", "arr")
        .explode("arr", out_name="v"))
    for t in (port, ref):
        t["k"] = np.arange(60, dtype=np.int64)
    _both(port, ref, build)


def test_explode_splits_output_into_batch_sized_chunks():
    n = 30
    lists = _lists(np.arange(0, 10 * n + 1, 10),
                   np.arange(10 * n, dtype=np.int64))
    k = np.arange(n, dtype=np.int64)
    settings = {"spark.rapids.tpu.sql.batchSizeRows": 64}
    got = _both({"k": k, "arr": lists}, {"k": k, "arr": _pa_list(lists)},
                lambda df, F: df.explode("arr", out_name="v"), settings)
    assert sorted(v for _, v in got) == list(range(300))
    tsess = tsrt.Session(settings, device="cpu")
    df = tsess.create_dataframe({"k": k, "arr": lists}).explode("arr", "v")
    tsess._execute(df._plan)
    ctx = tsess.last_exec_context()
    batches = [m.values["numOutputBatches"] for m in ctx.metrics.values()
               if "numOutputBatches" in m.values]
    # one input batch of 30 parents gives 300 rows: 5 chunks of <= 64
    assert batches == [5]


@pytest.mark.parametrize("outer", [False, True])
def test_explode_after_a_filter_compacts_host_columns(outer):
    port, ref = _sibling_tables(300, seed=5)
    build = (lambda df, F: df.filter((F.col("i32") > 0) & (F.col("f64") < 1))
             .explode("arr", out_name="v", outer=outer))
    settings = {"spark.rapids.tpu.sql.batchSizeRows": 64}
    _both(port, ref, build, settings)


def test_compact_of_host_columns_is_one_fetch():
    from spark_rapids_tpu_torch.batch import (ColumnBatch, DeviceColumn,
                                              Field, HostListColumn,
                                              HostStringColumn, Schema,
                                              numpy_column)
    from spark_rapids_tpu_torch.ops import batch_utils
    lists = numpy_column(_objects([[1], None, [2, 3], [], [4]]))
    batch = ColumnBatch(
        Schema([Field("k", T.INT64), Field("s", T.STRING),
                Field("a", lists[0])]),
        [DeviceColumn(T.INT64, torch.arange(5)),
         HostStringColumn(np.array(list("abcde"))),
         HostListColumn(lists[1], lists[2])], 5,
        torch.tensor([True, True, False, True, False]))
    with TStats.scoped() as st:
        out = batch_utils.compact(batch)
    assert st.blocking_fetches == 1 and out.num_rows == 3 and out.sel is None
    assert out.columns[0].data.tolist() == [0, 1, 3]
    assert out.columns[1].data.tolist() == ["a", "b", "d"]
    assert out.columns[2].data.offsets.tolist() == [0, 1, 1, 1]
    assert out.columns[2].valid.tolist() == [True, False, True]


def test_collect_of_an_unexploded_array_column():
    k = np.array([1, 2, 3, 4], dtype=np.int64)
    arr = _objects([[1.5, None], [], None, [2.5]])
    d = _objects([[datetime.date(2020, 1, 2)], None, [], [None]])
    ref = {"k": k, "arr": pa.array(list(arr), type=pa.list_(pa.float64())),
           "d": pa.array(list(d), type=pa.list_(pa.date32()))}
    got = _both({"k": k, "arr": arr, "d": d}, ref,
                lambda df, F: df.filter(F.col("k") != 2), ordered=True)
    assert got == [(1, [1.5, None], [datetime.date(2020, 1, 2)]),
                   (3, None, []), (4, [2.5], [None])]


@pytest.mark.parametrize("elem", ["int32", "bool", "date", "float32"])
def test_explode_element_types(elem):
    rng = np.random.default_rng(6)
    n = 50
    lens = rng.integers(0, 4, n)
    offs = np.concatenate([[0], np.cumsum(lens)])
    m = int(offs[-1])
    values = {"int32": rng.integers(-99, 99, m).astype(np.int32),
              "bool": rng.random(m) < 0.5,
              "date": np.datetime64("1999-01-01") + rng.integers(
                  0, 500, m).astype("timedelta64[D]"),
              "float32": rng.standard_normal(m).astype(np.float32)}[elem]
    ev = rng.random(m) < 0.85
    lists = _lists(offs, values, elem_valid=ev)
    k = np.arange(n, dtype=np.int64)
    got = _both({"k": k, "arr": lists}, {"k": k, "arr": _pa_list(lists)},
                lambda df, F: df.explode("arr", out_name="v", outer=True))
    assert len(got) == int(np.maximum(lens, 1).sum())


def test_explode_then_aggregate_double_elements():
    lists = _objects([[1.5, 2.5], [3.0], [10.0, 20.0]])
    k = np.array([1, 1, 2], dtype=np.int64)
    ref = {"k": k, "arr": pa.array(list(lists),
                                   type=pa.list_(pa.float64()))}
    got = _both({"k": k, "arr": lists}, ref,
                lambda df, F: df.explode("arr", out_name="v").group_by("k")
                .agg(F.sum(F.col("v")).alias("s")))
    assert sorted(got) == [(1, 7.0), (2, 30.0)]


def test_explode_placement_and_cpu_tagged_elements():
    s = tsrt.Session(device="cpu")
    jsess = jsrt.Session()
    num = s.create_dataframe({"k": np.array([1]), "arr": _objects([[1]])}) \
        .filter(TF.col("k") > 0).explode("arr", outer=True)
    jnum = jsess.create_dataframe({"k": np.array([1]), "arr": pa.array(
        [[1]], type=pa.list_(pa.int64()))}).filter(JF.col("k") > 0) \
        .explode("arr", outer=True)
    assert "! Generate" not in num.explain_string()
    assert num.explain_string().splitlines()[2:] == \
        jnum.explain_string().splitlines()[2:]
    cases = {
        "string": (_objects([["a", None]]),
                   pa.array([["a", None]], type=pa.list_(pa.string()))),
        "decimal": (_objects([[decimal.Decimal("1.25")]]),
                    pa.array([[decimal.Decimal("1.25")]],
                             type=pa.list_(pa.decimal128(3, 2)))),
        "nested": (ListArray(np.array([0, 1]), _objects([[1, 2]]),
                             element=T.array(T.INT64)),
                   pa.array([[[1, 2]]], type=pa.list_(pa.list_(
                       pa.int64()))))}
    for what, (port_arr, ref_arr) in cases.items():
        tdf = s.create_dataframe({"arr": port_arr}).explode("arr")
        jdf = jsess.create_dataframe({"arr": ref_arr}).explode("arr")
        texp = tdf.explain_string()
        assert "runs on CPU" in texp, what
        assert texp.splitlines()[2:] == jdf.explain_string().splitlines()[2:]
        with pytest.raises(NotImplementedError, match="item 6"):
            tdf.collect()


def _numpy_explode(starts, eoffs, values, values_valid, cols, lo, m):
    n = len(starts) - 1
    parent = np.repeat(np.arange(n), np.diff(starts))[lo:lo + m]
    rows = np.arange(lo, lo + m)
    if eoffs is None:
        e, ok = rows, np.ones(m, dtype=bool)
    else:
        ok = eoffs[parent + 1] > eoffs[parent]
        e = np.where(ok, eoffs[parent] + rows - starts[parent], 0)
    if values_valid is not None and len(values):
        ok = ok & values_valid[e]
    data = np.where(ok, values[e] if len(values) else 0, 0)
    return data, ok, [(d[parent], None if v is None else v[parent])
                      for d, v in cols]


@pytest.mark.parametrize("outer", [False, True])
def test_plain_explode_equals_numpy(outer):
    rng = np.random.default_rng(8)
    n = 500
    lens = np.where(rng.random(n) < 0.2, 0, rng.integers(0, 30, n))
    out_lens = np.maximum(lens, 1) if outer else lens
    starts = np.concatenate([[0], np.cumsum(out_lens)])
    eoffs = np.concatenate([[0], np.cumsum(lens)]) if outer else None
    values = rng.standard_normal(int(lens.sum()))
    vv = rng.random(len(values)) < 0.9
    cols = [(rng.integers(0, 99, n), rng.random(n) < 0.8),
            (rng.integers(0, 9, (n, 2)), None)]
    total = int(starts[-1])
    t = torch.from_numpy
    for lo in range(0, total, 97):
        m = min(97, total - lo)
        (d, v), moved = generate.explode_rows(
            t(starts), None if eoffs is None else t(eoffs), lo, m,
            t(values), t(vv), [(t(a), None if b is None else t(b))
                               for a, b in cols], True)
        wd, wv, wcols = _numpy_explode(starts, eoffs, values, vv, cols, lo,
                                       m)
        assert np.array_equal(d.numpy(), wd) and np.array_equal(v.numpy(),
                                                                wv)
        for (gd, gv), (xd, xv) in zip(moved, wcols):
            assert np.array_equal(gd.numpy(), xd)
            assert (gv is None) == (xv is None)
            assert gv is None or np.array_equal(gv.numpy(), xv)


@pytest.fixture(scope="module")
def db():
    return tpch.gen_db_arrays(0.01, tables=("orders", "lineitem"))


X1_SETTINGS = {"spark.rapids.tpu.sql.batchSizeRows": 4096}


def test_x1_matches_reference_and_oracle(db):
    lists = tpch.order_quantities(db["orders"], db["lineitem"])
    cols = {c: db["orders"][c] for c in ("o_orderkey", "o_orderdate",
                                         "o_orderpriority")}
    got = _both(dict(cols, o_qty=lists), dict(cols, o_qty=_pa_list(lists)),
                lambda df, F: tpch.x1(df, functions=F), X1_SETTINGS,
                ordered=True)
    want = tpch.x1_numpy(db["orders"], db["lineitem"])
    _same(got, want, ordered=True)
    assert sum(r[2] for r in got) > 0


def test_x1o_matches_reference_and_oracle(db):
    lists = tpch.order_quantities(db["orders"], db["lineitem"], 0.01, 0.01)
    okey = db["orders"]["o_orderkey"]
    tsess = tsrt.Session(X1_SETTINGS, device="cpu")
    jsess = jsrt.Session(X1_SETTINGS)
    with TStats.scoped() as ts:
        out = tpch.x1o(tsess.create_dataframe(
            {"o_orderkey": okey, "o_qty": lists})).to_device_arrays()
    with JStats.scoped() as js:
        ref = tpch.x1o(jsess.create_dataframe(
            {"o_orderkey": okey, "o_qty": _pa_list(lists)})) \
            .to_device_arrays()
    want = tpch.x1o_numpy({"o_orderkey": okey}, lists)
    assert ts.blocking_fetches <= js.blocking_fetches
    assert (~want["qty"][1]).sum() > 0  # null and emptied lists are there

    def rows(cols, to_np):
        k = to_np(cols["o_orderkey"][0])
        q, ok = to_np(cols["qty"][0]), cols["qty"][1]
        ok = np.ones(len(q), bool) if ok is None else to_np(ok)
        return sorted(zip(k.tolist(), np.where(ok, q, 0.0).tolist(),
                          ok.tolist()))
    got = rows(out, lambda x: x.numpy())
    assert got == rows(want, np.asarray)
    assert got == rows(ref, lambda x: np.asarray(x)[:len(got)])


# ---------------------------------------------------------------------------------
# The kernel's tile edges (``csrc/explode.cu`` takes 2,048 merge-path items,
# rows and parents' ends, a tile; 16 siblings a launch), run here through
# the plain version: a list longer than a tile and a chunk, runs of more
# than a tile of empty and null lists under OUTER, chunks that start inside
# lists, 17 siblings, siblings of every width with validity, wide decimals.
# ---------------------------------------------------------------------------------

EDGE_CHUNK = 1000


def _edge_lists(case, rng):
    """(list lengths, list validity) of one tile-edge case."""
    if case == "long_list":
        lens = rng.integers(0, 4, 60)
        lens[17] = 5_000
        return lens, rng.random(60) < 0.9
    if case == "empty_and_null_runs":
        lens = np.concatenate([rng.integers(1, 4, 40), np.zeros(2_500, int),
                               rng.integers(1, 4, 40), rng.integers(
                                   1, 4, 2_500), rng.integers(0, 4, 40)])
        valid = np.ones(len(lens), bool)
        valid[2_580:5_080] = False  # a run of 2,500 null lists
        return lens, valid
    lens = np.full(700, 7)  # 1,000 rows a chunk: chunks start inside lists
    return lens, rng.random(700) < 0.97


def _edge_siblings(case, n, rng):
    """(port columns, reference columns) of the siblings beside the
    list."""
    nulls = rng.random(n) < 0.25
    if case == "17_siblings":
        cols = {f"c{i}": rng.integers(-9, 9, n) + 100 * i for i in range(17)}
        return cols, dict(cols)
    if case == "wide_decimals":
        big = rng.integers(-10 ** 15, 10 ** 15, n) * 1000
        small = rng.integers(-10 ** 6, 10 ** 6, n)
        port = {"w": DecimalArray(big, 30, 2, valid=~nulls),
                "w2": DecimalArray(small, 25, 3),
                "id": np.arange(n, dtype=np.int64)}
        ref = {"w": pa.array([None if z else decimal.Decimal(int(c))
                              .scaleb(-2) for z, c in zip(nulls, big)],
                             type=pa.decimal128(30, 2)),
               "w2": pa.array([decimal.Decimal(int(c)).scaleb(-3)
                               for c in small], type=pa.decimal128(25, 3)),
               "id": port["id"]}
        return port, ref
    # every width: 1 byte with and without validity, 2, 4 with validity, 8
    # with validity, floats of 4 and 8
    flags = [None if z else bool(b) for z, b in
             zip(nulls, rng.random(n) < 0.5)]
    days = [None if z else datetime.date(1995, 1, 1) + datetime.timedelta(
        days=int(d)) for z, d in zip(rng.random(n) < 0.2,
                                     rng.integers(0, 900, n))]
    ints = [None if z else int(x) for z, x in
            zip(rng.random(n) < 0.3, rng.integers(-10 ** 12, 10 ** 12, n))]
    port = {"b": _objects(flags),
            "i8": rng.integers(-100, 100, n).astype(np.int8),
            "i16": rng.integers(-1000, 1000, n).astype(np.int16),
            "d": _objects(days), "i64": _objects(ints),
            "f32": rng.standard_normal(n).astype(np.float32),
            "f64": rng.standard_normal(n)}
    ref = dict(port, b=pa.array(flags, type=pa.bool_()),
               d=pa.array(days, type=pa.date32()),
               i64=pa.array(ints, type=pa.int64()))
    return port, ref


def _numpy_rows(names, port, lens, valid, values, elem_valid, outer):
    """The explode's rows by numpy: per parent its siblings (as the
    port's collect gives them) and each element, or one null row under
    OUTER for an empty or null list."""
    offs = np.concatenate([[0], np.cumsum(np.where(valid, lens, 0))])
    sib = []
    for name in names:
        col = port[name]
        if isinstance(col, DecimalArray):
            v = col.unscaled if col.unscaled.ndim == 1 else (
                col.unscaled[:, 0].astype(object) % (1 << 64)
                + (col.unscaled[:, 1].astype(object) << 64))
            vals = [decimal.Decimal(int(x)).scaleb(-col.dtype.scale)
                    for x in v]
            ok = np.ones(len(vals), bool) if col.valid is None else col.valid
            sib.append([x if o else None for x, o in zip(vals, ok)])
        elif col.dtype == object:
            sib.append(list(col))
        else:
            sib.append(col.tolist())
    rows = []
    for i in range(len(lens)):
        lo, hi = int(offs[i]), int(offs[i + 1])
        head = tuple(s[i] for s in sib)
        if hi == lo:
            if outer:
                rows.append(head + (None,))
            continue
        for e in range(lo, hi):
            rows.append(head + (int(values[e]) if elem_valid[e] else None,))
    return rows


@pytest.mark.parametrize("case,outer", [
    ("long_list", False), ("long_list", True),
    ("empty_and_null_runs", True), ("chunk_inside_list", False),
    ("chunk_inside_list", True), ("17_siblings", True),
    ("sibling_widths", True), ("sibling_widths", False),
    ("wide_decimals", True)])
def test_explode_tile_edges_match_reference_and_numpy(case, outer):
    rng = np.random.default_rng(1916)
    shape = case if case in ("long_list", "empty_and_null_runs") \
        else "chunk_inside_list"
    lens, valid = _edge_lists(shape, rng)
    n = len(lens)
    offs = np.concatenate([[0], np.cumsum(np.where(valid, lens, 0))])
    values = rng.integers(-10 ** 9, 10 ** 9, int(offs[-1]))
    elem_valid = rng.random(len(values)) < 0.9
    lists = _lists(offs, values, valid=valid, elem_valid=elem_valid)
    port, ref = _edge_siblings(case, n, rng)
    names = list(port)
    port["arr"], ref["arr"] = lists, _pa_list(lists)
    settings = {"spark.rapids.tpu.sql.batchSizeRows": EDGE_CHUNK}
    got = _both(port, ref, lambda df, F: df.explode(
        "arr", out_name="v", outer=outer), settings)
    want = _numpy_rows(names, port, lens, valid, values, elem_valid, outer)
    _same(got, want)
    out_rows = np.where(valid, lens, 0)
    if outer:
        out_rows = np.maximum(out_rows, 1)
    assert len(got) == int(out_rows.sum()) > EDGE_CHUNK


@pytest.mark.parametrize("shape", ["long_list", "empty_and_null_runs",
                                   "chunk_inside_list"])
def test_plain_explode_tile_edges_equal_numpy(shape):
    """``explode_rows`` (the kernel's contract, through its plain version)
    over chunks of a tile and a few rows, 17 siblings of 1, 2, 4 and 8
    bytes, with and without validity, and wide limbs, against numpy."""
    rng = np.random.default_rng(2048)
    lens, valid = _edge_lists(shape, rng)
    lens = np.where(valid, lens, 0)
    n = len(lens)
    kinds = (np.int8, np.int16, np.int32, np.int64, np.float32, np.float64,
             bool)
    cols = [(rng.integers(0, 99, n).astype(kinds[c % len(kinds)]),
             rng.random(n) < 0.8 if c % 2 else None) for c in range(16)]
    cols.append((rng.integers(-9, 9, (n, 2)), rng.random(n) < 0.5))
    t = torch.from_numpy
    tcols = [(t(d), None if v is None else t(v)) for d, v in cols]
    for outer in (False, True):
        out_lens = np.maximum(lens, 1) if outer else lens
        starts = np.concatenate([[0], np.cumsum(out_lens)])
        eoffs = np.concatenate([[0], np.cumsum(lens)]) if outer else None
        values = rng.standard_normal(int(lens.sum()))
        vv = rng.random(len(values)) < 0.9
        total, chunk = int(starts[-1]), 2_048 + 5
        for lo in range(0, total, chunk):
            m = min(chunk, total - lo)
            (d, v), moved = generate.explode_rows(
                t(starts), None if eoffs is None else t(eoffs), lo, m,
                t(values), t(vv), tcols, True)
            wd, wv, wcols = _numpy_explode(starts, eoffs, values, vv, cols,
                                           lo, m)
            assert np.array_equal(d.numpy(), wd)
            assert np.array_equal(v.numpy(), wv)
            assert len(moved) == len(cols)
            for (gd, gv), (xd, xv) in zip(moved, wcols):
                assert gd.dtype == torch.from_numpy(xd).dtype
                assert np.array_equal(gd.numpy(), xd)
                assert (gv is None) == (xv is None)
                assert gv is None or np.array_equal(gv.numpy(), xv)
