"""The port's numpy parquet reader and writer against pyarrow.

The reader (``spark_rapids_tpu_torch/io/parquet.py`` over ``io/thrift.py``
and ``io/pqformat.py``) must return pyarrow's values on files pyarrow
writes: every supported type, nulls, all-null chunks, dictionary pages that
fall back to PLAIN pages inside a chunk, data pages v1 and v2, SNAPPY,
GZIP and UNCOMPRESSED, several row groups and files, hive partition
directories, empty files and non-ASCII strings; in the batches pyarrow's
``iter_batches`` cuts; with pyarrow's footer statistics.  The RLE /
bit-packed hybrid is held to pyarrow's under hypothesis.  pyarrow must
read the port's files back exactly, statistics included.  A codec or type
the reader does not support raises, naming ROADMAP item 9."""

import datetime

import numpy as np
import pytest

pa = pytest.importorskip("pyarrow")
pq = pytest.importorskip("pyarrow.parquet")
from hypothesis import given, settings, strategies as st  # noqa: E402

from spark_rapids_tpu.io.parquet import ParquetSource as JParquetSource  # noqa: E402
from spark_rapids_tpu_torch.batch import HostStringColumn  # noqa: E402
from spark_rapids_tpu_torch.io import pqformat  # noqa: E402
from spark_rapids_tpu_torch.io.parquet import (ParquetSource,  # noqa: E402
                                               open_file, parquet_schema)
from spark_rapids_tpu_torch.io.writers import (ParquetWriter,  # noqa: E402
                                               write_table)
import spark_rapids_tpu_torch as tsrt  # noqa: E402
from spark_rapids_tpu_torch.sql import functions as TF  # noqa: E402

N = 3000
EPOCH = datetime.date(1970, 1, 1)


def _nulls(rng, values, frac=0.1):
    gone = rng.random(len(values)) < frac
    return [None if g else v for v, g in zip(values, gone)]


def _table(seed=0, n=N):
    rng = np.random.default_rng(seed)
    day = datetime.date(1990, 1, 1)
    return pa.table({
        "i64": pa.array(_nulls(rng, rng.integers(-100, 100, n).tolist()),
                        pa.int64()),
        "i32": pa.array(_nulls(rng, rng.integers(-10**6, 10**6, n).tolist()),
                        pa.int32()),
        "i16": pa.array(rng.integers(-100, 100, n).tolist(), pa.int16()),
        "i8": pa.array(rng.integers(-100, 100, n).tolist(), pa.int8()),
        "f64": pa.array(_nulls(rng, rng.random(n).tolist()), pa.float64()),
        "f32": pa.array(rng.random(n).astype(np.float32)),
        "b": pa.array(_nulls(rng, (rng.random(n) < .5).tolist()),
                      pa.bool_()),
        "d": pa.array(_nulls(rng, [day + datetime.timedelta(days=int(x))
                                   for x in rng.integers(0, 9000, n)]),
                      pa.date32()),
        "s": pa.array(_nulls(rng, [f"clé-{x}-ü" for x in
                                   rng.integers(0, 60, n)])),
        "u": pa.array([f"name#{x:09d}" for x in rng.permutation(n)]),
        "none": pa.array([None] * n, pa.int64()),
        "ts": pa.array(rng.integers(0, 10**15, n), pa.timestamp("us")),
    })


def _python(col, dtype_name):
    """A port host column of one batch as Python values (None for null)."""
    if isinstance(col, HostStringColumn):
        vals = list(col.data)
        ok = [True] * len(vals) if col.valid is None else col.valid.tolist()
        return [v if k else None for v, k in zip(vals, ok)]
    data, valid = col
    ok = [True] * len(data) if valid is None else valid.tolist()
    out = []
    for v, k in zip(data.tolist(), ok):
        if not k:
            out.append(None)
        elif dtype_name == "d":
            out.append(EPOCH + datetime.timedelta(days=v))
        else:
            out.append(v)
    return out


def _read_port(path, batch_rows=1700, **kw):
    return list(ParquetSource(path, batch_rows=batch_rows, num_threads=0,
                              **kw)())


def _assert_equal_to_pyarrow(path, batch_rows=1700):
    ref = pq.read_table(path)
    tables = _read_port(path, batch_rows)
    want_sizes = [b.num_rows for b in pq.ParquetFile(path).iter_batches(
        batch_size=batch_rows)]
    assert [t.num_rows for t in tables] == want_sizes
    for i, f in enumerate(parquet_schema([path])):
        got = []
        for t in tables:
            got += _python(t.columns[i], f.name)
        col = ref.column(f.name)
        if f.name == "ts":
            col = col.cast(pa.int64())
        want = col.to_pylist()
        if f.name == "f32":
            want = [None if x is None else float(np.float32(x))
                    for x in want]
        assert got == want, f.name


WRITE_OPTIONS = {
    "snappy dictionary v1": {},
    "gzip": {"compression": "gzip"},
    "uncompressed v2": {"compression": "none", "data_page_version": "2.0"},
    "snappy v2 dictionary fallback": {
        "compression": "snappy", "data_page_version": "2.0",
        "dictionary_pagesize_limit": 256},
    "plain snappy": {"use_dictionary": False, "compression": "snappy"},
    "dictionary fallback v1": {"dictionary_pagesize_limit": 128,
                               "compression": "none"},
}


@pytest.mark.parametrize("option", list(WRITE_OPTIONS))
def test_reader_matches_pyarrow(tmp_path, option):
    path = str(tmp_path / "t.parquet")
    pq.write_table(_table(), path, row_group_size=1300, data_page_size=2000,
                   **WRITE_OPTIONS[option])
    _assert_equal_to_pyarrow(path)


def test_string_columns_carry_their_distinct_values(tmp_path):
    """A string column's distinct live values (ascending) and each live
    row's index into them come from the dictionary pages, and agree with
    the rows."""
    path = str(tmp_path / "t.parquet")
    pq.write_table(_table(3), path, row_group_size=700,
                   dictionary_pagesize_limit=300)
    for t in _read_port(path, 1000):
        for c in t.columns:
            if isinstance(c, HostStringColumn):
                uniq, inverse = c._distinct
                live = c.data if c.valid is None else c.data[c.valid]
                assert list(uniq) == sorted(set(live))
                assert (uniq[inverse] == live).all()


def test_statistics_match_pyarrow(tmp_path):
    path = str(tmp_path / "t.parquet")
    pq.write_table(_table(1), path, row_group_size=1000)
    mine, ref = open_file(path), pq.ParquetFile(path).metadata
    for rg in range(ref.num_row_groups):
        for ci in range(ref.num_columns):
            a, b = mine.statistics(rg, ci), ref.row_group(rg).column(
                ci).statistics
            assert a.has_min_max == b.has_min_max
            assert a.null_count == b.null_count
            if b.has_min_max:
                assert (a.min, a.max) == (b.min, b.max)
                assert type(a.min) is type(b.min)


def test_all_null_chunk_and_empty_file(tmp_path):
    path = str(tmp_path / "nulls.parquet")
    pq.write_table(pa.table({"x": pa.array([None] * 10, pa.float64()),
                             "s": pa.array([None] * 10, pa.string())}), path)
    _assert_equal_to_pyarrow(path)
    empty = str(tmp_path / "empty.parquet")
    pq.write_table(pa.table({"x": pa.array([], pa.int64()),
                             "s": pa.array([], pa.string())}), empty)
    assert _read_port(empty) == []
    assert parquet_schema([empty]).names() == ["x", "s"]


def test_several_files_and_hive_partitions_match_reference(tmp_path):
    """A directory of hive partitions (``p=<int>/q=<str>``, one null
    partition) through both packages' sources: the same columns,
    partition columns appended, the same rows."""
    rng = np.random.default_rng(5)
    for p in (1, 2, None):
        for q in ("x", "y"):
            d = tmp_path / f"p={p if p is not None else '__HIVE_DEFAULT_PARTITION__'}" / f"q={q}"
            d.mkdir(parents=True)
            n = int(rng.integers(50, 200))
            pq.write_table(pa.table({
                "k": pa.array(rng.integers(0, 9, n)),
                "v": pa.array(rng.random(n))}), str(d / "part-0.parquet"),
                row_group_size=60)
    root = str(tmp_path)
    mine = ParquetSource(root, batch_rows=100, num_threads=2)
    ref = JParquetSource(root, batch_rows=100, num_threads=0)
    assert [(f.name, str(f.dtype)) for f in mine.schema()] == \
        [(f.name, str(f.dtype)) for f in ref.schema()]
    want = pa.concat_tables(list(ref())).to_pylist()
    got = []
    names = mine.schema().names()
    for t in mine():
        cols = [_python(c, n) for c, n in zip(t.columns, names)]
        got += [dict(zip(names, row)) for row in zip(*cols)]
    assert got == want


def test_port_writer_read_back_by_pyarrow(tmp_path):
    """Every type the writer writes, nulls included, several row groups,
    UNCOMPRESSED and GZIP: pyarrow reads the values and the statistics
    the port wrote."""
    rng = np.random.default_rng(2)
    n = 2500
    s = np.array([f"k{x}ü" for x in rng.integers(0, 40, n)], dtype=object)
    s[::7] = None
    cols = {
        "a": rng.integers(-5, 5, n), "b": rng.random(n),
        "d": np.datetime64("1992-01-01")
        + rng.integers(0, 900, n).astype("timedelta64[D]"),
        "s": s, "t": rng.integers(0, 100, n).astype(np.int32),
        "bo": rng.random(n) < .3,
        "nul": np.array([None if i % 3 else float(i) for i in range(n)],
                        dtype=object),
        "u": np.array([f"id{x:07d}" for x in range(n)])}
    for codec in ("UNCOMPRESSED", "GZIP"):
        path = str(tmp_path / f"w_{codec}.parquet")
        write_table(cols, path, codec=codec, row_group_size=1000)
        t = pq.read_table(path)
        assert t.num_rows == n
        for name, arr in cols.items():
            want = [x.item() if isinstance(x, np.generic) else x
                    for x in arr]
            if name == "d":
                want = [x.item() for x in arr]
            assert t.column(name).to_pylist() == want, name
        md = pq.ParquetFile(path).metadata
        assert md.num_row_groups == 3
        for rg in range(md.num_row_groups):
            lo, hi = rg * 1000, min(n, (rg + 1) * 1000)
            for ci, name in enumerate(cols):
                stats = md.row_group(rg).column(ci).statistics
                vals = [v for v in t.column(name).to_pylist()[lo:hi]
                        if v is not None]
                assert stats.null_count == (hi - lo) - len(vals)
                if vals:
                    assert stats.has_min_max
                    assert (stats.min, stats.max) == (min(vals), max(vals))
        _assert_equal_to_pyarrow(path, batch_rows=900)


def test_writer_row_groups_follow_write_calls(tmp_path):
    """One row group per ``write_table`` call of at most the group size,
    as pyarrow's ``ParquetWriter`` makes them."""
    path = str(tmp_path / "w.parquet")
    with ParquetWriter(path, row_group_size=1000) as w:
        w.write_table({"x": np.arange(700)})
        w.write_table({"x": np.arange(2500)})
    md = pq.ParquetFile(path).metadata
    assert [md.row_group(i).num_rows for i in range(md.num_row_groups)] == \
        [700, 1000, 1000, 500]


def test_dataframe_write_parquet_round_trip(tmp_path):
    sess = tsrt.Session(device="cpu")
    rng = np.random.default_rng(4)
    df = sess.create_dataframe({
        "k": rng.integers(0, 50, 400),
        "name": np.array([f"n{x}" for x in rng.integers(0, 9, 400)]),
        "d": np.datetime64("1994-01-01")
        + rng.integers(0, 100, 400).astype("timedelta64[D]")})
    q = df.where(TF.col("k") > 10)
    out = str(tmp_path / "out")
    n = q.write.mode("overwrite").parquet(out)
    back = sess.read_parquet(out)
    assert sorted(back.collect()) == sorted(q.collect())
    assert n == len(q.collect())
    with pytest.raises(FileExistsError):
        q.write.parquet(out)


@pytest.mark.parametrize("codec", ["zstd", "brotli", "lz4"])
def test_unsupported_codec_raises(tmp_path, codec):
    path = str(tmp_path / "c.parquet")
    pq.write_table(pa.table({"x": pa.array(np.arange(100))}), path,
                   compression=codec)
    with pytest.raises(NotImplementedError, match="ROADMAP.md item 9"):
        _read_port(path)


def test_unsupported_types_raise(tmp_path):
    import decimal
    path = str(tmp_path / "dec.parquet")
    pq.write_table(pa.table({"x": pa.array([decimal.Decimal("1.25")],
                                           pa.decimal128(5, 2))}), path)
    with pytest.raises(NotImplementedError, match="decimal"):
        parquet_schema([path])
    path = str(tmp_path / "list.parquet")
    pq.write_table(pa.table({"x": pa.array([[1, 2], [3]])}), path)
    with pytest.raises(NotImplementedError, match="ROADMAP.md item 9"):
        parquet_schema([path])


@settings(max_examples=40, deadline=None)
@given(st.lists(st.tuples(st.integers(0, 200), st.integers(1, 40)),
                min_size=1, max_size=30),
       st.booleans())
def test_rle_hybrid_matches_pyarrow(runs, nullable):
    """Dictionary indices in runs of repeated values (pyarrow writes them
    as repeated and bit-packed runs of the hybrid), with and without a
    null every 5th row (definition levels as the hybrid): the port reads
    pyarrow's values."""
    import tempfile
    vals = [v for v, k in runs for _ in range(k)]
    data = [None if nullable and i % 5 == 0 else v
            for i, v in enumerate(vals)]
    with tempfile.TemporaryDirectory() as d:
        path = f"{d}/r.parquet"
        pq.write_table(pa.table({"x": pa.array(data, pa.int64())}), path,
                       compression="none")
        t = _read_port(path, batch_rows=1 << 20)
        got = _python(t[0].columns[0], "x") if t else []
        assert got == data


@settings(max_examples=60, deadline=None)
@given(st.lists(st.integers(0, (1 << 20) - 1), max_size=300),
       st.integers(0, 20))
def test_rle_hybrid_round_trip(values, extra_bits):
    """The writer's hybrid decodes to its input at any sufficient bit
    width."""
    bw = max(int(max(values, default=0)).bit_length(), 1) + extra_bits % 4
    raw = pqformat.rle_hybrid_encode(np.array(values, dtype=np.int64), bw)
    got = pqformat.rle_hybrid(raw, 0, len(raw), bw, len(values))
    assert got.tolist() == values


def test_snappy_decoder_matches_pyarrow_codec():
    rng = np.random.default_rng(9)
    for blob in (b"", b"a" * 1000, bytes(rng.integers(0, 4, 70_000,
                                                        dtype=np.uint8)),
                 "répété ".encode() * 5000):
        packed = pa.compress(blob, codec="snappy", asbytes=True)
        assert pqformat.snappy_decompress(packed) == blob
