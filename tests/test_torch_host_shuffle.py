"""shuffle.mode=HOST in the port (``parallel/host_shuffle.py``,
``plan/exchange_exec.py _execute_host``): partition slices leave the
device after one fetch of their partition ids, a writer pool appends them
as compressed, checksummed frames (the reference's ``<cQQI>`` header) to
one file per partition, and each partition comes back, crc checked on
every decode, re-uploaded and concatenated.

Queries run through both packages on the same numpy data: rows (ints,
strings and dates exactly, float64 within rel 1e-9) and blocking fetches
(the port's at most the reference's).  The reference's HOST transport
writes Arrow IPC and cannot carry the dictionary codes of a string group
key (``to_arrow`` raises ArrowTypeError on Q1 and Q10); those queries are
held to the numpy oracle and to the reference's fetches for the same plan
on its single-process transport.
"""

import os
import time
import zlib

import numpy as np
import pytest

import spark_rapids_tpu as jsrt
from spark_rapids_tpu.models import tpch_suite
from spark_rapids_tpu.sql import functions as JF
from spark_rapids_tpu.utils.metrics import QueryStats as JStats
import spark_rapids_tpu_torch as tsrt
from spark_rapids_tpu_torch.models import tpch
from spark_rapids_tpu_torch.parallel import host_shuffle as hs
from spark_rapids_tpu_torch.sql import functions as TF
from spark_rapids_tpu_torch.utils.metrics import QueryStats as TStats

REL = 1e-9


def _host(tmp_path, **extra):
    return {"spark.rapids.tpu.shuffle.mode": "HOST",
            "spark.rapids.tpu.memory.spill.dir": str(tmp_path / "spill"),
            **extra}


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


def _slice(n, start=0, strings=True):
    vals = np.array([f"s{i}" if i % 7 else None for i in range(start,
                                                               start + n)],
                    dtype=object)
    cols = [("numeric", np.arange(start, start + n, dtype=np.int64), None),
            ("numeric", np.linspace(0, 1, n), np.arange(n) % 3 > 0),
            ("codes", (np.arange(n) % 4).astype(np.int32), None)]
    if strings:
        cols.append(("strings", vals, np.array([v is not None
                                                 for v in vals])))
    return hs.HostSlice(cols, n)


def _same_slice(a: hs.HostSlice, b: hs.HostSlice):
    assert a.num_rows == b.num_rows
    for (ka, da, va), (kb, db, vb) in zip(a.columns, b.columns):
        assert ka == kb
        assert list(da) == list(db)
        assert (va is None) == (vb is None)
        if va is not None:
            assert np.array_equal(va, vb)


# ---------------------------------------------------------------------------------
# Frames
# ---------------------------------------------------------------------------------

@pytest.mark.parametrize("compress", [True, False])
def test_frame_roundtrip(tmp_path, compress):
    sh = hs.HostShuffle(3, str(tmp_path), num_threads=2, compress=compress)
    try:
        a, b = _slice(300), _slice(1, start=300)
        sh.write_partition(0, a)
        sh.write_partition(2, b)
        sh.write_partition(0, b)
        sh.write_partition(1, _slice(0))     # an empty slice writes nothing
        sh.finish_writes()
        p0 = list(sh.read_partition(0))
        assert [s.num_rows for s in p0] == [300, 1]
        _same_slice(p0[0], a)
        _same_slice(p0[1], b)
        assert list(sh.read_partition(1)) == []
        assert [s.num_rows for s in sh.read_partition(2)] == [1]
        assert sh.bytes_read == sh.bytes_written > 0
        assert sh.part_rows == [301, 0, 1]
    finally:
        sh.close()
    assert not os.path.exists(sh.dir)


def test_frame_header_is_the_reference_layout():
    """``<cQQI>``: codec flag, stored length, raw length, crc32 of the
    stored bytes."""
    payload = hs.encode_columns(_slice(50))
    data = hs.frame(payload, compress=True)
    flag, clen, rlen, crc = hs._FRAME.unpack_from(data, 0)
    stored = data[hs._FRAME.size:]
    assert flag == b"Z" and clen == len(stored) and rlen == len(payload)
    assert crc == zlib.crc32(stored) & 0xFFFFFFFF
    assert zlib.decompress(stored) == payload
    # a frame that does not shrink is stored raw
    raw = hs.frame(os.urandom(64), compress=True)
    assert hs._FRAME.unpack_from(raw, 0)[0] == b"R"


def test_corrupted_frame_raises_on_decode(tmp_path):
    sh = hs.HostShuffle(1, str(tmp_path), num_threads=1)
    try:
        sh.write_partition(0, _slice(200))
        sh.finish_writes()
        path = sh._paths[0]
        data = bytearray(open(path, "rb").read())
        data[hs._FRAME.size + 7] ^= 0x40      # one bit of the stored bytes
        open(path, "wb").write(bytes(data))
        with pytest.raises(hs.FrameCorrupt, match="crc32"):
            list(sh.read_partition(0))
        with pytest.raises(hs.FrameCorrupt):
            list(hs.iter_frames(bytes(data)))
        with pytest.raises(hs.FrameCorrupt):
            hs.verify_stream(bytes(data))
    finally:
        sh.close()


def test_dictionary_written_once_per_shuffle(tmp_path):
    """A string column's codes travel in the partition frames and its
    dictionary once, in a checked frame file of its own."""
    sh = hs.HostShuffle(2, str(tmp_path), num_threads=2)
    try:
        values = np.array(["né", "", "x" * 300, "b"], dtype=object)
        codes = hs.HostSlice([("codes", np.array([3, 0, 1, 2], np.int32),
                               None)], 4)
        sh.write_partition(1, codes)
        sh.finish_writes()
        sh.write_dictionary(0, values)
        assert list(sh.read_dictionary(0)) == list(values)
        assert sh.read_dictionary(0, decode=False) is None
        (got,) = list(sh.read_partition(1))
        assert got.columns[0][0] == "codes"
        assert got.columns[0][1].tolist() == [3, 0, 1, 2]
        path = sh._dict_paths[0]
        data = bytearray(open(path, "rb").read())
        data[-1] ^= 1
        open(path, "wb").write(bytes(data))
        with pytest.raises(hs.FrameCorrupt):
            sh.read_dictionary(0)
    finally:
        sh.close()
    assert not os.path.exists(sh.dir)


def test_iter_frames_and_verify_stream():
    data = hs.frame(hs.encode_columns(_slice(10))) + hs.frame(
        hs.encode_columns(_slice(5, start=10)), compress=False)
    assert hs.verify_stream(data) is data
    got = list(hs.iter_frames(data))
    assert [s.num_rows for s in got] == [10, 5]
    _same_slice(got[1], _slice(5, start=10))


def test_gc_orphan_frames(tmp_path):
    old = tmp_path / "shuffle-old"
    new = tmp_path / "shuffle-new"
    other = tmp_path / "keep"
    for d in (old, new, other):
        d.mkdir()
        (d / "part-00000.bin").write_bytes(b"x")
    past = time.time() - 3600
    os.utime(old / "part-00000.bin", (past, past))
    os.utime(old, (past, past))
    assert hs.gc_orphan_frames(str(tmp_path), 60_000) == 1
    assert not old.exists() and new.exists() and other.exists()
    assert hs.gc_orphan_frames(str(tmp_path), 0) == 0


# ---------------------------------------------------------------------------------
# Queries through the HOST transport
# ---------------------------------------------------------------------------------

@pytest.fixture(scope="module")
def db():
    return tpch.gen_db_arrays(0.01)


@pytest.mark.parametrize("query", ["q3", "q18"])
def test_tpch_host_matches_reference(db, tmp_path, query):
    settings = _host(tmp_path, **{"spark.rapids.tpu.sql.batchSizeRows":
                                  16384})
    names = tpch.SUITE_QUERIES[query]
    jsess = jsrt.Session(settings)
    with JStats.scoped() as js:
        want = getattr(tpch_suite, f"run_{query}")(
            {t: jsess.create_dataframe(db[t]) for t in names})
    sess = tsrt.Session(settings, device="cpu")
    with TStats.scoped() as ts:
        got = tpch.run_query(query, {t: sess.create_dataframe(db[t])
                                     for t in names})
    _assert_rows_equal(got, want, ordered=True)
    _assert_rows_equal(got, tpch.query_oracle(query, db), ordered=True)
    assert ts.blocking_fetches <= js.blocking_fetches
    assert ts.shuffle_bytes_written == ts.shuffle_bytes_read > 0
    assert not os.listdir(tmp_path / "spill")   # every shuffle cleaned up


@pytest.mark.parametrize("query", ["q1", "q10"])
def test_tpch_host_with_string_keys(db, tmp_path, query):
    """String group keys cross the HOST exchange as dictionary codes with
    their dictionary; the reference's Arrow frames cannot carry them."""
    base = {"spark.rapids.tpu.sql.batchSizeRows": 16384}
    names = tpch.SUITE_QUERIES[query]
    jsess = jsrt.Session(_host(tmp_path, **base))
    with pytest.raises(Exception, match="string"):
        getattr(tpch_suite, f"run_{query}")(
            {t: jsess.create_dataframe(db[t]) for t in names})
    jsess = jsrt.Session({**base, "spark.rapids.tpu.sql.agg."
                          "singleProcessComplete": "false"})
    with JStats.scoped() as js:
        getattr(tpch_suite, f"run_{query}")(
            {t: jsess.create_dataframe(db[t]) for t in names})
    sess = tsrt.Session(_host(tmp_path, **base), device="cpu")
    with TStats.scoped() as ts:
        got = tpch.run_query(query, {t: sess.create_dataframe(db[t])
                                     for t in names})
    _assert_rows_equal(got, tpch.query_oracle(query, db), ordered=True)
    assert ts.blocking_fetches <= js.blocking_fetches
    assert ts.shuffle_bytes_written == ts.shuffle_bytes_read > 0


def test_grouped_agg_same_result_both_modes(tmp_path):
    rng = np.random.default_rng(7)
    n = 2000
    k = rng.integers(0, 50, n).astype(object)
    k[rng.random(n) < 0.1] = None
    t = {"k": k, "v": rng.uniform(0, 1, n)}
    rows = []
    for settings in (_host(tmp_path), {}):
        sess = tsrt.Session(settings, device="cpu")
        rows.append(sess.create_dataframe(t).group_by("k").agg(
            TF.sum(TF.col("v")).alias("s")).collect())
    _assert_rows_equal(*rows)


def test_join_through_host_shuffle(tmp_path):
    """A shuffled join with both sides through frame files."""
    settings = _host(tmp_path, **{
        "spark.rapids.tpu.sql.autoBroadcastJoinThreshold": -1})
    out = []
    for pkg, F in ((tsrt, TF), (jsrt, JF)):
        sess = pkg.Session(settings, **({"device": "cpu"} if pkg is tsrt
                                        else {}))
        a = sess.create_dataframe({"k": np.arange(100),
                                   "x": np.arange(100) * 1.0})
        b = sess.create_dataframe({"k2": np.arange(0, 100, 2),
                                   "y": np.arange(0, 100, 2) * 10.0})
        out.append(a.join(b, [("k", "k2")]).select("k", "x", "y").collect())
    _assert_rows_equal(*out)
    assert len(out[0]) == 50


def test_host_shuffle_with_string_values(tmp_path):
    """Host string columns ride the frames as offsets and bytes."""
    sess = tsrt.Session(_host(tmp_path, **{
        "spark.rapids.tpu.sql.autoBroadcastJoinThreshold": -1}),
        device="cpu")
    a = sess.create_dataframe({"k": np.array([1, 2, 1, 3]),
                               "s": np.array(["a", "b", None, "c"],
                                             dtype=object)})
    b = sess.create_dataframe({"k2": np.array([1, 2, 3]),
                               "t": np.array(["x", None, "z"],
                                             dtype=object)})
    got = a.join(b, [("k", "k2")]).select("k", "s", "t").collect()
    assert sorted(got, key=_key) == sorted(
        [(1, "a", "x"), (1, None, "x"), (2, "b", None), (3, "c", "z")],
        key=_key)
