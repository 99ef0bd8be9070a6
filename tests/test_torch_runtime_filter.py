"""Runtime join filters (row 15) in the port against the reference.

The reference's ``TestDPP`` and ``TestSmjRuntimeFilter`` cases
(``tests/test_subquery_dpp.py:109``, ``:234``) run through both Sessions
over the same parquet files: the same results, the same runtime
predicates installed on each scan, the same scan rows; with
``dpp.enabled`` false both scan more rows.  The plain ``key_stats``
(``ops/runtime_filter.py``) is held to numpy and to the stats vector the
reference's dense prefetch program fetched for the same build, the
``dpp.maxInKeys`` boundary included."""

import datetime

import numpy as np
import pytest
import torch

pa = pytest.importorskip("pyarrow")
pq = pytest.importorskip("pyarrow.parquet")

import spark_rapids_tpu as jsrt  # noqa: E402
from spark_rapids_tpu.plan.physical import CollectExec as JCollect  # noqa: E402
from spark_rapids_tpu.plan.physical import ExecContext as JContext  # noqa: E402
from spark_rapids_tpu.sql import functions as JF  # noqa: E402
import spark_rapids_tpu_torch as tsrt  # noqa: E402
from spark_rapids_tpu_torch.ops import runtime_filter as rf  # noqa: E402
from spark_rapids_tpu_torch.plan.overrides import apply_overrides  # noqa: E402
from spark_rapids_tpu_torch.plan.physical import CollectExec as TCollect  # noqa: E402
from spark_rapids_tpu_torch.plan.physical import ExecContext as TContext  # noqa: E402
from spark_rapids_tpu_torch.sql import functions as TF  # noqa: E402

BASE = datetime.date(1995, 1, 1)
REL = 1e-9


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The reference tests' tables: a 50,000-row fact table in 2,000-row
    groups keyed 0..399, its 400-row dimension (d_cat = key mod 7), a
    20,000-row date-keyed fact table with its 30-day dimension, and the
    40,000-row right side of the sort-merge join."""
    d = tmp_path_factory.mktemp("dpp")
    rng = np.random.default_rng(11)
    out = {}

    def write(name, table, **kw):
        out[name] = str(d / f"{name}.parquet")
        pq.write_table(table, out[name], **kw)
    write("fact", pa.table({"f_key": pa.array(rng.integers(0, 400, 50_000)),
                            "f_val": pa.array(rng.uniform(0, 100, 50_000))}),
          row_group_size=2000)
    write("dim", pa.table({
        "d_key": pa.array(np.arange(400, dtype=np.int64)),
        "d_cat": pa.array((np.arange(400) % 7).astype(np.int64))}))
    days = rng.integers(0, 1000, 20_000)
    write("factd", pa.table({
        "f_date": pa.array([BASE + datetime.timedelta(days=int(x))
                            for x in days], type=pa.date32()),
        "f_val": pa.array(rng.uniform(0, 10, 20_000))}), row_group_size=2000)
    write("dimd", pa.table({"d_date": pa.array(
        [BASE + datetime.timedelta(days=int(x)) for x in range(100, 130)],
        type=pa.date32())}))
    write("right", pa.table({
        "rk": pa.array(rng.integers(0, 1000, 40_000)),
        "rv": pa.array(rng.uniform(0, 1, 40_000))}), row_group_size=2000)
    out["left"] = {"lk": rng.integers(100, 120, 500),
                   "lv": rng.uniform(0, 1, 500)}
    return out


def _dpp_query(F, sess, files, cat):
    fact, dim = sess.read_parquet(files["fact"]), sess.read_parquet(
        files["dim"])
    return (fact.join(dim.where(F.col("d_cat") == cat),
                      on=[("f_key", "d_key")])
            .agg(F.sum(F.col("f_val")).alias("s"),
                 F.count_star().alias("c")))


def _date_query(F, sess, files, _):
    return (sess.read_parquet(files["factd"])
            .join(sess.read_parquet(files["dimd"]),
                  on=[("f_date", "d_date")])
            .agg(F.sum(F.col("f_val")).alias("s")))


def _semi_query(F, sess, files, cat):
    dim = sess.read_parquet(files["dim"]).where(F.col("d_cat") <= cat)
    return (sess.read_parquet(files["fact"])
            .join(dim, on=[("f_key", "d_key")], how="semi")
            .agg(F.count_star().alias("c")))


def _smj_query(F, sess, files, _):
    ldf = sess.create_dataframe(files["left"])
    return (ldf.join(sess.read_parquet(files["right"]), on=[("lk", "rk")])
            .agg(F.sum(F.col("rv")).alias("s"), F.count_star().alias("c")))


def _walk(node):
    yield node
    for c in getattr(node, "children", ()):
        yield from _walk(c)


def _run_reference(jsess, df):
    phys = jsess._plan_physical(df._plan)
    ctx = JContext(jsess._tpu_conf(), device=jsess.device)
    rows = JCollect(phys).collect_arrow(ctx).to_pylist()
    return [tuple(r.values()) for r in rows], phys, ctx


def _run_port(tsess, df):
    phys = apply_overrides(df._plan, tsess.conf())
    ctx = TContext(tsess.conf(), tsess.device)
    return TCollect(phys).collect_rows(ctx), phys, ctx


def _scans(phys):
    """(scan description, runtime predicates) of every file scan."""
    out = []
    for node in _walk(phys):
        if type(node).__name__ == "ScanExec":
            src = getattr(node, "source", None) or getattr(
                node, "_source_factory", None)
            if hasattr(src, "with_pushdown"):
                preds = node.runtime_predicates
                out.append((src.describe(), preds if callable(preds)
                             else preds or []))
    return sorted(out, key=repr)


def _scan_rows(ctx):
    return sorted(int(m.values.get("numOutputRows", 0))
                  for op, m in ctx.metrics.items()
                  if op.startswith("ScanExec"))


def _close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            if isinstance(b, float):
                assert abs(a - b) <= REL * max(abs(b), 1.0)
            else:
                assert a == b


CASES = {
    "in list": (_dpp_query, 3, {}),
    "empty build": (_dpp_query, 99, {}),
    "date keys": (_date_query, None, {}),
    "semi join": (_semi_query, 2, {}),
    "range over maxInKeys": (_dpp_query, 3,
                             {"spark.rapids.tpu.sql.dpp.maxInKeys": 56}),
    # d_cat == 3 keeps 57 keys
    "in list at maxInKeys": (_dpp_query, 3,
                             {"spark.rapids.tpu.sql.dpp.maxInKeys": 57}),
    "smj over exchanges": (_smj_query, None, {
        "spark.rapids.tpu.sql.autoBroadcastJoinThreshold": -1}),
    "smj sides whole": (_smj_query, None, {
        "spark.rapids.tpu.sql.autoBroadcastJoinThreshold": -1,
        "spark.rapids.tpu.sql.exchange.enabled": False}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_runtime_filters_match_reference(files, case):
    make, arg, extra = CASES[case]
    settings = dict({"spark.rapids.tpu.sql.batchSizeRows": 8192,
                     "spark.rapids.tpu.join.denseMinProbeRows": 0}, **extra)
    jsess = jsrt.Session(settings)
    tsess = tsrt.Session(settings, device="cpu")
    jrows, jphys, jctx = _run_reference(jsess, make(JF, jsess, files, arg))
    trows, tphys, tctx = _run_port(tsess, make(TF, tsess, files, arg))
    _close(trows, jrows)
    if case == "empty build":
        # the port never opens the probe side of an empty inner build (its
        # predicates stay unresolved); the reference reads it under its
        # empty IN list, which keeps no row group
        assert [p for _, p in _scans(jphys)] == [[], [("f_key", "in", [])]]
        assert [callable(p) for _, p in _scans(tphys)] == [False, True]
        assert [r for r in _scan_rows(jctx) if r] == \
            [r for r in _scan_rows(tctx) if r]
        return
    assert _scans(tphys) == _scans(jphys)
    assert _scan_rows(tctx) == _scan_rows(jctx)
    pushed = [p for _, preds in _scans(tphys) for p in preds]
    if case in ("in list", "date keys", "semi join",
                "in list at maxInKeys", "smj sides whole"):
        assert pushed and pushed[0][1] == "in"
    elif case == "range over maxInKeys":
        assert [op for _, op, _ in pushed] == [">=", "<="]


def test_dpp_off_scans_more_rows(files):
    """With dpp.enabled false neither package pushes anything, and both
    scan more rows."""
    rows = {}
    for dpp in (True, False):
        settings = {"spark.rapids.tpu.sql.dpp.enabled": dpp,
                    "spark.rapids.tpu.join.denseMinProbeRows": 0}
        tsess = tsrt.Session(settings, device="cpu")
        jsess = jsrt.Session(settings)
        _, _, tctx = _run_port(tsess, _dpp_query(TF, tsess, files, 3))
        _, _, jctx = _run_reference(jsess, _dpp_query(JF, jsess, files, 3))
        assert _scan_rows(tctx) == _scan_rows(jctx)
        rows[dpp] = sum(_scan_rows(tctx))
    assert rows[True] < rows[False]


def test_in_memory_scans_run_no_key_stats(files, monkeypatch):
    """A join whose probe side is an in-memory table computes no runtime
    filter stats."""
    calls = []
    monkeypatch.setattr(rf, "key_stats",
                        lambda *a, **k: calls.append(1))
    tsess = tsrt.Session({"spark.rapids.tpu.join.denseMinProbeRows": 0},
                         device="cpu")
    fact = tsess.create_dataframe({k: np.asarray(v) for k, v in pq.read_table(
        files["fact"]).to_pydict().items()})
    dim = tsess.read_parquet(files["dim"]).where(TF.col("d_cat") == 3)
    fact.join(dim, on=[("f_key", "d_key")]).agg(
        TF.count_star().alias("c")).collect()
    assert calls == []


# ---------------------------------------------------------------------------------
# key_stats
# ---------------------------------------------------------------------------------

def _numpy_stats(key, ok, vcap):
    big = rf.BIG
    live = key[ok].astype(np.int64)
    s = np.sort(np.where(ok, key.astype(np.int64), big))
    dup = int(((s[1:] == s[:-1]) & (s[1:] != big)).sum())
    uniq = np.unique(live[live != big])
    vals = np.full(vcap, big, dtype=np.int64)
    vals[:min(vcap, len(uniq))] = uniq[:vcap]
    head = [int(live.min()) if len(live) else big,
            int(live.max()) if len(live) else -big, len(live), dup,
            len(uniq)]
    return np.concatenate([np.array(head, dtype=np.int64), vals])


KEY_CASES = {
    "empty": (np.zeros(0, np.int64), None, None),
    "all null": (np.arange(50, dtype=np.int64), np.zeros(50, bool), None),
    "one key": (np.array([-7], np.int64), None, None),
    "10,000 distinct": (np.repeat(np.arange(10_000, dtype=np.int64), 2),
                        None, None),
    "10,001 distinct": (np.arange(10_001, dtype=np.int64)[::-1].copy(),
                        None, None),
    "int64 extremes": (np.array([2**63 - 1, -2**63, 0, 2**63 - 1, -1,
                                 2**63 - 2], np.int64), None, None),
    "int32 with masks": (np.random.default_rng(1).integers(
        -2**31, 2**31 - 1, 5000, dtype=np.int32),
        np.random.default_rng(2).random(5000) < .8,
        np.random.default_rng(3).random(5000) < .5),
}


def _edge_keys(n_valid, n_rows, seed, lo=0, hi=1 << 40):
    """``n_rows`` keys in [lo, hi), exactly ``n_valid`` of them live and
    valid: the edges of the kernel's one-block path."""
    rng = np.random.default_rng(seed)
    key = rng.integers(lo, hi, n_rows, dtype=np.int64)
    ok = np.zeros(n_rows, bool)
    ok[rng.choice(n_rows, n_valid, replace=False)] = True
    valid = ok | (rng.random(n_rows) < .5)
    return key, valid, ok | ~valid


# the kernel sorts at most SMALL_KEYS valid keys in one block, more by
# radix passes over the bytes of their range: the plain version is pinned
# on both sides of that edge, over a range that spans all of int64, and on
# a build whose every row is live
KEY_CASES.update({
    "single-block limit": _edge_keys(rf.SMALL_KEYS, 40_000, 4, -500, 9000),
    "one past the limit": _edge_keys(rf.SMALL_KEYS + 1, 40_000, 5),
    "full int64 range": (np.concatenate([
        np.array([2**63 - 1, -2**63, -2**63, 2**63 - 1], np.int64),
        np.random.default_rng(6).integers(-2**63, 2**63 - 1, 30_000,
                                          dtype=np.int64)]), None, None),
    "all rows live": (np.random.default_rng(7).integers(
        0, 60_000, 200_000, dtype=np.int64), None, None),
})


@pytest.mark.parametrize("case", list(KEY_CASES))
def test_key_stats_plain_matches_numpy(case):
    key, valid, active = KEY_CASES[case]
    vcap = rf.in_list_capacity(10_000)
    ok = np.ones(len(key), bool)
    for m in (valid, active):
        if m is not None:
            ok &= m
    got = rf.key_stats(torch.from_numpy(key),
                       None if valid is None else torch.from_numpy(valid),
                       None if active is None else torch.from_numpy(active),
                       vcap)
    np.testing.assert_array_equal(got.numpy(), _numpy_stats(key, ok, vcap))


@pytest.mark.parametrize("cat", [3, 99])
def test_key_stats_equal_the_reference_stats_vector(files, cat,
                                                    monkeypatch):
    """The stats and the distinct prefix the reference's dense prefetch
    program fetched for the dimension build (read where the reference
    resolves it, ``BroadcastJoinExec._pending_host``) equal the plain
    key_stats of the same keys."""
    from spark_rapids_tpu.plan.join_exec import BroadcastJoinExec
    hosts = []
    resolve = BroadcastJoinExec._pending_host

    def spy(self, pending):
        out = resolve(self, pending)
        hosts.append(np.asarray(out))
        return out
    monkeypatch.setattr(BroadcastJoinExec, "_pending_host", spy)
    jsess = jsrt.Session({"spark.rapids.tpu.join.denseMinProbeRows": 0})
    _run_reference(jsess, _dpp_query(JF, jsess, files, cat))
    assert hosts
    ref = hosts[0]
    dim = pq.read_table(files["dim"]).to_pydict()
    keys = np.array([k for k, c in zip(dim["d_key"], dim["d_cat"])
                     if c == cat], dtype=np.int64)
    got = rf.key_stats(torch.from_numpy(keys), None, None,
                       len(ref) - 4).numpy()
    np.testing.assert_array_equal(got[:4], ref[:4])
    np.testing.assert_array_equal(got[rf.HEADER:], ref[4:])


def test_in_list_capacity_is_the_reference_bucket():
    assert rf.in_list_capacity(10_000) == 16_384
    assert rf.in_list_capacity(16_383) == 16_384
    assert rf.in_list_capacity(16_384) == 32_768
    assert rf.in_list_capacity(3) == 1024
