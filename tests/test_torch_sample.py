"""The Bernoulli sample of the port (``ops/sample.py``, ``SampleExec``)
against the JAX reference's.  The plain threefry2x32 equals
``jax._src.prng.threefry_2x32`` on Random123's known answers and on random
words; the plain draws equal ``jax.random.uniform(fold_in(PRNGKey(seed),
idx), (capacity,))`` bit for bit for negative, large and ordinary seeds,
several batch indexes and odd and even capacities; ``SampleExec`` keeps
the reference Session's rows with ``batchSizeRows`` = 500 (a filter below
and above the sample, an empty batch in the stream), with no more
blocking fetches; and Q1 over a 1% lineitem sample at SF 0.01 equals the
reference and the numpy oracle over the rows the plain mask keeps (floats
within rel 1e-9: the packages sum in different orders).  The port runs
on the CPU (its kernels' plain versions)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax._src import prng

import spark_rapids_tpu as jsrt
from spark_rapids_tpu.sql import functions as JF
from spark_rapids_tpu.utils.metrics import QueryStats as JStats
import spark_rapids_tpu_torch as tsrt
from spark_rapids_tpu_torch.batch import ColumnBatch, DeviceColumn, Field, \
    Schema
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.models import tpch
from spark_rapids_tpu_torch.ops import sample as S
from spark_rapids_tpu_torch.plan.exec_nodes import SampleExec
from spark_rapids_tpu_torch.plan.physical import ExecContext, TpuExec
from spark_rapids_tpu_torch.config import TpuConf
from spark_rapids_tpu_torch.sql import functions as TF
from spark_rapids_tpu_torch.utils.metrics import QueryStats as TStats

import torch

SEEDS = [0, 42, 2 ** 31 - 1, 2 ** 40 + 7, -1]
KAT = [((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
       ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF),
        (0x1CB996FC, 0xBB002BE7))]
REL = 1e-9


def _jax_threefry(key, x0, x1):
    """JAX's threefry2x32 of word vectors ``x0``, ``x1`` (uint32)."""
    count = jnp.asarray(np.concatenate([x0, x1]).astype(np.uint32))
    out = np.asarray(prng.threefry_2x32(
        jnp.asarray(np.array(key, dtype=np.uint32)), count))
    return out[:len(x0)], out[len(x0):]


@pytest.mark.parametrize("case", range(len(KAT)))
def test_threefry_known_answers(case):
    key, (x0, x1), want = KAT[case]
    j0, j1 = _jax_threefry(key, np.array([x0]), np.array([x1]))
    assert (int(j0[0]), int(j1[0])) == want
    p0, p1 = S.threefry2x32_plain(key, torch.tensor([x0]), torch.tensor([x1]))
    assert (int(p0[0]), int(p1[0])) == want


def test_threefry_plain_equals_jax_on_random_words():
    rng = np.random.default_rng(14)
    for _ in range(3):
        key = tuple(int(k) for k in rng.integers(0, 1 << 32, 2))
        x0, x1 = rng.integers(0, 1 << 32, (2, 1000), dtype=np.uint64)
        j0, j1 = _jax_threefry(key, x0, x1)
        p0, p1 = S.threefry2x32_plain(key, torch.from_numpy(x0.astype(
            np.int64)), torch.from_numpy(x1.astype(np.int64)))
        assert np.array_equal(p0.numpy(), j0.astype(np.int64))
        assert np.array_equal(p1.numpy(), j1.astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_plain_draws_equal_jax_bit_for_bit(seed):
    for idx in (0, 1, 14, 2 ** 20 + 3):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), idx)
        assert S.batch_key(seed, idx) == tuple(int(k)
                                               for k in np.asarray(key))
        for cap in (1, 8, 17, 500, 4097):
            want = np.asarray(jax.random.uniform(key, (cap,)))
            assert want.dtype == np.float64
            got = S.uniform_plain(S.batch_key(seed, idx), cap, "cpu")
            assert np.array_equal(got.numpy().view(np.int64),
                                  want.view(np.int64)), (seed, idx, cap)


def test_sample_mask_plain_keeps_live_draws_below_fraction():
    key = S.batch_key(7, 3)
    u = S.uniform_plain(key, 64, "cpu")
    sel = torch.from_numpy(np.random.default_rng(1).random(50) < 0.5)
    m = S.sample_mask(key, 0.4, sel, 50, 64, "cpu")
    want = (u < 0.4).clone()
    want[50:] = False
    want[:50] &= sel
    assert torch.equal(m, want)
    assert not S.sample_mask(key, 0.0, None, 64, 64, "cpu").any()
    assert S.sample_mask(key, 1.0, None, 64, 64, "cpu").all()


def _sample_rows(build, settings):
    jsess = jsrt.Session(settings)
    tsess = tsrt.Session(settings, device="cpu")
    with JStats.scoped() as js:
        jrows = build(jsess, JF).collect()
    with TStats.scoped() as ts:
        trows = build(tsess, TF).collect()
    return jrows, js.blocking_fetches, trows, ts.blocking_fetches


def _table(s, n=2600):
    rng = np.random.default_rng(9)
    return s.create_dataframe({"k": np.arange(n, dtype=np.int64),
                               "v": rng.uniform(0, 1, n),
                               "g": rng.integers(0, 5, n)})


CASES = {
    "scan": lambda s, F: _table(s).sample(0.3, seed=11),
    "negative seed": lambda s, F: _table(s).sample(0.5, seed=-5),
    "large seed": lambda s, F: _table(s).sample(0.2, seed=2 ** 40 + 7),
    "filter below": lambda s, F: _table(s).filter(F.col("v") > 0.4)
    .sample(0.5, seed=3),
    "filter above": lambda s, F: _table(s).sample(0.5, seed=3)
    .filter(F.col("v") > 0.4),
    "project below": lambda s, F: _table(s).select(
        "k", (F.col("v") * 2).alias("w")).sample(0.25, seed=8),
    "aggregate above": lambda s, F: _table(s).sample(0.4, seed=12)
    .group_by("g").agg(F.count_star().alias("n"),
                       F.sum(F.col("v")).alias("s")).sort("g"),
    "fraction 0": lambda s, F: _table(s).sample(0.0, seed=1),
    "fraction 1": lambda s, F: _table(s).sample(1.0, seed=1),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_sample_exec_keeps_the_reference_rows(case):
    settings = {"spark.rapids.tpu.sql.batchSizeRows": 500}
    jrows, jf, trows, tf = _sample_rows(CASES[case], settings)
    assert len(trows) == len(jrows)
    for g, w in zip(sorted(trows), sorted(jrows)):
        for a, b in zip(g, w):
            if isinstance(b, float):
                assert abs(a - b) <= REL * max(abs(b), 1e-300)
            else:
                assert a == b
    assert tf <= jf
    if case == "fraction 1":
        assert len(trows) == 2600
    if case == "fraction 0":
        assert trows == []


class _Batches(TpuExec):
    """A child that yields given batches (an empty one among them)."""

    def __init__(self, batches):
        super().__init__()
        self.batches = batches

    @property
    def output_schema(self):
        return self.batches[0].schema

    def execute(self, ctx):
        yield from self.batches


def test_batch_index_counts_empty_batches():
    schema = Schema([Field("k", T.INT64)])
    sizes = [300, 0, 300]
    batches = [ColumnBatch(schema, [DeviceColumn(T.INT64, torch.arange(n))],
                           n) for n in sizes]
    out = list(SampleExec(_Batches(batches), 0.5, 77).execute(
        ExecContext(TpuConf(), torch.device("cpu"))))
    assert [b.num_rows for b in out] == sizes
    for idx, b in enumerate(out):
        want = np.asarray(jax.random.uniform(
            jax.random.fold_in(jax.random.PRNGKey(77), idx),
            (sizes[idx],))) < 0.5
        assert np.array_equal(b.sel.numpy(), want)


def test_sample_without_seed_draws_one_and_plans_as_the_reference():
    s = tsrt.Session(device="cpu")
    df = _table(s, 100)
    a = df.sample(0.5)
    assert a.collect() == a.collect()  # the drawn seed stays with the plan
    j = _table(jsrt.Session(), 100).sample(0.5, seed=1).filter(
        JF.col("k") > 3)
    t = df.sample(0.5, seed=1).filter(TF.col("k") > 3)
    assert t.explain_string().splitlines()[2:] == \
        j.explain_string().splitlines()[2:]


def test_q1_sample_matches_reference_and_oracle():
    db = tpch.gen_db_arrays(0.01, tables=("lineitem",))["lineitem"]
    settings = {"spark.rapids.tpu.sql.batchSizeRows": 16384}
    n = len(db["l_orderkey"])
    keep = tpch.sample_keep(n, 16384)
    assert 0.007 * n < keep.sum() < 0.013 * n
    want = tpch.q1_sample_numpy(db, keep)
    jsess = jsrt.Session(settings)
    tsess = tsrt.Session(settings, device="cpu")
    with JStats.scoped() as js:
        jrows = tpch.q1_sample(jsess.create_dataframe(db),
                               functions=JF).collect()
    with TStats.scoped() as ts:
        trows = tpch.q1_sample(tsess.create_dataframe(db)).collect()
    for ref in (jrows, want):
        assert len(trows) == len(ref)
        for g, w in zip(trows, ref):
            assert g[:2] == w[:2] and g[-1] == w[-1]
            for a, b in zip(g[2:-1], w[2:-1]):
                assert abs(a - b) <= REL * abs(b)
    assert ts.blocking_fetches <= js.blocking_fetches
