"""Compaction by mask: the port's ``batch_utils.compact`` (the plain version
of csrc/compact.cu on the CPU) against the JAX package's ``compact`` on the
same columns and selection mask; and ``concat_batches``.  Values move, so
they compare exactly, validity included."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spark_rapids_tpu  # noqa: F401  (enables jax x64)
from spark_rapids_tpu import batch as jb
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.ops import batch_utils as jbu
from spark_rapids_tpu_torch import batch as tb
from spark_rapids_tpu_torch import types as TT
from spark_rapids_tpu_torch.ops import batch_utils as tbu

COLUMNS = [("i64", "INT64", np.int64), ("i32", "INT32", np.int32),
           ("f64", "FLOAT64", np.float64), ("b", "BOOLEAN", np.bool_),
           ("i16", "INT16", np.int16)]


def _case(n, seed, live):
    rng = np.random.default_rng(seed)
    cols = []
    for j, (name, kind, dt) in enumerate(COLUMNS):
        data = (rng.integers(-1000, 1000, n) if dt != np.bool_
                else rng.random(n) < 0.5).astype(dt)
        valid = rng.random(n) < 0.8 if j % 2 == 0 else None
        cols.append((name, kind, data, valid))
    return cols, rng.random(n) < live


def _reference(cols, sel):
    n = len(sel)
    fields = [jb.Field(name, getattr(JT, kind), True)
              for name, kind, _, _ in cols]
    dcols = [jb.DeviceColumn(getattr(JT, kind), jnp.asarray(d),
                             None if v is None else jnp.asarray(v))
             for _, kind, d, v in cols]
    out = jbu.compact(jb.ColumnBatch(jb.Schema(fields), dcols, n,
                                     jnp.asarray(sel)))
    k = out.num_rows
    return [(np.asarray(c.data)[:k],
             None if c.valid is None else np.asarray(c.valid)[:k])
            for c in out.columns]


def _port(cols, sel, n_live=None):
    fields = [tb.Field(name, getattr(TT, kind), True)
              for name, kind, _, _ in cols]
    dcols = [tb.DeviceColumn(getattr(TT, kind), torch.from_numpy(d),
                             None if v is None else torch.from_numpy(v))
             for _, kind, d, v in cols]
    out = tbu.compact(tb.ColumnBatch(tb.Schema(fields), dcols, len(sel),
                                     torch.from_numpy(sel)), n_live=n_live)
    assert out.sel is None
    return [(c.data.numpy(), None if c.valid is None else c.valid.numpy())
            for c in out.columns]


@pytest.mark.parametrize("n,live", [(1, 1.0), (1000, 0.3), (5003, 0.9),
                                    (777, 0.0)])
def test_compact_matches_reference(n, live):
    cols, sel = _case(n, n, live)
    want = _reference(cols, sel)
    for n_live in (None, int(sel.sum())):
        got = _port(cols, sel, n_live)
        for (gd, gv), (wd, wv) in zip(got, want):
            np.testing.assert_array_equal(gd, wd)
            if wv is not None:
                np.testing.assert_array_equal(gv, wv)
            else:
                assert gv is None


def test_compact_fetches_the_count_only_when_not_given():
    from spark_rapids_tpu_torch.utils.metrics import QueryStats
    cols, sel = _case(100, 3, 0.5)
    with QueryStats.scoped() as st:
        _port(cols, sel)
    assert st.blocking_fetches == 1
    with QueryStats.scoped() as st:
        _port(cols, sel, int(sel.sum()))
    assert st.blocking_fetches == 0


def test_concat_batches_keeps_rows_masks_and_validity():
    s = tb.Schema([tb.Field("a", TT.INT64, True)])
    b1 = tb.ColumnBatch(s, [tb.DeviceColumn(TT.INT64, torch.arange(3),
                                            None)], 3,
                        torch.tensor([True, False, True]))
    b2 = tb.ColumnBatch(s, [tb.DeviceColumn(
        TT.INT64, torch.arange(10, 12), torch.tensor([False, True]))], 2)
    out = tbu.concat_batches([b1, b2])
    assert out.num_rows == 5
    assert out.columns[0].data.tolist() == [0, 1, 2, 10, 11]
    assert out.columns[0].valid.tolist() == [True] * 3 + [False, True]
    assert out.sel.tolist() == [True, False, True, True, True]


def test_compact_kernel_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        tbu.compact_kernel([(torch.zeros(3), None)],
                           torch.ones(3, dtype=torch.bool), 3)
    assert tbu.compact_kernel.launches == 0
