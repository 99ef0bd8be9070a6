"""Sort-shaped operators (``spark_rapids_tpu/plan/exec_nodes.py``
counterpart): the running top-k that ``ORDER BY ... LIMIT k`` becomes, the
device ORDER BY, and LIMIT.

``TopKExec`` (reference :236) keeps at most k rows on the device: each
input batch, behind the rows held so far, goes through the top-k kernel
(``ops/topk.py``, ``csrc/topk.cu``), which returns the indices of the
first k live rows under the reference's stable order, and those rows are
gathered.  Held rows come first, so ties keep input order as the
reference's stable per-batch sort and merge do.

``SortExec`` (reference :27) is the full device sort (``ops/sort.py``,
``csrc/sort.cu``): the stable permutation over the keys' order images,
live rows first, applied to every column.  In-core (one input batch, or
at most ``batchSizeRows`` rows in all): the input is concatenated and
sorted once; its selection mask moves with the rows, so the live rows end
up first under a prefix mask and no count is fetched.  Out-of-core (the
reference's range-partitioned path, GpuSortExec.scala:242): each input
batch is sorted into a run; the runs' primary-key range images
(``_range_key_fn`` :161) and live counts come to the host in ONE fetch;
range bounds are sampled from them (``_sample_bounds`` :193); each range
takes one contiguous slice of every run (two ``np.searchsorted`` on the
host keys, both ``side="left"``, so a key never spans two ranges),
concatenates them run by run and sorts them, and the ranges are yielded
in order.  Stable sorts of run-ordered slices keep ties in input order,
so the output equals one global stable sort.  ``LimitExec`` (reference
``LimitExec``) passes the first n rows of its input through: a LIMIT over
a host ORDER BY, as the reference places TPC-H Q21's.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..batch import (ColumnBatch, DeviceColumn, DictStringColumn, HostColumn,
                     HostStringColumn, Schema)
from ..exprs import EvalContext, Expression
from ..ops import batch_utils, topk
from ..ops import sort as sort_ops
from ..utils.metrics import fetch
from .physical import ExecContext, TpuExec, _device_arrays

__all__ = ["TopKExec", "SortExec", "LimitExec", "sample_bounds"]


def _gather(batch: ColumnBatch, idx: torch.Tensor) -> ColumnBatch:
    """Rows ``idx`` (-1: no row) of a non-empty ``batch``; the selection
    mask marks the rows that exist."""
    keep = idx >= 0
    safe = idx.clamp(min=0)
    cols: List = []
    for f, c in zip(batch.schema, batch.columns):
        if isinstance(c, HostColumn):
            raise NotImplementedError(
                f"a top-k over the host column {f.name} is not ported yet "
                f"(ROADMAP.md queue 2 row 8)")
        if isinstance(c, DictStringColumn):
            cols.append(DictStringColumn(
                c.codes[safe], None if c.valid is None else c.valid[safe],
                c.dictionary))
        else:
            cols.append(DeviceColumn(
                c.dtype, c.data[safe],
                None if c.valid is None else c.valid[safe]))
    return ColumnBatch(batch.schema, cols, idx.shape[0], keep)


def _head(batch: ColumnBatch, n: int) -> ColumnBatch:
    """The first ``n`` rows of a batch without a selection mask."""
    cols: List = []
    for c in batch.columns:
        valid = None if c.valid is None else c.valid[:n]
        if isinstance(c, DictStringColumn):
            cols.append(DictStringColumn(c.codes[:n], valid, c.dictionary))
        elif isinstance(c, HostStringColumn):
            cols.append(HostStringColumn(c.data[:n], valid))
        elif isinstance(c, HostColumn):
            cols.append(HostColumn(c.dtype, c.data[:n], valid))
        else:
            cols.append(DeviceColumn(c.dtype, c.data[:n], valid))
    return ColumnBatch(batch.schema, cols, n)


class TopKExec(TpuExec):
    """``Limit(Sort)`` as a running top-k: ``orders`` holds (bound key,
    ascending, nulls_first); ``n`` rows come out."""

    def __init__(self, child: TpuExec,
                 orders: List[Tuple[Expression, bool, bool]], n: int):
        super().__init__([child])
        if len(orders) > topk.TK_MAX_KEYS:
            raise NotImplementedError(
                f"a top-k on {len(orders)} sort keys is past the top-k "
                f"kernel's {topk.TK_MAX_KEYS} (ROADMAP.md queue 2 row 8); "
                f"the planner runs such a LIMIT over the full sort (row 8′)")
        self.orders = orders
        self.n = n

    @property
    def output_schema(self) -> Schema:
        return self.children[0].output_schema

    def _keys(self, b: ColumnBatch, device):
        ectx = EvalContext(_device_arrays(b), b.num_rows, device,
                           active=b.sel)
        out = []
        for e, asc, nf in self.orders:
            d, v = e.eval(ectx)
            out.append((d, v, asc, nf))
        return out

    def execute(self, ctx: ExecContext) -> Iterator[ColumnBatch]:
        m = ctx.metric_set(self.op_id)
        top: Optional[ColumnBatch] = None
        for b in self.children[0].execute(ctx):
            if b.num_rows == 0:
                continue
            with m.time("opTime"):
                cand = b if top is None \
                    else batch_utils.concat_batches([top, b])
                idx = topk.topk_indices(self._keys(cand, ctx.device),
                                        cand.sel, cand.num_rows, self.n)
                top = _gather(cand, idx)
        if top is not None:
            yield top


class SortExec(TpuExec):
    """A device ORDER BY over the whole input: ``orders`` holds (bound
    key, ascending, nulls_first)."""

    def __init__(self, child: TpuExec,
                 orders: List[Tuple[Expression, bool, bool]]):
        super().__init__([child])
        self.orders = orders

    @property
    def output_schema(self) -> Schema:
        return self.children[0].output_schema

    def node_desc(self) -> str:
        return f"TpuSort [{len(self.orders)} keys]"

    def _keys(self, b: ColumnBatch, device) -> List[sort_ops.SortKey]:
        ectx = EvalContext(_device_arrays(b), b.num_rows, device,
                           active=b.sel)
        out = []
        for e, asc, nf in self.orders:
            d, v = e.eval(ectx)
            if d.dim() == 0:
                d = d.expand(b.num_rows).contiguous()
            if v is not None and v.dim() == 0:
                v = v.expand(b.num_rows).contiguous()
            out.append((d, v, asc, nf))
        return out

    def _sort(self, b: ColumnBatch, device):
        """``b`` sorted, live rows first (its selection mask moves with
        them); its primary key; the permutation."""
        keys = self._keys(b, device)
        perm = sort_ops.sort_keys_perm(keys, b.sel, b.num_rows)
        return batch_utils.gather(b, perm), keys[0], perm

    def execute(self, ctx: ExecContext) -> Iterator[ColumnBatch]:
        m = ctx.metric_set(self.op_id)
        batch_rows = ctx.conf["spark.rapids.tpu.sql.batchSizeRows"]
        held: List[ColumnBatch] = []
        runs: list = []
        total = 0
        for b in self.children[0].execute(ctx):
            if b.num_rows == 0:
                continue
            with m.time("opTime"):
                total += b.num_rows
                held.append(b)
                if runs or (total > batch_rows and len(held) > 1):
                    # out-of-core from here on: every batch becomes a run
                    for h in held:
                        run, primary, perm = self._sort(h, ctx.device)
                        runs.append((run, sort_ops.range_key(*primary,
                                                             perm)))
                    held = []
        if runs:
            yield from self._ranges(ctx, m, runs, total, batch_rows)
            return
        if not held:
            return
        with m.time("opTime"):
            out = self._sort(batch_utils.concat_batches(held), ctx.device)[0]
        m.add("numOutputRows", out.num_rows)
        yield out

    def _ranges(self, ctx, m, runs, total: int, batch_rows: int
                ) -> Iterator[ColumnBatch]:
        with m.time("opTime"):
            host = fetch([(rk, None if run.sel is None else run.sel.sum())
                          for run, rk in runs])
            keys, live = [], []
            for (run, _), (rk, count) in zip(runs, host):
                n_live = run.num_rows if count is None else int(count)
                keys.append(rk[:n_live])
                live.append(batch_utils.slice_batch(run, 0, n_live))
            runs.clear()  # the device range keys are no longer needed
            del host
            for b in live:
                b.sel = None  # live rows only
            bounds = sample_bounds(keys, max(2, -(-total // batch_rows)))
        for lo_b, hi_b in bounds:
            with m.time("opTime"):
                slices = []
                for b, rk in zip(live, keys):
                    lo = 0 if lo_b is None else int(
                        np.searchsorted(rk, lo_b, side="left"))
                    hi = len(rk) if hi_b is None else int(
                        np.searchsorted(rk, hi_b, side="left"))
                    if hi > lo:
                        slices.append(batch_utils.slice_batch(b, lo, hi - lo))
                if not slices:
                    continue
                part = batch_utils.concat_batches(slices)
                del slices
                out = self._sort(part, ctx.device)[0]
                del part
            m.add("numOutputRows", out.num_rows)
            yield out


def sample_bounds(keys: List[np.ndarray], n_ranges: int):
    """Range boundaries from per-run key samples (the reference's
    ``_sample_bounds`` :193, GpuRangePartitioner's sampling): about 64
    samples per run, cut at the ``n_ranges`` quantiles.  Returns [(lo,
    hi), ...] with None for the open ends."""
    samples = []
    for k in keys:
        if len(k) == 0:
            continue
        step = max(1, len(k) // 64)
        samples.append(k[::step])
    if not samples:
        return [(None, None)]
    s = np.sort(np.concatenate(samples))
    cuts = []
    for i in range(1, n_ranges):
        q = s[min(len(s) - 1, (len(s) * i) // n_ranges)]
        if not cuts or q > cuts[-1]:
            cuts.append(q)
    bounds = []
    prev = None
    for c in cuts:
        bounds.append((prev, c))
        prev = c
    bounds.append((prev, None))
    return bounds


class LimitExec(TpuExec):
    """The first ``n`` rows of the child's output, in order.  A device
    batch with a selection mask is compacted first (one counted fetch)."""

    def __init__(self, child: TpuExec, n: int):
        super().__init__([child])
        self.n = n

    @property
    def output_schema(self) -> Schema:
        return self.children[0].output_schema

    def execute(self, ctx: ExecContext) -> Iterator[ColumnBatch]:
        left = self.n
        for b in self.children[0].execute(ctx):
            if left <= 0:
                break
            if b.sel is not None:
                b = batch_utils.compact(b)
            take = min(left, b.num_rows)
            left -= take
            yield b if take == b.num_rows else _head(b, take)
