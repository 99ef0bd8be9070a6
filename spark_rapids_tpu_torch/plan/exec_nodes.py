"""Sort-shaped operators (``spark_rapids_tpu/plan/exec_nodes.py``
counterpart): the running top-k that ``ORDER BY ... LIMIT k`` becomes, the
device ORDER BY, and LIMIT.

``TopKExec`` (reference :236) keeps at most k rows on the device: each
input batch, behind the rows held so far, goes through the top-k kernel
(``ops/topk.py``, ``csrc/topk.cu``), which returns the indices of the
first k live rows under the reference's stable order, and those rows are
gathered.  Held rows come first, so ties keep input order as the
reference's stable per-batch sort and merge do.

``SortExec`` (reference ``SortExec``, ``_sort_perm`` :219) sorts its whole
input on the device through the same kernel with k = the row count, which
is a full stable sort for inputs of up to ``TK_MAX_K`` rows (TPC-H Q13's
ORDER BY over its few dozen groups).  Longer inputs need the full device
sort and its range partitioner (:161), which are not ported yet (ROADMAP
queue 2 row 8′) and raise.  ``LimitExec`` (reference ``LimitExec``)
passes the first n rows of its input through: a LIMIT over a host ORDER
BY, as the reference places TPC-H Q21's.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Tuple

import torch

from ..batch import (ColumnBatch, DeviceColumn, DictStringColumn, HostColumn,
                     HostStringColumn, Schema)
from ..exprs import EvalContext, Expression
from ..ops import batch_utils, topk
from .physical import ExecContext, TpuExec, _device_arrays

__all__ = ["TopKExec", "SortExec", "LimitExec"]


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
                f"a top-k on {len(orders)} sort keys needs the full device "
                f"sort, which is not ported yet (ROADMAP.md queue 2 row 8′; "
                f"the top-k kernel takes {topk.TK_MAX_KEYS})")
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


class SortExec(TopKExec):
    """A device ORDER BY over the whole input: the top-k kernel with k =
    the input's row count (ties in input order), for inputs of at most
    ``topk.TK_MAX_K`` rows."""

    def __init__(self, child: TpuExec,
                 orders: List[Tuple[Expression, bool, bool]]):
        super().__init__(child, orders, topk.TK_MAX_K)

    def execute(self, ctx: ExecContext) -> Iterator[ColumnBatch]:
        m = ctx.metric_set(self.op_id)
        parts = [b for b in self.children[0].execute(ctx) if b.num_rows]
        if not parts:
            return
        with m.time("opTime"):
            whole = batch_utils.concat_batches(parts)
            if whole.num_rows > topk.TK_MAX_K:
                raise NotImplementedError(
                    f"a device ORDER BY over {whole.num_rows} rows needs "
                    f"the full device sort, which is not ported yet "
                    f"(ROADMAP.md queue 2 row 8′; the top-k kernel sorts "
                    f"at most {topk.TK_MAX_K} rows)")
            idx = topk.topk_indices(self._keys(whole, ctx.device), whole.sel,
                                    whole.num_rows, whole.num_rows)
        yield _gather(whole, idx)


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
