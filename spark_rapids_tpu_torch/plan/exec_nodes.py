"""Sort-shaped operators (``spark_rapids_tpu/plan/exec_nodes.py``
counterpart): the running top-k that ``ORDER BY ... LIMIT k`` becomes.

``TopKExec`` (reference :236) keeps at most k rows on the device: each
input batch, behind the rows held so far, goes through the top-k kernel
(``ops/topk.py``, ``csrc/topk.cu``), which returns the indices of the
first k live rows under the reference's stable order, and those rows are
gathered.  Held rows come first, so ties keep input order as the
reference's stable per-batch sort and merge do.  The full device sort
(``SortExec``, ``_sort_perm`` :219, the range partitioner :161) is not
ported yet (ROADMAP queue 2 row 8).
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Tuple

import torch

from ..batch import (ColumnBatch, DeviceColumn, DictStringColumn, HostColumn,
                     Schema)
from ..exprs import EvalContext, Expression
from ..ops import batch_utils, topk
from .physical import ExecContext, TpuExec, _device_arrays

__all__ = ["TopKExec"]


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


class TopKExec(TpuExec):
    """``Limit(Sort)`` as a running top-k: ``orders`` holds (bound key,
    ascending, nulls_first); ``n`` rows come out."""

    def __init__(self, child: TpuExec,
                 orders: List[Tuple[Expression, bool, bool]], n: int):
        super().__init__([child])
        if len(orders) > topk.TK_MAX_KEYS:
            raise NotImplementedError(
                f"a top-k on {len(orders)} sort keys needs the full device "
                f"sort, which is not ported yet (ROADMAP.md queue 2 row 8; "
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
