"""WindowExec: the device window operator
(``spark_rapids_tpu/plan/window_exec.py`` counterpart).

All window expressions of one (partition, order) spec run over one sort:
the input is concatenated and compacted into one batch, sorted once by
the spec's keys (the full device sort, ``csrc/sort.cu``) and gathered
once into that order; the segment structure is built once over the
sorted rows (``ops/window.py SortedWindowContext``), and each expression
reads the sorted rows and is a segmented scan or an elementwise pass over
them (``csrc/window_scan.cu``, ``csrc/window_frame.cu``).  Output rows
come in (partition, order) sorted order, as the reference emits them,
with the window columns appended.  The input batch is released once its
sorted copy exists.
"""

from __future__ import annotations

from typing import Iterator, List, Tuple

from ..batch import ColumnBatch, DeviceColumn, Field, Schema
from ..exprs import EvalContext
from ..ops import batch_utils
from ..ops.window import SortedWindowContext, full_column
from ..windowfns import WindowExpression
from .physical import ExecContext, TpuExec, _device_arrays

__all__ = ["WindowExec"]


class WindowExec(TpuExec):
    def __init__(self, child: TpuExec,
                 window_exprs: List[Tuple[str, WindowExpression]]):
        super().__init__([child])
        from .exec_nodes import refuse_wide_keys
        spec = window_exprs[0][1].spec
        refuse_wide_keys(list(spec.partition_by)
                         + [o.expr for o in spec.order_by])
        self.window_exprs = window_exprs
        fields = list(child.output_schema.fields)
        for name, e in window_exprs:
            fields.append(Field(name, e.dtype, e.nullable))
        self._schema = Schema(fields)

    @property
    def output_schema(self) -> Schema:
        return self._schema

    def node_desc(self) -> str:
        spec = self.window_exprs[0][1].spec
        return (f"TpuWindow [{', '.join(n for n, _ in self.window_exprs)}] "
                f"part={len(spec.partition_by)} order={len(spec.order_by)}")

    def _keys(self, ectx: EvalContext, n: int):
        spec = self.window_exprs[0][1].spec
        return ([full_column(e.eval(ectx), n) for e in spec.partition_by],
                [full_column(o.expr.eval(ectx), n) for o in spec.order_by])

    def execute(self, ctx: ExecContext) -> Iterator[ColumnBatch]:
        m = ctx.metric_set(self.op_id)
        batches = [b for b in self.children[0].execute(ctx) if b.num_rows]
        if not batches:
            return
        spec = self.window_exprs[0][1].spec
        with m.time("opTime"):
            # concatenate first, so a filtered input costs one count fetch
            whole = batch_utils.compact(batch_utils.concat_batches(batches))
            del batches
            n = whole.num_rows
            part, order = self._keys(EvalContext(_device_arrays(whole), n,
                                                 ctx.device), n)
            perm = SortedWindowContext.order(
                part, order, [o.ascending for o in spec.order_by],
                [o.nulls_first for o in spec.order_by], n, ctx.device)
            del part, order
            # every function reads the sorted rows: one gather in all
            rows = batch_utils.gather(whole, perm)
            del whole, perm
            ectx = EvalContext(_device_arrays(rows), n, ctx.device)
            w = SortedWindowContext(*self._keys(ectx, n), n, ctx.device)
            cols = list(rows.columns)
            for _, we in self.window_exprs:
                d, v = w.full(we.window_eval(w, ectx))
                cols.append(DeviceColumn(we.dtype,
                                         d.to(we.dtype.torch_dtype), v))
        result = ColumnBatch(self._schema, cols, w.n)
        m.add("numOutputRows", result.num_rows)
        m.add("numOutputBatches", 1)
        yield result
