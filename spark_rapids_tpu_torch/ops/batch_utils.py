"""Batch utilities (``spark_rapids_tpu/ops/batch_utils.py`` counterpart).

Only the bounded form of ``compact_packed`` (:307) is ported: the slice
that trims a batch whose live rows are packed at the front to a static
bound, without a host sync.  Compaction by mask, concat, row windows and
gathers (ROADMAP queue 2 row 3) come with the operators that need them.
"""

from __future__ import annotations

from ..batch import ColumnBatch, DeviceColumn, DictStringColumn, HostColumn

__all__ = ["compact_packed"]


def compact_packed(batch: ColumnBatch, bound: int) -> ColumnBatch:
    """Slice a batch whose live rows are front-packed (``sel`` is a prefix
    mask, as the grid aggregate's output is) to its first ``bound`` rows.
    ``bound`` is a static upper limit on live rows, so no count is
    fetched; ``sel`` rides along."""
    cap = min(bound, batch.num_rows)
    if cap == batch.num_rows:
        return batch
    cols = []
    for c in batch.columns:
        valid = None if c.valid is None else c.valid[:cap]
        if isinstance(c, DictStringColumn):
            cols.append(DictStringColumn(c.codes[:cap], valid, c.dictionary))
        elif isinstance(c, HostColumn):
            cols.append(type(c)(c.data[:cap], valid) if c.dtype.is_string
                        else HostColumn(c.dtype, c.data[:cap], valid))
        else:
            cols.append(DeviceColumn(c.dtype, c.data[:cap], valid))
    sel = None if batch.sel is None else batch.sel[:cap]
    return ColumnBatch(batch.schema, cols, cap, sel)
