"""CPU fallback operators (``spark_rapids_tpu/cpu/exec.py`` counterpart).

Only the host sort is ported: the operator that TPC-H Q1's ORDER BY on
string keys falls back to.  Rows reach the host through one counted fetch
per input batch; the sort is numpy ``lexsort`` over dense rank keys, with
Spark's orderings: NaN above every number, -0.0 equal to 0.0, and nulls
first for ascending and last for descending keys unless the order says
otherwise.
"""

from __future__ import annotations

from typing import Iterator, List, Tuple

import numpy as np

from ..batch import ColumnBatch, HostColumn, HostStringColumn, to_host
from ..exprs import BoundReference, Expression
from ..plan.physical import ExecContext, TpuExec

__all__ = ["CpuSortExec", "sort_key"]


def sort_key(data: np.ndarray, valid, ascending: bool,
             nulls_first: bool) -> np.ndarray:
    """int64 rank key encoding value order, direction and null placement.

    Dense ranks: equal values share a key, so descending negation keeps
    ties stable under the minor-to-major composition of ``lexsort``."""
    n = len(data)
    null = np.zeros(n, dtype=bool) if valid is None else ~valid
    if data.dtype.kind == "O":
        null = null | np.array([x is None for x in data], dtype=bool)
    key = np.empty(n, dtype=np.int64)
    live = ~null
    vals = data[live]
    if vals.dtype.kind == "O":
        vals = vals.astype(str)
    elif vals.dtype.kind == "f":
        vals = np.where(vals == 0, 0.0, vals)  # -0.0 ranks with 0.0
    # np.unique sorts NaN last and folds every NaN into one value
    _, rank = np.unique(vals, return_inverse=True)
    rank = rank.reshape(-1).astype(np.int64)
    key[live] = rank if ascending else -rank
    key[null] = np.iinfo(np.int64).min if nulls_first \
        else np.iinfo(np.int64).max
    return key


class CpuSortExec(TpuExec):
    """ORDER BY on the host over the child's rows; ``orders`` holds
    (bound key, ascending, nulls_first).  Keys are bare columns in this
    slice."""

    def __init__(self, child: TpuExec,
                 orders: List[Tuple[Expression, bool, bool]]):
        super().__init__([child])
        for e, _, _ in orders:
            if not isinstance(e, BoundReference):
                raise NotImplementedError(
                    "the host sort takes column keys only; computed sort "
                    "keys need the CPU expression evaluator, not ported yet")
        self.orders = orders

    @property
    def output_schema(self):
        return self.children[0].output_schema

    def execute(self, ctx: ExecContext) -> Iterator[ColumnBatch]:
        parts = [to_host(b) for b in self.children[0].execute(ctx)]
        schema = self.output_schema
        cols: List[HostColumn] = []
        for i, f in enumerate(schema):
            data = np.concatenate([p[i].data for p in parts]) if parts \
                else np.empty(0, dtype=object if f.dtype.is_string
                              else f.dtype.numpy_dtype)
            valids = [p[i].valid for p in parts]
            valid = None
            if any(v is not None for v in valids):
                valid = np.concatenate([
                    np.ones(len(p[i].data), dtype=bool) if v is None else v
                    for p, v in zip(parts, valids)])
            cols.append(HostStringColumn(data, valid) if f.dtype.is_string
                        else HostColumn(f.dtype, data, valid))
        n = len(cols[0].data) if cols else 0
        keys = [sort_key(cols[e.ordinal].data, cols[e.ordinal].valid, asc,
                         nf) for e, asc, nf in self.orders]
        perm = np.lexsort(keys[::-1]) if keys else np.arange(n)
        out = []
        for c in cols:
            valid = None if c.valid is None else c.valid[perm]
            out.append(HostStringColumn(c.data[perm], valid)
                       if c.dtype.is_string
                       else HostColumn(c.dtype, c.data[perm], valid))
        yield ColumnBatch(schema, out, n)
