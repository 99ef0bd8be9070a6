"""Shuffle exchange: hash repartitioning as a plan operator
(``spark_rapids_tpu/plan/exchange_exec.py`` counterpart, CACHE_ONLY).

The child's batches are staged whole (``stage_input`` :212), so a
shuffled join's runtime broadcast flip can read the staged size first
(``staged_fits`` :239) and either path reuses the staged batches.  The
partitions stay on the device: every staged batch gets its rows'
Spark-exact murmur3 partition ids and per-partition counts from
``csrc/hashing.cu`` (``ops/hashing.partition_ids``), one fetch reads the
counts of the whole exchange, and one stable placement of the staged rows
by partition id (``ops/join.partition_perm``, a radix pass of
``csrc/csr_join.cu`` with the id as the digit) makes each partition one
contiguous run of row numbers, in (batch, row) order, which a gather
(``csrc/csr_join.cu csr_gather``) turns into the partition's batch.  The
reference instead compacts the concatenation of every staged batch once per
partition.  Exactly ``n_parts`` batches come out, empty ones included: a
shuffled join zips the two sides' partitions pairwise.

String columns leave as dictionary codes.  A string key's dictionary is
the one the join and the other side's exchange share (``string_dicts``,
the reference's ``shared_dicts``), so equal strings hash and compare as
equal codes on both sides.  The reference's HOST and ICI transports and
its ``coalesce_output`` (the partial aggregation's exchange, which the
single-process plan never builds) are not ported: ``shuffle.mode`` HOST or
ICI raises (ROADMAP.md item 10).
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from ..batch import (ColumnBatch, DeviceColumn, DictStringColumn,
                     HostStringColumn, Schema)
from ..exprs import EvalContext, Expression
from ..ops import hashing, join
from ..ops.strings import StringDictionary, encode_column
from ..utils.metrics import QueryStats, fetch
from .cbo import estimated_row_bytes
from .physical import ExecContext, TpuExec, _device_arrays
from .planner import strip_alias

__all__ = ["ShuffleExchangeExec", "key_values", "split_by_pid",
           "empty_batch"]


def empty_batch(schema: Schema, device) -> ColumnBatch:
    """A batch of no rows."""
    cols: List = []
    for f in schema:
        if f.dtype.is_string:
            cols.append(HostStringColumn(np.empty(0, dtype=object)))
        else:
            cols.append(DeviceColumn(
                f.dtype, torch.empty(0, dtype=f.dtype.torch_dtype,
                                     device=device)))
    return ColumnBatch(schema, cols, 0)


def key_values(key_exprs: List[Expression], batch: ColumnBatch, device,
               dicts: Dict[int, StringDictionary]) -> list:
    """Per key expression (bound against ``batch``), its (data, valid) on
    the device: a bare string column as int32 codes of ``dicts[i]`` (made
    on first use and shared by every side that hashes or compares key
    ``i``), anything else evaluated under the batch's live mask."""
    ctx = EvalContext(_device_arrays(batch), batch.num_rows, device,
                      active=batch.sel)
    out = []
    for i, e in enumerate(key_exprs):
        core = strip_alias(e)
        if core.dtype.is_string:
            d = dicts.setdefault(i, StringDictionary())
            _, codes, valid = encode_column(batch.columns[core.ordinal], d,
                                            device)
            out.append((codes, valid))
            continue
        d, v = e.eval(ctx)
        if d.dim() == 0:
            d = d.expand(batch.num_rows)
        if v is not None and v.dim() == 0:
            v = v.expand(batch.num_rows)
        out.append((d.contiguous(), None if v is None else v.contiguous()))
    return out


def _encoded(batch: ColumnBatch, dicts: Dict[int, StringDictionary], device,
             key_dicts: Dict[int, StringDictionary]) -> list:
    """The batch's columns as (data, valid): string columns as codes of
    one dictionary per column (a key column's: the shared one; another
    column adopts the first batch's dictionary, so codes that arrive from
    a join pass as they are)."""
    out = []
    for i, c in enumerate(batch.columns):
        if isinstance(c, (HostStringColumn, DictStringColumn)):
            dicts[i], codes, valid = encode_column(
                c, key_dicts.get(i) or dicts.get(i), device)
            out.append((codes, valid))
        else:
            out.append((c.data, c.valid))
    return out


def split_by_pid(schema: Schema, cols: list,
                 dicts: Dict[int, StringDictionary], pids: torch.Tensor,
                 counts: np.ndarray, n_parts: int,
                 device) -> List[ColumnBatch]:
    """The rows of ``cols`` (device (data, valid) pairs, strings as codes
    of ``dicts``) split by partition id: one batch per partition in id
    order, rows in their order; ``counts`` are the host counts per id
    (``n_parts``: dead rows, dropped)."""
    perm = join.partition_perm(pids, n_parts)
    starts = np.concatenate([[0], np.cumsum(counts[:n_parts])])
    out = []
    for p in range(n_parts):
        idx = perm[int(starts[p]):int(starts[p + 1])]
        gathered = join.gather_rows(idx, cols, nullable=False)
        batch_cols = []
        for i, (f, (d, v)) in enumerate(zip(schema, gathered)):
            if i in dicts:
                batch_cols.append(DictStringColumn(d, v, dicts[i].values()))
            else:
                batch_cols.append(DeviceColumn(f.dtype, d, v))
        out.append(ColumnBatch(schema, batch_cols, idx.shape[0]))
    return out


class ShuffleExchangeExec(TpuExec):
    """Hash-repartition the child's output into exactly ``n_parts``
    partition batches, one per partition id in order."""

    def __init__(self, child: TpuExec, key_exprs: List[Expression],
                 n_parts: int, string_dicts: Dict[int, StringDictionary]):
        super().__init__([child])
        self.key_exprs = key_exprs  # bound against child.output_schema
        self.n_parts = n_parts
        self.string_dicts = string_dicts
        self._staged: Optional[List[ColumnBatch]] = None

    @property
    def output_schema(self) -> Schema:
        return self.children[0].output_schema

    def node_desc(self) -> str:
        return (f"TpuShuffleExchange hashpartitioning({len(self.key_exprs)} "
                f"keys, {self.n_parts})")

    def stage_input(self, ctx: ExecContext) -> List[ColumnBatch]:
        """The child's batches, staged once (selection masks kept): the
        flip reads their size here, and whichever path wins consumes
        them."""
        if self._staged is None:
            m = ctx.metric_set(self.op_id)
            self._staged = []
            for b in self.children[0].execute(ctx):
                m.add("numInputBatches", 1)
                if b.num_rows:
                    self._staged.append(b)
        return self._staged

    def release(self) -> None:
        """Drop the staged batches (their device memory goes with them)."""
        self._staged = None

    def staged_fits(self, ctx: ExecContext, threshold: int) -> bool:
        """Do the staged live rows fit ``threshold`` bytes at the planning
        row width?  A bound from the row counts first, with no fetch; only
        when it does not fit, one fetch of the exact live count."""
        staged = self.stage_input(ctx)
        width = estimated_row_bytes(self.output_schema)
        if sum(b.num_rows for b in staged) * width <= threshold:
            return True
        total = sum(b.num_rows for b in staged if b.sel is None)
        masked = [b.sel.sum() for b in staged if b.sel is not None]
        if masked:
            total += int(sum(int(x) for x in fetch(masked)))
        return total * width <= threshold

    def execute(self, ctx: ExecContext) -> Iterator[ColumnBatch]:
        mode = ctx.conf["spark.rapids.tpu.shuffle.mode"]
        if mode != "CACHE_ONLY":
            raise NotImplementedError(
                f"spark.rapids.tpu.shuffle.mode={mode} is not ported yet "
                f"(ROADMAP.md item 10); CACHE_ONLY runs")
        m = ctx.metric_set(self.op_id)
        device = ctx.device
        staged = self.stage_input(ctx)
        self.release()
        schema = self.output_schema
        if not staged:
            # exactly n_parts batches even for no input: the shuffled
            # join's pairwise zip relies on it
            for _ in range(self.n_parts):
                m.add("numOutputBatches", 1)
                yield empty_batch(schema, device)
            return
        with m.time("opTime"):
            n = sum(b.num_rows for b in staged)
            counts = torch.zeros(self.n_parts + 1, dtype=torch.int64,
                                 device=device)
            pids = torch.empty(n, dtype=torch.int32, device=device)
            dicts: Dict[int, StringDictionary] = {}
            key_dicts = self._key_dicts()
            parts, off = [], 0
            stats = QueryStats.get()
            for b in staged:
                keys = key_values(self.key_exprs, b, device,
                                  self.string_dicts)
                hashing.partition_ids(keys, self.n_parts, b.sel,
                                      counts=counts,
                                      pid_out=pids[off:off + b.num_rows])
                cols = _encoded(b, dicts, device, key_dicts)
                stats.shuffle_bytes += sum(
                    d.nbytes + (0 if v is None else v.nbytes)
                    for d, v in cols)
                parts.append(cols)
                off += b.num_rows
            del staged
            host_counts = fetch(counts)
            cols = [_cat([p[i] for p in parts]) for i in range(len(schema))]
            del parts
            out = split_by_pid(schema, cols, dicts, pids, host_counts,
                               self.n_parts, device)
        del cols, pids
        for batch in out:
            m.add("numOutputRows", batch.num_rows)
            m.add("numOutputBatches", 1)
        while out:
            yield out.pop(0)

    def _key_dicts(self) -> Dict[int, StringDictionary]:
        """Column ordinal → the shared dictionary of each bare string
        key."""
        out = {}
        for i, e in enumerate(self.key_exprs):
            core = strip_alias(e)
            if core.dtype.is_string:
                out[core.ordinal] = self.string_dicts.setdefault(
                    i, StringDictionary())
        return out


def _cat(values: list):
    """One (data, valid) from per-batch pieces (validity filled with True
    where a piece has none)."""
    if len(values) == 1:
        return values[0]
    data = torch.cat([d for d, _ in values])
    if all(v is None for _, v in values):
        return data, None
    return data, torch.cat([torch.ones(d.shape[0], dtype=torch.bool,
                                       device=d.device) if v is None else v
                            for d, v in values])
