"""Shuffle exchange: hash repartitioning as a plan operator
(``spark_rapids_tpu/plan/exchange_exec.py`` counterpart).

The child's batches are staged whole (``stage_input`` :212), so a
shuffled join's runtime broadcast flip can read the staged size first
(``staged_fits`` :239) and either path reuses the staged batches.  The
partitions stay on the device: every staged batch gets its rows'
Spark-exact murmur3 partition ids and per-partition counts from
``csrc/hashing.cu`` (``ops/hashing.partition_ids``), one fetch reads the
counts of the whole exchange, and one stable placement of the staged rows
by partition id (``ops/join.partition_perm``, the one-sweep radix pass
of ``csrc/csr_join.cu`` with the id as the digit) makes each partition one
contiguous run of row numbers, in (batch, row) order, which a gather
(``csrc/csr_join.cu csr_gather``) turns into the partition's batch.  The
reference instead compacts the concatenation of every staged batch once per
partition.  Exactly ``n_parts`` batches come out, empty ones included: a
shuffled join zips the two sides' partitions pairwise.

String columns leave as dictionary codes.  A string key's dictionary is
the one the join and the other side's exchange share (``string_dicts``,
the reference's ``shared_dicts``), so equal strings hash and compare as
equal codes on both sides.

``coalesce_output`` (the exchange between a partial and a final
aggregate, which needs whole groups per batch, not partition alignment):
a staged input of at most ``batchSizeRows`` rows comes out as one batch,
with no partition ids at all; a larger one as whole partitions grouped
into contiguous ranges of about ``batchSizeRows`` rows (the reference's
coalesced shuffle read, :330-366).

``shuffle.mode=HOST`` (``_execute_host``, reference :138-200): the
partition ids of each input batch on the device, its rows placed by
partition there (``partition_perm`` and a gather), and ONE fetch of the
placed columns and the partition counts per ``batchSizeBytes`` of input
(the reference fetches per batch); the writer pool of ``parallel/host_shuffle.py``
serializes, compresses and checksums each partition's rows into that
partition's frame file; then each partition's frames are read back (the
crc checked on every decode), re-uploaded and concatenated into one batch
per partition (codes of different dictionaries remapped into their
union; with ``coalesce_output``, small partitions read back together as
the CACHE_ONLY path groups them).  ``shuffle.mode=ICI`` exchanges run
inside mesh fragments (``parallel/spmd.py``); one reached here raises
unless ``shuffle.ici.fallback`` lets it run as CACHE_ONLY.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from ..batch import (ColumnBatch, DeviceColumn, DictStringColumn,
                     HostStringColumn, Schema)
from ..exprs import EvalContext, Expression
from ..ops import batch_utils, hashing, join
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


def _partition_ranges(counts: np.ndarray, target_rows: int):
    """Whole partitions [lo, hi) grouped into contiguous ranges of about
    ``target_rows`` rows each (reference :44)."""
    ranges, lo, acc = [], 0, 0
    for p in range(len(counts)):
        acc += int(counts[p])
        if acc >= target_rows:
            ranges.append((lo, p + 1))
            lo, acc = p + 1, 0
    if lo < len(counts):
        ranges.append((lo, len(counts)))
    return ranges


def split_by_pid(schema: Schema, cols: list,
                 dicts: Dict[int, StringDictionary], pids: torch.Tensor,
                 counts: np.ndarray, n_parts: int, device,
                 ranges=None) -> List[ColumnBatch]:
    """The rows of ``cols`` (device (data, valid) pairs, strings as codes
    of ``dicts``) split by partition id: one batch per partition in id
    order (or per range [lo, hi) of partitions), rows in their order;
    ``counts`` are the host counts per id (``n_parts``: dead rows,
    dropped)."""
    perm = join.partition_perm(pids, n_parts)
    starts = np.concatenate([[0], np.cumsum(counts[:n_parts])])
    out = []
    for lo, hi in ranges or [(p, p + 1) for p in range(n_parts)]:
        idx = perm[int(starts[lo]):int(starts[hi])]
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

    outputs_partitions = True

    def __init__(self, child: TpuExec, key_exprs: List[Expression],
                 n_parts: int, string_dicts: Dict[int, StringDictionary],
                 coalesce_output: bool = False):
        super().__init__([child])
        self.key_exprs = key_exprs  # bound against child.output_schema
        self.n_parts = n_parts
        self.string_dicts = string_dicts
        self.coalesce_output = coalesce_output
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
        if mode == "ICI" \
                and not ctx.conf["spark.rapids.tpu.shuffle.ici.fallback"]:
            raise RuntimeError(
                "shuffle.mode=ICI: this exchange was not lowered onto the "
                "mesh (unsupported surrounding plan); set "
                "spark.rapids.tpu.shuffle.ici.fallback=true to run it "
                "single-process instead")
        if mode == "HOST":
            yield from self._execute_host(ctx)
            return
        m = ctx.metric_set(self.op_id)
        device = ctx.device
        staged = self.stage_input(ctx)
        self.release()
        schema = self.output_schema
        if not staged:
            # exactly n_parts batches even for no input: the shuffled
            # join's pairwise zip relies on it
            for _ in range(1 if self.coalesce_output else self.n_parts):
                m.add("numOutputBatches", 1)
                yield empty_batch(schema, device)
            return
        batch_rows = ctx.conf["spark.rapids.tpu.sql.batchSizeRows"]
        if self.coalesce_output \
                and sum(b.num_rows for b in staged) <= batch_rows:
            # one output batch holds every group whole: no partition ids
            with m.time("opTime"):
                out = _coalesced(staged, self._key_dicts(), device)
            m.add("numOutputRows", out.num_rows)
            m.add("numOutputBatches", 1)
            yield out
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
            ranges = None
            if self.coalesce_output:
                ranges = _partition_ranges(host_counts[:self.n_parts],
                                           batch_rows)
            out = split_by_pid(schema, cols, dicts, pids, host_counts,
                               self.n_parts, device, ranges)
        del cols, pids
        for batch in out:
            m.add("numOutputRows", batch.num_rows)
            m.add("numOutputBatches", 1)
        while out:
            yield out.pop(0)

    def _execute_host(self, ctx: ExecContext) -> Iterator[ColumnBatch]:
        """The HOST transport: every partition's rows leave the device in
        frames and come back one partition at a time."""
        from ..parallel.host_shuffle import HostShuffle
        m = ctx.metric_set(self.op_id)
        device = ctx.device
        conf = ctx.conf
        shuffle = HostShuffle(
            self.n_parts, spill_dir(conf),
            num_threads=conf[
                "spark.rapids.tpu.sql.multiThreadedRead.numThreads"],
            compress=conf["spark.rapids.tpu.shuffle.compress"])
        stats = QueryStats.get()
        # input batches wait on the device, with their partition ids, until
        # they hold batchSizeBytes at the planning row width; then ONE
        # fetch brings the group to the host.  String columns leave as
        # codes of one dictionary per column, as on the device path
        budget = conf["spark.rapids.tpu.sql.batchSizeBytes"]
        width = estimated_row_bytes(self.output_schema)
        key_dicts = self._key_dicts()
        dicts: Dict[int, StringDictionary] = {}
        source = self._staged if self._staged is not None \
            else self.children[0].execute(ctx)
        group: list = []

        def flush():
            for p, sl in _host_slices(group, self.n_parts):
                shuffle.write_partition(p, sl)
            group.clear()
        try:
            for b in source:
                if self._staged is None:
                    m.add("numInputBatches", 1)
                if b.num_rows == 0:
                    continue
                with m.time("opTime"):
                    keys = key_values(self.key_exprs, b, device,
                                      self.string_dicts)
                    counts = torch.zeros(self.n_parts + 1,
                                         dtype=torch.int64, device=device)
                    pids = hashing.partition_ids(keys, self.n_parts, b.sel,
                                                 counts=counts)
                    # rows placed by partition on the device: the host
                    # cuts each partition's slice as a view
                    perm = join.partition_perm(pids, self.n_parts)
                    group.append((b, join.gather_rows(
                        perm, _encoded(b, dicts, device, key_dicts),
                        nullable=False), counts))
                    if sum(x.num_rows for x, _, _ in group) * width \
                            >= budget:
                        flush()
            with m.time("opTime"):
                flush()
                shuffle.finish_writes()
                for i, d in dicts.items():
                    shuffle.write_dictionary(i, d.values())
            stats.shuffle_bytes_written += shuffle.bytes_written
            m.add("shuffleBytesWritten", shuffle.bytes_written)
            schema = self.output_schema
            # each dictionary's frame checked; its codes rejoin the
            # dictionary this process holds, which the frame equals
            for i in dicts:
                shuffle.read_dictionary(i, decode=False)
            values = {i: d.values() for i, d in dicts.items()}
            # between a partial and a final aggregate, small partitions are
            # read back together (the final needs whole groups per batch)
            ranges = _partition_ranges(
                np.array(shuffle.part_rows), conf[
                    "spark.rapids.tpu.sql.batchSizeRows"]) \
                if self.coalesce_output \
                else [(p, p + 1) for p in range(self.n_parts)]
            read = 0
            for lo, hi in ranges:
                with m.time("opTime"):
                    parts = [_upload_slice(schema, sl, device, values)
                             for p in range(lo, hi)
                             for sl in shuffle.read_partition(p)]
                    out = batch_utils.concat_batches(parts) if parts \
                        else empty_batch(schema, device)
                stats.shuffle_bytes_read += shuffle.bytes_read - read
                m.add("shuffleBytesRead", shuffle.bytes_read - read)
                read = shuffle.bytes_read
                m.add("numOutputRows", out.num_rows)
                m.add("numOutputBatches", 1)
                yield out
        finally:
            shuffle.close()

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


def spill_dir(conf) -> str:
    """``memory.spill.dir``; its default names the temporary directory."""
    import os
    import tempfile
    d = conf["spark.rapids.tpu.memory.spill.dir"]
    if d == "/tmp/srt_spill":
        d = os.path.join(tempfile.gettempdir(), "srt_spill")
    return d


def _host_slices(group, n_parts: int):
    """(partition, host slice) of the live rows of every (batch, device
    columns placed by partition, partition counts) in ``group``, after
    ONE fetch of their columns and counts; string columns as codes (their
    dictionaries travel once per shuffle)."""
    from ..parallel.host_shuffle import HostSlice
    tree = [{"counts": counts, "cols": cols} for _, cols, counts in group]
    for (b, _, _), host in zip(group, fetch(tree) if group else []):
        bounds = np.concatenate([[0], np.cumsum(host["counts"][:n_parts])])
        strings = [isinstance(c, (HostStringColumn, DictStringColumn))
                   for c in b.columns]
        for p in range(n_parts):
            lo, hi = int(bounds[p]), int(bounds[p + 1])
            yield p, HostSlice(
                [("codes" if s else "numeric", d[lo:hi],
                  None if v is None else v[lo:hi])
                 for s, (d, v) in zip(strings, host["cols"])], hi - lo)


def _upload_slice(schema: Schema, sl, device, dictionaries) -> ColumnBatch:
    """A host slice read back from a frame as a device batch (string
    columns as codes of ``dictionaries[i]``)."""
    from ..batch import upload

    def up(a):
        return None if a is None else upload(torch.from_numpy(a), device)
    cols = []
    for i, (f, (kind, data, valid)) in enumerate(zip(schema, sl.columns)):
        if kind == "codes":
            cols.append(DictStringColumn(up(data), up(valid),
                                         dictionaries[i]))
        else:
            cols.append(DeviceColumn(f.dtype, up(data), up(valid)))
    return ColumnBatch(schema, cols, sl.num_rows)


def _coalesced(staged: List[ColumnBatch],
               key_dicts: Dict[int, StringDictionary], device) -> ColumnBatch:
    """The staged batches as one, selection masks kept (the consumer
    applies them); string columns as codes of one dictionary per column
    (a key column's: its shared one), coded batch by batch, so the pieces
    share their dictionary and no remap is needed."""
    schema = staged[0].schema
    if any(f.dtype.is_host_carried and not f.dtype.is_string
           for f in schema):  # lists stay on the host
        out = batch_utils.concat_batches(staged)
        cols = list(out.columns)
        for i, d in key_dicts.items():
            _, codes, valid = encode_column(cols[i], d, device)
            cols[i] = DictStringColumn(codes, valid, d.values())
        return ColumnBatch(out.schema, cols, out.num_rows, out.sel)
    dicts: Dict[int, StringDictionary] = {}
    parts = [_encoded(b, dicts, device, key_dicts) for b in staged]
    cols = []
    for i, f in enumerate(schema):
        d, v = _cat([p[i] for p in parts])
        cols.append(DictStringColumn(d, v, dicts[i].values()) if i in dicts
                    else DeviceColumn(f.dtype, d, v))
    sels = [b.sel for b in staged]
    sel = None if all(x is None for x in sels) else torch.cat(
        [torch.ones(b.num_rows, dtype=torch.bool, device=device)
         if x is None else x for b, x in zip(staged, sels)])
    return ColumnBatch(schema, cols, sum(b.num_rows for b in staged), sel)


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
