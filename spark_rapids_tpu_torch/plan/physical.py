"""Physical operators: scan, fused stage, aggregate, collect.

Counterpart of ``spark_rapids_tpu/plan/physical.py``.  Every operator
consumes and produces an iterator of :class:`ColumnBatch`.  The reference
traces a stage into one cached XLA program per capacity bucket; PyTorch
runs eagerly, so a stage here is its expressions' torch ops on exact-size
batches, and the aggregation reductions are the hand-written kernels of
``ops/groupby.py``.  Each aggregate keeps ONE device accumulator for the
whole query that every batch adds into, in place of the reference's
per-batch partials and merge programs (``_merge_scalars`` :943,
``_merge_partials`` :2211).  Nothing here waits for the device: the only
host syncs are the counted fetches where rows reach the host.
"""

from __future__ import annotations

import itertools
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from .. import types as T
from ..batch import (ColumnBatch, DeviceColumn, DictStringColumn, Field,
                     HostColumn, HostListColumn, HostStringColumn, Schema,
                     upload)
from ..config import TpuConf
from ..exprs import AggregateExpression, BoundReference, EvalContext, \
    Expression
from ..ops import batch_utils, groupby
from ..ops.strings import StringDictionary, encode_column
from ..utils.metrics import MetricSet, QueryStats, fetch, fetch_scalars

__all__ = ["ExecContext", "TpuExec", "MemorySource", "ScanExec", "StageExec",
           "AggregateExec", "CollectExec"]

DENSE_MARGIN_GAPS = 64
_I64_MIN, _I64_MAX = -(1 << 63), (1 << 63) - 1


class ExecContext:
    """Per-query execution context: conf, metrics and the device."""

    def __init__(self, conf: TpuConf, device: torch.device):
        self.conf = conf
        self.device = device
        self.metrics: Dict[str, MetricSet] = {}

    def metric_set(self, op_id: str) -> MetricSet:
        if op_id not in self.metrics:
            self.metrics[op_id] = MetricSet(op_id)
        return self.metrics[op_id]


class TpuExec:
    """Base physical operator (the name is the reference's)."""

    def __init__(self, children=()):
        self.children = list(children)
        self.op_id = f"{type(self).__name__}@{id(self):x}"

    @property
    def output_schema(self) -> Schema:
        raise NotImplementedError

    def execute(self, ctx: ExecContext) -> Iterator[ColumnBatch]:
        raise NotImplementedError


def _cat_values(parts):
    """One (data, valid) from pieces (a missing validity filled True)."""
    data = torch.cat([d for d, _ in parts])
    if all(v is None for _, v in parts):
        return data, None
    return data, torch.cat([torch.ones(d.shape[0], dtype=torch.bool,
                                       device=d.device) if v is None else v
                            for d, v in parts])


def _device_arrays(b: ColumnBatch) -> list:
    return [(c.data, c.valid) if isinstance(c, DeviceColumn) else None
            for c in b.columns]


# ---------------------------------------------------------------------------------
# Scan over in-memory numpy columns
# ---------------------------------------------------------------------------------

class MemorySource:
    """Columns given as numpy (``batch.numpy_column`` form), cut into
    batches of ``batch_rows`` rows.

    Per column, the source keeps (shared by every pruned view of it) a
    pinned host copy for CUDA uploads, made the first time a query reads
    the column, and one host column object per batch for string and list
    columns, so the cached dictionary encodings of strings serve every
    run.
    ``unpruned`` is the schema of the table before column pruning: the
    planner's size estimates read it, as the reference's do, since the
    reference's in-memory scans are not narrowed.
    """

    def __init__(self, columns: Dict[str, Tuple[T.DataType, np.ndarray,
                                                Optional[np.ndarray]]],
                 batch_rows: int, _cache: Optional[dict] = None,
                 unpruned: Optional[Schema] = None):
        self.columns = columns
        self.batch_rows = batch_rows
        self.num_rows = len(next(iter(columns.values()))[1]) \
            if columns else 0
        self._cache = {} if _cache is None else _cache
        self.unpruned = unpruned if unpruned is not None else self.schema()

    def schema(self) -> Schema:
        return Schema([Field(n, dt, valid is not None)
                       for n, (dt, _, valid) in self.columns.items()])

    def pruned(self, names: List[str]) -> "MemorySource":
        return MemorySource({n: self.columns[n] for n in names},
                            self.batch_rows, self._cache, self.unpruned)

    def _host_tensor(self, key, arr: np.ndarray,
                     device: torch.device) -> torch.Tensor:
        t = self._cache.get(key)
        if t is None:
            t = torch.from_numpy(arr)
            if device.type == "cuda":
                t = t.pin_memory()
                self._cache[key] = t
        return t

    def _host_columns(self, name: str) -> List[HostColumn]:
        """The batches of a host-carried (string or list) column."""
        cols = self._cache.get(("host", name))
        if cols is None:
            dt, data, valid = self.columns[name]
            cls = HostListColumn if dt.is_nested else HostStringColumn
            cols = [cls(
                data[off:off + self.batch_rows],
                None if valid is None else valid[off:off + self.batch_rows])
                for off in range(0, self.num_rows, self.batch_rows)]
            self._cache[("host", name)] = cols
        return cols

    def batches(self, device: torch.device) -> Iterator[ColumnBatch]:
        schema = self.schema()
        for bi, off in enumerate(range(0, self.num_rows, self.batch_rows)):
            m = min(self.batch_rows, self.num_rows - off)
            timer = _UploadTimer(device)
            cols, nbytes = [], 0
            for name, (dt, data, valid) in self.columns.items():
                if dt.is_host_carried:
                    cols.append(self._host_columns(name)[bi])
                    continue
                d = upload(self._host_tensor(("data", name), data,
                                             device)[off:off + m], device)
                v = None if valid is None else upload(self._host_tensor(
                    ("valid", name), valid, device)[off:off + m], device)
                nbytes += d.nbytes + (0 if v is None else v.nbytes)
                cols.append(DeviceColumn(dt, d, v))
            timer.done(nbytes)
            yield ColumnBatch(schema, cols, m)


class _UploadTimer:
    """One uploaded batch in ``QueryStats``: counted, its bytes added, and
    on CUDA timed by a pair of events around its copies."""

    def __init__(self, device: torch.device):
        self.start = None
        if device.type == "cuda":
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record()

    def done(self, nbytes: int) -> None:
        stats = QueryStats.get()
        if self.start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            stats.upload_events.append((self.start, end))
        stats.uploads += 1
        stats.upload_bytes += nbytes


def _pinned_upload(table, key, arr: np.ndarray,
                   device: torch.device) -> torch.Tensor:
    """A host table's column on ``device``; for CUDA the pinned copy is
    made once and kept on the table (the file cache may serve it again)."""
    if device.type != "cuda":
        return torch.from_numpy(arr)
    t = table.pinned.get(key)
    if t is None:
        t = table.pinned[key] = torch.from_numpy(arr).pin_memory()
    return upload(t, device)


def upload_table(table, schema: Schema, device: torch.device) -> ColumnBatch:
    """One decoded file batch (``io/parquet.HostTable``) as a port batch:
    its numeric columns uploaded (counted in ``QueryStats``, timed by CUDA
    events), its string columns passed on as host columns."""
    timer = _UploadTimer(device)
    cols, nbytes = [], 0
    for i, (f, c) in enumerate(zip(schema, table.columns)):
        if not isinstance(c, tuple):
            cols.append(c)
            continue
        data, valid = c
        d = _pinned_upload(table, ("data", i), data, device)
        v = None if valid is None else _pinned_upload(table, ("valid", i),
                                                      valid, device)
        nbytes += d.nbytes + (0 if v is None else v.nbytes)
        cols.append(DeviceColumn(f.dtype, d, v))
    timer.done(nbytes)
    return ColumnBatch(schema, cols, table.num_rows)


class ScanExec(TpuExec):
    """A scan: the batches of an in-memory source, or the decoded batches
    of a file source (``io/parquet.ParquetSource``) uploaded, as the
    reference's ``ScanExec`` (``physical.py:158-320``) does.

    ``runtime_predicates`` are the predicates a join pushes into a file
    scan at run time (``join_exec._inject_dpp``, ``_inject_smj_filter``):
    a list, or a thunk resolved at the scan's first read
    (``_effective_source``), by when the joins above it have fetched their
    build stats.  With ``fileCache.enabled`` and ``fileCache.deviceTier``
    the uploaded batches of a file scan stay on the device, keyed by the
    source's ``cache_token`` (files, projection, predicates), and a repeated
    identical scan hands them out again without decoding or uploading."""

    def __init__(self, schema: Schema, source):
        super().__init__()
        self._schema = schema
        self.source = source
        self.runtime_predicates = None

    @property
    def output_schema(self) -> Schema:
        return self._schema

    def _effective_source(self):
        src = self.source
        preds = self.runtime_predicates
        if callable(preds):
            preds = self.runtime_predicates = preds()
        if preds and hasattr(src, "with_pushdown"):
            src = src.with_pushdown(None, preds)
        return src

    def execute(self, ctx: ExecContext) -> Iterator[ColumnBatch]:
        m = ctx.metric_set(self.op_id)
        batches = self._file_batches(ctx, m) \
            if hasattr(self.source, "with_pushdown") \
            else self.source.batches(ctx.device)
        for b in batches:
            m.add("numOutputRows", b.num_rows)
            yield b

    def _file_batches(self, ctx: ExecContext, m) -> Iterator[ColumnBatch]:
        from ..io.filecache import get_device_cache
        conf = ctx.conf
        source = self._effective_source()
        m.add("runtimePredicates", len(self.runtime_predicates or ()))
        dcache = dkey = None
        if conf["spark.rapids.tpu.sql.fileCache.enabled"] \
                and conf["spark.rapids.tpu.sql.fileCache.deviceTier"]:
            token = source.cache_token()
            if token is not None:
                dcache = get_device_cache(
                    conf["spark.rapids.tpu.sql.fileCache.device.maxBytes"])
                dkey = (token, str(ctx.device))
                hit = dcache.get(dkey)
                if hit is not None:
                    for b in hit:  # fresh wrappers over the cached columns
                        yield ColumnBatch(b.schema, b.columns, b.num_rows,
                                          b.sel)
                    return
        # the accumulator is dropped once it passes the cache's budget: an
        # over-budget scan streams on without pinning its batches
        acc = [] if dcache is not None else None
        acc_bytes = 0
        for table in source(prefetch_depth=4):
            b = upload_table(table, self._schema, ctx.device)
            if acc is not None:
                acc_bytes += dcache.batch_bytes(b)
                if acc_bytes > dcache.max_bytes:
                    acc = None
                else:
                    acc.append(b)
                    b = ColumnBatch(b.schema, b.columns, b.num_rows, b.sel)
            yield b
        m.add("rowGroupsRead", source.row_groups_kept)
        m.add("rowGroupsTotal", source.row_groups_total)
        if acc is not None:
            dcache.put(dkey, acc)


# ---------------------------------------------------------------------------------
# Fused filter/project stage
# ---------------------------------------------------------------------------------

class StageExec(TpuExec):
    """A pipeline of project and filter steps over one input.

    ``steps`` is a list of ("project", [(name, expr, host_src), ...]) or
    ("filter", pred_expr), bound against the running schema; ``host_src``
    (when expr is None) names a host column passed through by reference.
    Filters AND into the batch's live-row mask.  Under ANSI mode, error
    flags accumulate on the device and are checked once, after the last
    batch."""

    def __init__(self, child: TpuExec, steps: List[Tuple[str, object]],
                 output_schema: Schema):
        super().__init__([child])
        from .stringpred import lower_string_predicate_steps
        self.steps = lower_string_predicate_steps(steps)
        self._schema = output_schema

    @property
    def output_schema(self) -> Schema:
        return self._schema

    def run_batch(self, b: ColumnBatch, device: torch.device,
                  ansi: bool) -> Tuple[ColumnBatch, List[torch.Tensor]]:
        """One batch through the steps → (output batch, ANSI error masks).
        A string-valued projection (``stringpred.HostStringExpr``) becomes
        a dictionary column beside the host-carried ones."""
        from .planner import strip_alias
        from .stringpred import HostStringExpr
        cur = _device_arrays(b)
        host = list(b.columns)
        active = b.sel
        errors: List[torch.Tensor] = []
        for kind, payload in self.steps:
            ctx = EvalContext(cur, b.num_rows, device, active=active,
                              ansi=ansi, host=host)
            if kind == "filter":
                d, v = payload.eval(ctx)
                keep = d if v is None else d & v
                keep = keep.expand(b.num_rows) if keep.dim() == 0 else keep
                active = keep if active is None else active & keep
            else:
                cur, new_host = [], []
                for _, e, src in payload:
                    core = None if e is None else strip_alias(e)
                    if e is None:
                        cur.append(None)
                        new_host.append(host[src])
                    elif isinstance(core, HostStringExpr) \
                            and core.dtype.is_string:
                        cur.append(None)
                        new_host.append(core.column(ctx))
                    else:
                        cur.append(e.eval(ctx))
                        new_host.append(None)
                host = new_host
            errors += ctx.errors
        cols = []
        for f, val, h in zip(self._schema, cur, host):
            if val is None:
                cols.append(h)
                continue
            d, v = val
            if d.dim() == 0:  # a literal projection
                d = d.expand(b.num_rows).contiguous()
            elif f.dtype.is_wide_decimal and d.dim() == 1:  # its limbs
                d = d.expand(b.num_rows, 2).contiguous()
            if v is not None and v.dim() == 0:
                v = v.expand(b.num_rows).contiguous()
            cols.append(DeviceColumn(f.dtype, d, v))
        return ColumnBatch(self._schema, cols, b.num_rows, active), errors

    def execute(self, ctx: ExecContext) -> Iterator[ColumnBatch]:
        m = ctx.metric_set(self.op_id)
        ansi = ctx.conf["spark.rapids.tpu.sql.ansi.enabled"]
        err = None
        for b in self.children[0].execute(ctx):
            with m.time("opTime"):
                out, errors = self.run_batch(b, ctx.device, ansi)
                for e in errors:
                    e = e.any()
                    err = e if err is None else err | e
            yield out
        if err is not None and fetch_scalars(err)[0]:
            raise ArithmeticError(
                "ANSI mode: division by zero or invalid cast "
                "(spark.rapids.tpu.sql.ansi.enabled=true raises instead of "
                "returning null)")


# ---------------------------------------------------------------------------------
# Aggregate
# ---------------------------------------------------------------------------------

class AggregateExec(TpuExec):
    """Aggregation over all input batches, in one of four device paths:

    * ungrouped: every batch's contributions go through
      ``groupby.ungrouped_reduce`` (the masked_reduce kernel) into one
      K-slot accumulator;
    * grouped on bare key columns of which one is integral (a single key
      must be), every buffer an integral sum/min/max or a float64 sum:
      dense direct addressing on that primary key
      (``groupby.DenseAccumulator``, the dense_agg kernel), with the other
      keys — integers, dates, booleans, strings as codes, floats — as
      residual channels, as the reference's ``_try_dense_grouped_multi``
      (:1321) and ``_try_dense_grouped`` (:1084) do;
    * grouped, when every key is a bare string column and every buffer is
      a sum: the dense grid of dictionary codes (``grid_group_reduce``,
      the grid_agg kernel), as the reference does at
      ``plan/physical.py:1736-1790``;
    * every other grouping, and input the dense path or the grid rejects:
      the hash aggregation (``groupby.HashAccumulator``, the hash_agg
      kernel) in place of the reference's sort-based path
      (``_execute_grouped`` :1697, ``group_reduce``), with the batches the
      rejecting path had consumed replayed into it.

    A grouped FIRST or LAST always takes the hash path (the reference's
    dense path refuses them, ``physical.py:1068``, and the port's grid
    only sums); a wide decimal SUM never takes the dense path (the
    reference's refuses host-finalized sums, :1070) and is finalized on
    the device (``wide_decimal.sum_finalize``)."""

    def __init__(self, child: TpuExec,
                 group_exprs: List[Tuple[str, Expression]],
                 agg_exprs: List[Tuple[str, AggregateExpression]],
                 mode: str = "complete",
                 string_dicts: Optional[Dict[int, StringDictionary]] = None):
        super().__init__([child])
        if mode not in ("complete", "partial", "final"):
            raise ValueError(f"unknown aggregate mode {mode!r}")
        self.group_exprs = group_exprs
        self.agg_exprs = agg_exprs
        self.mode = mode
        # group index -> dictionary of a string key, shared by the partial
        # and the final around one exchange (the reference's
        # ``shared_dicts``), so codes stay comparable across it
        self.string_dicts = string_dicts if string_dicts is not None else {}
        self._schema = self._buffer_schema() if mode == "partial" else Schema(
            [Field(n, e.dtype, e.nullable) for n, e in group_exprs]
            + [Field(n, a.dtype, a.nullable) for n, a in agg_exprs])

    @property
    def output_schema(self) -> Schema:
        return self._schema

    def node_desc(self) -> str:
        keys = [n for n, _ in self.group_exprs]
        aggs = [f"{a.func}({n})" for n, a in self.agg_exprs]
        return f"TpuHashAggregate [{self.mode}] keys={keys} aggs={aggs}"

    def _buffers(self) -> List[Tuple[T.DataType, str]]:
        return [buf for _, agg in self.agg_exprs for buf in agg.buffers()]

    def _contributions(self, ectx: EvalContext):
        ops = [op for _, op in self._buffers()]
        vals = [c for _, agg in self.agg_exprs for c in agg.update(ectx)]
        return list(zip(vals, ops))

    def _finalize(self, buffer_values: list):
        """Per aggregate, finalize its buffers' values (tensors of the
        same length; FIRST/LAST buffers as (value, has) pairs) →
        [(data, valid)].  Under ANSI mode a wide SUM that overflowed its
        precision raises, after one fetch of the overflow flags."""
        outs, i, over = [], 0, []
        for _, agg in self.agg_exprs:
            nb = len(agg.buffers())
            data, valid = agg.finalize(
                [v if isinstance(v, tuple) else (v, None)
                 for v in buffer_values[i:i + nb]])
            outs.append((data.to(agg.dtype.torch_dtype), valid))
            if getattr(agg, "overflowed", None) is not None:
                over.append(agg.overflowed)
            i += nb
        if self._ansi and over \
                and bool(fetch_scalars(torch.cat(over).any())[0]):
            raise OverflowError("sum overflowed its decimal precision "
                                "(ANSI mode)")
        return outs

    def _value_columns(self, buffer_values: list) -> List[DeviceColumn]:
        """The output columns after the keys: a partial aggregate's buffer
        columns (a FIRST/LAST buffer's ``has`` as its validity), else the
        finalized aggregates."""
        if self.mode != "partial":
            return [DeviceColumn(agg.dtype, data, valid)
                    for (_, agg), (data, valid) in zip(
                        self.agg_exprs, self._finalize(buffer_values))]
        return [DeviceColumn(dt, *(v if isinstance(v, tuple) else (v, None)))
                for (dt, _), v in zip(self._buffers(), buffer_values)]

    def _ordered(self) -> bool:
        return any(op in groupby.ORDERED_OPS for _, op in self._buffers())

    def execute(self, ctx: ExecContext) -> Iterator[ColumnBatch]:
        self._ansi = ctx.conf["spark.rapids.tpu.sql.ansi.enabled"]
        batches = self.children[0].execute(ctx)
        if not self.group_exprs:
            yield self._execute_ungrouped(ctx, batches)
        elif self.mode == "final":
            yield from self._execute_final(ctx, batches)
        elif self.mode == "partial":
            yield from self._execute_partial(ctx, batches)
        elif self._ordered():
            yield from self._execute_hash(ctx, batches)
        elif self._dense_static_ok(ctx.conf):
            yield from self._execute_dense(ctx, batches)
        elif self._grid_static_ok():
            yield from self._execute_grid(ctx, batches)
        else:
            yield from self._execute_hash(ctx, batches)

    def _dicts(self) -> List[Optional[StringDictionary]]:
        """Per group key, the dictionary its codes use so far."""
        return [self.string_dicts.get(k) for k in range(len(self.group_exprs))]

    def _keep_dicts(self, dicts) -> None:
        for k, d in enumerate(dicts):
            if d is not None:
                self.string_dicts[k] = d

    # -- ungrouped ----------------------------------------------------------------
    def _execute_ungrouped(self, ctx: ExecContext, batches) -> ColumnBatch:
        m = ctx.metric_set(self.op_id)
        specs = [(op, dt == T.FLOAT64) for dt, op in self._buffers()]
        acc_f, acc_i = groupby.init_scalars(specs, ctx.device)
        acc_h = torch.zeros_like(acc_i)
        for b in batches:
            with m.time("opTime"):
                active = b.active_mask(ctx.device)
                ectx = EvalContext(_device_arrays(b), b.num_rows, ctx.device,
                                   active=active)
                groupby.ungrouped_reduce(self._contributions(ectx), active,
                                         acc_f, acc_i, acc_h)
        values = []
        for j, (op, f) in enumerate(specs):
            v = (acc_f if f else acc_i)[j:j + 1]
            values.append((v, acc_h[j:j + 1] > 0)
                          if op in groupby.ORDERED_OPS else v)
        cols = []
        for (name, agg), (data, valid) in zip(
                self.agg_exprs, self._finalize(values)):
            cols.append(DeviceColumn(
                agg.dtype, data.reshape((1, 2) if agg.dtype.is_wide_decimal
                                        else (1,)),
                None if valid is None else valid.reshape(1)))
        m.add("numOutputRows", 1)
        return ColumnBatch(self._schema, cols, 1)

    # -- grouped: the dense grid of dictionary codes ------------------------------
    def _grid_static_ok(self) -> bool:
        """The grid takes bare string keys and sums only."""
        from .planner import strip_alias
        return all(isinstance(core, BoundReference) and core.dtype.is_string
                   for core in (strip_alias(e) for _, e in self.group_exprs)) \
            and all(op == "sum" for _, op in self._buffers())

    def _grid_layout(self) -> List[str]:
        """Where each buffer lands in the grid accumulator, fixed at bind
        time: a count that can carry no validity mask is the presence
        count; every other buffer gets a float64 or int64 column."""
        kinds = []
        for _, agg in self.agg_exprs:
            for (dt, _), every_row in zip(agg.buffers(), agg.row_counts()):
                kinds.append("cnt" if every_row
                             else "f" if dt == T.FLOAT64 else "i")
        return kinds

    def _execute_grid(self, ctx: ExecContext, batches
                      ) -> Iterator[ColumnBatch]:
        """The grid over padded dictionary sizes; a grid that outgrows
        ``gridMaxGroups`` hands every batch seen so far, and the rest, to
        the hash aggregation.  A partial aggregate's grid emits its
        buffers."""
        from .planner import strip_alias
        m = ctx.metric_set(self.op_id)
        ords = [strip_alias(e).ordinal for _, e in self.group_exprs]
        grid_max = ctx.conf["spark.rapids.tpu.sql.agg.gridMaxGroups"]
        dicts = self._dicts()
        acc: Optional[groupby.GridAccumulator] = None
        seen: List[ColumnBatch] = []
        for b in batches:
            with m.time("opTime"):
                keys = []
                for k, o in enumerate(ords):
                    dicts[k], codes, valid = encode_column(b.columns[o],
                                                           dicts[k],
                                                           ctx.device)
                    keys.append((codes, valid))
                # padded dictionary sizes: the grid grows only when a
                # dictionary passes a power of two
                dims = tuple(1 << max(len(d) - 1, 0).bit_length()
                             for d in dicts)
                if groupby.grid_size(dims) > grid_max:
                    m.add("aggGridRejected", 1)
                    self._keep_dicts(dicts)
                    yield from self._execute_hash(
                        ctx, itertools.chain(seen, [b], batches))
                    return
                seen.append(b)
                active = b.active_mask(ctx.device)
                ectx = EvalContext(_device_arrays(b), b.num_rows, ctx.device,
                                   active=active)
                if acc is None:
                    acc = groupby.GridAccumulator(dims, self._grid_layout(),
                                                  ctx.device)
                elif dims != acc.dims:
                    acc.regrid(dims)
                groupby.grid_group_reduce(keys, dims,
                                          self._contributions(ectx), active,
                                          acc)
        self._keep_dicts(dicts)
        if acc is None:
            yield self._empty()
            return
        # observed slots packed to the front, in slot (key code) order
        observed = acc.cnt > 0
        pack = torch.argsort((~observed).to(torch.int8), stable=True)
        cols: List = []
        for (codes, valid), d in zip(acc.slot_codes(), dicts):
            cols.append(DictStringColumn(codes[pack], valid[pack], d.values()))
        for c in self._value_columns(acc.values()):
            cols.append(DeviceColumn(c.dtype, c.data[pack],
                                     None if c.valid is None
                                     else c.valid[pack]))
        out = ColumnBatch(self._schema, cols, acc.G, observed[pack])
        bound = 1
        for d in dicts:
            bound *= len(d) + 1
        yield batch_utils.compact_packed(out, bound)

    # -- grouped: dense direct addressing on an integral primary key ----------
    def _key_refs(self) -> List[Optional[BoundReference]]:
        from .planner import strip_alias
        return [e if isinstance(e, BoundReference) else None
                for e in (strip_alias(e) for _, e in self.group_exprs)]

    def _dense_static_ok(self, conf: TpuConf) -> bool:
        """The reference's static gates of its dense paths
        (``_dense_agg_static_ok`` :1061 for one key,
        ``_dense_residual_static_ok`` :1288 for several): every key a bare
        column, one of them integral (a single key must be), every buffer
        a sum/min/max, and no float64 min/max (the dense channels add
        float64 but order only int64).  Floating keys ride as residuals."""
        if self.mode != "complete" \
                or not conf["spark.rapids.tpu.sql.agg.dense.enabled"] \
                or not conf["spark.rapids.tpu.join.denseDomainCap"]:
            return False
        if any(op not in ("sum", "min", "max")
               or (dt == T.FLOAT64 and op != "sum")
               for dt, op in self._buffers()):
            return False
        if any(getattr(agg, "lanes", 0) for _, agg in self.agg_exprs):
            return False  # a wide sum (the reference's host_finalize)
        refs = self._key_refs()
        if any(r is None or r.dtype is None for r in refs):
            return False
        kinds = ["s" if r.dtype.is_string else
                 np.dtype(r.dtype.numpy_dtype).kind for r in refs]
        if len(refs) == 1:
            return kinds[0] in "iu"
        return all(k in "iubsf" for k in kinds) and any(k in "iu"
                                                      for k in kinds)

    def _dense_key_values(self, b: ColumnBatch, dicts, device):
        """Per group key, its (data, valid) for the dense kernels: strings
        as int32 dictionary codes, booleans and narrow ints as int32,
        floats as float64 (residuals only)."""
        out = []
        for k, ref in enumerate(self._key_refs()):
            col = b.columns[ref.ordinal]
            if ref.dtype.is_string:
                dicts[k], codes, valid = encode_column(col, dicts[k], device)
                out.append((codes, valid))
                continue
            d = col.data
            if d.is_floating_point():
                d = d.to(torch.float64)
            elif d.dtype not in (torch.int32, torch.int64):
                d = d.to(torch.int32)
            out.append((d, col.valid))
        return out

    def _channels(self, contributions) -> List[Tuple[str, bool]]:
        return [("count" if d is None else op, dt == T.FLOAT64)
                for (dt, op), ((d, _), _) in zip(self._buffers(),
                                                 contributions)]

    def _execute_dense(self, ctx: ExecContext, batches
                       ) -> Iterator[ColumnBatch]:
        """The reference's ``_try_dense_grouped_multi`` (:1321) and, for one
        key, ``_try_dense_grouped`` (:1084), through the dense_agg kernel.

        One fetch reads the first batch's key stats and the functional-
        dependence probe; the primary key is the integral candidate with
        the smallest domain whose values each map to one key tuple.  Every
        batch then scatters into ONE accumulator over the first batch's
        span and a margin; rows outside it wait in the overflow buffer,
        and the tail fetch (violation flag, group count, overflow count
        and key range) decides whether to widen the domain once and replay
        them, at one more fetch.  The output is compacted to the observed groups, in key
        order, with the null key last.  Input the path rejects (no primary
        key, a domain over ``denseDomainCap``, accumulators over
        ``maxAccumBytes``, a full overflow buffer, a residual key that is
        not determined by the primary) goes to the hash aggregation with
        every batch, as the reference replays its buffered batches into
        its sort path (``_sort_path_replay`` :1670)."""
        m = ctx.metric_set(self.op_id)
        conf, device = ctx.conf, ctx.device
        refs = self._key_refs()
        n_keys = len(refs)
        cap = conf["spark.rapids.tpu.join.denseDomainCap"]
        cand = [not r.dtype.is_string
                and np.dtype(r.dtype.numpy_dtype).kind in "iu" for r in refs]
        dicts: List[Optional[StringDictionary]] = [None] * n_keys
        seen: List[Tuple[ColumnBatch, list]] = []

        def reject() -> List[ColumnBatch]:
            """Every batch, the consumed ones first, into the hash
            aggregation."""
            m.add("aggDenseRejected", 1)
            return list(self._execute_hash(ctx, itertools.chain(
                (b for b, _ in seen), batches)))

        best = None
        for b in batches:
            with m.time("opTime"):
                kv = self._dense_key_values(b, dicts, device)
                seen.append((b, kv))
                # floats enter the dependence probe as their group-key
                # words (-0.0 = +0.0, one NaN), as the reference hashes them
                stats, fd = groupby.dense_key_stats(
                    [(groupby.key_word(d) if d.is_floating_point() else d, v)
                     for d, v in kv], cand, b.sel)
                stats, fd = fetch((stats, fd))
            if not any(stats[i][2] for i in range(n_keys) if cand[i]):
                continue  # no valid candidate key yet: keep looking
            for i in range(n_keys):
                kmin, kmax, n_valid = (int(x) for x in stats[i])
                if not cand[i] or n_valid == 0 or kmax - kmin + 1 > cap:
                    continue
                if n_keys > 1 and fd[i]:
                    continue  # maps to two key tuples: not the primary
                if best is None or kmax - kmin + 1 < best[0]:
                    best = (kmax - kmin + 1, i, kmin, n_valid)
            if best is None:
                # no integral key has a domain within denseDomainCap and
                # determines the others
                yield from reject()
                return
            break
        if not seen:
            yield self._empty()
            return
        # no valid primary in the whole input: every row has a null key
        domain, pidx, kmin, n_valid = best if best is not None \
            else (1, cand.index(True), 0, 1)
        res_idx = [i for i in range(n_keys) if i != pidx]
        n_bufs = len(self._buffers())
        max_bytes = conf["spark.rapids.tpu.sql.agg.dense.maxAccumBytes"]

        def too_big(D) -> bool:
            return n_keys > 1 and \
                D * (len(res_idx) * 18 + 2 + 8 * n_bufs) > max_bytes

        # the first batch's span with a margin of DENSE_MARGIN_GAPS mean key
        # gaps on each side, where it fits: a later batch's keys just past
        # the first batch's extremes then need no widening (and no second
        # tail fetch); keys beyond it overflow and widen
        D = domain
        if too_big(D):
            yield from reject()
            return
        margin = DENSE_MARGIN_GAPS * -(-domain // n_valid)
        lo = max(kmin - margin, _I64_MIN)
        hi = min(kmin + domain - 1 + margin, _I64_MAX)
        if hi - lo + 1 <= cap and not too_big(hi - lo + 1):
            kmin, D = lo, hi - lo + 1
        acc = None
        for b, kv in itertools.chain(list(seen), ((b, None)
                                                  for b in batches)):
            with m.time("opTime"):
                if kv is None:
                    kv = self._dense_key_values(b, dicts, device)
                    seen.append((b, None))
                ectx = EvalContext(_device_arrays(b), b.num_rows, device,
                                   active=b.sel)
                contributions = self._contributions(ectx)
                if acc is None:
                    acc = groupby.DenseAccumulator(
                        kmin, D, len(res_idx),
                        self._channels(contributions), device,
                        res_f64=[refs[i].dtype.is_floating
                                 for i in res_idx])
                acc.update(kv[pidx], [kv[i] for i in res_idx],
                           [v for v, _ in contributions], b.sel)
        violated, n_groups, n_over, omin, omax = (
            int(x) for x in fetch(acc.tail()))
        if n_over:
            lo, hi = min(acc.kmin, omin), max(acc.kmin + acc.D - 1, omax)
            if n_over > acc.cap or hi - lo + 1 > cap or too_big(hi - lo + 1):
                yield from reject()  # the overflow outgrew the buffer or caps
                return
            acc.widen(lo, hi - lo + 1)
            acc.replay_overflow(n_over)
            m.add("aggDenseWidened", 1)
            violated, n_groups = (int(x) for x in fetch(acc.check()))
        if violated:
            # a residual key takes two values, or null and non-null, under
            # one primary key
            yield from reject()
            return
        m.add("aggDensePath", 1)
        yield self._dense_output(acc, pidx, res_idx, dicts, n_groups)

    def _dense_output(self, acc, pidx: int, res_idx: List[int], dicts,
                      n_groups: int) -> ColumnBatch:
        """The accumulator's observed slots as the output batch (keys in
        the query's order, then the aggregates), compacted."""
        fields = self._schema.fields
        cols: List = []
        for i in range(len(self._key_refs())):
            f = fields[i]
            if i == pidx:
                data, valid = acc.slot_keys()
            else:
                data, valid = acc.residual(res_idx.index(i))
            valid = valid if f.nullable else None
            if f.dtype.is_string:
                cols.append(DictStringColumn(data.to(torch.int32), valid,
                                             dicts[i].values()))
            else:
                cols.append(DeviceColumn(f.dtype,
                                         data.to(f.dtype.torch_dtype),
                                         valid))
        for (name, agg), (data, valid) in zip(self.agg_exprs,
                                              self._finalize(acc.acc)):
            cols.append(DeviceColumn(agg.dtype, data, valid))
        out = ColumnBatch(self._schema, cols, acc.S, acc.present.bool())
        return batch_utils.compact(out, n_live=n_groups)

    # -- grouped: the hash aggregation ------------------------------------------
    def _hash_key_words(self, b: ColumnBatch, ectx: EvalContext, dicts,
                        device):
        """Per group key, its int64 word column and validity
        (``groupby.key_word``): strings as dictionary codes."""
        from .planner import strip_alias
        out = []
        for k, (_, e) in enumerate(self.group_exprs):
            core = strip_alias(e)
            if core.dtype.is_string:
                dicts[k], codes, valid = encode_column(
                    b.columns[core.ordinal], dicts[k], device)
                out.append((codes.to(torch.int64), valid))
                continue
            d, v = e.eval(ectx)
            if d.dim() == 0:
                d = d.expand(b.num_rows)
            if v is not None and v.dim() == 0:
                v = v.expand(b.num_rows)
            out.append((groupby.key_word(d), v))
        return out

    def _key_bound(self, dicts) -> Optional[int]:
        """An upper bound on the number of groups from the keys' domains
        alone (dictionary sizes and booleans, each with a null), or None
        when a key's domain is unbounded."""
        bound = 1
        for (_, e), d in zip(self.group_exprs, dicts):
            if d is not None:
                bound *= len(d) + 1
            elif e.dtype.kind == T.TypeKind.BOOLEAN:
                bound *= 3
            else:
                return None
        return bound

    def _execute_hash(self, ctx: ExecContext, batches
                      ) -> Iterator[ColumnBatch]:
        """The hash aggregation over every batch into one table, at one
        fetch for each time the table may have to grow, and one to
        compact a large table's output.  A partial aggregate emits its
        buffers, and starts a new table, once the host's bound on its
        groups passes the buffer row limit and one fetch confirms it (the
        reference's emit-when-over-limit, ``physical.py:1897-1922``)."""
        m = ctx.metric_set(self.op_id)
        device = ctx.device
        dicts = self._dicts()
        limit = self._buffer_row_limit(ctx.conf) \
            if self.mode == "partial" else None
        acc: Optional[groupby.HashAccumulator] = None
        emitted = False
        for b in batches:
            if b.num_rows == 0:
                continue
            with m.time("opTime"):
                ectx = EvalContext(_device_arrays(b), b.num_rows, device,
                                   active=b.sel)
                words = self._hash_key_words(b, ectx, dicts, device)
                contributions = self._contributions(ectx)
                if acc is None:
                    acc = groupby.HashAccumulator(
                        len(words), self._channels(contributions),
                        device)
                acc.key_bound = self._key_bound(dicts)
                acc.update(words, [v for v, _ in contributions], b.sel,
                           b.num_rows)
                over = limit is not None and acc.bound > limit \
                    and int(fetch(acc.ngroups)[0]) > limit
            if over:
                m.add("partialAggEmits", 1)
                self._keep_dicts(dicts)
                yield self._hash_output(m, acc, dicts)
                acc, emitted = None, True
        self._keep_dicts(dicts)
        if acc is not None:
            yield self._hash_output(m, acc, dicts)
        elif not emitted:
            yield self._empty()

    def _hash_output(self, m, acc: groupby.HashAccumulator, dicts,
                     groups: Optional[int] = None) -> ColumnBatch:
        """A hash table's groups as a batch: the keys from their words
        (strings as codes of their dictionaries), then the buffers or the
        finalized aggregates (``groups``: their count, when read)."""
        keys, values, live = acc.finish(groups)
        m.add("aggHashPath", 1)
        m.add("aggHashGrowths", acc.growths)
        cols: List = []
        for f, (word, valid), d in zip(self._schema.fields, keys, dicts):
            valid = valid if f.nullable else None
            if f.dtype.is_string:
                cols.append(DictStringColumn(word.to(torch.int32), valid,
                                             d.values()))
            else:
                cols.append(DeviceColumn(
                    f.dtype, groupby.key_from_word(word, f.dtype.torch_dtype),
                    valid))
        cols += self._value_columns(values)
        return ColumnBatch(self._schema, cols, keys[0][0].shape[0], live)

    # -- partial and final around an exchange (the reference's row 5') ---------
    def _buffer_row_limit(self, conf: TpuConf) -> int:
        """``sql.batchSizeBytes`` over the buffer row's width (string keys
        as 4-byte codes, reference ``physical.py:1910-1920``)."""
        width = 0
        for f in self._buffer_schema():
            if f.dtype.is_string:
                width += 4
            elif f.dtype.is_host_carried:
                width += 64
            else:
                width += np.dtype(f.dtype.numpy_dtype).itemsize * (
                    2 if f.dtype.is_wide_decimal else 1)
        return max(1, conf["spark.rapids.tpu.sql.batchSizeBytes"]
                   // max(width, 1))

    def _buffer_schema(self) -> Schema:
        fields = [Field(n, e.dtype, e.nullable) for n, e in self.group_exprs]
        return Schema(fields + [Field(f"{name}#buf{bi}", dt, True)
                                for name, agg in self.agg_exprs
                                for bi, (dt, _) in enumerate(agg.buffers())])

    def _key_values(self, b: ColumnBatch, ectx: EvalContext, dicts,
                    device) -> list:
        """Per group key its (data, valid): strings as int32 codes of the
        shared dictionaries, anything else evaluated."""
        from .planner import strip_alias
        out = []
        for k, (_, e) in enumerate(self.group_exprs):
            core = strip_alias(e)
            if core.dtype.is_string:
                dicts[k], codes, valid = encode_column(
                    b.columns[core.ordinal], dicts[k], device)
                out.append((codes, valid))
                continue
            d, v = e.eval(ectx)
            out.append((groupby._column(d, b.num_rows),
                        groupby._column(v, b.num_rows)))
        return out

    def _sample_group_ratio(self, b: ColumnBatch, dicts, device) -> float:
        """distinct / live of the group keys' 32-bit murmur3 hashes over
        the first ``min(num_rows, 2^18)`` rows of the first batch under
        its selection (reference :2006): ``csrc/group_ratio.cu``, both
        counts in one fetch."""
        from ..ops.hashing import hash_columns
        srows = min(b.num_rows, groupby.GR_MAX_ROWS)
        ectx = EvalContext(_device_arrays(b), b.num_rows, device,
                           active=b.sel)
        keys = [(d[:srows], None if v is None else v[:srows])
                for d, v in self._key_values(b, ectx, dicts, device)]
        h = hash_columns(keys)
        active = None if b.sel is None else b.sel[:srows]
        n_distinct, n_live = (int(x) for x in fetch(
            groupby.group_ratio(h, active)))
        return 0.0 if n_live == 0 else n_distinct / n_live

    def _pass_through(self, b: ColumnBatch, dicts, device) -> ColumnBatch:
        """One batch as buffer rows, unreduced: its keys and per-row
        contributions (a count's as 0/1, a FIRST/LAST value's ``has`` its
        qualifying mask) under the batch's selection (the reference's
        pass-through program :1884, elementwise: no kernel)."""
        n = b.num_rows
        ectx = EvalContext(_device_arrays(b), n, device, active=b.sel)
        cols: List = []
        for f, (d, v), dk in zip(self._schema.fields,
                                 self._key_values(b, ectx, dicts, device),
                                 dicts):
            v = v if f.nullable else None
            cols.append(DictStringColumn(d, v, dk.values())
                        if f.dtype.is_string else DeviceColumn(f.dtype, d, v))
        for (dt, op), ((d, v), _) in zip(self._buffers(),
                                         self._contributions(ectx)):
            v = groupby._column(groupby.kernel_op(op, v)[1], n)
            if d is None:  # a count: 1 where the row counts
                d = torch.ones(n, dtype=torch.int64, device=device) \
                    if v is None else v.to(torch.int64)
                v = None
            cols.append(DeviceColumn(dt, groupby._column(d, n), v))
        return ColumnBatch(self._schema, cols, n, b.sel)

    def _execute_partial(self, ctx: ExecContext, batches
                         ) -> Iterator[ColumnBatch]:
        """The partial aggregate: the skip probe on the first batch
        decides once; then every batch passes through unreduced
        (``skippedPartialAgg``), or the grid (bare string keys, sums) or
        the hash aggregation reduces the stream to buffer rows."""
        m = ctx.metric_set(self.op_id)
        device = ctx.device
        first = next(batches, None)
        if first is None:
            yield self._empty()
            return
        batches = itertools.chain([first], batches)
        skip = ctx.conf["spark.rapids.tpu.sql.agg.skipPartialAggRatio"]
        if skip < 1.0:
            dicts = self._dicts()
            with m.time("opTime"):
                ratio = self._sample_group_ratio(first, dicts, device)
            self._keep_dicts(dicts)
            if ratio > skip:
                m.add("skippedPartialAgg", 1)
                for b in batches:
                    with m.time("opTime"):
                        out = self._pass_through(b, dicts, device)
                    self._keep_dicts(dicts)
                    m.add("numOutputRows", b.num_rows)
                    yield out
                return
        if self._grid_static_ok():
            yield from self._execute_grid(ctx, batches)
        else:
            yield from self._execute_hash(ctx, batches)

    def _merge_channels(self) -> List[Tuple[str, bool]]:
        return [(groupby.merge_op(op), dt == T.FLOAT64)
                for dt, op in self._buffers()]

    def _execute_final(self, ctx: ExecContext, batches
                       ) -> Iterator[ColumnBatch]:
        """The final aggregate: buffer rows merged with their merge ops
        (``groupby.HashAccumulator.merge``, hash_agg.cu's merge entry, the
        reference's ``_merge_fn`` :2296) and finalized.  An exchange's
        output batches each hold whole groups, so each is merged and
        finalized alone (the reference's streaming final, :1805)."""
        from .exchange_exec import ShuffleExchangeExec
        m = ctx.metric_set(self.op_id)
        if isinstance(self.children[0], ShuffleExchangeExec):
            streams = ([b] for b in batches)
        else:
            streams = iter([batches])
        any_out = False
        for stream in streams:
            for out in self._merge_stream(ctx, m, stream):
                any_out = True
                m.add("numOutputRows", out.num_rows)
                yield out
        if not any_out:
            yield self._empty()

    def _merge_stream(self, ctx: ExecContext, m, batches
                      ) -> Iterator[ColumnBatch]:
        """Merge buffer batches into one table; once its groups pass the
        buffer row limit (a fetch confirms the host's bound), the table's
        groups and every later row split into ``agg.repartitionBuckets``
        disjoint buckets by ``xxhash64(keys) % n`` (``csrc/hashing.cu``,
        the reference's ``_split_by_key_hash`` :2169 and
        ``_merge_bucket`` :2194).  Past the host's bound, the table's
        bucket ids are computed at once, so one fetch reads the group
        count with the bucket counts.  Each bucket keeps its rows and
        merges them once, at the end, into a table sized for them (so no
        bucket table grows); one fetch of the bucket counts then raises on
        a bucket past the limit."""
        device = ctx.device
        nk = len(self.group_exprs)
        limit = self._buffer_row_limit(ctx.conf)
        dicts = self._dicts()
        channels = self._merge_channels()
        n_buckets = ctx.conf["spark.rapids.tpu.sql.agg.repartitionBuckets"]
        acc: Optional[groupby.HashAccumulator] = None
        groups: Optional[int] = None   # the table's count, once read
        buckets = None
        for b in batches:
            if b.num_rows == 0:
                continue
            with m.time("opTime"):
                ectx = EvalContext(_device_arrays(b), b.num_rows, device,
                                   active=b.sel)
                words = self._hash_key_words(b, ectx, dicts, device)
                bufs = [(c.data, c.valid) for c in b.columns[nk:]]
                if buckets is not None:
                    self._merge_buckets(buckets, words, bufs, b.sel,
                                        b.num_rows, device)
                    continue
                if acc is None:
                    acc = groupby.HashAccumulator(nk, channels, device)
                acc.key_bound = self._key_bound(dicts)
                acc.merge(words, bufs, b.sel, b.num_rows)
                groups = None
                if acc.bound <= limit:
                    continue
                # the whole table under its live mask: no fetch yet
                keys, values, live = acc.finish(compact=False)
                pids, counts = self._bucket_ids(keys, live, n_buckets,
                                                device)
                host = fetch(torch.cat([acc.ngroups, counts]))
                groups = int(host[0])
                if groups > limit:
                    m.add("aggRepartitions", 1)
                    buckets = [[] for _ in range(n_buckets)]
                    self._split(buckets, pids, host[1:], list(keys) + [
                        v if isinstance(v, tuple) else (v, None)
                        for v in values])
                    acc = None
        self._keep_dicts(dicts)
        if buckets is not None:
            accs = []
            for pieces in buckets:
                if not pieces:
                    continue
                cols = [_cat_values([p[0][j] for p in pieces])
                        for j in range(len(pieces[0][0]))]
                n = sum(p[1] for p in pieces)
                x = groupby.HashAccumulator(nk, channels, device)
                x.merge(cols[:nk], cols[nk:], None, n)
                accs.append(x)
            # a bucket of at most ``limit`` rows holds at most ``limit``
            # groups: only larger ones need their count read
            big = [x for x, pieces in zip(accs, [p for p in buckets if p])
                   if sum(r for _, r in pieces) > limit]
            counts = fetch([x.ngroups for x in big]) if big else []
            if any(int(c[0]) > limit for c in counts):
                raise RuntimeError(
                    "aggregate re-partition bucket overflowed "
                    "spark.rapids.tpu.sql.batchSizeBytes: raise the conf "
                    "(extreme key skew across hash buckets)")
            # the buckets' groups as one batch: one fetch downstream, not
            # one per bucket
            yield batch_utils.concat_batches(
                [self._hash_output(m, x, dicts) for x in accs])
        elif acc is not None:
            yield self._hash_output(m, acc, dicts, groups)

    def _bucket_ids(self, words, active, n_buckets: int, device):
        """(int32 bucket id per row, int64 [n + 1] counts on the device)
        of ``xxhash64(keys) % n_buckets`` over the keys in their own types
        (strings as codes), as the reference's ``_split_by_key_hash``
        hashes them (``csrc/hashing.cu``)."""
        from ..ops import hashing
        keys = [(w.to(torch.int32) if f.dtype.is_string else
                 groupby.key_from_word(w, f.dtype.torch_dtype), v)
                for f, (w, v) in zip(self._schema.fields, words)]
        counts = torch.zeros(n_buckets + 1, dtype=torch.int64, device=device)
        return hashing.xxhash64_mod(keys, n_buckets, active,
                                    counts=counts), counts

    @staticmethod
    def _split(buckets, pids, host_counts, cols) -> None:
        """Each bucket's run of ``cols`` rows, by one stable placement by
        bucket id (``ops/join.py partition_perm``)."""
        from ..ops import join
        nb = len(buckets)
        perm = join.partition_perm(pids, nb)
        starts = np.concatenate([[0], np.cumsum(host_counts[:nb])])
        for i, x in enumerate(buckets):
            lo, hi = int(starts[i]), int(starts[i + 1])
            if hi > lo:
                x.append((join.gather_rows(perm[lo:hi], cols,
                                           nullable=False), hi - lo))

    def _merge_buckets(self, buckets, words, bufs, active, n: int,
                       device) -> None:
        """A later batch's rows into the buckets: one fetch of its bucket
        counts."""
        pids, counts = self._bucket_ids(words, active, len(buckets), device)
        self._split(buckets, pids, fetch(counts), list(words) + list(bufs))

    def _empty(self) -> ColumnBatch:
        cols = []
        for f in self._schema:
            if f.dtype.is_string:
                cols.append(HostStringColumn(np.empty(0, dtype=object)))
            else:
                cols.append(HostColumn(f.dtype, np.empty(
                    (0, 2) if f.dtype.is_wide_decimal else 0,
                    f.dtype.numpy_dtype)))
        return ColumnBatch(self._schema, cols, 0)


# ---------------------------------------------------------------------------------
# Collect
# ---------------------------------------------------------------------------------

class CollectExec(TpuExec):
    def __init__(self, child: TpuExec):
        super().__init__([child])

    @property
    def output_schema(self) -> Schema:
        return self.children[0].output_schema

    def collect_rows(self, ctx: ExecContext) -> List[tuple]:
        """Every output row as a tuple of Python values; one counted fetch
        per device-resident output batch."""
        from ..batch import to_host
        rows: List[tuple] = []
        for b in self.children[0].execute(ctx):
            cols = [_python_values(c) for c in to_host(b)]
            rows.extend(zip(*cols) if cols else [])
        return rows


def _python_values(col: HostColumn) -> list:
    if col.dtype.is_nested:
        lists = col.data
        flat = _python_values(HostColumn(col.dtype.element, lists.values,
                                         lists.elem_valid))
        vals = lists.to_pylist(flat)
    elif col.dtype.is_decimal:
        from ..batch import decimal_values
        vals = decimal_values(col.dtype, col.data)
    elif col.dtype.kind == T.TypeKind.DATE:
        vals = col.data.astype("datetime64[D]").tolist()
    elif col.dtype.kind == T.TypeKind.TIMESTAMP:
        vals = col.data.astype("datetime64[us]").tolist()
    else:
        vals = col.data.tolist()
    if col.valid is not None:
        vals = [v if ok else None for v, ok in zip(vals, col.valid.tolist())]
    return vals
