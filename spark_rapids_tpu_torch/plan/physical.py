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
                     HostColumn, HostStringColumn, Schema, upload)
from ..config import TpuConf
from ..exprs import AggregateExpression, BoundReference, EvalContext, \
    Expression
from ..ops import batch_utils, groupby
from ..ops.strings import StringDictionary
from ..utils.metrics import MetricSet, QueryStats, fetch, fetch_scalars

__all__ = ["ExecContext", "TpuExec", "MemorySource", "ScanExec", "StageExec",
           "AggregateExec", "CollectExec"]


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
    the column, and one :class:`HostStringColumn` object per batch for
    string columns, so their cached dictionary encodings serve every run.
    """

    def __init__(self, columns: Dict[str, Tuple[T.DataType, np.ndarray,
                                                Optional[np.ndarray]]],
                 batch_rows: int, _cache: Optional[dict] = None):
        self.columns = columns
        self.batch_rows = batch_rows
        self.num_rows = len(next(iter(columns.values()))[1]) \
            if columns else 0
        self._cache = {} if _cache is None else _cache

    def schema(self) -> Schema:
        return Schema([Field(n, dt, valid is not None)
                       for n, (dt, _, valid) in self.columns.items()])

    def pruned(self, names: List[str]) -> "MemorySource":
        return MemorySource({n: self.columns[n] for n in names},
                            self.batch_rows, self._cache)

    def _host_tensor(self, key, arr: np.ndarray,
                     device: torch.device) -> torch.Tensor:
        t = self._cache.get(key)
        if t is None:
            t = torch.from_numpy(arr)
            if device.type == "cuda":
                t = t.pin_memory()
                self._cache[key] = t
        return t

    def _string_columns(self, name: str) -> List[HostStringColumn]:
        cols = self._cache.get(("str", name))
        if cols is None:
            _, data, valid = self.columns[name]
            cols = [HostStringColumn(
                data[off:off + self.batch_rows],
                None if valid is None else valid[off:off + self.batch_rows])
                for off in range(0, self.num_rows, self.batch_rows)]
            self._cache[("str", name)] = cols
        return cols

    def batches(self, device: torch.device) -> Iterator[ColumnBatch]:
        schema = self.schema()
        stats = QueryStats.get()
        for bi, off in enumerate(range(0, self.num_rows, self.batch_rows)):
            m = min(self.batch_rows, self.num_rows - off)
            timed = device.type == "cuda"
            if timed:
                start = torch.cuda.Event(enable_timing=True)
                start.record()
            cols, nbytes = [], 0
            for name, (dt, data, valid) in self.columns.items():
                if dt.is_host_carried:
                    cols.append(self._string_columns(name)[bi])
                    continue
                d = upload(self._host_tensor(("data", name), data,
                                             device)[off:off + m], device)
                v = None if valid is None else upload(self._host_tensor(
                    ("valid", name), valid, device)[off:off + m], device)
                nbytes += d.nbytes + (0 if v is None else v.nbytes)
                cols.append(DeviceColumn(dt, d, v))
            if timed:
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                stats.upload_events.append((start, end))
            stats.uploads += 1
            stats.upload_bytes += nbytes
            yield ColumnBatch(schema, cols, m)


class ScanExec(TpuExec):
    def __init__(self, schema: Schema, source: MemorySource):
        super().__init__()
        self._schema = schema
        self.source = source

    @property
    def output_schema(self) -> Schema:
        return self._schema

    def execute(self, ctx: ExecContext) -> Iterator[ColumnBatch]:
        m = ctx.metric_set(self.op_id)
        for b in self.source.batches(ctx.device):
            m.add("numOutputRows", b.num_rows)
            yield b


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
        self.steps, self.host_exprs = lower_string_predicate_steps(steps)
        self._schema = output_schema

    @property
    def output_schema(self) -> Schema:
        return self._schema

    def run_batch(self, b: ColumnBatch, device: torch.device,
                  ansi: bool) -> Tuple[ColumnBatch, List[torch.Tensor]]:
        """One batch through the steps → (output batch, ANSI error masks)."""
        from .stringpred import host_predicate_column
        cur = _device_arrays(b)
        host = list(b.columns)
        active = b.sel
        errors: List[torch.Tensor] = []
        extras = [host_predicate_column(e, b.columns[o], device)
                  for e, o in self.host_exprs]
        for kind, payload in self.steps:
            ctx = EvalContext(cur, b.num_rows, device, active=active,
                              ansi=ansi, extras=extras)
            if kind == "filter":
                d, v = payload.eval(ctx)
                keep = d if v is None else d & v
                keep = keep.expand(b.num_rows) if keep.dim() == 0 else keep
                active = keep if active is None else active & keep
            else:
                cur = [None if e is None else e.eval(ctx)
                       for _, e, _ in payload]
                host = [host[src] if e is None else None
                        for _, e, src in payload]
            errors += ctx.errors
        cols = []
        for f, val, h in zip(self._schema, cur, host):
            if val is None:
                cols.append(h)
                continue
            d, v = val
            if d.dim() == 0:  # a literal projection
                d = d.expand(b.num_rows).contiguous()
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
    """Aggregation over all input batches, in one of three device paths:

    * ungrouped: every batch's contributions go through
      ``groupby.ungrouped_reduce`` (the masked_reduce kernel) into one
      K-slot accumulator;
    * grouped on bare key columns of which one is integral, every buffer a
      sum/min/max: dense direct addressing on that primary key
      (``groupby.DenseAccumulator``, the dense_agg kernel), with the other
      keys as residual channels, as the reference's
      ``_try_dense_grouped_multi`` (:1321) and ``_try_dense_grouped``
      (:1084) do;
    * grouped, when every key is a bare string column and every buffer is
      a sum: the dense grid of dictionary codes (``grid_group_reduce``,
      the grid_agg kernel), as the reference does at
      ``plan/physical.py:1736-1790``.

    Other grouped aggregations, and input the dense path rejects, need the
    sort-based path, which is not ported yet, and raise
    ``NotImplementedError``."""

    def __init__(self, child: TpuExec,
                 group_exprs: List[Tuple[str, Expression]],
                 agg_exprs: List[Tuple[str, AggregateExpression]]):
        super().__init__([child])
        self.group_exprs = group_exprs
        self.agg_exprs = agg_exprs
        self._schema = Schema(
            [Field(n, e.dtype, e.nullable) for n, e in group_exprs]
            + [Field(n, a.dtype, a.nullable) for n, a in agg_exprs])

    @property
    def output_schema(self) -> Schema:
        return self._schema

    def _buffers(self) -> List[Tuple[T.DataType, str]]:
        return [buf for _, agg in self.agg_exprs for buf in agg.buffers()]

    def _contributions(self, ectx: EvalContext):
        ops = [op for _, op in self._buffers()]
        vals = [c for _, agg in self.agg_exprs for c in agg.update(ectx)]
        return list(zip(vals, ops))

    def _finalize(self, buffer_values: List[torch.Tensor]):
        """Per aggregate, finalize its buffers' values (tensors of the
        same shape) → [(data, valid)]."""
        outs, i = [], 0
        for _, agg in self.agg_exprs:
            nb = len(agg.buffers())
            data, valid = agg.finalize([(v, None)
                                        for v in buffer_values[i:i + nb]])
            outs.append((data.to(agg.dtype.torch_dtype), valid))
            i += nb
        return outs

    def execute(self, ctx: ExecContext) -> Iterator[ColumnBatch]:
        if not self.group_exprs:
            yield self._execute_ungrouped(ctx)
        elif self._dense_static_ok(ctx.conf):
            yield self._execute_dense(ctx)
        else:
            yield self._execute_grid(ctx)

    # -- ungrouped ----------------------------------------------------------------
    def _execute_ungrouped(self, ctx: ExecContext) -> ColumnBatch:
        m = ctx.metric_set(self.op_id)
        specs = [(op, dt == T.FLOAT64) for dt, op in self._buffers()]
        acc_f, acc_i = groupby.init_scalars(specs, ctx.device)
        for b in self.children[0].execute(ctx):
            with m.time("opTime"):
                active = b.active_mask(ctx.device)
                ectx = EvalContext(_device_arrays(b), b.num_rows, ctx.device,
                                   active=active)
                groupby.ungrouped_reduce(self._contributions(ectx), active,
                                         acc_f, acc_i)
        values = [acc_f[j] if f else acc_i[j]
                  for j, (_, f) in enumerate(specs)]
        cols = []
        for (name, agg), (data, valid) in zip(self.agg_exprs,
                                              self._finalize(values)):
            cols.append(DeviceColumn(
                agg.dtype, data.reshape(1),
                None if valid is None else valid.reshape(1)))
        m.add("numOutputRows", 1)
        return ColumnBatch(self._schema, cols, 1)

    # -- grouped: the dense grid of dictionary codes ------------------------------
    def _grid_key_ordinals(self) -> List[int]:
        from .planner import strip_alias
        ords = []
        for name, e in self.group_exprs:
            core = strip_alias(e)
            if not (isinstance(core, BoundReference) and core.dtype.is_string):
                raise NotImplementedError(
                    f"group key {name}: only bare string columns group on the "
                    f"dense grid; the sort-based grouped aggregation is not "
                    f"ported yet (ROADMAP.md, modules to port, item 4)")
            ords.append(core.ordinal)
        if any(op != "sum" for _, op in self._buffers()):
            raise NotImplementedError(
                "min/max over groups needs the sort-based grouped "
                "aggregation, which is not ported yet (ROADMAP.md, modules "
                "to port, item 4)")
        return ords

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

    @staticmethod
    def _encode(col: HostStringColumn, d: Optional[StringDictionary],
                device: torch.device):
        """(dictionary, device codes, device valid) of a host string column,
        cached on the column object.  A query with no dictionary yet
        adopts the cached one (its codes are valid verbatim)."""
        if not isinstance(col, HostStringColumn):
            raise NotImplementedError(
                "grouping on dictionary codes that arrive from a join (a "
                "second dictionary to merge) is not ported yet (ROADMAP.md, "
                "modules to port, item 4)")
        cached = col._enc_cache
        if cached is not None and cached[1].device == device \
                and (d is None or cached[0] is d):
            return cached
        d = d if d is not None else StringDictionary()
        codes, valid = d.encode(col.data, col.valid)
        col._enc_cache = (d, upload(torch.from_numpy(codes), device),
                          None if valid is None
                          else upload(torch.from_numpy(valid), device))
        return col._enc_cache

    def _execute_grid(self, ctx: ExecContext) -> ColumnBatch:
        m = ctx.metric_set(self.op_id)
        ords = self._grid_key_ordinals()
        grid_max = ctx.conf["spark.rapids.tpu.sql.agg.gridMaxGroups"]
        dicts: List[Optional[StringDictionary]] = [None] * len(ords)
        acc: Optional[groupby.GridAccumulator] = None
        for b in self.children[0].execute(ctx):
            with m.time("opTime"):
                keys = []
                for k, o in enumerate(ords):
                    dicts[k], codes, valid = self._encode(b.columns[o],
                                                          dicts[k],
                                                          ctx.device)
                    keys.append((codes, valid))
                # padded dictionary sizes: the grid grows only when a
                # dictionary passes a power of two
                dims = tuple(1 << max(len(d) - 1, 0).bit_length()
                             for d in dicts)
                if groupby.grid_size(dims) > grid_max:
                    raise NotImplementedError(
                        f"the dense grid of dims {dims} exceeds "
                        f"spark.rapids.tpu.sql.agg.gridMaxGroups={grid_max};"
                        f" the sort-based grouped aggregation is not ported "
                        f"yet (ROADMAP.md, modules to port, item 4)")
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
        if acc is None:
            return self._empty()
        # observed slots packed to the front, in slot (key code) order
        observed = acc.cnt > 0
        pack = torch.argsort((~observed).to(torch.int8), stable=True)
        cols: List = []
        for (codes, valid), d in zip(acc.slot_codes(), dicts):
            cols.append(DictStringColumn(codes[pack], valid[pack], d.values()))
        for (name, agg), (data, valid) in zip(
                self.agg_exprs, self._finalize(acc.values())):
            cols.append(DeviceColumn(agg.dtype, data[pack],
                                     None if valid is None else valid[pack]))
        out = ColumnBatch(self._schema, cols, acc.G, observed[pack])
        bound = 1
        for d in dicts:
            bound *= len(d) + 1
        return batch_utils.compact_packed(out, bound)

    # -- grouped: dense direct addressing on an integral primary key ----------
    def _key_refs(self) -> List[Optional[BoundReference]]:
        from .planner import strip_alias
        return [e if isinstance(e, BoundReference) else None
                for e in (strip_alias(e) for _, e in self.group_exprs)]

    def _dense_static_ok(self, conf: TpuConf) -> bool:
        """The reference's static gates of its dense paths
        (``_dense_agg_static_ok`` :1061 for one key,
        ``_dense_residual_static_ok`` :1288 for several): every key a bare
        column, one of them integral, every buffer a sum/min/max."""
        if not conf["spark.rapids.tpu.sql.agg.dense.enabled"] \
                or not conf["spark.rapids.tpu.join.denseDomainCap"]:
            return False
        if any(op not in ("sum", "min", "max") for _, op in self._buffers()):
            return False
        refs = self._key_refs()
        if any(r is None or r.dtype is None for r in refs):
            return False
        kinds = ["s" if r.dtype.is_string else
                 np.dtype(r.dtype.numpy_dtype).kind for r in refs]
        if len(refs) == 1:
            return kinds[0] in "iu"
        return all(k in "iufbs" for k in kinds) and any(k in "iu"
                                                      for k in kinds)

    def _dense_key_values(self, b: ColumnBatch, dicts, device):
        """Per group key, its (int32/int64 data, valid) for the dense
        kernels: strings as dictionary codes, booleans and narrow ints
        as int32."""
        out = []
        for k, ref in enumerate(self._key_refs()):
            col = b.columns[ref.ordinal]
            if ref.dtype.is_string:
                dicts[k], codes, valid = self._encode(col, dicts[k], device)
                out.append((codes, valid))
                continue
            if ref.dtype.is_floating:
                raise NotImplementedError(
                    f"group key {self.group_exprs[k][0]}: a floating-point "
                    f"key beside an integral one needs the sort-based "
                    f"grouped aggregation, which is not ported yet "
                    f"(ROADMAP.md, modules to port, item 4)")
            d = col.data
            if d.dtype not in (torch.int32, torch.int64):
                d = d.to(torch.int32)
            out.append((d, col.valid))
        return out

    def _dense_channels(self, contributions) -> List[Tuple[str, bool]]:
        chans = []
        for (dt, op), ((d, _), _) in zip(self._buffers(), contributions):
            is_f64 = dt == T.FLOAT64
            if is_f64 and op != "sum":
                raise NotImplementedError(
                    f"float64 {op} over groups needs the sort-based grouped "
                    f"aggregation, which is not ported yet (ROADMAP.md, "
                    f"modules to port, item 4)")
            chans.append(("count" if d is None else op, is_f64))
        return chans

    @staticmethod
    def _reject(why: str) -> NotImplementedError:
        return NotImplementedError(
            f"the dense grouped aggregation rejects this input ({why}); the "
            f"sort-based grouped aggregation it would fall back to is not "
            f"ported yet (ROADMAP.md, modules to port, item 4)")

    def _execute_dense(self, ctx: ExecContext) -> ColumnBatch:
        """The reference's ``_try_dense_grouped_multi`` (:1321) and, for one
        key, ``_try_dense_grouped`` (:1084), through the dense_agg kernel.

        One fetch reads the first batch's key stats and the functional-
        dependence probe; the primary key is the integral candidate with
        the smallest domain whose values each map to one key tuple.  Every
        batch then scatters into ONE accumulator; rows outside the first
        batch's (padded) domain wait in the overflow buffer, and the tail
        fetch (violation flag, group count, overflow count and key range)
        decides whether to widen the domain once and replay them, at one
        more fetch.  The output is compacted to the observed groups, in key
        order, with the null key last."""
        m = ctx.metric_set(self.op_id)
        conf, device = ctx.conf, ctx.device
        refs = self._key_refs()
        n_keys = len(refs)
        cap = conf["spark.rapids.tpu.join.denseDomainCap"]
        cand = [not r.dtype.is_string
                and np.dtype(r.dtype.numpy_dtype).kind in "iu" for r in refs]
        dicts: List[Optional[StringDictionary]] = [None] * n_keys
        seen: List[Tuple[ColumnBatch, list]] = []
        best = None
        batches = self.children[0].execute(ctx)
        for b in batches:
            with m.time("opTime"):
                kv = self._dense_key_values(b, dicts, device)
                seen.append((b, kv))
                stats, fd = groupby.dense_key_stats(kv, cand, b.sel)
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
                    best = (kmax - kmin + 1, i, kmin)
            if best is None:
                raise self._reject(
                    f"no integral key has a domain within "
                    f"spark.rapids.tpu.join.denseDomainCap={cap} and "
                    f"determines the others")
            break
        if not seen:
            return self._empty()
        # no valid primary in the whole input: every row has a null key
        domain, pidx, kmin = best if best is not None \
            else (1, cand.index(True), 0)
        res_idx = [i for i in range(n_keys) if i != pidx]
        n_bufs = len(self._buffers())

        def check_size(D):
            est = D * (len(res_idx) * 18 + 2 + 8 * n_bufs)
            if n_keys > 1 and \
                    est > conf["spark.rapids.tpu.sql.agg.dense.maxAccumBytes"]:
                raise self._reject(
                    f"{est} accumulator bytes exceed "
                    f"spark.rapids.tpu.sql.agg.dense.maxAccumBytes")

        # the first batch's exact span: keys beyond it overflow and widen
        D = domain
        check_size(D)
        acc = None
        m.add("aggDensePath", 1)
        for b, kv in itertools.chain(seen, ((b, None) for b in batches)):
            with m.time("opTime"):
                if kv is None:
                    kv = self._dense_key_values(b, dicts, device)
                ectx = EvalContext(_device_arrays(b), b.num_rows, device,
                                   active=b.sel)
                contributions = self._contributions(ectx)
                if acc is None:
                    acc = groupby.DenseAccumulator(
                        kmin, D, len(res_idx),
                        self._dense_channels(contributions), device)
                acc.update(kv[pidx], [kv[i] for i in res_idx],
                           [v for v, _ in contributions], b.sel)
        violated, n_groups, n_over, omin, omax = (
            int(x) for x in fetch(acc.tail()))
        if n_over:
            if n_over > acc.cap:
                raise self._reject(
                    f"{n_over} rows fall outside the first batch's key "
                    f"domain, more than the overflow buffer's {acc.cap}")
            lo, hi = min(acc.kmin, omin), max(acc.kmin + acc.D - 1, omax)
            if hi - lo + 1 > cap:
                raise self._reject(
                    f"the widened key domain {hi - lo + 1} exceeds "
                    f"spark.rapids.tpu.join.denseDomainCap={cap}")
            D = hi - lo + 1
            check_size(D)
            acc.widen(lo, D)
            acc.replay_overflow(n_over)
            m.add("aggDenseWidened", 1)
            violated, n_groups = (int(x) for x in fetch(acc.check()))
        if violated:
            raise self._reject("a residual key takes two values, or null "
                               "and non-null, under one primary key")
        return self._dense_output(acc, pidx, res_idx, dicts, n_groups)

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
                r = res_idx.index(i)
                data, valid = acc.vmin[r], acc.vdmax[r] == 1
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

    def _empty(self) -> ColumnBatch:
        cols = []
        for f in self._schema:
            if f.dtype.is_string:
                cols.append(HostStringColumn(np.empty(0, dtype=object)))
            else:
                cols.append(HostColumn(f.dtype,
                                       np.empty(0, f.dtype.numpy_dtype)))
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
    if col.dtype.kind == T.TypeKind.DATE:
        vals = col.data.astype("datetime64[D]").tolist()
    elif col.dtype.kind == T.TypeKind.TIMESTAMP:
        vals = col.data.astype("datetime64[us]").tolist()
    else:
        vals = col.data.tolist()
    if col.valid is not None:
        vals = [v if ok else None for v, ok in zip(vals, col.valid.tolist())]
    return vals
