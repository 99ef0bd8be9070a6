"""Equi-joins: the broadcast join (dense, CSR and sorted paths) and the
shuffled sort-merge join with its runtime broadcast flip.

Counterpart of ``spark_rapids_tpu/plan/join_exec.py``:

* ``BroadcastExchangeExec`` (:62 ``materialize_whole``): the build side,
  materialized once as one batch, selection masks kept.
* ``BroadcastJoinExec`` (:842): a streamed probe side against the build.
  Its static gate (``_dense_static_ok`` :1145: one key with an integer
  image — integers, dates, dictionary codes of strings, floats as
  ``_float_orderable`` images — an inner join on either side or a left,
  semi or anti join building the right, a probe estimated at
  ``denseMinProbeRows`` or more) sends a join to the stats fetch
  (``_dense_prefetch`` :1200), which picks the dense table for unique keys
  (``_dense_join_pair`` :1410), the CSR tables for repeated keys
  (``_csr_match_state`` :1040), and the sorted path for a key domain over
  ``denseDomainCap``.  Every other join — several keys, a right join, a
  small probe — takes the sorted path directly (``_match_state`` :932):
  the build sorted once, each probe batch searched.
* ``SortMergeJoinExec`` (:122): over two ``ShuffleExchangeExec``\\ s it
  first tries the runtime flip (``_try_runtime_broadcast`` :295), else
  joins the partitions pairwise, splitting a pair over ``batchSizeRows``
  by xxhash64 (``_sub_partition_join`` :362); without exchanges
  (``exchange.enabled`` false) it joins the two sides whole.  A pair joins
  through the sorted match state (``_match_state`` :626): inner, left,
  right (a mirrored left join), full (the build rows no probe row matched
  appended after the expansion, ``_unmatched_build_mask`` :750,
  ``_append_unmatched_build`` :773, on the device), semi and anti.

The phases run through ``ops/join.py`` and its kernels ``csrc/dense_join
.cu``, ``csrc/csr_join.cu`` and ``csrc/sort_join.cu``.  Inner, left and
right outputs that expand read their size in one fetch per probe batch
(per partition pair), a full join's unmatched count riding in the same
fetch; semi, anti and dense probes pass the probe batch through under a
selection mask with no fetch.  String keys compare as codes of one
dictionary per key shared by both sides and their exchanges (the
reference's ``shared_dicts``); string payload columns ride as dictionary
codes.  USING keys of right and full joins coalesce across the sides
(``_assemble`` :793).

Joins that match on more than key equality (``csrc/cond_join.cu``):

* a residual condition on a left, semi, anti, existence, right or full
  join takes part in the matching (``_conditioned_probe_join`` :446):
  every candidate pair of the sorted match state (one fetch of their
  number), the condition over the pair columns, the surviving pairs
  counted per probe row and per build row; semi, anti and existence read
  the probe counts, outer joins pad the rows no surviving pair holds.  The
  runtime flip stays off for such joins (:304), and the dense and CSR
  paths do not take them (:1145), as in the reference.
* an inner join's condition filters its output (``_apply_residual``
  :576), on every path;
* an existence join keeps every probe row and adds the match flag
  (``_existence`` :617): the semi modes' selection;
* a cross join pairs every left row with every right row (``_cross``
  :827), broadcast or its sides whole.

Runtime join filters (row 15, ``csrc/key_stats.cu`` through
``ops/runtime_filter.py``): when ``dpp.enabled`` is set and a join's other
side passes its key unchanged from a file scan (``_scan_origin`` :1726),
the build keys' min, max, counts and sorted distinct prefix become
predicates on that scan (``_runtime_key_preds`` :1700: an empty IN list
for an empty build, the exact IN list up to ``dpp.maxInKeys`` distinct
keys, else the key range), which prune its row groups and filter its rows
on the host before the upload; the join still matches every row, so no
result changes:

* a broadcast inner or semi join on the dense path (``_inject_dpp``
  :1522) computes them in place of the dense stats, and they ride its
  probe chain's one stats fetch; the scan resolves them at its first read;
* a sort-merge join that joins its sides whole (``_inject_smj_filter``
  :161: inner, left, semi, anti and existence) computes them over its
  materialized left side and reads them in one fetch before it reads its
  right side.

Neither runs for an in-memory scan, so those paths keep their launches.
"""

from __future__ import annotations

import datetime
from typing import Dict, Iterator, List, Optional

import torch

from .. import types as T
from ..batch import ColumnBatch, DeviceColumn, DictStringColumn, Schema
from ..exprs import BoundReference, EvalContext, bind
from ..batch import live_mask
from ..ops import batch_utils, hashing, join, runtime_filter
from ..ops.strings import StringDictionary, encode_column
from ..utils.metrics import fetch
from . import logical as L
from .planner import strip_alias
from .cbo import estimate_rows, estimated_bytes
from .exchange_exec import (ShuffleExchangeExec, _encoded, empty_batch,
                            key_values, split_by_pid)
from .physical import ExecContext, ScanExec, StageExec, TpuExec

__all__ = ["BroadcastExchangeExec", "BroadcastJoinExec", "SortMergeJoinExec",
           "bound_join_keys", "plan_broadcast_join"]

_CANON = {"left_outer": "left", "right_outer": "right", "full_outer": "full",
          "left_semi": "semi", "left_anti": "anti"}
# sides that may be broadcast: never the row-preserving side; a full join
# preserves both
_LEGAL_BUILD_SIDES = {"inner": (1, 0), "cross": (1, 0), "left": (1,),
                      "semi": (1,), "anti": (1,), "existence": (1,),
                      "right": (0,), "full": ()}
_OUTER = ("left", "right", "full")


def canon_how(how: str) -> str:
    return _CANON.get(how, how)


def bound_join_keys(plan: L.Join, lsch: Schema, rsch: Schema):
    """Both sides' join keys bound, and the common type of each pair: the
    one place the exchanges and the join learn which values they hash and
    compare (a divergence would send equal keys to different
    partitions)."""
    lk = [bind(k, lsch) for k in plan.left_keys]
    rk = [bind(k, rsch) for k in plan.right_keys]
    common = [a.dtype if a.dtype == b.dtype or a.dtype.is_string
              else T.common_type(a.dtype, b.dtype) for a, b in zip(lk, rk)]
    return lk, rk, common


class BroadcastExchangeExec(TpuExec):
    """The build side, materialized once as one batch: every child batch
    concatenated, selection masks kept (the build kernels fold them in, so
    no live count is fetched)."""

    def __init__(self, child: TpuExec):
        super().__init__([child])

    @property
    def output_schema(self) -> Schema:
        return self.children[0].output_schema

    def node_desc(self) -> str:
        return "TpuBroadcastExchange"

    def materialize(self, ctx: ExecContext) -> ColumnBatch:
        m = ctx.metric_set(self.op_id)
        with m.time("buildTime"):
            return _whole(self.children[0], ctx)

    def execute(self, ctx: ExecContext) -> Iterator[ColumnBatch]:
        yield self.materialize(ctx)


def _whole(child: TpuExec, ctx: ExecContext) -> ColumnBatch:
    parts = [b for b in child.execute(ctx) if b.num_rows > 0]
    if not parts:
        return empty_batch(child.output_schema, ctx.device)
    if len(parts) > 1:
        parts = _shared_codes(parts, ctx.device)
    return batch_utils.concat_batches(parts)


def _shared_codes(parts: List[ColumnBatch], device) -> List[ColumnBatch]:
    """``parts`` with every string column as codes of one dictionary per
    column, so they concatenate on the device.  Each part's encoding is
    cached on its column object (``encode_column``): a warm run encodes
    nothing, where concatenating the host strings would make a new column,
    and so a new encoding, every run."""
    cols = [list(b.columns) for b in parts]
    for i, f in enumerate(parts[0].schema):
        first = parts[0].columns[i]
        if not f.dtype.is_string or all(
                isinstance(b.columns[i], DictStringColumn)
                and isinstance(first, DictStringColumn)
                and b.columns[i].dictionary is first.dictionary
                for b in parts):
            continue
        d, enc = None, []
        for b in parts:
            d, codes, valid = encode_column(b.columns[i], d, device)
            enc.append((codes, valid))
        values = d.values()
        for c, (codes, valid) in zip(cols, enc):
            c[i] = DictStringColumn(codes, valid, values)
    return [ColumnBatch(b.schema, c, b.num_rows, b.sel)
            for b, c in zip(parts, cols)]


class _StagedExec(TpuExec):
    """The staged input of an exchange, replayed (the flipped join's
    build)."""

    def __init__(self, schema: Schema, batches: List[ColumnBatch]):
        super().__init__()
        self._schema = schema
        self._batches = batches

    @property
    def output_schema(self) -> Schema:
        return self._schema

    def node_desc(self) -> str:
        return "TpuAQEStagedInput"

    def execute(self, ctx: ExecContext) -> Iterator[ColumnBatch]:
        batches, self._batches = self._batches, []
        yield from batches


def _device_values(col, device):
    """(data, valid, dictionary or None) of a column on the device:
    string columns as int32 dictionary codes."""
    if isinstance(col, DeviceColumn):
        return col.data, col.valid, None
    if isinstance(col, DictStringColumn):
        return col.codes, col.valid, col.dictionary
    d, codes, valid = encode_column(col, None, device)
    return codes, valid, d.values()


def _column(dtype: T.DataType, data, valid, dictionary):
    if dictionary is not None:
        return DictStringColumn(data, valid, dictionary)
    return DeviceColumn(dtype, data, valid)


def _runtime_key_preds(scol: str, ct: T.DataType, kmin: int, kmax: int,
                       n_valid: int, n_distinct: int, conf,
                       values_fn) -> list:
    """The predicates a runtime join filter pushes (reference :1700): an
    empty IN list for an empty build, the exact IN list up to
    ``dpp.maxInKeys`` distinct keys, else the key range.  ``values_fn()``
    gives the distinct key images (None: too many)."""
    is_date = ct.kind == T.TypeKind.DATE

    def conv(v):
        if is_date:
            return datetime.date(1970, 1, 1) + datetime.timedelta(days=int(v))
        return int(v)

    if n_valid == 0:
        return [(scol, "in", [])]
    preds = [(scol, ">=", conv(kmin)), (scol, "<=", conv(kmax))]
    max_in = conf["spark.rapids.tpu.sql.dpp.maxInKeys"]
    if 0 < n_distinct <= max_in and values_fn is not None:
        vals = values_fn()
        if vals is not None and len(vals) <= max_in:
            preds = [(scol, "in", [conv(v) for v in vals])]
    return preds


def _scan_origin(node: TpuExec, out_name: str):
    """(file ScanExec, its column) that output column ``out_name`` of
    ``node`` passes through from unchanged, through stages' projections
    (reference :1726); None when a step computes it or the scan is not a
    file scan."""
    name = out_name
    while True:
        if isinstance(node, StageExec):
            cur = list(node.children[0].output_schema.names())
            maps = []  # per projection: output name -> input name
            for kind, payload in node.steps:
                if kind != "project":
                    continue
                mp = {}
                for pname, expr, _ in payload:
                    if expr is None:
                        continue  # host pass-through: strings, not keys
                    core = strip_alias(expr)
                    if isinstance(core, BoundReference) \
                            and core.ordinal < len(cur):
                        mp[pname] = cur[core.ordinal]
                maps.append(mp)
                cur = [pname for pname, _, _ in payload]
            for mp in reversed(maps):
                name = mp.get(name)
                if name is None:
                    return None
            node = node.children[0]
            continue
        if isinstance(node, ScanExec) and hasattr(node.source,
                                                  "with_pushdown"):
            return (node, name) if name in node.output_schema.names() \
                else None
        return None


def _integral_key(ct: T.DataType) -> bool:
    """Keys a runtime filter takes: integers and dates (reference: numpy
    kind ``iu``)."""
    if ct.is_host_carried or ct.is_wide_decimal:
        return False
    return ct.numpy_dtype.kind in "iu"


def _filter_target(plan_side: TpuExec, key, conf):
    """(scan, scan column) a runtime filter on bound key ``key`` of the
    side ``plan_side`` pushes into, or None."""
    if not conf["spark.rapids.tpu.sql.dpp.enabled"]:
        return None
    core = strip_alias(key)
    if not isinstance(core, BoundReference):
        return None
    return _scan_origin(plan_side,
                        plan_side.output_schema.names()[core.ordinal])


class _EquiJoin(TpuExec):
    """What both joins share: the bound keys, their common types and the
    shared string dictionaries, the sorted match state and the assembly
    of expanded output rows."""

    def __init__(self, plan: L.Join, left: TpuExec, right: TpuExec,
                 string_dicts: Optional[Dict[int, StringDictionary]]):
        super().__init__([left, right])
        self.plan = plan
        self.how = canon_how(plan.how)
        if self.how not in _LEGAL_BUILD_SIDES:
            raise ValueError(f"unknown join type {plan.how!r}")
        self.condition = plan.condition
        self.using = list(plan.using)
        self._schema = plan.schema()
        lk, rk, self.common = bound_join_keys(plan, left.output_schema,
                                              right.output_schema)
        self.key_exprs = (lk, rk)
        self.string_dicts = {} if string_dicts is None else string_dicts

    @property
    def output_schema(self) -> Schema:
        return self._schema

    def _keys(self, side: int, b: ColumnBatch, device) -> list:
        """Side ``side``'s key values over ``b`` in their common types
        (strings as codes of the shared dictionaries)."""
        out = []
        for (d, v), ct in zip(key_values(self.key_exprs[side], b, device,
                                         self.string_dicts), self.common):
            if not ct.is_string and d.dtype != ct.torch_dtype:
                d = d.to(ct.torch_dtype)
            out.append((d, v))
        return out

    def _sorted_join(self, probe: ColumnBatch, build: ColumnBatch,
                     probe_side: int, state: join.SortedBuild, device
                     ) -> Optional[ColumnBatch]:
        """One probe batch against a sorted build: semi and anti as a
        selection, the rest expanded (one fetch of the output size; a full
        join's unmatched build count rides in it).  None: no output row."""
        how = self.how
        pkeys = self._keys(probe_side, probe, device)
        lo, matches, got = join.sorted_probe(
            pkeys, probe.sel, state, "semi" if how == "existence" else how)
        if how in ("semi", "anti", "existence"):
            return self._flagged(probe, got)
        offsets = got
        if how == "full":
            unmatched, count = join.unmatched_build_mask(lo, matches, state,
                                                         build.sel)
            total, extra = (int(x) for x in fetch(
                torch.cat([offsets[-1:], count])))
        else:
            total, extra = int(fetch(offsets[-1:])[0]), 0
        if total + extra == 0:
            return None
        pi, bi = join.csr_expand(offsets, lo, state.b_perm, total)
        if extra:
            rows = torch.arange(build.num_rows, dtype=torch.int32,
                                device=device)
            tail = batch_utils.compact_columns([(rows, None)], unmatched,
                                               extra)[0][0]
            pi = torch.cat([pi, torch.full((extra,), -1, dtype=pi.dtype,
                                           device=device)])
            bi = torch.cat([bi, tail])
        return self._residual(self._assemble_maps(
            probe, build, probe_side, pi, bi, total + extra, device), device)

    def _flagged(self, probe: ColumnBatch, matched) -> ColumnBatch:
        """A semi or anti join's probe rows under the selection
        ``matched`` (bool per probe row: the anti selection for an anti
        join); an existence join's every probe row with ``matched`` as
        its ``exists`` column."""
        if self.how != "existence":
            return ColumnBatch(self._schema, probe.columns, probe.num_rows,
                               matched)
        return ColumnBatch(self._schema, list(probe.columns)
                           + [DeviceColumn(T.BOOLEAN, matched, None)],
                           probe.num_rows, probe.sel)

    def _residual(self, out: ColumnBatch, device) -> ColumnBatch:
        """An inner join's output under its residual condition
        (``_apply_residual`` :576): the condition over the output's
        columns ANDed into the selection."""
        if self.condition is None:
            return out
        keep = _condition_mask(bind(self.condition, out.schema), out.columns,
                               out.num_rows, device)
        return ColumnBatch(out.schema, out.columns, out.num_rows,
                           keep if out.sel is None else out.sel & keep)

    def _conditioned(self, probe: ColumnBatch, build: ColumnBatch, device,
                     state: Optional[join.SortedBuild] = None
                     ) -> ColumnBatch:
        """A left, semi, anti, existence, right or full join whose residual
        condition takes part in the matching (``_conditioned_probe_join``
        :446): the left side probes, the right side builds (``state``, its
        sorted keys, when the caller keeps them across batches).  One fetch
        reads the number of candidate pairs."""
        how = self.how
        if state is None:
            state = join.sorted_build(self._keys(1, build, device), build.sel)
        lo, _, offsets = join.sorted_probe(self._keys(0, probe, device),
                                           probe.sel, state, "inner")
        total = int(fetch(offsets[-1:])[0])
        pi, bi = join.cond_expand(offsets, lo, state.b_perm, total)
        cond = bind(self.condition, Schema.pair(probe.schema, build.schema))
        refs = _ordinals(cond)
        np_ = len(probe.schema.fields)
        cols: List = [None] * (np_ + len(build.schema.fields))
        for batch, idx, base in ((probe, pi, 0), (build, bi, np_)):
            at = [i for i in range(len(batch.columns)) if base + i in refs]
            vals = [_device_values(batch.columns[i], device) for i in at]
            got = join.gather_rows(idx, [(d, v) for d, v, _ in vals], False)
            for i, (d, v), (_, _, dct) in zip(at, got, vals):
                cols[base + i] = _column(batch.schema.fields[i].dtype, d, v,
                                         dct)
        keep = _condition_mask(cond, cols, total, device)
        pc, bc = join.cond_counts(keep, pi, bi, probe.num_rows,
                                  build.num_rows if how in ("right", "full")
                                  else None)
        plive = live_mask(probe.num_rows, None, probe.sel, device)
        hit = pc > 0
        if how == "existence":
            return self._flagged(probe, hit)
        if how in ("semi", "anti"):
            return self._flagged(probe, plive & (hit if how == "semi"
                                                 else ~hit))
        # outer: the surviving pairs, then the probe rows (left, full) and
        # the build rows (right, full) no surviving pair holds, null-padded,
        # in one gather; the pad rows ride under the selection
        i32 = dict(dtype=torch.int32, device=device)
        np_rows, nb_rows = probe.num_rows, build.num_rows
        pmap, bmap, sel = [pi], [bi], [keep]
        if how in ("left", "full"):
            pmap.append(torch.arange(np_rows, **i32))
            bmap.append(torch.full((np_rows,), -1, **i32))
            sel.append(plive & ~hit)
        if how in ("right", "full"):
            blive = live_mask(nb_rows, None, build.sel, device)
            pmap.append(torch.full((nb_rows,), -1, **i32))
            bmap.append(torch.arange(nb_rows, **i32))
            sel.append(blive & (bc == 0))
        pi, bi, sel = torch.cat(pmap), torch.cat(bmap), torch.cat(sel)
        out = self._assemble_maps(probe, build, 0, pi, bi, pi.shape[0],
                                  device, pad_probe=how in ("right", "full"))
        return ColumnBatch(out.schema, out.columns, out.num_rows, sel)

    def _cross(self, left: ColumnBatch, right: ColumnBatch,
               device) -> ColumnBatch:
        """The cross product of the two batches' live rows (``_cross``
        :827): every pair by ``cross_pairs``, the sides' selections
        carried to the pairs."""
        pi, bi = join.cross_pairs(left.num_rows, right.num_rows, device)
        out = self._assemble_maps(left, right, 0, pi, bi, pi.shape[0],
                                  device)
        sel = None
        for b, idx in ((left, pi), (right, bi)):
            if b.sel is not None:
                s = b.sel[idx.to(torch.int64)]
                sel = s if sel is None else sel & s
        return self._residual(ColumnBatch(out.schema, out.columns,
                                          out.num_rows, sel), device)

    def _assemble_maps(self, probe: ColumnBatch, build: ColumnBatch,
                       probe_side: int, pi, bi, total: int,
                       device, pad_probe: Optional[bool] = None
                       ) -> ColumnBatch:
        """The output rows given by the gather maps (``pi`` into the probe
        batch, ``bi`` into the build batch, -1 a null row): the left side's
        columns, then the right side's without USING key copies, which a
        right or full join coalesces into the left's.  ``pad_probe``: the
        probe map holds -1 (default: a full join's)."""
        how = self.how
        using = set(self.using)
        sides = [None, None]
        sides[probe_side] = (probe, pi, how == "full" if pad_probe is None
                             else pad_probe)
        sides[1 - probe_side] = (build, bi, how in _OUTER)
        cols_of = []
        for s, (batch, idx, nullable) in enumerate(sides):
            keep = [(f, c) for f, c in zip(batch.schema, batch.columns)
                    if s == 0 or f.name not in using
                    or how in ("right", "full")]
            vals = [_device_values(c, device) for _, c in keep]
            out = join.gather_rows(idx, [(d, v) for d, v, _ in vals],
                                   nullable)
            cols_of.append({f.name: _column(f.dtype, d, v, dct)
                            for (f, _), (d, v), (_, _, dct)
                            in zip(keep, out, vals)})
        left, right = (sides[0][0], sides[1][0])
        cols: List = []
        for f in left.schema:
            c = cols_of[0][f.name]
            if f.name in using and how in ("right", "full"):
                c = _coalesce(c, cols_of[1][f.name], device)
            cols.append(c)
        cols += [cols_of[1][f.name] for f in right.schema
                 if f.name not in using]
        return ColumnBatch(self._schema, cols, total)


def _ordinals(e) -> set:
    """The bound ordinals an expression reads."""
    from ..exprs import BoundReference
    if isinstance(e, BoundReference):
        return {e.ordinal}
    out = set()
    for c in e.children:
        out |= _ordinals(c)
    return out


def _condition_mask(cond, columns, n: int, device) -> torch.Tensor:
    """bool [n]: where the bound ``cond`` holds (true, not null) over
    ``columns`` (device columns read as (data, valid); None or a host
    column where the condition reads none)."""
    arrays = [(c.data, c.valid) if isinstance(c, DeviceColumn) else None
              for c in columns]
    d, v = cond.eval(EvalContext(arrays, n, device, host=columns))
    keep = d if v is None else d & v
    return keep.expand(n) if keep.dim() == 0 else keep


def _coalesce(lc, rc, device):
    """USING-key coalescing: the left value where it is not null, else the
    right one; null only where both are."""
    if isinstance(lc, DeviceColumn) and isinstance(rc, DeviceColumn):
        lv = lc.valid if lc.valid is not None else torch.ones_like(
            lc.data, dtype=torch.bool)
        valid = None if rc.valid is None else lv | rc.valid
        return DeviceColumn(lc.dtype, torch.where(lv, lc.data, rc.data),
                            valid)
    d = StringDictionary()
    _, lcodes, lv = encode_column(lc, d, device)
    _, rcodes, rv = encode_column(rc, d, device)
    lv = lv if lv is not None else torch.ones_like(lcodes, dtype=torch.bool)
    valid = None if rv is None else lv | rv
    return DictStringColumn(torch.where(lv, lcodes, rcodes), valid,
                            d.values())


# ---------------------------------------------------------------------------------
# Broadcast join
# ---------------------------------------------------------------------------------

class BroadcastJoinExec(_EquiJoin):
    """Join of a streamed probe side against a broadcast build side:
    inner and cross (either side builds), left, semi, anti and existence
    (the right side builds), right (the left side builds)."""

    def __init__(self, plan: L.Join, left: TpuExec, right: TpuExec,
                 build_side: int, string_dicts=None,
                 probe_est: Optional[float] = None):
        super().__init__(plan, left, right, string_dicts)
        if build_side not in _LEGAL_BUILD_SIDES[self.how]:
            raise ValueError(f"cannot broadcast side {build_side} of a "
                             f"{self.how} join")
        self.build_side = build_side
        self.probe_est = probe_est
        # per execution (keyed by the context's id): the prepared build
        # and the fetched build stats
        self._prepared: Dict[int, tuple] = {}
        self._host_stats: Dict[int, list] = {}

    def node_desc(self) -> str:
        side = "left" if self.build_side == 0 else "right"
        kind = "NestedLoop" if self.how == "cross" else "Hash"
        return f"TpuBroadcast{kind}Join [{self.how}] build={side}"

    def _dense_static_ok(self, conf) -> bool:
        """The reference's ``_dense_static_ok`` :1145: one key with an
        integer image, a join type the dense probe takes (an inner join's
        condition filters its output; the other types take a condition in
        the matching, which the dense probe does not), a probe side not
        estimated under ``denseMinProbeRows``."""
        min_probe = conf["spark.rapids.tpu.join.denseMinProbeRows"]
        if self.probe_est is not None and min_probe \
                and self.probe_est < min_probe:
            return False
        if not conf["spark.rapids.tpu.join.denseDomainCap"]:
            return False
        if self.how not in ("inner", "left", "semi", "anti", "existence") \
                or len(self.common) != 1:
            return False
        if self.condition is not None and self.how != "inner":
            return False
        ct = self.common[0]
        return ct.is_string or ct.is_integral or ct.is_floating \
            or ct.kind in (T.TypeKind.DATE, T.TypeKind.TIMESTAMP)

    def _dense_key(self, side: int, b: ColumnBatch, device):
        """The single key as the dense kernels read it: int32 or int64,
        floats as their ``sort_image``."""
        d, v = self._keys(side, b, device)[0]
        if d.is_floating_point():
            d = join.sort_image(d)
        elif d.dtype not in (torch.int32, torch.int64):
            d = d.to(torch.int32)
        return d.contiguous(), None if v is None else v.contiguous()

    def _payload(self, build: ColumnBatch, device):
        """(field, data, valid, dictionary) of every build column an inner
        or left join carries; none for semi and anti."""
        if self.how in ("semi", "anti", "existence"):
            return []
        using = set(self.using) if self.build_side == 1 else set()
        return [(f, *_device_values(c, device))
                for f, c in zip(build.schema, build.columns)
                if f.name not in using]

    def _assemble(self, probe_cols, built, n: int,
                  sel: Optional[torch.Tensor]) -> ColumnBatch:
        """The dense output batch: build columns then probe columns when
        the left side builds, else probe then build; a using key's copy on
        the right side is dropped."""
        cols = built + probe_cols if self.build_side == 0 \
            else probe_cols + built
        return ColumnBatch(self._schema, cols, n, sel)

    def _probe_columns(self, probe: ColumnBatch) -> list:
        using = set(self.using) if self.build_side == 0 else set()
        return [(f, c) for f, c in zip(probe.schema, probe.columns)
                if f.name not in using]

    def _prepare(self, ctx: ExecContext):
        """This join's build, materialized once per execution, with its
        dense key and, where the dense gate passes, the device stats
        tensor the one fetch reads: (build, key, valid, stats or None)."""
        prep = self._prepared.get(id(ctx))
        if prep is None:
            m = ctx.metric_set(self.op_id)
            build = self.children[self.build_side].materialize(ctx)
            prep = (build, None, None, None)
            if self._dense_static_ok(ctx.conf):
                cap = ctx.conf["spark.rapids.tpu.join.denseDomainCap"]
                target = self._dpp_target(ctx.conf)
                with m.time("buildTime"):
                    bkey, bvalid = self._dense_key(self.build_side, build,
                                                   ctx.device)
                    if target is None:
                        stats = join.join_key_stats(bkey, bvalid, build.sel,
                                                    cap)
                    else:
                        # the exact sort-based stats serve the dense
                        # decision too, and the IN list rides the same fetch
                        stats = runtime_filter.key_stats(
                            bkey, bvalid, build.sel,
                            runtime_filter.in_list_capacity(ctx.conf[
                                "spark.rapids.tpu.sql.dpp.maxInKeys"]))
                prep = (build, bkey, bvalid, stats)
                if target is not None:
                    self._inject_dpp(ctx, *target)
            self._prepared[id(ctx)] = prep
        return prep

    def _dpp_target(self, conf):
        """(scan, column) of the probe side that dynamic partition pruning
        filters (reference ``_inject_dpp`` :1522: inner and semi joins on
        an integer or date key the probe side passes from a file scan), or
        None."""
        if self.how not in ("inner", "semi") \
                or not _integral_key(self.common[0]):
            return None
        probe_side = 1 - self.build_side
        return _filter_target(self.children[probe_side],
                              self.key_exprs[probe_side][0], conf)

    def _inject_dpp(self, ctx: ExecContext, scan: ScanExec,
                    scol: str) -> None:
        """Install the runtime predicates on the probe scan as a thunk the
        scan resolves at its first read, when this join's stats have been
        fetched with its probe chain's."""
        conf = ctx.conf
        max_in = conf["spark.rapids.tpu.sql.dpp.maxInKeys"]
        ct = self.common[0]

        def preds_fn():
            host = self._fetched(ctx)
            kmin, kmax, n_valid, dup = (int(x) for x in host[:4])

            def values_fn():
                vals = host[runtime_filter.HEADER:]
                vals = vals[vals != runtime_filter.BIG]
                return vals.tolist() if len(vals) <= max_in else None
            return _runtime_key_preds(scol, ct, kmin, kmax, n_valid,
                                      n_valid - dup, conf, values_fn)
        scan.runtime_predicates = preds_fn

    def _probe_chain(self) -> List["BroadcastJoinExec"]:
        """This join and the broadcast joins below it on the probe side,
        through stages: their build stats ride one fetch, as the
        reference's fused region fetches its joins' stats in its one
        prologue (``plan/fusion.py``, ``utils/metrics.py:596
        region_scalars``)."""
        chain: List[BroadcastJoinExec] = []
        node: TpuExec = self
        while True:
            if isinstance(node, BroadcastJoinExec):
                chain.append(node)
                node = node.children[1 - node.build_side]
            elif isinstance(node, StageExec):
                node = node.children[0]
            else:
                return chain

    def _fetched(self, ctx: ExecContext):
        """This join's host stats vector, fetched together with those of
        every not yet fetched dense join of its probe chain."""
        host = self._host_stats.get(id(ctx))
        if host is None:
            chain = [j for j in self._probe_chain()
                     if id(ctx) not in j._host_stats]
            preps = [j._prepare(ctx) for j in chain]
            dense = [(j, p[3]) for j, p in zip(chain, preps)
                     if p[3] is not None]
            for (j, _), h in zip(dense, fetch([t for _, t in dense])):
                j._host_stats[id(ctx)] = h
            host = self._host_stats[id(ctx)]
        return host

    def _stats(self, ctx: ExecContext):
        """This join's build stats [min, max, count, duplicates]."""
        return [int(x) for x in self._fetched(ctx)[:4]]

    def execute(self, ctx: ExecContext) -> Iterator[ColumnBatch]:
        m = ctx.metric_set(self.op_id)
        try:
            yield from self._execute(ctx, m)
        finally:
            self._prepared.pop(id(ctx), None)
            self._host_stats.pop(id(ctx), None)

    def _execute(self, ctx: ExecContext, m) -> Iterator[ColumnBatch]:
        device = ctx.device
        build, bkey, bvalid, stats = self._prepare(ctx)
        if stats is not None:
            cap = ctx.conf["spark.rapids.tpu.join.denseDomainCap"]
            kmin, kmax, n_valid, dup = self._stats(ctx)
            if n_valid == 0:
                if self.how in ("inner", "semi"):
                    return  # nothing can match
                kmin, kmax, dup = 0, 0, 0  # a one-slot table that matches none
            D = kmax - kmin + 1
            if D <= cap:
                if dup == 0:
                    m.add("joinDensePath", 1)
                    yield from self._dense(ctx, m, build, bkey, bvalid, kmin,
                                           D)
                else:
                    m.add("joinCsrPath", 1)
                    yield from self._csr(ctx, m, build, bkey, bvalid, kmin, D)
                return
        bs = self.build_side
        if self.how == "cross" or (self.condition is not None
                                   and self.how != "inner"):
            yield from self._pairwise(ctx, m, build)
            return
        m.add("joinSortedPath", 1)
        with m.time("buildTime"):
            state = join.sorted_build(self._keys(bs, build, device),
                                      build.sel)
        for probe in self._probe_batches(ctx):
            with m.time("opTime"):
                out = self._sorted_join(probe, build, 1 - bs, state, device)
            m.add("numOutputBatches", 1)
            if out is not None:
                yield out

    def _pairwise(self, ctx, m, build) -> Iterator[ColumnBatch]:
        """Cross joins and joins whose condition takes part in the
        matching, per probe batch with the sides in their order: a
        conditioned join's right side builds (sorted once when it is the
        broadcast side, per batch when it streams)."""
        device = ctx.device
        bs = self.build_side
        state = None
        if self.how != "cross" and bs == 1:
            m.add("joinConditionedPath", 1)
            with m.time("buildTime"):
                state = join.sorted_build(self._keys(1, build, device),
                                          build.sel)
        for probe in self._probe_batches(ctx):
            left, right = (build, probe) if bs == 0 else (probe, build)
            with m.time("opTime"):
                out = self._cross(left, right, device) \
                    if self.how == "cross" \
                    else self._conditioned(left, right, device, state)
            m.add("numOutputBatches", 1)
            yield out

    def _probe_batches(self, ctx):
        for probe in self.children[1 - self.build_side].execute(ctx):
            if probe.num_rows:
                yield probe

    def _dense(self, ctx, m, build, bkey, bvalid, kmin: int, D: int):
        """Unique build keys: the direct-address table, sync-free probes."""
        device = ctx.device
        with m.time("buildTime"):
            table = join.build_join_table(bkey, bvalid, build.sel, kmin, D)
            payload = self._payload(build, device)
        for probe in self._probe_batches(ctx):
            with m.time("opTime"):
                pkey, pvalid = self._dense_key(1 - self.build_side, probe,
                                               device)
                sel, gathered = join.probe_join(
                    pkey, pvalid, probe.sel, kmin, table,
                    [(d, v) for _, d, v, _ in payload],
                    "semi" if self.how == "existence" else self.how)
            m.add("numOutputBatches", 1)
            if self.how in ("semi", "anti", "existence"):
                yield self._flagged(probe, sel)
                continue
            built = [_column(f.dtype, d, v, dct) for (f, _, _, dct), (d, v)
                     in zip(payload, gathered)]
            yield self._residual(self._assemble(
                [c for _, c in self._probe_columns(probe)], built,
                probe.num_rows, sel), device)

    def _csr(self, ctx, m, build, bkey, bvalid, kmin: int, D: int):
        """Repeated build keys: counts, starts and the stable build
        permutation once; per probe batch a selection (semi, anti) or the
        gather maps of its output rows (inner, left: one fetch of the
        output size)."""
        device = ctx.device
        with m.time("buildTime"):
            counts, starts, b_perm = join.csr_build(bkey, bvalid, build.sel,
                                                    kmin, D)
        for probe in self._probe_batches(ctx):
            with m.time("opTime"):
                pkey, pvalid = self._dense_key(1 - self.build_side, probe,
                                               device)
                got = join.csr_probe(pkey, pvalid, probe.sel, kmin, counts,
                                     starts, "semi" if self.how == "existence"
                                     else self.how)
            m.add("numOutputBatches", 1)
            if self.how in ("semi", "anti", "existence"):
                yield self._flagged(probe, got)
                continue
            lo, offsets = got
            total = int(fetch(offsets[-1:])[0])
            if total == 0:
                continue
            with m.time("opTime"):
                pi, bi = join.csr_expand(offsets, lo, b_perm, total)
                yield self._residual(self._assemble_maps(
                    probe, build, 1 - self.build_side, pi, bi, total,
                    device), device)


# ---------------------------------------------------------------------------------
# Shuffled sort-merge join
# ---------------------------------------------------------------------------------

class SortMergeJoinExec(_EquiJoin):
    """The join of two sides no broadcast takes: over two shuffle
    exchanges, partition pair by partition pair (or flipped to a broadcast
    join when a staged side turns out small, unless a condition takes part
    in the matching); else (exchanges off, or a cross join) the two sides
    whole."""

    def node_desc(self) -> str:
        return f"TpuSortMergeJoin [{self.how}]"

    def execute(self, ctx: ExecContext) -> Iterator[ColumnBatch]:
        m = ctx.metric_set(self.op_id)
        lchild, rchild = self.children
        if isinstance(lchild, ShuffleExchangeExec) \
                and isinstance(rchild, ShuffleExchangeExec):
            flipped = self._try_runtime_broadcast(ctx, m)
            if flipped is not None:
                yield from flipped
                return
            limit = ctx.conf["spark.rapids.tpu.sql.batchSizeRows"]
            lgen, rgen = lchild.execute(ctx), rchild.execute(ctx)
            try:
                for lb, rb in zip(lgen, rgen):
                    if lb.num_rows == 0 and rb.num_rows == 0:
                        continue
                    if lb.num_rows + rb.num_rows > limit:
                        yield from self._sub_partition_join(ctx, m, lb, rb)
                        continue
                    out = self._join_pair(ctx, m, lb, rb)
                    if out is not None:
                        yield out
            finally:
                lgen.close()
                rgen.close()
            return
        left = _whole(lchild, ctx)
        if self.how in ("inner", "left", "semi", "anti", "existence"):
            # right rows no left key matches never come out: the left
            # keys may filter the right side's scan before it is read
            self._inject_smj_filter(ctx, left)
        right = _whole(rchild, ctx)
        if left.num_rows or right.num_rows:
            out = self._join_pair(ctx, m, left, right)
            if out is not None:
                yield out

    def _inject_smj_filter(self, ctx: ExecContext, left: ColumnBatch
                           ) -> None:
        """The left side's key stats as runtime predicates on the right
        side's file scan (reference :161, an exact range or IN list in
        place of Spark's bloom filter): one fetch reads the stats and the
        distinct prefix together."""
        if len(self.common) != 1 or not _integral_key(self.common[0]):
            return
        target = _filter_target(self.children[1], self.key_exprs[1][0],
                                ctx.conf)
        if target is None:
            return
        scan, scol = target
        d, v = self._keys(0, left, ctx.device)[0]
        if d.dtype not in (torch.int32, torch.int64):
            d = d.to(torch.int64)
        host = fetch(runtime_filter.key_stats(
            d.contiguous(), None if v is None else v.contiguous(), left.sel,
            runtime_filter.in_list_capacity(
                ctx.conf["spark.rapids.tpu.sql.dpp.maxInKeys"])))
        kmin, kmax, n_valid, _, n_distinct = (
            int(x) for x in host[:runtime_filter.HEADER])

        def values_fn():
            vals = host[runtime_filter.HEADER:]
            return vals[vals != runtime_filter.BIG].tolist()
        scan.runtime_predicates = _runtime_key_preds(
            scol, self.common[0], kmin, kmax, n_valid, n_distinct, ctx.conf,
            values_fn)

    def _try_runtime_broadcast(self, ctx: ExecContext, m):
        """Flip to a broadcast join when the smaller-estimated legal build
        side's staged input is actually under the broadcast threshold; the
        probe is the other exchange's child.  None: no flip (the staged
        batches then feed the exchange)."""
        conf = ctx.conf
        threshold = conf["spark.rapids.tpu.sql.autoBroadcastJoinThreshold"]
        if not conf["spark.rapids.tpu.sql.aqe.enabled"] or threshold < 0 \
                or conf["spark.rapids.tpu.shuffle.mode"] != "CACHE_ONLY" \
                or self.condition is not None:
            return None
        legal = _LEGAL_BUILD_SIDES[self.how]
        if not legal:
            return None
        ests = [(i, estimated_bytes(self.plan.children[i])) for i in legal]
        cand = min(ests, key=lambda t: float("inf") if t[1] is None
                   else t[1])[0]
        exch = self.children[cand]
        if not exch.staged_fits(ctx, threshold):
            return None
        m.add("aqeShuffleToBroadcast", 1)
        staged = exch.stage_input(ctx)
        exch.release()
        pair = [None, None]
        pair[cand] = BroadcastExchangeExec(_StagedExec(exch.output_schema,
                                                       staged))
        pair[1 - cand] = self.children[1 - cand].children[0]
        return BroadcastJoinExec(self.plan, pair[0], pair[1], cand,
                                 string_dicts=self.string_dicts).execute(ctx)

    def _sub_partition_join(self, ctx: ExecContext, m, lb: ColumnBatch,
                            rb: ColumnBatch) -> Iterator[ColumnBatch]:
        """An oversized partition pair split into ``join.subPartitions``
        sub-pairs by an independent key hash (xxhash64; equal keys still
        meet), each joined alone; one fetch reads both sides' counts."""
        k = max(2, ctx.conf["spark.rapids.tpu.sql.join.subPartitions"])
        m.add("subPartitionedPairs", 1)
        device = ctx.device
        sides = []
        for side, b in ((0, lb), (1, rb)):
            counts = torch.zeros(k + 1, dtype=torch.int64, device=device)
            pids = hashing.partition_ids(self._keys(side, b, device), k,
                                         b.sel, algo="xxhash64",
                                         counts=counts)
            dicts: Dict[int, StringDictionary] = {}
            sides.append((b, _encoded(b, dicts, device, {}), dicts, pids,
                          counts))
        host = fetch([s[4] for s in sides])
        parts = [split_by_pid(b.schema, cols, dicts, pids, c, k, device)
                 for (b, cols, dicts, pids, _), c in zip(sides, host)]
        for lp, rp in zip(*parts):
            if lp.num_rows == 0 and rp.num_rows == 0:
                continue
            out = self._join_pair(ctx, m, lp, rp)
            if out is not None:
                yield out

    def _join_pair(self, ctx: ExecContext, m, left: ColumnBatch,
                   right: ColumnBatch) -> Optional[ColumnBatch]:
        """One pair through the sorted match state: a right join probes
        with its right side (the mirrored left join), every other type
        with its left; a join whose condition takes part in the matching
        probes with its left side (``_join_pair`` :420), a cross join
        pairs every row."""
        device = ctx.device
        if self.how == "cross" or (self.condition is not None
                                   and self.how != "inner"):
            with m.time("opTime"):
                out = self._cross(left, right, device) \
                    if self.how == "cross" \
                    else self._conditioned(left, right, device)
            m.add("numOutputBatches", 1)
            return out
        probe_side = 1 if self.how == "right" else 0
        probe, build = (right, left) if probe_side else (left, right)
        with m.time("opTime"):
            state = join.sorted_build(self._keys(1 - probe_side, build,
                                                 device), build.sel)
            out = self._sorted_join(probe, build, probe_side, state, device)
        m.add("numOutputBatches", 1)
        return out


def plan_broadcast_join(plan: L.Join, left: TpuExec, right: TpuExec, conf,
                        string_dicts: Dict[int, StringDictionary]
                        ) -> Optional[BroadcastJoinExec]:
    """The reference's build-side choice (``plan_broadcast_join`` :1846):
    among the sides that may be broadcast for the join type, the smaller
    one whose estimate fits ``autoBroadcastJoinThreshold`` builds; None
    when none does (a full join never broadcasts)."""
    how = canon_how(plan.how)
    legal = _LEGAL_BUILD_SIDES.get(how, ())
    threshold = conf["spark.rapids.tpu.sql.autoBroadcastJoinThreshold"]
    if not legal or threshold < 0:
        return None
    ests = [estimated_bytes(c) for c in plan.children]
    fits = [s for s in legal if ests[s] is not None and ests[s] <= threshold]
    if not fits:
        return None
    build_side = min(fits, key=lambda s: ests[s])
    probe_est = estimate_rows(plan.children[1 - build_side])
    if build_side == 1:
        return BroadcastJoinExec(plan, left, BroadcastExchangeExec(right), 1,
                                 string_dicts, probe_est)
    return BroadcastJoinExec(plan, BroadcastExchangeExec(left), right, 0,
                             string_dicts, probe_est)
