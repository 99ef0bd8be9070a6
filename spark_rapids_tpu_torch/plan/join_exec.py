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

Not ported, and raising ``NotImplementedError`` naming ROADMAP queue 2 row
7′: cross joins (``_cross`` :827), residual join conditions
(``_conditioned_probe_join`` :446, ``_apply_residual`` :576) and existence
joins (``_existence`` :617).  The reference's runtime scan pruning
(``_inject_dpp`` :1522, ``_inject_smj_filter`` :161) prunes parquet row
groups and changes no result; the port reads in-memory columns, so it is
not ported (ROADMAP.md item 9).
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional

import torch

from .. import types as T
from ..batch import ColumnBatch, DeviceColumn, DictStringColumn, Schema
from ..exprs import bind
from ..ops import batch_utils, hashing, join
from ..ops.strings import StringDictionary, encode_column
from ..utils.metrics import fetch
from . import logical as L
from .cbo import estimate_rows, estimated_bytes
from .exchange_exec import (ShuffleExchangeExec, _encoded, empty_batch,
                            key_values, split_by_pid)
from .physical import ExecContext, TpuExec

__all__ = ["BroadcastExchangeExec", "BroadcastJoinExec", "SortMergeJoinExec",
           "bound_join_keys", "plan_broadcast_join"]

_CANON = {"left_outer": "left", "right_outer": "right", "full_outer": "full",
          "left_semi": "semi", "left_anti": "anti"}
# sides that may be broadcast: never the row-preserving side; a full join
# preserves both
_LEGAL_BUILD_SIDES = {"inner": (1, 0), "left": (1,), "semi": (1,),
                      "anti": (1,), "right": (0,), "full": ()}
_OUTER = ("left", "right", "full")


def _not_ported(what: str, row: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md queue 2 row {row})")


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
    return batch_utils.concat_batches(parts)


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
            raise _not_ported(f"a {plan.how} join", "7′")
        if plan.condition is not None:
            raise _not_ported("a join with a residual condition", "7′")
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
        lo, matches, got = join.sorted_probe(pkeys, probe.sel, state, how)
        if how in ("semi", "anti"):
            return ColumnBatch(self._schema, probe.columns, probe.num_rows,
                               got)
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
        return self._assemble_maps(probe, build, probe_side, pi, bi,
                                   total + extra, device)

    def _assemble_maps(self, probe: ColumnBatch, build: ColumnBatch,
                       probe_side: int, pi, bi, total: int,
                       device) -> ColumnBatch:
        """The output rows given by the gather maps (``pi`` into the probe
        batch, ``bi`` into the build batch, -1 a null row): the left side's
        columns, then the right side's without USING key copies, which a
        right or full join coalesces into the left's."""
        how = self.how
        using = set(self.using)
        sides = [None, None]
        sides[probe_side] = (probe, pi, how == "full")
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
    """Equi-join of a streamed probe side against a broadcast build side:
    inner (either side builds), left, semi and anti (the right side
    builds), right (the left side builds)."""

    def __init__(self, plan: L.Join, left: TpuExec, right: TpuExec,
                 build_side: int, string_dicts=None,
                 probe_est: Optional[float] = None):
        super().__init__(plan, left, right, string_dicts)
        if build_side not in _LEGAL_BUILD_SIDES[self.how]:
            raise ValueError(f"cannot broadcast side {build_side} of a "
                             f"{self.how} join")
        self.build_side = build_side
        self.probe_est = probe_est

    def node_desc(self) -> str:
        side = "left" if self.build_side == 0 else "right"
        return f"TpuBroadcastHashJoin [{self.how}] build={side}"

    def _dense_static_ok(self, conf) -> bool:
        """The reference's ``_dense_static_ok`` :1145: one key with an
        integer image, a join type the dense probe takes, a probe side not
        estimated under ``denseMinProbeRows``."""
        min_probe = conf["spark.rapids.tpu.join.denseMinProbeRows"]
        if self.probe_est is not None and min_probe \
                and self.probe_est < min_probe:
            return False
        if not conf["spark.rapids.tpu.join.denseDomainCap"]:
            return False
        if self.how not in ("inner", "left", "semi", "anti") \
                or len(self.common) != 1:
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
        if self.how in ("semi", "anti"):
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

    def execute(self, ctx: ExecContext) -> Iterator[ColumnBatch]:
        m = ctx.metric_set(self.op_id)
        device = ctx.device
        bs = self.build_side
        build = self.children[bs].materialize(ctx)
        if self._dense_static_ok(ctx.conf):
            cap = ctx.conf["spark.rapids.tpu.join.denseDomainCap"]
            with m.time("buildTime"):
                bkey, bvalid = self._dense_key(bs, build, device)
                kmin, kmax, n_valid, dup = (int(x) for x in fetch(
                    join.join_key_stats(bkey, bvalid, build.sel, cap)))
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
                    [(d, v) for _, d, v, _ in payload], self.how)
            m.add("numOutputBatches", 1)
            if self.how in ("semi", "anti"):
                yield ColumnBatch(self._schema, probe.columns, probe.num_rows,
                                  sel)
                continue
            built = [_column(f.dtype, d, v, dct) for (f, _, _, dct), (d, v)
                     in zip(payload, gathered)]
            yield self._assemble([c for _, c in self._probe_columns(probe)],
                                 built, probe.num_rows, sel)

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
                                     starts, self.how)
            m.add("numOutputBatches", 1)
            if self.how in ("semi", "anti"):
                yield ColumnBatch(self._schema, probe.columns, probe.num_rows,
                                  got)
                continue
            lo, offsets = got
            total = int(fetch(offsets[-1:])[0])
            if total == 0:
                continue
            with m.time("opTime"):
                pi, bi = join.csr_expand(offsets, lo, b_perm, total)
                yield self._assemble_maps(probe, build, 1 - self.build_side,
                                          pi, bi, total, device)


# ---------------------------------------------------------------------------------
# Shuffled sort-merge join
# ---------------------------------------------------------------------------------

class SortMergeJoinExec(_EquiJoin):
    """The join of two sides no broadcast takes: over two shuffle
    exchanges, partition pair by partition pair (or flipped to a broadcast
    join when a staged side turns out small); else the two sides whole."""

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
        left, right = _whole(lchild, ctx), _whole(rchild, ctx)
        if left.num_rows or right.num_rows:
            out = self._join_pair(ctx, m, left, right)
            if out is not None:
                yield out

    def _try_runtime_broadcast(self, ctx: ExecContext, m):
        """Flip to a broadcast join when the smaller-estimated legal build
        side's staged input is actually under the broadcast threshold; the
        probe is the other exchange's child.  None: no flip (the staged
        batches then feed the exchange)."""
        conf = ctx.conf
        threshold = conf["spark.rapids.tpu.sql.autoBroadcastJoinThreshold"]
        if not conf["spark.rapids.tpu.sql.aqe.enabled"] or threshold < 0 \
                or conf["spark.rapids.tpu.shuffle.mode"] != "CACHE_ONLY":
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
        with its left."""
        device = ctx.device
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
