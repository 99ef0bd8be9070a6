"""Broadcast joins on one integral key: the dense path and the CSR path.

Counterpart of ``spark_rapids_tpu/plan/join_exec.py``: the broadcast
exchange (``BroadcastExchangeExec``, whose build side is materialized
whole, ``materialize_whole`` :62), the broadcast join's dense path
(``_dense_static_ok`` :1145, ``_dense_join_pair`` :1410) and CSR path
(``_csr_match_state`` :1040 with ``_semi_anti`` :690 and ``_outer_join``
:697) for inner, left outer, semi and anti joins, and the build-side
choice (``plan_broadcast_join`` :1846, ``_legal_build_sides`` :1838).  The
phases run through ``ops/join.py`` and its kernels ``csrc/dense_join.cu``
and ``csrc/csr_join.cu``.

A join's one planning fetch reads the build keys' min, max, count and
duplicate count, as the reference's stats program does: a build without
repeated keys takes the dense table (key - kmin → build row), whose probe
passes each probe batch through under a selection mask with the build
columns gathered beside it (left: null where unmatched) and costs no
fetch; a build that repeats keys takes the CSR path (per-slot counts and
starts and a stable build permutation), whose semi and anti probes are
selections again, and whose inner and left probes expand into gather
maps at one fetch per probe batch (the output size), as the reference's
``_outer_join`` does.  String columns ride as int32 dictionary codes
(``DictStringColumn``), as the reference's ``_dense_payload_fields``
:1168 and ``_gather_cols`` :1904 do.

What neither path covers raises ``NotImplementedError`` naming its ROADMAP
row: right, full and cross joins and joins whose sides both exceed the
broadcast threshold (the shuffled sort-merge join, row 7), several keys,
keys that are not integral, a key domain over ``denseDomainCap`` and a
probe side under ``denseMinProbeRows`` (the sorted broadcast path, row
6′).  The reference's dynamic partition pruning (``_inject_dpp`` :1522)
prunes parquet row groups; the port reads in-memory columns, so it is not
ported (ROADMAP item 9).
"""

from __future__ import annotations

from typing import Iterator, List, Optional

import numpy as np
import torch

from .. import types as T
from ..batch import (ColumnBatch, DeviceColumn, DictStringColumn,
                     HostStringColumn, Schema)
from ..exprs import EvalContext, bind
from ..ops import batch_utils, join
from ..ops.strings import encode_column
from ..utils.metrics import fetch
from . import logical as L
from .cbo import estimate_rows, estimated_bytes
from .physical import ExecContext, TpuExec, _device_arrays

__all__ = ["BroadcastExchangeExec", "BroadcastJoinExec",
           "plan_broadcast_join"]

_CANON = {"left_outer": "left", "right_outer": "right", "full_outer": "full",
          "left_semi": "semi", "left_anti": "anti"}
# sides that may be broadcast: never the row-preserving side
_LEGAL_BUILD_SIDES = {"inner": (1, 0), "left": (1,), "semi": (1,),
                      "anti": (1,)}


def _not_ported(what: str, row: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md queue 2 row {row})")


class BroadcastExchangeExec(TpuExec):
    """The build side, materialized once as one batch: every child batch
    concatenated, selection masks kept (the build kernels fold them in, so
    no live count is fetched)."""

    def __init__(self, child: TpuExec):
        super().__init__([child])

    @property
    def output_schema(self) -> Schema:
        return self.children[0].output_schema

    def materialize(self, ctx: ExecContext) -> ColumnBatch:
        m = ctx.metric_set(self.op_id)
        with m.time("buildTime"):
            parts = [b for b in self.children[0].execute(ctx)
                     if b.num_rows > 0]
            if not parts:
                return _empty_batch(self.output_schema, ctx.device)
            return batch_utils.concat_batches(parts)

    def execute(self, ctx: ExecContext) -> Iterator[ColumnBatch]:
        yield self.materialize(ctx)


def _device_values(col, device):
    """(data, valid, dictionary or None) of a column on the device:
    string columns as int32 dictionary codes."""
    if isinstance(col, DeviceColumn):
        return col.data, col.valid, None
    d, codes, valid = encode_column(col, None, device)
    dictionary = col.dictionary if isinstance(col, DictStringColumn) \
        else d.values()
    return codes, valid, dictionary


def _column(dtype: T.DataType, data, valid, dictionary):
    if dictionary is not None:
        return DictStringColumn(data, valid, dictionary)
    return DeviceColumn(dtype, data, valid)


class BroadcastJoinExec(TpuExec):
    """Equi-join of a streamed probe side against a broadcast build side
    on one integral key: inner (either side builds), left outer, semi and
    anti (the right side builds)."""

    def __init__(self, plan: L.Join, left: TpuExec, right: TpuExec,
                 build_side: int):
        super().__init__([left, right])
        self.how = _CANON.get(plan.how, plan.how)
        if build_side not in _LEGAL_BUILD_SIDES[self.how]:
            raise ValueError(f"cannot broadcast side {build_side} of a "
                             f"{self.how} join")
        self.build_side = build_side
        self.using = list(plan.using)
        self._schema = plan.schema()
        lk = bind(plan.left_keys[0], left.output_schema)
        rk = bind(plan.right_keys[0], right.output_schema)
        self.keys = (lk, rk)
        for k in self.keys:
            if not k.dtype.is_integral and k.dtype.kind != T.TypeKind.DATE:
                raise _not_ported(
                    f"a join on a {k.dtype} key (the dense and CSR paths "
                    f"take integral and date keys; the sorted broadcast "
                    f"path)", "6′")
        wide = any(k.dtype.torch_dtype == torch.int64 for k in self.keys)
        self.key_dtype = torch.int64 if wide else torch.int32

    @property
    def output_schema(self) -> Schema:
        return self._schema

    def node_desc(self) -> str:
        side = "left" if self.build_side == 0 else "right"
        return f"TpuBroadcastHashJoin [{self.how}] build={side}"

    def _key(self, side: int, b: ColumnBatch, device):
        d, v = self.keys[side].eval(EvalContext(_device_arrays(b),
                                                b.num_rows, device,
                                                active=b.sel))
        if d.dim() == 0:
            d = d.expand(b.num_rows)
        if v is not None and v.dim() == 0:
            v = v.expand(b.num_rows)
        return d.to(self.key_dtype).contiguous(), \
            None if v is None else v.contiguous()

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
        """The output batch: build columns then probe columns when the left
        side builds, else probe then build; a using key's copy on the
        right side is dropped."""
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
        cap = ctx.conf["spark.rapids.tpu.join.denseDomainCap"]
        with m.time("buildTime"):
            bkey, bvalid = self._key(bs, build, device)
            kmin, kmax, n_valid, dup = (int(x) for x in fetch(
                join.join_key_stats(bkey, bvalid, build.sel, max(cap, 1))))
        if n_valid == 0:
            if self.how in ("inner", "semi"):
                return  # nothing can match
            kmin, kmax, dup = 0, 0, 0  # a one-slot table that matches none
        if kmax - kmin + 1 > cap:
            raise _not_ported(
                f"a broadcast join whose build keys span {kmax - kmin + 1} "
                f"values, over spark.rapids.tpu.join.denseDomainCap={cap} "
                f"(the sorted broadcast path)", "6′")
        D = kmax - kmin + 1
        if dup == 0:
            m.add("joinDensePath", 1)
            yield from self._dense(ctx, m, build, bkey, bvalid, kmin, D)
        else:
            m.add("joinCsrPath", 1)
            yield from self._csr(ctx, m, build, bkey, bvalid, kmin, D)

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
                pkey, pvalid = self._key(1 - self.build_side, probe, device)
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
            payload = self._payload(build, device)
        for probe in self._probe_batches(ctx):
            with m.time("opTime"):
                pkey, pvalid = self._key(1 - self.build_side, probe, device)
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
                pcols = [(f, *_device_values(c, device))
                         for f, c in self._probe_columns(probe)]
                p_out = join.gather_rows(pi, [(d, v) for _, d, v, _ in pcols],
                                         nullable=False)
                b_out = join.gather_rows(bi, [(d, v) for _, d, v, _ in
                                              payload],
                                         nullable=self.how == "left")
            passed = [_column(f.dtype, d, v, dct) for (f, _, _, dct), (d, v)
                      in zip(pcols, p_out)]
            built = [_column(f.dtype, d, v, dct) for (f, _, _, dct), (d, v)
                     in zip(payload, b_out)]
            yield self._assemble(passed, built, total, None)


def plan_broadcast_join(plan: L.Join, left: TpuExec, right: TpuExec,
                        conf) -> BroadcastJoinExec:
    """The reference's build-side choice: among the sides that may be
    broadcast for the join type, the smaller one whose estimate fits
    ``spark.rapids.tpu.sql.autoBroadcastJoinThreshold`` builds.  Only what
    the dense and CSR paths run is ported; the rest raises."""
    how = _CANON.get(plan.how, plan.how)
    legal = _LEGAL_BUILD_SIDES.get(how)
    if legal is None:
        raise _not_ported(f"a {plan.how} join (right, full and cross joins "
                          f"plan the shuffled join)", "7")
    if len(plan.left_keys) != 1:
        raise _not_ported(f"an equi-join on {len(plan.left_keys)} keys (the "
                          f"sorted broadcast path)", "6′")
    threshold = conf["spark.rapids.tpu.sql.autoBroadcastJoinThreshold"]
    ests = [estimated_bytes(c) for c in plan.children]
    fits = [s for s in legal if threshold >= 0 and ests[s] is not None
            and ests[s] <= threshold]
    if not fits:
        raise _not_ported("a join whose broadcastable side exceeds "
                          "spark.rapids.tpu.sql.autoBroadcastJoinThreshold "
                          "(the shuffled sort-merge join)", "7")
    build_side = min(fits, key=lambda s: ests[s])
    probe_est = estimate_rows(plan.children[1 - build_side])
    min_probe = conf["spark.rapids.tpu.join.denseMinProbeRows"]
    if probe_est is not None and min_probe and probe_est < min_probe:
        raise _not_ported(
            f"a broadcast join whose probe side is estimated at "
            f"{probe_est:.0f} rows, under "
            f"spark.rapids.tpu.join.denseMinProbeRows={min_probe} (the "
            f"sorted broadcast path)", "6′")
    if build_side == 1:
        return BroadcastJoinExec(plan, left, BroadcastExchangeExec(right), 1)
    return BroadcastJoinExec(plan, BroadcastExchangeExec(left), right, 0)


def _empty_batch(schema: Schema, device) -> ColumnBatch:
    cols: List = []
    for f in schema:
        if f.dtype.is_string:
            cols.append(HostStringColumn(np.empty(0, dtype=object)))
        else:
            cols.append(DeviceColumn(
                f.dtype, torch.empty(0, dtype=f.dtype.torch_dtype,
                                     device=device)))
    return ColumnBatch(schema, cols, 0)
