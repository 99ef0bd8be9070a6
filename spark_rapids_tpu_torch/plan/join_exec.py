"""Broadcast joins on the dense direct-address path.

Counterpart of ``spark_rapids_tpu/plan/join_exec.py``: the broadcast
exchange (``BroadcastExchangeExec``, whose build side is materialized
whole, ``materialize_whole`` :62), the broadcast join's dense path for
inner joins on one integral key (``_dense_static_ok`` :1145,
``execute`` :1572) and the build-side choice (``plan_broadcast_join``
:1846).  The phases run through ``ops/join.py`` and its kernel
``csrc/dense_join.cu``.

A join costs one blocking fetch: the build keys' min, max and count, which
size the table.  Whether a build key repeats is counted on the device
while the table is built and read by the query's next fetch
(``QueryStats.defer_check``), which raises before any row reaches the
caller.  Everything the dense path does not cover raises
``NotImplementedError`` naming its ROADMAP row: joins that are not inner
(row 7), several keys, keys that are not integral, repeated build keys,
a key domain over ``denseDomainCap`` or a probe side under
``denseMinProbeRows`` (the CSR and sorted broadcast paths, row 6′), and
joins whose sides both exceed the broadcast threshold (the shuffled
sort-merge join, row 7).  The reference's dynamic partition pruning
(``_inject_dpp`` :1522) prunes parquet row groups; the port reads
in-memory columns, so it is not ported (ROADMAP item 9).
"""

from __future__ import annotations

from typing import Iterator, List

import numpy as np
import torch

from .. import types as T
from ..batch import ColumnBatch, DeviceColumn, HostStringColumn, Schema
from ..exprs import EvalContext, bind
from ..ops import batch_utils, join
from ..utils.metrics import QueryStats, fetch
from . import logical as L
from .cbo import estimate_rows, estimated_bytes
from .physical import ExecContext, TpuExec, _device_arrays

__all__ = ["BroadcastExchangeExec", "BroadcastJoinExec",
           "plan_broadcast_join"]

_CANON = {"left_outer": "left", "right_outer": "right", "full_outer": "full",
          "left_semi": "semi", "left_anti": "anti"}


def _not_ported(what: str, row: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md queue 2 row {row})")


class BroadcastExchangeExec(TpuExec):
    """The build side, materialized once as one batch: every child batch
    concatenated, selection masks kept (the dense build folds them in, so
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


class BroadcastJoinExec(TpuExec):
    """Inner equi-join of a streamed probe side against a broadcast build
    side on one integral key, by direct addressing: the table maps
    key - kmin to the build row, and each probe batch passes through
    under a selection mask with the build columns gathered beside it."""

    def __init__(self, plan: L.Join, left: TpuExec, right: TpuExec,
                 build_side: int):
        super().__init__([left, right])
        self.build_side = build_side
        self.using = list(plan.using)
        self._schema = plan.schema()
        lk = bind(plan.left_keys[0], left.output_schema)
        rk = bind(plan.right_keys[0], right.output_schema)
        self.keys = (lk, rk)
        for k in self.keys:
            if not k.dtype.is_integral and k.dtype.kind != T.TypeKind.DATE:
                raise _not_ported(
                    f"a join on a {k.dtype} key (the dense path takes "
                    f"integral and date keys; the sorted broadcast path)",
                    "6′")
        wide = any(k.dtype.torch_dtype == torch.int64 for k in self.keys)
        self.key_dtype = torch.int64 if wide else torch.int32

    @property
    def output_schema(self) -> Schema:
        return self._schema

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

    def _payload(self, build: ColumnBatch):
        """(build schema index, (data, valid)) of every build column the
        output carries."""
        using = set(self.using) if self.build_side == 1 else set()
        out = []
        for i, (f, c) in enumerate(zip(build.schema, build.columns)):
            if f.name in using:
                continue
            if not isinstance(c, DeviceColumn):
                raise _not_ported(
                    f"the string column {f.name} on a join's build side "
                    f"(string payloads ride as dictionary codes in the "
                    f"reference)", "6′")
            out.append((i, (c.data, c.valid)))
        return out

    def execute(self, ctx: ExecContext) -> Iterator[ColumnBatch]:
        m = ctx.metric_set(self.op_id)
        device = ctx.device
        bs, ps = self.build_side, 1 - self.build_side
        build = self.children[bs].materialize(ctx)
        with m.time("buildTime"):
            bkey, bvalid = self._key(bs, build, device)
            kmin, kmax, n_valid = (int(x) for x in fetch(
                join.join_key_stats(bkey, bvalid, build.sel)))
        if n_valid == 0:
            return  # an inner join with an empty build side has no rows
        cap = ctx.conf["spark.rapids.tpu.join.denseDomainCap"]
        if kmax - kmin + 1 > cap:
            raise _not_ported(
                f"a broadcast join whose build keys span {kmax - kmin + 1} "
                f"values, over spark.rapids.tpu.join.denseDomainCap={cap} "
                f"(the CSR and sorted broadcast paths)", "6′")
        with m.time("buildTime"):
            table, dup = join.build_join_table(bkey, bvalid, build.sel,
                                               kmin, kmax - kmin + 1)
            QueryStats.get().defer_check(dup, str(_not_ported(
                "a broadcast join whose build side repeats a key (the CSR "
                "and sorted broadcast paths)", "6′")))
            payload = self._payload(build)
        using = set(self.using) if bs == 0 else set()
        for probe in self.children[ps].execute(ctx):
            if probe.num_rows == 0:
                continue
            with m.time("opTime"):
                pkey, pvalid = self._key(ps, probe, device)
                sel, gathered = join.probe_join(pkey, pvalid, probe.sel, kmin,
                                                table, [v for _, v in payload])
            built = [DeviceColumn(build.schema.fields[i].dtype, d, v)
                     for (i, _), (d, v) in zip(payload, gathered)]
            passed = [c for f, c in zip(probe.schema, probe.columns)
                      if f.name not in using]
            cols = built + passed if bs == 0 else passed + built
            m.add("numOutputBatches", 1)
            yield ColumnBatch(self._schema, cols, probe.num_rows, sel)


def plan_broadcast_join(plan: L.Join, left: TpuExec, right: TpuExec,
                        conf) -> BroadcastJoinExec:
    """The reference's build-side choice: the smaller side whose estimate
    fits ``spark.rapids.tpu.sql.autoBroadcastJoinThreshold`` builds.  Only
    what the dense inner path runs is ported; the rest raises."""
    how = _CANON.get(plan.how, plan.how)
    if how != "inner":
        raise _not_ported(f"a {plan.how} join (outer, semi, anti and cross "
                          f"joins)", "7")
    if len(plan.left_keys) != 1:
        raise _not_ported(f"an equi-join on {len(plan.left_keys)} keys (the "
                          f"sorted broadcast path)", "6′")
    threshold = conf["spark.rapids.tpu.sql.autoBroadcastJoinThreshold"]
    ests = [estimated_bytes(c) for c in plan.children]
    fits = [s for s in (1, 0) if threshold >= 0 and ests[s] is not None
            and ests[s] <= threshold]
    if not fits:
        raise _not_ported("a join whose sides both exceed "
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
