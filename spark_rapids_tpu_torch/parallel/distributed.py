"""One distributed aggregation step over a device mesh
(``spark_rapids_tpu/parallel/distributed.py`` counterpart).

A DataFrame query is planned as usual with the partial/final split
(``sql.agg.singleProcessComplete=false``); its final → exchange → partial
aggregate tree, with an optional stage between the scan and the partial,
is recognised, and the bound expressions of those nodes run per shard of
a table cut row-wise across the mesh: the stage, the partial aggregate's
keys and contributions, then ``exchange.exchange_grouped_agg`` (local
partial aggregation, bucketize, the exchange, the merge), and the
finalize.  The planner's expressions and the distributed step are one
compiler, as in the reference.  The table is the dict of numpy arrays
that ``Session.create_dataframe`` takes; string columns ride as codes of
one dictionary per column and come back as strings.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..batch import numpy_column, upload
from ..exprs import EvalContext
from ..utils.metrics import fetch
from .exchange import exchange_grouped_agg

__all__ = ["plan_distributed_agg", "distributed_agg_collect"]


def _find_agg_tree(phys):
    """final aggregate → exchange → partial aggregate in a planned query."""
    from ..plan.exchange_exec import ShuffleExchangeExec
    from ..plan.physical import AggregateExec
    node = phys
    while node is not None:
        if isinstance(node, AggregateExec) and node.mode == "final":
            exch = node.children[0]
            if isinstance(exch, ShuffleExchangeExec):
                partial = exch.children[0]
                if isinstance(partial, AggregateExec) \
                        and partial.mode == "partial":
                    return node, exch, partial
        node = node.children[0] if node.children else None
    raise ValueError("plan has no partial->exchange->final aggregate "
                     "(set spark.rapids.tpu.sql.agg.singleProcessComplete="
                     "false; is spark.rapids.tpu.sql.exchange.enabled on?)")


def plan_distributed_agg(df, devices: Sequence[torch.device],
                         bucket_cap: Optional[int] = None):
    """Plan a grouped-aggregate DataFrame query as one distributed step.

    Returns (step, feed, (final, partial)): ``feed(table)`` cuts a table's
    columns across the mesh (data and validity; strings as codes),
    ``step(shards)`` runs the step and gives per shard (keys, finalized
    values, live mask) and the overflow counts.  Only a stage may stand
    between the scan and the partial aggregate; anything else is
    refused, never ignored."""
    from ..ops.strings import StringDictionary
    from ..plan.overrides import apply_overrides
    from ..plan.physical import ScanExec, StageExec
    conf = df.session.conf()
    phys = apply_overrides(df._plan, conf)
    final, _, partial = _find_agg_tree(phys)
    below = partial.children[0]
    stage = None
    if isinstance(below, StageExec):
        stage, below = below, below.children[0]
    if not isinstance(below, ScanExec):
        raise ValueError(f"the distributed step takes a scan and at most "
                         f"one stage below the partial aggregate, found "
                         f"{type(below).__name__}")
    if stage is not None:
        from .spmd import _host_stage
        if _host_stage(stage):
            raise ValueError("a stage with host string work cannot run in "
                             "the distributed step")
    in_schema = below.output_schema
    devices = [torch.device(d) for d in devices]
    n_dev = len(devices)
    dicts: Dict[int, StringDictionary] = {}

    def feed(table: Dict[str, np.ndarray]):
        """Per device its (columns [(data, valid)], live mask, rows)."""
        cols = []
        for i, f in enumerate(in_schema):
            dt, data, valid = numpy_column(table[f.name])
            if f.dtype.is_string:
                ok = np.ones(len(data), bool) if valid is None else valid
                values, codes = np.unique(
                    np.where(ok, data, "").astype(str), return_inverse=True)
                dicts[i] = StringDictionary.from_values(values)
                data = codes.astype(np.int32)
            cols.append((data, valid))
        n = len(cols[0][0]) if cols else 0
        per = max(1, -(-n // n_dev))
        shards = []
        for s, dev in enumerate(devices):
            lo, hi = min(s * per, n), min((s + 1) * per, n)

            def up(a):
                return None if a is None else upload(
                    torch.from_numpy(np.ascontiguousarray(a[lo:hi])), dev)
            shards.append(([(up(d), up(v)) for d, v in cols],
                           torch.ones(hi - lo, dtype=torch.bool, device=dev),
                           hi - lo))
        return shards

    def step(shards):
        inputs = []
        for (arrays, active, n), dev in zip(shards, devices):
            if stage is not None:
                for kind, payload in stage.steps:
                    ectx = EvalContext(arrays, n, dev, active=active)
                    if kind == "filter":
                        d, v = payload.eval(ectx)
                        keep = d if v is None else d & v
                        active = active & (keep.expand(n) if keep.dim() == 0
                                           else keep)
                    else:
                        arrays = [arrays[src] if e is None else e.eval(ectx)
                                  for _, e, src in payload]
            ectx = EvalContext(arrays, n, dev, active=active)
            keys = [tuple(None if x is None else (
                x.expand(n) if x.dim() == 0 else x).contiguous()
                for x in e.eval(ectx)) for _, e in partial.group_exprs]
            contributions = partial._contributions(ectx)
            inputs.append((keys, [v for v, _ in contributions], active, n))
        channels = partial._channels(contributions)
        key_dtypes = [torch.int32 if e.dtype.is_string
                      else e.dtype.torch_dtype
                      for _, e in partial.group_exprs]
        cap = bucket_cap if bucket_cap is not None else max(
            max(n for _, _, n in shards), 1)
        merged, overflow = exchange_grouped_agg(inputs, key_dtypes, channels,
                                                devices, cap)
        partial._ansi = conf["spark.rapids.tpu.sql.ansi.enabled"]
        out = [(keys, partial._finalize(values), live)
               for keys, values, live in merged]
        return out, overflow

    def source_ordinal(e) -> int:
        """The scan column a bare string key reads, through the stage's
        projections."""
        from ..exprs import BoundReference
        from ..plan.planner import strip_alias
        core = strip_alias(e)
        if not isinstance(core, BoundReference):
            raise ValueError("a string key of the distributed step must be "
                             "a column")
        ordinal = core.ordinal
        for kind, payload in reversed(stage.steps if stage else []):
            if kind == "project":
                _, pe, src = payload[ordinal]
                core = None if pe is None else strip_alias(pe)
                if pe is not None and not isinstance(core, BoundReference):
                    raise ValueError("a string key of the distributed step "
                                     "must be a column")
                ordinal = src if pe is None else core.ordinal
        return ordinal

    step.string_dicts = dicts
    step.source_ordinal = source_ordinal
    return step, feed, (final, partial)


def distributed_agg_collect(df, devices: Sequence[torch.device],
                            table: Dict[str, np.ndarray],
                            bucket_cap: Optional[int] = None
                            ) -> List[Tuple]:
    """Run the distributed step over ``table`` and bring the groups to the
    host as rows (one fetch of every shard's groups and overflow)."""
    from .spmd import ICICapacityOverflow
    step, feed, (_, partial) = plan_distributed_agg(df, devices, bucket_cap)
    out, overflow = step(feed(table))
    host = fetch({"overflow": [o.reshape(1) for o in overflow],
                  "shards": [(keys, values, live)
                              for keys, values, live in out]})
    lost = int(sum(int(o[0]) for o in host["overflow"]))
    if lost:
        raise ICICapacityOverflow(f"exchange bucket overflow: {lost} rows")
    names = [e for _, e in partial.group_exprs]
    ordinals = [step.source_ordinal(e) if e.dtype.is_string else None
                for e in names]
    rows: List[Tuple] = []
    for keys, values, live in host["shards"]:
        # a table's dead slots hold no key: select the groups first
        sel = slice(None) if live is None else live.astype(bool)
        cols = [(d[sel], None if v is None else v[sel])
                for d, v in list(keys) + list(values)]
        for j, ((d, v), e, o) in enumerate(zip(cols, names, ordinals)):
            if e.dtype.is_string:
                cols[j] = (step.string_dicts[o].values()[d], v)
        for r in range(len(cols[0][0])):
            rows.append(tuple(
                None if v is not None and not v[r] else
                (d[r].item() if hasattr(d[r], "item") else d[r])
                for d, v in cols))
    return rows
