"""The wrap → tag → convert planner (``spark_rapids_tpu/plan/overrides.py``
counterpart).

* wrap: a meta tree over the logical plan;
* tag: per-node TypeSig and capability checks collect human-readable
  reasons a node cannot run on the device;
* convert: supported nodes become device operators (project/filter chains
  fuse into one ``StageExec``); tagged nodes become CPU operators;
* explain: per-node placement, ``*`` on the device and ``!`` on the CPU
  with ``@`` reason lines, in the reference's format.

The plan is optimized first (``optimizer.optimize``: filter pushdown and
column pruning), for execution and explain alike.  The port has one CPU
operator so far, the host sort that an ORDER BY on string keys needs
(TPC-H Q1, Q4, Q21); any other fallback, and any device operator not
ported yet, raises ``NotImplementedError`` naming its ROADMAP item.
``Distinct`` becomes an aggregate grouped on every column (reference
``overrides.py:405``); ``Sample`` becomes ``SampleExec`` (:433) and
``Generate`` ``GenerateExec`` (:465), tagged for the CPU as the reference
tags it (:203-215: string, decimal or nested elements), where the port
raises naming ROADMAP item 6; a device ORDER BY becomes ``SortExec`` (reference
:412) and a LIMIT over a device ORDER BY ``TopKExec`` where the top-k
kernel reaches (else ``LimitExec`` over the sort, as over anything else,
``exec_nodes.py``); a ``Window`` is tagged as the reference tags it
(:279-300) and becomes ``WindowExec`` (:457).  A window the reference
sends to the CPU (string partition or order keys) raises: the CPU window
is not ported (ROADMAP item 6).  A ``Union`` becomes ``UnionExec``
(reference :442), on the device as there (:216), and a ``Cache``
``CacheExec`` (:438).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..batch import Schema
from ..config import TpuConf
from ..exprs import BoundReference, Expression, bind
from . import logical as L
from .physical import AggregateExec, ScanExec, StageExec, TpuExec
from .optimizer import optimize
from .planner import bind_project, strip_alias
from .stringpred import lowerable_kind

__all__ = ["apply_overrides", "explain_plan", "NodeMeta"]

EXPLAIN_HEADER = ("*  = runs on GPU\n!  = falls back to CPU (reasons follow "
                  "on @-lines)\n")


def expr_reasons(e: Expression, allow_string_passthrough: bool = True,
                 allow_string_preds: bool = False) -> List[str]:
    """Reasons this bound expression tree cannot run on the device.

    ``allow_string_preds``: inside stages, boolean subtrees over one string
    column are evaluated on the host per distinct value
    (``plan/stringpred.py``), so they do not disqualify the node."""
    reasons: List[str] = []
    core = strip_alias(e)
    if isinstance(core, BoundReference):
        if core.dtype.is_host_carried:
            if not allow_string_passthrough:
                reasons.append(
                    f"host-carried column {core.name or core.ordinal} "
                    f"({core.dtype}) used in computation")
        else:
            r = core.output_sig.check(core.dtype)
            if r is not None:
                reasons.append(f"column {core.name or core.ordinal}: {r}")
        return reasons

    def walk(node: Expression):
        if allow_string_preds and lowerable_kind(node) is not None:
            return
        dt = node.dtype
        if dt is not None:
            if dt.is_string:
                reasons.append(
                    f"expression {type(node).__name__} produces/consumes "
                    f"string (device string kernels pending)")
                return
            r = node.output_sig.check(dt)
            if r is not None:
                label = (f"column {node.name or node.ordinal}"
                         if isinstance(node, BoundReference)
                         else type(node).__name__)
                reasons.append(f"{label}: {r}")
                return
        for c in node.children:
            cdt = c.dtype
            if cdt is not None and not cdt.is_string:
                r = node.input_sig.check(cdt)
                if r is not None:
                    reasons.append(
                        f"{type(node).__name__} input "
                        f"{getattr(c, 'name', '') or type(c).__name__}: {r}")
                    continue
            walk(c)

    walk(core)
    return reasons


class NodeMeta:
    def __init__(self, plan: L.LogicalPlan, conf: TpuConf):
        self.plan = plan
        self.conf = conf
        self.children = [NodeMeta(c, conf) for c in plan.children]
        self.reasons: List[str] = []

    def will_not_work(self, reason: str):
        self.reasons.append(reason)

    @property
    def on_device(self) -> bool:
        return not self.reasons

    def tag(self):
        for c in self.children:
            c.tag()
        if not self.conf["spark.rapids.tpu.sql.enabled"]:
            self.will_not_work("spark.rapids.tpu.sql.enabled is false")
            return
        try:
            self._tag_self()
        except (TypeError, KeyError, ValueError) as ex:
            self.will_not_work(f"tagging error: {ex}")

    def _tag_self(self):
        p = self.plan
        if isinstance(p, L.LogicalScan):
            return
        if isinstance(p, L.Project):
            schema = p.children[0].schema()
            for name, e in p.exprs:
                for r in expr_reasons(bind(e, schema),
                                      allow_string_preds=True):
                    self.will_not_work(f"{name}: {r}")
            return
        if isinstance(p, L.Filter):
            b = bind(p.condition, p.children[0].schema())
            for r in expr_reasons(b, allow_string_passthrough=False,
                                  allow_string_preds=True):
                self.will_not_work(f"condition: {r}")
            return
        if isinstance(p, L.Generate):
            f = next((f for f in p.children[0].schema()
                      if f.name == p.column), None)
            if f is None or f.dtype.element is None:
                self.will_not_work(
                    f"explode column {p.column!r} is not an ARRAY")
            else:
                elem = f.dtype.element
                if elem.is_string or elem.is_nested or elem.is_decimal:
                    self.will_not_work(
                        f"explode of array<{elem}> runs on CPU (elements "
                        f"have no device representation)")
            return
        if isinstance(p, (L.Limit, L.Union, L.Distinct, L.Sample, L.Cache)):
            # Distinct groups by bare column references: string columns
            # go through dictionary codes like any group key
            return
        if isinstance(p, L.Join):
            for keys, child, side in ((p.left_keys, p.children[0], "left"),
                                      (p.right_keys, p.children[1], "right")):
                schema = child.schema()
                for k in keys:
                    b = bind(k, schema)
                    core = strip_alias(b)
                    if core.dtype is not None and core.dtype.is_string:
                        # placed as the reference places it (bare string
                        # columns join on dictionary codes there); the
                        # port's join refuses string keys when it is built
                        if not isinstance(core, BoundReference):
                            self.will_not_work(
                                f"{side} join key is a computed string "
                                f"expression (device string kernels "
                                f"pending)")
                        continue
                    if core.dtype is not None and \
                            core.dtype.is_wide_decimal:
                        # the reference's one-word hash kernels
                        # (overrides.py:236-239); DECIMAL(p <= 18) keys
                        # join as int64
                        self.will_not_work(
                            f"{side} join key: decimal128 join keys run "
                            "on CPU (one-word hash kernels)")
                        continue
                    for r in expr_reasons(b, allow_string_passthrough=False):
                        self.will_not_work(f"{side} join key: {r}")
            if p.how not in ("inner", "left", "left_outer", "right",
                             "right_outer", "full", "full_outer", "semi",
                             "anti", "left_semi", "left_anti", "cross",
                             "existence"):
                self.will_not_work(f"join type {p.how} not supported")
            # residual conditions: as the reference tags them (:249-268)
            outer = ("left", "left_outer", "right", "right_outer", "full",
                     "full_outer", "outer")
            if p.condition is not None and p.how not in outer + (
                    "inner", "semi", "anti", "existence", "left_semi",
                    "left_anti"):
                self.will_not_work(f"non-equi residual condition on "
                                   f"{p.how} join runs on CPU")
            elif p.condition is not None:
                # an outer USING join with a condition stays on the device
                # (the reference sends it to the CPU: its conditioned
                # assembly does not coalesce USING keys; the port's does)
                both = Schema.pair(p.children[0].schema(),
                                   p.children[1].schema())
                for r in expr_reasons(bind(p.condition, both),
                                      allow_string_passthrough=False):
                    self.will_not_work(f"join condition: {r}")
            return
        if isinstance(p, L.Aggregate):
            schema = p.children[0].schema()
            for name, e in p.group_exprs:
                core = strip_alias(bind(e, schema))
                if core.dtype is not None and core.dtype.is_string:
                    # bare string columns group on the device via
                    # dictionary codes (ops/strings.py)
                    if not isinstance(core, BoundReference):
                        self.will_not_work(
                            f"group key {name} is a computed string "
                            f"expression (device string kernels pending)")
                elif core.dtype is not None and core.dtype.is_wide_decimal:
                    # the reference's one-word grouping kernels
                    # (overrides.py:172-177); DECIMAL(p <= 18) keys group
                    # as int64
                    self.will_not_work(
                        f"group key {name}: decimal128 grouping keys "
                        "run on CPU")
                else:
                    for r in expr_reasons(core,
                                          allow_string_passthrough=False):
                        self.will_not_work(f"group key {name}: {r}")
            # the DataFrame splits arithmetic over aggregate calls into a
            # projection above (dataframe._decompose_agg_exprs): only plain
            # calls reach an Aggregate
            for name, e in p.agg_exprs:
                b = strip_alias(bind(e, schema))
                for c in b.children:
                    for r in expr_reasons(c, allow_string_passthrough=False):
                        self.will_not_work(f"aggregate {name}: {r}")
            return
        if isinstance(p, L.Sort):
            schema = p.children[0].schema()
            for o in p.orders:
                for r in expr_reasons(bind(o.expr, schema),
                                      allow_string_passthrough=False):
                    self.will_not_work(f"sort key: {r}")
            return
        if isinstance(p, L.Window):
            from ..windowfns import WindowExpression, device_support_reason
            schema = p.children[0].schema()
            for name, e in p.window_exprs:
                b = strip_alias(bind(e, schema))
                if not isinstance(b, WindowExpression):
                    self.will_not_work(f"{name} is not a window expression")
                    continue
                r = device_support_reason(b)
                if r:
                    self.will_not_work(f"{name}: {r}")
                for pe in b.spec.partition_by:
                    for rr in expr_reasons(pe,
                                           allow_string_passthrough=False):
                        self.will_not_work(f"{name} partition key: {rr}")
                for o in b.spec.order_by:
                    for rr in expr_reasons(o.expr,
                                           allow_string_passthrough=False):
                        self.will_not_work(f"{name} order key: {rr}")
                for c in b.func.children:
                    for rr in expr_reasons(c, allow_string_passthrough=False):
                        self.will_not_work(f"{name}: {rr}")
            return
        self.will_not_work(f"operator {type(p).__name__} has no GPU version")

    def explain_lines(self, indent: int = 0) -> List[str]:
        mark = "*" if self.on_device else "!"
        lines = ["  " * indent + f"{mark} {self.plan.node_desc()}"]
        lines += ["  " * indent + f"    @{r}" for r in self.reasons]
        for c in self.children:
            lines += c.explain_lines(indent + 1)
        return lines


def _plan_aggregate(child: TpuExec, group_bound, agg_bound,
                    conf: TpuConf) -> TpuExec:
    """A grouped aggregation as partial -> shuffle exchange -> final (the
    reference's ``_plan_aggregate`` :322): under HOST and ICI always,
    under CACHE_ONLY when ``sql.agg.singleProcessComplete`` is false; an
    ungrouped aggregate, or exchanges off, is one complete pass.  The
    partial and final share one string-dictionary registry, and the
    exchange coalesces small partitions on read (the final needs whole
    groups per batch, not partition alignment)."""
    if not group_bound or not conf["spark.rapids.tpu.sql.exchange.enabled"]:
        return AggregateExec(child, group_bound, agg_bound)
    if conf["spark.rapids.tpu.shuffle.mode"] == "CACHE_ONLY" \
            and conf["spark.rapids.tpu.sql.agg.singleProcessComplete"]:
        return AggregateExec(child, group_bound, agg_bound)
    from .exchange_exec import ShuffleExchangeExec
    shared: dict = {}
    partial = AggregateExec(child, group_bound, agg_bound, mode="partial",
                            string_dicts=shared)
    keys = [BoundReference(i, f.dtype, f.nullable, f.name)
            for i, f in enumerate(
                partial.output_schema.fields[:len(group_bound)])]
    exchange = ShuffleExchangeExec(
        partial, keys, conf["spark.rapids.tpu.sql.shuffle.partitions"],
        shared, coalesce_output=True)
    final_keys = [(n, BoundReference(i, e.dtype, e.nullable, n))
                  for i, (n, e) in enumerate(group_bound)]
    return AggregateExec(exchange, final_keys, agg_bound, mode="final",
                         string_dicts=shared)


def _convert(meta: NodeMeta, conf: TpuConf) -> TpuExec:
    p = meta.plan
    if not meta.on_device:
        if not conf["spark.rapids.tpu.sql.fallback.enabled"]:
            raise NotImplementedError(
                f"{type(p).__name__} cannot run on the GPU and CPU fallback "
                f"is disabled: {'; '.join(meta.reasons)}")
        if conf["spark.rapids.tpu.test.validateExecsOnTpu"]:
            raise AssertionError(
                f"validateExecsOnTpu: {type(p).__name__} fell back to CPU: "
                f"{'; '.join(meta.reasons)}")
        if isinstance(p, L.Sort):
            from ..cpu.exec import CpuSortExec
            child = _convert(meta.children[0], conf)
            schema = child.output_schema
            return CpuSortExec(child, [(bind(o.expr, schema), o.ascending,
                                        o.nulls_first) for o in p.orders])
        if isinstance(p, L.Window):
            raise NotImplementedError(
                f"the CPU window operator is not ported yet (ROADMAP.md "
                f"item 6, the cpu/ fallback operators): "
                f"{'; '.join(meta.reasons)}")
        raise NotImplementedError(
            f"the CPU fallback for {type(p).__name__} is not ported yet "
            f"(ROADMAP.md item 6, the cpu/ fallback operators): "
            f"{'; '.join(meta.reasons)}")

    if isinstance(p, (L.Project, L.Filter)):
        chain: List[NodeMeta] = []
        node = meta
        while isinstance(node.plan, (L.Project, L.Filter)) \
                and node.on_device:
            chain.append(node)
            node = node.children[0]
        child = _convert(node, conf)
        schema = child.output_schema
        steps: List[Tuple[str, object]] = []
        for nm in reversed(chain):
            if isinstance(nm.plan, L.Filter):
                steps.append(("filter", bind(nm.plan.condition, schema)))
            else:
                triples, schema = bind_project(nm.plan.exprs, schema)
                steps.append(("project", triples))
        return StageExec(child, steps, schema)

    if isinstance(p, L.LogicalScan):
        return ScanExec(p.schema(), p.source)

    if isinstance(p, L.Aggregate):
        child = _convert(meta.children[0], conf)
        schema = child.output_schema
        return _plan_aggregate(
            child, [(n, bind(e, schema)) for n, e in p.group_exprs],
            [(n, strip_alias(bind(e, schema))) for n, e in p.agg_exprs],
            conf)

    if isinstance(p, L.Distinct):
        child = _convert(meta.children[0], conf)
        schema = child.output_schema
        return _plan_aggregate(
            child, [(f.name, BoundReference(i, f.dtype, f.nullable, f.name))
                    for i, f in enumerate(schema)], [], conf)

    if isinstance(p, L.Sort):
        from .exec_nodes import SortExec
        child = _convert(meta.children[0], conf)
        schema = child.output_schema
        return SortExec(child, [(bind(o.expr, schema), o.ascending,
                                 o.nulls_first) for o in p.orders])

    if isinstance(p, L.Join):
        from .planner import plan_join
        return plan_join(p, _convert(meta.children[0], conf),
                         _convert(meta.children[1], conf), conf)

    if isinstance(p, L.Window):
        from .window_exec import WindowExec
        child = _convert(meta.children[0], conf)
        schema = child.output_schema
        return WindowExec(child, [(n, strip_alias(bind(e, schema)))
                                  for n, e in p.window_exprs])

    if isinstance(p, L.Sample):
        from .exec_nodes import SampleExec
        return SampleExec(_convert(meta.children[0], conf), p.fraction,
                          p.seed)

    if isinstance(p, L.Generate):
        from .exec_nodes import GenerateExec
        return GenerateExec(_convert(meta.children[0], conf), p.column,
                            p.out_name, p.outer, p.schema())

    if isinstance(p, L.Union):
        from .exec_nodes import UnionExec
        return UnionExec([_convert(c, conf) for c in meta.children],
                         p.schema())

    if isinstance(p, L.Cache):
        from .exec_nodes import CacheExec
        return CacheExec(_convert(meta.children[0], conf), p)

    if isinstance(p, L.Limit):
        from .exec_nodes import LimitExec
        from ..ops.topk import TK_MAX_K, TK_MAX_KEYS
        sort_meta = meta.children[0]
        if not (isinstance(sort_meta.plan, L.Sort) and sort_meta.on_device):
            return LimitExec(_convert(sort_meta, conf), p.n)
        if p.n > TK_MAX_K or len(sort_meta.plan.orders) > TK_MAX_KEYS:
            # past the top-k kernel's reach: the full sort, then the head
            return LimitExec(_convert(sort_meta, conf), p.n)
        from .exec_nodes import TopKExec
        child = _convert(sort_meta.children[0], conf)
        schema = child.output_schema
        return TopKExec(child, [(bind(o.expr, schema), o.ascending,
                                 o.nulls_first)
                                for o in sort_meta.plan.orders], p.n)

    raise NotImplementedError(
        f"the device {type(p).__name__} operator is not ported yet "
        f"(ROADMAP.md, modules to port)")


def _tagged(plan: L.LogicalPlan, conf: TpuConf) -> NodeMeta:
    meta = NodeMeta(plan, conf)
    meta.tag()
    return meta


def apply_overrides(plan: L.LogicalPlan, conf: Optional[TpuConf] = None
                    ) -> TpuExec:
    conf = conf or TpuConf()
    meta = _tagged(optimize(plan), conf)
    explain = conf["spark.rapids.tpu.sql.explain"]
    if explain == "ALL" or (explain == "NOT_ON_TPU" and any(
            ln.lstrip().startswith(("!", "@"))
            for ln in meta.explain_lines())):
        import logging
        logging.getLogger("spark_rapids_tpu_torch.overrides").info(
            "plan placement:\n%s", "\n".join(meta.explain_lines()))
    return _convert(meta, conf)


def explain_plan(plan: L.LogicalPlan, conf: Optional[TpuConf] = None) -> str:
    meta = _tagged(optimize(plan), conf or TpuConf())
    return EXPLAIN_HEADER + "\n".join(meta.explain_lines())
