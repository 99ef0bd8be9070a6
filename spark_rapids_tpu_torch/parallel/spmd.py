"""Plan fragments run shard by shard over a device mesh
(``spark_rapids_tpu/parallel/spmd.py`` counterpart, ``shuffle.mode=ICI``).

The reference lowers a plan *fragment* that contains exchanges into ONE
jitted ``shard_map`` program over a ``jax.sharding.Mesh``: each
``ShuffleExchangeExec`` becomes a bucketize and an ``all_to_all`` of the
bucket axis (``parallel/exchange.py``), and the operators between
exchanges (stages, partial and final aggregates, equi-joins) run per
device shard.  The port's mesh is a list of ``torch.device``s
(``Session.ici_mesh``/``set_mesh``) and a fragment runs in one process:
every lowered node takes the list of shards ``[(arrays, active)]`` (per
column its (data, valid), and the live mask) and gives the next list, one
shard after the other; an exchange moves the buckets to their
destination devices with ``copy_``.

Dataflow per query, as the reference's:

  1. ``distribute_plan`` finds the topmost lowerable subtree that holds
     at least one exchange (the *fragment*).
  2. Subtrees under it that do not lower become *leaves*: run on the
     single-process executor, concatenated (selection kept, so no
     compaction fetch) and cut row-wise across the mesh, or copied whole
     to every device for a broadcast join's build side.  Strings ride as
     codes of one dictionary, which the session keeps across queries.
  3. The fragment runs.  Bucket and join capacities are fixed per run
     (``shuffle.ici.bucketRows``, ``shuffle.ici.joinOutputRows``); rows
     past them are counted, never kept, and a count above 0 raises
     ``ICICapacityOverflow``, which ``distribute_plan`` answers by running
     the fragment again with every capacity ×4, up to
     ``shuffle.ici.overflowRetries`` times, before it surfaces.
  4. The fragment's shards, concatenated on the session's device with
     their live masks, replace it as an in-memory input; the rest of the
     plan (sort, top-k, limit, ...) runs on the normal executor.  Repeat
     until no lowerable fragment remains.

Blocking fetches: the reference's step is one program and one fetch of its
overflow counters.  Here a node that must read a count fetches it for
every shard at once (a join's output sizes, a large aggregate table's
group count), pending overflow counters riding along, and the fragment
ends with one fetch of the counters still unread.

An exchange that is present but does not lower raises unless
``shuffle.ici.fallback`` is set: a user who asks for ICI never silently
gets the single-process shuffle.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..batch import ColumnBatch, DeviceColumn, DictStringColumn, Schema
from ..exprs import EvalContext
from ..ops import groupby, join
from ..ops.strings import StringDictionary, encode_column
from ..plan.physical import TpuExec
from ..utils.metrics import QueryStats, fetch
from .exchange import bucketize, exchange, hash_ids, received_active

log = logging.getLogger("spark_rapids_tpu_torch.spmd")

__all__ = ["distribute_plan", "NotLowerable", "ICICapacityOverflow",
           "bucket_capacity"]

Value = Tuple[torch.Tensor, Optional[torch.Tensor]]
Shard = Tuple[List[Value], torch.Tensor]


class NotLowerable(Exception):
    """A plan node (or what it needs) cannot run inside a fragment."""


class ICICapacityOverflow(RuntimeError):
    """A fixed-capacity exchange bucket or join expansion overflowed.
    ``distribute_plan`` catches it and runs the fragment again at 4x
    capacities (``shuffle.ici.overflowRetries``) before surfacing it."""


def bucket_capacity(n_rows: int, min_capacity: int = 1024) -> int:
    """Smallest power of two >= max(n_rows, min_capacity) (the reference's
    ``batch.bucket_capacity`` ladder)."""
    cap = max(int(min_capacity), 1)
    n = max(int(n_rows), 1)
    while cap < n:
        cap <<= 1
    return cap


def _full(x: Optional[torch.Tensor], n: int) -> Optional[torch.Tensor]:
    """A contiguous [n] column (a literal evaluates to a 0-dim tensor)."""
    if x is None:
        return None
    return (x.expand(n) if x.dim() == 0 else x).contiguous()


def _ones(n: int, device) -> torch.Tensor:
    return torch.ones(n, dtype=torch.bool, device=device)


class _Env:
    """What one run of a fragment shares: the shards of its leaves, the
    mesh, the fragment-wide string dictionary and the overflow counters
    not read yet."""

    def __init__(self, devices: Sequence[torch.device], conf,
                 sdict: StringDictionary):
        self.devices = list(devices)
        self.conf = conf
        self.sdict = sdict
        self.leaves: Dict[int, List[Shard]] = {}
        # (label, per-shard int64 [1] counters) not fetched yet
        self.overflow: List[Tuple[str, List[torch.Tensor]]] = []

    def fetch_with_overflow(self, tensors: List[torch.Tensor], where):
        """ONE fetch of ``tensors`` (each int64, moved to ``where``) and of
        every pending overflow counter; raises ICICapacityOverflow when a
        counter is above 0."""
        pend, self.overflow = self.overflow, []
        flat = [t.reshape(-1).to(torch.int64).to(where) for t in tensors]
        for _, cs in pend:
            flat += [c.reshape(-1).to(torch.int64).to(where) for c in cs]
        if not flat:
            return []
        host = fetch(torch.cat(flat))
        n = sum(t.numel() for t in tensors)
        _raise_overflow(pend, host[n:])
        return host[:n]


def _raise_overflow(pend, counts) -> None:
    detail, at = [], 0
    for label, cs in pend:
        k = sum(c.numel() for c in cs)
        lost = int(counts[at:at + k].sum())
        at += k
        if lost:
            detail.append(f"{label}: {lost} rows")
    if detail:
        raise ICICapacityOverflow(
            "ICI fragment capacity overflow — would drop rows; raise the "
            "named conf and retry: " + "; ".join(detail))


# ---------------------------------------------------------------------------------
# Lowered-node tree
# ---------------------------------------------------------------------------------

class _Leaf:
    """A subtree run single-process and cut across the mesh."""

    def __init__(self, phys, index: int):
        self.phys = phys
        self.schema = phys.output_schema
        self.index = index
        self.cap: Optional[int] = None   # per-device rows, set when run
        self.replicated = False          # a broadcast build: every device

    def resolve(self) -> None:
        assert self.cap is not None, "leaf not materialized"

    def emit(self, env: _Env) -> List[Shard]:
        return env.leaves[self.index]


class _Stage:
    """StageExec's filter and project steps per shard."""

    def __init__(self, stage, child):
        self.stage = stage
        self.child = child
        self.schema = stage.output_schema
        self.cap = None

    def resolve(self) -> None:
        self.child.resolve()
        self.cap = self.child.cap

    def emit(self, env: _Env) -> List[Shard]:
        out = []
        for (arrays, active), dev in zip(self.child.emit(env), env.devices):
            n = active.shape[0]
            cur = list(arrays)
            for kind, payload in self.stage.steps:
                ectx = EvalContext(cur, n, dev, active=active)
                if kind == "filter":
                    d, v = payload.eval(ectx)
                    keep = _full(d if v is None else d & v, n)
                    active = active & keep
                else:
                    cur = [cur[src] if e is None else
                           tuple(_full(x, n) for x in e.eval(ectx))
                           for _, e, src in payload]
            out.append((cur, active))
        return out


class _Exchange:
    """ShuffleExchangeExec → bucketize by pmod(murmur3(keys), n_devices)
    and the swap of the bucket axis: equal keys meet on one device."""

    LABEL = "exchange bucket (spark.rapids.tpu.shuffle.ici.bucketRows)"

    def __init__(self, exch, child, n_dev: int, bucket_rows: int,
                 cap_scale: int = 1):
        self.exch = exch
        self.child = child
        self.schema = exch.output_schema
        self.n_dev = n_dev
        self._bucket_rows = bucket_rows
        self._cap_scale = cap_scale
        self.bucket_cap = None
        self.cap = None

    def resolve(self) -> None:
        self.child.resolve()
        # auto: a device holds at most child.cap live rows, so a bucket of
        # child.cap never overflows (memory-heavy; bucketRows bounds it)
        self.bucket_cap = (self._bucket_rows * self._cap_scale
                           if self._bucket_rows > 0 else self.child.cap)
        self.cap = self.n_dev * self.bucket_cap

    def emit(self, env: _Env) -> List[Shard]:
        parts, sent, overflow = [], [], []
        for (arrays, active), dev in zip(self.child.emit(env), env.devices):
            n = active.shape[0]
            ectx = EvalContext(list(arrays), n, dev, active=active)
            keys = [tuple(_full(x, n) for x in e.eval(ectx))
                    for e in self.exch.key_exprs]
            pids = hash_ids(keys, self.n_dev)
            flat = []
            for d, v in arrays:
                flat += [d, _ones(n, dev) if v is None else v]
            b, s, o = bucketize(pids, active, self.n_dev, self.bucket_cap,
                                flat)
            parts.append(b)
            sent.append(s)
            overflow.append(o.reshape(1))
        env.overflow.append((self.LABEL, overflow))
        recv, counts = exchange(parts, sent, env.devices)
        out = []
        for arrays, c in zip(recv, counts):
            out.append(([(arrays[i], arrays[i + 1])
                         for i in range(0, len(arrays), 2)],
                        received_active(c, self.bucket_cap)))
        return out


class _Aggregate:
    """AggregateExec partial or final per shard on the hash aggregation
    (``hash_agg.cu``: the update for a partial, the merge ops for a
    final); one fetch for every shard whose table is large enough to be
    compacted."""

    def __init__(self, agg, child):
        self.agg = agg
        self.child = child
        self.schema = agg.output_schema
        self.cap = None

    def resolve(self) -> None:
        self.child.resolve()
        self.cap = self.child.cap

    def emit(self, env: _Env) -> List[Shard]:
        agg = self.agg
        agg._ansi = env.conf["spark.rapids.tpu.sql.ansi.enabled"]
        nk = len(agg.group_exprs)
        # string keys are codes of the fragment's dictionary: its size
        # bounds their groups (and so the tables)
        key_bound = agg._key_bound([env.sdict if e.dtype.is_string else None
                                    for _, e in agg.group_exprs])
        accs = []
        for (arrays, active), dev in zip(self.child.emit(env), env.devices):
            n = active.shape[0]
            ectx = EvalContext(list(arrays), n, dev, active=active)
            words = [(groupby.key_word(_full(d, n)), _full(v, n))
                     for d, v in (e.eval(ectx) for _, e in agg.group_exprs)]
            if agg.mode == "final":
                acc = groupby.HashAccumulator(nk, agg._merge_channels(), dev,
                                              key_bound=key_bound)
                acc.merge(words, list(arrays[nk:]), active, n)
            else:
                contributions = agg._contributions(ectx)
                acc = groupby.HashAccumulator(
                    nk, agg._channels(contributions), dev,
                    key_bound=key_bound)
                acc.update(words, [v for v, _ in contributions], active, n)
            accs.append(acc)
        big = [a for a in accs if a.needs_count()]
        counts = env.fetch_with_overflow([a.ngroups for a in big],
                                         env.devices[0]) if big else []
        groups = dict(zip(map(id, big), (int(c) for c in counts)))
        out = []
        for acc in accs:
            keys, values, live = acc.finish(groups.get(id(acc)))
            n = keys[0][0].shape[0]
            cols = [(word.to(torch.int32) if f.dtype.is_string else
                     groupby.key_from_word(word, f.dtype.torch_dtype), valid)
                    for f, (word, valid) in zip(self.schema.fields, keys)]
            cols += [(c.data, c.valid) for c in agg._value_columns(values)]
            out.append((cols, _ones(n, acc.device) if live is None
                        else live))
        return out


class _Join:
    """An equi-join per shard on the sorted match state (``sort_join.cu``)
    and the expansion (``csr_join.cu``); one fetch reads every shard's
    output size, and a size past the fixed capacity is an overflow."""

    LABEL = "join expansion (spark.rapids.tpu.shuffle.ici.joinOutputRows)"

    def __init__(self, join_exec, left, right, out_rows: int,
                 cap_scale: int = 1):
        self.join = join_exec
        self.left = left
        self.right = right
        self.schema = join_exec.output_schema
        self._out_rows = out_rows
        self._cap_scale = cap_scale
        self.cap = None

    def resolve(self) -> None:
        self.left.resolve()
        self.right.resolve()
        if self.join.how in ("semi", "anti"):
            self.cap = self.left.cap
        else:
            auto = self.left.cap + self.right.cap
            self.cap = bucket_capacity(
                (self._out_rows if self._out_rows > 0 else auto)
                * self._cap_scale)

    def _keys(self, side: int, arrays, active, dev) -> List[Value]:
        n = active.shape[0]
        ectx = EvalContext(list(arrays), n, dev, active=active)
        out = []
        for e, ct in zip(self.join.key_exprs[side], self.join.common):
            d, v = e.eval(ectx)
            d = _full(d, n)
            if not ct.is_string and d.dtype != ct.torch_dtype:
                d = d.to(ct.torch_dtype)
            out.append((d, _full(v, n)))
        return out

    def emit(self, env: _Env) -> List[Shard]:
        how = self.join.how
        lefts, rights = self.left.emit(env), self.right.emit(env)
        # the right join probes with its right side
        probe_side = 1 if how == "right" else 0
        states = []
        for l_sh, r_sh, dev in zip(lefts, rights, env.devices):
            probe, build = (r_sh, l_sh) if probe_side else (l_sh, r_sh)
            state = join.sorted_build(
                self._keys(1 - probe_side, build[0], build[1], dev),
                build[1])
            lo, matches, got = join.sorted_probe(
                self._keys(probe_side, probe[0], probe[1], dev), probe[1],
                state, how)
            states.append((probe, build, state, lo, matches, got))
        if how in ("semi", "anti"):
            out = [(list(p[0]), got) for p, _, _, _, _, got in states]
            return self._residual(out, env)
        sizes, unmatched = [], []
        for probe, build, state, lo, matches, offsets in states:
            extra = torch.zeros(1, dtype=torch.int64, device=lo.device)
            mask = None
            if how == "full":
                # build rows no probe row matched: a null-probe row each
                mask, extra = join.unmatched_build_mask(lo, matches, state,
                                                        build[1])
            unmatched.append(mask)
            sizes += [offsets[-1:], extra.reshape(1)]
        host = env.fetch_with_overflow(sizes, env.devices[0])
        lost = sum(max(int(host[2 * i] + host[2 * i + 1]) - self.cap, 0)
                   for i in range(len(states)))
        if lost:
            raise ICICapacityOverflow(
                "ICI fragment capacity overflow — would drop rows; raise "
                f"the named conf and retry: {self.LABEL}: {lost} rows")
        out = []
        for i, (probe, build, state, lo, matches, offsets) in \
                enumerate(states):
            total, extra = int(host[2 * i]), int(host[2 * i + 1])
            pi, bi = join.csr_expand(offsets, lo, state.b_perm, total)
            if extra:
                nb = build[1].shape[0]
                rows = torch.arange(nb, dtype=torch.int32, device=lo.device)
                pi = torch.cat([pi, torch.full((extra,), -1,
                                               dtype=pi.dtype,
                                               device=lo.device)])
                bi = torch.cat([bi, rows[unmatched[i]]])
            p_cols = join.gather_rows(pi, list(probe[0]), nullable=True)
            b_cols = join.gather_rows(bi, list(build[0]), nullable=True)
            out.append((self._assemble(p_cols, b_cols, probe_side),
                        _ones(total + extra, lo.device)))
        return self._residual(out, env)

    def _assemble(self, p_cols, b_cols, probe_side: int) -> List[Value]:
        """Output-schema order: the left fields (a USING key coalesced for
        right and full joins), then the right fields but the USING ones."""
        how = self.join.how
        using = set(self.join.using)
        lsch, rsch = self.left.schema, self.right.schema
        lcols, rcols = (b_cols, p_cols) if probe_side else (p_cols, b_cols)
        out = []
        for f, (d, v) in zip(lsch, lcols):
            if f.name in using and how in ("right", "full") \
                    and f.name in rsch.names():
                rd, rv = rcols[rsch.names().index(f.name)]
                lv = _ones(d.shape[0], d.device) if v is None else v
                rv = _ones(rd.shape[0], rd.device) if rv is None else rv
                d, v = torch.where(lv, d, rd), lv | rv
            out.append((d, v))
        out += [c for f, c in zip(rsch, rcols) if f.name not in using]
        return out

    def _residual(self, shards: List[Shard], env: _Env) -> List[Shard]:
        """An inner join's residual condition ANDed into the live mask."""
        if self.join.condition is None:
            return shards
        from ..exprs import bind
        cond = bind(self.join.condition, self.schema)
        out = []
        for (arrays, active), dev in zip(shards, env.devices):
            n = active.shape[0]
            d, v = cond.eval(EvalContext(list(arrays), n, dev,
                                         active=active))
            out.append((arrays, active & _full(d if v is None else d & v,
                                               n)))
        return out


# ---------------------------------------------------------------------------------
# Lowering
# ---------------------------------------------------------------------------------

def _host_stage(stage) -> bool:
    """Does a stage evaluate anything on the host (string predicates or
    string-valued projections over host columns)?"""
    from ..plan.stringpred import HostStringExpr

    def walk(e) -> bool:
        return isinstance(e, HostStringExpr) or any(
            walk(c) for c in getattr(e, "children", ()))
    for kind, payload in stage.steps:
        exprs = [payload] if kind == "filter" else [
            e for _, e, _ in payload if e is not None]
        if any(walk(e) for e in exprs):
            return True
    return False


def _lower(node, leaves: List[_Leaf], conf, n_dev: int,
           has_exchange: List[bool], cap_scale: int = 1):
    """Lower ``node``; subtrees that do not lower become leaves.  Raises
    NotLowerable where a leaf would have to hold an exchange."""
    from ..plan.exchange_exec import ShuffleExchangeExec
    from ..plan.join_exec import BroadcastJoinExec, SortMergeJoinExec
    from ..plan.physical import AggregateExec, StageExec

    def lower(child):
        return _lower(child, leaves, conf, n_dev, has_exchange, cap_scale)

    if isinstance(node, ShuffleExchangeExec):
        child = lower(node.children[0])
        has_exchange[0] = True
        return _Exchange(node, child, n_dev,
                         conf["spark.rapids.tpu.shuffle.ici.bucketRows"],
                         cap_scale)

    if isinstance(node, StageExec):
        if _host_stage(node) or conf["spark.rapids.tpu.sql.ansi.enabled"]:
            # host string work cannot run on code shards, and ANSI errors
            # are checked at the stage's end: the stage runs
            # single-process and its result is cut across the mesh
            return _make_leaf(node, leaves)
        return _Stage(node, lower(node.children[0]))

    if isinstance(node, AggregateExec):
        if node.mode not in ("partial", "final") or not node.group_exprs:
            return _make_leaf(node, leaves)
        return _Aggregate(node, lower(node.children[0]))

    if isinstance(node, BroadcastJoinExec):
        if node.how in ("cross", "existence") or (
                node.condition is not None and node.how != "inner"):
            # no bounded expansion for a nested loop; a non-inner
            # residual condition takes part in the matching, which the
            # single-process path does (_conditioned)
            return _make_leaf(node, leaves)
        n_leaves, had = len(leaves), has_exchange[0]
        try:
            probe = lower(node.children[1 - node.build_side])
            built = node.children[node.build_side]
            # the build side rides replicated: every device holds it
            build = _make_leaf(built.children[0] if built.children
                               else built, leaves)
            build.replicated = True
        except NotLowerable:
            del leaves[n_leaves:]
            has_exchange[0] = had
            raise
        left, right = (build, probe) if node.build_side == 0 \
            else (probe, build)
        return _Join(node, left, right,
                     conf["spark.rapids.tpu.shuffle.ici.joinOutputRows"],
                     cap_scale)

    if isinstance(node, SortMergeJoinExec):
        if node.how in ("cross", "existence") or (
                node.condition is not None and node.how != "inner"):
            return _make_leaf(node, leaves)
        n_leaves, had = len(leaves), has_exchange[0]
        left, right = lower(node.children[0]), lower(node.children[1])
        if not (isinstance(left, _Exchange) and isinstance(right, _Exchange)):
            # no colocation guarantee per shard without the exchanges
            del leaves[n_leaves:]
            has_exchange[0] = had
            return _make_leaf(node, leaves)
        return _Join(node, left, right,
                     conf["spark.rapids.tpu.shuffle.ici.joinOutputRows"],
                     cap_scale)

    return _make_leaf(node, leaves)


def _make_leaf(phys, leaves: List[_Leaf]) -> _Leaf:
    if _contains_exchange(phys):
        # running this subtree would run its exchange single-process:
        # refuse, so _find_fragment descends to the inner fragment first
        raise NotLowerable(f"{type(phys).__name__} subtree contains an "
                           f"exchange and cannot be a materialized leaf")
    _check_device_schema(phys.output_schema)
    leaf = _Leaf(phys, len(leaves))
    leaves.append(leaf)
    return leaf


def _check_device_schema(schema: Schema) -> None:
    for f in schema:
        dt = f.dtype
        if dt.is_string:
            continue
        if dt.is_host_carried:
            raise NotLowerable(f"column {f.name!r}: {dt} has no shard "
                               f"representation")
        if dt.is_wide_decimal:
            raise NotLowerable(f"column {f.name!r}: {dt} exceeds the 64-bit "
                               f"shard representation")


def _contains_exchange(node) -> bool:
    from ..plan.exchange_exec import ShuffleExchangeExec
    return isinstance(node, ShuffleExchangeExec) or any(
        _contains_exchange(c) for c in node.children)


def _find_fragment(node, conf, n_dev: int, cap_scale: int = 1):
    """The topmost node whose subtree lowers and holds an exchange:
    (node, lowered root, leaves), or None."""
    try:
        leaves: List[_Leaf] = []
        has_exchange = [False]
        lowered = _lower(node, leaves, conf, n_dev, has_exchange, cap_scale)
        if has_exchange[0] and not isinstance(lowered, _Leaf):
            return node, lowered, leaves
    except NotLowerable as e:
        log.info("ICI: subtree %s not lowerable: %s", type(node).__name__, e)
    for c in node.children:
        found = _find_fragment(c, conf, n_dev, cap_scale)
        if found is not None:
            return found
    return None


# ---------------------------------------------------------------------------------
# Fragment execution
# ---------------------------------------------------------------------------------

def _leaf_values(col, sdict: StringDictionary, device) -> Value:
    """A leaf column as device (data, valid): strings as codes of the
    fragment's dictionary."""
    if isinstance(col, DeviceColumn):
        return col.data, col.valid
    _, codes, valid = encode_column(col, sdict, device)
    return codes, valid


def _cat(parts: List[Value]) -> Value:
    data = torch.cat([d for d, _ in parts])
    if all(v is None for _, v in parts):
        return data, None
    return data, torch.cat([_ones(d.shape[0], d.device) if v is None else v
                            for d, v in parts])


def _materialize_leaf(leaf: _Leaf, ctx, devices, sdict: StringDictionary,
                      cache: dict) -> List[Shard]:
    """Run the leaf's subtree single-process (once per fragment, retries
    included) and cut it row-wise across the mesh, or copy it whole to
    every device when it is replicated.  Strings are encoded batch by
    batch, so an in-memory scan's columns keep their encodings from one
    run to the next."""
    n_dev = len(devices)
    key = id(leaf.phys)
    if key not in cache:
        batches = [b for b in leaf.phys.execute(ctx) if b.num_rows]
        if batches:
            cols = [_cat([_leaf_values(b.columns[i], sdict, ctx.device)
                          for b in batches])
                    for i in range(len(leaf.schema))]
            active = torch.cat([_ones(b.num_rows, ctx.device)
                                if b.sel is None else b.sel
                                for b in batches])
        else:
            cols = [(torch.zeros(0, dtype=torch.int32 if f.dtype.is_string
                                 else f.dtype.torch_dtype,
                                 device=ctx.device), None)
                    for f in leaf.schema]
            active = torch.zeros(0, dtype=torch.bool, device=ctx.device)
        cache[key] = (cols, active)
    cols, active = cache[key]
    rows = active.shape[0]
    if leaf.replicated:
        leaf.cap = bucket_capacity(rows, min_capacity=8)
        spans = [(0, rows)] * n_dev
    else:
        leaf.cap = bucket_capacity(-(-rows // n_dev), min_capacity=8)
        spans = [(min(s * leaf.cap, rows), min((s + 1) * leaf.cap, rows))
                 for s in range(n_dev)]
    out = []
    for (lo, hi), dev in zip(spans, devices):
        out.append(([(d[lo:hi].to(dev), None if v is None
                      else v[lo:hi].to(dev)) for d, v in cols],
                    active[lo:hi].to(dev)))
    return out


def _execute_fragment(lowered, leaves: List[_Leaf], ctx, devices,
                      cache: dict, sdict: StringDictionary) -> ColumnBatch:
    """Run the fragment over the mesh → one batch on the session's device
    (the shards concatenated, their live masks as its selection)."""
    env = _Env(devices, ctx.conf, sdict)
    for leaf in leaves:
        env.leaves[leaf.index] = _materialize_leaf(leaf, ctx, devices, sdict,
                                                   cache)
    lowered.resolve()
    shards = lowered.emit(env)
    live = [a.sum().reshape(1) for _, a in shards]
    n_live = env.fetch_with_overflow(live, ctx.device)
    stats = QueryStats.get()
    if stats is not None:
        stats.ici_fragment_rows += int(n_live.sum())
    cols = []
    for i, f in enumerate(lowered.schema):
        d = torch.cat([arrays[i][0].to(ctx.device) for arrays, _ in shards])
        vs = [arrays[i][1] for arrays, _ in shards]
        v = None if all(x is None for x in vs) else torch.cat(
            [(_ones(a.shape[0], ctx.device) if x is None else x)
             .to(ctx.device) for x, (_, a) in zip(vs, shards)])
        cols.append(DictStringColumn(d, v, sdict.values())
                    if f.dtype.is_string else DeviceColumn(f.dtype, d, v))
    active = torch.cat([a.to(ctx.device) for _, a in shards])
    return ColumnBatch(lowered.schema, cols, active.shape[0], active)


class FragmentResultExec(TpuExec):
    """The output of a fragment that ran on the mesh, in its place in
    the plan (the reference's ``ScanExec(desc="ici-fragment")``)."""

    def __init__(self, schema: Schema, batch: ColumnBatch):
        super().__init__()
        self._schema = schema
        self._batch = batch

    @property
    def output_schema(self) -> Schema:
        return self._schema

    def node_desc(self) -> str:
        return "TpuScan [ici-fragment]"

    def execute(self, ctx):
        yield self._batch


# ---------------------------------------------------------------------------------
# Plan rewrite entry
# ---------------------------------------------------------------------------------

def distribute_plan(phys, ctx, devices: Sequence[torch.device],
                    sdict: Optional[StringDictionary] = None):
    """Run every lowerable exchange-bearing fragment of ``phys`` on the
    mesh ``devices``; returns the rest of the plan for the normal
    executor.  ``sdict``: the dictionary string columns are coded in (the
    session keeps one, so a scan column's encoding is made once)."""
    sdict = StringDictionary() if sdict is None else sdict
    conf = ctx.conf
    n_dev = len(devices)
    stats = QueryStats.get()
    root = phys
    for _ in range(16):
        found = _find_fragment(root, conf, n_dev)
        if found is None:
            break
        frag_node, lowered, leaves = found
        log.info("ICI: executing fragment %s over %d devices (%d leaves)",
                 type(frag_node).__name__, n_dev, len(leaves))
        retries = conf["spark.rapids.tpu.shuffle.ici.overflowRetries"]
        scale, attempt, cache = 1, 0, {}
        while True:
            try:
                batch = _execute_fragment(lowered, leaves, ctx, devices,
                                          cache, sdict)
                break
            except ICICapacityOverflow:
                attempt += 1
                if attempt > retries:
                    raise
                # the same fragment again, every capacity 4x; the leaves
                # ran once and are cut again from the cache
                scale *= 4
                if stats is not None:
                    stats.ici_retries += 1
                log.warning("ICI: capacity overflow, retrying fragment at "
                            "%dx capacities (attempt %d/%d)", scale,
                            attempt, retries)
                refound = _find_fragment(frag_node, conf, n_dev,
                                         cap_scale=scale)
                if refound is None or refound[0] is not frag_node:
                    raise
                _, lowered, leaves = refound
        if stats is not None:
            stats.ici_fragments += 1
        repl = FragmentResultExec(lowered.schema, batch)
        if frag_node is root:
            root = repl
        else:
            _replace_child(root, frag_node, repl)
    else:
        raise RuntimeError("ICI fragment extraction did not converge")
    if _contains_exchange(root):
        if not conf["spark.rapids.tpu.shuffle.ici.fallback"]:
            raise RuntimeError(
                "shuffle.mode=ICI: the plan holds exchanges that could not "
                "be lowered to the mesh; set "
                "spark.rapids.tpu.shuffle.ici.fallback=true to run them "
                "single-process instead")
        log.warning("ICI: residual exchanges run single-process "
                    "(shuffle.ici.fallback=true)")
    return root


def _replace_child(node, old, new) -> bool:
    for i, c in enumerate(node.children):
        if c is old:
            node.children[i] = new
            return True
        if _replace_child(c, old, new):
            return True
    return False
