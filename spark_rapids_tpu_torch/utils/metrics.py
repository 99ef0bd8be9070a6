"""Query statistics, operator metrics and the counted device→host fetch.

Counterpart of ``spark_rapids_tpu/utils/metrics.py`` (``fetch`` :366,
``fetch_scalars`` :439, ``QueryStats``, ``MetricSet``).  Every blocking
device→host transfer of the engine goes through :func:`fetch`, which counts
ONE blocking fetch per call however many tensors ride in it: the copies are
queued into pinned host buffers and the host waits once.  The counts are
comparable with the reference's ``QueryStats.blocking_fetches``.
"""

from __future__ import annotations

import contextlib
import contextvars
import time
from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np
import torch

__all__ = ["QueryStats", "MetricSet", "fetch", "fetch_scalars"]

_STATS_STACK: "contextvars.ContextVar[tuple]" = \
    contextvars.ContextVar("srt_torch_query_stats", default=())

_COUNTERS = ("blocking_fetches", "fetch_bytes", "fetch_wait_s", "uploads",
             "upload_bytes", "shuffle_bytes", "shuffle_bytes_written",
             "shuffle_bytes_read", "ici_fragments", "ici_fragment_rows",
             "ici_retries", "cache_materializations", "cache_replays")


class QueryStats:
    """Per-query sync and upload profile.

    ``upload_events`` holds one (start, end) CUDA event pair per uploaded
    batch, recorded on the stream the copies ran on, so
    :meth:`upload_ms` reads the time the copies took on the device
    timeline.  :meth:`scoped` opens a query scope; on exit its counters
    (not its events) fold into the enclosing scope.
    """

    _process: "QueryStats" = None

    def __init__(self):
        self.blocking_fetches = 0
        self.fetch_bytes = 0
        self.fetch_wait_s = 0.0
        self.uploads = 0
        self.upload_bytes = 0
        # bytes of the batches shuffle exchanges partitioned
        self.shuffle_bytes = 0
        # HOST shuffle: frame bytes written and read back
        self.shuffle_bytes_written = 0
        self.shuffle_bytes_read = 0
        # ICI: mesh fragments run, the rows they put out, and their
        # overflow retries
        self.ici_fragments = 0
        self.ici_fragment_rows = 0
        self.ici_retries = 0
        # df.cache(): runs that executed the cached child, and runs that
        # replayed its batches
        self.cache_materializations = 0
        self.cache_replays = 0
        self.upload_events: List[Tuple[torch.cuda.Event, torch.cuda.Event]] \
            = []

    @classmethod
    def get(cls) -> "QueryStats":
        stack = _STATS_STACK.get()
        if stack:
            return stack[-1]
        if cls._process is None:
            cls._process = QueryStats()
        return cls._process

    @classmethod
    @contextlib.contextmanager
    def scoped(cls):
        parent = cls.get()
        mine = QueryStats()
        token = _STATS_STACK.set(_STATS_STACK.get() + (mine,))
        try:
            yield mine
        finally:
            _STATS_STACK.reset(token)
            for name in _COUNTERS:
                setattr(parent, name,
                        getattr(parent, name) + getattr(mine, name))

    def upload_ms(self) -> float:
        """Device time of this scope's uploads (synchronizes on the last
        event); 0.0 when nothing was uploaded to a CUDA device."""
        if not self.upload_events:
            return 0.0
        self.upload_events[-1][1].synchronize()
        return sum(a.elapsed_time(b) for a, b in self.upload_events)


class MetricSet:
    """Per-operator metrics (GpuMetric analog): counters and timers."""

    def __init__(self, op_id: str):
        self.op_id = op_id
        self.values: Dict[str, float] = defaultdict(float)

    def add(self, name: str, v: float) -> None:
        self.values[name] += v

    @contextlib.contextmanager
    def time(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.values[name] += time.perf_counter() - t0


def _flatten(tree, leaves: list):
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return ("leaf", len(leaves) - 1)
    if isinstance(tree, (list, tuple)):
        return (type(tree), [_flatten(t, leaves) for t in tree])
    if isinstance(tree, dict):
        return (dict, {k: _flatten(v, leaves) for k, v in tree.items()})
    return ("const", tree)


def _unflatten(spec, host: list):
    kind, payload = spec
    if kind == "leaf":
        return host[payload]
    if kind == "const":
        return payload
    if kind is dict:
        return {k: _unflatten(v, host) for k, v in payload.items()}
    return kind(_unflatten(s, host) for s in payload)


def fetch(tree):
    """The engine's one blocking device→host transfer: every tensor leaf
    of ``tree`` (nested lists, tuples and dicts) becomes a numpy array.

    CUDA leaves are copied asynchronously into pinned host buffers and the
    host waits once on the current stream, so a call is one sync however
    many tensors it moves."""
    s = QueryStats.get()
    s.blocking_fetches += 1
    leaves: list = []
    spec = _flatten(tree, leaves)
    t0 = time.perf_counter()
    host = []
    on_cuda = False
    for t in leaves:
        if t.is_cuda:
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            buf.copy_(t, non_blocking=True)
            host.append(buf)
            on_cuda = True
        else:
            host.append(t.detach().clone())
    if on_cuda:
        torch.cuda.current_stream().synchronize()
    out = [h.numpy() for h in host]
    s.fetch_wait_s += time.perf_counter() - t0
    s.fetch_bytes += sum(a.nbytes for a in out)
    return _unflatten(spec, out)


def fetch_scalars(x: torch.Tensor) -> list:
    """Fetch a small tensor of scalars as a list of Python ints."""
    return [int(v) for v in np.ravel(fetch(x))]
