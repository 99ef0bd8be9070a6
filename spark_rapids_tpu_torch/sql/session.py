"""Session: the entry point (``spark_rapids_tpu/sql/session.py``
counterpart).

A session is bound to one ``torch.device``: the CUDA card unless the
caller passes ``device="cpu"``.  Asking for CUDA where there is none
raises; nothing falls back to the CPU.  Every entry point resolves the
plan's subqueries first (``plan/subquery.py``), running each subplan
through ``_collect_rows``, as the reference does (session.py:320, :525).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from ..batch import numpy_column
from ..config import TpuConf
from ..plan import logical as L
from ..plan.physical import CollectExec, ExecContext, MemorySource
from ..runtime.device import DeviceManager, resolve_device
from ..utils.metrics import QueryStats
from .dataframe import DataFrame

__all__ = ["Session"]


class Session:
    """A query session bound to one device."""

    _lock = threading.Lock()
    _active: Optional["Session"] = None

    def __init__(self, settings: Optional[Dict[str, Any]] = None,
                 device: Union[str, torch.device] = "cuda"):
        self.device = resolve_device(device)
        TpuConf(settings)  # refuse unknown keys up front
        self._settings: Dict[str, Any] = dict(settings or {})
        self._last_ctx: Optional[ExecContext] = None
        self._last_stats: Optional[QueryStats] = None

    @classmethod
    def get_or_create(cls, settings: Optional[Dict[str, Any]] = None,
                      device: Union[str, torch.device] = "cuda"
                      ) -> "Session":
        """The process's active session on ``device`` (settings merge into
        it); a request for another device replaces it."""
        dev = resolve_device(device)
        with cls._lock:
            if cls._active is None or cls._active.device != dev:
                cls._active = Session(settings, dev)
            elif settings:
                TpuConf(settings)
                cls._active._settings.update(settings)
            return cls._active

    def conf(self) -> TpuConf:
        return TpuConf(self._settings)

    def device_info(self):
        return DeviceManager.describe(self.device)

    def create_dataframe(self, data: Dict[str, np.ndarray]) -> DataFrame:
        """A DataFrame over a dict of numpy arrays: the same dict the
        reference's ``create_dataframe`` takes.  Columns are converted
        once here (dates to int32 days, object arrays to typed columns);
        the device upload happens per batch when a query runs."""
        columns = {name: numpy_column(arr) for name, arr in data.items()}
        lengths = {len(c[1]) for c in columns.values()}
        if len(lengths) > 1:
            raise ValueError(f"columns differ in length: {sorted(lengths)}")
        src = MemorySource(
            columns, self.conf()["spark.rapids.tpu.sql.batchSizeRows"])
        return DataFrame(L.LogicalScan(src.schema(), src, "local"), self)

    def _clamp_reader_rows(self, src):
        """``reader.batchSizeBytes``: a soft byte cap on one scan batch,
        applied as a row cap from the schema's estimated row width (the
        source's ``with_pushdown`` rebuilds inherit it; reference :101)."""
        from ..plan.cbo import estimated_row_bytes
        byte_cap = self.conf()["spark.rapids.tpu.sql.reader.batchSizeBytes"]
        if byte_cap > 0:
            width = estimated_row_bytes(src.schema())
            src.batch_rows = max(1, min(src.batch_rows, byte_cap // width))
        return src

    def read_parquet(self, path, columns=None) -> DataFrame:
        """A DataFrame over parquet files (a file, a directory, hive
        partition directories or a glob; reference :133), read by the
        port's numpy reader (``io/parquet.py``) with the session's
        ``fileCache.*``, ``scan.exactFilterPushdown``,
        ``multiThreadedRead.numThreads`` and ``reader.batchSizeBytes``."""
        from ..io.parquet import ParquetSource
        conf = self.conf()
        cache_bytes = (
            conf["spark.rapids.tpu.sql.fileCache.maxBytes"]
            if conf["spark.rapids.tpu.sql.fileCache.enabled"] else 0)
        src = ParquetSource(
            path, columns=columns,
            batch_rows=conf["spark.rapids.tpu.sql.batchSizeRows"],
            num_threads=conf[
                "spark.rapids.tpu.sql.multiThreadedRead.numThreads"],
            cache_bytes=cache_bytes,
            exact_filter=conf["spark.rapids.tpu.sql.scan.exactFilterPushdown"])
        src = self._clamp_reader_rows(src)
        return DataFrame(L.LogicalScan(src.schema(), src, src.describe(),
                                       fmt="parquet"), self)

    # -- execution ----------------------------------------------------------------
    def _execute(self, plan: L.LogicalPlan):
        from ..plan.subquery import resolve_subqueries
        return self._collect_rows(resolve_subqueries(plan,
                                                     self._collect_rows))

    def _collect_rows(self, plan: L.LogicalPlan):
        """A subquery-free plan's rows (the subquery resolver's executor
        too)."""
        from ..plan.overrides import apply_overrides
        conf = self.conf()
        phys = apply_overrides(plan, conf)
        ctx = ExecContext(conf, self.device)
        self._last_ctx = ctx
        with QueryStats.scoped() as stats:
            self._last_stats = stats
            return CollectExec(phys).collect_rows(ctx)

    def _execute_device(self, plan: L.LogicalPlan):
        """Execute to ONE compacted device batch, or None when no row comes
        out (reference :517): the batches are concatenated before the
        compaction, so a filtered result costs one count fetch, not one
        per batch."""
        from ..ops import batch_utils
        from ..plan.overrides import apply_overrides
        from ..plan.subquery import resolve_subqueries
        plan = resolve_subqueries(plan, self._collect_rows)
        conf = self.conf()
        phys = apply_overrides(plan, conf)
        ctx = ExecContext(conf, self.device)
        self._last_ctx = ctx
        with QueryStats.scoped() as stats:
            self._last_stats = stats
            batches = [b for b in phys.execute(ctx) if b.num_rows > 0]
            if not batches:
                return None
            return batch_utils.compact(batch_utils.concat_batches(batches))

    def _explain(self, plan: L.LogicalPlan) -> str:
        from ..plan.overrides import explain_plan
        return explain_plan(plan, self.conf())

    def last_exec_context(self) -> Optional[ExecContext]:
        """Per-operator metrics of the most recent collect."""
        return self._last_ctx

    def last_query_stats(self) -> Optional[QueryStats]:
        """Fetch and upload profile of the most recent collect."""
        return self._last_stats
