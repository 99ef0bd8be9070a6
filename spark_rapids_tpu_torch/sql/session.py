"""Session: the entry point (``spark_rapids_tpu/sql/session.py``
counterpart).

A session is bound to one ``torch.device``: the CUDA card unless the
caller passes ``device="cpu"``.  Asking for CUDA where there is none
raises; nothing falls back to the CPU.
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

    # -- execution ----------------------------------------------------------------
    def _execute(self, plan: L.LogicalPlan):
        from ..plan.overrides import apply_overrides
        from ..utils.metrics import fetch
        conf = self.conf()
        phys = apply_overrides(plan, conf)
        ctx = ExecContext(conf, self.device)
        self._last_ctx = ctx
        with QueryStats.scoped() as stats:
            self._last_stats = stats
            rows = CollectExec(phys).collect_rows(ctx)
            if stats.deferred_checks:  # no fetch read them yet
                fetch([])
            return rows

    def _explain(self, plan: L.LogicalPlan) -> str:
        from ..plan.overrides import explain_plan
        return explain_plan(plan, self.conf())

    def last_exec_context(self) -> Optional[ExecContext]:
        """Per-operator metrics of the most recent collect."""
        return self._last_ctx

    def last_query_stats(self) -> Optional[QueryStats]:
        """Fetch and upload profile of the most recent collect."""
        return self._last_stats
