"""Typed configuration registry: the keys this slice of the port reads.

The port's counterpart of ``spark_rapids_tpu/config.py``.  Key strings and
defaults are the reference's, so one settings dict drives both packages in
the differential tests.  A key the reference registers but the port does
not read yet is refused with a clear error rather than silently ignored.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

__all__ = ["ConfEntry", "TpuConf", "register", "ALL_ENTRIES"]


@dataclass(frozen=True)
class ConfEntry:
    key: str
    default: Any
    doc: str
    conv: Callable[[str], Any]
    check: Optional[Callable[[Any], Optional[str]]] = None

    def convert(self, raw: Any) -> Any:
        value = self.conv(raw) if isinstance(raw, str) else raw
        if self.check is not None:
            err = self.check(value)
            if err:
                raise ValueError(
                    f"invalid value {value!r} for {self.key}: {err}")
        return value


ALL_ENTRIES: Dict[str, ConfEntry] = {}


def _to_bool(s: str) -> bool:
    return s.strip().lower() in ("1", "true", "yes", "on")


def register(key: str, default: Any, doc: str, *,
             check: Callable = None) -> ConfEntry:
    if isinstance(default, bool):
        conv = _to_bool
    elif isinstance(default, int):
        conv = int
    else:
        conv = str
    entry = ConfEntry(key, default, doc, conv, check)
    assert key not in ALL_ENTRIES, f"duplicate conf key {key}"
    ALL_ENTRIES[key] = entry
    return entry


def _one_of(*allowed: str):
    def _check(v):
        return None if v in allowed else f"must be one of {allowed}"
    return _check


def _positive(v):
    return None if v > 0 else "must be positive"


SQL_ENABLED = register(
    "spark.rapids.tpu.sql.enabled", True,
    "Enable device acceleration of SQL/DataFrame execution. When false "
    "every operator is tagged for the CPU.")

EXPLAIN = register(
    "spark.rapids.tpu.sql.explain", "NOT_ON_TPU",
    "Explain verbosity for plan conversion: NONE, NOT_ON_TPU (reasons for "
    "fallbacks only), or ALL.",
    check=_one_of("NONE", "NOT_ON_TPU", "ALL"))

BATCH_SIZE_ROWS = register(
    "spark.rapids.tpu.sql.batchSizeRows", 4 << 20,
    "Number of rows per columnar batch on the device. The port does not "
    "pad batches: the last batch of a scan holds the remainder.",
    check=_positive)

ANSI_ENABLED = register(
    "spark.rapids.tpu.sql.ansi.enabled", False,
    "ANSI mode: division by zero and invalid casts raise instead of "
    "returning null.")

CPU_FALLBACK_ENABLED = register(
    "spark.rapids.tpu.sql.fallback.enabled", True,
    "Execute unsupported operators on the CPU instead of failing the "
    "query.")

VALIDATE_EXECS = register(
    "spark.rapids.tpu.test.validateExecsOnTpu", False,
    "Test-only: fail if any operator in the plan falls back to CPU.")

GRID_MAX_GROUPS = register(
    "spark.rapids.tpu.sql.agg.gridMaxGroups", 4096,
    "Grouped aggregation uses a dense-grid reduction (no sort) when every "
    "group key is a dictionary-coded string and the padded grid has at "
    "most this many slots.",
    check=_positive)

AUTO_BROADCAST_THRESHOLD = register(
    "spark.rapids.tpu.sql.autoBroadcastJoinThreshold", 256 * 1024 * 1024,
    "Estimated-size cutoff (bytes) under which the build side of a join is "
    "broadcast (materialized once) instead of hash partitioned; -1 "
    "disables the choice. The smaller side that fits builds.")

DENSE_DOMAIN_CAP = register(
    "spark.rapids.tpu.join.denseDomainCap", 1 << 26,
    "Largest key domain (max_key - min_key + 1) for which the dense "
    "direct-address kernels engage: broadcast joins build a key -> row "
    "table, and integral-key aggregations scatter into domain-sized "
    "accumulators. 0 turns the dense paths off.",
    check=lambda v: None if v >= 0 else "must be >= 0")

DENSE_MIN_PROBE_ROWS = register(
    "spark.rapids.tpu.join.denseMinProbeRows", 16384,
    "Smallest estimated probe-side row count for which a broadcast join "
    "engages the dense direct-address path (its build-key stats cost one "
    "fetch). 0 always engages.",
    check=lambda v: None if v >= 0 else "must be >= 0")

AGG_DENSE_ENABLED = register(
    "spark.rapids.tpu.sql.agg.dense.enabled", True,
    "Enable the dense direct-address grouped aggregation (scatter into "
    "domain-sized accumulators) for bounded-domain integral group keys; "
    "the domain cap is join.denseDomainCap.")

AGG_DENSE_MAX_ACCUM = register(
    "spark.rapids.tpu.sql.agg.dense.maxAccumBytes", 1_500_000_000,
    "Device-memory budget for the multi-key dense aggregation's "
    "accumulators (primary-key domain x (residual channels + aggregate "
    "buffers)).",
    check=_positive)


AQE_ENABLED = register(
    "spark.rapids.tpu.sql.aqe.enabled", True,
    "Adaptive re-planning at exchange boundaries: a shuffled join whose "
    "staged build input is actually under autoBroadcastJoinThreshold "
    "flips to a broadcast join at run time. The staged input serves "
    "either path.")

EXCHANGE_ENABLED = register(
    "spark.rapids.tpu.sql.exchange.enabled", True,
    "Plan equi-joins that broadcast neither side over hash-partitioned "
    "sides (a shuffle exchange under each side of a sort-merge join). "
    "When false such a join joins its two sides whole.")

SHUFFLE_PARTITIONS = register(
    "spark.rapids.tpu.sql.shuffle.partitions", 8,
    "Number of partitions of a shuffle exchange. On one card a partition "
    "exists for memory decomposition, not parallelism.",
    check=_positive)

SHUFFLE_MODE = register(
    "spark.rapids.tpu.shuffle.mode", "CACHE_ONLY",
    "Shuffle transport: CACHE_ONLY (partitions stay on the device). HOST "
    "and ICI are the reference's other transports; the port raises on "
    "them (ROADMAP.md item 10).",
    check=_one_of("HOST", "ICI", "CACHE_ONLY"))

AGG_SINGLE_PROCESS_COMPLETE = register(
    "spark.rapids.tpu.sql.agg.singleProcessComplete", True,
    "Run an aggregate whose input is all in this process in one complete "
    "pass. false asks for the reference's partial/final split (its row "
    "5', with the skip-ratio probe); the port raises on it until the "
    "distribution slice (ROADMAP.md item 10).")

JOIN_SUBPARTITIONS = register(
    "spark.rapids.tpu.sql.join.subPartitions", 16,
    "Fan-out used to split a shuffled-join partition pair whose combined "
    "rows exceed sql.batchSizeRows by a second, independent key hash "
    "(xxhash64) before joining.",
    check=_positive)


class TpuConf:
    """An immutable snapshot of settings; unset keys resolve to defaults."""

    def __init__(self, settings: Optional[Dict[str, Any]] = None):
        self._values: Dict[str, Any] = {}
        for k, v in (settings or {}).items():
            entry = ALL_ENTRIES.get(k)
            if entry is None:
                raise KeyError(
                    f"config key {k!r} is not read by spark_rapids_tpu_torch "
                    f"yet (known keys: {sorted(ALL_ENTRIES)})")
            self._values[k] = entry.convert(v)

    def __getitem__(self, key: str) -> Any:
        return self._values.get(key, ALL_ENTRIES[key].default)
