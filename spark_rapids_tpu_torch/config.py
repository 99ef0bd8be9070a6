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
    elif isinstance(default, float):
        conv = float
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
    "Shuffle transport: CACHE_ONLY (partitions stay on the device), HOST "
    "(partition slices leave the device as compressed, checksummed frame "
    "files written by a thread pool and are read back one partition at a "
    "time, parallel/host_shuffle.py), or ICI (exchange-bearing plan "
    "fragments run shard by shard over the session's device mesh, the "
    "exchange a bucketize and a swap of the bucket axis, "
    "parallel/spmd.py).",
    check=_one_of("HOST", "ICI", "CACHE_ONLY"))

AGG_SINGLE_PROCESS_COMPLETE = register(
    "spark.rapids.tpu.sql.agg.singleProcessComplete", True,
    "Under shuffle.mode=CACHE_ONLY, plan grouped aggregations as one "
    "complete pass. false plans them as partial -> exchange -> final, as "
    "HOST and ICI always do; the partial samples its first batch and "
    "passes rows through unreduced when the keys barely reduce "
    "(sql.agg.skipPartialAggRatio).")

AGG_SKIP_PARTIAL_RATIO = register(
    "spark.rapids.tpu.sql.agg.skipPartialAggRatio", 0.3,
    "When the first batch's sampled distinct/live key ratio exceeds this "
    "fraction, the partial aggregate passes rows through to the exchange "
    "unreduced. 1.0 disables skipping.",
    check=lambda v: None if 0.0 <= v <= 1.0 else "must be in [0, 1]")

AGG_REPARTITION_BUCKETS = register(
    "spark.rapids.tpu.sql.agg.repartitionBuckets", 64,
    "Hash-bucket count of the final aggregate's re-partition fallback: a "
    "merge whose groups outgrow sql.batchSizeBytes over the buffer's row "
    "width splits into this many disjoint key buckets (xxhash64 % n), "
    "each bounded by the same limit; a bucket past it raises.",
    check=_positive)

BATCH_SIZE_BYTES = register(
    "spark.rapids.tpu.sql.batchSizeBytes", 1 << 30,
    "Soft byte target of a batch: the partial aggregate emits, and the "
    "final aggregate re-partitions, past this many bytes of buffer rows "
    "(string keys counted as 4-byte codes).",
    check=_positive)

SHUFFLE_COMPRESS = register(
    "spark.rapids.tpu.shuffle.compress", True,
    "Compress HOST shuffle frames (zlib level 1; a frame that does not "
    "shrink is stored raw).")

SPILL_DIR = register(
    "spark.rapids.tpu.memory.spill.dir", "/tmp/srt_spill",
    "Directory of the HOST shuffle's frame files (one shuffle-<id> "
    "directory per exchange, removed when it closes).")

ICI_DEVICES = register(
    "spark.rapids.tpu.shuffle.ici.devices", 0,
    "Number of mesh devices for shuffle.mode=ICI (0 = every visible CUDA "
    "device). Session.set_mesh() installs an explicit device list.",
    check=lambda v: None if v >= 0 else "must be >= 0")

ICI_BUCKET_ROWS = register(
    "spark.rapids.tpu.shuffle.ici.bucketRows", 0,
    "Per-destination send-bucket rows of an ICI exchange (0 = auto: the "
    "sender's shard rows, which cannot overflow but costs n_devices x "
    "shard rows on the receive side). Overflow is detected and retried, "
    "never dropped.",
    check=lambda v: None if v >= 0 else "must be >= 0")

ICI_JOIN_OUT_ROWS = register(
    "spark.rapids.tpu.shuffle.ici.joinOutputRows", 0,
    "Per-shard output rows of an ICI join expansion (0 = auto: probe plus "
    "build shard rows). Overflow is detected and retried, never dropped.",
    check=lambda v: None if v >= 0 else "must be >= 0")

ICI_OVERFLOW_RETRIES = register(
    "spark.rapids.tpu.shuffle.ici.overflowRetries", 2,
    "Retries of an ICI fragment whose bucket or join capacity overflowed, "
    "each with every capacity scaled 4x; 0 raises at once.",
    check=lambda v: None if v >= 0 else "must be >= 0")

ICI_FALLBACK = register(
    "spark.rapids.tpu.shuffle.ici.fallback", False,
    "When true, exchanges that cannot be lowered onto the mesh run on the "
    "single-process CACHE_ONLY path instead of failing the query.")

JOIN_SUBPARTITIONS = register(
    "spark.rapids.tpu.sql.join.subPartitions", 16,
    "Fan-out used to split a shuffled-join partition pair whose combined "
    "rows exceed sql.batchSizeRows by a second, independent key hash "
    "(xxhash64) before joining.",
    check=_positive)


DPP_ENABLED = register(
    "spark.rapids.tpu.sql.dpp.enabled", True,
    "Runtime join filters: once a broadcast join's build side (or a "
    "sort-merge join's left side, when it joins its sides whole) is "
    "materialized, push its key range, or the exact key list when the "
    "distinct count is small, into the other side's file scan as runtime "
    "predicates for row-group pruning and the exact host filter.")

DPP_MAX_IN_KEYS = register(
    "spark.rapids.tpu.sql.dpp.maxInKeys", 10_000,
    "Largest distinct build-key count pushed as an exact IN-list runtime "
    "predicate; above it only the [min, max] range is pushed.",
    check=_positive)

READER_THREADS = register(
    "spark.rapids.tpu.sql.multiThreadedRead.numThreads", 8,
    "A value above 0 decodes file batches on a prefetch thread while the "
    "device computes; 0 decodes them on the calling thread.",
    check=lambda v: None if v >= 0 else "must be >= 0")

SCAN_EXACT_FILTER = register(
    "spark.rapids.tpu.sql.scan.exactFilterPushdown", True,
    "Apply the pushed filter conjuncts exactly on the host during a file "
    "scan, so filtered-out rows are never uploaded (the device filter "
    "still evaluates the whole condition).")

FILE_CACHE_ENABLED = register(
    "spark.rapids.tpu.sql.fileCache.enabled", False,
    "Keep the decoded host tables of scanned files (keyed by path, mtime, "
    "size, columns, row groups and pushed predicates) so repeated scans "
    "skip the parquet decode.")

FILE_CACHE_MAX_BYTES = register(
    "spark.rapids.tpu.sql.fileCache.maxBytes", 4 << 30,
    "Byte budget of the decoded-file cache; least recently used files are "
    "evicted beyond it.", check=_positive)

FILE_CACHE_DEVICE_TIER = register(
    "spark.rapids.tpu.sql.fileCache.deviceTier", True,
    "With the file cache enabled, also keep the uploaded device batches of "
    "repeated identical scans resident (LRU under "
    "fileCache.device.maxBytes), so they skip the upload too.")

FILE_CACHE_DEVICE_MAX_BYTES = register(
    "spark.rapids.tpu.sql.fileCache.device.maxBytes", 2 << 30,
    "Device byte budget of the file cache's device tier.", check=_positive)

READER_BATCH_BYTES = register(
    "spark.rapids.tpu.sql.reader.batchSizeBytes", 512 << 20,
    "Soft cap on the bytes of file data decoded into one scan batch, "
    "applied as a row cap from the schema's estimated row width.")

CACHE_ENABLED = register(
    "spark.rapids.tpu.sql.cache.enabled", False,
    "The reference's cross-query device cache (spark_rapids_tpu/cache/). "
    "Not ported: true raises (ROADMAP.md item 3).",
    check=lambda v: ("the cross-query device cache is not ported yet "
                     "(ROADMAP.md item 3)") if v else None)


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
