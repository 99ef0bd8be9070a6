"""The decoded-file cache and its device tier.

Counterpart of ``spark_rapids_tpu/io/filecache.py``: :class:`FileCache`
(:28) keeps the decoded host tables of scanned files, keyed by (path,
mtime, size, columns, row groups) and the scan's exact-filter predicates,
in a byte-budgeted LRU, so repeated scans skip the parquet decode;
:class:`DeviceBatchCache` (:93) keeps the *uploaded* batches of repeated
identical scans resident on the device (``fileCache.deviceTier``), keyed
by the source's ``cache_token`` (files, projection, predicates), so they
skip the upload as well.  The reference's cross-query cache
(``spark_rapids_tpu/cache/``, ``sql.cache.enabled``) is not ported
(ROADMAP.md item 3).
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import Optional, Tuple

__all__ = ["FileCache", "DeviceBatchCache", "get_file_cache",
           "get_device_cache", "clear_file_cache"]


class FileCache:
    """Byte-budgeted LRU of decoded host tables keyed by file identity."""

    def __init__(self, max_bytes: int):
        self.max_bytes = max_bytes
        self._lock = threading.Lock()
        self._entries: "OrderedDict[tuple, Tuple[int, list]]" = OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.misses = 0

    @staticmethod
    def key_for(path: str, columns, row_groups) -> Optional[tuple]:
        try:
            st = os.stat(path)
        except OSError:
            return None
        cols = tuple(columns) if columns is not None else None
        rgs = tuple(row_groups) if row_groups is not None else None
        return (os.path.abspath(path), st.st_mtime_ns, st.st_size, cols, rgs)

    def _entry_bytes(self, values: list) -> int:
        return sum(t.nbytes for t in values)

    def get(self, key: tuple) -> Optional[list]:
        with self._lock:
            hit = self._entries.get(key)
            if hit is None:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return hit[1]

    def put(self, key: tuple, values: list) -> None:
        nbytes = self._entry_bytes(values)
        if nbytes > self.max_bytes:
            return
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old[0]
            self._entries[key] = (nbytes, values)
            self._bytes += nbytes
            self._evict_to_budget()

    def _evict_to_budget(self) -> None:
        while self._bytes > self.max_bytes and self._entries:
            _, (sz, _v) = self._entries.popitem(last=False)
            self._bytes -= sz

    def set_max_bytes(self, max_bytes: int) -> None:
        with self._lock:
            self.max_bytes = max_bytes
            self._evict_to_budget()

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._bytes = 0


class DeviceBatchCache(FileCache):
    """LRU of uploaded scan output (lists of device ``ColumnBatch``).
    Entries are never mutated: the scan hands out fresh batch wrappers
    over the cached columns on both the populate and the hit path."""

    @staticmethod
    def batch_bytes(b) -> int:
        from ..batch import DeviceColumn, HostColumn
        total = 0
        for c in b.columns:
            if isinstance(c, DeviceColumn):
                total += c.data.nbytes + (0 if c.valid is None
                                          else c.valid.nbytes)
            elif isinstance(c, HostColumn):
                total += c.data.nbytes
        return total

    def _entry_bytes(self, values: list) -> int:
        return sum(self.batch_bytes(b) for b in values)


_cache: Optional[FileCache] = None
_device_cache: Optional[DeviceBatchCache] = None
_cache_lock = threading.Lock()


def get_file_cache(max_bytes: int) -> FileCache:
    global _cache
    with _cache_lock:
        if _cache is None:
            _cache = FileCache(max_bytes)
        elif _cache.max_bytes != max_bytes:
            _cache.set_max_bytes(max_bytes)
        return _cache


def get_device_cache(max_bytes: int) -> DeviceBatchCache:
    global _device_cache
    with _cache_lock:
        if _device_cache is None:
            _device_cache = DeviceBatchCache(max_bytes)
        elif _device_cache.max_bytes != max_bytes:
            _device_cache.set_max_bytes(max_bytes)
        return _device_cache


def clear_file_cache() -> None:
    """Drop every cached decoded table and device batch."""
    with _cache_lock:
        if _cache is not None:
            _cache.clear()
        if _device_cache is not None:
            _device_cache.clear()
