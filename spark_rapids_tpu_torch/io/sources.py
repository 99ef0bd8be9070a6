"""The file scan source base (``spark_rapids_tpu/io/sources.py:26
FileSource`` counterpart).

What every file source shares: the file list, the projection and the
pushed predicates of the pushdown contract (``with_pushdown`` builds a
narrowed copy), the description the explain string shows, and the
prefetch iterator that decodes batches on a background thread while the
caller uploads and computes.  ``io/parquet.ParquetSource`` is the one file
source ported; the reference's ORC, JSON and CSV sources are not
(ROADMAP.md item 9).
"""

from __future__ import annotations

import contextvars
import queue
import threading
from typing import Iterator, List, Optional

__all__ = ["FileSource"]


class FileSource:
    """A file scan: ``paths``, ``columns`` (None: all), ``predicates``,
    ``batch_rows`` and ``num_threads`` (0: decode on the calling thread).
    Subclasses give ``_read_all()``, the decoded batches in order."""

    fmt = "file"

    def __init__(self, path, paths: List[str],
                 columns: Optional[List[str]], predicates: Optional[list],
                 batch_rows: int, num_threads: int):
        self.path = path
        self.paths = paths
        if not self.paths:
            raise FileNotFoundError(f"no {self.fmt} files match {path!r}")
        self.columns = list(columns) if columns is not None else None
        self.predicates = list(predicates or [])
        self.batch_rows = batch_rows
        self.num_threads = num_threads

    def describe(self) -> str:
        d = str(self.path)
        if self.columns is not None:
            d += f" cols={self.columns}"
        if self.predicates:
            d += f" pushdown={[(n, op) for n, op, _ in self.predicates]}"
        return d

    def _read_all(self) -> Iterator:
        raise NotImplementedError

    def __call__(self, prefetch_depth: int = 4) -> Iterator:
        """The decoded batches, decoded ahead on a prefetch thread when
        ``num_threads`` > 0.  ``prefetch_depth`` bounds the decoded but
        unconsumed batches; a consumer that abandons the iterator (a
        LIMIT, an error) stops the producer."""
        if self.num_threads <= 0:
            yield from self._read_all()
            return
        q: "queue.Queue" = queue.Queue(maxsize=max(1, prefetch_depth))
        stop = threading.Event()
        end = object()

        def _put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for t in self._read_all():
                    if not _put(t):
                        return
                _put(end)
            except BaseException as ex:  # handed to the consumer
                _put(ex)

        # the producer runs in a copy of the caller's context, so what it
        # records lands in the calling query's scope
        cctx = contextvars.copy_context()
        th = threading.Thread(target=lambda: cctx.run(producer), daemon=True,
                              name=f"srt-torch-{self.fmt}-prefetch")
        th.start()
        try:
            while True:
                item = q.get()
                if item is end:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
