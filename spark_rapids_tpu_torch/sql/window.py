"""Public window-spec API (``spark_rapids_tpu/sql/window.py`` counterpart,
PySpark's ``pyspark.sql.Window``)."""

from __future__ import annotations

import sys

from .. import exprs as E
from ..plan.logical import SortOrder
from ..windowfns import WindowFrame, WindowSpecDef
from .column import Column

__all__ = ["Window", "WindowSpec"]

_UNBOUNDED = 1 << 40


def _to_sort_order(c) -> SortOrder:
    if isinstance(c, SortOrder):
        return c
    if isinstance(c, str):
        return SortOrder(E.UnresolvedColumn(c))
    if isinstance(c, Column):
        return SortOrder(c.expr)
    raise TypeError(f"cannot order by {c!r}")


def _bound(v: int):
    """None for unbounded (PySpark's sentinels and anything past 2^40)."""
    if v <= -_UNBOUNDED or v >= _UNBOUNDED:
        return None
    return int(v)


class WindowSpec:
    def __init__(self, spec: WindowSpecDef):
        self._spec = spec

    def _explicit_frame(self):
        return self._spec.frame if self._spec.frame_explicit else None

    def partition_by(self, *cols) -> "WindowSpec":
        exprs = [c.expr if isinstance(c, Column) else E.UnresolvedColumn(c)
                 for c in cols]
        return WindowSpec(WindowSpecDef(
            exprs, self._spec.order_by, self._explicit_frame(),
            frame_explicit=self._spec.frame_explicit))

    partitionBy = partition_by

    def order_by(self, *cols) -> "WindowSpec":
        orders = [_to_sort_order(c) for c in cols]
        return WindowSpec(WindowSpecDef(
            self._spec.partition_by, orders, self._explicit_frame(),
            frame_explicit=self._spec.frame_explicit))

    orderBy = order_by

    def rows_between(self, start: int, end: int) -> "WindowSpec":
        frame = WindowFrame("rows", _bound(start), _bound(end))
        return WindowSpec(WindowSpecDef(self._spec.partition_by,
                                        self._spec.order_by, frame,
                                        frame_explicit=True))

    rowsBetween = rows_between

    def range_between(self, start: int, end: int) -> "WindowSpec":
        frame = WindowFrame("range", _bound(start), _bound(end))
        return WindowSpec(WindowSpecDef(self._spec.partition_by,
                                        self._spec.order_by, frame,
                                        frame_explicit=True))

    rangeBetween = range_between


class Window:
    """Factory: ``Window.partition_by("k").order_by("t")``."""

    unboundedPreceding = -sys.maxsize
    unboundedFollowing = sys.maxsize
    currentRow = 0
    unbounded_preceding = unboundedPreceding
    unbounded_following = unboundedFollowing
    current_row = 0

    @staticmethod
    def partition_by(*cols) -> WindowSpec:
        return WindowSpec(WindowSpecDef([], [])).partition_by(*cols)

    partitionBy = partition_by

    @staticmethod
    def order_by(*cols) -> WindowSpec:
        return WindowSpec(WindowSpecDef([], [])).order_by(*cols)

    orderBy = order_by

    @staticmethod
    def rows_between(start: int, end: int) -> WindowSpec:
        return WindowSpec(WindowSpecDef([], [])).rows_between(start, end)

    rowsBetween = rows_between
