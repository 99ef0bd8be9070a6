"""Row and size estimates for planning (``spark_rapids_tpu/plan/cbo.py``
``estimate_rows`` :23, and ``spark_rapids_tpu/batch.py:87
estimated_row_bytes``).

The broadcast-join choice reads them: the smaller join side whose estimate
fits ``spark.rapids.tpu.sql.autoBroadcastJoinThreshold`` builds, and the
probe side's estimate gates the dense path (``join.denseMinProbeRows``).
The formulas are the reference's, so both packages choose the same build
side.  The reference's cost-based un-tagging pass (``apply_cbo``) is off by
default there and not ported.
"""

from __future__ import annotations

from typing import Optional

from . import logical as L

__all__ = ["estimate_rows", "estimated_row_bytes", "estimated_bytes"]


def estimate_rows(node: L.LogicalPlan) -> Optional[float]:
    """Bottom-up row estimate; None = unknown."""
    if isinstance(node, L.LogicalScan):
        # a file source counts its footers' rows (reference :23-41)
        est = getattr(node.source, "estimated_rows", None)
        n = est() if est is not None else getattr(node.source, "num_rows",
                                                   None)
        return None if n is None else float(n)
    if isinstance(node, L.Filter):
        c = estimate_rows(node.children[0])
        return None if c is None else c * 0.5
    if isinstance(node, L.Limit):
        c = estimate_rows(node.children[0])
        return float(node.n) if c is None else min(float(node.n), c)
    if isinstance(node, L.Aggregate):
        c = estimate_rows(node.children[0])
        if c is None:
            return None
        return 1.0 if not node.group_exprs else max(1.0, c * 0.1)
    if isinstance(node, L.Join):
        l = estimate_rows(node.children[0])
        r = estimate_rows(node.children[1])
        return None if l is None or r is None else max(l, r)
    if isinstance(node, L.Union):
        parts = [estimate_rows(c) for c in node.children]
        return None if any(p is None for p in parts) else sum(parts)
    if node.children:
        return estimate_rows(node.children[0])
    return None


def estimated_row_bytes(schema) -> int:
    """Planning-time row width: 24 bytes for a string, 8 for anything
    else."""
    return sum(24 if f.dtype.is_string else 8 for f in schema) or 8


def estimated_bytes(node: L.LogicalPlan) -> Optional[float]:
    """Rows times the planning row width; an in-memory scan is as wide as
    its table before column pruning, as the reference's unnarrowed scans
    are (a file scan is narrowed in both packages)."""
    rows = estimate_rows(node)
    if rows is None:
        return None
    schema = node.schema()
    if isinstance(node, L.LogicalScan):
        schema = getattr(node.source, "unpruned", schema)
    return rows * estimated_row_bytes(schema)
