"""Query and data definitions (TPC-H)."""
