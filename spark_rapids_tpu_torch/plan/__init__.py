"""Logical plans, column pruning, placement and physical operators."""
