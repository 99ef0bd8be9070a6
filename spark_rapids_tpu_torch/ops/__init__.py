"""Device reductions and batch helpers, with their hand-written kernels."""
