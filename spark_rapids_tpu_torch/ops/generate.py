"""The rows of an explode (row 16 of the kernel list).

``explode_rows`` builds one output chunk of a ``GenerateExec``: rows [lo,
lo + m) of a batch's explode, each with its list element and every
sibling device column's value at its parent row.  The host gives it, from
the list offsets it already holds, ``starts`` (int64 [n + 1], each parent's
first output row) and, under OUTER only, ``eoffs`` (int64 [n + 1], each
parent's first element; an empty or null list then still takes one output
row, with a null element).  Without OUTER a row's element is the row
itself.  ``csrc/explode.cu`` computes it for CUDA tensors
(:func:`explode_kernel`, which counts its launches); the plain PyTorch
version (:func:`explode_plain`, ``repeat_interleave`` and gathers) for CPU
tensors.  It replaces the reference's ``GenerateExec._gather_fn``
(``spark_rapids_tpu/plan/exec_nodes.py:466``) and the element column the
reference builds on the host per chunk (:494-528).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from .. import kernels

__all__ = ["explode_rows", "explode_plain", "explode_kernel", "EX_MAX_COLS"]

EX_MAX_COLS = 16            # csrc/explode.cu EX_MAX_COLS

Value = Tuple[torch.Tensor, Optional[torch.Tensor]]


def explode_rows(starts: torch.Tensor, eoffs: Optional[torch.Tensor],
                 lo: int, m: int, values: torch.Tensor,
                 values_valid: Optional[torch.Tensor], cols: Sequence[Value],
                 with_valid: bool) -> Tuple[Value, List[Value]]:
    """Rows [lo, lo + m) of the explode: ((element data, element validity
    or None), [(sibling data, validity) per column]).  ``values`` are the
    batch's flat elements (element i of the batch at index i), with
    ``values_valid``; ``cols`` the parents' device columns ([n], or a
    wide decimal's [n, 2] limbs).  ``with_valid`` asks for the element
    validity (OUTER, or null elements)."""
    from .wide_decimal import join_wide, split_wide
    flat, layout = split_wide(list(cols))
    run = explode_kernel if starts.is_cuda else explode_plain
    elem, moved = run(starts, eoffs, lo, m, values, values_valid, flat,
                      with_valid)
    return elem, join_wide(moved, layout)


def explode_plain(starts, eoffs, lo: int, m: int, values, values_valid,
                  cols, with_valid: bool):
    """Plain PyTorch version of ``csrc/explode.cu``."""
    n, dev = starts.shape[0] - 1, starts.device
    rows = torch.arange(lo, lo + m, dtype=torch.int64, device=dev)
    parent = torch.repeat_interleave(
        torch.arange(n, device=dev), starts[1:] - starts[:-1])[lo:lo + m]
    ok = torch.ones(m, dtype=torch.bool, device=dev)
    e = rows
    if eoffs is not None:
        ok = eoffs[parent + 1] > eoffs[parent]
        e = torch.where(ok, eoffs[parent] + (rows - starts[parent]), 0)
    if values.shape[0] == 0:
        data = torch.zeros(m, dtype=values.dtype, device=dev)
    else:
        if values_valid is not None:
            ok = ok & values_valid[e]
        data = torch.where(ok, values[e], torch.zeros((), dtype=values.dtype,
                                                      device=dev))
    return ((data, ok if with_valid else None),
            [(d[parent], None if v is None else v[parent]) for d, v in cols])


def _check(t: torch.Tensor, shape, what: str) -> None:
    if not t.is_cuda or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(f"explode: {what} must be a contiguous CUDA "
                         f"{tuple(shape)} tensor, got {tuple(t.shape)} on "
                         f"{t.device}")


def explode_kernel(starts, eoffs, lo: int, m: int, values, values_valid,
                   cols, with_valid: bool):
    """Launch ``explode`` of ``csrc/explode.cu`` (same arguments as
    :func:`explode_plain`): one launch per group of ``EX_MAX_COLS``
    sibling columns, the element column in the first."""
    n, dev = starts.shape[0] - 1, starts.device
    if n <= 0:
        raise ValueError("explode needs at least one parent row")
    _check(starts, (n + 1,), "starts")
    if starts.dtype != torch.int64 or (
            eoffs is not None and eoffs.dtype != torch.int64):
        raise ValueError("explode: starts and eoffs are int64")
    if eoffs is not None:
        _check(eoffs, (n + 1,), "eoffs")
    _check(values, (values.shape[0],), "values")
    if values_valid is not None:
        _check(values_valid, (values.shape[0],), "values_valid")
    if values.shape[0] == 0:  # no element at all: every row's is null
        values = torch.zeros(1, dtype=values.dtype, device=dev)
    data = torch.empty(m, dtype=values.dtype, device=dev)
    valid = torch.empty(m, dtype=torch.bool, device=dev) if with_valid \
        else None
    result: List[Value] = []
    ptrs = []
    for d, v in cols:
        _check(d, (n,), "a sibling column")
        if v is not None:
            _check(v, (n,), "a sibling validity")
        if d.element_size() not in (1, 2, 4, 8):
            raise ValueError(f"explode moves 1, 2, 4 or 8-byte elements, "
                             f"not {d.dtype}")
        od = torch.empty(m, dtype=d.dtype, device=dev)
        ov = None if v is None else torch.empty(m, dtype=torch.bool,
                                                device=dev)
        result.append((od, ov))
        ptrs.append((d.data_ptr(), od.data_ptr(),
                     None if v is None else v.data_ptr(),
                     None if ov is None else ov.data_ptr(),
                     d.element_size()))
    if m == 0:
        return (data, valid), result
    lib = kernels.load("explode")
    P = kernels.pointer_array
    stream = torch.cuda.current_stream(dev).cuda_stream
    for g in range(0, max(len(ptrs), 1), EX_MAX_COLS):
        group = ptrs[g:g + EX_MAX_COLS]
        first = g == 0
        rc = lib.explode(
            n, starts.data_ptr(), None if eoffs is None else eoffs.data_ptr(),
            lo, m, values.data_ptr() if first else None,
            None if values_valid is None or not first
            else values_valid.data_ptr(),
            values.element_size(), data.data_ptr() if first else None,
            None if valid is None or not first else valid.data_ptr(),
            len(group), P([p[0] for p in group]), P([p[1] for p in group]),
            P([p[2] for p in group]), P([p[3] for p in group]),
            kernels.int_array([p[4] for p in group]), stream)
        kernels.check_launch(lib, "explode", rc)
        explode_kernel.launches += 1
    return (data, valid), result


explode_kernel.launches = 0
