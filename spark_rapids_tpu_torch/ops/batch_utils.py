"""Batch utilities (``spark_rapids_tpu/ops/batch_utils.py`` counterpart):
compaction by mask, concatenation of device columns, the bounded slice
of a front-packed batch, row windows (``slice_batch``) and the gather of a
whole batch by a permutation (``gather``).

``compact`` packs the live rows of every device column to the front through
the hand-written kernel ``csrc/compact.cu`` (replacing the reference's
``_compact_fn`` :280), or its plain PyTorch version for CPU tensors;
``compact_columns`` is the dispatching wrapper and ``compact_kernel`` the
launcher, which counts its launches.  Host-carried columns (strings and
lists) are filtered on the host by the live mask, which comes over in the
one counted fetch that also gives the live count (reference :217-222).
``concat_batches`` is ``torch.cat`` of each column (dictionary codes of
different dictionaries are first remapped into their union dictionary by
a device gather through ``csrc/csr_join.cu csr_gather``, the dictionary
half of the reference's ``_concat_fn`` :240) and ``slice_batch`` a view
of each.  ``gather`` applies a permutation to every column through the
full device sort's gather kernel (``ops/sort.py``, ``csrc/sort.cu``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import kernels
from ..batch import (ColumnBatch, DeviceColumn, DictStringColumn, HostColumn,
                     HostListColumn, HostStringColumn)

__all__ = ["compact_packed", "compact", "compact_columns", "compact_kernel",
           "compact_plain", "host_rows", "concat_batches", "slice_batch",
           "gather", "CP_MAX_COLS"]

CP_MAX_COLS = 16            # csrc/compact.cu CP_MAX_COLS
CP_TILE = 4096              # csrc/compact.cu CP_TILE

Value = Tuple[torch.Tensor, Optional[torch.Tensor]]


def compact_packed(batch: ColumnBatch, bound: int) -> ColumnBatch:
    """Slice a batch whose live rows are front-packed (``sel`` is a prefix
    mask, as the grid aggregate's output is) to its first ``bound`` rows.
    ``bound`` is a static upper limit on live rows, so no count is
    fetched; ``sel`` rides along."""
    cap = min(bound, batch.num_rows)
    if cap == batch.num_rows:
        return batch
    cols = []
    for c in batch.columns:
        valid = None if c.valid is None else c.valid[:cap]
        if isinstance(c, DictStringColumn):
            cols.append(DictStringColumn(c.codes[:cap], valid, c.dictionary))
        elif isinstance(c, HostColumn):
            cols.append(host_rows(c, slice(0, cap)))
        else:
            cols.append(DeviceColumn(c.dtype, c.data[:cap], valid))
    sel = None if batch.sel is None else batch.sel[:cap]
    return ColumnBatch(batch.schema, cols, cap, sel)


def host_rows(c: HostColumn, rows) -> HostColumn:
    """The rows ``rows`` (a slice, bool mask or index array) of a host
    column, as a column of the same kind."""
    valid = None if c.valid is None else c.valid[rows]
    if isinstance(c, (HostStringColumn, HostListColumn)):
        return type(c)(c.data[rows], valid)
    return HostColumn(c.dtype, c.data[rows], valid)


def compact(batch: ColumnBatch, n_live: Optional[int] = None) -> ColumnBatch:
    """The batch's live rows packed to the front, in row order, with no
    selection mask.  The live count is fetched (one counted fetch) unless
    the caller already knows it; with host-carried columns the whole mask
    comes over in that fetch and filters them with numpy."""
    if batch.sel is None:
        return batch
    from ..utils.metrics import fetch
    host_mask = None
    if any(isinstance(c, HostColumn) for c in batch.columns):
        host_mask = fetch(batch.sel)
        n_live = int(host_mask.sum())
    elif n_live is None:
        n_live = int(fetch(batch.sel.sum()))
    device = [c for c in batch.columns if not isinstance(c, HostColumn)]
    packed = iter(compact_columns(
        [(c.codes, c.valid) if isinstance(c, DictStringColumn)
         else (c.data, c.valid) for c in device], batch.sel, n_live))
    cols: List = []
    for c in batch.columns:
        if isinstance(c, HostColumn):
            cols.append(host_rows(c, host_mask))
            continue
        d, v = next(packed)
        cols.append(DictStringColumn(d, v, c.dictionary)
                    if isinstance(c, DictStringColumn)
                    else DeviceColumn(c.dtype, d, v))
    return ColumnBatch(batch.schema, cols, n_live)


def compact_columns(cols: Sequence[Value], active: torch.Tensor,
                    n_live: int) -> List[Value]:
    """Each (data, valid) column's rows where ``active`` holds, packed to
    the front; ``n_live`` is the number of such rows (wide decimal limbs
    move as two columns)."""
    from .wide_decimal import join_wide, split_wide
    cols, layout = split_wide(cols)
    run = compact_kernel if active.is_cuda else compact_plain
    out: List[Value] = []
    for lo in range(0, len(cols), CP_MAX_COLS):
        out += run(cols[lo:lo + CP_MAX_COLS], active, n_live)
    return join_wide(out, layout)


def compact_plain(cols, active, n_live: int) -> List[Value]:
    """Plain PyTorch version of ``csrc/compact.cu``."""
    return [(d[active], None if v is None else v[active]) for d, v in cols]


def compact_kernel(cols, active, n_live: int) -> List[Value]:
    """Launch ``csrc/compact.cu`` on CUDA tensors (same arguments as
    :func:`compact_plain`)."""
    n = active.shape[0]
    if len(cols) > CP_MAX_COLS:
        raise ValueError(f"compact takes at most {CP_MAX_COLS} columns")
    if active.dtype != torch.bool or not active.is_cuda \
            or not active.is_contiguous():
        raise ValueError("active must be a contiguous CUDA bool tensor")
    dev = active.device
    ins, outs, vins, vouts, elems, result = [], [], [], [], [], []
    for d, v in cols:
        for t in (d, v):
            if t is not None and (t.shape != (n,) or not t.is_cuda
                                  or not t.is_contiguous()):
                raise ValueError(f"compact columns must be contiguous CUDA "
                                 f"[{n}] tensors, got {tuple(t.shape)} on "
                                 f"{t.device}")
        if d.element_size() not in (1, 2, 4, 8):
            raise ValueError(f"compact moves 1, 2, 4 or 8-byte elements, "
                             f"not {d.dtype}")
        od = torch.empty(n_live, dtype=d.dtype, device=dev)
        ov = None if v is None else torch.empty(n_live, dtype=torch.bool,
                                                device=dev)
        ins.append(d.data_ptr())
        outs.append(od.data_ptr())
        vins.append(None if v is None else v.data_ptr())
        vouts.append(None if ov is None else ov.data_ptr())
        elems.append(d.element_size())
        result.append((od, ov))
    if n == 0 or n_live == 0 or not cols:
        return result  # nothing to move: no launch
    lib = kernels.load("compact")
    nbytes = lib.compact_scratch(n)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    P = kernels.pointer_array
    rc = lib.compact(len(cols), P(ins), P(outs), P(vins), P(vouts),
                     kernels.int_array(elems), active.data_ptr(), n, n_live,
                     scratch.data_ptr(), nbytes,
                     torch.cuda.current_stream(dev).cuda_stream)
    kernels.check_launch(lib, "compact", rc)
    compact_kernel.launches += 1
    return result


compact_kernel.launches = 0


def concat_batches(batches: Sequence[ColumnBatch]) -> ColumnBatch:
    """One batch holding every row of ``batches`` in order (``torch.cat``
    per column; selection masks and validity ride along, filled with True
    where a batch has none)."""
    if len(batches) == 1:
        return batches[0]
    first = batches[0]
    n = sum(b.num_rows for b in batches)

    def cat_valid(masks, lengths, like):
        if all(m is None for m in masks):
            return None
        parts = [torch.ones(k, dtype=torch.bool, device=like.device)
                 if m is None else m for m, k in zip(masks, lengths)]
        return torch.cat(parts)

    lengths = [b.num_rows for b in batches]
    cols: List = []
    for i, c in enumerate(first.columns):
        parts = [b.columns[i] for b in batches]
        if isinstance(c, DictStringColumn) and all(
                isinstance(p, DictStringColumn) for p in parts):
            # codes of one dictionary are comparable as they are; codes of
            # different ones are remapped into their union first
            union = None
            codes = []
            if all(p.dictionary is c.dictionary for p in parts):
                codes = [p.codes for p in parts]
                dictionary = c.dictionary
            else:
                from .strings import encode_column
                for p in parts:
                    union, x, _ = encode_column(p, union, p.codes.device)
                    codes.append(x)
                dictionary = union.values()
            cols.append(DictStringColumn(
                torch.cat(codes),
                cat_valid([p.valid for p in parts], lengths, c.codes),
                dictionary))
            continue
        if all(isinstance(p, HostStringColumn) for p in parts):
            valids = [p.valid for p in parts]
            valid = None if all(v is None for v in valids) else np.concatenate(
                [np.ones(len(p.data), dtype=bool) if v is None else v
                 for p, v in zip(parts, valids)])
            cols.append(HostStringColumn(
                np.concatenate([p.data for p in parts]), valid))
            continue
        if not all(isinstance(p, DeviceColumn) for p in parts):
            raise NotImplementedError(
                "concatenating dictionary codes of different dictionaries, "
                "or host columns with device columns, is not ported yet "
                "(ROADMAP.md queue 2 row 3)")
        cols.append(DeviceColumn(
            c.dtype, torch.cat([p.data for p in parts]),
            cat_valid([p.valid for p in parts], lengths, c.data)))
    sel = None
    if any(b.sel is not None for b in batches):
        dev = next(b.sel for b in batches if b.sel is not None).device
        sel = torch.cat([torch.ones(b.num_rows, dtype=torch.bool, device=dev)
                         if b.sel is None else b.sel for b in batches])
    return ColumnBatch(first.schema, cols, n, sel)


def slice_batch(batch: ColumnBatch, start: int, length: int) -> ColumnBatch:
    """Rows [start, start + length) of ``batch`` as views of every column
    (reference :390): device data and validity, dictionary codes (which
    keep their dictionary), host columns and the selection mask."""
    end = start + length

    def cut(x):
        return None if x is None else x[start:end]
    cols: List = []
    for c in batch.columns:
        if isinstance(c, DictStringColumn):
            cols.append(DictStringColumn(cut(c.codes), cut(c.valid),
                                         c.dictionary))
        elif isinstance(c, HostColumn):
            cols.append(host_rows(c, slice(start, end)))
        else:
            cols.append(DeviceColumn(c.dtype, cut(c.data), cut(c.valid)))
    return ColumnBatch(batch.schema, cols, length, cut(batch.sel))


def gather(batch: ColumnBatch, perm: torch.Tensor) -> ColumnBatch:
    """Every row of ``batch`` at the int32 permutation ``perm`` (its
    selection mask goes along).  Host columns raise: moving host rows by a
    device permutation is not ported (ROADMAP.md item 3)."""
    from .sort import gather_columns
    cols = []
    for f, c in zip(batch.schema, batch.columns):
        if isinstance(c, HostColumn):
            raise NotImplementedError(
                f"a device sort or window over the host column {f.name} is "
                f"not ported yet (ROADMAP.md item 3)")
        cols.append((c.codes if isinstance(c, DictStringColumn) else c.data,
                     c.valid))
    if batch.sel is not None:
        cols.append((batch.sel, None))
    moved = gather_columns(cols, perm) if cols else []
    out: List = []
    for c, (d, v) in zip(batch.columns, moved):
        out.append(DictStringColumn(d, v, c.dictionary)
                   if isinstance(c, DictStringColumn)
                   else DeviceColumn(c.dtype, d, v))
    sel = moved[-1][0] if batch.sel is not None else None
    return ColumnBatch(batch.schema, out, perm.shape[0], sel)
