"""The full device sort: order images, the stable permutation, the range
key and the gather by permutation.

Counterpart of ``spark_rapids_tpu/ops/groupby.py:43 sortable_view`` and
``:82 sort_indices_for_keys`` as ``spark_rapids_tpu/plan/exec_nodes.py``
runs them (``_sort_perm`` :219, ``_range_key_fn`` :161).  On CUDA tensors
each wrapper launches ``csrc/sort.cu`` (or raises); on CPU tensors it runs
the plain PyTorch version, which the tests hold against the reference.

* :func:`sort_images` — per key, the reference's order words: a key of at
  most 4 bytes folds its null flag above its 32-bit view into one word
  (``(flag << 32) + view + 2^31``, 5 radix bytes), an 8-byte key gives its
  view (8 bytes) and, with a validity mask, a flag word above it (1 byte).
  ``desc`` complements the view; ``flag`` is ``valid`` for nulls first and
  ``not valid`` for nulls last.  A null row keeps its payload's view, as
  the reference's lexsort does.
* :func:`sort_perm` — the stable permutation over the words, most
  significant first, with live rows first: exactly
  ``sort_indices_for_keys``'s.
* :func:`range_key` — ``_range_key_fn``'s view of the primary key in output
  order: the view, complemented for ``desc``, nulls as int64 min (nulls
  first) or max.
* :func:`gather_columns` — (data, valid) columns taken at a permutation.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from .. import kernels
from .topk import sortable_view

__all__ = ["SO_MAX_COLS", "RADIX_TILE", "SortKey", "Word", "sort_images",
           "sort_images_plain", "sort_images_kernel", "sort_perm",
           "sort_perm_plain", "sort_perm_kernel", "range_key",
           "range_key_plain", "range_key_kernel", "gather_columns",
           "gather_plain", "gather_kernel", "key_args", "sort_keys_perm"]

SO_MAX_COLS = 16            # csrc/sort.cu SO_MAX_COLS
# rows of one tile of the one-sweep radix pass (csrc/radix.cuh OS_TILE, as
# sort.cu's sort_tile_rows returns it): the shapes where a look-back
# crosses a tile boundary
RADIX_TILE = 4096
_FLOATS = (torch.float32, torch.float64)

# (data, valid-or-None, ascending, nulls_first)
SortKey = Tuple[torch.Tensor, Optional[torch.Tensor], bool, bool]
# an int64 order word and its radix byte count
Word = Tuple[torch.Tensor, int]
Value = Tuple[torch.Tensor, Optional[torch.Tensor]]


def key_args(data: torch.Tensor) -> Tuple[int, int]:
    """(element bytes, kind) of a key column for csrc/order.cuh: kind 1 for
    floats, 0 for integers, dates, codes and booleans."""
    if data.dtype not in _FLOATS and (data.is_floating_point()
                                      or data.is_complex()):
        raise ValueError(f"a sort key of type {data.dtype} is not supported")
    return data.element_size(), int(data.dtype in _FLOATS)


def _check(t: Optional[torch.Tensor], n: int, what: str) -> None:
    if t is None:
        return
    if t.shape != (n,) or not t.is_cuda or not t.is_contiguous():
        raise ValueError(f"{what} must be a contiguous CUDA [{n}] tensor, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ---------------------------------------------------------------------------------
# images
# ---------------------------------------------------------------------------------

def sort_images(keys: Sequence[SortKey]) -> List[Word]:
    """The order words of ``keys`` (most significant first)."""
    if not keys:
        return []
    run = sort_images_kernel if keys[0][0].is_cuda else sort_images_plain
    return run(keys)


def sort_images_plain(keys: Sequence[SortKey]) -> List[Word]:
    """Plain PyTorch version of ``sort_image`` in ``csrc/sort.cu``."""
    words: List[Word] = []
    for data, valid, ascending, nulls_first in keys:
        key_args(data)
        ok = (torch.ones(data.shape[0], dtype=torch.bool, device=data.device)
              if valid is None else valid)
        flag = (ok if nulls_first else ~ok).to(torch.int64)
        view = sortable_view(data)
        if not ascending:
            view = ~view
        if data.element_size() <= 4:
            words.append(((flag << 32) + view + (1 << 31), 5))
        else:
            if valid is not None:
                words.append((flag, 1))
            words.append((view, 8))
    return words


def sort_images_kernel(keys: Sequence[SortKey]) -> List[Word]:
    """Launch ``sort_image`` of ``csrc/sort.cu`` once per key."""
    for data, valid, _, _ in keys:
        _check(data, data.shape[0], "a sort key")
        _check(valid, data.shape[0], "a sort key's validity")
        if valid is not None and valid.dtype != torch.bool:
            raise ValueError("validity must be bool")
        key_args(data)
    lib = kernels.load("sort")
    words: List[Word] = []
    launched = False
    for data, valid, ascending, nulls_first in keys:
        n = data.shape[0]
        elem, kind = key_args(data)
        word = torch.empty(n, dtype=torch.int64, device=data.device)
        flag = (torch.empty_like(word) if elem == 8 and valid is not None
                else None)
        if flag is not None:
            words.append((flag, 1))
        words.append((word, 5 if elem <= 4 else 8))
        if n == 0:
            continue
        rc = lib.sort_image(data.data_ptr(), _ptr(valid), elem, kind,
                            int(not ascending), int(nulls_first), n,
                            word.data_ptr(), _ptr(flag), _stream(data))
        kernels.check_launch(lib, "sort_image", rc)
        launched = True
    sort_images_kernel.launches += launched
    return words


sort_images_kernel.launches = 0


# ---------------------------------------------------------------------------------
# permutation
# ---------------------------------------------------------------------------------

def sort_perm(words: Sequence[Word], active: Optional[torch.Tensor],
              n: int) -> torch.Tensor:
    """int32 [n]: the stable permutation that orders the rows by
    ``words`` (most significant first), live rows (``active``, None: all)
    first."""
    dev = active.device if active is not None else (
        words[0][0].device if words else None)
    if dev is not None and dev.type == "cuda":
        return sort_perm_kernel(words, active, n)
    return sort_perm_plain(words, active, n, dev)


def sort_perm_plain(words: Sequence[Word], active: Optional[torch.Tensor],
                    n: int, device=None) -> torch.Tensor:
    """Plain PyTorch version of ``sort_perm``: stable sorts from the least
    significant word up, then by the dead flag."""
    order = torch.arange(n, device=device)
    for w, _ in reversed(words):
        order = order[torch.sort(w[order], stable=True).indices]
    if active is not None:
        dead = (~active).to(torch.int8)
        order = order[torch.sort(dead[order], stable=True).indices]
    return order.to(torch.int32)


def sort_perm_kernel(words: Sequence[Word], active: Optional[torch.Tensor],
                     n: int) -> torch.Tensor:
    """Launch ``sort_perm`` of ``csrc/sort.cu`` (same arguments as
    :func:`sort_perm`)."""
    dev = active.device if active is not None else words[0][0].device
    for w, b in words:
        _check(w, n, "a sort word")
        if w.dtype != torch.int64 or not 1 <= b <= 8:
            raise ValueError("sort words are int64 with 1..8 radix bytes")
    _check(active, n, "the live mask")
    if active is not None and active.dtype != torch.bool:
        raise ValueError("active must be bool")
    perm = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return perm
    passes = sum(b for _, b in words) + (active is not None)
    lib = kernels.load("sort")
    nbytes = lib.sort_perm_scratch(n, passes)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    P = kernels.pointer_array
    rc = lib.sort_perm(len(words), P([w.data_ptr() for w, _ in words]),
                       kernels.int_array([b for _, b in words]),
                       _ptr(active), n, perm.data_ptr(), scratch.data_ptr(),
                       nbytes, _stream(perm))
    kernels.check_launch(lib, "sort_perm", rc)
    sort_perm_kernel.launches += 1
    return perm


sort_perm_kernel.launches = 0


def sort_keys_perm(keys: Sequence[SortKey], active: Optional[torch.Tensor],
                   n: int) -> torch.Tensor:
    """The stable permutation of ``n`` rows under ``keys``, live rows
    first: images, then the sort."""
    return sort_perm(sort_images(keys), active, n)


# ---------------------------------------------------------------------------------
# range key
# ---------------------------------------------------------------------------------

def range_key(data: torch.Tensor, valid: Optional[torch.Tensor],
              ascending: bool, nulls_first: bool,
              perm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """int64: the primary key's range image at each row of ``perm`` (None:
    every row in order)."""
    run = range_key_kernel if data.is_cuda else range_key_plain
    return run(data, valid, ascending, nulls_first, perm)


def range_key_plain(data, valid, ascending: bool, nulls_first: bool,
                    perm=None) -> torch.Tensor:
    """Plain PyTorch version of ``sort_range_key`` in ``csrc/sort.cu``."""
    key_args(data)
    if perm is not None:
        data = data[perm.long()]
        valid = None if valid is None else valid[perm.long()]
    view = sortable_view(data)
    if not ascending:
        view = ~view
    if valid is not None:
        info = torch.iinfo(torch.int64)
        view = torch.where(valid, view, torch.full_like(
            view, info.min if nulls_first else info.max))
    return view


def range_key_kernel(data, valid, ascending: bool, nulls_first: bool,
                     perm=None) -> torch.Tensor:
    """Launch ``sort_range_key`` of ``csrc/sort.cu``."""
    n = data.shape[0] if perm is None else perm.shape[0]
    rows = data.shape[0]
    _check(data, rows, "the range key")
    _check(valid, rows, "the range key's validity")
    if perm is not None:
        _check(perm, n, "the permutation")
        if perm.dtype != torch.int32:
            raise ValueError("the permutation must be int32")
    elem, kind = key_args(data)
    out = torch.empty(n, dtype=torch.int64, device=data.device)
    if n == 0:
        return out
    lib = kernels.load("sort")
    rc = lib.sort_range_key(data.data_ptr(), _ptr(valid), elem, kind,
                            int(not ascending), int(nulls_first), _ptr(perm),
                            n, out.data_ptr(), _stream(data))
    kernels.check_launch(lib, "sort_range_key", rc)
    range_key_kernel.launches += 1
    return out


range_key_kernel.launches = 0


# ---------------------------------------------------------------------------------
# gather
# ---------------------------------------------------------------------------------

def gather_columns(cols: Sequence[Value], perm: torch.Tensor) -> List[Value]:
    """Each (data, valid) column taken at the int32 permutation ``perm``
    (wide decimal limbs move as two columns)."""
    from .wide_decimal import join_wide, split_wide
    cols, layout = split_wide(cols)
    run = gather_kernel if perm.is_cuda else gather_plain
    out: List[Value] = []
    for lo in range(0, len(cols), SO_MAX_COLS):
        out += run(cols[lo:lo + SO_MAX_COLS], perm)
    return join_wide(out, layout)


def gather_plain(cols, perm) -> List[Value]:
    """Plain PyTorch version of ``sort_gather`` in ``csrc/sort.cu``."""
    p = perm.long()
    return [(d[p], None if v is None else v[p]) for d, v in cols]


def gather_kernel(cols, perm) -> List[Value]:
    """Launch ``sort_gather`` of ``csrc/sort.cu`` (same arguments as
    :func:`gather_plain`)."""
    n = perm.shape[0]
    if not 1 <= len(cols) <= SO_MAX_COLS:
        raise ValueError(f"the gather takes 1..{SO_MAX_COLS} columns")
    _check(perm, n, "the permutation")
    if perm.dtype != torch.int32:
        raise ValueError("the permutation must be int32")
    ins, outs, vins, vouts, elems, result = [], [], [], [], [], []
    for d, v in cols:
        if not d.is_cuda or not d.is_contiguous() or d.dim() != 1 or (
                v is not None and (v.shape != d.shape or not v.is_cuda
                                   or v.dtype != torch.bool
                                   or not v.is_contiguous())):
            raise ValueError("gathered columns must be contiguous 1-d CUDA "
                             "tensors with bool validity")
        if d.element_size() not in (1, 2, 4, 8):
            raise ValueError(f"the gather moves 1, 2, 4 or 8-byte elements, "
                             f"not {d.dtype}")
        od = torch.empty(n, dtype=d.dtype, device=d.device)
        ov = None if v is None else torch.empty(n, dtype=torch.bool,
                                                device=d.device)
        ins.append(d.data_ptr())
        outs.append(od.data_ptr())
        vins.append(_ptr(v))
        vouts.append(_ptr(ov))
        elems.append(d.element_size())
        result.append((od, ov))
    if n == 0:
        return result
    lib = kernels.load("sort")
    P = kernels.pointer_array
    rc = lib.sort_gather(len(cols), P(ins), P(outs), P(vins), P(vouts),
                         kernels.int_array(elems), perm.data_ptr(), n,
                         _stream(perm))
    kernels.check_launch(lib, "sort_gather", rc)
    gather_kernel.launches += 1
    return result


gather_kernel.launches = 0
