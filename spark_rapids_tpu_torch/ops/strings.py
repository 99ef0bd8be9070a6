"""String group keys as dictionary codes (``spark_rapids_tpu/ops/strings.py``
counterpart, numpy only).

String key columns are dictionary-encoded on the host into dense int32
codes; the device groups on the codes, and the codes decode back to
strings at the output boundary.  The dictionary is incremental and
query-scoped: every batch extends the same mapping, so codes stay
comparable across batches.  Code order is insertion order, valid for
equality (grouping) only, never for ORDER BY.

:func:`encode_column` gives any string column as device codes: a host
column is encoded once and the encoding cached on the column object (the
in-memory scan hands out the same objects on every run); dictionary codes
that arrive from a join or a partial aggregate are adopted verbatim when
their dictionary is (a snapshot of) the one in use, and remapped into it otherwise, so codes of different
dictionaries are never compared.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["StringDictionary", "encode_column", "distinct_strings"]

_SAMPLE = 1 << 20


def distinct_strings(values: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(the sorted distinct values, each value's index into them): what
    ``np.unique(values, return_inverse=True)`` gives, without sorting the
    strings of a large fixed-width column.  Each string's characters are
    hashed to one uint64 word; the distinct hashes of a sample usually
    cover the column (a dimension column repeats few values), so the rows
    are found among them by binary search, else every hash is sorted.  The
    distinct strings are checked to have distinct hashes; a collision
    falls back to ``np.unique`` of the strings."""
    if values.dtype.kind == "O":
        values = values.astype(str)
    n = len(values)
    if values.dtype.kind == "U" and n > _SAMPLE and values.dtype.itemsize:
        words = np.ascontiguousarray(values).view(np.uint32).reshape(n, -1)
        h = np.zeros(n, dtype=np.uint64)
        for j in range(words.shape[1]):
            h = (h * np.uint64(0x100000001B3)) ^ words[:, j]
        hu, first = np.unique(h[:_SAMPLE], return_index=True)
        at = np.minimum(np.searchsorted(hu, h), len(hu) - 1)
        if not np.array_equal(hu[at], h):
            hu, first, at = np.unique(h, return_index=True,
                                      return_inverse=True)
        cand = values[first]
        order = np.argsort(cand, kind="stable")
        if len(np.unique(cand)) == len(cand):
            rank = np.empty(len(order), dtype=np.int64)
            rank[order] = np.arange(len(order))
            return cand[order], rank[at.reshape(-1)]
    uniq, inverse = np.unique(values, return_inverse=True)
    return uniq, inverse.reshape(-1)



class StringDictionary:
    """Incremental string → int32 code mapping."""

    def __init__(self):
        self._code_of: Dict[str, int] = {}
        self._values: List[str] = []
        self._array: Optional[np.ndarray] = None
        # values adopted by from_values, turned into the map above only
        # when a lookup needs it: adopted codes are used as they are
        self._pending: Optional[np.ndarray] = None
        # the values array this dictionary was adopted from: codes that
        # refer to it are this dictionary's codes
        self.source: Optional[np.ndarray] = None
        # id(values array) -> (values array, device remap into this one)
        self.remaps: Dict[int, tuple] = {}
        # the snapshots values() handed out: codes are only ever appended,
        # so codes coded against any of them are this dictionary's codes
        self._issued: Dict[int, np.ndarray] = {}

    @classmethod
    def from_values(cls, values: np.ndarray) -> "StringDictionary":
        """A dictionary whose codes are the positions in ``values``
        (distinct strings, as a join's dictionary holds)."""
        d = cls()
        d._pending = d._array = d.source = values
        return d

    def _materialize(self) -> None:
        if self._pending is not None:
            self._values = [str(v) for v in self._pending]
            self._code_of = {v: i for i, v in enumerate(self._values)}
            self._pending = None

    def __len__(self) -> int:
        if self._pending is not None:
            return len(self._pending)
        return len(self._values)

    def encode(self, data: np.ndarray, valid: Optional[np.ndarray] = None,
               distinct: Optional[tuple] = None
               ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """Host strings → (int32 codes, validity-or-None); null slots get
        code 0.  ``np.unique`` finds the batch's distinct values in C, so
        only those pass through the Python map; ``distinct`` gives them
        (the distinct live values and each live row's index) when the
        caller has them already, as a file scan does from its dictionary
        pages."""
        self._materialize()
        if distinct is None:
            live = data if valid is None else data[valid]
            distinct = distinct_strings(live)
        local, inverse = distinct
        remap = np.empty(max(len(local), 1), dtype=np.int32)
        for i, v in enumerate(local.tolist()):
            code = self._code_of.get(v)
            if code is None:
                code = len(self._values)
                self._code_of[v] = code
                self._values.append(v)
            remap[i] = code
        if valid is None:
            return remap[inverse.reshape(-1)], None
        codes = np.zeros(len(data), dtype=np.int32)
        codes[valid] = remap[inverse.reshape(-1)]
        return codes, valid

    def values(self) -> np.ndarray:
        """The dictionary as an object array: ``values()[code]``.  The same
        array object comes back until the dictionary grows, so columns
        coded against one snapshot share it (``DictStringColumn``
        identity)."""
        if self._pending is not None:
            return self._array
        if self._array is None or len(self._array) != len(self._values):
            self._array = np.empty(len(self._values), dtype=object)
            self._array[:] = self._values
            self._issued[id(self._array)] = self._array
        return self._array

    def issued(self, values: np.ndarray) -> bool:
        """Is ``values`` a snapshot of this dictionary (its codes valid
        here as they are)?"""
        return values is self.source \
            or self._issued.get(id(values)) is values


def encode_column(col, d: Optional[StringDictionary], device: torch.device):
    """(dictionary, device int32 codes, device valid-or-None) of a string
    column under dictionary ``d`` (None: the column's own or a new one).

    A ``HostStringColumn`` is encoded on the host and its encoding cached
    on the column object; a query with no dictionary yet adopts the cached
    one.  A ``DictStringColumn``'s codes are used verbatim when its
    dictionary is ``d``'s source (or ``d`` is None, which adopts it), and
    otherwise remapped into ``d`` through a device gather."""
    from ..batch import DictStringColumn, upload
    if isinstance(col, DictStringColumn):
        if d is None:
            d = StringDictionary.from_values(col.dictionary)
        if d.issued(col.dictionary):
            return d, col.codes, col.valid
        if len(col.dictionary) == 0:  # every row is null
            return d, torch.zeros_like(col.codes), col.valid
        hit = d.remaps.get(id(col.dictionary))
        if hit is None or hit[0] is not col.dictionary:
            codes, _ = d.encode(np.asarray(col.dictionary, dtype=object))
            hit = (col.dictionary,
                   upload(torch.from_numpy(codes), col.codes.device))
            d.remaps[id(col.dictionary)] = hit
        from .join import gather_rows
        (codes, _), = gather_rows(col.codes, [(hit[1], None)],
                                  nullable=False)
        return d, codes, col.valid
    cached = col._enc_cache
    if cached is not None and cached[1].device == device \
            and (d is None or cached[0] is d):
        return cached
    d = d if d is not None else StringDictionary()
    codes, valid = d.encode(col.data, col.valid,
                            col.__dict__.get("_distinct"))
    col._enc_cache = (d, upload(torch.from_numpy(codes), device),
                      None if valid is None
                      else upload(torch.from_numpy(valid), device))
    return col._enc_cache
