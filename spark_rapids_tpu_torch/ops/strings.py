"""String group keys as dictionary codes (``spark_rapids_tpu/ops/strings.py``
counterpart, numpy only).

String key columns are dictionary-encoded on the host into dense int32
codes; the device groups on the codes, and the codes decode back to
strings at the output boundary.  The dictionary is incremental and
query-scoped: every batch extends the same mapping, so codes stay
comparable across batches.  Code order is insertion order, valid for
equality (grouping) only, never for ORDER BY.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["StringDictionary"]


class StringDictionary:
    """Incremental string → int32 code mapping."""

    def __init__(self):
        self._code_of: Dict[str, int] = {}
        self._values: List[str] = []

    def __len__(self) -> int:
        return len(self._values)

    def encode(self, data: np.ndarray, valid: Optional[np.ndarray] = None
               ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """Host strings → (int32 codes, validity-or-None); null slots get
        code 0.  ``np.unique`` finds the batch's distinct values in C, so
        only those pass through the Python map."""
        live = data if valid is None else data[valid]
        if live.dtype.kind == "O":
            live = live.astype(str)
        local, inverse = np.unique(live, return_inverse=True)
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
        """The dictionary as an object array: ``values()[code]``."""
        out = np.empty(len(self._values), dtype=object)
        out[:] = self._values
        return out
