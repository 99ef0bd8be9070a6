"""String functions the port evaluates on the host
(``spark_rapids_tpu/stringfns.py`` counterpart: ``Substring`` :142 and
``Like`` :232).

Strings have no device form in the port.  These expressions are evaluated
by ``plan/stringpred.py`` once per distinct value of the one string column
they read (or once per dictionary entry of a column a join produced), and
the results reach the device as a bool column or as the int32 codes of a
new dictionary.  ``apply`` maps a numpy array of distinct non-null strings
to the results; a null input gives null.
"""

from __future__ import annotations

import re

import numpy as np

from . import types as T
from .exprs import Expression

__all__ = ["Substring", "Like", "like_pattern_to_regex"]


class _HostStringExpression(Expression):
    """Base: one string child (plus literal arguments), evaluated on the
    host only."""

    out_type = T.STRING

    def __init__(self, *children: Expression):
        self.children = tuple(children)
        if all(c.resolved() for c in children):
            self._rebind()

    def _rebind(self):
        self.dtype = self.out_type
        self.nullable = any(c.nullable for c in self.children)

    def eval(self, ctx):
        raise NotImplementedError(
            f"{type(self).__name__} is evaluated on the host "
            f"(plan/stringpred.py), not in a device stage")

    def apply(self, values: np.ndarray) -> np.ndarray:
        raise NotImplementedError


def _literal_int(e: Expression, what: str) -> int:
    value = getattr(e, "value", None)
    if not isinstance(value, (int, np.integer)):
        raise NotImplementedError(f"substring {what} must be an integer "
                                  f"literal, got {e.fingerprint()}")
    return int(value)


class Substring(_HostStringExpression):
    """``substring(str, pos, len)``: 1-based; pos <= 0 counts from the end
    (0 acts as 1); a length <= 0 gives ''."""

    def window(self, length: int):
        """(start, end) of the characters kept from a string of
        ``length``, clamped at 0 (Spark's substringSQL)."""
        pos = _literal_int(self.children[1], "position")
        ln = _literal_int(self.children[2], "length")
        if ln <= 0:
            return 0, 0
        start = pos - 1 if pos > 0 else 0 if pos == 0 else length + pos
        return max(start, 0), max(start + ln, 0)

    def apply(self, values: np.ndarray) -> np.ndarray:
        pos = _literal_int(self.children[1], "position")
        values = np.asarray(values, dtype=str)
        if pos >= 0 and values.dtype.itemsize and len(values):
            # one slice of the fixed-width characters for every value
            width = values.dtype.itemsize // 4
            start, end = self.window(0)
            end = min(end, width)
            if end <= start:
                return np.full(len(values), "", dtype="U1")
            chars = values.view("U1").reshape(len(values), width)
            return chars[:, start:end].copy().view(
                f"U{end - start}").reshape(-1)
        out = np.empty(len(values), dtype=object)
        for i, s in enumerate(values.tolist()):
            lo, hi = self.window(len(s))
            out[i] = s[lo:hi] if hi > lo else ""
        return out.astype(str) if len(out) else np.array([], dtype="U1")


def like_pattern_to_regex(pattern: str, escape: str = "\\") -> str:
    """SQL LIKE → an anchored Python regex: ``%`` any run, ``_`` one
    character, ``escape`` quotes the next character."""
    out = []
    i = 0
    while i < len(pattern):
        ch = pattern[i]
        if ch == escape and i + 1 < len(pattern):
            out.append(re.escape(pattern[i + 1]))
            i += 2
            continue
        out.append(".*" if ch == "%" else "." if ch == "_"
                   else re.escape(ch))
        i += 1
    return "^" + "".join(out) + "$"


class Like(_HostStringExpression):
    """``str LIKE pattern``."""

    out_type = T.BOOLEAN

    def __init__(self, child: Expression, pattern: str, escape: str = "\\"):
        self.pattern = str(pattern)
        self.escape = escape
        super().__init__(child)

    def _fp_extra(self):
        return f"like={self.pattern!r}:{self.dtype}"

    def apply(self, values: np.ndarray) -> np.ndarray:
        values = np.asarray(values, dtype=str)
        p, plain = self.pattern, lambda s: not any(c in s for c in
                                                   "%_" + self.escape)
        # a literal with % at one or both ends needs no regex
        if len(p) >= 2 and p[0] == "%" and p[-1] == "%" and plain(p[1:-1]):
            return np.char.find(values, p[1:-1]) >= 0
        if p.endswith("%") and plain(p[:-1]):
            return np.char.startswith(values, p[:-1])
        if p.startswith("%") and plain(p[1:]):
            return np.char.endswith(values, p[1:])
        rx = re.compile(like_pattern_to_regex(p, self.escape), re.DOTALL)
        return np.fromiter((rx.match(s) is not None for s in values.tolist()),
                           dtype=bool, count=len(values))
