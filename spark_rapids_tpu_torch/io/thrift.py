"""The Thrift compact protocol, as parquet's footer and page headers use it.

pyarrow parses these structures for the reference (``spark_rapids_tpu/io/
parquet.py``); the port reads and writes them itself, with no dependency
beyond the standard library.

Reading is generic: :func:`read_struct` decodes every field of a struct
into a dict keyed by field id (nested structs as dicts, lists as lists,
binaries as bytes), so a field the port does not know, such as the size
statistics and page-index offsets recent writers add, is read past and
ignored.  :func:`read_file_metadata` and :func:`read_page_header` then
name the fields the reader uses (``FileMetaData``, ``SchemaElement``,
``RowGroup``, ``ColumnChunk``, ``ColumnMetaData``, ``Statistics``,
``PageHeader``, ``DataPageHeader`` v1 and v2, ``DictionaryPageHeader``).

Writing takes structs as lists of ``(field id, type, value)`` with the
type names of :data:`TYPES`; a nested struct's value is such a list, a
list's value is ``(element type, items)``.
"""

from __future__ import annotations

import struct as _struct
from typing import Any, Dict, List, Tuple

__all__ = ["TYPES", "read_struct", "write_struct", "read_file_metadata",
           "read_page_header", "PageHeader"]

# compact protocol type ids
_STOP, _TRUE, _FALSE, _BYTE, _I16, _I32, _I64, _DOUBLE, _BINARY, _LIST, \
    _SET, _MAP, _STRUCT = range(13)
TYPES = {"bool": _TRUE, "byte": _BYTE, "i16": _I16, "i32": _I32,
         "i64": _I64, "double": _DOUBLE, "binary": _BINARY, "list": _LIST,
         "struct": _STRUCT}


class _Reader:
    def __init__(self, buf, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def byte(self) -> int:
        b = self.buf[self.pos]
        self.pos += 1
        return b

    def varint(self) -> int:
        shift = out = 0
        while True:
            b = self.buf[self.pos]
            self.pos += 1
            out |= (b & 0x7F) << shift
            if b < 0x80:
                return out
            shift += 7

    def zigzag(self) -> int:
        v = self.varint()
        return (v >> 1) ^ -(v & 1)

    def value(self, t: int) -> Any:
        if t == _TRUE:
            return True
        if t == _FALSE:
            return False
        if t == _BYTE:
            b = self.byte()
            return b - 256 if b > 127 else b
        if t in (_I16, _I32, _I64):
            return self.zigzag()
        if t == _DOUBLE:
            v = _struct.unpack_from("<d", self.buf, self.pos)[0]
            self.pos += 8
            return v
        if t == _BINARY:
            n = self.varint()
            v = bytes(self.buf[self.pos:self.pos + n])
            self.pos += n
            return v
        if t in (_LIST, _SET):
            head = self.byte()
            n, et = head >> 4, head & 0x0F
            if n == 15:
                n = self.varint()
            if et in (_TRUE, _FALSE):  # booleans as one byte each
                return [self.byte() == _TRUE for _ in range(n)]
            return [self.value(et) for _ in range(n)]
        if t == _MAP:
            n = self.varint()
            if n == 0:
                return {}
            kv = self.byte()
            return {self.value(kv >> 4): self.value(kv & 0x0F)
                    for _ in range(n)}
        if t == _STRUCT:
            return self.struct()
        raise ValueError(f"thrift: unknown compact type {t}")

    def struct(self) -> Dict[int, Any]:
        out: Dict[int, Any] = {}
        last = 0
        while True:
            head = self.byte()
            t = head & 0x0F
            if t == _STOP:
                return out
            delta = head >> 4
            fid = last + delta if delta else self.zigzag()
            out[fid] = self.value(t)
            last = fid


def read_struct(buf, pos: int = 0) -> Tuple[Dict[int, Any], int]:
    """(the struct at ``pos`` as {field id: value}, the position after
    it)."""
    r = _Reader(buf, pos)
    return r.struct(), r.pos


class _Writer:
    def __init__(self):
        self.out = bytearray()

    def varint(self, v: int) -> None:
        while True:
            if v < 0x80:
                self.out.append(v)
                return
            self.out.append((v & 0x7F) | 0x80)
            v >>= 7

    def zigzag(self, v: int) -> None:
        self.varint((v << 1) ^ (v >> 63))

    def value(self, t: str, v) -> None:
        if t == "byte":
            self.out.append(v & 0xFF)
        elif t in ("i16", "i32", "i64"):
            self.zigzag(int(v))
        elif t == "double":
            self.out += _struct.pack("<d", v)
        elif t == "binary":
            b = v.encode() if isinstance(v, str) else bytes(v)
            self.varint(len(b))
            self.out += b
        elif t == "list":
            et, items = v
            code = _TRUE if et == "bool" else TYPES[et]
            if len(items) < 15:
                self.out.append((len(items) << 4) | code)
            else:
                self.out.append(0xF0 | code)
                self.varint(len(items))
            for item in items:
                if et == "bool":
                    self.out.append(_TRUE if item else _FALSE)
                else:
                    self.value(et, item)
        elif t == "struct":
            self.struct(v)
        else:
            raise ValueError(f"thrift: cannot write type {t!r}")

    def struct(self, fields) -> None:
        last = 0
        for fid, t, v in fields:
            if v is None:
                continue
            code = (_TRUE if v else _FALSE) if t == "bool" else TYPES[t]
            if 0 < fid - last <= 15:
                self.out.append(((fid - last) << 4) | code)
            else:
                self.out.append(code)
                self.zigzag(fid)
            if t != "bool":
                self.value(t, v)
            last = fid
        self.out.append(_STOP)


def write_struct(fields: List[tuple]) -> bytes:
    """A struct given as ``[(field id, type, value), ...]`` (ascending
    ids; a None value is left out) in the compact protocol."""
    w = _Writer()
    w.struct(fields)
    return bytes(w.out)


# ---------------------------------------------------------------------------------
# Parquet's structures (parquet.thrift field ids)
# ---------------------------------------------------------------------------------

def _statistics(s) -> dict:
    if s is None:
        return None
    return {"max": s.get(1), "min": s.get(2), "null_count": s.get(3),
            "distinct_count": s.get(4), "max_value": s.get(5),
            "min_value": s.get(6)}


def _logical_type(lt) -> tuple:
    """LogicalType union → (name, params)."""
    if not lt:
        return None
    fid, v = next(iter(lt.items()))
    names = {1: "STRING", 2: "MAP", 3: "LIST", 4: "ENUM", 5: "DECIMAL",
             6: "DATE", 7: "TIME", 8: "TIMESTAMP", 10: "INTEGER",
             11: "UNKNOWN", 12: "JSON", 13: "BSON", 14: "UUID",
             15: "FLOAT16"}
    name = names.get(fid, f"logical{fid}")
    params = {}
    if name == "DECIMAL":
        params = {"scale": v.get(1), "precision": v.get(2)}
    elif name in ("TIME", "TIMESTAMP"):
        unit = v.get(2) or {}
        params = {"utc": v.get(1), "unit": {1: "ms", 2: "us", 3: "ns"}.get(
            next(iter(unit), None))}
    elif name == "INTEGER":
        params = {"bits": v.get(1), "signed": v.get(2)}
    return name, params


def read_file_metadata(buf) -> dict:
    """The footer's ``FileMetaData`` as a dict of the fields the reader
    uses."""
    fm, _ = read_struct(buf)
    schema = [{"type": e.get(1), "type_length": e.get(2),
               "repetition": e.get(3), "name": e.get(4).decode(),
               "num_children": e.get(5), "converted_type": e.get(6),
               "scale": e.get(7), "precision": e.get(8),
               "logical_type": _logical_type(e.get(10))}
              for e in fm.get(2, [])]
    row_groups = []
    for rg in fm.get(4, []):
        cols = []
        for cc in rg.get(1, []):
            md = cc.get(3) or {}
            cols.append({
                "file_path": cc.get(1), "type": md.get(1),
                "encodings": md.get(2, []),
                "path": [p.decode() for p in md.get(3, [])],
                "codec": md.get(4), "num_values": md.get(5),
                "total_uncompressed_size": md.get(6),
                "total_compressed_size": md.get(7),
                "data_page_offset": md.get(9),
                "dictionary_page_offset": md.get(11),
                "statistics": _statistics(md.get(12))})
        row_groups.append({"columns": cols, "total_byte_size": rg.get(2),
                           "num_rows": rg.get(3)})
    return {"version": fm.get(1), "schema": schema,
            "num_rows": fm.get(3, 0), "row_groups": row_groups,
            "key_value": {kv.get(1, b"").decode(): kv.get(2)
                          for kv in fm.get(5, [])},
            "created_by": (fm.get(6) or b"").decode(errors="replace"),
            "column_orders": fm.get(7)}


class PageHeader:
    """A page header's fields: ``type`` (0 data v1, 2 dictionary, 3 data
    v2), the sizes, and per type ``num_values``, ``encoding``, the level
    encodings or byte lengths, ``num_nulls``, ``is_compressed``."""

    __slots__ = ("type", "uncompressed_size", "compressed_size",
                 "num_values", "encoding", "def_encoding", "num_nulls",
                 "def_bytes", "rep_bytes", "is_compressed", "is_sorted")

    def __init__(self, h: dict):
        self.type = h.get(1)
        self.uncompressed_size = h.get(2)
        self.compressed_size = h.get(3)
        self.num_nulls = self.def_bytes = self.rep_bytes = None
        self.def_encoding = self.is_sorted = None
        self.is_compressed = True
        if self.type == 0:
            d = h.get(5) or {}
            self.num_values, self.encoding = d.get(1), d.get(2)
            self.def_encoding = d.get(3)
        elif self.type == 2:
            d = h.get(7) or {}
            self.num_values, self.encoding = d.get(1), d.get(2)
            self.is_sorted = d.get(3)
        elif self.type == 3:
            d = h.get(8) or {}
            self.num_values, self.num_nulls = d.get(1), d.get(2)
            self.encoding = d.get(4)
            self.def_bytes, self.rep_bytes = d.get(5), d.get(6)
            self.is_compressed = d.get(7, True)
        else:
            self.num_values = self.encoding = None


def read_page_header(buf, pos: int) -> Tuple[PageHeader, int]:
    """(the page header at ``pos``, the position of the page's data)."""
    h, end = read_struct(buf, pos)
    return PageHeader(h), end
