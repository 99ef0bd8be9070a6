"""Parquet's page format in numpy: the codecs, the encodings and the
decoding of one column chunk.

What the reader supports, and what raises (naming ROADMAP.md item 9):

* codecs UNCOMPRESSED, SNAPPY (:func:`snappy_decompress`, a plain Python
  decoder of the raw snappy format) and GZIP (``zlib``); any other codec
  raises;
* data pages v1 (levels with a 4-byte length prefix, inside the
  compressed page) and v2 (levels uncompressed, no prefix), and
  dictionary pages;
* PLAIN values of BOOLEAN (bit-packed), INT32, INT64, FLOAT, DOUBLE and
  BYTE_ARRAY, and RLE_DICTIONARY / PLAIN_DICTIONARY indices into a PLAIN
  dictionary page, falling back to PLAIN pages inside one chunk as
  writers do once a dictionary grows large;
* the RLE/bit-packed hybrid (:func:`rle_hybrid`) for definition levels and
  dictionary indices;
* flat columns only (a definition level of at most 1, no repetition).

A decoded chunk is a :class:`Chunk`: its validity and, for numbers, the
values of the valid rows; for strings, a dictionary of distinct values in
ascending order and each valid row's rank in it (``np.unique`` of the
chunk's dictionary page; a page written as sorted is taken as it is), so
neither the reader nor the engine above it sorts the strings of every
row.
"""

from __future__ import annotations

import zlib
from typing import List, Optional, Tuple

import numpy as np

from .thrift import read_page_header

__all__ = ["CODECS", "ENCODINGS", "PHYSICAL", "Chunk", "snappy_decompress",
           "decompress", "rle_hybrid", "rle_hybrid_encode", "plain_decode",
           "plain_encode_strings", "read_chunk", "unsupported"]

PHYSICAL = {0: "BOOLEAN", 1: "INT32", 2: "INT64", 3: "INT96", 4: "FLOAT",
            5: "DOUBLE", 6: "BYTE_ARRAY", 7: "FIXED_LEN_BYTE_ARRAY"}
CODECS = {0: "UNCOMPRESSED", 1: "SNAPPY", 2: "GZIP", 3: "LZO", 4: "BROTLI",
          5: "LZ4", 6: "ZSTD", 7: "LZ4_RAW"}
ENCODINGS = {0: "PLAIN", 2: "PLAIN_DICTIONARY", 3: "RLE", 4: "BIT_PACKED",
             5: "DELTA_BINARY_PACKED", 6: "DELTA_LENGTH_BYTE_ARRAY",
             7: "DELTA_BYTE_ARRAY", 8: "RLE_DICTIONARY",
             9: "BYTE_STREAM_SPLIT"}
_NUMPY = {1: "<i4", 2: "<i8", 4: "<f4", 5: "<f8"}


def unsupported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"parquet {what} is not supported by the port's reader yet "
        f"(ROADMAP.md item 9)")


# ---------------------------------------------------------------------------------
# Codecs
# ---------------------------------------------------------------------------------

def snappy_decompress(src) -> bytes:
    """The raw snappy format (what parquet's SNAPPY pages hold): a varint
    length, then literals and back-references."""
    src = bytes(src)
    pos = shift = n = 0
    while True:
        b = src[pos]
        pos += 1
        n |= (b & 0x7F) << shift
        if b < 0x80:
            break
        shift += 7
    out = bytearray()
    end = len(src)
    while pos < end:
        tag = src[pos]
        pos += 1
        kind = tag & 3
        if kind == 0:
            ln = tag >> 2
            if ln >= 60:
                nb = ln - 59
                ln = int.from_bytes(src[pos:pos + nb], "little")
                pos += nb
            ln += 1
            out += src[pos:pos + ln]
            pos += ln
            continue
        if kind == 1:
            ln = ((tag >> 2) & 7) + 4
            off = ((tag >> 5) << 8) | src[pos]
            pos += 1
        elif kind == 2:
            ln = (tag >> 2) + 1
            off = src[pos] | (src[pos + 1] << 8)
            pos += 2
        else:
            ln = (tag >> 2) + 1
            off = int.from_bytes(src[pos:pos + 4], "little")
            pos += 4
        start = len(out) - off
        if off <= 0 or start < 0:
            raise ValueError("snappy: corrupt back-reference")
        if off >= ln:
            out += out[start:start + ln]
        else:  # an overlapping copy repeats the last `off` bytes
            pat = bytes(out[start:])
            out += (pat * (ln // off + 1))[:ln]
    if len(out) != n:
        raise ValueError(f"snappy: {len(out)} bytes decoded, {n} expected")
    return bytes(out)


def decompress(data, codec: int, size: int) -> bytes:
    """A page's bytes under ``codec`` (the ColumnMetaData enum)."""
    if codec == 0:
        return data
    if codec == 1:
        return snappy_decompress(data)
    if codec == 2:
        return zlib.decompress(bytes(data), 47)  # gzip or zlib header
    raise unsupported(f"codec {CODECS.get(codec, codec)}")


# ---------------------------------------------------------------------------------
# The RLE / bit-packed hybrid
# ---------------------------------------------------------------------------------

def _unpack(raw: np.ndarray, bit_width: int, count: int) -> np.ndarray:
    """``count`` little-endian bit-packed values of ``bit_width`` bits.
    Up to 8 bits, each group of 8 values (``bit_width`` bytes) is read as
    one 64-bit word and shifted apart; wider values go through single
    bits."""
    if bit_width <= 8 and count % 8 == 0:
        groups = np.zeros((count // 8, 8), dtype=np.uint8)
        groups[:, :bit_width] = raw[:count // 8 * bit_width].reshape(
            -1, bit_width)
        words = groups.view("<u8")
        shifts = np.arange(8, dtype=np.uint64) * np.uint64(bit_width)
        return ((words >> shifts) & np.uint64((1 << bit_width) - 1)
                ).astype(np.int32).reshape(-1)
    bits = np.unpackbits(raw, bitorder="little")[:count * bit_width]
    bits = bits.reshape(count, bit_width)
    if bit_width <= 8:
        return np.packbits(bits, axis=1, bitorder="little")[:, 0].astype(
            np.int32)
    w = (np.int64(1) << np.arange(bit_width, dtype=np.int64))
    return (bits.astype(np.int64) @ w).astype(np.int32)


def rle_hybrid(buf, pos: int, end: int, bit_width: int, count: int
               ) -> np.ndarray:
    """int32 [count] values of the RLE/bit-packed hybrid in
    ``buf[pos:end]``.  Repeated runs fill their slices as they are read;
    the bytes of every bit-packed run are unpacked together at the end."""
    out = np.zeros(count, dtype=np.int32)
    if bit_width == 0 or count == 0:
        return out
    vbytes = (bit_width + 7) // 8
    lit_dst: List[Tuple[int, int]] = []
    lit_src: List[bytes] = []
    i = 0
    while i < count and pos < end:
        shift = header = 0
        while True:
            b = buf[pos]
            pos += 1
            header |= (b & 0x7F) << shift
            if b < 0x80:
                break
            shift += 7
        if header & 1:
            groups = header >> 1
            nbytes = groups * bit_width
            take = min(groups * 8, count - i)
            lit_dst.append((i, take))
            lit_src.append(bytes(buf[pos:pos + nbytes]))
            pos += nbytes
            i += take
        else:
            run = min(header >> 1, count - i)
            out[i:i + run] = int.from_bytes(buf[pos:pos + vbytes], "little")
            pos += vbytes
            i += run
    if lit_dst:
        raw = np.frombuffer(b"".join(lit_src), dtype=np.uint8)
        vals = _unpack(raw, bit_width, len(raw) * 8 // bit_width)
        if len(lit_dst) == 1:
            d, take = lit_dst[0]
            out[d:d + take] = vals[:take]
        else:
            dst = np.array([d for d, _ in lit_dst], dtype=np.int64)
            take = np.array([t for _, t in lit_dst], dtype=np.int64)
            # each run's values start at a multiple of 8 in `vals`
            groups = np.array([len(s) // bit_width * 8 for s in lit_src],
                              dtype=np.int64)
            src0 = np.concatenate([[0], np.cumsum(groups)[:-1]])
            step = np.arange(int(take.sum()), dtype=np.int64) - np.repeat(
                np.cumsum(take) - take, take)
            out[np.repeat(dst, take) + step] = vals[np.repeat(src0, take)
                                                    + step]
    return out


def rle_hybrid_encode(values: np.ndarray, bit_width: int) -> bytes:
    """``values`` as the hybrid: one repeated run when every value is the
    same, else one bit-packed run (padded to a multiple of 8 values)."""
    values = np.asarray(values, dtype=np.int64)
    n = len(values)

    def varint(v):
        out = bytearray()
        while v >= 0x80:
            out.append((v & 0x7F) | 0x80)
            v >>= 7
        out.append(v)
        return bytes(out)
    if n == 0:
        return b""
    if bit_width == 0 or (values == values[0]).all():
        return varint(n << 1) + int(values[0]).to_bytes(
            (bit_width + 7) // 8, "little")
    groups = -(-n // 8)
    padded = np.zeros(groups * 8, dtype=np.int64)
    padded[:n] = values
    bits = ((padded[:, None] >> np.arange(bit_width)) & 1).astype(np.uint8)
    return varint((groups << 1) | 1) + np.packbits(
        bits.reshape(-1), bitorder="little").tobytes()


# ---------------------------------------------------------------------------------
# PLAIN
# ---------------------------------------------------------------------------------

def _plain_strings(buf, pos: int, end: int, count: int) -> np.ndarray:
    """``count`` PLAIN BYTE_ARRAY values as an object array of str.  When
    every value has the first value's length (fixed-width keys, names and
    codes) the lengths are checked and the bytes cut in one numpy step."""
    out = np.empty(count, dtype=object)
    if count == 0:
        return out
    ln = int.from_bytes(buf[pos:pos + 4], "little")
    if end - pos == count * (4 + ln):
        rows = np.frombuffer(buf, dtype=np.uint8, count=count * (4 + ln),
                             offset=pos).reshape(count, 4 + ln)
        lens = np.ascontiguousarray(rows[:, :4]).view("<u4").ravel()
        body = np.ascontiguousarray(rows[:, 4:])
        if (lens == ln).all() and (ln == 0 or (
                (body < 128).all() and (body[:, -1] != 0).all())):
            if ln == 0:
                out[:] = ""
            else:
                out[:] = body.view(f"S{ln}").ravel().astype(f"U{ln}")
            return out
    mv = bytes(buf[pos:end])
    p = 0
    for i in range(count):
        n = int.from_bytes(mv[p:p + 4], "little")
        out[i] = mv[p + 4:p + 4 + n].decode("utf-8")
        p += 4 + n
    return out


def plain_decode(buf, pos: int, end: int, ptype: int, count: int):
    """``count`` PLAIN values of physical type ``ptype``."""
    if ptype in _NUMPY:
        return np.frombuffer(buf, dtype=_NUMPY[ptype], count=count,
                             offset=pos)
    if ptype == 0:
        raw = np.frombuffer(buf, dtype=np.uint8, count=(count + 7) // 8,
                            offset=pos)
        return np.unpackbits(raw, bitorder="little")[:count].astype(bool)
    if ptype == 6:
        return _plain_strings(buf, pos, end, count)
    raise unsupported(f"physical type {PHYSICAL.get(ptype, ptype)}")


def plain_encode_strings(values) -> bytes:
    """Strings as PLAIN BYTE_ARRAY values (4-byte length, UTF-8 bytes)."""
    parts = []
    for v in values:
        b = v.encode("utf-8")
        parts.append(len(b).to_bytes(4, "little"))
        parts.append(b)
    return b"".join(parts)


# ---------------------------------------------------------------------------------
# One column chunk
# ---------------------------------------------------------------------------------

class Chunk:
    """A decoded flat column chunk of ``n`` rows: ``valid`` (bool [n], or
    None when no row is null); ``values``, the valid rows' values (numbers)
    or, for strings, ``dictionary`` (distinct str, ascending, object
    array) and ``codes`` (int32, each valid row's index into it)."""

    __slots__ = ("n", "valid", "values", "dictionary", "codes")

    def __init__(self, n, valid, values=None, dictionary=None, codes=None):
        self.n = n
        self.valid = valid
        self.values = values
        self.dictionary = dictionary
        self.codes = codes


def _sorted_strings(values: np.ndarray, codes: np.ndarray,
                    trusted: bool) -> Tuple[np.ndarray, np.ndarray]:
    """(ascending distinct values, codes remapped into them)."""
    if trusted or len(values) == 0:
        return values, codes
    uniq, inverse = np.unique(values, return_inverse=True)
    dictionary = np.empty(len(uniq), dtype=object)
    dictionary[:] = list(uniq)
    return dictionary, inverse.reshape(-1).astype(np.int32)[codes]


def read_chunk(buf, meta: dict, ptype: int, max_def: int, n: int) -> Chunk:
    """Decode the column chunk ``meta`` (a ``read_file_metadata`` column)
    of ``n`` rows from the file bytes ``buf``."""
    codec = meta["codec"]
    if codec not in (0, 1, 2):
        raise unsupported(f"codec {CODECS.get(codec, codec)}")
    data_off = meta["data_page_offset"]
    dict_off = meta["dictionary_page_offset"]
    pos = dict_off if dict_off is not None and dict_off < data_off \
        else data_off
    total = meta["num_values"]
    dictionary = None
    dict_sorted = False
    valids: List[np.ndarray] = []
    pieces: List[tuple] = []    # ("plain", values) | ("dict", indices)
    seen = 0
    while seen < total:
        h, pos = read_page_header(buf, pos)
        page = memoryview(buf)[pos:pos + h.compressed_size]
        pos += h.compressed_size
        if h.type == 2:
            raw = decompress(page, codec, h.uncompressed_size)
            if h.encoding not in (0, 2):
                raise unsupported(
                    f"dictionary encoding {ENCODINGS.get(h.encoding)}")
            dictionary = plain_decode(raw, 0, len(raw), ptype, h.num_values)
            dict_sorted = bool(h.is_sorted)
            continue
        if h.type not in (0, 3):
            continue  # index pages
        nv = h.num_values
        if h.type == 0:
            raw = decompress(page, codec, h.uncompressed_size)
            p = 0
            defs = None
            if max_def:
                if h.def_encoding != 3:
                    raise unsupported(f"definition level encoding "
                                      f"{ENCODINGS.get(h.def_encoding)}")
                ln = int.from_bytes(raw[0:4], "little")
                defs = rle_hybrid(raw, 4, 4 + ln, 1, nv)
                p = 4 + ln
            body, bpos = raw, p
        else:
            lvl = h.rep_bytes + h.def_bytes
            defs = rle_hybrid(page, h.rep_bytes, lvl, 1, nv) if max_def \
                else None
            rest = page[lvl:]
            body = decompress(rest, codec, h.uncompressed_size - lvl) \
                if h.is_compressed else bytes(rest)
            bpos = 0
        ok = None if defs is None else defs.astype(bool)
        k = nv if ok is None else int(ok.sum())
        end = len(body)
        if h.encoding == 0:
            pieces.append(("plain", plain_decode(body, bpos, end, ptype, k)))
        elif h.encoding in (2, 8):
            if dictionary is None:
                raise ValueError("parquet: dictionary page missing")
            bw = body[bpos] if k else 0
            pieces.append(("dict", rle_hybrid(body, bpos + 1, end, bw, k)))
        elif h.encoding == 3 and ptype == 0:
            # booleans as the hybrid, length-prefixed (v2 pages)
            ln = int.from_bytes(body[bpos:bpos + 4], "little")
            pieces.append(("plain", rle_hybrid(body, bpos + 4, bpos + 4 + ln,
                                               1, k).astype(bool)))
        else:
            raise unsupported(f"encoding {ENCODINGS.get(h.encoding)}")
        valids.append(np.ones(nv, dtype=bool) if ok is None else ok)
        seen += nv
    valid = np.concatenate(valids) if valids else np.ones(0, dtype=bool)
    if len(valid) != n:
        raise ValueError(f"parquet: chunk holds {len(valid)} values, "
                         f"{n} rows expected")
    valid = None if valid.all() else valid
    if ptype == 6:
        # strings: every piece as codes into dictionary + plain values
        parts, codes, base = [], [], 0
        if dictionary is not None:
            parts.append(dictionary)
            base = len(dictionary)
        for kind, v in pieces:
            if kind == "dict":
                codes.append(v)
            else:
                parts.append(v)
                codes.append(np.arange(base, base + len(v), dtype=np.int32))
                base += len(v)
        values = np.concatenate(parts) if parts else np.empty(0, object)
        codes = np.concatenate(codes) if codes else np.zeros(0, np.int32)
        only_dict = all(kind == "dict" for kind, _ in pieces)
        d, c = _sorted_strings(values, codes, dict_sorted and only_dict)
        return Chunk(n, valid, dictionary=d, codes=c)
    vals = [v if kind == "plain" else dictionary[v] for kind, v in pieces]
    values = np.concatenate(vals) if len(vals) > 1 else (
        vals[0] if vals else np.zeros(0, dtype=_NUMPY.get(ptype, bool)))
    return Chunk(n, valid, values=values)
