"""Spark-exact row hashing: murmur3 for hash partitioning, xxhash64 for the
shuffled join's sub-partitions (``spark_rapids_tpu/ops/hashing.py``
counterpart).

Semantics (org.apache.spark.sql.catalyst.expressions.Murmur3Hash and
XxHash64, seed 42), as the reference computes them:

* a null leaves the running hash unchanged;
* bool, int8, int16, int32, dates and dictionary codes hash as one 4-byte
  int; int64 as 8 bytes (murmur3: the low word, then the high word);
* float32 and float64 hash their bit patterns after -0.0 -> +0.0 and one
  canonical NaN (0x7FC00000, 0x7FF8000000000000); subnormals hash as +0.0,
  which is what the reference computes (its programs run with
  flush-to-zero, so a subnormal equals zero there; Spark keeps their bits:
  ROADMAP.md queue 3);
* a partition id is the non-negative remainder of the hash by the
  partition count: of the murmur3 hash as int32 (Spark's
  HashPartitioning), of the xxhash64 hash as int64; the aggregate's
  re-partition buckets (``xxhash64_mod``, reference
  ``plan/physical.py:2169 _split_by_key_hash``) take the remainder of the
  xxhash64 hash as an UNSIGNED 64-bit number.

The dispatching functions (``hash_columns``, ``xxhash64_columns``,
``spark_partition_id``, ``partition_ids``, ``xxhash64_mod``) launch
``csrc/hashing.cu`` for CUDA tensors (``hash_rows_kernel``, which counts
its launches; ``xxhash64_mod_kernel`` counts its own) and run the plain
PyTorch versions for CPU tensors.  The plain versions hold unsigned
32- and 64-bit words in int64 tensors: 32-bit words are masked, 64-bit
products wrap modulo 2^64 and right shifts are made logical by masks.
The kernel takes partition ids without division, by the constants
``_divisor`` computes once a call; ``partition_rule`` is that rule on
Python integers, which the tests hold to ``%``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from .. import kernels

__all__ = ["SPARK_PARTITION_SEED", "HS_MAX_KEYS", "HS_MAX_PARTS",
           "normalize_float_bits", "f64_bit_pattern", "hash_value",
           "hash_columns", "spark_partition_id", "xxhash64_value",
           "xxhash64_columns", "partition_ids", "hash_rows_plain",
           "hash_rows_kernel", "xxhash64_mod", "xxhash64_mod_plain",
           "xxhash64_mod_kernel", "partition_rule"]

Value = Tuple[torch.Tensor, Optional[torch.Tensor]]

SPARK_PARTITION_SEED = 42
HS_MAX_KEYS = 8             # csrc/hashing.cu HS_MAX_KEYS
HS_MAX_PARTS = 4096         # csrc/hashing.cu HS_MAX_PARTS
_ALGO = {"murmur3": 0, "xxhash64": 1, "xxhash64_umod": 2}
_M32 = 0xFFFFFFFF
_FLT_MIN = 1.17549435e-38
_DBL_MIN = 2.2250738585072014e-308


def _s64(u: int) -> int:
    """An unsigned 64-bit constant as the int64 with the same bits."""
    return u - (1 << 64) if u >= 1 << 63 else u


_XP1 = _s64(0x9E3779B185EBCA87)
_XP2 = _s64(0xC2B2AE3D27D4EB4F)
_XP3 = _s64(0x165667B19E3779F9)
_XP4 = _s64(0x85EBCA77C2B2AE63)
_XP5 = _s64(0x27D4EB2F165667C5)


# ---------------------------------------------------------------------------------
# Float normalizations
# ---------------------------------------------------------------------------------

def normalize_float_bits(d: torch.Tensor) -> torch.Tensor:
    """float32 → int32 bit pattern with -0.0, +0.0 and subnormals as
    +0.0's bits and every NaN as 0x7FC00000."""
    b = d.view(torch.int32)
    b = torch.where(d.abs() < _FLT_MIN, 0, b)
    return torch.where(torch.isnan(d), 0x7FC00000, b)


def f64_bit_pattern(d: torch.Tensor) -> torch.Tensor:
    """float64 → int64 bit pattern with -0.0, +0.0 and subnormals as 0 and
    every NaN as 0x7FF8000000000000."""
    b = d.view(torch.int64)
    b = torch.where(d.abs() < _DBL_MIN, 0, b)
    return torch.where(torch.isnan(d), 0x7FF8000000000000, b)


def _word(data: torch.Tensor) -> Tuple[torch.Tensor, bool]:
    """(the hash input of each row as int64, whether it takes the 8-byte
    path): 4-byte inputs as their unsigned 32-bit value."""
    if data.dtype == torch.float64:
        return f64_bit_pattern(data), True
    if data.dtype == torch.float32:
        return normalize_float_bits(data).to(torch.int64) & _M32, False
    if data.dtype == torch.int64:
        return data, True
    if data.dtype in (torch.bool, torch.int8, torch.int16, torch.int32):
        return data.to(torch.int32).to(torch.int64) & _M32, False
    raise TypeError(f"no device hash for dtype {data.dtype}")


def _lsr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64-held unsigned 64-bit words."""
    return (x >> s) & ((1 << (64 - s)) - 1)


# ---------------------------------------------------------------------------------
# murmur3, plain
# ---------------------------------------------------------------------------------

def _rotl32(x, r):
    return ((x << r) | (x >> (32 - r))) & _M32


def _mix_k1(k1):
    k1 = (k1 * 0xcc9e2d51) & _M32
    return (_rotl32(k1, 15) * 0x1b873593) & _M32


def _mix_h1(h1, k1):
    h1 = _rotl32(h1 ^ k1, 13)
    return (h1 * 5 + 0xe6546b64) & _M32


def _fmix32(h1, length: int):
    h1 = h1 ^ length
    h1 = h1 ^ (h1 >> 16)
    h1 = (h1 * 0x85ebca6b) & _M32
    h1 = h1 ^ (h1 >> 13)
    h1 = (h1 * 0xc2b2ae35) & _M32
    return h1 ^ (h1 >> 16)


def hash_value(data: torch.Tensor, valid: Optional[torch.Tensor],
               running: torch.Tensor) -> torch.Tensor:
    """Fold one column into the running murmur3 hash (uint32 values held
    in int64), plain version."""
    w, wide = _word(data)
    if wide:
        h = _mix_h1(running, _mix_k1(w & _M32))
        out = _fmix32(_mix_h1(h, _mix_k1(_lsr(w, 32))), 8)
    else:
        out = _fmix32(_mix_h1(running, _mix_k1(w)), 4)
    return out if valid is None else torch.where(valid, out, running)


# ---------------------------------------------------------------------------------
# xxhash64, plain
# ---------------------------------------------------------------------------------

def _rotl64(x, r):
    return (x << r) | _lsr(x, 64 - r)


def _xx_avalanche(h):
    h = h ^ _lsr(h, 33)
    h = h * _XP2
    h = h ^ _lsr(h, 29)
    h = h * _XP3
    return h ^ _lsr(h, 32)


def xxhash64_value(data: torch.Tensor, valid: Optional[torch.Tensor],
                   running: torch.Tensor) -> torch.Tensor:
    """Fold one column into the running xxhash64 (64 bits held in int64),
    plain version."""
    w, wide = _word(data)
    if wide:
        h = running + (_XP5 + 8)
        k1 = _rotl64(w * _XP2, 31) * _XP1
        h = _rotl64(h ^ k1, 27) * _XP1 + _XP4
    else:
        h = running + (_XP5 + 4)
        h = h ^ (w * _XP1)
        h = _rotl64(h, 23) * _XP2 + _XP3
    out = _xx_avalanche(h)
    return out if valid is None else torch.where(valid, out, running)


# ---------------------------------------------------------------------------------
# Row hashes, partition ids and counts
# ---------------------------------------------------------------------------------

def hash_rows_plain(keys: Sequence[Value], active: Optional[torch.Tensor],
                    algo: str, seed: int, nparts: int,
                    counts: Optional[torch.Tensor] = None):
    """Plain PyTorch version of ``hash_rows_kernel``: (int64 [n] hashes,
    int32 [n] partition ids or None); ``counts`` (int64 [nparts + 1]) is
    added to."""
    n = keys[0][0].shape[0]
    dev = keys[0][0].device
    h = torch.full((n,), seed, dtype=torch.int64, device=dev)
    fold = hash_value if algo == "murmur3" else xxhash64_value
    for d, v in keys:
        h = fold(d, v, h)
    if not nparts:
        return h, None
    signed = torch.where(h >= 1 << 31, h - (1 << 32), h) \
        if algo == "murmur3" else h
    pid = torch.remainder(signed, nparts).to(torch.int32)
    if active is not None:
        pid = torch.where(active, pid, nparts)
    if counts is not None:
        counts += torch.bincount(pid.to(torch.int64), minlength=nparts + 1)
    return h, pid


def hash_rows_kernel(keys: Sequence[Value], active: Optional[torch.Tensor],
                     algo: str, seed: int, nparts: int,
                     counts: Optional[torch.Tensor] = None,
                     want_hash: bool = True, pid_out=None):
    """Launch ``hash_rows`` of ``csrc/hashing.cu``: (int64 [n] hashes or
    None, int32 [n] partition ids or None).  ``pid_out`` may be a
    contiguous int32 [n] view to write the ids into; ``counts`` (int64
    [nparts + 1]) is added to."""
    out = _hash_rows(keys, active, algo, seed, nparts, counts, want_hash,
                     pid_out)
    hash_rows_kernel.launches += 1
    return out


def _hash_rows(keys, active, algo: str, seed: int, nparts: int, counts,
               want_hash: bool, pid_out):
    """One ``hash_rows`` launch after the checks (the callers count it)."""
    n = keys[0][0].shape[0]
    if not 1 <= len(keys) <= HS_MAX_KEYS:
        raise ValueError(f"hash_rows takes 1..{HS_MAX_KEYS} keys, got "
                         f"{len(keys)}")
    if not 0 <= nparts <= HS_MAX_PARTS:
        raise ValueError(f"hash_rows takes at most {HS_MAX_PARTS} partitions")
    for t, dtypes, what in [(d, None, "key") for d, _ in keys] \
            + [(v, (torch.bool,), "key valid") for _, v in keys] \
            + [(active, (torch.bool,), "active"),
               (counts, (torch.int64,), "counts"),
               (pid_out, (torch.int32,), "pid out")]:
        if t is None:
            continue
        m = nparts + 1 if what == "counts" else n
        if (dtypes is not None and t.dtype not in dtypes) \
                or t.shape != (m,) or not t.is_contiguous() or not t.is_cuda:
            raise ValueError(f"{what}: expected a contiguous CUDA [{m}] "
                             f"tensor, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    for d, _ in keys:
        if d.dtype not in (torch.bool, torch.int8, torch.int16, torch.int32,
                           torch.int64, torch.float32, torch.float64):
            raise TypeError(f"no device hash for dtype {d.dtype}")
    dev = keys[0][0].device
    h = torch.empty(n, dtype=torch.int64, device=dev) if want_hash else None
    pid = None
    if nparts:
        pid = pid_out if pid_out is not None else torch.empty(
            n, dtype=torch.int32, device=dev)
    magic, bias = _divisor(nparts, algo) if nparts else (0, 0)
    P = kernels.pointer_array
    lib = kernels.load("hashing")
    rc = lib.hash_rows(
        len(keys), P([d.data_ptr() for d, _ in keys]),
        P([None if v is None else v.data_ptr() for _, v in keys]),
        kernels.int_array([d.element_size() for d, _ in keys]),
        kernels.int_array([int(d.is_floating_point()) for d, _ in keys]),
        None if active is None else active.data_ptr(), n, _ALGO[algo], seed,
        nparts, magic, bias, None if h is None else h.data_ptr(),
        None if pid is None else pid.data_ptr(),
        None if counts is None else counts.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    kernels.check_launch(lib, "hash_rows", rc)
    return h, pid


hash_rows_kernel.launches = 0


_M64 = (1 << 64) - 1
_BIAS = {"murmur3": 1 << 31, "xxhash64": 1 << 63, "xxhash64_umod": 0}


def _divisor(n: int, algo: str) -> Tuple[int, int]:
    """The partition rule's constants for ``n`` partitions, as
    ``csrc/hashing.cu`` takes them: (M = floor((2^64 - 1) / n) + 1 mod
    2^64, as the int64 with its bits; the bias's remainder: 2^31 mod n for
    murmur3, 2^63 mod n for xxhash64, 0 for the unsigned remainder)."""
    return _s64((_M64 // n + 1) & _M64), _BIAS[algo] % n


def _fastmod(x: int, m: int, n: int) -> int:
    """x mod n as the kernel takes it (x < 2^52, n <= 2^12): the high 64
    bits of (M x mod 2^64) n."""
    return (((m * x) & _M64) * n) >> 64


def partition_rule(h: int, n: int, algo: str) -> int:
    """The kernel's partition id of one hash, on Python integers (``h``:
    the uint32 murmur3 hash or the 64 xxhash64 bits, unsigned): the signed
    hash's non-negative remainder by ``n`` (murmur3, xxhash64) or the
    unsigned one (xxhash64_umod), with no division: the dividend is
    biased to unsigned, reduced by fastmod (a 64-bit one as fastmod of
    (fastmod(hi) << 32 | lo)) and the bias's remainder taken off again.
    The tests hold it to Python's ``%``."""
    m, bias = _divisor(n, algo)
    m &= _M64
    if algo == "murmur3":
        r = _fastmod(h ^ (1 << 31), m, n)
    else:
        a = h ^ (1 << 63) if algo == "xxhash64" else h
        r = _fastmod((_fastmod(a >> 32, m, n) << 32) | (a & _M32), m, n)
    return r - bias if r >= bias else r + n - bias


def _contiguous(keys: Sequence[Value]):
    return [(d.contiguous(), None if v is None else v.contiguous())
            for d, v in keys]


def hash_columns(keys: Sequence[Value],
                 seed: int = SPARK_PARTITION_SEED) -> torch.Tensor:
    """Row-wise murmur3 over the key columns: int64 [n] holding the uint32
    hash (Spark's HashPartitioning hash)."""
    keys = _contiguous(keys)
    if keys[0][0].is_cuda:
        return hash_rows_kernel(keys, None, "murmur3", seed, 0)[0]
    return hash_rows_plain(keys, None, "murmur3", seed, 0)[0]


def xxhash64_columns(keys: Sequence[Value], seed: int = 42) -> torch.Tensor:
    """Row-wise xxhash64 over the key columns: int64 [n] holding the 64
    hash bits."""
    keys = _contiguous(keys)
    if keys[0][0].is_cuda:
        return hash_rows_kernel(keys, None, "xxhash64", seed, 0)[0]
    return hash_rows_plain(keys, None, "xxhash64", seed, 0)[0]


def spark_partition_id(keys: Sequence[Value], n_parts: int) -> torch.Tensor:
    """Spark's non-negative pmod(murmur3 hash as int32, n_parts)."""
    return partition_ids(keys, n_parts, None)


def partition_ids(keys: Sequence[Value], n_parts: int,
                  active: Optional[torch.Tensor], algo: str = "murmur3",
                  counts: Optional[torch.Tensor] = None,
                  pid_out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """int32 [n] partition id of each row (``n_parts`` for a row outside
    ``active``), by murmur3 (the exchange) or xxhash64 (sub-partitions);
    each row is added to ``counts[pid]`` (int64 [n_parts + 1]) when given.
    ``pid_out`` (int32 [n]) receives the ids when given."""
    if algo not in ("murmur3", "xxhash64"):
        raise ValueError(f"hash {algo!r} is not one of {list(_ALGO)}")
    keys = _contiguous(keys)
    if keys[0][0].is_cuda:
        return hash_rows_kernel(keys, active, algo, SPARK_PARTITION_SEED,
                                n_parts, counts, want_hash=False,
                                pid_out=pid_out)[1]
    pid = hash_rows_plain(keys, active, algo, SPARK_PARTITION_SEED, n_parts,
                          counts)[1]
    if pid_out is not None:
        pid_out.copy_(pid)
        return pid_out
    return pid


def _umod(h: torch.Tensor, n: int) -> torch.Tensor:
    """Remainder of int64-held unsigned 64-bit words by ``n`` (< 2^31):
    2^64 = 2^32 * 2^32, so hi * (2^32 mod n) + lo folds in int64."""
    hi = _lsr(h, 32) % n
    lo = h & _M32
    return (hi * ((1 << 32) % n) + lo % n) % n


def xxhash64_mod_plain(keys: Sequence[Value], n: int,
                       active: Optional[torch.Tensor] = None,
                       counts: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Plain version of ``xxhash64_mod_kernel``."""
    h, _ = hash_rows_plain(keys, None, "xxhash64", SPARK_PARTITION_SEED, 0)
    pid = _umod(h, n).to(torch.int32)
    if active is not None:
        pid = torch.where(active, pid, n)
    if counts is not None:
        counts += torch.bincount(pid.to(torch.int64), minlength=n + 1)
    return pid


def xxhash64_mod_kernel(keys: Sequence[Value], n: int,
                        active: Optional[torch.Tensor] = None,
                        counts: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Launch ``hash_rows`` of ``csrc/hashing.cu`` with the unsigned
    remainder (algo 2): int32 [rows] bucket ids, ``n`` for an inactive
    row; ``counts`` (int64 [n + 1]) is added to."""
    keys = _contiguous(keys)
    pid = _hash_rows(keys, active, "xxhash64_umod", SPARK_PARTITION_SEED, n,
                     counts, False, None)[1]
    xxhash64_mod_kernel.launches += 1
    return pid


xxhash64_mod_kernel.launches = 0


def xxhash64_mod(keys: Sequence[Value], n: int,
                 active: Optional[torch.Tensor] = None,
                 counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Bucket id per row: ``xxhash64(keys, 42) % n`` of the unsigned hash
    as int32 (``n`` for a row outside ``active``), the reference's
    ``_split_by_key_hash`` ids; each row is added to ``counts[id]``
    (int64 [n + 1]) when given."""
    keys = _contiguous(keys)
    if keys[0][0].is_cuda:
        return xxhash64_mod_kernel(keys, n, active, counts)
    return xxhash64_mod_plain(keys, n, active, counts)
