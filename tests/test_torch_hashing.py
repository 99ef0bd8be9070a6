"""Spark-exact hashing: the port's plain versions of csrc/hashing.cu
(murmur3, xxhash64, partition ids) against the JAX package's
``ops/hashing.py`` on the same seeded numpy columns, bit for bit, for every
supported type with nulls, -0.0, NaN, ±inf, subnormals and int64
extremes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spark_rapids_tpu  # noqa: F401  (enables x64 before any jnp array)
from spark_rapids_tpu.ops import hashing as J
from spark_rapids_tpu_torch.ops import hashing as H

N = 1000


def _column(kind: str, seed: int = 5) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "bool":
        return rng.random(N) < 0.5
    if kind in ("int8", "int16", "int32"):
        info = np.iinfo(kind)
        x = rng.integers(info.min, info.max, N, endpoint=True).astype(kind)
        x[:3] = [info.min, info.max, 0]
        return x
    if kind == "int64":
        x = rng.integers(-2**63, 2**63 - 1, N, dtype=np.int64)
        x[:4] = [np.iinfo(np.int64).min, np.iinfo(np.int64).max, 0, -1]
        return x
    if kind == "date":
        return rng.integers(-1000, 20000, N).astype(np.int32)
    dt = np.dtype(kind)
    tiny = np.finfo(dt).tiny
    edges = np.array([0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf, tiny,
                      -tiny, tiny / 2, -tiny / 4, np.finfo(dt).max,
                      np.finfo(dt).min], dtype=dt)
    x = rng.normal(scale=1e3, size=N).astype(dt)
    x[:len(edges)] = edges
    return x


KINDS = ["bool", "int8", "int16", "int32", "int64", "date", "float32",
         "float64"]


def _pair(kind, nulls: bool, seed: int = 5):
    a = _column(kind, seed)
    valid = np.random.default_rng(seed + 1).random(N) < 0.85 if nulls \
        else None
    jk = (jnp.asarray(a), None if valid is None else jnp.asarray(valid))
    tk = (torch.from_numpy(a.copy()),
          None if valid is None else torch.from_numpy(valid.copy()))
    return jk, tk


@pytest.mark.parametrize("nulls", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_hashes_are_bit_exact_with_reference(kind, nulls):
    """murmur3 (uint32) and xxhash64 (64 bits) of one column; a null leaves
    the seed unchanged.  Subnormals hash as +0.0 in both packages."""
    jk, tk = _pair(kind, nulls)
    want = np.asarray(J.hash_columns([jk])).astype(np.int64)
    np.testing.assert_array_equal(H.hash_columns([tk]).numpy(), want)
    want = np.asarray(J.xxhash64_columns([jk])).view(np.int64)
    np.testing.assert_array_equal(H.xxhash64_columns([tk]).numpy(), want)


def test_multi_column_hash_folds_left_to_right():
    cols = [_pair(k, True, seed) for seed, k in enumerate(
        ("int64", "float64", "int32", "bool", "float32"), start=11)]
    jk, tk = [j for j, _ in cols], [t for _, t in cols]
    np.testing.assert_array_equal(
        H.hash_columns(tk).numpy(),
        np.asarray(J.hash_columns(jk)).astype(np.int64))
    np.testing.assert_array_equal(
        H.xxhash64_columns(tk).numpy(),
        np.asarray(J.xxhash64_columns(jk)).view(np.int64))


@pytest.mark.parametrize("n_parts", [1, 7, 8, 200])
@pytest.mark.parametrize("kind", ["int64", "float64", "date"])
def test_spark_partition_id_matches_reference(kind, n_parts):
    jk, tk = _pair(kind, True)
    want = np.asarray(J.spark_partition_id([jk], n_parts))
    got = H.spark_partition_id([tk], n_parts).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0 and got.max() < n_parts


@pytest.mark.parametrize("algo", ["murmur3", "xxhash64"])
def test_partition_ids_count_rows_and_park_dead_rows(algo):
    """Dead rows get id n_parts; the counts add up across calls; xxhash64
    ids are the non-negative remainder of the hash as int64."""
    _, tk = _pair("int64", True)
    active = torch.from_numpy(np.random.default_rng(3).random(N) < 0.7)
    counts = torch.zeros(9, dtype=torch.int64)
    pid = H.partition_ids([tk], 8, active, algo, counts=counts)
    H.partition_ids([tk], 8, active, algo, counts=counts)
    assert (pid[~active] == 8).all() and (pid[active] < 8).all()
    assert counts.tolist() == (2 * torch.bincount(
        pid.to(torch.int64), minlength=9)).tolist()
    if algo == "xxhash64":
        h = H.xxhash64_columns([tk])
        assert pid[active].tolist() == torch.remainder(h, 8)[active].tolist()
    out = torch.full((N,), -5, dtype=torch.int32)
    H.partition_ids([tk], 8, active, algo, pid_out=out)
    assert out.tolist() == pid.tolist()


def test_hash_kernel_wrapper_refuses_cpu_tensors():
    keys = [(torch.zeros(4, dtype=torch.int64), None)]
    with pytest.raises(ValueError, match="CUDA"):
        H.hash_rows_kernel(keys, None, "murmur3", 42, 8,
                           counts=torch.zeros(9, dtype=torch.int64))
    with pytest.raises(TypeError, match="no device hash"):
        H.hash_columns([(torch.zeros(4, dtype=torch.uint8), None)])
    assert H.hash_rows_kernel.launches == 0


def _rule_dividends(n: int, bits: int):
    """Edge dividends of a ``bits``-bit hash for ``n`` partitions: 0, 1,
    n - 1, n, 2^31 - 1, 2^31, 2^32 - 1, 2^63 - 1, 2^63, 2^64 - 1 (their
    low ``bits``), and k n - 1, k n, k n + 1 for the largest k n below
    2^bits and below 2^(bits - 1)."""
    top = 1 << bits
    out = {0, 1, n - 1, n, 2**31 - 1, 2**31, 2**32 - 1, 2**63 - 1, 2**63,
           2**64 - 1}
    for edge in (top, top >> 1):
        k = (edge - 1) // n
        out |= {k * n - 1, k * n, k * n + 1}
    return sorted(x % top for x in out if x >= 0)


@pytest.mark.parametrize("algo", ["murmur3", "xxhash64", "xxhash64_umod"])
def test_partition_rule_matches_python_remainder(algo):
    """The kernel's division-free partition rule (``partition_rule``, with
    the constants ``_divisor`` passes to csrc/hashing.cu) equals Python's
    ``%`` for every n in 1..HS_MAX_PARTS at edge dividends: the int32
    pmod of the murmur3 hash, the int64 pmod of xxhash64 and the unsigned
    64-bit remainder of ``xxhash64_mod``."""
    bits = 32 if algo == "murmur3" else 64
    for n in range(1, H.HS_MAX_PARTS + 1):
        for h in _rule_dividends(n, bits):
            signed = h - (1 << bits) if h >> (bits - 1) else h
            want = (h if algo == "xxhash64_umod" else signed) % n
            assert H.partition_rule(h, n, algo) == want, (algo, n, h)
