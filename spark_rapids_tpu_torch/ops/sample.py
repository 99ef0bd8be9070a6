"""The Bernoulli keep mask of ``SampleExec`` (row 14 of the kernel list).

The reference keeps row i of the idx-th child batch where
``jax.random.uniform(fold_in(PRNGKey(seed), idx), (capacity,))[i] <
fraction`` (``spark_rapids_tpu/plan/exec_nodes.py:310``), in float64.  To
keep the same rows the port computes JAX's draw bit for bit: threefry2x32
with 20 rounds (``jax/_src/prng.py:863``), its partitionable counter (row
i's counter is ``(hi32(i), lo32(i))``, ``prng.py:989``, so a row's draw
does not depend on the batch's capacity), its 64-bit output ``out0 << 32
| out1`` (``prng.py:1184``) and its bits-to-float step, ``(bits >> 12 |
0x3FF0000000000000)`` as a double minus 1 (``jax/_src/random.py:435``).

* :func:`batch_key` is ``fold_in(PRNGKey(seed), idx)`` on the host:
  ``PRNGKey`` bit-casts the int64 seed to (hi, lo) words and ``fold_in``
  is ``threefry2x32(key, (0, idx))``, by the plain version on one counter.
* :func:`sample_mask` dispatches: ``csrc/sample.cu`` for CUDA tensors
  (:func:`sample_mask_kernel`, which counts its launches), the plain
  PyTorch version (:func:`sample_mask_plain`, int64 arithmetic masked to
  32 bits) for CPU tensors.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import kernels

__all__ = ["M32", "prng_key", "fold_in", "batch_key",
           "threefry2x32_plain", "threefry2x32_kernel", "uniform_plain",
           "sample_mask", "sample_mask_plain", "sample_mask_kernel",
           "OPS_PER_ROW"]

M32 = 0xFFFFFFFF
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# 32-bit integer operations per drawn row (csrc/sample.cu's count)
OPS_PER_ROW = 83

Key = Tuple[int, int]


def prng_key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)``: the int64 seed as (hi, lo) words."""
    u = int(seed) & ((1 << 64) - 1)
    return (u >> 32) & M32, u & M32


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)`` for a uint32 ``data``."""
    x0, x1 = threefry2x32_plain(key, torch.zeros(1, dtype=torch.int64),
                                torch.full((1,), int(data) & M32))
    return int(x0[0]), int(x1[0])


def batch_key(seed: int, batch_index: int) -> Key:
    """The key of the ``batch_index``-th batch's draws."""
    return fold_in(prng_key(seed), batch_index)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32_plain(key: Key, x0: torch.Tensor, x1: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """threefry2x32 of int64 tensors of 32-bit words (values in [0,
    2^32)), in int64 arithmetic masked to 32 bits."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + (ks[(i + 2) % 3] + i + 1)) & M32
    return x0, x1


def threefry2x32_kernel(key: Key, x0: torch.Tensor, x1: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """threefry2x32 through ``csrc/sample.cu`` on CUDA int32 tensors (the
    words' bits); returns int32 tensors of the output words' bits."""
    n = x0.shape[0]
    for t in (x0, x1):
        if t.dtype != torch.int32 or not t.is_cuda or t.shape != (n,) \
                or not t.is_contiguous():
            raise ValueError("threefry takes contiguous CUDA int32 [n] words")
    out0, out1 = torch.empty_like(x0), torch.empty_like(x1)
    lib = kernels.load("sample")
    rc = lib.threefry(key[0], key[1], x0.data_ptr(), x1.data_ptr(), n,
                      out0.data_ptr(), out1.data_ptr(),
                      torch.cuda.current_stream(x0.device).cuda_stream)
    kernels.check_launch(lib, "threefry", rc)
    return out0, out1


def uniform_plain(key: Key, n: int, device) -> torch.Tensor:
    """``jax.random.uniform(key, (n,))`` in float64, bit for bit."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    out0, out1 = threefry2x32_plain(key, i >> 32, i & M32)
    # (bits >> 12) of bits = out0 << 32 | out1: the 52 mantissa bits
    mant = (out0 << 20) | (out1 >> 12)
    return (mant | 0x3FF0000000000000).view(torch.float64) - 1.0


def sample_mask(key: Key, fraction: float, sel: Optional[torch.Tensor],
                num_rows: int, capacity: int, device) -> torch.Tensor:
    """Bool [capacity]: rows i < ``num_rows`` that ``sel`` (bool
    [num_rows] or None) keeps and whose draw under ``key`` is below
    ``fraction``."""
    device = torch.device(device)
    run = sample_mask_kernel if device.type == "cuda" \
        else sample_mask_plain
    return run(key, fraction, sel, num_rows, capacity, device)


def sample_mask_plain(key: Key, fraction: float, sel, num_rows: int,
                      capacity: int, device) -> torch.Tensor:
    """Plain PyTorch version of ``csrc/sample.cu``."""
    keep = uniform_plain(key, capacity, device) < fraction
    keep[num_rows:] = False
    if sel is not None:
        keep[:num_rows] &= sel
    return keep


def sample_mask_kernel(key: Key, fraction: float, sel, num_rows: int,
                       capacity: int, device) -> torch.Tensor:
    """Launch ``sample_mask`` of ``csrc/sample.cu``."""
    if sel is not None and (sel.dtype != torch.bool or not sel.is_cuda
                            or sel.shape != (num_rows,)
                            or not sel.is_contiguous()):
        raise ValueError("sel must be a contiguous CUDA bool [num_rows] "
                         "tensor")
    if not 0 <= num_rows <= capacity:
        raise ValueError(f"need 0 <= num_rows <= capacity, got {num_rows} "
                         f"and {capacity}")
    out = torch.empty(capacity, dtype=torch.bool, device=device)
    if capacity == 0:
        return out  # nothing to draw: no launch
    lib = kernels.load("sample")
    rc = lib.sample_mask(key[0], key[1], float(fraction),
                         None if sel is None else sel.data_ptr(), num_rows,
                         capacity, out.data_ptr(),
                         torch.cuda.current_stream(device).cuda_stream)
    kernels.check_launch(lib, "sample_mask", rc)
    sample_mask_kernel.launches += 1
    return out


sample_mask_kernel.launches = 0
