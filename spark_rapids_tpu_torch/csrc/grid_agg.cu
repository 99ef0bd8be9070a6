// grid_agg: grouped sums over a dense grid of dictionary-code slots, added
// into a device accumulator that lives for the whole query.
//
// Replaces: spark_rapids_tpu/ops/groupby.py:424 grid_group_reduce, run per
// batch by plan/physical.py:1768 _grid_program and merged by _merge_partials
// (:2211).
//
// Each row's slot is the mixed-radix number of its k key codes,
// gid = ((c0 * (d1+1)) + c1) * (d2+1) + ..., where a NULL key takes the
// extra slot d_i of its dimension; G = prod(d_i + 1).  The slot id is
// computed here and never written out.  Per slot the kernel adds nf float64
// columns, ni int64 columns (an int64 channel with no data counts the rows
// where its validity mask holds) and a presence count of live rows.
//
// Bound: device memory.  Each input byte is read once: n x (1 B active mask
// + 4 B per key code + 1 B per key or column validity mask + 8 B per data
// column), over 3.35 TB/s on an H100 SXM.  At TPC-H Q1 that is
// 2 x 4 + 1 + 7 x 8 = 65 B a row.
//
// Design.  TPC-H Q1 has 6 live slots out of 15, so atomics straight into
// device memory would serialize on a handful of addresses.
//   ga_shared: when the grid, G x (2 nf + ni + 1) x 8 B, fits in the 48 KB
//     of shared memory a block may take without opting in, each block
//     privatizes the whole grid there, accumulates with shared-memory
//     atomics over a grid-stride loop, and flushes its nonzero words once
//     with device atomics.
//   ga_global: otherwise every live row adds straight into device memory;
//     a grid that large spreads rows over many slots.
// The caller picks the variant (use_shared), so both stay testable.  The
// argument struct is __grid_constant__, so the helpers read it in place
// instead of copying 2 KB to each thread's stack.
// float64 sums are exact 128-bit fixed point per call (fixed128.cuh), so
// they are equal to the bit from run to run: ga_absmax takes each slot's
// largest finite |x| per column, the update adds the scaled integers (two
// words per slot and column, privatized in shared memory like the rest),
// and ga_fold converts each slot's integer into the float64 accumulator.
// int64 sums wrap modulo 2^64 like the reference's.
// Key codes must lie in [0, d_i): the caller's dictionary guarantees it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fixed128.cuh"

#define GA_MAX_KEYS 8
#define GA_MAX_COLS 32
#define GA_THREADS 256

struct GAArgs {
  const int* codes[GA_MAX_KEYS];
  const uint8_t* code_valid[GA_MAX_KEYS];  // nullptr: no NULL keys
  int dims[GA_MAX_KEYS];
  int nkeys;
  const double* f[GA_MAX_COLS];
  const uint8_t* f_valid[GA_MAX_COLS];
  int nf;
  const long long* i[GA_MAX_COLS];  // nullptr: a count channel
  const uint8_t* i_valid[GA_MAX_COLS];
  int ni;
  unsigned long long* fx;  // [G][nf][3] fixed-point words, zero between calls
  double* acc_f;           // [G][nf]
  long long rows;          // the call's row count (fixed-point headroom)
};

__device__ __forceinline__ int grid_id(const GAArgs& a, long long r) {
  int gid = 0;
#pragma unroll
  for (int k = 0; k < GA_MAX_KEYS; ++k) {
    if (k < a.nkeys) {
      const int d = a.dims[k];
      const int slot = (a.code_valid[k] != nullptr && !a.code_valid[k][r])
                           ? d : a.codes[k][r];
      gid = gid * (d + 1) + slot;
    }
  }
  return gid;
}

// Adds row r into one slot: the float64 columns' 128-bit words
// (fslot[2 j], fslot[2 j + 1]), the int64 words [0, ni), then the presence
// count.  An infinite or NaN x goes to the float64 accumulator itself.
__device__ __forceinline__ void add_row(const GAArgs& a, long long r, int g,
                                        unsigned long long* fslot,
                                        unsigned long long* islot,
                                        unsigned long long* cnt) {
#pragma unroll
  for (int j = 0; j < GA_MAX_COLS; ++j) {
    if (j < a.nf && (a.f_valid[j] == nullptr || a.f_valid[j][r])) {
      const double x = a.f[j][r];
      const long long c = (long long)g * a.nf + j;
      if (isfinite(x))
        fx_add(fslot + 2 * j, x, fx_scale(a.fx[3 * c + 2], a.rows));
      else
        atomicAdd(a.acc_f + c, x);
    }
  }
#pragma unroll
  for (int j = 0; j < GA_MAX_COLS; ++j) {
    if (j < a.ni && (a.i_valid[j] == nullptr || a.i_valid[j][r])) {
      const unsigned long long v =
          a.i[j] == nullptr ? 1ULL : (unsigned long long)a.i[j][r];
      atomicAdd(islot + j, v);
    }
  }
  atomicAdd(cnt, 1ULL);
}

// Each slot's largest finite |x| per float64 column, for this call.
__global__ void __launch_bounds__(GA_THREADS)
ga_absmax(const __grid_constant__ GAArgs a,
          const uint8_t* __restrict__ active, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += stride) {
    if (!active[r]) continue;
    const long long g = grid_id(a, r);
    for (int j = 0; j < a.nf; ++j)
      if (a.f_valid[j] == nullptr || a.f_valid[j][r])
        fx_absmax(a.fx + 3 * (g * a.nf + j) + 2, a.f[j][r]);
  }
}

__global__ void __launch_bounds__(GA_THREADS)
ga_shared(const __grid_constant__ GAArgs a,
          const uint8_t* __restrict__ active, long long n, int G,
          unsigned long long* __restrict__ acc_i,
          unsigned long long* __restrict__ acc_cnt) {
  extern __shared__ unsigned long long grid[];  // [G][2 nf + ni + 1] words
  const int W = 2 * a.nf + a.ni + 1;
  for (int t = threadIdx.x; t < G * W; t += blockDim.x) grid[t] = 0ULL;
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += stride) {
    if (!active[r]) continue;
    const int g = grid_id(a, r);
    unsigned long long* slot = grid + (long long)g * W;
    add_row(a, r, g, slot, slot + 2 * a.nf, slot + 2 * a.nf + a.ni);
  }
  __syncthreads();
  for (int t = threadIdx.x; t < G * W; t += blockDim.x) {
    const int g = t / W, c = t % W;
    if (c < 2 * a.nf) {
      if (c % 2 == 0)  // the pair (lo, hi) of column c / 2
        fx_add_words(a.fx + 3 * ((long long)g * a.nf + c / 2), grid[t],
                     grid[t + 1]);
      continue;
    }
    const unsigned long long v = grid[t];
    if (v == 0ULL) continue;
    if (c < 2 * a.nf + a.ni) {
      atomicAdd(acc_i + (long long)g * a.ni + (c - 2 * a.nf), v);
    } else {
      atomicAdd(acc_cnt + g, v);
    }
  }
}

__global__ void __launch_bounds__(GA_THREADS)
ga_global(const __grid_constant__ GAArgs a,
          const uint8_t* __restrict__ active, long long n,
          unsigned long long* __restrict__ acc_i,
          unsigned long long* __restrict__ acc_cnt) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += stride) {
    if (!active[r]) continue;
    const long long g = grid_id(a, r);
    // the global words of a slot's columns are 3 apart: (lo, hi) of column
    // j at fx[3 (g nf + j)], reached through a stride-3 view below
    unsigned long long* fslot = a.fx + 3 * g * a.nf;
#pragma unroll
    for (int j = 0; j < GA_MAX_COLS; ++j) {
      if (j < a.nf && (a.f_valid[j] == nullptr || a.f_valid[j][r])) {
        const double x = a.f[j][r];
        unsigned long long* w = fslot + 3 * j;
        if (isfinite(x))
          fx_add(w, x, fx_scale(w[2], a.rows));
        else
          atomicAdd(a.acc_f + g * a.nf + j, x);
      }
    }
    unsigned long long* islot = acc_i + g * a.ni;
#pragma unroll
    for (int j = 0; j < GA_MAX_COLS; ++j) {
      if (j < a.ni && (a.i_valid[j] == nullptr || a.i_valid[j][r]))
        atomicAdd(islot + j,
                  a.i[j] == nullptr ? 1ULL : (unsigned long long)a.i[j][r]);
    }
    atomicAdd(acc_cnt + g, 1ULL);
  }
}

// Each slot's fixed-point sums of this call into the float64 accumulator;
// the words cleared for the next call.
__global__ void __launch_bounds__(GA_THREADS)
ga_fold(const __grid_constant__ GAArgs a, long long cells) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       c < cells; c += stride) {
    unsigned long long* w = a.fx + 3 * c;
    if (w[2] == 0ULL) continue;
    a.acc_f[c] += fx_value(w, a.rows);
    w[0] = w[1] = w[2] = 0ULL;
  }
}

// Host entry, bound with ctypes.  The per-key and per-column pointer arrays
// and `dims` are host arrays; everything else points to device memory.
// acc_f is [G, nf] float64, acc_i [G, ni] int64, acc_cnt [G] int64, fx
// [G, nf, 3] uint64 words (zero between calls).  Returns
// cudaGetLastError() after the launches (0 = launched).
extern "C" int grid_agg(const void* const* codes,
                        const void* const* code_valid, const int* dims,
                        int nkeys, const void* active, long long n,
                        const void* const* f, const void* const* f_valid,
                        int nf, const void* const* i,
                        const void* const* i_valid, int ni, void* acc_f,
                        void* acc_i, void* acc_cnt, void* fx, int G,
                        int use_shared, void* stream) {
  if (nkeys < 1 || nkeys > GA_MAX_KEYS || nf < 0 || nf > GA_MAX_COLS ||
      ni < 0 || ni > GA_MAX_COLS || G < 1)
    return (int)cudaErrorInvalidValue;
  GAArgs a = {};
  for (int k = 0; k < nkeys; ++k) {
    a.codes[k] = static_cast<const int*>(codes[k]);
    a.code_valid[k] = static_cast<const uint8_t*>(code_valid[k]);
    a.dims[k] = dims[k];
  }
  a.nkeys = nkeys;
  for (int j = 0; j < nf; ++j) {
    a.f[j] = static_cast<const double*>(f[j]);
    a.f_valid[j] = static_cast<const uint8_t*>(f_valid[j]);
  }
  a.nf = nf;
  for (int j = 0; j < ni; ++j) {
    a.i[j] = static_cast<const long long*>(i[j]);
    a.i_valid[j] = static_cast<const uint8_t*>(i_valid[j]);
  }
  a.ni = ni;
  a.fx = static_cast<unsigned long long*>(fx);
  a.acc_f = static_cast<double*>(acc_f);
  a.rows = n;
  if (nf > 0 && fx == nullptr) return (int)cudaErrorInvalidValue;

  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  long long want = (n + GA_THREADS - 1) / GA_THREADS;
  const long long cap = (long long)sms * (use_shared ? 4 : 8);
  const int blocks = (int)(want < 1 ? 1 : (want < cap ? want : cap));

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned long long* ai = static_cast<unsigned long long*>(acc_i);
  unsigned long long* ac = static_cast<unsigned long long*>(acc_cnt);
  const uint8_t* act = static_cast<const uint8_t*>(active);
  if (nf > 0) ga_absmax<<<blocks, GA_THREADS, 0, s>>>(a, act, n);
  if (use_shared) {
    const size_t smem =
        (size_t)G * (2 * nf + ni + 1) * sizeof(unsigned long long);
    ga_shared<<<blocks, GA_THREADS, smem, s>>>(a, act, n, G, ai, ac);
  } else {
    ga_global<<<blocks, GA_THREADS, 0, s>>>(a, act, n, ai, ac);
  }
  if (nf > 0) {
    const long long cells = (long long)G * nf;
    const long long want_f = (cells + GA_THREADS - 1) / GA_THREADS;
    const int fold_blocks = (int)(want_f < cap ? want_f : cap);
    ga_fold<<<fold_blocks, GA_THREADS, 0, s>>>(a, cells);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
