// csr_join: the broadcast join over a build side that repeats keys —
// counts and starts over the key domain, a stable build permutation, the
// probe, the expansion into gather maps, and the gathers.
//
// Replaces: spark_rapids_tpu/plan/join_exec.py:1040 _csr_match_state (the
// counts/starts tables over key - kmin and the stable lexsort of build rows
// by slot, :1085; the probe's (lo, matches)), :690 _semi_anti, :697
// _outer_join with :1649 _expand_rows (the gather maps pi, bi with -1 for a
// left join's unmatched rows), and :1904 _gather_cols.
//
// Entry points, in the order a join calls them:
//   csr_slots      per build row its slot key - kmin, or D when the row is
//                  dead, null or outside the domain; counts[slot] += 1
//                  (atomics: a count does not depend on order);
//   csr_scan       exclusive scan of int32 counts into int64 offsets, with
//                  the total in out[n] (radix.cuh scan_i32);
//   csr_sort_pass  one 8-bit pass of a stable LSD radix sort of row numbers
//                  by slot (radix.cuh radix_pass).  bit_length(D) / 8
//                  passes give b_perm: the live rows grouped by slot, each
//                  slot's rows in build order, as the reference's lexsort
//                  on (slot, row) does — without atomics, so the order is
//                  fixed.  With a partition id as the slot, one pass places
//                  a shuffle exchange's rows by partition;
//   csr_probe      per probe row its slot's (lo, matches), 0 matches when
//                  the row is dead, null or outside the domain; semi and
//                  anti write the selection (anti keeps null-key rows, as
//                  _semi_anti does); inner and left write the row's output
//                  count (a left join's miss counts 1) and lo (-1: no
//                  match);
//   csr_expand     per probe row, its output rows [offsets[i],
//                  offsets[i+1]): pi = i, bi = b_perm[lo + k] or -1;
//   csr_gather     per output row and column, data and validity gathered
//                  at idx (idx < 0: a null row).
//
// Bound: device memory.  The build is a few passes over 4-8 B per build
// row (the sort moves slot and row number, 8 B, per pass); the probe reads
// each probe row's key and two table words at a random slot (two 32-byte
// sectors); the expansion writes 16 B per output row and reads one 4 B
// b_perm word per match (runs of a key's rows are contiguous); the gathers
// read one sector per output row and column.  Simple first: one thread
// per probe row writes that row's whole output range, so a key repeated
// millions of times serializes on one thread.
//
// Keys are int32 or int64 (dates are int32 days).  Row numbers are int32
// (the build side has fewer than 2^31 rows); offsets are int64.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "radix.cuh"

#define CJ_THREADS 256
#define CJ_MAX_COLS 16

#define CJ_INNER 0
#define CJ_SEMI 1
#define CJ_ANTI 2
#define CJ_LEFT 3

__device__ __forceinline__ long long load_key(const void* p, int elem,
                                              long long r) {
  return elem == 8 ? static_cast<const long long*>(p)[r]
                   : (long long)static_cast<const int*>(p)[r];
}

// True when key k lies in [kmin, kmin + D); idx receives k - kmin.
__device__ __forceinline__ bool in_domain(long long k, long long kmin,
                                          long long D, long long* idx) {
  if (k < kmin) return false;
  const unsigned long long d =
      (unsigned long long)k - (unsigned long long)kmin;
  if (d >= (unsigned long long)D) return false;
  *idx = (long long)d;
  return true;
}

// ---------------------------------------------------------------------------
// Build: slots and counts
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(CJ_THREADS)
cj_slots(const void* __restrict__ keys, int elem,
         const uint8_t* __restrict__ key_valid,
         const uint8_t* __restrict__ active, long long n, long long kmin,
         long long D, int* __restrict__ slots, int* __restrict__ counts) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += stride) {
    long long idx = D;
    if ((active == nullptr || active[r]) &&
        (key_valid == nullptr || key_valid[r]) &&
        in_domain(load_key(keys, elem, r), kmin, D, &idx))
      atomicAdd(counts + idx, 1);
    slots[r] = (int)idx;
  }
}

// ---------------------------------------------------------------------------
// Probe, expansion, gathers
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(CJ_THREADS)
cj_probe(const void* __restrict__ keys, int elem,
         const uint8_t* __restrict__ key_valid,
         const uint8_t* __restrict__ active, long long n, long long kmin,
         long long D, const int* __restrict__ counts,
         const long long* __restrict__ starts, int mode,
         int* __restrict__ lo, int* __restrict__ cnt,
         uint8_t* __restrict__ sel) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += stride) {
    const bool row_live = active == nullptr || active[r];
    long long idx = 0;
    int matches = 0;
    if (row_live && (key_valid == nullptr || key_valid[r]) &&
        in_domain(load_key(keys, elem, r), kmin, D, &idx))
      matches = counts[idx];
    if (mode == CJ_SEMI) {
      sel[r] = matches > 0;
    } else if (mode == CJ_ANTI) {
      sel[r] = row_live && matches == 0;
    } else {
      lo[r] = matches > 0 ? (int)starts[idx] : -1;
      cnt[r] = mode == CJ_LEFT ? (row_live ? (matches > 0 ? matches : 1) : 0)
                               : matches;
    }
  }
}

__global__ void __launch_bounds__(CJ_THREADS)
cj_expand(const long long* __restrict__ offsets, const int* __restrict__ lo,
          const int* __restrict__ b_perm, long long n,
          long long* __restrict__ pi, int* __restrict__ bi) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += stride) {
    const long long o = offsets[r], end = offsets[r + 1];
    const int l = lo[r];
    for (long long j = o; j < end; ++j) {
      pi[j] = r;
      bi[j] = l < 0 ? -1 : b_perm[l + (j - o)];
    }
  }
}

struct CJCols {
  const void* data[CJ_MAX_COLS];
  const uint8_t* valid[CJ_MAX_COLS];  // nullptr: the column has no nulls
  void* out[CJ_MAX_COLS];
  uint8_t* out_valid[CJ_MAX_COLS];    // nullptr: no output validity
  int elem[CJ_MAX_COLS];
  int ncols;
};

__device__ __forceinline__ void gather_elem(void* dst, const void* src,
                                            int elem, long long to,
                                            long long from, bool ok) {
  switch (elem) {
    case 8:
      static_cast<long long*>(dst)[to] =
          ok ? static_cast<const long long*>(src)[from] : 0LL;
      break;
    case 4:
      static_cast<int*>(dst)[to] =
          ok ? static_cast<const int*>(src)[from] : 0;
      break;
    case 2:
      static_cast<short*>(dst)[to] =
          ok ? static_cast<const short*>(src)[from] : (short)0;
      break;
    default:
      static_cast<uint8_t*>(dst)[to] =
          ok ? static_cast<const uint8_t*>(src)[from] : (uint8_t)0;
  }
}

// idx is int64 (idx_elem 8: pi) or int32 (idx_elem 4: bi).
__global__ void __launch_bounds__(CJ_THREADS)
cj_gather(const __grid_constant__ CJCols c, const void* __restrict__ idx,
          int idx_elem, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += stride) {
    const long long i = load_key(idx, idx_elem, r);
    const bool ok = i >= 0;
#pragma unroll 4
    for (int j = 0; j < c.ncols; ++j) {
      gather_elem(c.out[j], c.data[j], c.elem[j], r, i, ok);
      if (c.out_valid[j] != nullptr)
        c.out_valid[j][r] = ok && (c.valid[j] == nullptr || c.valid[j][i]);
    }
  }
}

static cudaError_t grid_for(long long n, int* blocks, int per_sm) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long want = (n + CJ_THREADS - 1) / CJ_THREADS;
  const long long cap = (long long)sms * per_sm;
  *blocks = (int)(want < 1 ? 1 : (want < cap ? want : cap));
  return cudaSuccess;
}

// Host entries, bound with ctypes; every pointer but the column pointer
// arrays points to device memory.  Each returns cudaGetLastError() after
// its launches (0 = launched).

// slots: [n] int32; counts: [D] int32, zeroed by the caller.
extern "C" int csr_slots(const void* keys, int elem, const void* key_valid,
                         const void* active, long long n, long long kmin,
                         long long D, void* slots, void* counts,
                         void* stream) {
  if ((elem != 4 && elem != 8) || D < 1 || D >= INT_MAX || n >= INT_MAX)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  int blocks = 1;
  cudaError_t err = grid_for(n, &blocks, 8);
  if (err != cudaSuccess) return (int)err;
  cj_slots<<<blocks, CJ_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      keys, elem, static_cast<const uint8_t*>(key_valid),
      static_cast<const uint8_t*>(active), n, kmin, D,
      static_cast<int*>(slots), static_cast<int*>(counts));
  return (int)cudaGetLastError();
}

// out: [n + 1] int64; sums: ceil(n / SCAN_TILE) int64 words of scratch.
extern "C" int csr_scan(const void* in, long long n, void* out, void* sums,
                        void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  return (int)scan_i32(static_cast<const int*>(in),
                       static_cast<long long*>(out), n,
                       static_cast<long long*>(sums),
                       static_cast<cudaStream_t>(stream));
}

// One pass over bits [shift, shift + 8) (tiles = ceil(n / RS_TILE)).
// hist: 256 * tiles int32; offs: 256 * tiles + 1 int64; sums:
// ceil(256 * tiles / SCAN_TILE) int64.
extern "C" int csr_sort_pass(const void* keys_in, const void* vals_in,
                             void* keys_out, void* vals_out, long long n,
                             int shift, void* hist, void* offs, void* sums,
                             void* stream) {
  if (n < 0 || n >= INT_MAX || shift < 0 || shift > 24)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  return (int)radix_pass<int>(
      static_cast<const int*>(keys_in), static_cast<const int*>(vals_in),
      static_cast<int*>(keys_out), static_cast<int*>(vals_out), n, shift,
      static_cast<int*>(hist), static_cast<long long*>(offs),
      static_cast<long long*>(sums), static_cast<cudaStream_t>(stream));
}

// mode 1/2 (semi, anti): sel [n]; mode 0/3 (inner, left): lo, cnt [n].
extern "C" int csr_probe(const void* keys, int elem, const void* key_valid,
                         const void* active, long long n, long long kmin,
                         long long D, const void* counts, const void* starts,
                         int mode, void* lo, void* cnt, void* sel,
                         void* stream) {
  if ((elem != 4 && elem != 8) || D < 1 || mode < CJ_INNER
      || mode > CJ_LEFT)
    return (int)cudaErrorInvalidValue;
  if ((mode == CJ_SEMI || mode == CJ_ANTI) ? sel == nullptr
                                           : (lo == nullptr || cnt == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  int blocks = 1;
  cudaError_t err = grid_for(n, &blocks, 16);
  if (err != cudaSuccess) return (int)err;
  cj_probe<<<blocks, CJ_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      keys, elem, static_cast<const uint8_t*>(key_valid),
      static_cast<const uint8_t*>(active), n, kmin, D,
      static_cast<const int*>(counts), static_cast<const long long*>(starts),
      mode, static_cast<int*>(lo), static_cast<int*>(cnt),
      static_cast<uint8_t*>(sel));
  return (int)cudaGetLastError();
}

// offsets: [n + 1] int64 (csr_scan of the probe's counts); pi: int64,
// bi: int32, both [offsets[n]].
extern "C" int csr_expand(const void* offsets, const void* lo,
                          const void* b_perm, long long n, void* pi, void* bi,
                          void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  int blocks = 1;
  cudaError_t err = grid_for(n, &blocks, 16);
  if (err != cudaSuccess) return (int)err;
  cj_expand<<<blocks, CJ_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(offsets), static_cast<const int*>(lo),
      static_cast<const int*>(b_perm), n, static_cast<long long*>(pi),
      static_cast<int*>(bi));
  return (int)cudaGetLastError();
}

extern "C" int csr_gather(const void* idx, int idx_elem, long long n,
                          int ncols, const void* const* data,
                          const void* const* valid, const int* elems,
                          void* const* out, void* const* out_valid,
                          void* stream) {
  if ((idx_elem != 4 && idx_elem != 8) || ncols < 0 || ncols > CJ_MAX_COLS)
    return (int)cudaErrorInvalidValue;
  CJCols c = {};
  for (int j = 0; j < ncols; ++j) {
    const int e = elems[j];
    if (e != 1 && e != 2 && e != 4 && e != 8)
      return (int)cudaErrorInvalidValue;
    c.data[j] = data[j];
    c.valid[j] = static_cast<const uint8_t*>(valid[j]);
    c.out[j] = out[j];
    c.out_valid[j] = static_cast<uint8_t*>(out_valid[j]);
    c.elem[j] = e;
  }
  c.ncols = ncols;
  if (n == 0 || ncols == 0) return (int)cudaSuccess;
  int blocks = 1;
  cudaError_t err = grid_for(n, &blocks, 16);
  if (err != cudaSuccess) return (int)err;
  cj_gather<<<blocks, CJ_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      c, idx, idx_elem, n);
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
