// topk: the first k live rows of a batch under a stable multi-key ORDER BY,
// as row indices in order.
//
// Replaces: spark_rapids_tpu/plan/exec_nodes.py:236 TopKExec, which sorts
// every batch with a stable lexsort (:219 _sort_perm over
// ops/groupby.py:82 sort_indices_for_keys and :43 sortable_view) and clips
// it to k rows.  Here no full sort is done: only k rows are kept.
//
// Each row becomes a tuple of int64 words compared in order, then its row
// number, which is what a stable sort breaks ties with.  Per key, a key
// with a validity mask first contributes its null word (nulls first: a
// null row 0 and a valid row 1; nulls last: the reverse), then every key
// its value word: integers as they are, floats as sortable_view's image
// (-0.0 as +0.0, every NaN above +inf, negative floats below positive), a
// descending key as the bitwise complement.  Inactive rows are left out.
//
//   tk_columns     block b sorts rows [b*CHUNK, (b+1)*CHUNK) — words built
//                  from the columns in shared memory, a bitonic sort of
//                  CHUNK entries — and writes its first k entries;
//   tk_candidates  the same over the candidates of the previous pass.
// The entry runs tk_columns once, then tk_candidates until one block is
// left; with CHUNK >= 2k every pass at least halves the candidates.  Empty
// slots carry the largest words and row number, so they sort after every
// row and come back as -1.
//
// Bound: device memory for the first pass (each key column and the mask
// read once; at TPC-H Q3, ~1.29 M rows of a float64 sum with its validity
// and an int32 date: 14 B a row), and the sort's operations in shared
// memory, log2(CHUNK)^2 / 2 compare-exchange steps of every entry, which
// for CHUNK = 2048 are 66 steps a row.  The design keeps the sort in
// shared memory so each row's words are read from device memory once.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define TK_THREADS 1024
#define TK_CHUNK 2048
#define TK_MAX_KEYS 4
#define TK_MAX_WORDS (2 * TK_MAX_KEYS)

enum { K_INT32 = 0, K_INT64 = 1, K_F64 = 2, K_F32 = 3, K_BOOL = 4 };

struct TKArgs {
  const void* data[TK_MAX_KEYS];
  const uint8_t* valid[TK_MAX_KEYS];  // nullptr: the key has no nulls
  int kind[TK_MAX_KEYS];
  int desc[TK_MAX_KEYS];
  int nulls_first[TK_MAX_KEYS];
  int nkeys;
  int nwords;
};

__device__ __forceinline__ long long f64_view(double x) {
  if (x != x) return LLONG_MAX;  // NaN: above every number
  if (x == 0.0) return 0;        // -0.0 sorts with +0.0
  const long long b = __double_as_longlong(x);
  return b < 0 ? LLONG_MIN - b : b;
}

__device__ __forceinline__ long long f32_view(float x) {
  if (x != x) return INT_MAX;
  if (x == 0.0f) return 0;
  const int b = __float_as_int(x);
  return (long long)(b < 0 ? INT_MIN - b : b);
}

__device__ __forceinline__ long long value_view(const TKArgs& a, int c,
                                                long long r) {
  switch (a.kind[c]) {
    case K_INT64: return static_cast<const long long*>(a.data[c])[r];
    case K_F64: return f64_view(static_cast<const double*>(a.data[c])[r]);
    case K_F32: return f32_view(static_cast<const float*>(a.data[c])[r]);
    case K_BOOL: return static_cast<const uint8_t*>(a.data[c])[r] ? 1 : 0;
    default: return static_cast<const int*>(a.data[c])[r];
  }
}

// Shared memory: words [nwords][TK_CHUNK], then row numbers [TK_CHUNK].
__device__ __forceinline__ bool tk_less(const long long* w, const long long* idx,
                                        int nwords, int i, int j) {
  for (int q = 0; q < nwords; ++q) {
    const long long x = w[q * TK_CHUNK + i], y = w[q * TK_CHUNK + j];
    if (x != y) return x < y;
  }
  return idx[i] < idx[j];
}

__device__ void tk_sort(long long* w, long long* idx, int nwords) {
  for (int size = 2; size <= TK_CHUNK; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      __syncthreads();
      for (int t = threadIdx.x; t < TK_CHUNK / 2; t += TK_THREADS) {
        const int i = 2 * t - (t & (stride - 1));
        const int j = i + stride;
        const bool up = (i & size) == 0;
        if (tk_less(w, idx, nwords, j, i) == up) {
          for (int q = 0; q < nwords; ++q) {
            const long long x = w[q * TK_CHUNK + i];
            w[q * TK_CHUNK + i] = w[q * TK_CHUNK + j];
            w[q * TK_CHUNK + j] = x;
          }
          const long long x = idx[i];
          idx[i] = idx[j];
          idx[j] = x;
        }
      }
    }
  }
  __syncthreads();
}

__device__ void tk_emit(const long long* w, const long long* idx, int nwords,
                        int k, long long* __restrict__ out_w,
                        long long* __restrict__ out_idx, long long out_n) {
  for (int t = threadIdx.x; t < k; t += TK_THREADS) {
    const long long o = (long long)blockIdx.x * k + t;
    for (int q = 0; q < nwords; ++q) out_w[q * out_n + o] = w[q * TK_CHUNK + t];
    out_idx[o] = idx[t];
  }
}

__global__ void __launch_bounds__(TK_THREADS)
tk_columns(const __grid_constant__ TKArgs a,
           const uint8_t* __restrict__ active, long long n, int k,
           long long* __restrict__ out_w, long long* __restrict__ out_idx,
           long long out_n) {
  extern __shared__ long long smem[];
  long long* w = smem;
  long long* idx = smem + (long long)a.nwords * TK_CHUNK;
  const long long base = (long long)blockIdx.x * TK_CHUNK;
  for (int t = threadIdx.x; t < TK_CHUNK; t += TK_THREADS) {
    const long long r = base + t;
    if (r >= n || (active != nullptr && !active[r])) {
      for (int q = 0; q < a.nwords; ++q) w[q * TK_CHUNK + t] = LLONG_MAX;
      idx[t] = LLONG_MAX;
      continue;
    }
    int q = 0;
    for (int c = 0; c < a.nkeys; ++c) {
      if (a.valid[c] != nullptr) {
        const bool v = a.valid[c][r] != 0;
        w[q++ * TK_CHUNK + t] = a.nulls_first[c] ? (v ? 1 : 0) : (v ? 0 : 1);
      }
      const long long view = value_view(a, c, r);
      w[q++ * TK_CHUNK + t] = a.desc[c] ? ~view : view;
    }
    idx[t] = r;
  }
  tk_sort(w, idx, a.nwords);
  tk_emit(w, idx, a.nwords, k, out_w, out_idx, out_n);
}

__global__ void __launch_bounds__(TK_THREADS)
tk_candidates(const long long* __restrict__ in_w,
              const long long* __restrict__ in_idx, long long in_n,
              int nwords, int k, long long* __restrict__ out_w,
              long long* __restrict__ out_idx, long long out_n) {
  extern __shared__ long long smem[];
  long long* w = smem;
  long long* idx = smem + (long long)nwords * TK_CHUNK;
  const long long base = (long long)blockIdx.x * TK_CHUNK;
  for (int t = threadIdx.x; t < TK_CHUNK; t += TK_THREADS) {
    const long long r = base + t;
    const bool in = r < in_n;
    for (int q = 0; q < nwords; ++q)
      w[q * TK_CHUNK + t] = in ? in_w[q * in_n + r] : LLONG_MAX;
    idx[t] = in ? in_idx[r] : LLONG_MAX;
  }
  tk_sort(w, idx, nwords);
  tk_emit(w, idx, nwords, k, out_w, out_idx, out_n);
}

__global__ void tk_finish(const long long* __restrict__ idx, int k,
                          long long* __restrict__ out) {
  for (int t = threadIdx.x; t < k; t += blockDim.x)
    out[t] = idx[t] == LLONG_MAX ? -1 : idx[t];
}

static long long tk_blocks(long long n) {
  return (n + TK_CHUNK - 1) / TK_CHUNK;
}

// Host entry, bound with ctypes.  The per-key arrays are host arrays.
// `scratch` holds two candidate buffers of max(1, ceil(n / TK_CHUNK)) * k
// entries each, nwords + 1 int64 words per entry.  `out` receives k int64
// row indices, -1 past the live rows.

extern "C" int topk(int nkeys, const void* const* data,
                    const void* const* valid, const int* kinds,
                    const int* desc, const int* nulls_first,
                    const void* active, long long n, int k, void* scratch,
                    void* out, void* stream) {
  if (nkeys < 1 || nkeys > TK_MAX_KEYS || k < 1 || 2 * k > TK_CHUNK ||
      n < 0)
    return (int)cudaErrorInvalidValue;
  TKArgs a = {};
  int nwords = 0;
  for (int c = 0; c < nkeys; ++c) {
    if (kinds[c] < K_INT32 || kinds[c] > K_BOOL)
      return (int)cudaErrorInvalidValue;
    a.data[c] = data[c];
    a.valid[c] = static_cast<const uint8_t*>(valid[c]);
    a.kind[c] = kinds[c];
    a.desc[c] = desc[c] != 0;
    a.nulls_first[c] = nulls_first[c] != 0;
    nwords += valid[c] != nullptr ? 2 : 1;
  }
  a.nkeys = nkeys;
  a.nwords = nwords;
  const size_t smem = (size_t)(nwords + 1) * TK_CHUNK * sizeof(long long);
  cudaError_t err = cudaFuncSetAttribute(
      tk_columns, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        tk_candidates, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  long long blocks = tk_blocks(n) < 1 ? 1 : tk_blocks(n);
  const long long half = blocks * k * (nwords + 1);
  long long* buf[2] = {static_cast<long long*>(scratch),
                       static_cast<long long*>(scratch) + half};
  long long m = blocks * k;  // entries in the current candidate buffer
  tk_columns<<<(int)blocks, TK_THREADS, smem, s>>>(
      a, static_cast<const uint8_t*>(active), n, k, buf[0],
      buf[0] + (long long)nwords * m, m);
  err = cudaGetLastError();
  int cur = 0;
  while (err == cudaSuccess && blocks > 1) {
    const long long in_n = m;
    blocks = tk_blocks(in_n);
    m = blocks * k;
    tk_candidates<<<(int)blocks, TK_THREADS, smem, s>>>(
        buf[cur], buf[cur] + (long long)nwords * in_n, in_n, nwords, k,
        buf[1 - cur], buf[1 - cur] + (long long)nwords * m, m);
    err = cudaGetLastError();
    cur = 1 - cur;
  }
  if (err != cudaSuccess) return (int)err;
  tk_finish<<<1, 1024, 0, s>>>(buf[cur] + (long long)nwords * m, k,
                               static_cast<long long*>(out));
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
