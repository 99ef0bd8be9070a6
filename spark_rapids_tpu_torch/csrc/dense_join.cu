// dense_join: the dense direct-address broadcast join — build-key stats, a
// key -> build-row table, and the probe with its payload gathers.
//
// Replaces: spark_rapids_tpu/plan/join_exec.py:1200 _dense_prefetch (the
// build-key stats program), :1353 _dense_build_state_impl (the int32 table
// key - kmin -> build row) and :1410 _dense_join_pair (the probe: table
// lookup, selection AND, payload gathers), for inner joins on one integral
// key.
//
// Three entry points, one per phase:
//   dense_join_stats  min, max and count of the live, valid build keys in
//                     one pass (block reduction, one atomic per block);
//   dense_join_build  one thread per live build row claims table[key - kmin]
//                     with atomicCAS from -1; a claimed slot means a
//                     duplicate key, counted into a device word (the dense
//                     path holds only for unique keys).  The reference finds
//                     duplicates with a device sort inside its stats
//                     program; here the count stays on the device until the
//                     query's next fetch, so a join costs one fetch (the
//                     stats, which size the table);
//   dense_join_probe  per probe row: the live mask, the key's validity, the
//                     domain test and the table lookup, then every payload
//                     column's data and validity gathered from the matched
//                     build row, and the output selection byte — one launch,
//                     no index tensor written out.
//
// Bound: device memory.  The probe reads each probe row's 1 B mask, its key
// (8 B) and one 4 B table word at a random address (a 32-byte sector), and
// for each matched row one sector of each payload column; it writes the
// selection byte and each payload element.  At TPC-H Q3's second join
// (~15 M-slot table, 60 MB, larger than the 50 MB L2) the random table
// reads dominate.  The design keeps to one pass: the lookup and every
// gather of a row happen in the thread that owns it, so the table word and
// the build row index never leave registers.
//
// Keys are int32 or int64 (dates are int32 days); the caller promotes both
// sides to one type.  Payload elements are 1, 2, 4 or 8 bytes.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define DJ_THREADS 256
#define DJ_MAX_COLS 16

__device__ __forceinline__ long long load_key(const void* p, int elem,
                                              long long r) {
  return elem == 8 ? static_cast<const long long*>(p)[r]
                   : (long long)static_cast<const int*>(p)[r];
}

// True when key k lies in [kmin, kmin + D); idx receives k - kmin.  The
// difference is taken unsigned, so extreme keys cannot overflow it.
__device__ __forceinline__ bool in_domain(long long k, long long kmin,
                                          long long D, long long* idx) {
  if (k < kmin) return false;
  const unsigned long long d =
      (unsigned long long)k - (unsigned long long)kmin;
  if (d >= (unsigned long long)D) return false;
  *idx = (long long)d;
  return true;
}

__device__ __forceinline__ bool live(const uint8_t* active,
                                     const uint8_t* valid, long long r) {
  return (active == nullptr || active[r]) && (valid == nullptr || valid[r]);
}

// out: [min, max, count], preset by the caller to INT64_MAX, INT64_MIN, 0.
__global__ void __launch_bounds__(DJ_THREADS)
dj_stats(const void* __restrict__ keys, int elem,
         const uint8_t* __restrict__ key_valid,
         const uint8_t* __restrict__ active, long long n,
         long long* __restrict__ out) {
  long long lo = LLONG_MAX, hi = LLONG_MIN, cnt = 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += stride) {
    if (!live(active, key_valid, r)) continue;
    const long long k = load_key(keys, elem, r);
    lo = k < lo ? k : lo;
    hi = k > hi ? k : hi;
    ++cnt;
  }
  for (int o = 16; o > 0; o >>= 1) {
    const long long l2 = __shfl_down_sync(0xffffffffu, lo, o);
    const long long h2 = __shfl_down_sync(0xffffffffu, hi, o);
    lo = l2 < lo ? l2 : lo;
    hi = h2 > hi ? h2 : hi;
    cnt += __shfl_down_sync(0xffffffffu, cnt, o);
  }
  __shared__ long long s_lo[DJ_THREADS / 32], s_hi[DJ_THREADS / 32],
      s_cnt[DJ_THREADS / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    s_lo[warp] = lo;
    s_hi[warp] = hi;
    s_cnt[warp] = cnt;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < DJ_THREADS / 32; ++w) {
      lo = s_lo[w] < lo ? s_lo[w] : lo;
      hi = s_hi[w] > hi ? s_hi[w] : hi;
      cnt += s_cnt[w];
    }
    if (cnt > 0) {
      atomicMin(out, lo);
      atomicMax(out + 1, hi);
      atomicAdd(reinterpret_cast<unsigned long long*>(out + 2),
                (unsigned long long)cnt);
    }
  }
}

// table: [D] int32 preset to -1; dup: one device word, preset to 0.
__global__ void __launch_bounds__(DJ_THREADS)
dj_build(const void* __restrict__ keys, int elem,
         const uint8_t* __restrict__ key_valid,
         const uint8_t* __restrict__ active, long long n, long long kmin,
         long long D, int* __restrict__ table,
         unsigned long long* __restrict__ dup) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += stride) {
    if (!live(active, key_valid, r)) continue;
    long long idx;
    if (!in_domain(load_key(keys, elem, r), kmin, D, &idx)) continue;
    if (atomicCAS(table + idx, -1, (int)r) != -1) atomicAdd(dup, 1ULL);
  }
}

struct DJPayload {
  const void* data[DJ_MAX_COLS];
  const uint8_t* valid[DJ_MAX_COLS];  // nullptr: the build column has no nulls
  void* out[DJ_MAX_COLS];
  uint8_t* out_valid[DJ_MAX_COLS];    // nullptr exactly where valid is
  int elem[DJ_MAX_COLS];
  int ncols;
};

__device__ __forceinline__ void copy_elem(void* dst, const void* src,
                                          int elem, long long to,
                                          long long from, bool matched) {
  switch (elem) {
    case 8:
      static_cast<long long*>(dst)[to] =
          matched ? static_cast<const long long*>(src)[from] : 0LL;
      break;
    case 4:
      static_cast<int*>(dst)[to] =
          matched ? static_cast<const int*>(src)[from] : 0;
      break;
    case 2:
      static_cast<short*>(dst)[to] =
          matched ? static_cast<const short*>(src)[from] : (short)0;
      break;
    default:
      static_cast<uint8_t*>(dst)[to] =
          matched ? static_cast<const uint8_t*>(src)[from] : (uint8_t)0;
  }
}

__global__ void __launch_bounds__(DJ_THREADS)
dj_probe(const __grid_constant__ DJPayload p, const void* __restrict__ keys,
         int elem, const uint8_t* __restrict__ key_valid,
         const uint8_t* __restrict__ active, long long n, long long kmin,
         long long D, const int* __restrict__ table,
         uint8_t* __restrict__ out_sel) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += stride) {
    int bi = -1;
    long long idx;
    if (live(active, key_valid, r) &&
        in_domain(load_key(keys, elem, r), kmin, D, &idx))
      bi = table[idx];
    const bool matched = bi >= 0;
    out_sel[r] = matched;
#pragma unroll 4
    for (int j = 0; j < p.ncols; ++j) {
      copy_elem(p.out[j], p.data[j], p.elem[j], r, bi, matched);
      if (p.out_valid[j] != nullptr)
        p.out_valid[j][r] = matched && p.valid[j][bi];
    }
  }
}

static cudaError_t grid_for(long long n, int* blocks, int per_sm) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long want = (n + DJ_THREADS - 1) / DJ_THREADS;
  const long long cap = (long long)sms * per_sm;
  *blocks = (int)(want < 1 ? 1 : (want < cap ? want : cap));
  return cudaSuccess;
}

// Host entries, bound with ctypes; every pointer but the payload arrays'
// host arrays points to device memory.  Each returns cudaGetLastError()
// after its launch (0 = launched).
extern "C" int dense_join_stats(const void* keys, int elem,
                                const void* key_valid, const void* active,
                                long long n, void* out, void* stream) {
  if (elem != 4 && elem != 8) return (int)cudaErrorInvalidValue;
  int blocks = 1;
  cudaError_t err = grid_for(n, &blocks, 8);
  if (err != cudaSuccess) return (int)err;
  dj_stats<<<blocks, DJ_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      keys, elem, static_cast<const uint8_t*>(key_valid),
      static_cast<const uint8_t*>(active), n, static_cast<long long*>(out));
  return (int)cudaGetLastError();
}

extern "C" int dense_join_build(const void* keys, int elem,
                                const void* key_valid, const void* active,
                                long long n, long long kmin, long long D,
                                void* table, void* dup, void* stream) {
  if ((elem != 4 && elem != 8) || n > INT_MAX || D < 1)
    return (int)cudaErrorInvalidValue;
  int blocks = 1;
  cudaError_t err = grid_for(n, &blocks, 8);
  if (err != cudaSuccess) return (int)err;
  dj_build<<<blocks, DJ_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      keys, elem, static_cast<const uint8_t*>(key_valid),
      static_cast<const uint8_t*>(active), n, kmin, D,
      static_cast<int*>(table), static_cast<unsigned long long*>(dup));
  return (int)cudaGetLastError();
}

extern "C" int dense_join_probe(const void* keys, int elem,
                                const void* key_valid, const void* active,
                                long long n, long long kmin, long long D,
                                const void* table, int ncols,
                                const void* const* data,
                                const void* const* valid,
                                const int* elems, void* const* out,
                                void* const* out_valid, void* out_sel,
                                void* stream) {
  if ((elem != 4 && elem != 8) || ncols < 0 || ncols > DJ_MAX_COLS || D < 1)
    return (int)cudaErrorInvalidValue;
  DJPayload p = {};
  for (int j = 0; j < ncols; ++j) {
    const int e = elems[j];
    if (e != 1 && e != 2 && e != 4 && e != 8)
      return (int)cudaErrorInvalidValue;
    if ((valid[j] == nullptr) != (out_valid[j] == nullptr))
      return (int)cudaErrorInvalidValue;
    p.data[j] = data[j];
    p.valid[j] = static_cast<const uint8_t*>(valid[j]);
    p.out[j] = out[j];
    p.out_valid[j] = static_cast<uint8_t*>(out_valid[j]);
    p.elem[j] = e;
  }
  p.ncols = ncols;
  int blocks = 1;
  cudaError_t err = grid_for(n, &blocks, 16);
  if (err != cudaSuccess) return (int)err;
  dj_probe<<<blocks, DJ_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      p, keys, elem, static_cast<const uint8_t*>(key_valid),
      static_cast<const uint8_t*>(active), n, kmin, D,
      static_cast<const int*>(table), static_cast<uint8_t*>(out_sel));
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
