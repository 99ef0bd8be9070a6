// compact: pack the live rows of every column of a batch to the front, in
// row order, validity masks riding along.
//
// Replaces: spark_rapids_tpu/ops/batch_utils.py:280 _compact_fn (one
// program: cumsum of the live mask, then a scatter per column), called by
// batch_utils.compact (:151) with the live count already fetched
// (`n_live`), as the dense aggregation's output compaction does.
//
// Three kernels in one entry, no host sync between them:
//   cp_count    per tile of CP_TILE rows, the number of live rows;
//   cp_scan     one block turns the tile counts into exclusive offsets;
//   cp_scatter  per tile, each warp ballots its live rows, a block-level
//               prefix over the warps' counts gives each live row its rank,
//               and the row's element of every column (1, 2, 4 or 8 bytes)
//               and its validity byte go to offset + rank.
//
// Bound: device memory.  The mask is read twice (once per pass: 1 B a row)
// and each column's live rows are read and written once.  At TPC-H Q3's
// aggregate output (~16.8 M slots, ~1.29 M of them live, three 8-byte
// columns, a 4-byte one and a validity mask) the two mask passes and the
// live rows' sectors dominate.
// The scan's tile counts are 4 B per 4096 rows, so the extra pass costs
// little against reading the mask again in the scatter.

#include <cuda_runtime.h>
#include <stdint.h>

#define CP_THREADS 1024
#define CP_TILE 4096
#define CP_MAX_COLS 16

__global__ void __launch_bounds__(CP_THREADS)
cp_count(const uint8_t* __restrict__ active, long long n,
         long long* __restrict__ counts) {
  const long long base = (long long)blockIdx.x * CP_TILE;
  int c = 0;
  for (int t = threadIdx.x; t < CP_TILE; t += CP_THREADS) {
    const long long r = base + t;
    c += (r < n && active[r]) ? 1 : 0;
  }
  c = __reduce_add_sync(0xffffffffu, c);
  __shared__ int s[CP_THREADS / 32];
  if (threadIdx.x % 32 == 0) s[threadIdx.x / 32] = c;
  __syncthreads();
  if (threadIdx.x < 32) {
    int v = s[threadIdx.x];
    v = __reduce_add_sync(0xffffffffu, v);
    if (threadIdx.x == 0) counts[blockIdx.x] = v;
  }
}

// In place: counts[i] becomes the number of live rows before tile i.
__global__ void __launch_bounds__(CP_THREADS)
cp_scan(long long* __restrict__ counts, long long tiles) {
  __shared__ long long s[CP_THREADS];
  long long carry = 0;
  for (long long lo = 0; lo < tiles; lo += CP_THREADS) {
    const long long i = lo + threadIdx.x;
    const long long v = i < tiles ? counts[i] : 0;
    s[threadIdx.x] = v;
    __syncthreads();
    for (int o = 1; o < CP_THREADS; o <<= 1) {  // Hillis-Steele inclusive
      const long long add = threadIdx.x >= o ? s[threadIdx.x - o] : 0;
      __syncthreads();
      s[threadIdx.x] += add;
      __syncthreads();
    }
    if (i < tiles) counts[i] = carry + s[threadIdx.x] - v;
    carry += s[CP_THREADS - 1];
    __syncthreads();
  }
}

struct CPArgs {
  const void* in[CP_MAX_COLS];
  void* out[CP_MAX_COLS];
  const uint8_t* vin[CP_MAX_COLS];  // nullptr: no validity mask
  uint8_t* vout[CP_MAX_COLS];
  int elem[CP_MAX_COLS];
  int ncols;
};

__device__ __forceinline__ void move_elem(void* dst, const void* src, int elem,
                                     long long to, long long from) {
  switch (elem) {
    case 8:
      static_cast<long long*>(dst)[to] =
          static_cast<const long long*>(src)[from];
      break;
    case 4:
      static_cast<int*>(dst)[to] = static_cast<const int*>(src)[from];
      break;
    case 2:
      static_cast<short*>(dst)[to] = static_cast<const short*>(src)[from];
      break;
    default:
      static_cast<uint8_t*>(dst)[to] = static_cast<const uint8_t*>(src)[from];
  }
}

__global__ void __launch_bounds__(CP_THREADS)
cp_scatter(const __grid_constant__ CPArgs a,
           const uint8_t* __restrict__ active, long long n,
           const long long* __restrict__ offsets, long long n_live) {
  __shared__ int warp_base[CP_THREADS / 32];
  __shared__ int chunk_total;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long base = (long long)blockIdx.x * CP_TILE;
  long long out_base = offsets[blockIdx.x];
  for (int t0 = 0; t0 < CP_TILE; t0 += CP_THREADS) {
    const long long r = base + t0 + threadIdx.x;
    const bool live = r < n && active[r];
    const unsigned int ballot = __ballot_sync(0xffffffffu, live);
    if (lane == 0) warp_base[warp] = __popc(ballot);
    __syncthreads();
    if (warp == 0) {  // exclusive prefix over the 32 warp counts
      const int v = warp_base[lane];
      int incl = v;
      for (int o = 1; o < 32; o <<= 1) {
        const int up = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += up;
      }
      warp_base[lane] = incl - v;
      if (lane == 31) chunk_total = incl;
    }
    __syncthreads();
    if (live) {
      const long long to = out_base + warp_base[warp] +
                           __popc(ballot & ((1u << lane) - 1u));
      if (to < n_live) {
        for (int j = 0; j < a.ncols; ++j) {
          move_elem(a.out[j], a.in[j], a.elem[j], to, r);
          if (a.vin[j] != nullptr) a.vout[j][to] = a.vin[j][r];
        }
      }
    }
    out_base += chunk_total;
    __syncthreads();
  }
}

// Host entry, bound with ctypes.  `in`, `out`, `vin`, `vout` and `elems`
// are host arrays; columns are [n] in and [n_live] out; `scratch` holds
// one int64 per CP_TILE rows.  Returns cudaGetLastError() (0 = launched).
extern "C" int compact(int ncols, const void* const* in, void* const* out,
                       const void* const* vin, void* const* vout,
                       const int* elems, const void* active, long long n,
                       long long n_live, void* scratch, void* stream) {
  if (ncols < 0 || ncols > CP_MAX_COLS || n < 0 || n_live < 0)
    return (int)cudaErrorInvalidValue;
  CPArgs a = {};
  for (int j = 0; j < ncols; ++j) {
    const int e = elems[j];
    if (e != 1 && e != 2 && e != 4 && e != 8)
      return (int)cudaErrorInvalidValue;
    if ((vin[j] == nullptr) != (vout[j] == nullptr))
      return (int)cudaErrorInvalidValue;
    a.in[j] = in[j];
    a.out[j] = out[j];
    a.vin[j] = static_cast<const uint8_t*>(vin[j]);
    a.vout[j] = static_cast<uint8_t*>(vout[j]);
    a.elem[j] = e;
  }
  a.ncols = ncols;
  if (n == 0 || n_live == 0) return (int)cudaSuccess;
  const long long tiles = (n + CP_TILE - 1) / CP_TILE;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* act = static_cast<const uint8_t*>(active);
  long long* offsets = static_cast<long long*>(scratch);
  cp_count<<<(int)tiles, CP_THREADS, 0, s>>>(act, n, offsets);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cp_scan<<<1, CP_THREADS, 0, s>>>(offsets, tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cp_scatter<<<(int)tiles, CP_THREADS, 0, s>>>(a, act, n, offsets, n_live);
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
