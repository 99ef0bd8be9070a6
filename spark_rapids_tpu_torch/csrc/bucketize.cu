// bucketize: the send side of the mesh exchange — every live row scattered
// into its destination's fixed-capacity bucket, for every payload column.
//
// Replaces: spark_rapids_tpu/parallel/exchange.py:32 bucketize (a stable
// argsort of the destinations, a segment_sum of the counts, each sorted
// row's position within its destination, and one drop-mode scatter per
// column into zero-filled [n_parts, bucket_cap] buckets).
//
// Result, equal to the reference's: out[c][p * cap + j] is column c of the
// j-th live row (in source order) whose destination is p, for j < cap, and
// zero past the bucket's fill; sent[p] = min(count[p], cap); overflow = the
// live rows past their bucket's capacity.  Dead rows and overflowing rows
// are DROPPED, never clamped into a slot: a full last bucket keeps its
// rows (the reference's comment :56-60).
//
// Three launches, no sort:
//   bz_count  one warp per block over a contiguous chunk of rows: the
//             chunk's rows per destination into counts[p][block] (a shared
//             histogram, then one store per destination);
//   bz_scan   one block per destination: the exclusive prefix of its
//             counts over the blocks (so a block knows where its rows
//             start in the bucket), the total, sent = min(total, cap), and
//             the overflow added up;
//   bz_scatter the same chunks again, 32 rows a step in source order: a
//             lane's rank among the step's earlier lanes with the same
//             destination (__match_any_sync), plus the destination's
//             running count in shared memory, plus the block's offset, is
//             the row's stable slot; rows at or past cap are counted, not
//             written.
//
// Bound: device memory.  Each input byte is read twice (count and scatter
// read the destinations; the scatter reads the payload once) and each
// output byte written once; the buckets are zero-filled by the caller.  The
// count and scan passes move 4 bytes per row and per (block, destination).

#include <cuda_runtime.h>
#include <stdint.h>

#define BZ_MAX_COLS 64
#define BZ_MAX_PARTS 4096
#define BZ_CHUNK 1024      // rows per block
#define BZ_SCAN_THREADS 1024

struct BZCols {
  const void* in[BZ_MAX_COLS];
  void* out[BZ_MAX_COLS];
  int elem[BZ_MAX_COLS];
  int ncols;
};

__device__ __forceinline__ int dest_of(const int* __restrict__ pids,
                                       const uint8_t* __restrict__ active,
                                       long long r, int nparts) {
  const int p = pids[r];
  if ((active != nullptr && !active[r]) || p < 0 || p >= nparts)
    return nparts;  // dead: goes nowhere
  return p;
}

__global__ void __launch_bounds__(32)
bz_count(const int* __restrict__ pids, const uint8_t* __restrict__ active,
         long long n, int nparts, int nblocks, int* __restrict__ counts) {
  extern __shared__ int s_hist[];
  for (int p = threadIdx.x; p < nparts; p += 32) s_hist[p] = 0;
  __syncwarp();
  const long long lo = (long long)blockIdx.x * BZ_CHUNK;
  const long long hi = lo + BZ_CHUNK < n ? lo + BZ_CHUNK : n;
  for (long long r = lo + threadIdx.x; r < hi; r += 32) {
    const int p = dest_of(pids, active, r, nparts);
    if (p < nparts) atomicAdd(s_hist + p, 1);
  }
  __syncwarp();
  for (int p = threadIdx.x; p < nparts; p += 32)
    counts[(long long)p * nblocks + blockIdx.x] = s_hist[p];
}

// One block per destination: counts[p][b] becomes the exclusive prefix
// over b; the total lands in sent (capped) and the overflow counter.
__global__ void __launch_bounds__(BZ_SCAN_THREADS)
bz_scan(int* __restrict__ counts, int nblocks, long long cap,
        int* __restrict__ sent, unsigned long long* __restrict__ overflow) {
  __shared__ int s_warp[BZ_SCAN_THREADS / 32];
  __shared__ long long s_carry;
  int* row = counts + (long long)blockIdx.x * nblocks;
  if (threadIdx.x == 0) s_carry = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int base = 0; base < nblocks; base += BZ_SCAN_THREADS) {
    const int b = base + threadIdx.x;
    const int x = b < nblocks ? row[b] : 0;
    int inc = x;  // inclusive scan within the warp
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, inc, o);
      if (lane >= o) inc += y;
    }
    if (lane == 31) s_warp[warp] = inc;
    __syncthreads();
    if (warp == 0) {
      int w = s_warp[lane];
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, w, o);
        if (lane >= o) w += y;
      }
      s_warp[lane] = w;  // inclusive over warps
    }
    __syncthreads();
    const long long before = s_carry + (warp > 0 ? s_warp[warp - 1] : 0);
    if (b < nblocks) row[b] = (int)(before + inc - x);
    __syncthreads();
    if (threadIdx.x == 0) s_carry += s_warp[BZ_SCAN_THREADS / 32 - 1];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const long long total = s_carry;
    sent[blockIdx.x] = (int)(total < cap ? total : cap);
    if (total > cap) atomicAdd(overflow, (unsigned long long)(total - cap));
  }
}

__global__ void __launch_bounds__(32)
bz_scatter(const int* __restrict__ pids, const uint8_t* __restrict__ active,
           long long n, int nparts, int nblocks, long long cap,
           const int* __restrict__ offsets, const __grid_constant__ BZCols c) {
  extern __shared__ int s_run[];
  for (int p = threadIdx.x; p < nparts; p += 32) s_run[p] = 0;
  __syncwarp();
  const unsigned lt = (1u << threadIdx.x) - 1u;
  const long long lo = (long long)blockIdx.x * BZ_CHUNK;
  const long long hi = lo + BZ_CHUNK < n ? lo + BZ_CHUNK : n;
  for (long long base = lo; base < hi; base += 32) {
    const long long r = base + threadIdx.x;
    const int p = r < hi ? dest_of(pids, active, r, nparts) : nparts + 1;
    const unsigned same = __match_any_sync(0xffffffffu, p);
    const int rank = __popc(same & lt);
    const bool leader = (same & lt) == 0u;
    if (p < nparts) {
      const long long slot =
          (long long)offsets[(long long)p * nblocks + blockIdx.x] +
          s_run[p] + rank;
      if (slot < cap) {
        const long long at = (long long)p * cap + slot;
        for (int k = 0; k < c.ncols; ++k) {
          switch (c.elem[k]) {
            case 8:
              static_cast<long long*>(c.out[k])[at] =
                  static_cast<const long long*>(c.in[k])[r];
              break;
            case 4:
              static_cast<int*>(c.out[k])[at] =
                  static_cast<const int*>(c.in[k])[r];
              break;
            case 2:
              static_cast<short*>(c.out[k])[at] =
                  static_cast<const short*>(c.in[k])[r];
              break;
            default:
              static_cast<uint8_t*>(c.out[k])[at] =
                  static_cast<const uint8_t*>(c.in[k])[r];
          }
        }
      }
    }
    __syncwarp();
    if (leader && p < nparts) s_run[p] += __popc(same);
    __syncwarp();
  }
}

// Host entry, bound with ctypes.  pids: int32 [n] destinations; active:
// uint8 [n] or nullptr; in/out: ncols device pointers (out: zero-filled
// [nparts, cap] buffers of the same element size); counts: int32
// [nparts * nblocks] scratch with nblocks = ceil(n / BZ_CHUNK); sent: int32
// [nparts]; overflow: one uint64 word, zeroed by the caller.  Returns
// cudaGetLastError() after the launches.
extern "C" int bucketize(const void* pids, const void* active, long long n,
                         int nparts, long long cap, int ncols,
                         const void* const* in, void* const* out,
                         const int* elems, void* counts, void* sent,
                         void* overflow, void* stream) {
  if (n < 0 || nparts < 1 || nparts > BZ_MAX_PARTS || cap < 0 || ncols < 0
      || ncols > BZ_MAX_COLS || n >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  BZCols c = {};
  for (int k = 0; k < ncols; ++k) {
    const int e = elems[k];
    if (e != 1 && e != 2 && e != 4 && e != 8) return (int)cudaErrorInvalidValue;
    c.in[k] = in[k];
    c.out[k] = out[k];
    c.elem[k] = e;
  }
  c.ncols = ncols;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nblocks = (int)((n + BZ_CHUNK - 1) / BZ_CHUNK);
  const size_t shared = (size_t)nparts * sizeof(int);
  if (nblocks > 0)
    bz_count<<<nblocks, 32, shared, st>>>(
        static_cast<const int*>(pids), static_cast<const uint8_t*>(active),
        n, nparts, nblocks, static_cast<int*>(counts));
  bz_scan<<<nparts, BZ_SCAN_THREADS, 0, st>>>(
      static_cast<int*>(counts), nblocks, cap, static_cast<int*>(sent),
      static_cast<unsigned long long*>(overflow));
  if (nblocks > 0 && cap > 0)
    bz_scatter<<<nblocks, 32, shared, st>>>(
        static_cast<const int*>(pids), static_cast<const uint8_t*>(active),
        n, nparts, nblocks, cap, static_cast<const int*>(counts), c);
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
