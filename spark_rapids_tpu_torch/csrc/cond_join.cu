// cond_join: the pairs and counts of joins that match on more than key
// equality — a join with a residual condition, an existence join and a
// cross join.
//
// Replaces: spark_rapids_tpu/plan/join_exec.py:446 _conditioned_probe_join
// (its candidate expansion program :467-483 over _expand_rows :1649, and
// the two segment_sums of the surviving pairs :500-513, per probe row and
// per build row), :617 _existence (its flag comes from the same probe
// counts) and :827 _cross (pi = j // n_r, bi = j % n_r).  The condition
// itself is the stage's elementwise work over the gathered pair columns,
// as in the reference, where XLA fuses it; it is not part of this file.
//
// Entry points:
//   cond_expand  every candidate pair of the match state: pair j belongs
//                to the probe row p whose range [offsets[p], offsets[p+1])
//                holds it, and pairs with the build row
//                b_perm[lo[p] + (j - offsets[p])].  One thread per pair;
//                thread 0 of each block finds, by binary search over the
//                offsets, the probe rows of the block's first and last
//                pairs, and every thread then searches only between them
//                (a few steps over offsets the block shares in L1), so a
//                probe row with many candidates and a run of rows with
//                none cost the same per pair.
//   cond_counts  the surviving pairs (keep) counted per probe row and per
//                build row.  The pairs of one probe row are adjacent (pi
//                is sorted), so the lanes of a warp that hold kept pairs
//                of one row find each other (__match_any_sync) and one
//                of them adds their number: a segmented reduction within
//                the warp, one atomic per row and warp.  The per-build
//                counts (right and full joins) take one atomic per kept
//                pair; a build row is hit once per candidate of its key,
//                so contention is low.  Semi, anti and existence joins
//                pass no build counts and skip those atomics.
//   cross_pairs  pi = j / n_r and bi = j % n_r for j < n_l * n_r, grid
//                stride.
//
// Bound: device memory.  cond_expand reads the probe's offsets and lo
// (12 B a probe row) and b_perm at each pair's build position, and writes
// 8 B a pair; cond_counts reads 9 B a pair and writes 4 B a probe row (and
// a build row); cross_pairs writes 8 B a pair.  Every index is int32 (the
// wrappers refuse sides or pair counts of 2^31 or more, so nothing wraps).

#include <cuda_runtime.h>
#include <stdint.h>

#define CJ_THREADS 256

// The largest p in [a, b] with offsets[p] <= j (offsets non-decreasing,
// offsets[a] <= j).
__device__ __forceinline__ long long probe_row(const long long* offsets,
                                               long long a, long long b,
                                               long long j) {
  while (a < b) {
    const long long mid = (a + b + 1) >> 1;
    if (offsets[mid] <= j) a = mid; else b = mid - 1;
  }
  return a;
}

__global__ void __launch_bounds__(CJ_THREADS)
cond_expand_k(const long long* __restrict__ offsets,
              const int* __restrict__ lo, const int* __restrict__ b_perm,
              long long n, long long total, int* __restrict__ pi,
              int* __restrict__ bi) {
  __shared__ long long first_row, last_row;
  const long long j0 = (long long)blockIdx.x * CJ_THREADS;
  if (threadIdx.x == 0) {
    const long long j1 = min(j0 + CJ_THREADS, total) - 1;
    first_row = probe_row(offsets, 0, n - 1, j0);
    last_row = probe_row(offsets, first_row, n - 1, j1);
  }
  __syncthreads();
  const long long j = j0 + threadIdx.x;
  if (j >= total) return;
  const long long p = probe_row(offsets, first_row, last_row, j);
  pi[j] = (int)p;
  bi[j] = b_perm[lo[p] + (int)(j - offsets[p])];
}

__global__ void __launch_bounds__(CJ_THREADS)
cond_counts_k(const uint8_t* __restrict__ keep, const int* __restrict__ pi,
              const int* __restrict__ bi, long long total,
              int* __restrict__ pcount, int* __restrict__ bcount) {
  const long long j = (long long)blockIdx.x * CJ_THREADS + threadIdx.x;
  const bool kept = j < total && keep[j];
  // every lane of the warp takes part in the ballot (no lane has left)
  const unsigned kept_lanes = __ballot_sync(0xffffffffu, kept);
  if (!kept) return;
  const int p = pi[j];
  const unsigned peers = __match_any_sync(kept_lanes, p);
  if ((threadIdx.x & 31) == __ffs(peers) - 1)
    atomicAdd(pcount + p, __popc(peers));
  if (bcount != nullptr) atomicAdd(bcount + bi[j], 1);
}

__global__ void __launch_bounds__(CJ_THREADS)
cross_pairs_k(long long total, long long n_r, int* __restrict__ pi,
              int* __restrict__ bi) {
  const long long stride = (long long)gridDim.x * CJ_THREADS;
  for (long long j = (long long)blockIdx.x * CJ_THREADS + threadIdx.x;
       j < total; j += stride) {
    pi[j] = (int)(j / n_r);
    bi[j] = (int)(j % n_r);
  }
}

static long long blocks_for(long long n) {
  return (n + CJ_THREADS - 1) / CJ_THREADS;
}

extern "C" int cond_expand(const void* offsets, const void* lo,
                           const void* b_perm, long long n, long long total,
                           void* pi, void* bi, void* stream) {
  if (n < 0 || total < 0 || total >= (1LL << 31) || (total > 0 && n == 0))
    return (int)cudaErrorInvalidValue;
  if (total > 0)
    cond_expand_k<<<(unsigned)blocks_for(total), CJ_THREADS, 0,
                    (cudaStream_t)stream>>>(
        (const long long*)offsets, (const int*)lo, (const int*)b_perm, n,
        total, (int*)pi, (int*)bi);
  return (int)cudaGetLastError();
}

extern "C" int cond_counts(const void* keep, const void* pi, const void* bi,
                           long long total, void* pcount, void* bcount,
                           void* stream) {
  if (total < 0 || total >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  if (total > 0)
    cond_counts_k<<<(unsigned)blocks_for(total), CJ_THREADS, 0,
                    (cudaStream_t)stream>>>(
        (const uint8_t*)keep, (const int*)pi, (const int*)bi, total,
        (int*)pcount, (int*)bcount);
  return (int)cudaGetLastError();
}

extern "C" int cross_pairs(long long n_l, long long n_r, void* pi, void* bi,
                           void* stream) {
  if (n_l < 0 || n_r < 0 || n_l >= (1LL << 31) || n_r >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const long long total = n_l * n_r;
  if (total > 0) {
    const long long blocks = blocks_for(total);
    cross_pairs_k<<<(unsigned)(blocks < 132 * 64 ? blocks : 132 * 64),
                    CJ_THREADS, 0, (cudaStream_t)stream>>>(
        total, n_r, (int*)pi, (int*)bi);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
