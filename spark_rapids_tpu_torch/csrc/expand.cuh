// expand.cuh: the expansion of a match state into pair maps by output row,
// shared by csr_join.cu (csr_expand: int64 pi, bi = -1 for a left join's
// unmatched row) and cond_join.cu (cond_expand: int32 pi, every row's lo a
// real build position), and the merge-path split that cond_join.cu's
// counts take too (explode.cu's rows take warp_search).
//
// The merge path of the output rows [0, total) and the ends offsets[r + 1]
// of the n probe rows: row r's end comes before output j when
// offsets[r + 1] <= j.  Block b takes items [b EX_TILE, (b + 1) EX_TILE) of
// the merged sequence: probe-row ends [r0, r1) and outputs [j0, j1), found
// by two warps with a 32-way search over offsets (warp_search); output j's
// probe row is r0 + the ends of [r0, r1) at or below j.  Offsets and lo of
// the block's rows are staged in shared memory, each thread finds its
// output row's probe row there, and pi and bi are written coalesced, so a
// key with millions of matches spreads over the whole grid and a run of
// rows with none costs one item each.
//
// Bound: device memory.  12 B a probe row read (offsets, lo), one 4 B
// b_perm word a pair (a row's build positions are contiguous), and
// sizeof(pi) + 4 B a pair written.
//
// Included by each kernel source, which is compiled into its own library.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define EX_THREADS 256
#define EX_TILE 2048  // merge-path items a block (8 a thread)

// The first i in [lo, hi) where pred(i) is false (hi if none), for a pred
// that is true then false along i; all 32 lanes of the warp call it and
// get the answer.  Each step probes 32 evenly spaced positions at once.
template <class Pred>
__device__ __forceinline__ long long warp_search(long long lo, long long hi,
                                                 const Pred& pred) {
  const int lane = threadIdx.x & 31;
  while (hi - lo > 32) {
    const long long len = hi - lo;
    const long long at = lo + (len * (lane + 1)) / 32 - 1;
    const int c = __popc(__ballot_sync(0xffffffffu, pred(at)));
    const long long new_lo = c > 0 ? lo + (len * c) / 32 : lo;
    if (c < 32) hi = lo + (len * (c + 1)) / 32 - 1;
    lo = new_lo;
  }
  const long long at = lo + lane;
  return lo + __popc(__ballot_sync(0xffffffffu, at < hi && pred(at)));
}

// Warps 0 and 1 of a block over merge-path items [d0, d1) write the
// number of probe-row ends before d0 and before d1 into s_split[0] and
// s_split[1], and return it to their lanes (-1 to the other warps): end r
// comes before item d when r + offsets[r + 1] < d.
__device__ __forceinline__ long long ex_split(
    const long long* __restrict__ offsets, long long n, long long total,
    long long d0, long long d1, long long* s_split) {
  const int warp = threadIdx.x >> 5;
  if (warp >= 2) return -1;
  const long long d = warp == 0 ? d0 : d1;
  const long long a = d - total > 0 ? d - total : 0;
  const long long z = d < n ? d : n;
  const long long r = warp_search(
      a, z, [&](long long r) { return r + offsets[r + 1] < d; });
  if ((threadIdx.x & 31) == 0) s_split[warp] = r;
  return r;
}

// pi[j] = the probe row of output j, bi[j] = b_perm[lo + (j - offsets[pi])]
// or -1 where lo is -1.
template <typename PI>
__global__ void __launch_bounds__(EX_THREADS)
ex_expand(const long long* __restrict__ offsets, const int* __restrict__ lo,
          const int* __restrict__ b_perm, long long n, long long total,
          PI* __restrict__ pi, int* __restrict__ bi) {
  __shared__ long long s_off[EX_TILE + 1];  // offsets[r0 .. r1]
  __shared__ int s_lo[EX_TILE + 1];         // lo[r0 .. r1] (r < n)
  __shared__ long long s_split[2];
  const int t = threadIdx.x;
  const long long items = total + n;
  const long long d0 = (long long)blockIdx.x * EX_TILE;
  const long long d1 = d0 + EX_TILE < items ? d0 + EX_TILE : items;
  ex_split(offsets, n, total, d0, d1, s_split);
  __syncthreads();
  const long long r0 = s_split[0], r1 = s_split[1];
  const long long j0 = d0 - r0, j1 = d1 - r1;
  const int rows = (int)(r1 - r0);
  for (int k = t; k <= rows; k += EX_THREADS) {
    s_off[k] = offsets[r0 + k];
    s_lo[k] = r0 + k < n ? lo[r0 + k] : -1;
  }
  __syncthreads();
  for (long long j = j0 + t; j < j1; j += EX_THREADS) {
    int a = 1, z = rows + 1;  // ends s_off[1..rows] at or below j
    while (a < z) {
      const int mid = (a + z) >> 1;
      if (s_off[mid] <= j) a = mid + 1; else z = mid;
    }
    const int k = a - 1;  // output j belongs to probe row r0 + k
    const int l = s_lo[k];
    pi[j] = (PI)(r0 + k);
    bi[j] = l < 0 ? -1 : b_perm[l + (j - s_off[k])];
  }
}

// offsets: [n + 1] int64 running counts, total = offsets[n]; lo: int32
// [n]; pi: [total] of PI, bi: int32 [total].
template <typename PI>
static cudaError_t ex_expand_launch(const void* offsets, const void* lo,
                                    const void* b_perm, long long n,
                                    long long total, void* pi, void* bi,
                                    cudaStream_t stream) {
  if (total == 0) return cudaSuccess;
  const long long tiles = (total + n + EX_TILE - 1) / EX_TILE;
  ex_expand<PI><<<(unsigned)tiles, EX_THREADS, 0, stream>>>(
      static_cast<const long long*>(offsets), static_cast<const int*>(lo),
      static_cast<const int*>(b_perm), n, total, static_cast<PI*>(pi),
      static_cast<int*>(bi));
  return cudaGetLastError();
}
