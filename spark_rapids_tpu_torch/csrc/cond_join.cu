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
//                b_perm[lo[p] + (j - offsets[p])]: expand.cuh's merge path
//                by output row (shared with csr_join.cu's csr_expand), with
//                int32 pi.
//   cond_counts  the surviving pairs (keep) counted per probe row over its
//                range of pairs, and per build row.  The same merge path:
//                a block takes EX_TILE items of pairs and probe-row ends,
//                reads its pairs' keep bytes in 16-byte words into a mask
//                and a prefix count a word in shared memory, and stores
//                the count of every probe row whose end it holds, once: no
//                atomic and no zero fill.  Offsets of those rows are staged
//                in shared memory beside the keep words.  Its first row
//                began in an earlier tile: within CC_NEAR pairs, the block
//                reads those pairs too; further back (a hot key), it adds
//                them by a deterministic decoupled look-back: a tile that
//                holds a row end publishes its open row's kept pairs as a
//                prefix (P) at once, a tile inside one row its kept pairs
//                as an aggregate (A); the block that ends the row sums A
//                words back to the nearest P, 32 tiles a step.  Tickets
//                order the tiles, and one memset a call clears the status
//                words and the ticket.  The per-build counts (right and
//                full joins) take one atomic per kept pair into a zeroed
//                bcount; a build row is hit once per candidate of its key,
//                so contention is low.  Semi, anti and existence joins
//                pass no build counts and skip those atomics and bi.
//   cross_pairs  pi = j / n_r and bi = j % n_r for j < n_l * n_r, grid
//                stride.
//
// Bound: device memory.  cond_expand reads the probe's offsets and lo
// (12 B a probe row) and b_perm at each pair's build position, and writes
// 8 B a pair; cond_counts reads 1 B a pair and 8 B a probe row, and
// writes 4 B a probe row (and reads 4 B a kept pair and adds into a build
// row's count); cross_pairs writes 8 B a pair.  Every index is int32 (the
// wrappers refuse sides or pair counts of 2^31 or more, so nothing wraps).

#include <cuda_runtime.h>
#include <stdint.h>

#include "expand.cuh"

#define CJ_THREADS 256
#define CC_NEAR 1024  // a first row that began this near is read whole
#define CC_WORDS ((EX_TILE + CC_NEAR) / 16 + 3)  // keep words read, + 1
#define CC_FLAG_AGG 1ull
#define CC_FLAG_INC 2ull
#define CC_VALUE_MASK ((1ull << 62) - 1ull)

// The kept pairs before tile `tile` back to the nearest row end: warp 0
// reads 32 earlier tiles' words at once (lane l: tile - 1 - l), waits
// until all are published, adds the aggregates (A) up to the nearest
// prefix (P, whose value it adds and stops at) or past tile 0.
__device__ __forceinline__ long long cc_look_back(
    const unsigned long long* status, long long tile) {
  const int lane = threadIdx.x & 31;
  long long before = 0;
  for (long long j = tile - 1; j >= 0;) {
    const long long at = j - lane;
    const unsigned long long w =
        at >= 0 ? *(volatile const unsigned long long*)(status + at)
                : CC_FLAG_INC << 62;
    if (__any_sync(0xffffffffu, (w >> 62) == 0ull)) continue;
    const unsigned inc = __ballot_sync(0xffffffffu, (w >> 62) == CC_FLAG_INC);
    const int last = inc ? __ffs(inc) - 1 : 31;
    long long v = lane <= last ? (long long)(w & CC_VALUE_MASK) : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    before += v;
    if (inc) break;
    j -= 32;
  }
  return before;
}

__global__ void __launch_bounds__(EX_THREADS)
cc_counts(const uint8_t* __restrict__ keep,
          const long long* __restrict__ offsets, const int* __restrict__ bi,
          long long n, long long total, int* __restrict__ pcount,
          int* __restrict__ bcount, unsigned long long* status,
          unsigned* __restrict__ ticket) {
  __shared__ long long s_off[EX_TILE + 1];      // offsets[r0 .. r1]
  __shared__ long long s_split[2];
  __shared__ long long s_first;                 // offsets[r0]
  __shared__ unsigned short s_mask[CC_WORDS];   // kept bytes of each word
  __shared__ int s_pre[CC_WORDS];               // kept pairs before it
  __shared__ int s_warp[EX_THREADS / 32];
  __shared__ long long s_carry;
  __shared__ unsigned s_tile;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (t == 0) s_tile = atomicAdd(ticket, 1u);
  __syncthreads();
  const long long tile = s_tile;
  const long long items = total + n;
  const long long d0 = tile * EX_TILE;
  const long long d1 = d0 + EX_TILE < items ? d0 + EX_TILE : items;
  const long long split = ex_split(offsets, n, total, d0, d1, s_split);
  if (warp == 0 && lane == 0) s_first = offsets[split];
  __syncthreads();
  const long long r0 = s_split[0], r1 = s_split[1];
  const long long j0 = d0 - r0, j1 = d1 - r1;
  const int rows = (int)(r1 - r0);
  // the pairs read: from the first row's start when it began at most
  // CC_NEAR pairs before the tile (its count is then the block's alone),
  // else from j0 (its earlier pairs by the look-back)
  const bool near = j0 - s_first <= CC_NEAR;
  const long long k0 = near ? s_first : j0;
  // [k0, j1) in 16-byte words aligned in memory: word w holds pairs
  // a0 + 16 w .. a0 + 16 w + 15 (bytes outside [k0, j1) masked out; an
  // aligned word never crosses a page)
  const long long a0 = k0 - (long long)(((uintptr_t)keep + k0) & 15);
  const int words = j1 > k0 ? (int)((j1 - a0 + 15) >> 4) : 0;
  uint4 w = make_uint4(0, 0, 0, 0);
  if (t < words) w = *reinterpret_cast<const uint4*>(keep + a0 + 16LL * t);
  for (int k = t; k <= rows; k += EX_THREADS) s_off[k] = offsets[r0 + k];
  unsigned mask = 0;
  if (t < words) {
    const long long c0 = a0 + 16LL * t;
    const unsigned part[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if ((part[k] >> (8 * b)) & 0xffu) mask |= 1u << (4 * k + b);
    if (k0 > c0) mask &= ~((1u << (int)(k0 - c0)) - 1u);
    if (j1 - c0 < 16) mask &= (1u << (int)(j1 - c0)) - 1u;
  }
  // exclusive scan of the words' counts over the block
  const int cnt = __popc(mask);
  int incl = cnt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += u;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  int before_warp = 0, all = 0;
#pragma unroll
  for (int v = 0; v < EX_THREADS / 32; ++v) {
    if (v < warp) before_warp += s_warp[v];
    all += s_warp[v];
  }
  if (t < words) {
    s_mask[t] = (unsigned short)mask;
    s_pre[t] = before_warp + incl - cnt;
  }
  if (t == words) {  // the word past the last
    s_mask[t] = 0;
    s_pre[t] = all;
  }
  __syncthreads();
  // kept pairs in [k0, x), k0 <= x <= j1
  auto kept_before = [&](long long x) {
    const long long o = x - a0;
    const int c = (int)(o >> 4), b = (int)(o & 15);
    return s_pre[c] + __popc((unsigned)s_mask[c] & ((1u << b) - 1u));
  };
  const bool has_end = rows > 0;
  // publish: a tile with a row end, its open row's kept pairs (P); a tile
  // inside one row, its kept pairs (A)
  if (t == 0) {
    const long long open = has_end ? all - kept_before(s_off[rows])
                                   : all - kept_before(j0);
    *(volatile unsigned long long*)(status + tile) =
        ((has_end || tile == 0 ? CC_FLAG_INC : CC_FLAG_AGG) << 62) |
        (unsigned long long)open;
  }
  // the first row's pairs before a far start, by the look-back
  const bool carried = has_end && !near;
  if (warp == 0 && carried) {
    const long long v = cc_look_back(status, tile);
    if (lane == 0) s_carry = v;
  }
  __syncthreads();
  for (int k = t; k < rows; k += EX_THREADS) {
    const long long start = s_off[k];
    long long c = kept_before(s_off[k + 1]);
    if (start >= k0) c -= kept_before(start);
    else c += s_carry;  // k == 0: the row began far before the tile
    pcount[r0 + k] = (int)c;
  }
  if (bcount != nullptr) {
    for (long long j = j0 + t; j < j1; j += EX_THREADS) {
      const long long o = j - a0;
      if ((s_mask[o >> 4] >> (o & 15)) & 1u) atomicAdd(bcount + bi[j], 1);
    }
  }
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
  return (int)ex_expand_launch<int>(offsets, lo, b_perm, n, total, pi, bi,
                                    (cudaStream_t)stream);
}

static long long cc_tiles(long long n, long long total) {
  return (n + total + EX_TILE - 1) / EX_TILE;
}

// Bytes of cond_counts' scratch: a status word a tile and the ticket.
extern "C" long long cond_counts_scratch(long long n, long long total) {
  return 8 * cc_tiles(n, total) + 8;
}

// keep: bool [total]; offsets: int64 [n + 1] (total = offsets[n]); bi:
// int32 [total] (read only with bcount); pcount: int32 [n], every entry
// written; bcount: int32 [n_build], zeroed by the caller, or nullptr;
// scratch: cond_counts_scratch(n, total) bytes, cleared here.
extern "C" int cond_counts(const void* keep, const void* offsets,
                           const void* bi, long long n, long long total,
                           void* pcount, void* bcount, void* scratch,
                           long long scratch_bytes, void* stream) {
  if (n < 0 || total < 0 || total >= (1LL << 31) || (total > 0 && n == 0) ||
      scratch_bytes < cond_counts_scratch(n, total))
    return (int)cudaErrorInvalidValue;
  const long long tiles = cc_tiles(n, total);
  if (tiles == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(scratch, 0, 8 * tiles + 8, st);
  if (err != cudaSuccess) return (int)err;
  unsigned long long* status = static_cast<unsigned long long*>(scratch);
  cc_counts<<<(unsigned)tiles, EX_THREADS, 0, st>>>(
      (const uint8_t*)keep, (const long long*)offsets, (const int*)bi, n,
      total, (int*)pcount, (int*)bcount, status,
      reinterpret_cast<unsigned*>(status + tiles));
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
