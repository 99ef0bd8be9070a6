// dense_join: the dense direct-address broadcast join — build-key stats, a
// key -> build-row table, and the probe with its payload gathers.
//
// Replaces: spark_rapids_tpu/plan/join_exec.py:1200 _dense_prefetch (the
// build-key stats program, duplicate count included), :1353
// _dense_build_state_impl (the int32 table key - kmin -> build row) and
// :1410 _dense_join_pair (the probe: table lookup, the inner, semi, anti
// and left outer selections, payload gathers), for joins on one integral
// key.
//
// Three entry points, one per phase:
//   dense_join_stats  min, max, count and duplicate count of the live,
//                     valid build keys.  A first kernel reduces min, max
//                     and count (block reduction, one atomic per block); a
//                     second marks a bitmap of `cap` bits at key - kmin,
//                     reading kmin from the first kernel's output in device
//                     memory, and counts the keys whose bit was already set
//                     (atomicOr returns the old word).  The reference finds
//                     duplicates with a device sort inside its stats
//                     program; here the count is exact whenever the domain
//                     fits `cap` (the only case the dense and CSR paths
//                     take) and rides the same single fetch, which decides
//                     between the dense table and the CSR path;
//   dense_join_build  the direct table: one thread per live build row
//                     claims table[key - kmin] with atomicCAS from -1 (keys
//                     are unique here);
//   dense_join_build_sparse
//                     the sparse layout (below) in three launches;
//   dense_join_probe  per probe row: the live mask, the key's validity, the
//                     domain test and the lookup in either layout, then the
//                     output selection byte for the join type (inner:
//                     matched; semi: matched; anti: live and unmatched;
//                     left: live) and every payload column's data and
//                     validity gathered from the matched build row (a left
//                     join's misses are null) -- one launch, no index
//                     tensor written out.
//
// Bound: device memory, and the latency of the dependent reads a probe row
// makes.  A probe row reads its 1 B mask and its key (8 B), then a table
// entry at a random address, and for each matched row one random sector of
// each payload column; it writes the selection byte and each payload
// element.  At TPC-H Q3's second join (15,003,036 slots, 9.7% live) a
// direct table is 60 MB, larger than the 50 MB L2, so each live probe row
// reads a random DRAM sector whether its slot is live or not; and the
// row's reads are serial (mask -> key -> table -> payload -> stores).
// tools/dense_probe_bench.cu times the probe before this design in
// variants that leave one part out (PERF.md §6).  The design:
//
//   * several rows a thread (DJ_ROWS): the mask (one word) and the keys
//     (16-byte loads) of its rows arrive together, every table lookup
//     of the rows is issued before the first is used, then every matched
//     row's payload gathers of a column together; the selection and each
//     payload column leave as vector stores.  Views at an odd
//     storage offset and the ragged last rows take a scalar path;
//   * element sizes fixed per launch: the host groups the payload columns
//     by width (8, 4, 2, 1 bytes) and the kernel runs one loop per width,
//     each compiled for its size: no per-element switch;
//   * a sparse layout that stays in L2 (the probe's SPARSE form): where
//     the live build is sparse in a domain whose direct table would not
//     fit in L2, the build writes one 32-byte block per 224 slots -- a
//     rank word (the live slots before the block) and 7 bitmap words --
//     and the live build rows compacted in slot order (int32).  At Q3
//     that is 2.1 MB + 5.8 MB instead of 60 MB.  A probe row reads its
//     bit word; on a set bit its block (the same sector: the rank and the
//     earlier bits) and the compact entry at rank + popcounts.  An
//     unmatched row never leaves L2.  ops/join.py
//     (dense_layout) picks the layout on the host from the count, kmin and
//     kmax that the stats' one fetch already brings.  Building it takes
//     three launches a join: set the bits (and list the live rows' slots),
//     scan the blocks' popcounts into the rank words (a decoupled look-back
//     over 2,048-block tiles), place each listed row.
//
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>
#include <string.h>

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

// out[3] += the live valid keys whose bit in the `cap`-bit bitmap (zeroed
// by the caller) was set already; kmin is read from out[0].
__global__ void __launch_bounds__(DJ_THREADS)
dj_dup(const void* __restrict__ keys, int elem,
       const uint8_t* __restrict__ key_valid,
       const uint8_t* __restrict__ active, long long n, long long cap,
       unsigned int* __restrict__ bitmap, long long* __restrict__ out) {
  const long long kmin = out[0];
  long long dup = 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += stride) {
    if (!live(active, key_valid, r)) continue;
    long long idx;
    if (!in_domain(load_key(keys, elem, r), kmin, cap, &idx)) continue;
    const unsigned int bit = 1u << (idx & 31);
    if (atomicOr(bitmap + (idx >> 5), bit) & bit) ++dup;
  }
  for (int o = 16; o > 0; o >>= 1)
    dup += __shfl_down_sync(0xffffffffu, dup, o);
  __shared__ long long s_dup[DJ_THREADS / 32];
  if (threadIdx.x % 32 == 0) s_dup[threadIdx.x / 32] = dup;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < DJ_THREADS / 32; ++w) dup += s_dup[w];
    if (dup > 0)
      atomicAdd(reinterpret_cast<unsigned long long*>(out + 3),
                (unsigned long long)dup);
  }
}

// table: [D] int32 preset to -1.
__global__ void __launch_bounds__(DJ_THREADS)
dj_build(const void* __restrict__ keys, int elem,
         const uint8_t* __restrict__ key_valid,
         const uint8_t* __restrict__ active, long long n, long long kmin,
         long long D, int* __restrict__ table) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += stride) {
    if (!live(active, key_valid, r)) continue;
    long long idx;
    if (!in_domain(load_key(keys, elem, r), kmin, D, &idx)) continue;
    atomicCAS(table + idx, -1, (int)r);
  }
}

// ---------------------------------------------------------------------------
// the sparse layout
// ---------------------------------------------------------------------------

#define DJ_BLOCK_SLOTS 224   // slots a 32-byte block: a rank word, 7 bit words
#define DJ_RANK_THREADS 256
#define DJ_RANK_ITEMS 8
#define DJ_RANK_TILE (DJ_RANK_THREADS * DJ_RANK_ITEMS)
#define DJ_FLAG_AGG 1ull
#define DJ_FLAG_INC 2ull

// slot s of the sparse layout: its block, its bit word (1..7) and bit
__device__ __forceinline__ void sp_where(unsigned s, unsigned* b,
                                         unsigned* w, unsigned* bit) {
  *b = s / DJ_BLOCK_SLOTS;
  const unsigned r = s - *b * DJ_BLOCK_SLOTS;
  *w = 1u + (r >> 5);
  *bit = r & 31u;
}

// blk: zeroed [blocks * 8] words; sets the bit of each live valid key and
// appends (slot, row) to list (its count in *nlist, zeroed): the place
// pass then reads the live rows only.  A block takes DJ_BITS_ROUNDS rows
// a thread a step (coalesced, their loads in flight together) and makes
// one atomic add a step for its appends.
#define DJ_BITS_ROUNDS 8
__global__ void __launch_bounds__(DJ_THREADS)
dj_sp_bits(const void* __restrict__ keys, int elem,
           const uint8_t* __restrict__ key_valid,
           const uint8_t* __restrict__ active, long long n, long long kmin,
           long long D, unsigned* __restrict__ blk,
           unsigned long long* __restrict__ list,
           unsigned* __restrict__ nlist, long long cap) {
  __shared__ unsigned s_warp[DJ_THREADS / 32];
  __shared__ unsigned s_base;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long chunk = (long long)DJ_THREADS * DJ_BITS_ROUNDS;
  for (long long c0 = (long long)blockIdx.x * chunk; c0 < n;
       c0 += (long long)gridDim.x * chunk) {
    unsigned want = 0, slots[DJ_BITS_ROUNDS];
#pragma unroll
    for (int k = 0; k < DJ_BITS_ROUNDS; ++k) {
      const long long r = c0 + (long long)k * DJ_THREADS + threadIdx.x;
      long long idx = -1;
      if (r < n && live(active, key_valid, r) &&
          in_domain(load_key(keys, elem, r), kmin, D, &idx)) {
        want |= 1u << k;
        slots[k] = (unsigned)idx;
      }
    }
#pragma unroll
    for (int k = 0; k < DJ_BITS_ROUNDS; ++k) {
      if ((want >> k) & 1u) {
        unsigned b, w, bit;
        sp_where(slots[k], &b, &w, &bit);
        atomicOr(blk + (size_t)b * 8 + w, 1u << bit);
      }
    }
    // the block's appends: an exclusive scan of the threads' counts, one
    // atomic add for the block
    const unsigned cnt = __popc(want);
    unsigned incl = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned x = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += x;
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned total = 0;
      for (int w = 0; w < DJ_THREADS / 32; ++w) {
        const unsigned x = s_warp[w];
        s_warp[w] = total;
        total += x;
      }
      s_base = total ? atomicAdd(nlist, total) : 0u;
    }
    __syncthreads();
    long long at = (long long)s_base + s_warp[warp] + incl - cnt;
#pragma unroll
    for (int k = 0; k < DJ_BITS_ROUNDS; ++k) {
      if ((want >> k) & 1u) {
        if (at < cap)
          list[at] = ((unsigned long long)slots[k] << 32) |
                     (unsigned)(c0 + (long long)k * DJ_THREADS + threadIdx.x);
        ++at;
      }
    }
    __syncthreads();
  }
}

// The rank words: blk[8 b] = the set bits of blocks 0..b-1.  One tile of
// DJ_RANK_TILE blocks a block of threads, its number from an atomic counter
// (*ctr, zeroed); status[t] (zeroed) publishes the tile's count (flag A)
// and then its inclusive prefix (flag P); a tile adds earlier tiles' words
// back to the first P.  Counts are integers: the order of the adds is free.
__global__ void __launch_bounds__(DJ_RANK_THREADS)
dj_sp_rank(unsigned* __restrict__ blk, long long nblocks,
           unsigned long long* status, unsigned* __restrict__ ctr) {
  __shared__ unsigned s_tile, s_warp[DJ_RANK_THREADS / 32];
  __shared__ unsigned long long s_before;
  if (threadIdx.x == 0) s_tile = atomicAdd(ctr, 1u);
  __syncthreads();
  const long long tile = s_tile;
  const long long b0 = tile * DJ_RANK_TILE + (long long)threadIdx.x *
                       DJ_RANK_ITEMS;
  unsigned cnt[DJ_RANK_ITEMS], sum = 0;
#pragma unroll
  for (int u = 0; u < DJ_RANK_ITEMS; ++u) {
    cnt[u] = 0;
    if (b0 + u < nblocks) {
      const uint4* q = reinterpret_cast<const uint4*>(blk + (b0 + u) * 8);
      const uint4 x = q[0], y = q[1];
      cnt[u] = __popc(x.y) + __popc(x.z) + __popc(x.w) + __popc(y.x) +
               __popc(y.y) + __popc(y.z) + __popc(y.w);
    }
    sum += cnt[u];
  }
  // exclusive scan of the threads' sums
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  unsigned before = 0, total = 0;
  for (int w = 0; w < DJ_RANK_THREADS / 32; ++w) {
    if (w < warp) before += s_warp[w];
    total += s_warp[w];
  }
  before += incl - sum;
  if (threadIdx.x == 0) {
    volatile unsigned long long* mine = status + tile;
    *mine = ((tile == 0 ? DJ_FLAG_INC : DJ_FLAG_AGG) << 62) | total;
    unsigned long long acc = 0;
    for (long long j = tile - 1; j >= 0;) {
      const unsigned long long w =
          *(volatile const unsigned long long*)(status + j);
      if (w == 0) continue;  // not yet published
      acc += w & ((1ull << 62) - 1);
      if ((w >> 62) == DJ_FLAG_INC) break;
      --j;
    }
    if (tile > 0) *mine = (DJ_FLAG_INC << 62) | (acc + total);
    s_before = acc;
  }
  __syncthreads();
  unsigned run = (unsigned)s_before + before;
#pragma unroll
  for (int u = 0; u < DJ_RANK_ITEMS; ++u) {
    if (b0 + u < nblocks) blk[(b0 + u) * 8] = run;
    run += cnt[u];
  }
}

// A slot's 32-byte block: its rank word and 7 bit words.
__device__ __forceinline__ void sp_block(const unsigned* __restrict__ blk,
                                         unsigned b, unsigned (&ws)[8]) {
  const uint4* q = reinterpret_cast<const uint4*>(blk + (size_t)b * 8);
  const uint4 x = __ldg(q), y = __ldg(q + 1);
  ws[0] = x.x; ws[1] = x.y; ws[2] = x.z; ws[3] = x.w;
  ws[4] = y.x; ws[5] = y.y; ws[6] = y.z; ws[7] = y.w;
}

// The position of slot (w, bit) of a block in the compact rows, or -1
// where its bit is clear: the block's rank plus the set bits before it
// (words 1..w-1 and below bit in w).
__device__ __forceinline__ unsigned sp_pos(const unsigned (&ws)[8],
                                           unsigned w, unsigned bit) {
  unsigned word = ws[1];
#pragma unroll
  for (unsigned j = 2; j < 8; ++j)
    if (j == w) word = ws[j];
  if (!((word >> bit) & 1u)) return 0xffffffffu;
  unsigned pos = ws[0] + __popc(word & ((1u << bit) - 1u));
#pragma unroll
  for (unsigned j = 1; j < 7; ++j)
    if (j < w) pos += __popc(ws[j]);
  return pos;
}

// rows[pos] = the build row of each (slot, row) of the list (cap entries)
__global__ void __launch_bounds__(DJ_THREADS)
dj_sp_place(const unsigned long long* __restrict__ list,
            const unsigned* __restrict__ nlist,
            const unsigned* __restrict__ blk, int* __restrict__ rows,
            long long cap) {
  const long long n = *nlist < cap ? *nlist : cap;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const unsigned long long e = list[i];
    unsigned b, w, bit, ws[8];
    sp_where((unsigned)(e >> 32), &b, &w, &bit);
    sp_block(blk, b, ws);
    const unsigned pos = sp_pos(ws, w, bit);
    if (pos < cap) rows[pos] = (int)(unsigned)e;
  }
}

// ---------------------------------------------------------------------------
// the probe
// ---------------------------------------------------------------------------

// join types of dense_join_probe
#define DJ_INNER 0
#define DJ_SEMI 1
#define DJ_ANTI 2
#define DJ_LEFT 3

#define DJ_ROWS 4          // rows a thread a step
#define DJ_PROBE_PER_SM 8  // probe blocks an SM in the grid

// Payload columns grouped by element size: columns [start[e], start[e+1])
// have 8, 4, 2 and 1-byte elements for e = 0..3.
struct DJPayload {
  const void* data[DJ_MAX_COLS];
  const uint8_t* valid[DJ_MAX_COLS];  // nullptr: the build column has no nulls
  void* out[DJ_MAX_COLS];
  uint8_t* out_valid[DJ_MAX_COLS];    // nullptr: no output validity (inner
                                      // join of a column without nulls)
  int start[5];
};

template <int E> struct DJElem;
template <> struct DJElem<8> { typedef unsigned long long T; };
template <> struct DJElem<4> { typedef unsigned T; };
template <> struct DJElem<2> { typedef unsigned short T; };
template <> struct DJElem<1> { typedef uint8_t T; };

// DJ_ROWS elements from/to an address aligned to their size (16 bytes at
// most): 16-byte accesses, or one access of 2, 4 or 8 bytes.
template <int B> struct DJWord;
template <> struct DJWord<2> { typedef unsigned short T; };
template <> struct DJWord<4> { typedef unsigned T; };
template <> struct DJWord<8> { typedef uint2 T; };

__host__ __device__ constexpr int dj_align(int bytes) {
  return bytes < 16 ? bytes : 16;
}

template <typename T>
__device__ __forceinline__ void vec_load(const T* __restrict__ p,
                                         T (&v)[DJ_ROWS]) {
  constexpr int B = (int)sizeof(T) * DJ_ROWS;
  unsigned char b[B];
  if constexpr (B >= 16) {
#pragma unroll
    for (int i = 0; i < B / 16; ++i) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(p) + i);
      memcpy(b + 16 * i, &q, 16);
    }
  } else {
    typedef typename DJWord<B>::T W;
    const W w = __ldg(reinterpret_cast<const W*>(p));
    memcpy(b, &w, B);
  }
#pragma unroll
  for (int i = 0; i < DJ_ROWS; ++i)
    memcpy(&v[i], b + i * sizeof(T), sizeof(T));
}

template <typename T>
__device__ __forceinline__ void vec_store(T* __restrict__ p,
                                          const T (&v)[DJ_ROWS]) {
  constexpr int B = (int)sizeof(T) * DJ_ROWS;
  unsigned char b[B];
#pragma unroll
  for (int i = 0; i < DJ_ROWS; ++i)
    memcpy(b + i * sizeof(T), &v[i], sizeof(T));
  if constexpr (B >= 16) {
#pragma unroll
    for (int i = 0; i < B / 16; ++i) {
      uint4 q;
      memcpy(&q, b + 16 * i, 16);
      reinterpret_cast<uint4*>(p)[i] = q;
    }
  } else {
    typedef typename DJWord<B>::T W;
    W w;
    memcpy(&w, b, B);
    *reinterpret_cast<W*>(p) = w;
  }
}

// The E-byte payload columns [j0, j1): each matched row's element (0 for
// a miss) and, where the output has validity, matched && the build row's.
template <int E>
__device__ __forceinline__ void gather_width(const DJPayload& p, int j0,
                                             int j1, const int (&bi)[DJ_ROWS],
                                             long long r0, int rows,
                                             bool full) {
  typedef typename DJElem<E>::T T;
  for (int j = j0; j < j1; ++j) {
    const T* __restrict__ src = static_cast<const T*>(p.data[j]);
    T* __restrict__ dst = static_cast<T*>(p.out[j]) + r0;
    T v[DJ_ROWS];
#pragma unroll
    for (int u = 0; u < DJ_ROWS; ++u)
      v[u] = bi[u] >= 0 ? __ldg(src + bi[u]) : (T)0;
    if (full) {
      vec_store<T>(dst, v);
    } else {
#pragma unroll
      for (int u = 0; u < DJ_ROWS; ++u)
        if (u < rows) dst[u] = v[u];
    }
    uint8_t* ov = p.out_valid[j];
    if (ov != nullptr) {
      const uint8_t* __restrict__ bv = p.valid[j];
      uint8_t o[DJ_ROWS];
#pragma unroll
      for (int u = 0; u < DJ_ROWS; ++u)
        o[u] = bi[u] >= 0 && (bv == nullptr || __ldg(bv + bi[u]));
      if (full) {
        vec_store<uint8_t>(ov + r0, o);
      } else {
#pragma unroll
        for (int u = 0; u < DJ_ROWS; ++u)
          if (u < rows) ov[r0 + u] = o[u];
      }
    }
  }
}

// One launch: DJ_ROWS rows a thread a grid-stride step.  SPARSE reads the
// sparse layout (blk, rows), else the direct table; K is the key type.
// vec: every input and output allows the 16-byte (8-byte for bytes)
// accesses of a full group of rows.
template <bool SPARSE, typename K>
__global__ void __launch_bounds__(DJ_THREADS)
dj_probe(const __grid_constant__ DJPayload p, const K* __restrict__ keys,
         const uint8_t* __restrict__ key_valid,
         const uint8_t* __restrict__ active, long long n, long long kmin,
         long long D, const int* __restrict__ table,
         const unsigned* __restrict__ blk, const int* __restrict__ brows,
         int mode, int vec, uint8_t* __restrict__ out_sel) {
  const long long groups = (n + DJ_ROWS - 1) / DJ_ROWS;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       g < groups; g += stride) {
    const long long r0 = g * DJ_ROWS;
    const int rows = n - r0 < DJ_ROWS ? (int)(n - r0) : DJ_ROWS;
    const bool full = vec && rows == DJ_ROWS;
    K k[DJ_ROWS];
    uint8_t a[DJ_ROWS], kv[DJ_ROWS];
    if (full) {
      vec_load<K>(keys + r0, k);
      if (active != nullptr) vec_load<uint8_t>(active + r0, a);
      if (key_valid != nullptr) vec_load<uint8_t>(key_valid + r0, kv);
    } else {
#pragma unroll
      for (int u = 0; u < DJ_ROWS; ++u) {
        const bool in = u < rows;
        k[u] = in ? keys[r0 + u] : (K)0;
        a[u] = in && (active == nullptr || active[r0 + u]);
        kv[u] = in && (key_valid == nullptr || key_valid[r0 + u]);
      }
    }
    if (active == nullptr && full) {
#pragma unroll
      for (int u = 0; u < DJ_ROWS; ++u) a[u] = 1;
    }
    if (key_valid == nullptr && full) {
#pragma unroll
      for (int u = 0; u < DJ_ROWS; ++u) kv[u] = 1;
    }
    // every lookup of the rows issued before the first is used
    int bi[DJ_ROWS];
    unsigned slot[DJ_ROWS];
#pragma unroll
    for (int u = 0; u < DJ_ROWS; ++u) {
      long long idx = -1;
      const bool ok = a[u] && kv[u] &&
                      in_domain((long long)k[u], kmin, D, &idx);
      slot[u] = ok ? (unsigned)idx : 0xffffffffu;
    }
    if (!SPARSE) {
#pragma unroll
      for (int u = 0; u < DJ_ROWS; ++u)
        bi[u] = slot[u] != 0xffffffffu ? __ldg(table + slot[u]) : -1;
    } else {
      // each row's bit word; the block (the same sector) only where the
      // bit is set
      unsigned word[DJ_ROWS];
#pragma unroll
      for (int u = 0; u < DJ_ROWS; ++u) {
        word[u] = 0;
        if (slot[u] != 0xffffffffu) {
          unsigned b, w, bit;
          sp_where(slot[u], &b, &w, &bit);
          word[u] = __ldg(blk + (size_t)b * 8 + w);
        }
      }
      unsigned pos[DJ_ROWS];
#pragma unroll
      for (int u = 0; u < DJ_ROWS; ++u) {
        pos[u] = 0xffffffffu;
        unsigned b, w, bit;
        sp_where(slot[u], &b, &w, &bit);
        if (slot[u] != 0xffffffffu && ((word[u] >> bit) & 1u)) {
          unsigned ws[8];
          sp_block(blk, b, ws);
          pos[u] = sp_pos(ws, w, bit);
        }
      }
#pragma unroll
      for (int u = 0; u < DJ_ROWS; ++u)
        bi[u] = pos[u] != 0xffffffffu ? __ldg(brows + pos[u]) : -1;
    }
    uint8_t sel[DJ_ROWS];
#pragma unroll
    for (int u = 0; u < DJ_ROWS; ++u) {
      const bool matched = bi[u] >= 0;
      sel[u] = mode == DJ_ANTI ? (a[u] && !matched)
               : mode == DJ_LEFT ? a[u] : matched;
    }
    if (full) {
      vec_store<uint8_t>(out_sel + r0, sel);
    } else {
#pragma unroll
      for (int u = 0; u < DJ_ROWS; ++u)
        if (u < rows) out_sel[r0 + u] = sel[u];
    }
    gather_width<8>(p, p.start[0], p.start[1], bi, r0, rows, full);
    gather_width<4>(p, p.start[1], p.start[2], bi, r0, rows, full);
    gather_width<2>(p, p.start[2], p.start[3], bi, r0, rows, full);
    gather_width<1>(p, p.start[3], p.start[4], bi, r0, rows, full);
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
// out: [min, max, count, dup], preset to INT64_MAX, INT64_MIN, 0, 0;
// bitmap: ceil(cap / 32) zeroed words.
extern "C" int dense_join_stats(const void* keys, int elem,
                                const void* key_valid, const void* active,
                                long long n, long long cap, void* bitmap,
                                void* out, void* stream) {
  if ((elem != 4 && elem != 8) || cap < 1) return (int)cudaErrorInvalidValue;
  int blocks = 1;
  cudaError_t err = grid_for(n, &blocks, 8);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dj_stats<<<blocks, DJ_THREADS, 0, s>>>(
      keys, elem, static_cast<const uint8_t*>(key_valid),
      static_cast<const uint8_t*>(active), n, static_cast<long long*>(out));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dj_dup<<<blocks, DJ_THREADS, 0, s>>>(
      keys, elem, static_cast<const uint8_t*>(key_valid),
      static_cast<const uint8_t*>(active), n, cap,
      static_cast<unsigned int*>(bitmap), static_cast<long long*>(out));
  return (int)cudaGetLastError();
}

extern "C" int dense_join_build(const void* keys, int elem,
                                const void* key_valid, const void* active,
                                long long n, long long kmin, long long D,
                                void* table, void* stream) {
  if ((elem != 4 && elem != 8) || n > INT_MAX || D < 1)
    return (int)cudaErrorInvalidValue;
  int blocks = 1;
  cudaError_t err = grid_for(n, &blocks, 8);
  if (err != cudaSuccess) return (int)err;
  dj_build<<<blocks, DJ_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      keys, elem, static_cast<const uint8_t*>(key_valid),
      static_cast<const uint8_t*>(active), n, kmin, D,
      static_cast<int*>(table));
  return (int)cudaGetLastError();
}

// The sparse layout of D slots: blk [ceil(D / 224) * 8] words, then
// `tiles` = ceil(blocks / 2048) 8-byte status words and two counter
// words, all zeroed by the caller; rows [cap] int32; list [cap] 8-byte
// scratch (cap: the live valid keys).  Three launches.
extern "C" int dense_join_build_sparse(const void* keys, int elem,
                                       const void* key_valid,
                                       const void* active, long long n,
                                       long long kmin, long long D,
                                       void* blk, void* status, void* ctr,
                                       void* rows, void* list, long long cap,
                                       void* stream) {
  if ((elem != 4 && elem != 8) || n > INT_MAX || D < 1 || D > UINT_MAX / 2
      || cap < 0)
    return (int)cudaErrorInvalidValue;
  const long long nblocks = (D + DJ_BLOCK_SLOTS - 1) / DJ_BLOCK_SLOTS;
  const long long tiles = (nblocks + DJ_RANK_TILE - 1) / DJ_RANK_TILE;
  int blocks = 1, place = 1;
  cudaError_t err = grid_for(n, &blocks, 8);
  if (err == cudaSuccess) err = grid_for(cap, &place, 8);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned* b = static_cast<unsigned*>(blk);
  unsigned* c = static_cast<unsigned*>(ctr);  // the tile counter, the list's
  unsigned long long* l = static_cast<unsigned long long*>(list);
  if (n > 0 && cap > 0) {
    dj_sp_bits<<<blocks, DJ_THREADS, 0, s>>>(
        keys, elem, static_cast<const uint8_t*>(key_valid),
        static_cast<const uint8_t*>(active), n, kmin, D, b, l, c + 1, cap);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  dj_sp_rank<<<(unsigned)tiles, DJ_RANK_THREADS, 0, s>>>(
      b, nblocks, static_cast<unsigned long long*>(status), c);
  err = cudaGetLastError();
  if (err != cudaSuccess || n == 0 || cap == 0) return (int)err;
  dj_sp_place<<<place, DJ_THREADS, 0, s>>>(l, c + 1, b,
                                           static_cast<int*>(rows), cap);
  return (int)cudaGetLastError();
}

static bool aligned(const void* p, int bytes) {
  return ((uintptr_t)p & (uintptr_t)(bytes - 1)) == 0;
}

// table: the direct table [D] int32, or nullptr with blk and rows the
// sparse layout.  Payload columns in any order; the host entry groups
// them by element size.
extern "C" int dense_join_probe(const void* keys, int elem,
                                const void* key_valid, const void* active,
                                long long n, long long kmin, long long D,
                                const void* table, const void* blk,
                                const void* rows, int mode, int ncols,
                                const void* const* data,
                                const void* const* valid,
                                const int* elems, void* const* out,
                                void* const* out_valid, void* out_sel,
                                void* stream) {
  if ((elem != 4 && elem != 8) || ncols < 0 || ncols > DJ_MAX_COLS || D < 1
      || D > UINT_MAX / 2 || mode < DJ_INNER || mode > DJ_LEFT
      || ((mode == DJ_SEMI || mode == DJ_ANTI) && ncols > 0)
      || (table == nullptr && (blk == nullptr || rows == nullptr)))
    return (int)cudaErrorInvalidValue;
  DJPayload p = {};
  // one or more vector accesses a group of rows: each array aligned to
  // its group's bytes (16 at most)
  int vec = aligned(keys, dj_align(elem * DJ_ROWS)) &&
            aligned(key_valid, dj_align(DJ_ROWS)) &&
            aligned(active, dj_align(DJ_ROWS)) &&
            aligned(out_sel, dj_align(DJ_ROWS));
  int at = 0;
  const int widths[4] = {8, 4, 2, 1};
  for (int w = 0; w < 4; ++w) {
    p.start[w] = at;
    for (int j = 0; j < ncols; ++j) {
      const int e = elems[j];
      if (e != 1 && e != 2 && e != 4 && e != 8)
        return (int)cudaErrorInvalidValue;
      if (e != widths[w]) continue;
      // an inner join keeps a column's validity exactly where it has one;
      // a left join's misses make every gathered column nullable
      if (mode == DJ_LEFT ? out_valid[j] == nullptr
                          : (valid[j] == nullptr) != (out_valid[j] == nullptr))
        return (int)cudaErrorInvalidValue;
      p.data[at] = data[j];
      p.valid[at] = static_cast<const uint8_t*>(valid[j]);
      p.out[at] = out[j];
      p.out_valid[at] = static_cast<uint8_t*>(out_valid[j]);
      vec = vec && aligned(out[j], dj_align(e * DJ_ROWS)) &&
            aligned(out_valid[j], dj_align(DJ_ROWS));
      ++at;
    }
  }
  p.start[4] = at;
  if (n == 0) return (int)cudaSuccess;
  int blocks = 1;
  cudaError_t err = grid_for((n + DJ_ROWS - 1) / DJ_ROWS, &blocks,
                             DJ_PROBE_PER_SM);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* kv = static_cast<const uint8_t*>(key_valid);
  const uint8_t* ac = static_cast<const uint8_t*>(active);
  const int* t = static_cast<const int*>(table);
  const unsigned* bl = static_cast<const unsigned*>(blk);
  const int* br = static_cast<const int*>(rows);
  uint8_t* sel = static_cast<uint8_t*>(out_sel);
  if (elem == 8) {
    const long long* k = static_cast<const long long*>(keys);
    if (t != nullptr)
      dj_probe<false, long long><<<blocks, DJ_THREADS, 0, s>>>(
          p, k, kv, ac, n, kmin, D, t, bl, br, mode, vec, sel);
    else
      dj_probe<true, long long><<<blocks, DJ_THREADS, 0, s>>>(
          p, k, kv, ac, n, kmin, D, t, bl, br, mode, vec, sel);
  } else {
    const int* k = static_cast<const int*>(keys);
    if (t != nullptr)
      dj_probe<false, int><<<blocks, DJ_THREADS, 0, s>>>(
          p, k, kv, ac, n, kmin, D, t, bl, br, mode, vec, sel);
    else
      dj_probe<true, int><<<blocks, DJ_THREADS, 0, s>>>(
          p, k, kv, ac, n, kmin, D, t, bl, br, mode, vec, sel);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
