// window_scan: the segment structure of a window's sorted rows and the
// segmented scans its functions are built from.
//
// Replaces: spark_rapids_tpu/ops/window.py:35 SortedWindowContext (segment
// and peer starts from groupby.py:174 _segment_starts, their positions by
// cummax/cummin), :95-133 the rank family, :135 shift (lag/lead), :159
// _segmented_scan, :171 running_sum, :177 running_minmax and :187
// partition_reduce.  The rows come in (partition keys, order keys) order
// from sort.cu; every output is in that order.
//
// Entry points:
//   win_context    a window spec's segment structure in two launches: a
//                  forward kernel compares each row's keys with the
//                  previous row's (a tile's keys staged in shared memory)
//                  and writes seg_start[i] (row i starts a partition: a
//                  partition key differs from row i - 1), peer_start[i]
//                  (it starts a peer group: a partition or order key
//                  differs) and their start positions, the running max of
//                  i at the flags; a backward kernel over the two flag
//                  arrays writes the end positions, the running min from
//                  the last row back of i where a group ends.  Keys compare
//                  by order.cuh's view; two nulls are equal whatever their
//                  payload, a null and a value differ.
//   win_scan       an inclusive scan in one launch: values are int32,
//                  int64 or float64 (sum, min or max; min/max propagate NaN
//                  as jnp.minimum/maximum do) where a mask allows, or the
//                  count of a flag array (dense rank, running count), and
//                  reset at partition starts.
//   win_take       out[i] = src[idx[i]]: a partition reduction (the scan at
//                  the partition's last row) or a RANGE running frame (the
//                  scan at the peer group's last row) gathered back.
//   win_rank       row_number, rank, dense_rank, percent_rank, cume_dist
//                  and ntile, elementwise from the positions.
//   win_shift      lag/lead: the value `offset` rows back within the
//                  partition, else the default (a column) or null.
//
// Bound: device memory.  A scan must read its values (8 B) and resets (1 B)
// and write its output (8 B): 17 B a row, 1.02 GB over W1's 60,012,150
// rows; the context reads the keys and writes two flag bytes and four
// int32 positions.  The design before this one read a scan's input twice
// over three launches (tile aggregates, one block scanning them, a rescan)
// with a thread's 8 rows strided across the warp, and built the context
// from 13 launches (the flags, then four position scans).  Now:
//   * one launch a scan (Merrill and Garland's decoupled look-back): a tile
//     of WS_TILE rows a block, its number from an atomic counter (so a
//     block waits only on tiles whose blocks already run), its aggregate
//     published at once (flag A; P at once where the tile holds a reset)
//     and its inclusive prefix (P) after the look-back.  The status words
//     and the tile counter are cleared before each launch (one memset on
//     the stream, 4 B a tile), so a zero word reads as not yet published;
//     a tile writes its 8-byte value, fences, then its status word;
//   * float64 sums equal to the bit from run to run: a tile folds its carry
//     strictly in tile order, from the nearest inclusive prefix P_j (or
//     aggregate that holds a reset) it finds: P_t = P_j + A_(j+1) + ... +
//     A_t, left to right, which by induction is the chained scan's value
//     whatever the timing; rows combine within a tile in a fixed order;
//   * coalesced tiles: 16-byte loads of the values staged through shared
//     memory (a swizzle keeps a thread's 16 consecutive items free of bank
//     conflicts) into each thread's consecutive items, mask and reset bytes
//     as one 16-byte load a thread, and the output leaves the same way.
//     Views at an odd storage offset and the last tile take scalar loads.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

#include "order.cuh"

#define WS_THREADS 256
#define WS_ITEMS 16
#define WS_TILE (WS_THREADS * WS_ITEMS)
#define WS_MAX_KEYS 16
#define WS_LB_DEPTH 8     // look-back windows of 32 tiles kept before waiting
#define WS_MIN_BLOCKS 4   // resident blocks an SM the scan kernels ask for

#define WS_SUM 0
#define WS_MIN 1
#define WS_MAX 2

#define WS_LD_VALUES 0
#define WS_LD_FLAG_COUNT 3

#define WS_T_I32 0
#define WS_T_I64 1
#define WS_T_F64 2

#define WS_ST_AGG 1u
#define WS_ST_INC 2u

static cudaError_t ws_grid(long long n, int per_sm, int* blocks) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long want = (n + WS_THREADS - 1) / WS_THREADS;
  const long long cap = (long long)sms * per_sm;
  *blocks = (int)(want < 1 ? 1 : (want < cap ? want : cap));
  return cudaSuccess;
}

static bool ws_aligned(const void* p, int bytes) {
  return ((uintptr_t)p & (uintptr_t)(bytes - 1)) == 0;
}

// ---------------------------------------------------------------------------
// combining (value, reset) pairs
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ T ws_apply(int op, T a, T b) {
  if (op == WS_SUM) return a + b;
  if (op == WS_MIN) return b < a ? b : a;
  return b > a ? b : a;
}

template <>
__device__ __forceinline__ double ws_apply<double>(int op, double a,
                                                   double b) {
  if (op == WS_SUM) return a + b;
  if (a != a) return a;  // NaN propagates
  if (b != b) return b;
  if (op == WS_MIN) return b < a ? b : a;
  return b > a ? b : a;
}

// A segmented scan's combining step: (av, af) := (av, af) then (bv, bf),
// where a reset in b discards a.
template <typename T>
struct WSThen {
  int op;
  __device__ __forceinline__ void operator()(T& av, int& af, T bv,
                                             int bf) const {
    av = bf ? bv : ws_apply<T>(op, av, bv);
    af |= bf;
  }
};

// Two positions scanned together, each by max (start positions) or min
// (end positions); no resets.
struct WSPair {
  int seg, peer;
};

template <bool MAX>
struct WSPairThen {
  __device__ __forceinline__ void operator()(WSPair& a, int& af, WSPair b,
                                             int bf) const {
    a.seg = MAX ? (b.seg > a.seg ? b.seg : a.seg)
                : (b.seg < a.seg ? b.seg : a.seg);
    a.peer = MAX ? (b.peer > a.peer ? b.peer : a.peer)
                 : (b.peer < a.peer ? b.peer : a.peer);
    af |= bf;
  }
};

template <typename T>
__device__ __forceinline__ T ws_shfl(T v, int lane) {
  static_assert(sizeof(T) == 4 || sizeof(T) == 8, "4 or 8-byte values");
  if (sizeof(T) == 4) {
    unsigned u;
    memcpy(&u, &v, 4);
    u = __shfl_sync(0xffffffffu, u, lane);
    memcpy(&v, &u, 4);
  } else {
    unsigned long long u;
    memcpy(&u, &v, 8);
    u = __shfl_sync(0xffffffffu, u, lane);
    memcpy(&v, &u, 8);
  }
  return v;
}

template <typename T>
__device__ __forceinline__ T ws_shfl_up(T v, int o) {
  unsigned long long u = 0;
  memcpy(&u, &v, sizeof(T));
  u = __shfl_up_sync(0xffffffffu, u, o);
  memcpy(&v, &u, sizeof(T));
  return v;
}

template <typename T>
__device__ __forceinline__ T ws_shfl_down(T v, int o) {
  unsigned long long u = 0;
  memcpy(&u, &v, sizeof(T));
  u = __shfl_down_sync(0xffffffffu, u, o);
  memcpy(&v, &u, sizeof(T));
  return v;
}

// Block-wide exclusive scan of each thread's (v, f) in thread order (or,
// REV, from the last thread back); returns the block's total in (tv, tf).
// Fixed order: the warps' shuffles, then one thread over the warps.
template <typename T, typename F, bool REV = false>
__device__ __forceinline__ void ws_block_exclusive(F fn, T identity, T& v,
                                                   int& f, T& tv, int& tf) {
  __shared__ unsigned long long s_v[WS_THREADS / 32];
  __shared__ int s_f[WS_THREADS / 32];
  __shared__ unsigned long long s_tv;
  __shared__ int s_tf;
  const int lane0 = threadIdx.x % 32, warp0 = threadIdx.x / 32;
  const int lane = REV ? 31 - lane0 : lane0;
  const int warp = REV ? WS_THREADS / 32 - 1 - warp0 : warp0;
  const int warps = WS_THREADS / 32;
  T iv = v;
  int iff = f;
  for (int o = 1; o < 32; o <<= 1) {
    const T pv = REV ? ws_shfl_down<T>(iv, o) : ws_shfl_up<T>(iv, o);
    const int pf = REV ? __shfl_down_sync(0xffffffffu, iff, o)
                       : __shfl_up_sync(0xffffffffu, iff, o);
    if (lane >= o) {
      T a = pv;
      int af = pf;
      fn(a, af, iv, iff);
      iv = a;
      iff = af;
    }
  }
  T ev = REV ? ws_shfl_down<T>(iv, 1) : ws_shfl_up<T>(iv, 1);
  int ef = REV ? __shfl_down_sync(0xffffffffu, iff, 1)
               : __shfl_up_sync(0xffffffffu, iff, 1);
  if (lane == 0) {
    ev = identity;
    ef = 0;
  }
  if (lane == 31) {
    unsigned long long u = 0;
    memcpy(&u, &iv, sizeof(T));
    s_v[warp] = u;
    s_f[warp] = iff;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    T run = identity;
    int rf = 0;
    for (int w = 0; w < warps; ++w) {
      T wv;
      memcpy(&wv, &s_v[w], sizeof(T));
      const int wf = s_f[w];
      unsigned long long u = 0;
      memcpy(&u, &run, sizeof(T));
      s_v[w] = u;  // exclusive prefix of warp w
      s_f[w] = rf;
      fn(run, rf, wv, wf);
    }
    unsigned long long u = 0;
    memcpy(&u, &run, sizeof(T));
    s_tv = u;
    s_tf = rf;
  }
  __syncthreads();
  T pv;
  memcpy(&pv, &s_v[warp], sizeof(T));
  int pf = s_f[warp];
  fn(pv, pf, ev, ef);
  v = pv;
  f = pf;
  memcpy(&tv, &s_tv, sizeof(T));
  tf = s_tf;
  __syncthreads();
}

// ---------------------------------------------------------------------------
// the decoupled look-back
// ---------------------------------------------------------------------------

// Per call: val[2 t] the 8-byte aggregate of tile t and val[2 t + 1] its
// inclusive prefix (two words, so a reader that saw flag A never reads a
// value the P overwrote), st[t] its status word (reset << 2 | A or P; zero
// until published); ctr[0] the tile counter.  The status words and the
// counter are zeroed before every launch.
struct WSLook {
  unsigned long long* val;
  unsigned* st;
  unsigned* ctr;
};

template <typename T>
__device__ __forceinline__ void ws_publish(const WSLook& lk, long long t,
                                           T v, int f, unsigned status) {
  unsigned long long u = 0;
  memcpy(&u, &v, sizeof(T));
  __stcg(lk.val + 2 * t + (status == WS_ST_INC), u);
  __threadfence();
  *(volatile unsigned*)(lk.st + t) = ((unsigned)f << 2) | status;
}

// The tile number of this block (from the counter), in thread 0's result
// broadcast through shared memory.
__device__ __forceinline__ long long ws_ticket(const WSLook& lk) {
  __shared__ unsigned s_t;
  if (threadIdx.x == 0) s_t = atomicAdd(lk.ctr, 1u);
  __syncthreads();
  return (long long)s_t;
}

// The exclusive carry of tile `tile` > 0 (its first warp, all 32 lanes):
// lanes read 32 earlier tiles at once, nearest first, and wait for each to
// publish; the nearest that stops the walk (an inclusive prefix, or an
// aggregate that holds a reset, or the start) seeds the fold, which then
// takes every nearer aggregate one by one in tile order.  Windows with no
// stop are kept in shared memory (WS_LB_DEPTH of them; past that the walk
// waits on its farthest window until a stop appears there).
template <typename T, typename F>
__device__ __forceinline__ void ws_look_back(const WSLook& lk, long long tile,
                                             F fn, T identity, T& cv,
                                             int& cf) {
  __shared__ unsigned long long s_wv[WS_LB_DEPTH][32];
  const int lane = threadIdx.x & 31;
  long long base = tile - 1;
  int depth = 0;
  while (true) {
    const long long j = base - lane;
    T v = identity;
    int rf = 0, stop = 1;
    if (j >= 0) {
      unsigned w;
      do {
        w = *(volatile const unsigned*)(lk.st + j);
      } while (w == 0);
      __threadfence();
      const bool inc = (w & 3u) == WS_ST_INC;
      const unsigned long long u = __ldcg(lk.val + 2 * j + inc);
      memcpy(&v, &u, sizeof(T));
      rf = (int)((w >> 2) & 1u);
      stop = inc || rf;
    }
    const unsigned stops = __ballot_sync(0xffffffffu, stop);
    if (stops != 0) {
      const int s = __ffs(stops) - 1;
      T acc = ws_shfl<T>(v, s);
      int af = __shfl_sync(0xffffffffu, rf, s);
      for (int l = s - 1; l >= 0; --l) {
        const T b = ws_shfl<T>(v, l);
        fn(acc, af, b, 0);  // an aggregate without a reset
      }
      for (int d = depth - 1; d >= 0; --d) {
        for (int l = 31; l >= 0; --l) {
          T b;
          memcpy(&b, &s_wv[d][l], sizeof(T));
          fn(acc, af, b, 0);
        }
      }
      cv = acc;
      cf = af;
      return;
    }
    if (depth < WS_LB_DEPTH) {
      unsigned long long u = 0;
      memcpy(&u, &v, sizeof(T));
      s_wv[depth][lane] = u;
      __syncwarp();
      ++depth;
      base -= 32;
    }
  }
}

// ---------------------------------------------------------------------------
// coalesced tiles
// ---------------------------------------------------------------------------

// 16-byte chunk c of a tile lives at chunk c ^ ((c >> 3) & 7) of shared
// memory: a quarter warp's 8 threads reading chunk q of their consecutive
// items (chunks span * t + q), and 8 consecutive chunks written, each touch
// 8 distinct 16-byte bank groups.
__device__ __forceinline__ int ws_swz(int c) { return c ^ ((c >> 3) & 7); }

// A full tile's values into each thread's WS_ITEMS consecutive items.
template <typename T>
__device__ __forceinline__ void ws_load_tile(const T* __restrict__ src,
                                             uint4* smem,
                                             T (&x)[WS_ITEMS]) {
  constexpr int chunks = WS_TILE * (int)sizeof(T) / 16;
  constexpr int span = WS_ITEMS * (int)sizeof(T) / 16;
  const uint4* g = reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int k = 0; k < chunks / WS_THREADS; ++k) {
    const int c = threadIdx.x + k * WS_THREADS;
    smem[ws_swz(c)] = __ldcs(g + c);
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < span; ++q) {
    const uint4 u = smem[ws_swz(threadIdx.x * span + q)];
    memcpy(reinterpret_cast<char*>(x) + 16 * q, &u, 16);
  }
  __syncthreads();
}

template <typename T>
__device__ __forceinline__ void ws_store_tile(T* __restrict__ dst,
                                              uint4* smem,
                                              const T (&y)[WS_ITEMS]) {
  constexpr int chunks = WS_TILE * (int)sizeof(T) / 16;
  constexpr int span = WS_ITEMS * (int)sizeof(T) / 16;
  __syncthreads();
#pragma unroll
  for (int q = 0; q < span; ++q) {
    uint4 u;
    memcpy(&u, reinterpret_cast<const char*>(y) + 16 * q, 16);
    smem[ws_swz(threadIdx.x * span + q)] = u;
  }
  __syncthreads();
  uint4* g = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int k = 0; k < chunks / WS_THREADS; ++k) {
    const int c = threadIdx.x + k * WS_THREADS;
    __stcs(g + c, smem[ws_swz(c)]);
  }
}

// A thread's WS_ITEMS (16 or 8) consecutive bytes, one vector access.
static_assert(WS_ITEMS == 16 || WS_ITEMS == 8, "16 or 8 rows a thread");
typedef std::conditional<WS_ITEMS == 16, uint4, uint2>::type WSRowBytes;

__device__ __forceinline__ void ws_load_bytes(const uint8_t* __restrict__ p,
                                              uint8_t (&b)[WS_ITEMS]) {
  const WSRowBytes u = __ldcs(reinterpret_cast<const WSRowBytes*>(p));
  memcpy(b, &u, WS_ITEMS);
}

__device__ __forceinline__ void ws_store_bytes(uint8_t* __restrict__ p,
                                               const uint8_t (&b)[WS_ITEMS]) {
  WSRowBytes u;
  memcpy(&u, b, WS_ITEMS);
  __stcs(reinterpret_cast<WSRowBytes*>(p), u);
}

// ---------------------------------------------------------------------------
// the one-pass segmented scan
// ---------------------------------------------------------------------------

template <typename T>
struct WSIn {
  const T* vals;          // WS_LD_VALUES
  const uint8_t* mask;    // WS_LD_VALUES: rows that contribute (nullptr all)
  const uint8_t* flags;   // WS_LD_FLAG_COUNT: the flags counted
  const uint8_t* reset;   // partition starts (nullptr: no resets)
  long long n;
  T identity;
  int op;
  int mode;
  int vec;                // 16-byte accesses allowed on full tiles
};

template <typename T>
__global__ void __launch_bounds__(WS_THREADS, WS_MIN_BLOCKS)
ws_scan_k(const __grid_constant__ WSIn<T> in, WSLook lk, T* __restrict__ out) {
  __shared__ uint4 s_tile[WS_TILE * sizeof(T) / 16];
  __shared__ unsigned long long s_cv;
  __shared__ int s_cf;
  const long long tile = ws_ticket(lk);
  const long long base = tile * WS_TILE;
  const long long row0 = base + (long long)threadIdx.x * WS_ITEMS;
  const bool full = in.vec && base + WS_TILE <= in.n;
  const WSThen<T> fn{in.op};
  T x[WS_ITEMS];
  uint8_t m[WS_ITEMS], r[WS_ITEMS];
  if (full) {
    if (in.mode == WS_LD_VALUES) {
      ws_load_tile<T>(in.vals + base, s_tile, x);
      if (in.mask != nullptr) {
        ws_load_bytes(in.mask + row0, m);
#pragma unroll
        for (int u = 0; u < WS_ITEMS; ++u)
          if (!m[u]) x[u] = in.identity;
      }
    } else {
      ws_load_bytes(in.flags + row0, m);
#pragma unroll
      for (int u = 0; u < WS_ITEMS; ++u) x[u] = (T)m[u];
    }
    if (in.reset != nullptr) {
      ws_load_bytes(in.reset + row0, r);
    } else {
#pragma unroll
      for (int u = 0; u < WS_ITEMS; ++u) r[u] = 0;
    }
  } else {
#pragma unroll
    for (int u = 0; u < WS_ITEMS; ++u) {
      const long long i = row0 + u;
      const bool ok = i < in.n;
      if (in.mode == WS_LD_VALUES)
        x[u] = ok && (in.mask == nullptr || in.mask[i]) ? in.vals[i]
                                                         : in.identity;
      else
        x[u] = ok ? (T)in.flags[i] : (T)0;
      r[u] = ok && in.reset != nullptr && in.reset[i];
    }
  }
  // the thread's rows in order, then the block's exclusive scan
  T v = in.identity;
  int f = 0;
#pragma unroll
  for (int u = 0; u < WS_ITEMS; ++u) fn(v, f, x[u], r[u]);
  T tv;
  int tf;
  ws_block_exclusive<T, WSThen<T>>(fn, in.identity, v, f, tv, tf);
  if (threadIdx.x < 32) {
    if (threadIdx.x == 0)
      ws_publish<T>(lk, tile, tv, tf,
                    tile == 0 || tf ? WS_ST_INC : WS_ST_AGG);
    T cv = in.identity;
    int cf = 0;
    if (tile > 0) ws_look_back<T>(lk, tile, fn, in.identity, cv, cf);
    if (threadIdx.x == 0) {
      if (tile > 0 && !tf) {
        T pv = cv;
        int pf = cf;
        fn(pv, pf, tv, tf);
        ws_publish<T>(lk, tile, pv, pf, WS_ST_INC);
      }
      unsigned long long u = 0;
      memcpy(&u, &cv, sizeof(T));
      s_cv = u;
      s_cf = cf;
    }
  }
  __syncthreads();
  T run;
  memcpy(&run, &s_cv, sizeof(T));
  int rf = s_cf;
  fn(run, rf, v, f);
#pragma unroll
  for (int u = 0; u < WS_ITEMS; ++u) {
    fn(run, rf, x[u], r[u]);
    x[u] = run;
  }
  if (full) {
    ws_store_tile<T>(out + base, s_tile, x);
  } else {
#pragma unroll
    for (int u = 0; u < WS_ITEMS; ++u)
      if (row0 + u < in.n) out[row0 + u] = x[u];
  }
}

// ---------------------------------------------------------------------------
// the window context: flags and start positions forward, end positions
// backward
// ---------------------------------------------------------------------------

struct WSKeys {
  const void* data[WS_MAX_KEYS];
  const uint8_t* valid[WS_MAX_KEYS];
  int elem[WS_MAX_KEYS];
  int kind[WS_MAX_KEYS];
  int npart;  // the first npart keys are partition keys
  int nkeys;
};

// shared slot of tile row i (-1 .. WS_TILE - 1): one pad word every 16
// rows keeps a thread's 16 consecutive rows off one bank
__device__ __forceinline__ int ws_kpad(int i) {
  return i + 1 + ((i + 1) >> 4);
}
#define WS_KSLOTS (WS_TILE + 1 + (WS_TILE + 1) / 16 + 1)

// Rows base - 1 .. base + WS_TILE - 1 of one key column into shared
// memory as order.cuh's views and validity bytes (E-byte elements of
// KIND): a thread's rows in two halves, each half's loads issued before
// its first store.
template <int E, int KIND>
__device__ __forceinline__ void ws_stage_key(const void* data,
                                             const uint8_t* valid,
                                             long long base, long long n,
                                             long long* s_key,
                                             uint8_t* s_ok) {
  constexpr int half = WS_ITEMS / 2;
#pragma unroll
  for (int h = 0; h < WS_ITEMS; h += half) {
    long long kv[half];
    unsigned ok = 0;
#pragma unroll
    for (int j = 0; j < half; ++j) {
      const long long g = base + threadIdx.x + (h + j) * WS_THREADS;
      const bool in = g < n;
      ok |= (unsigned)(in && (valid == nullptr || valid[g])) << j;
      kv[j] = in ? key_view(data, E, KIND, g) : 0;
    }
#pragma unroll
    for (int j = 0; j < half; ++j) {
      const int i = threadIdx.x + (h + j) * WS_THREADS;
      s_key[ws_kpad(i)] = kv[j];
      s_ok[ws_kpad(i)] = (ok >> j) & 1u;
    }
  }
  if (threadIdx.x == 0) {
    const long long g = base - 1;
    const bool in = g >= 0 && g < n;
    s_key[ws_kpad(-1)] = in ? key_view(data, E, KIND, g) : 0;
    s_ok[ws_kpad(-1)] = in && (valid == nullptr || valid[g]);
  }
}

// A thread's WS_ITEMS flags (bit u: row row0 + u) as bytes.
__device__ __forceinline__ void ws_bits_bytes(unsigned bits,
                                              uint8_t (&b)[WS_ITEMS]) {
#pragma unroll
  for (int u = 0; u < WS_ITEMS; ++u) b[u] = (bits >> u) & 1u;
}

// The rows a thread holds below n, as a mask of its WS_ITEMS bits.
__device__ __forceinline__ unsigned ws_rows_mask(long long row0,
                                                 long long n) {
  const long long rows = n - row0;
  return rows >= WS_ITEMS ? (WS_ITEMS == 32 ? ~0u : (1u << WS_ITEMS) - 1u)
         : rows <= 0     ? 0u
                         : (1u << rows) - 1u;
}

__global__ void __launch_bounds__(WS_THREADS, WS_MIN_BLOCKS)
ws_ctx_fwd(const __grid_constant__ WSKeys k, long long n, WSLook lk,
           uint8_t* __restrict__ seg_start, uint8_t* __restrict__ peer_start,
           int* __restrict__ seg_pos, int* __restrict__ peer_pos, int vec) {
  __shared__ __align__(16) long long s_key[WS_KSLOTS];
  __shared__ uint8_t s_ok[WS_KSLOTS];
  __shared__ unsigned long long s_cv;
  const long long tile = ws_ticket(lk);
  const long long base = tile * WS_TILE;
  const long long row0 = base + (long long)threadIdx.x * WS_ITEMS;
  const bool full = vec && base + WS_TILE <= n;
  // bit u: row row0 + u starts a partition (seg) or a peer group (peer)
  unsigned seg = row0 == 0 ? 1u : 0u, peer = seg;
  for (int c = 0; c < k.nkeys; ++c) {
    const void* d = k.data[c];
    const uint8_t* kvalid = k.valid[c];
    if (k.kind[c] == OK_KIND_FLOAT) {
      if (k.elem[c] == 8)
        ws_stage_key<8, OK_KIND_FLOAT>(d, kvalid, base, n, s_key, s_ok);
      else
        ws_stage_key<4, OK_KIND_FLOAT>(d, kvalid, base, n, s_key, s_ok);
    } else {
      switch (k.elem[c]) {
        case 1:
          ws_stage_key<1, OK_KIND_INT>(d, kvalid, base, n, s_key, s_ok);
          break;
        case 2:
          ws_stage_key<2, OK_KIND_INT>(d, kvalid, base, n, s_key, s_ok);
          break;
        case 4:
          ws_stage_key<4, OK_KIND_INT>(d, kvalid, base, n, s_key, s_ok);
          break;
        default:
          ws_stage_key<8, OK_KIND_INT>(d, kvalid, base, n, s_key, s_ok);
      }
    }
    __syncthreads();
    const int t0 = (int)threadIdx.x * WS_ITEMS;
    unsigned diff = 0;
#pragma unroll
    for (int u = 0; u < WS_ITEMS; ++u) {
      const int a = ws_kpad(t0 + u - 1), b = ws_kpad(t0 + u);
      const bool dd = s_ok[a] != s_ok[b] ||
                      (s_ok[b] && s_key[a] != s_key[b]);
      diff |= (unsigned)dd << u;
    }
    if (c < k.npart) seg |= diff;
    peer |= diff;
    __syncthreads();
  }
  const unsigned in = ws_rows_mask(row0, n);
  seg &= in;
  peer = (peer | seg) & in;  // partition starts are peer starts too
  // The thread's last starts; a partition start also acts as a reset:
  // every position before it is smaller, so a tile that holds one is its
  // own inclusive prefix (published at once; a look-back stops there).
  const WSPairThen<true> fn{};
  WSPair v;
  v.seg = seg ? (int)row0 + 31 - __clz(seg) : 0;
  v.peer = peer ? (int)row0 + 31 - __clz(peer) : 0;
  int f = seg != 0;
  WSPair tv;
  int tf;
  ws_block_exclusive<WSPair, WSPairThen<true>>(fn, WSPair{0, 0}, v, f, tv,
                                               tf);
  if (threadIdx.x < 32) {
    if (threadIdx.x == 0)
      ws_publish<WSPair>(lk, tile, tv, tf,
                         tile == 0 || tf ? WS_ST_INC : WS_ST_AGG);
    WSPair cv = {0, 0};
    int cf = 0;
    if (tile > 0)
      ws_look_back<WSPair>(lk, tile, fn, WSPair{0, 0}, cv, cf);
    if (threadIdx.x == 0) {
      if (tile > 0 && !tf) {
        WSPair pv = cv;
        int pf = cf;
        fn(pv, pf, tv, tf);
        ws_publish<WSPair>(lk, tile, pv, pf, WS_ST_INC);
      }
      memcpy(&s_cv, &cv, 8);
    }
  }
  __syncthreads();
  WSPair run;
  memcpy(&run, &s_cv, 8);
  int rf = 0;
  fn(run, rf, v, f);
  // positions: the running max of the start rows, one output at a time
  int pos[WS_ITEMS];
  uint8_t flag[WS_ITEMS];
  int at = run.seg;
#pragma unroll
  for (int u = 0; u < WS_ITEMS; ++u) {
    if ((seg >> u) & 1u) at = (int)row0 + u;
    pos[u] = at;
  }
  ws_bits_bytes(seg, flag);
  uint4* sm = reinterpret_cast<uint4*>(s_key);
  if (full) {
    ws_store_bytes(seg_start + row0, flag);
    ws_store_tile<int>(seg_pos + base, sm, pos);
  } else {
#pragma unroll
    for (int u = 0; u < WS_ITEMS; ++u) {
      if (row0 + u < n) {
        seg_start[row0 + u] = flag[u];
        seg_pos[row0 + u] = pos[u];
      }
    }
  }
  at = run.peer;
#pragma unroll
  for (int u = 0; u < WS_ITEMS; ++u) {
    if ((peer >> u) & 1u) at = (int)row0 + u;
    pos[u] = at;
  }
  ws_bits_bytes(peer, flag);
  if (full) {
    ws_store_bytes(peer_start + row0, flag);
    ws_store_tile<int>(peer_pos + base, sm, pos);
  } else {
#pragma unroll
    for (int u = 0; u < WS_ITEMS; ++u) {
      if (row0 + u < n) {
        peer_start[row0 + u] = flag[u];
        peer_pos[row0 + u] = pos[u];
      }
    }
  }
}

// End positions: tiles from the last back (ticket t is tile
// tiles - 1 - t), rows from the last back; row i ends its group where row
// i + 1 starts one or i = n - 1.
__global__ void __launch_bounds__(WS_THREADS, WS_MIN_BLOCKS)
ws_ctx_bwd(const uint8_t* __restrict__ seg_start,
           const uint8_t* __restrict__ peer_start, long long n, WSLook lk,
           int* __restrict__ seg_end, int* __restrict__ peer_end, int vec) {
  __shared__ uint4 s_tile[WS_TILE * 4 / 16];
  __shared__ unsigned long long s_cv;
  const long long ticket = ws_ticket(lk);
  const long long tiles = (n + WS_TILE - 1) / WS_TILE;
  const long long base = (tiles - 1 - ticket) * WS_TILE;
  const long long row0 = base + (long long)threadIdx.x * WS_ITEMS;
  const bool full = vec && base + WS_TILE <= n;
  // bit u: row row0 + u ends a partition (seg) or a peer group (peer)
  unsigned seg = 0, peer = 0;
  const long long after = row0 + WS_ITEMS;
  if (full) {
    uint8_t b[WS_ITEMS];
    ws_load_bytes(seg_start + row0, b);
#pragma unroll
    for (int u = 1; u < WS_ITEMS; ++u) seg |= (unsigned)(b[u] != 0) << (u - 1);
    ws_load_bytes(peer_start + row0, b);
#pragma unroll
    for (int u = 1; u < WS_ITEMS; ++u) peer |= (unsigned)(b[u] != 0) << (u - 1);
  } else {
#pragma unroll
    for (int u = 0; u < WS_ITEMS - 1; ++u) {
      const long long i = row0 + u + 1;
      if (i < n) {
        seg |= (unsigned)(seg_start[i] != 0) << u;
        peer |= (unsigned)(peer_start[i] != 0) << u;
      }
    }
  }
  const bool last_in = after >= n;  // the row after this thread's last
  const unsigned top = 1u << (WS_ITEMS - 1);
  if (!last_in && seg_start[after]) seg |= top;
  if (!last_in && peer_start[after]) peer |= top;
  const unsigned in = ws_rows_mask(row0, n);
  if (row0 < n && n - 1 - row0 < WS_ITEMS) {  // row n - 1 ends everything
    seg |= 1u << (n - 1 - row0);
    peer |= 1u << (n - 1 - row0);
  }
  seg &= in;
  peer = (peer | seg) & in;
  // a partition's end is a peer group's end too, and every later end is
  // larger: a tile that holds one is its own inclusive prefix
  const int last = (int)(n - 1);
  const WSPairThen<false> fn{};
  WSPair v;
  v.seg = seg ? (int)row0 + __ffs(seg) - 1 : last;
  v.peer = peer ? (int)row0 + __ffs(peer) - 1 : last;
  int f = seg != 0;
  WSPair tv;
  int tf;
  ws_block_exclusive<WSPair, WSPairThen<false>, true>(
      fn, WSPair{last, last}, v, f, tv, tf);
  if (threadIdx.x < 32) {
    if (threadIdx.x == 0)
      ws_publish<WSPair>(lk, ticket, tv, tf,
                         ticket == 0 || tf ? WS_ST_INC : WS_ST_AGG);
    WSPair cv = {last, last};
    int cf = 0;
    if (ticket > 0)
      ws_look_back<WSPair>(lk, ticket, fn, WSPair{last, last}, cv, cf);
    if (threadIdx.x == 0) {
      if (ticket > 0 && !tf) {
        WSPair pv = cv;
        int pf = cf;
        fn(pv, pf, tv, tf);
        ws_publish<WSPair>(lk, ticket, pv, pf, WS_ST_INC);
      }
      memcpy(&s_cv, &cv, 8);
    }
  }
  __syncthreads();
  WSPair run;
  memcpy(&run, &s_cv, 8);
  int rf = 0;
  fn(run, rf, v, f);
  int pos[WS_ITEMS];
  int at = run.seg;
#pragma unroll
  for (int u = WS_ITEMS - 1; u >= 0; --u) {
    if ((seg >> u) & 1u) at = (int)row0 + u;
    pos[u] = at;
  }
  if (full) {
    ws_store_tile<int>(seg_end + base, s_tile, pos);
  } else {
#pragma unroll
    for (int u = 0; u < WS_ITEMS; ++u)
      if (row0 + u < n) seg_end[row0 + u] = pos[u];
  }
  at = run.peer;
#pragma unroll
  for (int u = WS_ITEMS - 1; u >= 0; --u) {
    if ((peer >> u) & 1u) at = (int)row0 + u;
    pos[u] = at;
  }
  if (full) {
    ws_store_tile<int>(peer_end + base, s_tile, pos);
  } else {
#pragma unroll
    for (int u = 0; u < WS_ITEMS; ++u)
      if (row0 + u < n) peer_end[row0 + u] = pos[u];
  }
}

// ---------------------------------------------------------------------------
// take, ranks, shift
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(WS_THREADS)
ws_take(const void* __restrict__ src, int elem, const int* __restrict__ idx,
        long long n, void* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const long long r = idx[i];
    if (elem == 8)
      static_cast<long long*>(out)[i] = static_cast<const long long*>(src)[r];
    else if (elem == 4)
      static_cast<int*>(out)[i] = static_cast<const int*>(src)[r];
    else
      static_cast<uint8_t*>(out)[i] = static_cast<const uint8_t*>(src)[r];
  }
}

#define WS_ROW_NUMBER 0
#define WS_RANK 1
#define WS_DENSE_RANK 2
#define WS_PERCENT_RANK 3
#define WS_CUME_DIST 4
#define WS_NTILE 5

struct WSPos {
  const int* seg_start;
  const int* seg_end;
  const int* peer_start;
  const int* peer_end;
  const int* dense;  // WS_DENSE_RANK: the peer-start count
};

__global__ void __launch_bounds__(WS_THREADS)
ws_rank(const __grid_constant__ WSPos p, int fn, long long tiles,
        long long n, void* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const long long s = p.seg_start[i];
    switch (fn) {
      case WS_ROW_NUMBER:
        static_cast<int*>(out)[i] = (int)(i - s + 1);
        break;
      case WS_RANK:
        static_cast<int*>(out)[i] = (int)(p.peer_start[i] - s + 1);
        break;
      case WS_DENSE_RANK:
        static_cast<int*>(out)[i] = p.dense[i];
        break;
      case WS_PERCENT_RANK: {
        const double rows1 = (double)(p.seg_end[i] - s);
        const double r = (double)(p.peer_start[i] - s);
        static_cast<double*>(out)[i] = rows1 > 0 ? r / rows1 : 0.0;
        break;
      }
      case WS_CUME_DIST:
        static_cast<double*>(out)[i] =
            (double)(p.peer_end[i] - s + 1) / (double)(p.seg_end[i] - s + 1);
        break;
      default: {  // Spark NTile: the first size % tiles buckets get a row more
        const long long size = p.seg_end[i] - s + 1;
        const long long rn0 = i - s;
        const long long base = size / tiles, rem = size % tiles;
        const long long big = base + 1;
        const long long tile =
            rn0 < big * rem ? rn0 / big
                            : rem + (rn0 - big * rem) / (base > 0 ? base : 1);
        static_cast<int*>(out)[i] = (int)(tile + 1);
      }
    }
  }
}

__device__ __forceinline__ void ws_copy(const void* src, long long r,
                                        void* dst, long long i, int elem) {
  switch (elem) {
    case 1:
      static_cast<uint8_t*>(dst)[i] = static_cast<const uint8_t*>(src)[r];
      break;
    case 2:
      static_cast<uint16_t*>(dst)[i] = static_cast<const uint16_t*>(src)[r];
      break;
    case 4:
      static_cast<uint32_t*>(dst)[i] = static_cast<const uint32_t*>(src)[r];
      break;
    default:
      static_cast<unsigned long long*>(dst)[i] =
          static_cast<const unsigned long long*>(src)[r];
  }
}

// out[i] = data[i - offset] within the partition, else dflt[i] (dflt ==
// nullptr: null).  out_valid is written for every row.
__global__ void __launch_bounds__(WS_THREADS)
ws_shift(const void* __restrict__ data, const uint8_t* __restrict__ valid,
         int elem, long long offset, const void* __restrict__ dflt,
         const uint8_t* __restrict__ dflt_valid,
         const int* __restrict__ seg_start, const int* __restrict__ seg_end,
         long long n, void* __restrict__ out,
         uint8_t* __restrict__ out_valid) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const long long src = i - offset;
    const bool in_seg = src >= seg_start[i] && src <= seg_end[i];
    if (in_seg) {
      ws_copy(data, src, out, i, elem);
      out_valid[i] = valid == nullptr ? 1 : valid[src];
    } else if (dflt != nullptr) {
      ws_copy(dflt, i, out, i, elem);
      out_valid[i] = dflt_valid == nullptr ? 1 : dflt_valid[i];
    } else {
      ws_copy(data, i, out, i, elem);  // any payload under a null
      out_valid[i] = 0;
    }
  }
}

// ---------------------------------------------------------------------------
// host entries (ctypes); each returns cudaGetLastError() after its
// launches (0 = launched)
// ---------------------------------------------------------------------------

// The look-back scratch of a call over n rows (any contents): 2
// ceil(n / WS_TILE) 8-byte values, then as many status words and the tile
// counter.  Each launch clears its status words and counter first.
extern "C" long long win_scratch_bytes(long long n) {
  const long long tiles = n <= 0 ? 1 : (n + WS_TILE - 1) / WS_TILE;
  return 16 * tiles + 4 * tiles + 4;
}

// The scratch's regions over `tiles` tiles, its status words and counter
// zeroed on the stream.
static cudaError_t ws_look(void* scratch, long long tiles, cudaStream_t s,
                           WSLook* lk) {
  char* b = static_cast<char*>(scratch);
  lk->val = reinterpret_cast<unsigned long long*>(b);
  lk->st = reinterpret_cast<unsigned*>(b + 16 * tiles);
  lk->ctr = reinterpret_cast<unsigned*>(b + 20 * tiles);
  return cudaMemsetAsync(lk->st, 0, (size_t)(4 * tiles + 4), s);
}

// Keys in sorted order: the first npart are partition keys, the rest order
// keys (none: one partition, one peer group).  seg_start, peer_start: [n]
// uint8 out; seg_pos, seg_end, peer_pos, peer_end: [n] int32 out.  Two
// launches over one scratch, each after its own clear.
extern "C" int win_context(int npart, int nkeys, const void* const* data,
                           const void* const* valid, const int* elems,
                           const int* kinds, long long n, void* seg_start,
                           void* peer_start, void* seg_pos, void* seg_end,
                           void* peer_pos, void* peer_end, void* scratch,
                           void* stream) {
  if (nkeys < 0 || nkeys > WS_MAX_KEYS || npart < 0 || npart > nkeys ||
      n < 0 || n >= INT_MAX || scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  WSKeys k = {};
  for (int c = 0; c < nkeys; ++c) {
    const int e = elems[c], kd = kinds[c];
    const bool ok = kd == OK_KIND_FLOAT ? (e == 4 || e == 8)
                    : kd == OK_KIND_INT
                        ? (e == 1 || e == 2 || e == 4 || e == 8)
                        : false;
    if (!ok || data[c] == nullptr) return (int)cudaErrorInvalidValue;
    k.data[c] = data[c];
    k.valid[c] = static_cast<const uint8_t*>(valid[c]);
    k.elem[c] = e;
    k.kind[c] = kd;
  }
  k.npart = npart;
  k.nkeys = nkeys;
  if (n == 0) return (int)cudaSuccess;
  const long long tiles = (n + WS_TILE - 1) / WS_TILE;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  WSLook lk;
  cudaError_t err = ws_look(scratch, tiles, s, &lk);
  if (err != cudaSuccess) return (int)err;
  uint8_t* ss = static_cast<uint8_t*>(seg_start);
  uint8_t* ps = static_cast<uint8_t*>(peer_start);
  const int vec = ws_aligned(seg_start, 16) && ws_aligned(peer_start, 16) &&
                  ws_aligned(seg_pos, 16) && ws_aligned(peer_pos, 16) &&
                  ws_aligned(seg_end, 16) && ws_aligned(peer_end, 16);
  ws_ctx_fwd<<<(unsigned)tiles, WS_THREADS, 0, s>>>(
      k, n, lk, ss, ps, static_cast<int*>(seg_pos),
      static_cast<int*>(peer_pos), vec);
  err = cudaGetLastError();
  if (err == cudaSuccess) err = ws_look(scratch, tiles, s, &lk);
  if (err != cudaSuccess) return (int)err;
  ws_ctx_bwd<<<(unsigned)tiles, WS_THREADS, 0, s>>>(
      ss, ps, n, lk, static_cast<int*>(seg_end),
      static_cast<int*>(peer_end), vec);
  return (int)cudaGetLastError();
}

// type: 0 int32, 1 int64, 2 float64; op: 0 sum, 1 min, 2 max; mode: 0
// values (vals where mask), 3 the count of `flags`.  reset: partition
// starts or nullptr.  identity: the op's identity as int64 bits of the
// type.  out: [n] of the type.  One launch over the look-back scratch.
extern "C" int win_scan(int type, int op, int mode, const void* vals,
                        const void* mask, const void* flags,
                        const void* reset, long long identity_bits,
                        long long n, void* out, void* scratch,
                        void* stream) {
  if (type < WS_T_I32 || type > WS_T_F64 || op < WS_SUM || op > WS_MAX ||
      (mode != WS_LD_VALUES && mode != WS_LD_FLAG_COUNT) || n < 0 ||
      n >= INT_MAX || out == nullptr || scratch == nullptr ||
      (mode == WS_LD_VALUES ? vals == nullptr : flags == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  const uint8_t* fl = static_cast<const uint8_t*>(flags);
  const uint8_t* rs = static_cast<const uint8_t*>(reset);
  const unsigned tiles = (unsigned)((n + WS_TILE - 1) / WS_TILE);
  WSLook lk;
  const cudaError_t err = ws_look(scratch, tiles, s, &lk);
  if (err != cudaSuccess) return (int)err;
  const int vec = ws_aligned(vals, 16) && ws_aligned(mask, 16) &&
                  ws_aligned(flags, 16) && ws_aligned(reset, 16) &&
                  ws_aligned(out, 16);
  if (type == WS_T_I32) {
    WSIn<int> in = {static_cast<const int*>(vals), m, fl, rs, n,
                    (int)identity_bits, op, mode, vec};
    ws_scan_k<int><<<tiles, WS_THREADS, 0, s>>>(in, lk,
                                                static_cast<int*>(out));
  } else if (type == WS_T_I64) {
    WSIn<long long> in = {static_cast<const long long*>(vals), m, fl, rs, n,
                          identity_bits, op, mode, vec};
    ws_scan_k<long long><<<tiles, WS_THREADS, 0, s>>>(
        in, lk, static_cast<long long*>(out));
  } else {
    double identity;
    memcpy(&identity, &identity_bits, sizeof(identity));
    WSIn<double> in = {static_cast<const double*>(vals), m, fl, rs, n,
                       identity, op, mode, vec};
    ws_scan_k<double><<<tiles, WS_THREADS, 0, s>>>(
        in, lk, static_cast<double*>(out));
  }
  return (int)cudaGetLastError();
}

// out[i] = src[idx[i]], elements of 1, 4 or 8 bytes; idx int32.
extern "C" int win_take(const void* src, int elem, const void* idx,
                        long long n, void* out, void* stream) {
  if ((elem != 1 && elem != 4 && elem != 8) || n < 0 || src == nullptr ||
      idx == nullptr || out == nullptr)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  int blocks = 1;
  cudaError_t err = ws_grid(n, 16, &blocks);
  if (err != cudaSuccess) return (int)err;
  ws_take<<<blocks, WS_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      src, elem, static_cast<const int*>(idx), n, out);
  return (int)cudaGetLastError();
}

// fn: 0 row_number, 1 rank, 2 dense_rank, 3 percent_rank, 4 cume_dist,
// 5 ntile(tiles).  Positions are int32 [n]; dense: the peer-start count
// (dense_rank only).  out: int32 [n], float64 for 3 and 4.
extern "C" int win_rank(int fn, long long tiles, const void* seg_start,
                        const void* seg_end, const void* peer_start,
                        const void* peer_end, const void* dense, long long n,
                        void* out, void* stream) {
  if (fn < WS_ROW_NUMBER || fn > WS_NTILE || n < 0 || out == nullptr ||
      seg_start == nullptr || (fn == WS_NTILE && tiles < 1) ||
      ((fn == WS_PERCENT_RANK || fn == WS_CUME_DIST || fn == WS_NTILE) &&
       seg_end == nullptr) ||
      ((fn == WS_RANK || fn == WS_PERCENT_RANK) && peer_start == nullptr) ||
      (fn == WS_CUME_DIST && peer_end == nullptr) ||
      (fn == WS_DENSE_RANK && dense == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  WSPos p = {static_cast<const int*>(seg_start),
             static_cast<const int*>(seg_end),
             static_cast<const int*>(peer_start),
             static_cast<const int*>(peer_end),
             static_cast<const int*>(dense)};
  int blocks = 1;
  cudaError_t err = ws_grid(n, 16, &blocks);
  if (err != cudaSuccess) return (int)err;
  ws_rank<<<blocks, WS_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      p, fn, tiles, n, out);
  return (int)cudaGetLastError();
}

// lag (offset > 0) / lead (offset < 0).  data/valid: the sorted column;
// dflt/dflt_valid: the default as a column, or nullptr (null).  out: [n]
// elements; out_valid: [n] uint8.
extern "C" int win_shift(const void* data, const void* valid, int elem,
                         long long offset, const void* dflt,
                         const void* dflt_valid, const void* seg_start,
                         const void* seg_end, long long n, void* out,
                         void* out_valid, void* stream) {
  if ((elem != 1 && elem != 2 && elem != 4 && elem != 8) || n < 0 ||
      data == nullptr || out == nullptr || out_valid == nullptr ||
      seg_start == nullptr || seg_end == nullptr)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  int blocks = 1;
  cudaError_t err = ws_grid(n, 16, &blocks);
  if (err != cudaSuccess) return (int)err;
  ws_shift<<<blocks, WS_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      data, static_cast<const uint8_t*>(valid), elem, offset, dflt,
      static_cast<const uint8_t*>(dflt_valid),
      static_cast<const int*>(seg_start), static_cast<const int*>(seg_end),
      n, out, static_cast<uint8_t*>(out_valid));
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
