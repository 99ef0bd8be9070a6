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
// The row number makes every tuple distinct: the order is total.
//
// Two routes, chosen on the host from k (a host integer: no sync).
//
// k <= TK_FILTER_MAX_K (128; the main path's 10, 20 and 100): filter
// first, sort only the survivors (after Johnson, Douze and Jegou's
// WarpSelect, "Billion-scale similarity search with GPUs", 2017).
//   tk_filter_rows  each warp reads 64 consecutive rows at a time, two a
//                   lane with their loads issued together, every key word
//                   once, and keeps its own sorted list of its kpad = 32 *
//                   ceil(k / 32) best entries in shared memory.  A row is
//                   rejected by one compare of its first key's 64-bit
//                   prefix against a bound and one tuple compare against
//                   the list's k-th entry, held in registers.  Rows that
//                   pass go to the warp's queue of TK_QUEUE (32) entries; a
//                   full queue is sorted in registers (a bitonic network of
//                   shuffles) and merged into the list by places (an
//                   entry's place is its index plus the other side's
//                   entries below it, a binary search), with no block
//                   barrier.  At the end the block places each warp list's
//                   first k entries among all its warps' lists and writes
//                   its k best.
//   tk_bound        one block lowers the prefix bound once more from the
//                   blocks' lists.
//   tk_rank         one warp per entry i < k of each block's list: its
//                   place in the result is i plus, per other list, the
//                   entries below it (a binary search a lane); a place
//                   below k is written, the rest of the output stays -1.
//                   Entries whose prefix is above the bound leave at once,
//                   so few warps search, and no single block merges lists.
// The prefix bound.  A row's prefix is its first key's words as one
// 64-bit image that never decreases along the order, so a row whose prefix
// is above P has before it every row whose prefix is not.  If m lists
// (a warp's, or a block's) have their entries 2^g - 1 at prefixes not
// above P and m 2^g >= k, that makes k rows, and no row above P is in the
// result.  After each merge a warp publishes its entries 2^g - 1's
// prefixes in shared memory and takes, for the two least g that have m =
// ceil(k / 2^g) warps, the m-th lowest (block_bound), and its own k-th
// entry's prefix; the lowest goes to a word in device memory (gp,
// atomicMin) that every warp reads once a round.  A warp's own k-th entry
// cuts only after k rows; the block's bound cuts after about k / warps
// rows a warp.  tk_bound does the same over the blocks' lists before
// tk_rank.
// Choices: a queue of 32 (one entry a lane: a ballot places the passing
// rows, one shuffle network sorts them); up to TK_WARPS (16) warps a
// block, fewer when a warp's lists ((nwords + 1) x (2 kpad + 32) words)
// would take the block past TK_BLOCK_SMEM (112 KB); one block an SM (the
// registers allow no more) with at least 256 rows a warp.  Input in the
// requested order fills each warp's list from its first rows and rejects
// the rest; reversed input passes every row and costs one merge per 32
// rows.
//
// k > TK_FILTER_MAX_K, up to TK_MAX_K (1024): the bitonic route.
//   tk_columns     block b sorts rows [b*CHUNK, (b+1)*CHUNK) — words built
//                  from the columns in shared memory, a bitonic sort of
//                  CHUNK entries — and writes its first k entries;
//   tk_candidates  the same over the candidates of the previous pass.
// The entry runs tk_columns once, then tk_candidates until one block is
// left; with CHUNK >= 2k every pass at least halves the candidates.  Empty
// slots carry the largest words and row number, so they sort after every
// row and come back as -1.
//
// Bound: device memory, each key column and the mask read once (at TPC-H
// Q3, ~1.29 M rows of a float64 sum with its validity and an int32 date:
// 13 B a row).  The filter route reads each row's words once from device
// memory and compares them once; the lists stay in shared memory.  The
// kernels' shared memory limit is raised once per process and device, and
// the scratch (gp, then the blocks' lists, or the bitonic route's
// candidate buffers) is sized by topk_scratch, which runs the same choices
// as the launch.

#include <atomic>

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define TK_THREADS 1024
#define TK_CHUNK 2048
#define TK_MAX_KEYS 4
#define TK_MAX_WORDS (2 * TK_MAX_KEYS)
#define TK_FILTER_MAX_K 128
#define TK_QUEUE 32
#define TK_WARPS 16
#define TK_PREFS 8   // per warp, the prefixes of its list entries 2^g - 1
#define TK_MAX_LISTS 512  // blocks of the filter route, at most
#define TK_BLOCK_SMEM (112 * 1024)
#define TK_SMEM_LIMIT (160 * 1024)
#define TK_FULL 0xffffffffu

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

// ---------------------------------------------------------------------------
// the filter route (k <= TK_FILTER_MAX_K)
// ---------------------------------------------------------------------------

// In registers an entry is 2 NK words, two a key (its null word, 0 for a
// key without nulls, then its value word), and a row number; NK is 2 or 4
// (TK_MAX_KEYS), a template argument, so two keys take half the
// registers.  In memory an entry is EW = nwords + 1 consecutive words: the
// words in use, then the row number.  Compared word by word, that is the
// entry order.
struct TKLayout {
  int nkeys;
  int nwords;
  unsigned vmask;  // bit c: key c has a null word
};

template <int NK>
struct TKEnt {
  long long w[2 * NK];
  long long row;
};

template <int NK>
__device__ __forceinline__ bool ent_less(const TKEnt<NK>& a,
                                         const TKEnt<NK>& b, int nkeys) {
#pragma unroll
  for (int q = 0; q < 2 * NK; ++q)
    if (q < 2 * nkeys && a.w[q] != b.w[q]) return a.w[q] < b.w[q];
  return a.row < b.row;
}

template <int NK>
__device__ __forceinline__ void row_ent(const TKArgs& a, long long r,
                                        TKEnt<NK>& e) {
#pragma unroll
  for (int c = 0; c < NK; ++c) {
    e.w[2 * c] = e.w[2 * c + 1] = 0;
    if (c >= a.nkeys) continue;
    if (a.valid[c] != nullptr) {
      const bool v = a.valid[c][r] != 0;
      e.w[2 * c] = a.nulls_first[c] ? (v ? 1 : 0) : (v ? 0 : 1);
    }
    const long long view = value_view(a, c, r);
    e.w[2 * c + 1] = a.desc[c] ? ~view : view;
  }
  e.row = r;
}

template <int NK>
__device__ __forceinline__ void load_ent(const long long* p,
                                         const TKLayout& f, TKEnt<NK>& e) {
  int q = 0;
#pragma unroll
  for (int c = 0; c < NK; ++c) {
    e.w[2 * c] = e.w[2 * c + 1] = 0;
    if (c >= f.nkeys) continue;
    if ((f.vmask >> c) & 1u) e.w[2 * c] = p[q++];
    e.w[2 * c + 1] = p[q++];
  }
  e.row = p[f.nwords];
}

template <int NK>
__device__ __forceinline__ void store_ent(long long* p, const TKLayout& f,
                                          const TKEnt<NK>& e) {
  int q = 0;
#pragma unroll
  for (int c = 0; c < NK; ++c) {
    if (c >= f.nkeys) continue;
    if ((f.vmask >> c) & 1u) p[q++] = e.w[2 * c];
    p[q++] = e.w[2 * c + 1];
  }
  p[f.nwords] = e.row;
}

// The entries of the sorted list of `len` entries at p (EW words an
// entry) below e.
template <int NK>
__device__ __forceinline__ int rank_in(const long long* __restrict__ p,
                                       int ew, int len, const TKLayout& f,
                                       const TKEnt<NK>& e) {
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    TKEnt<NK> x;  // every word at once: one wait a step
    load_ent(p + mid * ew, f, x);
    if (ent_less(x, e, f.nkeys))
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// A 64-bit image of an entry's first key, non-decreasing in the entry
// order: the value word with its sign bit flipped, behind the null word
// (which then takes the top bit, the value its upper 63 bits).
template <int NK>
__device__ __forceinline__ unsigned long long prefix_of(const TKEnt<NK>& e,
                                                        const TKLayout& f) {
  const unsigned long long v =
      (unsigned long long)e.w[1] ^ 0x8000000000000000ULL;
  if (!(f.vmask & 1u)) return v;
  return (e.w[0] != 0 ? 0x8000000000000000ULL : 0ULL) | (v >> 1);
}

__device__ __forceinline__ TKLayout layout_of(const TKArgs& a) {
  TKLayout f = {a.nkeys, a.nwords, 0u};
  for (int c = 0; c < a.nkeys; ++c)
    if (a.valid[c] != nullptr) f.vmask |= 1u << c;
  return f;
}

__device__ __forceinline__ int tk_region_words(int nwords, int kpad) {
  return (nwords + 1) * (2 * kpad + TK_QUEUE);
}

// One warp's lists in shared memory, EW words an entry: entries [0, kpad)
// and [kpad, 2 kpad) are the list and the buffer it is merged into,
// [2 kpad, 2 kpad + TK_QUEUE) the queue.  A row must be below `thr`, the
// list's k-th entry, and its first key's prefix not above `gp`.
template <int NK>
struct TKWarp {
  long long* base;
  int ew;
  int kpad;
  int k;
  int cur;  // the list's first entry: 0 or kpad
  int qc;   // entries in the queue
  TKEnt<NK> thr;
  unsigned long long gp;
};

template <int NK>
__device__ void warp_init(TKWarp<NK>& ws, long long* region, int kpad, int k,
                          const TKLayout& f, int lane) {
  ws.base = region;
  ws.ew = f.nwords + 1;
  ws.kpad = kpad;
  ws.k = k;
  ws.cur = 0;
  ws.qc = 0;
  ws.gp = ~0ULL;
  for (int i = lane; i < kpad * ws.ew; i += 32) region[i] = LLONG_MAX;
  __syncwarp();
  load_ent(region + (k - 1) * ws.ew, f, ws.thr);
}

template <int NK>
__device__ __forceinline__ TKEnt<NK> shfl_ent(const TKEnt<NK>& e, int mask) {
  TKEnt<NK> o;
#pragma unroll
  for (int q = 0; q < 2 * NK; ++q)
    o.w[q] = __shfl_xor_sync(TK_FULL, e.w[q], mask);
  o.row = __shfl_xor_sync(TK_FULL, e.row, mask);
  return o;
}

// Sorts one entry a lane across the warp (a bitonic network of shuffles).
template <int NK>
__device__ __forceinline__ void warp_sort(TKEnt<NK>& e, int nkeys, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const TKEnt<NK> o = shfl_ent(e, stride);
      const bool up = (lane & size) == 0, low = (lane & stride) == 0;
      const bool take = (low == up) ? ent_less(o, e, nkeys)
                                    : ent_less(e, o, nkeys);
      if (take) e = o;
    }
  }
}

// The lowest prefix bound the block's warps' lists give: per warp w and
// g, s_pref[w][g] is the prefix of w's list entry 2^g - 1 (all ones while
// empty), which only falls; m warps whose entries 2^g - 1 have prefixes
// not above P hold m 2^g rows not above P, so with m = ceil(k / 2^g) the
// m-th lowest of s_pref[.][g] bounds the result's prefixes.  Two g a
// call, the least with m <= warps and the next.
__device__ __forceinline__ unsigned long long block_bound(
    volatile unsigned long long (*s_pref)[TK_PREFS], int nw, int k,
    int kpad, int lane) {
  unsigned long long best = ~0ULL;
  int g = 0;
  while ((k + (1 << g) - 1) >> g > nw) ++g;
  for (int h = 0; h < 2 && (1 << (g + h)) <= kpad && g + h < TK_PREFS;
       ++h) {
    const int m = (k + (1 << (g + h)) - 1) >> (g + h);
    const unsigned long long v = lane < nw ? s_pref[lane][g + h] : ~0ULL;
    int lt = 0, le = 0;
    for (int o = 0; o < nw; ++o) {
      const unsigned long long x = __shfl_sync(TK_FULL, v, o);
      lt += x < v;
      le += x <= v;
    }
    const unsigned hit = __ballot_sync(TK_FULL, lane < nw && lt < m && m <= le);
    if (hit) {
      const unsigned long long p = __shfl_sync(TK_FULL, v, __ffs(hit) - 1);
      best = p < best ? p : best;
    }
  }
  return best;
}

// Merges the queue into the list, into the other buffer: the queue is
// sorted in registers and written back, then every entry's place is its
// index plus the entries of the other side below it (a binary search).
// Real entries are distinct (row numbers), so places are.  The list's
// entries 2^g - 1 go to s_pref, and the lower of the list's k-th entry's
// prefix and the block's bound lowers gp.
template <int NK>
__device__ void warp_flush(TKWarp<NK>& ws, const TKLayout& f, int lane,
                           unsigned long long* gp,
                           volatile unsigned long long (*s_pref)[TK_PREFS],
                           int warp, int nw) {
  __syncwarp();
  if (ws.qc == 0) return;
  long long* b = ws.base;
  const int ew = ws.ew, in = ws.cur, out = ws.kpad - ws.cur,
            qb = 2 * ws.kpad;
  TKEnt<NK> q;
  if (lane < ws.qc) {
    load_ent(b + (qb + lane) * ew, f, q);
  } else {
#pragma unroll
    for (int i = 0; i < 2 * NK; ++i) q.w[i] = LLONG_MAX;
    q.row = LLONG_MAX;
  }
  warp_sort(q, f.nkeys, lane);
  __syncwarp();
  store_ent(b + (qb + lane) * ew, f, q);
  __syncwarp();
  for (int i = lane; i < ws.kpad; i += 32) {
    TKEnt<NK> e;
    load_ent(b + (in + i) * ew, f, e);
    const int r = i + rank_in(b + qb * ew, ew, ws.qc, f, e);
    if (r < ws.kpad) store_ent(b + (out + r) * ew, f, e);
  }
  if (lane < ws.qc) {
    const int r = lane + rank_in(b + in * ew, ew, ws.kpad, f, q);
    if (r < ws.kpad) store_ent(b + (out + r) * ew, f, q);
  }
  __syncwarp();
  ws.cur = out;
  ws.qc = 0;
  load_ent(b + (out + ws.k - 1) * ew, f, ws.thr);
  if (lane < TK_PREFS && (1 << lane) <= ws.kpad) {
    TKEnt<NK> e;
    load_ent(b + (out + (1 << lane) - 1) * ew, f, e);
    if (e.row != LLONG_MAX) s_pref[warp][lane] = prefix_of(e, f);
  }
  __syncwarp();
  unsigned long long p = block_bound(s_pref, nw, ws.k, ws.kpad, lane);
  if (ws.thr.row != LLONG_MAX) {
    const unsigned long long own = prefix_of(ws.thr, f);
    p = own < p ? own : p;
  }
  if (p < ws.gp) {
    ws.gp = p;
    if (lane == 0) atomicMin(gp, p);
  }
}

// Offers each lane's entry (`has`: the lane holds one) to the warp's list.
template <int NK>
__device__ void warp_offer(TKWarp<NK>& ws, const TKLayout& f, bool has,
                           const TKEnt<NK>& e, int lane,
                           unsigned long long* gp,
                           volatile unsigned long long (*s_pref)[TK_PREFS],
                           int warp, int nw) {
  const bool near = has && prefix_of(e, f) <= ws.gp;
  bool pass = near && ent_less(e, ws.thr, f.nkeys);
  unsigned m = __ballot_sync(TK_FULL, pass);
  if (m == 0) return;
  if (ws.qc + __popc(m) > TK_QUEUE) {
    warp_flush(ws, f, lane, gp, s_pref, warp, nw);
    pass = near && prefix_of(e, f) <= ws.gp && ent_less(e, ws.thr, f.nkeys);
    m = __ballot_sync(TK_FULL, pass);
  }
  if (pass)
    store_ent(ws.base + (2 * ws.kpad + ws.qc +
                         __popc(m & ((1u << lane) - 1u))) * ws.ew,
              f, e);
  ws.qc += __popc(m);
  __syncwarp();
}

// Each warp keeps its own sorted list of its kpad best entries (rows in
// chunks of 64, every (gridDim.x * warps)-th chunk); at the end the block's
// k best of its warps' lists are placed by rank (an entry's place is its
// index plus, per other warp list, the entries below it) and written.  gp:
// preset to all ones; out: the blocks' lists, kpad entries each (the first
// k filled, the rest empty).
template <int NK>
__global__ void __launch_bounds__(TK_WARPS * 32)
tk_filter_rows(const __grid_constant__ TKArgs a,
               const uint8_t* __restrict__ active, long long n, int k,
               int kpad, unsigned long long* gp,
               long long* __restrict__ out) {
  extern __shared__ long long smem[];
  __shared__ int s_cur[TK_WARPS];
  __shared__ unsigned long long s_pref[TK_WARPS][TK_PREFS];
  const TKLayout f = layout_of(a);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32,
            nw = blockDim.x / 32, ew = f.nwords + 1,
            region = tk_region_words(f.nwords, kpad);
  if (lane < TK_PREFS) s_pref[warp][lane] = ~0ULL;
  __syncthreads();
  TKWarp<NK> ws;
  warp_init(ws, smem + warp * region, kpad, k, f, lane);
  const long long tw = (long long)gridDim.x * nw;
  for (long long c = (long long)blockIdx.x * nw + warp; c * 64 < n;
       c += tw) {
    const unsigned long long g = __ldcg(gp);
    if (g < ws.gp) ws.gp = g;
    const long long r0 = c * 64 + lane, r1 = r0 + 32;
    const bool has0 = r0 < n && (active == nullptr || active[r0]);
    const bool has1 = r1 < n && (active == nullptr || active[r1]);
    TKEnt<NK> e0 = {}, e1 = {};
    if (has0) row_ent(a, r0, e0);
    if (has1) row_ent(a, r1, e1);
    warp_offer(ws, f, has0, e0, lane, gp, s_pref, warp, nw);
    warp_offer(ws, f, has1, e1, lane, gp, s_pref, warp, nw);
  }
  warp_flush(ws, f, lane, gp, s_pref, warp, nw);
  if (lane == 0) s_cur[warp] = ws.cur;
  long long* mine = out + (long long)blockIdx.x * kpad * ew;
  for (int i = threadIdx.x; i < kpad * ew; i += blockDim.x)
    mine[i] = LLONG_MAX;
  __syncthreads();
  for (int u = threadIdx.x; u < nw * k; u += blockDim.x) {
    const int w = u / k, i = u % k;
    TKEnt<NK> e;
    load_ent(smem + w * region + (s_cur[w] + i) * ew, f, e);
    if (e.row == LLONG_MAX) continue;
    int place = i;
    for (int o = 0; o < nw && place < k; ++o)
      if (o != w)
        place += rank_in(smem + o * region + s_cur[o] * ew, ew, k, f, e);
    if (place < k) store_ent(mine + place * ew, f, e);
  }
}

// The prefix bound tk_rank prunes with, as block_bound makes it over the
// blocks' lists: per g with 2^g - 1 < k, m = ceil(k / 2^g) lists whose
// entries 2^g - 1 have prefixes not above P hold k rows not above P, so
// the m-th lowest of those prefixes (when there are m lists) bounds the
// result; the lowest of these, and gp.  One block: a thread per (g, list)
// counts the prefixes of its g below its own, reading them from shared
// memory in step.
template <int NK>
__global__ void __launch_bounds__(1024)
tk_bound(int nkeys, int nwords, unsigned vmask,
         const long long* __restrict__ lists, int lists_n, int k, int kpad,
         unsigned long long* gp) {
  __shared__ unsigned long long s_p[TK_PREFS][TK_MAX_LISTS];
  __shared__ unsigned long long s_best;
  const TKLayout f = {nkeys, nwords, vmask};
  const int ew = nwords + 1;
  if (threadIdx.x == 0) s_best = *gp;
  for (int u = threadIdx.x; u < TK_PREFS * lists_n; u += blockDim.x) {
    const int g = u / lists_n, o = u % lists_n, j = (1 << g) - 1;
    unsigned long long p = ~0ULL;
    if (j < k) {
      TKEnt<NK> e;
      load_ent(lists + ((long long)o * kpad + j) * ew, f, e);
      if (e.row != LLONG_MAX) p = prefix_of(e, f);
    }
    s_p[g][o] = p;
  }
  __syncthreads();
  for (int u = threadIdx.x; u < TK_PREFS * lists_n; u += blockDim.x) {
    const int g = u / lists_n, o = u % lists_n;
    const int m = (k + (1 << g) - 1) >> g;
    const unsigned long long v = s_p[g][o];
    if (m > lists_n || v == ~0ULL) continue;
    int lt = 0, le = 0;
    for (int x = 0; x < lists_n; ++x) {
      lt += s_p[g][x] < v;
      le += s_p[g][x] <= v;
    }
    if (lt < m && m <= le) atomicMin(&s_best, v);
  }
  __syncthreads();
  if (threadIdx.x == 0) *gp = s_best;
}

// One warp per entry i < k of each block's list: its place among all the
// lists' entries is i plus, per other list, the entries below it (a binary
// search a lane); an entry whose place is below k is written there.  Real
// entries are distinct (row numbers), so places are.  A list holds only
// its block's kpad best rows, but an entry it leaves out has kpad rows of
// that list before it, so every entry of the result is placed exactly.
// Entries whose prefix is above `bound` (tk_bound) leave at once.  out:
// preset to -1.
template <int NK>
__global__ void __launch_bounds__(256)
tk_rank(int nkeys, int nwords, unsigned vmask,
        const long long* __restrict__ lists, int lists_n, int k, int kpad,
        const unsigned long long* __restrict__ bound,
        long long* __restrict__ out) {
  const TKLayout f = {nkeys, nwords, vmask};
  const int ew = nwords + 1, lane = threadIdx.x % 32;
  const long long w = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  if (w >= (long long)lists_n * k) return;
  const int b = (int)(w / k), i = (int)(w % k);
  TKEnt<NK> e;
  load_ent(lists + ((long long)b * kpad + i) * ew, f, e);
  if (e.row == LLONG_MAX || prefix_of(e, f) > *bound) return;
  int place = i;
  for (int b0 = 0; b0 < lists_n; b0 += 32) {
    const int o = b0 + lane;
    int below = 0;
    if (o < lists_n && o != b)
      below = rank_in(lists + (long long)o * kpad * ew, ew, k, f, e);
    for (int m = 16; m > 0; m >>= 1)
      below += __shfl_xor_sync(TK_FULL, below, m);
    place += below;
    if (place >= k) return;
  }
  if (lane == 0) out[place] = e.row;
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

static long long tk_blocks(long long n) {
  return (n + TK_CHUNK - 1) / TK_CHUNK;
}

// The filter route's shape for these arguments: kpad, warps a block and
// blocks.
struct TKShape {
  int kpad;
  int warps;
  long long blocks;
  size_t smem;
};

static cudaError_t tk_shape(long long n, int k, int nwords, TKShape* sh) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  sh->kpad = (k + 31) / 32 * 32;
  const size_t warp_bytes =
      (size_t)(nwords + 1) * (2 * sh->kpad + TK_QUEUE) * sizeof(long long);
  const int warps = (int)(TK_BLOCK_SMEM / warp_bytes);
  sh->warps = warps < 1 ? 1 : (warps > TK_WARPS ? TK_WARPS : warps);
  sh->smem = sh->warps * warp_bytes;
  const long long per_block = 256LL * sh->warps;
  const long long want = (n + per_block - 1) / per_block;
  const long long cap = sms < TK_MAX_LISTS ? sms : TK_MAX_LISTS;
  sh->blocks = want < 1 ? 1 : (want < cap ? want : cap);
  return cudaSuccess;
}

// Raises the kernels' dynamic shared memory limit, once per process and
// device.
static cudaError_t tk_allow_smem() {
  static std::atomic<unsigned long long> done(0);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ULL << (dev & 63);
  if (done.load() & bit) return cudaSuccess;
  const void* fns[] = {(const void*)tk_columns, (const void*)tk_candidates,
                       (const void*)tk_filter_rows<2>,
                       (const void*)tk_filter_rows<TK_MAX_KEYS>};
  for (const void* fn : fns) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               TK_SMEM_LIMIT);
    if (err != cudaSuccess) return err;
  }
  done.fetch_or(bit);
  return cudaSuccess;
}

// Bytes of scratch `topk` needs for these arguments (nwords: the words a
// row's tuple has, one a key plus one a key with nulls); a negative CUDA
// error code on failure.
extern "C" long long topk_scratch(long long n, int k, int nwords) {
  if (k < 1 || nwords < 1 || nwords > TK_MAX_WORDS || n < 0)
    return -(long long)cudaErrorInvalidValue;
  if (k > TK_FILTER_MAX_K) {
    const long long blocks = tk_blocks(n) < 1 ? 1 : tk_blocks(n);
    return 2 * blocks * k * (nwords + 1) * (long long)sizeof(long long);
  }
  TKShape sh;
  const cudaError_t err = tk_shape(n, k, nwords, &sh);
  if (err != cudaSuccess) return -(long long)err;
  return (1 + sh.blocks * sh.kpad * (nwords + 1)) *
         (long long)sizeof(long long);
}

static cudaError_t tk_bitonic(const TKArgs& a, const uint8_t* active,
                              long long n, int k, long long* scratch,
                              long long* out, cudaStream_t s) {
  const int nwords = a.nwords;
  const size_t smem = (size_t)(nwords + 1) * TK_CHUNK * sizeof(long long);
  long long blocks = tk_blocks(n) < 1 ? 1 : tk_blocks(n);
  const long long half = blocks * k * (nwords + 1);
  long long* buf[2] = {scratch, scratch + half};
  long long m = blocks * k;  // entries in the current candidate buffer
  tk_columns<<<(int)blocks, TK_THREADS, smem, s>>>(
      a, active, n, k, buf[0], buf[0] + (long long)nwords * m, m);
  cudaError_t err = cudaGetLastError();
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
  if (err != cudaSuccess) return err;
  tk_finish<<<1, 1024, 0, s>>>(buf[cur] + (long long)nwords * m, k, out);
  return cudaGetLastError();
}

// Host entry, bound with ctypes.  The per-key arrays are host arrays.
// `scratch` holds topk_scratch(n, k, nwords) bytes.  `out` receives k
// int64 row indices, -1 past the live rows.
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
  unsigned vmask = 0;
  for (int c = 0; c < nkeys; ++c) {
    if (kinds[c] < K_INT32 || kinds[c] > K_BOOL)
      return (int)cudaErrorInvalidValue;
    a.data[c] = data[c];
    a.valid[c] = static_cast<const uint8_t*>(valid[c]);
    a.kind[c] = kinds[c];
    a.desc[c] = desc[c] != 0;
    a.nulls_first[c] = nulls_first[c] != 0;
    nwords += valid[c] != nullptr ? 2 : 1;
    if (valid[c] != nullptr) vmask |= 1u << c;
  }
  a.nkeys = nkeys;
  a.nwords = nwords;
  cudaError_t err = tk_allow_smem();
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* act = static_cast<const uint8_t*>(active);
  long long* buf = static_cast<long long*>(scratch);
  long long* idx = static_cast<long long*>(out);
  if (k > TK_FILTER_MAX_K) return (int)tk_bitonic(a, act, n, k, buf, idx, s);
  TKShape sh;
  err = tk_shape(n, k, nwords, &sh);
  if (err != cudaSuccess) return (int)err;
  // scratch: the prefix bound gp, then the blocks' lists
  unsigned long long* gp = reinterpret_cast<unsigned long long*>(buf);
  long long* lists = buf + 1;
  err = cudaMemsetAsync(gp, 0xff, sizeof(unsigned long long), s);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(idx, 0xff, (size_t)k * sizeof(long long), s);
  if (err != cudaSuccess) return (int)err;
  const int nb = (int)sh.blocks, threads = sh.warps * 32;
  const int rank_blocks = (int)(((long long)nb * k * 32 + 255) / 256);
  if (nkeys <= 2) {
    tk_filter_rows<2><<<nb, threads, sh.smem, s>>>(a, act, n, k, sh.kpad, gp,
                                                   lists);
    tk_bound<2><<<1, 1024, 0, s>>>(nkeys, nwords, vmask, lists, nb, k,
                                   sh.kpad, gp);
    tk_rank<2><<<rank_blocks, 256, 0, s>>>(nkeys, nwords, vmask, lists, nb,
                                           k, sh.kpad, gp, idx);
  } else {
    tk_filter_rows<TK_MAX_KEYS><<<nb, threads, sh.smem, s>>>(
        a, act, n, k, sh.kpad, gp, lists);
    tk_bound<TK_MAX_KEYS><<<1, 1024, 0, s>>>(nkeys, nwords, vmask, lists,
                                             nb, k, sh.kpad, gp);
    tk_rank<TK_MAX_KEYS><<<rank_blocks, 256, 0, s>>>(
        nkeys, nwords, vmask, lists, nb, k, sh.kpad, gp, idx);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
