// grid_agg: grouped sums over a dense grid of dictionary-code slots, added
// into a device accumulator that lives for the whole query.
//
// Replaces: spark_rapids_tpu/ops/groupby.py:424 grid_group_reduce, run per
// batch by plan/physical.py:1768 _grid_program and merged by _merge_partials
// (:2211).
//
// Each row's slot is the mixed-radix number of its k key codes,
// gid = ((c0 * (d1+1)) + c1) * (d2+1) + ..., where a NULL key takes the
// extra slot d_i of its dimension; G = prod(d_i + 1).  The slot id is
// computed here and never written out.  Per slot the kernel adds nf float64
// columns, ni int64 columns (an int64 channel with no data counts the rows
// where its validity mask holds) and a presence count of live rows.
// int64 sums wrap modulo 2^64 like the reference's.  Key codes must lie in
// [0, d_i): the caller's dictionary guarantees it.
//
// Bound: device memory.  Each input byte is read once: n x (1 B active mask
// + 4 B per key code + 1 B per key or column validity mask + 8 B per data
// column), over 3.35 TB/s on an H100 SXM.  At TPC-H Q1 that is
// 2 x 4 + 1 + 7 x 8 = 65 B a row.
//
// Design: one pass over the rows a call, no contended atomics.
//   * float64 sums at the query's scale (fixed128.cuh): the first call
//     with finite non-zero values sets each column's scale from its largest
//     |x| (ga_prepare, a read of the float columns that returns at once
//     once every scale is set); a value within 2^-21..2^19 of that |x| is
//     an exact 128-bit integer at the scale and adds once, at its row,
//     into the slot's query-scale pair `q`, kept across calls.  The pairs
//     become float64 only when the output is read (grid_agg_fold, over the
//     G x nf cells).  Sums are integers, so they are equal to the bit from
//     run to run.
//   * the fallback, decided on the device: any other finite non-zero value
//     (far outside the scale's range) raises its cell's per-call
//     largest-|x| word in the same pass and sets the call's fallback flag.
//     One more launch follows every call and returns at once when the flag
//     is clear: ga_fallback adds those values at the cell's per-call scale
//     (a second pass over the rows, only when the flag is set) and its last
//     block turns each touched cell into float64 and adds it to the slot's
//     float64 word.  The flags alternate by the call's parity, so each call
//     clears the next call's flag without a memset; the scale words and
//     flags start zeroed (a scale word is s + FX_SCALE_BIAS).  Infinities
//     and NaN go to the float64 word with atomicAdd (their sums do not
//     depend on the order).  Launches a call: ga_prepare (float64
//     columns), ga_update, ga_fallback.
//   * reduce before any shared atomic: a warp's lanes that hold one slot
//     combine their 128-bit integers, int64 words and count with shuffles
//     (one __match_any_sync, then a pointer-jumping reduction whose steps
//     follow the warp's largest group, not its number of groups: the
//     WarpGroup helpers below), and one leader per slot adds them.  TPC-H
//     Q1 has 6 live slots of 15: 15 shared atomics a row from every lane
//     (about 62 M per batch on ~6 addresses) become about 6 leaders' 15 a
//     warp step.
//   * ga_update<SHARED>: when the grid, G x (2 nf + ni + 1) x 8 B, fits in
//     48 KB of shared memory (with the kernel's own words beside it, past
//     what a block may take without opting in: the launch opts in), each
//     block keeps a private grid there and flushes its non-zero words once
//     with device atomics; otherwise the leaders add straight into device
//     memory (a grid that large spreads rows over many slots).  The caller
//     picks the variant (use_shared), so both stay testable.
//   * wide loads: a lane takes 16 consecutive rows, its active mask as one
//     16-byte word, then 4 rows at a time their key codes as a 16-byte word
//     per key, validity masks as 4-byte words and each column's 4 values
//     as two 16-byte words (one 32-byte sector a lane).  Views whose
//     storage is not 16-byte aligned (an odd storage offset), and a unit
//     that runs past n, load a row at a time: the same kernel, WIDE false.
//   * grid: SM count x the blocks an SM holds at the call's shared memory
//     (cudaOccupancyMaxActiveBlocksPerMultiprocessor, queried once per
//     process and variant), capped at one 16-row unit a thread.  Measured
//     at Q1's shape (tools/agg_bench.py, H100): 0.302 ms; capped at 2
//     blocks an SM 0.439, at 4 0.302; with 4 (8) columns' values loaded
//     before any is used 0.458 (0.755): the registers cost more than the
//     loads in flight gained.
// The argument struct is __grid_constant__, so the helpers read it in
// place instead of copying 2 KB to each thread's stack.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fixed128.cuh"

// The warp's lanes of one slot, combined in registers before any atomic.
//
// __match_any_sync splits the warp into groups of lanes with equal keys.
// Each lane links to the next higher lane of its group, and a sum (or min,
// or max) over the group is a pointer-jumping reduction: at step s each
// lane adds the partial of the lane 2^s ranks above it and takes that
// lane's link, so after ceil(log2(largest group)) steps the group's lowest
// lane, its leader, holds the whole.  The steps do not depend on how many
// groups the warp holds (one shuffle per 32-bit word a step), and a warp
// whose groups are all single lanes takes none.  Every lane of the warp
// must call these together (a warp-uniform loop); a lane with no
// contribution passes a key of its own (wg_dead_key) so it groups with no
// other lane.

#define WG_FULL 0xffffffffu

struct WarpGroup {
  unsigned peers;  // the lanes of my group
  int next;        // the next higher lane of my group, -1 at its top
  int steps;       // reduction steps the warp's largest group needs
  bool leader;     // the lowest lane of my group
};

// A key no group id takes (group ids are >= 0), distinct per lane.
__device__ __forceinline__ long long wg_dead_key() {
  return -1LL - (long long)(threadIdx.x & 31);
}

__device__ __forceinline__ WarpGroup wg_make(long long key) {
  const unsigned lane = threadIdx.x & 31;
  WarpGroup g;
  g.peers = __match_any_sync(WG_FULL, (unsigned long long)key);
  const unsigned above = lane == 31 ? 0u : g.peers & (~0u << (lane + 1));
  g.next = above ? __ffs(above) - 1 : -1;
  g.leader = (g.peers & ((1u << lane) - 1u)) == 0u;
  const unsigned largest = __reduce_max_sync(WG_FULL, __popc(g.peers));
  g.steps = largest > 1 ? 32 - __clz(largest - 1) : 0;
  return g;
}

// One pointer-jumping step's partner: my link, or myself past the top.
__device__ __forceinline__ int wg_src(int next) {
  return next < 0 ? (int)(threadIdx.x & 31) : next;
}

__device__ __forceinline__ unsigned long long wg_shfl(unsigned long long v,
                                                      int src) {
  return (unsigned long long)__shfl_sync(WG_FULL, (long long)v, src);
}

// The group's 64-bit wrapping sum, whole at its leader.
__device__ __forceinline__ unsigned long long wg_sum(const WarpGroup& g,
                                                     unsigned long long v) {
  int nx = g.next;
  for (int s = 0; s < g.steps; ++s) {
    const int src = wg_src(nx);
    const unsigned long long o = wg_shfl(v, src);
    const int nn = __shfl_sync(WG_FULL, nx, src);
    if (nx >= 0) {
      v += o;
      nx = nn;
    }
  }
  return v;
}

// The group's 128-bit two's-complement sum (lo, hi), whole at its leader.
__device__ __forceinline__ void wg_sum128(const WarpGroup& g,
                                          unsigned long long* lo,
                                          unsigned long long* hi) {
  int nx = g.next;
  for (int s = 0; s < g.steps; ++s) {
    const int src = wg_src(nx);
    const unsigned long long olo = wg_shfl(*lo, src);
    const unsigned long long ohi = wg_shfl(*hi, src);
    const int nn = __shfl_sync(WG_FULL, nx, src);
    if (nx >= 0) {
      const unsigned long long s2 = *lo + olo;
      *hi += ohi + (s2 < *lo ? 1ULL : 0ULL);
      *lo = s2;
      nx = nn;
    }
  }
}

// The group's signed minimum (is_max false) or maximum, whole at its
// leader.
__device__ __forceinline__ long long wg_extreme(const WarpGroup& g,
                                                long long v, bool is_max) {
  int nx = g.next;
  for (int s = 0; s < g.steps; ++s) {
    const int src = wg_src(nx);
    const long long o = __shfl_sync(WG_FULL, v, src);
    const int nn = __shfl_sync(WG_FULL, nx, src);
    if (nx >= 0) {
      v = is_max ? (o > v ? o : v) : (o < v ? o : v);
      nx = nn;
    }
  }
  return v;
}

#define GA_MAX_KEYS 8
#define GA_MAX_COLS 32
#define GA_THREADS 256
#define GA_UNIT 16  // rows a lane takes: one 16-byte word of the mask
#define GA_SMEM_OPT_IN (64 * 1024)  // dynamic shared memory a block may take

struct GAArgs {
  const int* codes[GA_MAX_KEYS];
  const uint8_t* code_valid[GA_MAX_KEYS];  // nullptr: no NULL keys
  int dims[GA_MAX_KEYS];
  int nkeys;
  const double* f[GA_MAX_COLS];
  const uint8_t* f_valid[GA_MAX_COLS];
  int nf;
  const long long* i[GA_MAX_COLS];  // nullptr: a count channel
  const uint8_t* i_valid[GA_MAX_COLS];
  int ni;
  const uint8_t* active;
  long long n;
  int G;
  double* acc_f;               // [G][nf]
  unsigned long long* acc_i;   // [G][ni]
  unsigned long long* acc_cnt; // [G]
  unsigned long long* q;       // [G][nf][2] query-scale integers, kept
  unsigned long long* fb;      // [G][nf][3] fallback words, zero between calls
  long long* words;            // [nf] largest |x| bits, [nf] scale words,
                               // [2] fallback flags, [1] a ticket
  long long call;              // the call's number (its flag's parity)
};

__device__ __forceinline__ long long* fb_flag(const GAArgs& a, long long call) {
  return a.words + 2 * a.nf + (call & 1);
}

// 4 bytes of rows r0..r0+3 as one word (byte t: row r0 + t); rows past n
// read as 0.
template <bool WIDE>
__device__ __forceinline__ unsigned load4_u8(const uint8_t* p, long long r0,
                                             long long n, bool full) {
  if (WIDE && full) return __ldg(reinterpret_cast<const unsigned*>(p + r0));
  unsigned w = 0;
#pragma unroll
  for (int t = 0; t < 4; ++t)
    if (r0 + t < n) w |= (unsigned)__ldg(p + r0 + t) << (8 * t);
  return w;
}

__device__ __forceinline__ bool byte_of(unsigned w, int t) {
  return ((w >> (8 * t)) & 0xffu) != 0u;
}

template <bool WIDE>
__device__ __forceinline__ void load4_i32(const int* p, long long r0,
                                          long long n, bool full, int v[4]) {
  if (WIDE && full) {
    const int4 x = __ldg(reinterpret_cast<const int4*>(p + r0));
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
    return;
  }
#pragma unroll
  for (int t = 0; t < 4; ++t) v[t] = r0 + t < n ? __ldg(p + r0 + t) : 0;
}

// 4 8-byte words of rows r0..r0+3 (doubles as their bits).
template <bool WIDE>
__device__ __forceinline__ void load4_u64(const void* p, long long r0,
                                          long long n, bool full,
                                          long long v[4]) {
  const long long* w = static_cast<const long long*>(p);
  if (WIDE && full) {
    const longlong2 a = __ldg(reinterpret_cast<const longlong2*>(w + r0));
    const longlong2 b = __ldg(reinterpret_cast<const longlong2*>(w + r0 + 2));
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
    return;
  }
#pragma unroll
  for (int t = 0; t < 4; ++t) v[t] = r0 + t < n ? __ldg(w + r0 + t) : 0;
}

// The slot words a leader adds into: the block's private grid (SHARED) or
// the device accumulators.
template <bool SHARED>
struct GridTarget {
  unsigned long long* grid;  // [G][2 nf + ni + 1] (SHARED)
  int W;

  __device__ __forceinline__ unsigned long long* q(const GAArgs& a, int g,
                                                   int j) const {
    return SHARED ? grid + (long long)g * W + 2 * j
                  : a.q + 2 * ((long long)g * a.nf + j);
  }
  __device__ __forceinline__ unsigned long long* i(const GAArgs& a, int g,
                                                   int j) const {
    return SHARED ? grid + (long long)g * W + 2 * a.nf + j
                  : a.acc_i + (long long)g * a.ni + j;
  }
  __device__ __forceinline__ unsigned long long* cnt(const GAArgs& a,
                                                     int g) const {
    return SHARED ? grid + (long long)g * W + 2 * a.nf + a.ni
                  : a.acc_cnt + g;
  }
};

// One float64 column's 4 rows of a sub-unit into their slots: each
// value at the query scale, combined over the warp's lanes of a slot and
// added once by its leader; far values to the fallback, specials to the
// float64 word.
template <bool SHARED>
__device__ __forceinline__ void add_f64_column(
    const GAArgs& a, const GridTarget<SHARED>& to, const WarpGroup* wg,
    const bool* live, const int* gid, int j, const long long* bits,
    unsigned ok, long long sc, long long* flag) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const double x = __longlong_as_double(bits[t]);
    unsigned long long lo = 0, hi = 0, fbx = 0;
    if (live[t] && byte_of(ok, t)) {
      if (!isfinite(x)) {  // inf and NaN sums do not depend on the order
        atomicAdd(a.acc_f + (long long)gid[t] * a.nf + j, x);
      } else if (x != 0.0) {
        if (fx_in_range(x, sc))
          fx_int(x, fx_scale_of(sc), &lo, &hi);
        else
          fbx = (unsigned long long)__double_as_longlong(fabs(x));
      }
    }
    wg_sum128(wg[t], &lo, &hi);
    if (wg[t].leader && live[t] && (lo | hi) != 0ULL)
      fx_add_words(to.q(a, gid[t], j), lo, hi);
    if (__any_sync(WG_FULL, fbx != 0ULL)) {  // rare: the fallback
      const unsigned long long m =
          (unsigned long long)wg_extreme(wg[t], (long long)fbx, true);
      if (wg[t].leader && live[t] && m != 0ULL) {
        unsigned long long* w = a.fb + 3 * ((long long)gid[t] * a.nf + j) + 2;
        if (m > *w) atomicMax(w, m);
      }
      if (lane == 0 && *flag == 0) *flag = 1;
    }
  }
}

template <bool SHARED, bool WIDE>
__global__ void __launch_bounds__(GA_THREADS)
ga_update(const __grid_constant__ GAArgs a) {
  extern __shared__ unsigned long long grid[];
  __shared__ long long s_scale[GA_MAX_COLS];
  const int W = 2 * a.nf + a.ni + 1;
  if (SHARED)
    for (int t = threadIdx.x; t < a.G * W; t += blockDim.x) grid[t] = 0ULL;
  if ((int)threadIdx.x < a.nf) {
    // the column's query scale: set, or made now from the largest |x| the
    // first calls' fallback left (every block makes the same; block 0
    // keeps it)
    const int j = threadIdx.x;
    long long sc = a.words[a.nf + j];
    if (sc == 0 && a.words[j] != 0) {
      sc = fx_scale_word((unsigned long long)a.words[j]);
      if (blockIdx.x == 0) a.words[a.nf + j] = sc;
    }
    s_scale[j] = sc;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *fb_flag(a, a.call + 1) = 0;
  __syncthreads();
  const GridTarget<SHARED> to{grid, W};
  long long* flag = fb_flag(a, a.call);
  const int lane = threadIdx.x & 31;
  const long long n = a.n;
  const long long units = (n + GA_UNIT - 1) / GA_UNIT;
  const long long warps = (long long)gridDim.x * (blockDim.x / 32);
  // warp-uniform: every lane runs every step, lanes past the end with no
  // live row
  for (long long wu = ((long long)blockIdx.x * (blockDim.x / 32) +
                       threadIdx.x / 32) * 32;
       wu < units; wu += warps * 32) {
    const long long base = (wu + lane) * GA_UNIT;
    const bool full16 = base + GA_UNIT <= n;
    unsigned live16[4];
    if (WIDE && full16) {
      const uint4 m = __ldg(reinterpret_cast<const uint4*>(a.active + base));
      live16[0] = m.x; live16[1] = m.y; live16[2] = m.z; live16[3] = m.w;
    } else {
#pragma unroll
      for (int s = 0; s < 4; ++s)
        live16[s] = load4_u8<false>(a.active, base + 4 * s, n, false);
    }
#pragma unroll 1
    for (int s = 0; s < 4; ++s) {
      const long long r0 = base + 4 * s;
      const bool full = r0 + 4 <= n;
      int gid[4] = {0, 0, 0, 0};
      for (int k = 0; k < a.nkeys; ++k) {
        const int d = a.dims[k];
        int c[4];
        load4_i32<WIDE>(a.codes[k], r0, n, full, c);
        const unsigned ok = a.code_valid[k] == nullptr ? 0x01010101u
            : load4_u8<WIDE>(a.code_valid[k], r0, n, full);
#pragma unroll
        for (int t = 0; t < 4; ++t)
          gid[t] = gid[t] * (d + 1) + (byte_of(ok, t) ? c[t] : d);
      }
      WarpGroup wg[4];
      bool live[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        live[t] = byte_of(live16[s], t);
        wg[t] = wg_make(live[t] ? gid[t] : wg_dead_key());
        if (wg[t].leader && live[t])
          atomicAdd(to.cnt(a, gid[t]), (unsigned long long)__popc(wg[t].peers));
      }
      for (int j = 0; j < a.nf; ++j) {
        long long bits[4];
        load4_u64<WIDE>(a.f[j], r0, n, full, bits);
        const unsigned ok = a.f_valid[j] == nullptr ? 0x01010101u
            : load4_u8<WIDE>(a.f_valid[j], r0, n, full);
        add_f64_column(a, to, wg, live, gid, j, bits, ok, s_scale[j], flag);
      }
      for (int j = 0; j < a.ni; ++j) {
        long long v[4] = {1, 1, 1, 1};
        if (a.i[j] != nullptr) load4_u64<WIDE>(a.i[j], r0, n, full, v);
        const unsigned ok = a.i_valid[j] == nullptr ? 0x01010101u
            : load4_u8<WIDE>(a.i_valid[j], r0, n, full);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const unsigned long long x =
              live[t] && byte_of(ok, t) ? (unsigned long long)v[t] : 0ULL;
          const unsigned long long sum = wg_sum(wg[t], x);
          if (wg[t].leader && live[t] && sum != 0ULL)
            atomicAdd(to.i(a, gid[t], j), sum);
        }
      }
    }
  }
  if (!SHARED) return;
  __syncthreads();
  for (int t = threadIdx.x; t < a.G * W; t += blockDim.x) {
    const int g = t / W, c = t % W;
    if (c < 2 * a.nf) {
      if (c % 2 == 0)  // the pair (lo, hi) of column c / 2
        fx_add_words(a.q + 2 * ((long long)g * a.nf + c / 2), grid[t],
                     grid[t + 1]);
      continue;
    }
    const unsigned long long v = grid[t];
    if (v == 0ULL) continue;
    if (c < 2 * a.nf + a.ni)
      atomicAdd(a.acc_i + (long long)g * a.ni + (c - 2 * a.nf), v);
    else
      atomicAdd(a.acc_cnt + g, v);
  }
}

// While a column's query scale is not set (the first calls with rows), its
// largest finite |x| over the call's live rows into words[j] (one atomic a
// block), from which ga_update makes the scale: so the first call adds at
// the query scale too.  Once every scale is set the blocks return at once.
__global__ void __launch_bounds__(GA_THREADS)
ga_prepare(const __grid_constant__ GAArgs a) {
  __shared__ unsigned long long s_max[GA_THREADS / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (int j = 0; j < a.nf; ++j) {
    if (a.words[a.nf + j] != 0) continue;
    unsigned long long m = 0;
    for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         r < a.n; r += stride) {
      if (!a.active[r] || (a.f_valid[j] != nullptr && !a.f_valid[j][r]))
        continue;
      const double x = a.f[j][r];
      if (!fx_finite_nonzero(x)) continue;
      const unsigned long long b =
          (unsigned long long)__double_as_longlong(fabs(x));
      m = b > m ? b : m;
    }
    for (int o = 16; o > 0; o >>= 1) {
      const unsigned long long o2 = __shfl_down_sync(WG_FULL, m, o);
      m = o2 > m ? o2 : m;
    }
    if (lane == 0) s_max[warp] = m;
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int w = 1; w < GA_THREADS / 32; ++w) m = s_max[w] > m ? s_max[w] : m;
      if (m) atomicMax(reinterpret_cast<unsigned long long*>(a.words + j), m);
    }
    __syncthreads();
  }
}

// The row's slot (as ga_update computes it) for a row a thread reads alone.
__device__ __forceinline__ int grid_id(const GAArgs& a, long long r) {
  int gid = 0;
  for (int k = 0; k < a.nkeys; ++k) {
    const int d = a.dims[k];
    const bool ok = a.code_valid[k] == nullptr || a.code_valid[k][r];
    gid = gid * (d + 1) + (ok ? a.codes[k][r] : d);
  }
  return gid;
}

// The fallback (only when this call's flag is set): each value ga_update
// left to it added at its cell's per-call scale; then the launch's last
// block (a ticket) turns each touched cell's integer into float64 and adds
// it to the slot's float64 word, the cell's words cleared.
__global__ void __launch_bounds__(GA_THREADS)
ga_fallback(const __grid_constant__ GAArgs a) {
  if (*fb_flag(a, a.call) == 0) return;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       r < a.n; r += stride) {
    if (!a.active[r]) continue;
    const long long g = grid_id(a, r);
    for (int j = 0; j < a.nf; ++j) {
      if (a.f_valid[j] != nullptr && !a.f_valid[j][r]) continue;
      const double x = a.f[j][r];
      if (!fx_finite_nonzero(x) || fx_in_range(x, a.words[a.nf + j]))
        continue;
      unsigned long long* w = a.fb + 3 * (g * a.nf + j);
      fx_add(w, x, fx_scale(w[2], a.n));
    }
  }
  __shared__ bool s_last;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    unsigned long long* t =
        reinterpret_cast<unsigned long long*>(a.words + 2 * a.nf + 2);
    s_last = atomicAdd(t, 1ULL) == (unsigned long long)gridDim.x - 1;
    if (s_last) *t = 0ULL;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (long long c = threadIdx.x; c < (long long)a.G * a.nf;
       c += blockDim.x) {
    unsigned long long* w = a.fb + 3 * c;
    if (w[2] == 0ULL) continue;
    a.acc_f[c] += fx_value(w, a.n);
    w[0] = w[1] = w[2] = 0ULL;
  }
}

// Each cell's query-scale integer into its float64 word, cleared.
__global__ void __launch_bounds__(GA_THREADS)
ga_fold(unsigned long long* __restrict__ q, double* __restrict__ acc_f,
        const long long* __restrict__ words, int nf, long long cells) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       c < cells; c += stride) {
    unsigned long long* p = q + 2 * c;
    const long long sc = words[nf + (int)(c % nf)];
    if (sc == 0 || (p[0] | p[1]) == 0ULL) continue;
    acc_f[c] += fx_to_double(p[0], p[1], fx_scale_of(sc));
    p[0] = p[1] = 0ULL;
  }
}

static cudaError_t sm_count(int* sms) {
  static int cached = 0;
  if (cached == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&cached, cudaDevAttrMultiProcessorCount,
                                   dev);
    if (err != cudaSuccess) return err;
  }
  *sms = cached;
  return cudaSuccess;
}

// Blocks an SM holds of `kernel` at `smem` bytes, queried once per
// process, kernel and size.
static cudaError_t per_sm(const void* kernel, size_t smem, int* out) {
  static struct { const void* k; size_t smem; int per_sm; } seen[32];
  static int nseen = 0;
  for (int s = 0; s < nseen; ++s)
    if (seen[s].k == kernel && seen[s].smem == smem) {
      *out = seen[s].per_sm;
      return cudaSuccess;
    }
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, kernel, GA_THREADS, smem);
  if (err != cudaSuccess) return err;
  if (*out < 1) *out = 1;
  if (nseen < 32) seen[nseen++] = {kernel, smem, *out};
  return cudaSuccess;
}

static bool aligned16(const void* p) {
  return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15u) == 0u;
}

template <bool SHARED, bool WIDE>
static cudaError_t launch_update(const GAArgs& a, size_t smem, int sms,
                                 cudaStream_t s) {
  const void* fn = reinterpret_cast<const void*>(&ga_update<SHARED, WIDE>);
  cudaError_t err;
  if (SHARED) {
    // a 48 KB grid beside the kernel's static shared words needs the
    // opt-in (once per process and variant)
    static bool opted = false;
    if (!opted) {
      err = cudaFuncSetAttribute(fn,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 GA_SMEM_OPT_IN);
      if (err != cudaSuccess) return err;
      opted = true;
    }
  }
  int occ = 1;
  err = per_sm(fn, smem, &occ);
  if (err != cudaSuccess) return err;
  const long long units = (a.n + GA_UNIT - 1) / GA_UNIT;
  const long long want = (units + GA_THREADS - 1) / GA_THREADS;
  const long long cap = (long long)sms * occ;
  const int blocks = (int)(want < 1 ? 1 : (want < cap ? want : cap));
  ga_update<SHARED, WIDE><<<blocks, GA_THREADS, smem, s>>>(a);
  return cudaGetLastError();
}

// Host entries, bound with ctypes.  The per-key and per-column pointer
// arrays and `dims` are host arrays; everything else points to device
// memory.  acc_f is [G, nf] float64, acc_i [G, ni] int64, acc_cnt [G]
// int64, q [G, nf, 2] the query-scale integers (zero at the start of the
// query), fb [G, nf, 3] the fallback words (zero between calls), words
// [2 nf + 3] int64, zero at the query's start and kept across calls ([nf]
// largest |x| bits, [nf] scale words, two fallback flags, a ticket);
// call numbers the calls from 1.  Returns cudaGetLastError() after the
// launches (0 = launched).
extern "C" int grid_agg(const void* const* codes,
                        const void* const* code_valid, const int* dims,
                        int nkeys, const void* active, long long n,
                        const void* const* f, const void* const* f_valid,
                        int nf, const void* const* i,
                        const void* const* i_valid, int ni, void* acc_f,
                        void* acc_i, void* acc_cnt, void* q, void* fb,
                        void* words, long long call, int G, int use_shared,
                        void* stream) {
  if (nkeys < 1 || nkeys > GA_MAX_KEYS || nf < 0 || nf > GA_MAX_COLS ||
      ni < 0 || ni > GA_MAX_COLS || G < 1 || call < 1 ||
      (nf > 0 && (q == nullptr || fb == nullptr || words == nullptr)))
    return (int)cudaErrorInvalidValue;
  GAArgs a = {};
  bool wide = aligned16(active);
  for (int k = 0; k < nkeys; ++k) {
    a.codes[k] = static_cast<const int*>(codes[k]);
    a.code_valid[k] = static_cast<const uint8_t*>(code_valid[k]);
    a.dims[k] = dims[k];
    wide = wide && aligned16(codes[k]) && aligned16(code_valid[k]);
  }
  a.nkeys = nkeys;
  for (int j = 0; j < nf; ++j) {
    a.f[j] = static_cast<const double*>(f[j]);
    a.f_valid[j] = static_cast<const uint8_t*>(f_valid[j]);
    wide = wide && aligned16(f[j]) && aligned16(f_valid[j]);
  }
  a.nf = nf;
  for (int j = 0; j < ni; ++j) {
    a.i[j] = static_cast<const long long*>(i[j]);
    a.i_valid[j] = static_cast<const uint8_t*>(i_valid[j]);
    wide = wide && aligned16(i[j]) && aligned16(i_valid[j]);
  }
  a.ni = ni;
  a.active = static_cast<const uint8_t*>(active);
  a.n = n;
  a.G = G;
  a.acc_f = static_cast<double*>(acc_f);
  a.acc_i = static_cast<unsigned long long*>(acc_i);
  a.acc_cnt = static_cast<unsigned long long*>(acc_cnt);
  a.q = static_cast<unsigned long long*>(q);
  a.fb = static_cast<unsigned long long*>(fb);
  a.words = static_cast<long long*>(words);
  a.call = call;
  if (n == 0) return (int)cudaSuccess;
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem =
      use_shared ? (size_t)G * (2 * nf + ni + 1) * sizeof(unsigned long long)
                 : 0;
  const long long want = (n + GA_THREADS - 1) / GA_THREADS;
  const long long cap = (long long)sms * 8;
  if (nf > 0)
    ga_prepare<<<(int)(want < (long long)sms * 4 ? want : (long long)sms * 4),
                 GA_THREADS, 0, s>>>(a);
  if (use_shared)
    err = wide ? launch_update<true, true>(a, smem, sms, s)
               : launch_update<true, false>(a, smem, sms, s);
  else
    err = wide ? launch_update<false, true>(a, smem, sms, s)
               : launch_update<false, false>(a, smem, sms, s);
  if (err != cudaSuccess || nf == 0) return (int)err;
  // the fallback: a launch that returns at once unless the flag is set
  ga_fallback<<<(int)(want < cap ? want : cap), GA_THREADS, 0, s>>>(a);
  return (int)cudaGetLastError();
}

// The query-scale integers of G x nf cells into acc_f, cleared (q, acc_f,
// words as grid_agg keeps them).
extern "C" int grid_agg_fold(void* q, void* acc_f, const void* words, int nf,
                             long long cells, void* stream) {
  if (nf < 1 || cells < 0) return (int)cudaErrorInvalidValue;
  if (cells == 0) return (int)cudaSuccess;
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  const long long want = (cells + GA_THREADS - 1) / GA_THREADS;
  const long long cap = (long long)sms * 8;
  ga_fold<<<(int)(want < cap ? want : cap), GA_THREADS, 0,
            static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(q), static_cast<double*>(acc_f),
      static_cast<const long long*>(words), nf, cells);
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
