// compact: pack the live rows of every column of a batch to the front, in
// row order, validity masks riding along.
//
// Replaces: spark_rapids_tpu/ops/batch_utils.py:280 _compact_fn (one
// program: cumsum of the live mask, then a scatter per column), called by
// batch_utils.compact (:151) with the live count already fetched
// (`n_live`), as the dense aggregation's output compaction does.
//
// One sweep, on the pattern of bucketize.cu's, with one destination.  One
// memset clears the look-back's status words and the ticket of this call's
// own scratch; then ONE kernel, whose blocks take groups of tiles (CP_TILE
// rows each; one a group, or CP_GROUP where under 1 row in CP_SPARSE is
// live, so that fewer blocks pay the ticket, the mask's latency and the
// look-back) in ticket order:
//   * the mask is read once, a 16-byte word a thread a tile (16 rows,
//     neighbouring threads on neighbouring words); a thread's live rows
//     are a popcount of its word's bytes, one scan over the block ranks
//     them (a tile's count in each 16-bit field of a 64-bit word), and the
//     block lists its live rows by rank in shared memory (2 B a row);
//   * the group publishes its live count at once, then its first warp
//     looks back over the earlier groups' words, 32 at a time (an
//     aggregate: add and go on; a prefix: add and stop), and publishes its
//     prefix;
//   * meanwhile the other warps ask for the live rows' values, and only
//     theirs: 8- and 4-byte elements by cp.async straight into a stage in
//     shared memory at their rank (no register, no wait), 2- and 1-byte
//     ones (validity masks are 1-byte lanes) by plain loads, a few a
//     thread in flight, so every load of a pass is issued before the first
//     store;
//   * once the offset is known, each lane (a column or a validity mask)
//     leaves the stage as one contiguous run, in aligned 16-byte stores
//     (its two partial words element by element).  Lanes are grouped by
//     element width on the host, and each group is moved by loops compiled
//     for its width, the lanes' items spread over the block.  A group's
//     tiles move as units of as many neighbouring tiles as hold at most
//     CP_TILE live rows (a sparse group is one unit); a unit whose live
//     rows do not fit the stage at once (a dense tile) moves its lanes in
//     passes.
// Rows past n_live (the caller's count) are never written: the `to <
// n_live` guard.  An input mask at an address that is not 16-byte aligned
// (a slice_batch view) is read a byte at a time; column inputs are read by
// element, so any element-aligned view serves.  Outputs are fresh and
// 16-byte aligned (checked).
//
// Bound: device memory.  The mask is read once (1 B a row), each live row's
// sectors of each column once, and each output byte written once; the
// status words move 8 B a group.

#include <cuda_runtime.h>
#include <stdint.h>

#define CP_THREADS 256
#define CP_WARPS (CP_THREADS / 32)
#define CP_ROWS 16                       // rows a thread: one mask word
#define CP_TILE (CP_THREADS * CP_ROWS)   // 4096
#define CP_MAX_COLS 16
#define CP_MAX_LANES (2 * CP_MAX_COLS)   // columns and their validity
#define CP_STAGE (CP_TILE * 8)           // one 8-byte lane of a full tile
#define CP_GROUP 4                       // tiles a group, sparse mask
#define CP_SPARSE 8                      // sparse: under 1 row in 8 live
#define CP_MIN_BLOCKS 1                  // blocks an SM to fit registers to
#define CP_BATCH 4                       // plain loads a thread in flight
#define CP_FLAG_AGG 1ull
#define CP_FLAG_INC 2ull
#define CP_VALUE_MASK ((1ull << 62) - 1ull)

// The lanes, by element width: lanes [start[i], start[i + 1]) move
// elements of 8 >> i bytes.
struct CPLanes {
  const void* in[CP_MAX_LANES];
  void* out[CP_MAX_LANES];
  int start[5];
};

template <int E> struct CPElem;
template <> struct CPElem<8> { typedef unsigned long long T; };
template <> struct CPElem<4> { typedef unsigned T; };
template <> struct CPElem<2> { typedef unsigned short T; };
template <> struct CPElem<1> { typedef uint8_t T; };

__device__ __forceinline__ int cp_width(int lane, const CPLanes& a) {
  return lane < a.start[1] ? 8 : lane < a.start[2] ? 4
                                 : lane < a.start[3] ? 2 : 1;
}

__device__ __forceinline__ unsigned long long cp_word(unsigned long long flag,
                                                      long long v) {
  return (flag << 62) | (unsigned long long)v;
}

// Bit i set where byte i of x is not zero (4 bytes -> 4 bits).
__device__ __forceinline__ unsigned live_bits4(unsigned x) {
  const unsigned y = __vcmpne4(x, 0u) & 0x01010101u;
  return (y * 0x01020408u) >> 24;
}

// The live rows in the groups before `group`, read by the whole warp: each
// step reads 32 earlier groups' words at once, waits until all are
// published, and adds the aggregates (A) up to the nearest prefix (P,
// whose value it adds and stops at) or past group 0.  (Four words a lane a
// step ran slower: a step waits for the newest groups' words.)
__device__ __forceinline__ long long cp_look_back(
    const unsigned long long* status, long long group) {
  const int lane = threadIdx.x & 31;
  long long before = 0;
  for (long long j = group - 1; j >= 0;) {
    const long long at = j - lane;
    const unsigned long long w =
        at >= 0 ? *(volatile const unsigned long long*)(status + at)
                : CP_FLAG_INC << 62;
    if (__ballot_sync(0xffffffffu, (w >> 62) == 0ull)) continue;
    const unsigned inc = __ballot_sync(0xffffffffu, (w >> 62) == CP_FLAG_INC);
    const int last = inc ? __ffs(inc) - 1 : 31;
    long long v = lane <= last ? (long long)(w & CP_VALUE_MASK) : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    before += v;
    if (inc) break;
    j -= 32;
  }
  return before;
}

__device__ __forceinline__ void cp_async(void* smem, const void* gmem,
                                         int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                 "l"(gmem));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(gmem));
}

// Ask for the live values (rank j: source row r0 + src[j]) of lanes [ka,
// kb), all E bytes wide, into the stage: lane ka + q's at at + q stride,
// element j at + j E.  The lanes' (lane, rank) items are spread over nthr
// threads (this one is tid): 8- and 4-byte elements by cp.async, 2- and
// 1-byte ones by plain loads, CP_BATCH a thread in flight at once.
template <int E>
__device__ __forceinline__ void cp_fetch(const CPLanes& a, int ka, int kb,
                                         long long r0,
                                         const unsigned short* src, int live,
                                         unsigned char* at, int stride,
                                         int tid, int nthr) {
  typedef typename CPElem<E>::T T;
  const unsigned total = (unsigned)(kb - ka) * (unsigned)live;
  if constexpr (E >= 4) {
    for (unsigned i = tid; i < total; i += nthr) {
      const unsigned q = i / (unsigned)live, j = i - q * (unsigned)live;
      const T* in = static_cast<const T*>(a.in[ka + q]) + r0;
      cp_async(at + q * stride + j * E, in + src[j], E);
    }
  } else {
    for (unsigned i0 = tid; i0 < total; i0 += CP_BATCH * nthr) {
      T v[CP_BATCH];
      unsigned dst[CP_BATCH];
#pragma unroll
      for (int u = 0; u < CP_BATCH; ++u) {
        const unsigned i = i0 + u * nthr;
        if (i < total) {
          const unsigned q = i / (unsigned)live, j = i - q * (unsigned)live;
          v[u] = __ldg(static_cast<const T*>(a.in[ka + q]) + r0 + src[j]);
          dst[u] = q * stride + j * E;
        }
      }
#pragma unroll
      for (int u = 0; u < CP_BATCH; ++u)
        if (i0 + u * nthr < total) *reinterpret_cast<T*>(at + dst[u]) = v[u];
    }
  }
}

// Lanes [ka, kb) (E bytes wide, staged as cp_fetch put them) from the
// stage to out[off, end) (rank j at element off + j): aligned 16-byte
// words, the lanes' words spread over the block, neighbouring threads on
// neighbouring words; a run's two partial words element by element.
template <int E>
__device__ __forceinline__ void cp_store(const CPLanes& a, int ka, int kb,
                                         const unsigned char* at, int stride,
                                         long long off, long long end) {
  typedef typename CPElem<E>::T T;
  constexpr int PER = 16 / E;
  const long long w0 = off / PER;
  const unsigned nw = (unsigned)((end + PER - 1) / PER - w0);
  const unsigned total = (unsigned)(kb - ka) * nw;
  for (unsigned i = threadIdx.x; i < total; i += CP_THREADS) {
    const unsigned q = i / nw;
    const long long w = w0 + (i - q * nw);
    const T* st = reinterpret_cast<const T*>(at + q * stride);
    T* __restrict__ out = static_cast<T*>(a.out[ka + q]);
    const long long g = w * PER;
    if (g >= off && g + PER <= end) {
      union {
        T v[PER];
        uint4 u;
      } x;
#pragma unroll
      for (int e = 0; e < PER; ++e) x.v[e] = st[g - off + e];
      reinterpret_cast<uint4*>(out)[w] = x.u;
    } else {
      for (long long e = g < off ? off : g; e < g + PER && e < end; ++e)
        out[e] = st[e - off];
    }
  }
}

// The bytes a lane of `width`-byte elements takes in the stage.
__device__ __forceinline__ int cp_lane_bytes(int live, int width) {
  return (live * width + 15) & ~15;
}

// The lanes of [ka, kb), all E bytes wide: fetch or store.
template <int E>
__device__ __forceinline__ void cp_lanes(const CPLanes& a, int ka, int kb,
                                         bool store, long long r0,
                                         const unsigned short* src, int live,
                                         unsigned char* at, long long off,
                                         long long end, int tid, int nthr) {
  const int stride = cp_lane_bytes(live, E);
  if (store)
    cp_store<E>(a, ka, kb, at, stride, off, end);
  else
    cp_fetch<E>(a, ka, kb, r0, src, live, at, stride, tid, nthr);
}

// Lanes [k0, k1) of one pass, by width group: fetch (store = false) or
// store (store = true).
__device__ __forceinline__ void cp_pass(const CPLanes& a, int k0, int k1,
                                        bool store, long long r0,
                                        const unsigned short* src, int live,
                                        unsigned char* stage, long long off,
                                        long long end, int tid, int nthr) {
  unsigned char* at = stage;
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    const int ka = a.start[g] > k0 ? a.start[g] : k0;
    const int kb = a.start[g + 1] < k1 ? a.start[g + 1] : k1;
    if (kb <= ka) continue;
    switch (g) {
      case 0: cp_lanes<8>(a, ka, kb, store, r0, src, live, at, off, end, tid,
                          nthr); break;
      case 1: cp_lanes<4>(a, ka, kb, store, r0, src, live, at, off, end, tid,
                          nthr); break;
      case 2: cp_lanes<2>(a, ka, kb, store, r0, src, live, at, off, end, tid,
                          nthr); break;
      default: cp_lanes<1>(a, ka, kb, store, r0, src, live, at, off, end,
                           tid, nthr);
    }
    at += (kb - ka) * cp_lane_bytes(live, 8 >> g);
  }
}

// A block takes a group of GROUP consecutive tiles (1, or CP_GROUP for a
// sparse mask, chosen on the host) by ticket: the group's mask words are
// read at once, its live count published and looked back for once, then
// its tiles move through the stage as units, a unit as many neighbouring
// tiles as hold at most CP_TILE live rows together (a sparse group is one
// unit: one round of fetches).
template <int GROUP, bool VEC_MASK>
__global__ void __launch_bounds__(CP_THREADS, CP_MIN_BLOCKS)
cp_sweep(const __grid_constant__ CPLanes a,
         const uint8_t* __restrict__ active, long long n, long long n_live,
         unsigned long long* status, unsigned* ctr) {
  static_assert(GROUP >= 1 && GROUP <= 4, "a tile's count: 16 bits");
  __shared__ __align__(16) unsigned char s_stage[CP_STAGE];
  __shared__ unsigned short s_src[CP_TILE];
  __shared__ unsigned long long s_warp[CP_WARPS];
  __shared__ unsigned s_group;
  __shared__ long long s_before;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int nlanes = a.start[4];
  if (t == 0) s_group = atomicAdd(ctr, 1u);
  __syncthreads();
  const long long grp = s_group;
  const long long g0 = grp * GROUP * CP_TILE;  // the group's first row

  // this thread's 16 rows of each tile of the group, as bits
  unsigned m[GROUP];
#pragma unroll
  for (int g = 0; g < GROUP; ++g) {
    m[g] = 0;
    const long long rr =
        g0 + (long long)g * CP_TILE + (long long)t * CP_ROWS;
    if (rr >= n) continue;
    if (VEC_MASK && rr + CP_ROWS <= n) {
      const uint4 w = __ldcs(reinterpret_cast<const uint4*>(active + rr));
      m[g] = live_bits4(w.x) | live_bits4(w.y) << 4 |
             live_bits4(w.z) << 8 | live_bits4(w.w) << 12;
    } else {
      for (int i = 0; i < CP_ROWS; ++i)
        if (rr + i < n && active[rr + i]) m[g] |= 1u << i;
    }
  }
  // ranks: one scan over the block of the threads' counts, a tile's in
  // each 16-bit field (a tile holds at most 4,096 live rows)
  unsigned long long c = 0;
#pragma unroll
  for (int g = 0; g < GROUP; ++g)
    c |= (unsigned long long)__popc(m[g]) << (16 * g);
  unsigned long long incl = c;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned long long up = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += up;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  unsigned long long rank = incl - c, lives = 0;
#pragma unroll
  for (int w = 0; w < CP_WARPS; ++w) {
    if (w < warp) rank += s_warp[w];
    lives += s_warp[w];
  }
  long long live_all = 0;
#pragma unroll
  for (int g = 0; g < GROUP; ++g)
    live_all += (lives >> (16 * g)) & 0xffff;
  if (t == 0)  // this group's count, at once; group 0's is its prefix
    *(volatile unsigned long long*)(status + grp) =
        cp_word(grp == 0 ? CP_FLAG_INC : CP_FLAG_AGG, live_all);

  // the units in turn; each one's lanes in passes that fit the stage: a
  // pass's values are asked for (the group's first by the other warps,
  // while the first warp looks back), then leave as runs
  long long off = 0;
  for (int g = 0; g < GROUP;) {
    int g1 = g, live = 0;  // the unit: tiles [g, g1)
    while (g1 < GROUP) {
      const int l = (int)((lives >> (16 * g1)) & 0xffff);
      if (g1 > g && live + l > CP_TILE) break;
      live += l;
      ++g1;
    }
    int before = 0;
#pragma unroll
    for (int u = 0; u < GROUP; ++u) {
      if (u < g || u >= g1) continue;
      int r = before + (int)((rank >> (16 * u)) & 0xffff);
      for (unsigned b = m[u]; b; b &= b - 1)
        s_src[r++] = (unsigned short)((u - g) * CP_TILE + t * CP_ROWS +
                                      __ffs(b) - 1);
      before += (int)((lives >> (16 * u)) & 0xffff);
    }
    __syncthreads();
    if (g == 0 && warp == 0) {  // first, so later groups find a prefix
      const long long prefix = cp_look_back(status, grp);
      if (lane == 0) {
        if (grp > 0)
          *(volatile unsigned long long*)(status + grp) =
              cp_word(CP_FLAG_INC, prefix + live_all);
        s_before = prefix;
      }
    }
    const long long r0 = g0 + (long long)g * CP_TILE;
    for (int k0 = 0, pass = 0; k0 < nlanes; ++pass) {
      int k1 = k0, used = 0;
      while (k1 < nlanes) {
        const int bytes = cp_lane_bytes(live, cp_width(k1, a));
        if (k1 > k0 && used + bytes > CP_STAGE) break;
        used += bytes;
        ++k1;
      }
      const bool first = g == 0 && pass == 0;
      if (live > 0 && (!first || warp > 0)) {
        cp_pass(a, k0, k1, false, r0, s_src, live, s_stage, 0, 0,
                first ? t - 32 : t, first ? CP_THREADS - 32 : CP_THREADS);
        asm volatile("cp.async.commit_group;\n" ::);
        asm volatile("cp.async.wait_all;\n" ::);
      }
      __syncthreads();
      if (first) off = s_before;
      const long long end = off + live < n_live ? off + live : n_live;
      if (end > off)
        cp_pass(a, k0, k1, true, r0, s_src, live, s_stage, off, end, 0, 0);
      k0 = k1;
      __syncthreads();  // the stage is reused
      if (end <= off) break;  // nothing of this unit is kept
    }
    off += live;
    g = g1;
    if (off >= n_live) break;  // nothing after it is kept
  }
}

static long long cp_tiles(long long n) { return (n + CP_TILE - 1) / CP_TILE; }

// Bytes of compact's scratch: a status word a tile (a group's at most)
// and the ticket.
extern "C" long long compact_scratch(long long n) {
  return 8 * cp_tiles(n) + 8;
}

// Host entry, bound with ctypes.  `in`, `out`, `vin`, `vout` and `elems`
// are host arrays; columns are [n] in and [n_live] out (outputs 16-byte
// aligned); `scratch` holds compact_scratch(n) bytes, cleared here.
// Returns cudaGetLastError() after the launches (0 = launched).
extern "C" int compact(int ncols, const void* const* in, void* const* out,
                       const void* const* vin, void* const* vout,
                       const int* elems, const void* active, long long n,
                       long long n_live, void* scratch,
                       long long scratch_bytes, void* stream) {
  if (ncols < 0 || ncols > CP_MAX_COLS || n < 0 || n_live < 0)
    return (int)cudaErrorInvalidValue;
  // lanes by width: the columns' data (8, 4, 2, 1 bytes), then every
  // validity mask as a 1-byte lane
  CPLanes a = {};
  int nl = 0;
  for (int w = 0; w < 4; ++w) {
    const int e = 8 >> w;
    a.start[w] = nl;
    for (int j = 0; j < ncols; ++j) {
      if (elems[j] != 1 && elems[j] != 2 && elems[j] != 4 && elems[j] != 8)
        return (int)cudaErrorInvalidValue;
      if ((vin[j] == nullptr) != (vout[j] == nullptr))
        return (int)cudaErrorInvalidValue;
      if (elems[j] == e) {
        a.in[nl] = in[j];
        a.out[nl++] = out[j];
      }
      if (e == 1 && vin[j] != nullptr) {
        a.in[nl] = vin[j];
        a.out[nl++] = vout[j];
      }
    }
  }
  a.start[4] = nl;
  for (int k = 0; k < nl; ++k)
    if (((uintptr_t)a.out[k] & 15) != 0) return (int)cudaErrorInvalidValue;
  if (n == 0 || n_live == 0 || nl == 0) return (int)cudaSuccess;
  const long long tiles = cp_tiles(n);
  if (tiles > 0x7fffffffLL || scratch_bytes < compact_scratch(n))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned long long* status = static_cast<unsigned long long*>(scratch);
  cudaError_t err = cudaMemsetAsync(scratch, 0, compact_scratch(n), s);
  if (err != cudaSuccess) return (int)err;
  const uint8_t* act = static_cast<const uint8_t*>(active);
  unsigned* ctr = reinterpret_cast<unsigned*>(status + tiles);
  // a sparse mask (under 1 row in 16 live): CP_GROUP tiles a block, so
  // fewer blocks pay the ticket, the mask's latency and the look-back
  const bool sparse = n_live * CP_SPARSE < n;
  const bool vec = ((uintptr_t)act & 15) == 0;
  const unsigned groups =
      (unsigned)(sparse ? (tiles + CP_GROUP - 1) / CP_GROUP : tiles);
  if (sparse && vec)
    cp_sweep<CP_GROUP, true><<<groups, CP_THREADS, 0, s>>>(a, act, n, n_live,
                                                          status, ctr);
  else if (sparse)
    cp_sweep<CP_GROUP, false><<<groups, CP_THREADS, 0, s>>>(
        a, act, n, n_live, status, ctr);
  else if (vec)
    cp_sweep<1, true><<<groups, CP_THREADS, 0, s>>>(a, act, n, n_live,
                                                   status, ctr);
  else
    cp_sweep<1, false><<<groups, CP_THREADS, 0, s>>>(a, act, n, n_live,
                                                    status, ctr);
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
