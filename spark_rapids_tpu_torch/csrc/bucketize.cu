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
// One sweep, on the pattern of radix.cuh's one-sweep pass, with the
// destination as the digit.  One memset clears the look-back's status
// words, the tile ticket and the ready flag; then ONE kernel, whose blocks
// take tickets in start order:
//   * a block with a ticket below the tile count takes that tile of
//     BZ_TILE rows (256 threads x 8 rows).  It first asks for the tile's
//     payload columns, copied as they lie (16-byte cp.async, no registers)
//     into shared memory, up to a budget of bytes a batch, so the payload
//     is in flight while the block ranks its rows.  It reads the
//     destinations and the live mask once, into registers (rows in warp
//     order, coalesced); ranks each row within its destination in row
//     order (the lanes of one destination find each other with
//     __match_any_sync, the highest adds their number to the warp's
//     counter of it in shared memory; a prefix over the warps follows), so
//     ranks are stable; publishes its count of each destination at once
//     (A), looks back over earlier tiles' words (A: add and go on; P: add
//     the prefix and stop), a group of lanes a destination reading as many
//     tiles' words a step (a warp up to 8 destinations: the first tiles,
//     which all start together, find a prefix in a few steps), and
//     publishes its prefix (P).  Then every live row's slot is known: the
//     rows are listed in destination order, and each column leaves from
//     shared memory as runs of one destination's rows, its element size
//     chosen once per column, so a destination's rows leave in full
//     sectors.  The last tile knows every destination's total: it writes
//     sent and overflow, then raises the ready flag.  A call of one tile
//     and at most BZ_ZERO_SLOTS slots writes its zero tail itself, after
//     its columns (no block waits: a small call is all latency);
//   * a block with a later ticket (every tile's block has started, so none
//     waits on it) waits for the flag and writes the zero tail of
//     BZ_ZERO_SLOTS bucket slots of every column: the slots at or past
//     their bucket's fill, in 16-byte stores, neighbouring threads on
//     neighbouring words.
// So the live part is written once, by the tiles, and the tail once, by
// the kernel; the caller allocates every output uninitialised.
//
// Shared memory: the staged columns (a batch of at most `budget` bytes,
// chosen by the host), the rows' slots and source rows (10 B a row), the
// warps' counters (8 words a destination) and three words a destination.
// 8 destinations take ~61 KB (3 blocks an SM); 4,096 take ~226 KB (one).
//
// Bound: device memory.  Each input byte is read once (the destinations,
// the mask, the payload: a dead row's bytes share sectors with live ones),
// each output byte written once (the live rows and the zero tails); the
// status words move 8 B per (tile, destination).

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#define BZ_MAX_COLS 64
#define BZ_MAX_PARTS 4096
#define BZ_THREADS 256
#define BZ_WARPS (BZ_THREADS / 32)
#define BZ_ITEMS 8
#define BZ_WARP_ROWS (32 * BZ_ITEMS)
#define BZ_TILE (BZ_THREADS * BZ_ITEMS)
#define BZ_BUDGET 40960      // staged payload bytes a batch, at most
#define BZ_SMEM_MAX 232448   // shared memory a block can use (H100)
#define BZ_ZERO_SLOTS 4096   // bucket slots a zero-tail block writes
#define BZ_FLAG_AGG 1ull
#define BZ_FLAG_INC 2ull
#define BZ_VALUE_MASK ((1ull << 62) - 1ull)

// The columns, and their batches: batch b stages columns
// [first[b], first[b + 1]), column k at byte at[k] of the stage.
struct BZCols {
  const void* in[BZ_MAX_COLS];
  void* out[BZ_MAX_COLS];
  int elem[BZ_MAX_COLS];
  int at[BZ_MAX_COLS];
  int first[BZ_MAX_COLS + 1];
  int ncols, nbatches;
};

__device__ __forceinline__ int dest_of(const int* __restrict__ pids,
                                       const uint8_t* __restrict__ active,
                                       long long r, int nparts) {
  const int p = pids[r];
  if ((active != nullptr && !active[r]) || p < 0 || p >= nparts)
    return nparts;  // dead: goes nowhere
  return p;
}

// Bytes a column takes in the stage: its tile rows and the skew of their
// first byte within a 16-byte word.
static int bz_staged(int elem) { return BZ_TILE * elem + 16; }

// Shared memory besides the stage: slots (8 B) and source rows (2 B) of
// the tile's rows, the warps' counters and three words a destination.
static size_t bz_fixed_smem(int nparts) {
  return (size_t)BZ_TILE * 10 + (size_t)(BZ_WARPS + 3) * nparts * 4;
}

__device__ __forceinline__ unsigned long long bz_word(unsigned long long flag,
                                                      long long v) {
  return (flag << 62) | (unsigned long long)v;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

// Ask for batch b's columns of the tile's rows [r0, r1): the 16-byte words
// that hold each column's bytes, copied as they lie (an aligned word
// never crosses a page).
__device__ __forceinline__ void bz_stage(const BZCols& c, int b, long long r0,
                                         long long r1, unsigned char* stage) {
  for (int k = c.first[b]; k < c.first[b + 1]; ++k) {
    const int e = c.elem[k];
    const uintptr_t lo = (uintptr_t)c.in[k] + (uintptr_t)(r0 * e);
    const uintptr_t hi = (uintptr_t)c.in[k] + (uintptr_t)(r1 * e);
    if (hi <= lo) continue;
    const uintptr_t a = lo & ~(uintptr_t)15;
    const int words = (int)((((hi + 15) & ~(uintptr_t)15) - a) >> 4);
    for (int w = threadIdx.x; w < words; w += BZ_THREADS)
      cp_async16(stage + c.at[k] + 16 * w,
                 reinterpret_cast<const void*>(a + 16 * (uintptr_t)w));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// Column k from the stage to the buckets: slot j of the tile's rows in
// destination order is source row s_src[j], bound for s_dst[j] (-1: past
// the bucket's capacity).
template <typename T>
__device__ __forceinline__ void bz_column(const BZCols& c, int k, long long r0,
                                          const unsigned char* stage,
                                          const long long* s_dst,
                                          const unsigned short* s_src,
                                          int live) {
  const int skew =
      (int)(((uintptr_t)c.in[k] + (uintptr_t)(r0 * (long long)sizeof(T))) &
            15);
  const T* src = reinterpret_cast<const T*>(stage + c.at[k] + skew);
  T* __restrict__ out = static_cast<T*>(c.out[k]);
  for (int j = threadIdx.x; j < live; j += BZ_THREADS) {
    const long long g = s_dst[j];
    if (g >= 0) out[g] = src[s_src[j]];
  }
}

// Destination p's live rows in the tiles before `tile`, read by a group
// of L lanes (L a power of two, the group aligned in its warp; gmask its
// lanes, gl the lane's place in it): each step reads the words of L
// earlier tiles at once, waits until all are published, and adds the
// aggregates (A) up to the nearest prefix (P, whose value it adds and
// stops at) or past tile 0.  Every lane of the group gets the sum.
__device__ __forceinline__ long long bz_look_back(
    const unsigned long long* status, long long tile, int nparts, int p,
    int L, unsigned gmask, int gl) {
  const int base = (threadIdx.x & 31) - gl;
  long long before = 0;
  for (long long j = tile - 1; j >= 0;) {
    const long long at = j - gl;
    const unsigned long long w =
        at >= 0 ? *(volatile const unsigned long long*)(status + at * nparts
                                                         + p)
                : BZ_FLAG_INC << 62;
    if (__ballot_sync(gmask, (w >> 62) == 0ull)) continue;
    const unsigned inc =
        __ballot_sync(gmask, (w >> 62) == BZ_FLAG_INC) >> base;
    const int last = inc ? __ffs(inc) - 1 : L - 1;
    long long v = gl <= last ? (long long)(w & BZ_VALUE_MASK) : 0;
    for (int o = L >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(gmask, v, o);
    before += v;
    if (inc) break;
    j -= L;
  }
  return before;
}

// Zero the slots [z0, z1) of one column (e-byte elements from a 16-byte
// aligned out; z0 e a multiple of 16) that lie at or past their bucket's
// fill: a 16-byte word a thread a step, neighbouring threads on
// neighbouring words, so a warp writes 512 contiguous bytes.  A word whose
// slots all lie below one bucket's fill is skipped, one in its tail
// written whole; one where a fill or a bucket ends, slot by slot.  I is
// the slot index type (32 bits where the buckets' slots fit).
template <typename I>
__device__ __forceinline__ void bz_zero_range(unsigned char* out, int e,
                                              I z0, I z1, I cap,
                                              const int* fill) {
  const int per = 16 / e;  // slots a word
  const I words = (z1 - z0 + per - 1) / per;
  for (I w = threadIdx.x; w < words; w += BZ_THREADS) {
    const I s0 = z0 + w * per;
    const I p = s0 / cap, k = s0 - p * cap;
    if (k + per <= cap && s0 + per <= z1) {
      const I f = (I)fill[p];
      if (k + per <= f) continue;
      if (k >= f) {
        *reinterpret_cast<uint4*>(out + (size_t)s0 * e) =
            make_uint4(0, 0, 0, 0);
        continue;
      }
    }
    for (I x = s0; x < s0 + per && x < z1; ++x) {
      const I px = x / cap;
      if (x - px * cap >= (I)fill[px])
        for (int b = 0; b < e; ++b) out[(size_t)x * e + b] = 0;
    }
  }
}

__global__ void __launch_bounds__(BZ_THREADS)
bz_sweep(const int* __restrict__ pids, const uint8_t* __restrict__ active,
         long long n, int nparts, long long cap,
         const __grid_constant__ BZCols c, int budget, long long ntiles,
         unsigned long long* status, unsigned* ctr, int* sent,
         long long* overflow) {
  extern __shared__ __align__(16) unsigned char bz_smem_[];
  unsigned char* stage = bz_smem_;                        // [budget]
  long long* s_dst = reinterpret_cast<long long*>(stage + budget);
  unsigned short* s_src =
      reinterpret_cast<unsigned short*>(s_dst + BZ_TILE);  // [BZ_TILE]
  int* s_cnt = reinterpret_cast<int*>(s_src + BZ_TILE);  // [warps][nparts]
  int* s_tcnt = s_cnt + BZ_WARPS * nparts;                 // [nparts]
  int* s_start = s_tcnt + nparts;                          // [nparts]
  int* s_before = s_start + nparts;                        // [nparts]
  __shared__ unsigned s_tile;
  __shared__ int s_warp[BZ_WARPS];
  __shared__ unsigned long long s_over;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (t == 0) {
    s_tile = atomicAdd(ctr, 1u);
    s_over = 0;
  }
  __syncthreads();
  const long long tile = s_tile;

  const long long slots = (long long)nparts * cap;
  if (tile >= ntiles) {  // the zero tail
    if (t == 0) {
      while (*(volatile unsigned*)(ctr + 1) == 0u) __nanosleep(100);
      __threadfence();
    }
    __syncthreads();
    for (int p = t; p < nparts; p += BZ_THREADS) s_tcnt[p] = __ldcg(sent + p);
    __syncthreads();
    const long long z0 = (tile - ntiles) * BZ_ZERO_SLOTS;
    const long long z1 = z0 + BZ_ZERO_SLOTS < slots ? z0 + BZ_ZERO_SLOTS
                                                    : slots;
    for (int k = 0; k < c.ncols; ++k) {
      unsigned char* out = static_cast<unsigned char*>(c.out[k]);
      if (slots < (1LL << 32))
        bz_zero_range<unsigned>(out, c.elem[k], (unsigned)z0, (unsigned)z1,
                                (unsigned)cap, s_tcnt);
      else
        bz_zero_range<unsigned long long>(out, c.elem[k], z0, z1, cap,
                                          s_tcnt);
    }
    return;
  }

  const long long r0 = tile * BZ_TILE;
  const long long r1 = r0 + BZ_TILE < n ? r0 + BZ_TILE : n;
  if (c.nbatches > 0) bz_stage(c, 0, r0, r1, stage);
  for (int i = t; i < BZ_WARPS * nparts; i += BZ_THREADS) s_cnt[i] = 0;
  __syncthreads();
  const int row_base = warp * BZ_WARP_ROWS + lane;  // item i: + 32 i
  int d[BZ_ITEMS], rank[BZ_ITEMS];
#pragma unroll
  for (int i = 0; i < BZ_ITEMS; ++i) {
    const long long r = r0 + row_base + 32 * i;
    d[i] = r < n ? dest_of(pids, active, r, nparts) : nparts;
  }
  // rank within the warp, rows in order: the lanes of one destination
  // find each other and the highest of them adds their number to the
  // warp's counter
  int* my_cnt = s_cnt + warp * nparts;
  const unsigned lane_lt = (1u << lane) - 1u;
#pragma unroll
  for (int i = 0; i < BZ_ITEMS; ++i) {
    const unsigned peers = __match_any_sync(0xffffffffu, d[i]);
    const bool is_live = d[i] < nparts;
    const int base = is_live ? my_cnt[d[i]] : 0;
    __syncwarp();
    if (is_live && (peers >> lane) == 1u)
      my_cnt[d[i]] = base + __popc(peers);
    __syncwarp();
    rank[i] = base + __popc(peers & lane_lt);
  }
  __syncthreads();
  // per destination: the warps' counts become their offsets; the tile's
  // count, published at once
  for (int p = t; p < nparts; p += BZ_THREADS) {
    int sum = 0;
#pragma unroll
    for (int w = 0; w < BZ_WARPS; ++w) {
      const int x = s_cnt[w * nparts + p];
      s_cnt[w * nparts + p] = sum;
      sum += x;
    }
    s_tcnt[p] = sum;
    *(volatile unsigned long long*)(status + tile * nparts + p) =
        bz_word(tile == 0 ? BZ_FLAG_INC : BZ_FLAG_AGG, sum);
  }
  __syncthreads();
  // the destinations' first slots in the tile's destination order: thread
  // t scans its run of `per` destinations after a scan of the runs' sums
  const int per = (nparts + BZ_THREADS - 1) / BZ_THREADS;
  const int p0 = t * per < nparts ? t * per : nparts;
  const int p1 = p0 + per < nparts ? p0 + per : nparts;
  int run = 0;
  for (int p = p0; p < p1; ++p) run += s_tcnt[p];
  int incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += u;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  int at = incl - run, live = 0;
#pragma unroll
  for (int w = 0; w < BZ_WARPS; ++w) {
    if (w < warp) at += s_warp[w];
    live += s_warp[w];
  }
  for (int p = p0; p < p1; ++p) {
    s_start[p] = at;
    at += s_tcnt[p];
  }
  // look back, a group of L lanes a destination (L = 32 up to 8
  // destinations, 1 past 128); the last tile also writes sent and overflow
  int L = 32;
  while (L > 1 && L * nparts > BZ_THREADS) L >>= 1;
  const int gl = t & (L - 1);
  const unsigned gmask =
      L == 32 ? 0xffffffffu : ((1u << L) - 1u) << (lane & ~(L - 1));
  const bool last = tile == ntiles - 1;
  long long over = 0;
  for (int p = t / L; p < nparts; p += BZ_THREADS / L) {
    const long long before =
        bz_look_back(status, tile, nparts, p, L, gmask, gl);
    if (gl != 0) continue;
    const long long total = before + s_tcnt[p];
    if (tile > 0)
      *(volatile unsigned long long*)(status + tile * nparts + p) =
          bz_word(BZ_FLAG_INC, total);
    s_before[p] = (int)before;
    if (last) {
      sent[p] = (int)(total < cap ? total : cap);
      if (total > cap) over += total - cap;
    }
  }
  if (last) {
    if (over) atomicAdd(&s_over, (unsigned long long)over);
    __threadfence();
  }
  __syncthreads();
  if (last && t == 0) {
    *overflow = (long long)s_over;
    __threadfence();
    atomicExch(ctr + 1, 1u);  // ready: the zero tail may start
  }
  // each live row's place in destination order and its bucket slot
#pragma unroll
  for (int i = 0; i < BZ_ITEMS; ++i) {
    if (d[i] < nparts) {
      const int in_tile = s_cnt[warp * nparts + d[i]] + rank[i];
      const int pos = s_start[d[i]] + in_tile;
      const long long b = (long long)s_before[d[i]] + in_tile;
      s_dst[pos] = b < cap ? (long long)d[i] * cap + b : -1;
      s_src[pos] = (unsigned short)(row_base + 32 * i);
    }
  }
  // the columns, a batch at a time: wait for its copies, write it out,
  // ask for the next
  for (int b = 0; b < c.nbatches; ++b) {
    asm volatile("cp.async.wait_all;\n" ::);
    __syncthreads();
    for (int k = c.first[b]; k < c.first[b + 1]; ++k) {
      switch (c.elem[k]) {
        case 8:
          bz_column<long long>(c, k, r0, stage, s_dst, s_src, live);
          break;
        case 4:
          bz_column<int>(c, k, r0, stage, s_dst, s_src, live);
          break;
        case 2:
          bz_column<short>(c, k, r0, stage, s_dst, s_src, live);
          break;
        default:
          bz_column<uint8_t>(c, k, r0, stage, s_dst, s_src, live);
      }
    }
    if (b + 1 < c.nbatches) {
      __syncthreads();
      bz_stage(c, b + 1, r0, r1, stage);
    }
  }
  if (ntiles == 1 && slots <= BZ_ZERO_SLOTS) {  // the zero tail, here
    __syncthreads();
    for (int p = t; p < nparts; p += BZ_THREADS)
      s_start[p] = (int)(s_tcnt[p] < cap ? s_tcnt[p] : cap);
    __syncthreads();
    for (int k = 0; k < c.ncols; ++k)
      bz_zero_range<unsigned>(static_cast<unsigned char*>(c.out[k]),
                              c.elem[k], 0u, (unsigned)slots, (unsigned)cap,
                              s_start);
  }
}

// bz_sweep may take up to BZ_SMEM_MAX - 1024 bytes of dynamic shared
// memory, whatever a call needs: set once a device, to one value, so
// concurrent calls of different sizes never lower it under each other.
static cudaError_t bz_allow_smem() {
  static std::atomic<unsigned long long> done(0);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ULL << (dev & 63);
  if (done.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(bz_sweep,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             BZ_SMEM_MAX - 1024);
  if (err != cudaSuccess) return err;
  done.fetch_or(bit);
  return cudaSuccess;
}

static long long bz_tiles(long long n) {
  const long long t = (n + BZ_TILE - 1) / BZ_TILE;
  return t > 0 ? t : 1;
}

// Bytes of bucketize's scratch: a status word per (tile, destination),
// the tile ticket and the ready flag.
extern "C" long long bucketize_scratch(long long n, int nparts) {
  return 8 * bz_tiles(n) * (long long)nparts + 8;
}

// Host entry, bound with ctypes.  pids: int32 [n] destinations; active:
// uint8 [n] or nullptr; in/out: ncols device pointers (out: [nparts, cap]
// buffers of the same element size, uninitialised: every slot is
// written); sent: int32 [nparts]; overflow: one int64 word; scratch:
// bucketize_scratch(n, nparts) bytes, cleared here.  Returns
// cudaGetLastError() after the launches.
extern "C" int bucketize(const void* pids, const void* active, long long n,
                         int nparts, long long cap, int ncols,
                         const void* const* in, void* const* out,
                         const int* elems, void* sent, void* overflow,
                         void* scratch, long long scratch_bytes,
                         void* stream) {
  if (n < 0 || nparts < 1 || nparts > BZ_MAX_PARTS || cap < 0 || ncols < 0
      || ncols > BZ_MAX_COLS || n >= (1LL << 31)
      || scratch_bytes < bucketize_scratch(n, nparts))
    return (int)cudaErrorInvalidValue;
  // the stage: what is left of the block's shared memory, at most
  // BZ_BUDGET, in batches of whole columns
  const size_t fixed = bz_fixed_smem(nparts);
  const size_t room = BZ_SMEM_MAX - 1024 - fixed;
  const int budget = (int)(room < BZ_BUDGET ? room : BZ_BUDGET) & ~15;
  BZCols c = {};
  int used = 0;
  for (int k = 0; k < ncols; ++k) {
    const int e = elems[k];
    if (e != 1 && e != 2 && e != 4 && e != 8) return (int)cudaErrorInvalidValue;
    c.in[k] = in[k];
    c.out[k] = out[k];
    c.elem[k] = e;
    if (c.nbatches == 0 || used + bz_staged(e) > budget) {
      c.first[c.nbatches++] = k;
      used = 0;
    }
    c.at[k] = used;
    used += bz_staged(e);
  }
  c.first[c.nbatches] = ncols;
  c.ncols = ncols;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long ntiles = bz_tiles(n);
  const long long slots = (long long)nparts * cap;
  const long long zero_blocks =
      ncols == 0 || (ntiles == 1 && slots <= BZ_ZERO_SLOTS)
          ? 0 : (slots + BZ_ZERO_SLOTS - 1) / BZ_ZERO_SLOTS;
  if (ntiles + zero_blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const size_t shared = (size_t)budget + fixed;
  cudaError_t err = bz_allow_smem();
  if (err != cudaSuccess) return (int)err;
  unsigned long long* status = static_cast<unsigned long long*>(scratch);
  const long long words = ntiles * nparts;
  err = cudaMemsetAsync(scratch, 0, 8 * words + 8, st);
  if (err != cudaSuccess) return (int)err;
  bz_sweep<<<(unsigned)(ntiles + zero_blocks), BZ_THREADS, shared, st>>>(
      static_cast<const int*>(pids), static_cast<const uint8_t*>(active), n,
      nparts, cap, c, budget, ntiles, status,
      reinterpret_cast<unsigned*>(status + words), static_cast<int*>(sent),
      static_cast<long long*>(overflow));
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
