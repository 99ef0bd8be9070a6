// radix.cuh: the one-sweep stable LSD radix sort that sort.cu (the full
// device sort), sort_join.cu (the sorted build over 64-bit key images) and
// csr_join.cu (the CSR build's slot order, a shuffle exchange's placement
// of rows by partition) share.
//
//   os_gather_hist, os_pass
//               Merrill and Garland's decoupled look-back as Adinets and
//               Merrill's Onesweep (2022) applies it to LSD radix sorting:
//               64-bit words, int32 values, ping-pong buffers whose current
//               side is read on the device (state[p]).  Per word, ONE
//               kernel gathers the word in the current order and counts
//               every byte of it at once (os_gather_hist; with STORE false
//               it only counts, for a first word whose first pass reads the
//               source itself); then ONE kernel per byte (os_pass) reads
//               that byte's 256 counts, exits at once when one digit holds
//               all n rows (state[p + 1] = state[p]), and otherwise ranks,
//               looks back and scatters its tile.  The host launches the
//               same kernels whatever the data and never waits.
//   FROM_SRC, OUT
//               two forms of os_pass for a sort whose rows start in input
//               order (csr_join.cu's): FROM_SRC, the first pass, reads each
//               row's word from the source functor and its value is the row
//               number, so no kernel materializes the word beforehand; OUT,
//               the last pass, writes only the values, straight into the
//               caller's permutation.  A skipped pass in either form still
//               carries its input to its output (the source's words and row
//               numbers to side 0, the current values to the permutation).
//
// The one-sweep pass, per 4,096-row tile (OS_TILE):
//   * its tile number comes from an atomic counter, so a block only waits
//     on tiles whose blocks already run: the look-back cannot deadlock;
//   * each warp loads 256 consecutive rows (8 a lane, coalesced) into
//     registers and ranks their digits stably, row by row of the warp in
//     row order: the lanes of one digit find each other through a mask
//     in shared memory built with atomicOr (whose result does not depend
//     on the order of the ors; a warp whose digit is uniform skips it),
//     and the highest of them adds their count to the warp's counter of
//     the digit, so ranks follow lane order and stability needs no
//     order-dependent atomics; a prefix over the warps per digit follows;
//   * thread d publishes the tile's count of digit d at once (flag A), then
//     looks back over earlier tiles' words (A: add and go on; P: add the
//     inclusive prefix and stop), publishes its inclusive prefix (flag P)
//     and adds the digit's global start (the exclusive scan of the word's
//     counts, which every block recomputes from the 256 counts);
//   * the tile is stored sorted by digit into shared memory, then written
//     out slot by slot: slots of one digit go to consecutive addresses,
//     so keys and values leave in coalesced runs.
// Status words are 64-bit: epoch (the pass number + 1) in bits 48-63, the
// flag in 46-47, the count in 0-45.  They are cleared once per sort on the
// stream (with the histograms and tile counters); a word of an earlier
// pass carries an older epoch and reads as not yet published.
//
// Choices (H100: 132 SMs, 227 KB of shared memory a block, 64 K registers
// an SM):
//   * 8-bit digits: the skip is per byte, and S1's and the joins' keys vary
//     in 2-3 of their bytes; 11-bit digits would need 2,048 counters a
//     warp (128 KB for 16 warps) beside the tile, and skip less.
//   * 512 threads x 8 rows: 4,096 rows; the sorted tile (8 B key + 4 B
//     value a row, 48 KB) is dynamic shared memory and the ranking
//     counters and masks (2 x 16 x 257 words) alias it; OS_MIN_BLOCKS = 2
//     resident blocks an SM (<= 64 registers a thread), 264 tiles in
//     flight.  tools/onesweep_bench.sh times one pass alone in variants
//     (PERF.md §6): 256 x 16 and 512 x 12 ran as fast, 3 blocks an SM
//     spilled and ran ~1.6x slower; the ranking set the pace, and
//     __match_any_sync over 32 distinct digits ran 1.5x slower than the
//     atomicOr masks;
//   * the look-back reads one earlier tile's word at a time: windows of 8
//     and 16 tiles read at once measured no faster;
//   * the gather-histogram kernel runs 2 blocks an SM of 512 threads, 4
//     rows a thread a step (random reads in flight), with shared counters
//     (one add a warp when the warp's digit is uniform) merged once a
//     block.
//
// Included by each kernel source, which is compiled into its own library.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// ---------------------------------------------------------------------------
// One-sweep stable LSD radix sort: 64-bit words, int32 values
// ---------------------------------------------------------------------------

#define OS_THREADS 512
#define OS_WARPS (OS_THREADS / 32)
#define OS_ITEMS 8
#define OS_WARP_ROWS (32 * OS_ITEMS)
#define OS_TILE (OS_THREADS * OS_ITEMS)
#define OS_MIN_BLOCKS 2
#define OS_SMEM (OS_TILE * (8 + 4))
#define OS_HIST_THREADS 512
#define OS_HIST_ROWS 4
#define OS_HIST_PER_SM 2
#define OS_FLAG_AGG 1ull
#define OS_FLAG_INC 2ull
#define OS_COUNT_MASK ((1ull << 46) - 1ull)

// The word source of sorts whose words are gathered beforehand.
struct OSNoSrc {
  __device__ __forceinline__ unsigned long long operator()(long long) const {
    return 0ull;
  }
};

// Ping-pong buffers whose current side is state[p] (0 or 1).
struct OSBufs {
  unsigned long long* keys[2];
  int* vals[2];
};

// The scratch of one sort, carved from one buffer: the ping-pong buffers,
// the side per pass, and (cleared once per sort) the byte histograms, the
// tile counters and the look-back status words.
struct OSScratch {
  OSBufs b;
  int* state;                   // [passes + 1]
  unsigned* hist;               // [passes][256]
  unsigned* ctr;                // [passes]
  unsigned long long* status;   // [tiles][256]
  void* zero;                   // hist, ctr and status
  size_t zero_bytes;
};

static long long os_tiles(long long n) {
  return n <= 0 ? 1 : (n + OS_TILE - 1) / OS_TILE;
}

static size_t os_align(size_t bytes) { return (bytes + 255) & ~(size_t)255; }

// Bytes of scratch for n rows and `passes` passes; with s != nullptr,
// also carves *s from base.  bufs false: no ping-pong buffers (a sort of
// one FROM_SRC and OUT pass moves no row through them).
static size_t os_scratch(long long n, int passes, void* base, OSScratch* s,
                         bool bufs = true) {
  const size_t rows = bufs ? (size_t)(n > 0 ? n : 1) : 0;
  const size_t sizes[9] = {rows * 8, rows * 8, rows * 4, rows * 4,
                           (size_t)(passes + 1) * 4,
                           (size_t)passes * 256 * 4, (size_t)passes * 4,
                           (size_t)os_tiles(n) * 256 * 8, 0};
  void* at[9];
  size_t off = 0;
  for (int i = 0; i < 9; ++i) {
    at[i] = base == nullptr ? nullptr : static_cast<char*>(base) + off;
    off += os_align(sizes[i]);
  }
  if (s != nullptr) {
    s->b.keys[0] = static_cast<unsigned long long*>(at[0]);
    s->b.keys[1] = static_cast<unsigned long long*>(at[1]);
    s->b.vals[0] = static_cast<int*>(at[2]);
    s->b.vals[1] = static_cast<int*>(at[3]);
    s->state = static_cast<int*>(at[4]);
    s->hist = static_cast<unsigned*>(at[5]);
    s->ctr = static_cast<unsigned*>(at[6]);
    s->status = static_cast<unsigned long long*>(at[7]);
    s->zero = at[5];
    s->zero_bytes = static_cast<char*>(at[8]) - static_cast<char*>(at[5]);
  }
  return off;
}

// Clears the histograms, tile counters and status words of one sort.
static cudaError_t os_clear(const OSScratch& s, cudaStream_t st) {
  return cudaMemsetAsync(s.zero, 0, s.zero_bytes, st);
}

// Blocks of the gather-histogram kernel for n rows.
static cudaError_t os_hist_blocks(long long n, int* blocks) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long chunk = (long long)OS_HIST_THREADS * OS_HIST_ROWS;
  const long long want = (n + chunk - 1) / chunk;
  const long long cap = (long long)sms * OS_HIST_PER_SM;
  *blocks = (int)(want < 1 ? 1 : (want < cap ? want : cap));
  return cudaSuccess;
}

// keys[side][i] = src(row at position i) for the word whose first pass is
// p, side = state[p]: the row is vals[side][i], or i for the first word of
// a sort (which also writes vals[0][i] = i and state[0] = 0).  Counts each
// of the word's nbytes bytes into hist[p + byte][digit].  STORE false:
// only counts (and sets state[0] for a first word).
template <class Src, bool STORE = true>
__global__ void __launch_bounds__(OS_HIST_THREADS)
os_gather_hist(const __grid_constant__ OSBufs b, int* __restrict__ state,
               int p, int first, const __grid_constant__ Src src, int nbytes,
               long long n, unsigned* __restrict__ hist) {
  __shared__ unsigned s_h[8 * 256];
  const int t = threadIdx.x, lane = t & 31;
  for (int j = t; j < nbytes * 256; j += OS_HIST_THREADS) s_h[j] = 0;
  __syncthreads();
  const int side = first || !STORE ? 0 : state[p];
  const int* __restrict__ perm = b.vals[side];
  unsigned long long* __restrict__ keys = b.keys[side];
  int* __restrict__ iota = b.vals[0];
  const long long chunk = (long long)OS_HIST_THREADS * OS_HIST_ROWS;
  for (long long c = (long long)blockIdx.x * chunk; c < n;
       c += (long long)gridDim.x * chunk) {
    long long r[OS_HIST_ROWS];
    unsigned long long w[OS_HIST_ROWS];
#pragma unroll
    for (int u = 0; u < OS_HIST_ROWS; ++u) {
      const long long i = c + (long long)u * OS_HIST_THREADS + t;
      r[u] = i < n ? (first ? i : (long long)perm[i]) : -1;
    }
#pragma unroll
    for (int u = 0; u < OS_HIST_ROWS; ++u) w[u] = r[u] >= 0 ? src(r[u]) : 0;
#pragma unroll
    for (int u = 0; u < OS_HIST_ROWS; ++u) {
      const long long i = c + (long long)u * OS_HIST_THREADS + t;
      const bool ok = i < n;
      if (STORE && ok) {
        keys[i] = w[u];
        if (first) iota[i] = (int)i;
      }
      const unsigned live = __ballot_sync(0xffffffffu, ok);
      if (live == 0) continue;
      for (int byte = 0; byte < nbytes; ++byte) {
        const unsigned d = (unsigned)(w[u] >> (8 * byte)) & 255u;
        const unsigned lo =
            __reduce_min_sync(0xffffffffu, ok ? d : 0xffffffffu);
        const unsigned hi = __reduce_max_sync(0xffffffffu, ok ? d : 0u);
        if (lo == hi) {
          if (lane == 0)
            atomicAdd(&s_h[byte * 256 + lo], (unsigned)__popc(live));
        } else if (ok) {
          atomicAdd(&s_h[byte * 256 + d], 1u);
        }
      }
    }
  }
  if (first && blockIdx.x == 0 && t == 0) state[p] = 0;
  __syncthreads();
  for (int j = t; j < nbytes * 256; j += OS_HIST_THREADS)
    if (s_h[j] != 0) atomicAdd(&hist[(long long)p * 256 + j], s_h[j]);
}

// Exclusive scan of one value per thread over the OS_THREADS threads.
__device__ __forceinline__ unsigned os_scan(unsigned v, unsigned* s_warp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned u = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += u;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  unsigned before = 0;
  for (int w = 0; w < warp; ++w) before += s_warp[w];
  __syncthreads();
  return before + incl - v;
}

__device__ __forceinline__ unsigned long long os_word(unsigned epoch,
                                                      unsigned long long flag,
                                                      unsigned long long v) {
  return ((unsigned long long)epoch << 48) | (flag << 46) | v;
}

// Digit t's rows in the tiles before `tile` (thread t < 256): adds
// earlier tiles' aggregates (A) until an inclusive prefix (P); a word not
// yet published in this pass is read again.
__device__ __forceinline__ unsigned long long os_look_back(
    const unsigned long long* status, long long tile, int t,
    unsigned epoch) {
  unsigned long long before = 0;
  for (long long j = tile - 1; j >= 0;) {
    const unsigned long long w =
        *(volatile const unsigned long long*)(status + j * 256 + t);
    if ((unsigned)(w >> 48) != epoch) continue;
    before += w & OS_COUNT_MASK;
    if (((w >> 46) & 3ull) == OS_FLAG_INC) break;
    --j;
  }
  return before;
}

// Pass p over bits [shift, shift + 8) of the current side: hist is this
// pass's 256 counts, ctr its tile counter, epoch p + 1.  Threads t < 256
// also stand for digit t.  FROM_SRC: the pass is the sort's first, its
// rows are src(r) with value r in input order; OUT: the sort's last, only
// the values leave, into out.
template <class Src, bool FROM_SRC, bool OUT>
__global__ void __launch_bounds__(OS_THREADS, OS_MIN_BLOCKS)
os_pass(const __grid_constant__ OSBufs b, int* __restrict__ state, int p,
        long long n, int shift, const unsigned* __restrict__ hist,
        unsigned* __restrict__ ctr, unsigned long long* status,
        unsigned epoch, const __grid_constant__ Src src,
        int* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char os_smem[];
  unsigned long long* s_keys = reinterpret_cast<unsigned long long*>(os_smem);
  int* s_vals = reinterpret_cast<int*>(os_smem + (size_t)OS_TILE * 8);
  // the ranking counters and peer masks alias the sorted tile until it is
  // stored
  unsigned(*s_cnt)[257] = reinterpret_cast<unsigned(*)[257]>(os_smem);
  unsigned(*s_peer)[257] = s_cnt + OS_WARPS;
  __shared__ unsigned s_warp[OS_WARPS];
  __shared__ unsigned s_start[256];
  __shared__ long long s_out[256];
  __shared__ unsigned s_tile;

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const bool dig = t < 256;
  const unsigned count = dig ? hist[t] : 0u;
  const int skip = __syncthreads_or(dig && (long long)count == n);
  const int side = FROM_SRC ? 0 : state[p];
  if (blockIdx.x == 0 && t == 0) state[p + 1] = skip ? side : 1 - side;
  if (skip) {
    if (FROM_SRC || OUT) {  // block b carries tile b to the output
      const long long r0 = (long long)blockIdx.x * OS_TILE;
      const long long r1 = r0 + OS_TILE < n ? r0 + OS_TILE : n;
      for (long long r = r0 + t; r < r1; r += OS_THREADS) {
        if (OUT) {
          out[r] = FROM_SRC ? (int)r : b.vals[side][r];
        } else {
          b.keys[0][r] = src(r);
          b.vals[0][r] = (int)r;
        }
      }
    }
    return;
  }

  const unsigned digit_start = os_scan(count, s_warp);
  if (t == 0) s_tile = atomicAdd(ctr, 1u);
  for (int j = t; j < 2 * OS_WARPS * 257; j += OS_THREADS)
    reinterpret_cast<unsigned*>(os_smem)[j] = 0;
  __syncthreads();
  const long long tile = s_tile;
  const long long row0 = tile * OS_TILE + warp * OS_WARP_ROWS + lane;
  const unsigned long long* __restrict__ kin = b.keys[side];
  const int* __restrict__ vin = b.vals[side];
  unsigned long long k[OS_ITEMS];
  int v[OS_ITEMS];
  int pos[OS_ITEMS];
#pragma unroll
  for (int i = 0; i < OS_ITEMS; ++i) {
    const long long r = row0 + i * 32;
    if (FROM_SRC) {
      k[i] = r < n ? src(r) : 0ull;
      v[i] = (int)r;
    } else {
      k[i] = r < n ? kin[r] : 0ull;
      v[i] = r < n ? vin[r] : 0;
    }
  }
  // rank within the warp, rows in order: item i of lane l is row
  // row0 + 32 i (warp-major, then item, then lane).  The lanes of one
  // digit find each other through a mask in shared memory (atomicOr), or
  // at once when the warp's digit is uniform; the highest of them adds
  // their count to the warp's counter of the digit.
  const unsigned lane_le = 0xffffffffu >> (31 - lane);
#pragma unroll
  for (int i = 0; i < OS_ITEMS; ++i) {
    const unsigned d = row0 + i * 32 < n
                           ? (unsigned)((k[i] >> shift) & 255ull) : 256u;
    const bool uniform = __reduce_min_sync(0xffffffffu, d) ==
                         __reduce_max_sync(0xffffffffu, d);
    unsigned peers = 0xffffffffu;
    if (!uniform) {
      atomicOr(&s_peer[warp][d], 1u << lane);
      __syncwarp();
      peers = s_peer[warp][d];
    }
    const unsigned base = s_cnt[warp][d];
    __syncwarp();
    const int le = __popc(peers & lane_le);
    if (lane == 31 - __clz(peers)) {
      s_cnt[warp][d] = base + le;
      if (!uniform) s_peer[warp][d] = 0;
    }
    __syncwarp();
    pos[i] = (int)base + le - 1;
  }
  __syncthreads();
  // digit t: the warps' counts become their offsets; the tile's count,
  // published at once
  unsigned tile_cnt = 0;
  volatile unsigned long long* mine = status + tile * 256 + t;
  if (dig) {
#pragma unroll
    for (int w = 0; w < OS_WARPS; ++w) {
      const unsigned c = s_cnt[w][t];
      s_cnt[w][t] = tile_cnt;
      tile_cnt += c;
    }
    *mine = os_word(epoch, tile == 0 ? OS_FLAG_INC : OS_FLAG_AGG, tile_cnt);
  }
  const unsigned start = os_scan(tile_cnt, s_warp);
  if (dig) s_start[t] = start;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < OS_ITEMS; ++i) {
    if (row0 + i * 32 < n) {
      const int d = (int)((k[i] >> shift) & 255ull);
      pos[i] += (int)(s_start[d] + s_cnt[warp][d]);
    }
  }
  if (dig) {
    const unsigned long long before = os_look_back(status, tile, t, epoch);
    if (tile > 0) *mine = os_word(epoch, OS_FLAG_INC, before + tile_cnt);
    // slot j of the sorted tile, digit t, goes to s_out[t] + j
    s_out[t] = (long long)digit_start + (long long)before - (long long)start;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < OS_ITEMS; ++i) {
    if (row0 + i * 32 < n) {
      s_keys[pos[i]] = k[i];
      s_vals[pos[i]] = v[i];
    }
  }
  __syncthreads();
  const long long left = n - tile * OS_TILE;
  const int rows = left < OS_TILE ? (int)left : OS_TILE;
  unsigned long long* __restrict__ kout = b.keys[1 - side];
  int* __restrict__ vout = b.vals[1 - side];
  for (int j = t; j < rows; j += OS_THREADS) {
    const unsigned long long key = s_keys[j];
    const long long g = s_out[(int)((key >> shift) & 255ull)] + j;
    if (OUT) {
      out[g] = s_vals[j];
    } else {
      kout[g] = key;
      vout[g] = s_vals[j];
    }
  }
}

template <class Src, bool FROM_SRC, bool OUT>
static cudaError_t os_pass_run(const OSScratch& s, int p, long long n,
                               int shift, cudaStream_t st, const Src& src,
                               int* out) {
  cudaError_t err = cudaFuncSetAttribute(
      os_pass<Src, FROM_SRC, OUT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, OS_SMEM);
  if (err != cudaSuccess) return err;
  os_pass<Src, FROM_SRC, OUT><<<(unsigned)os_tiles(n), OS_THREADS, OS_SMEM,
                                st>>>(
      s.b, s.state, p, n, shift, s.hist + (size_t)p * 256, s.ctr + p,
      s.status, (unsigned)(p + 1), src, out);
  return cudaGetLastError();
}

// Pass p over bits [shift, shift + 8) of n rows; its counts are in
// s.hist[p], filled by the word's os_gather_hist.
static cudaError_t os_pass_launch(const OSScratch& s, int p, long long n,
                                  int shift, cudaStream_t st) {
  return os_pass_run<OSNoSrc, false, false>(s, p, n, shift, st, OSNoSrc(),
                                            nullptr);
}

// The same for a sort that starts from src in input order: from_src for
// its first pass, out (non-null) for its last.
template <class Src>
static cudaError_t os_pass_launch_src(const OSScratch& s, int p, long long n,
                                      int shift, cudaStream_t st,
                                      const Src& src, bool from_src,
                                      int* out) {
  if (from_src)
    return out != nullptr
               ? os_pass_run<Src, true, true>(s, p, n, shift, st, src, out)
               : os_pass_run<Src, true, false>(s, p, n, shift, st, src,
                                               nullptr);
  return out != nullptr
             ? os_pass_run<Src, false, true>(s, p, n, shift, st, src, out)
             : os_pass_run<Src, false, false>(s, p, n, shift, st, src,
                                              nullptr);
}
