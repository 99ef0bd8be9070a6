// key_stats: the build-key statistics of a runtime join filter — min, max,
// valid count, exact duplicate and distinct counts, and the first vcap
// distinct keys in ascending order — over the live, valid keys of one
// build batch.
//
// Replaces: spark_rapids_tpu/plan/join_exec.py:161 _inject_smj_filter (its
// stats program :196-211 and values program :223-235) and the dense
// prefetch program :1265-1287 that feeds :1522 _inject_dpp.  Both sort the
// keys widened to int64, with every dead or null row replaced by
// BIG = INT64_MAX, and read:
//   kmin = min over valid keys (BIG when none), kmax = max (-BIG when none),
//   n_valid, dup = #{i >= 1: s[i] == s[i-1] and s[i] != BIG},
//   the distinct values of s below BIG in ascending order, padded with BIG.
// The port's layout is out[0..4] = kmin, kmax, n_valid, dup, n_distinct
// (the number of distinct values below BIG), out[5..5+vcap) = the values.
// Only the valid keys matter: the BIG rows sort last and count nowhere.
//
// Design: every row is read once.  ks_compact folds min, max and the valid
// count into out[0..2] and writes the valid keys (int64) to a dense prefix
// of `pre`, in no particular order: per 1,024-row tile a block scan places
// each valid key and one atomic on out[2] reserves the tile's room.  Only
// that prefix is sorted, and its length is read on the device, so the host
// never waits (the stats ride the probe chain's one fetch):
//   * small path (n_valid <= KS_SMALL = 16,384 keys, 128 KiB): one block
//     loads the prefix into shared memory, bitonic-sorts it (BIG-padded to
//     a power of two) and writes dup, n_distinct and the distinct keys;
//   * large path (otherwise): a stable LSD radix sort of the prefix, keys
//     only, over the bytes of key - kmin that kmax - kmin needs (Q18's
//     orderkeys span ~26 bits: 4 passes), each pass a histogram, a scan
//     and a scatter by a fixed grid of persistent blocks, each owning one
//     contiguous chunk of the prefix (chunk order and in-chunk rank keep
//     the pass stable); then the tile counts, their scan and the placement
//     of the distinct keys over the sorted prefix.
// Every kernel of both paths is launched (the large path's only when the
// batch has more rows than KS_SMALL); each reads n_valid and the key range
// first and exits when its path or pass is not the one the data needs, so
// which path runs is decided on the device.
//
// Bound: device memory.  The key (4 or 8 B), validity and live bytes are
// read once; the large path adds per pass a read of the prefix (histogram)
// and a read and a write (scatter), 24 B per valid key, then one read of
// the sorted prefix.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define KS_THREADS 256
#define KS_ITEMS 4
#define KS_TILE (KS_THREADS * KS_ITEMS)
#define KS_HEADER 5
#define KS_BIG LLONG_MAX
#define KS_SMALL 16384          // keys the one-block path sorts
#define KS_SMALL_THREADS 1024
#define KS_WARPS (KS_THREADS / 32)

__global__ void ks_init(long long* __restrict__ out, long long vcap) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       j < KS_HEADER + vcap; j += stride) {
    long long v = KS_BIG;             // kmin, and the padding of the values
    if (j == 1) v = -KS_BIG;          // kmax
    else if (j >= 2 && j < KS_HEADER) v = 0;
    out[j] = v;
  }
}

// Block-wide exclusive scan of one value per thread (blockDim.x a multiple
// of 32, at most 1,024); *total receives the sum.  s_warp: 32 words.
__device__ __forceinline__ long long ks_block_scan(long long x,
                                                   long long* s_warp,
                                                   long long* total) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  long long inc = x;
  for (int d = 1; d < 32; d <<= 1) {
    const long long y = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc += y;
  }
  if (lane == 31) s_warp[wid] = inc;
  __syncthreads();
  if (wid == 0) {
    long long w = lane < nw ? s_warp[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const long long y = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += y;
    }
    s_warp[lane] = w;   // inclusive per warp
  }
  __syncthreads();
  const long long excl = inc - x + (wid > 0 ? s_warp[wid - 1] : 0);
  *total = s_warp[nw - 1];
  __syncthreads();
  return excl;
}

// One pass over the rows: min, max and count of the valid keys into
// out[0..2], the valid keys to pre[0..n_valid) in any order.
__global__ void __launch_bounds__(KS_THREADS)
ks_compact_k(const void* __restrict__ key, int elem,
             const uint8_t* __restrict__ valid,
             const uint8_t* __restrict__ active, long long n,
             long long* __restrict__ pre, long long* __restrict__ out) {
  __shared__ long long s_warp[32];
  __shared__ long long s_base;
  long long lo = KS_BIG, hi = -KS_BIG;
  const long long ntiles = (n + KS_TILE - 1) / KS_TILE;
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
    long long w[KS_ITEMS];
    bool live[KS_ITEMS];
    long long mine = 0;
#pragma unroll
    for (int k = 0; k < KS_ITEMS; k++) {
      const long long i = t * KS_TILE + (long long)k * KS_THREADS + threadIdx.x;
      live[k] = i < n && (valid == nullptr || valid[i]) &&
                (active == nullptr || active[i]);
      w[k] = 0;
      if (live[k]) {
        w[k] = elem == 8 ? ((const long long*)key)[i]
                         : (long long)((const int*)key)[i];
        lo = w[k] < lo ? w[k] : lo;
        hi = w[k] > hi ? w[k] : hi;
        mine++;
      }
    }
    long long total;
    long long pos = ks_block_scan(mine, s_warp, &total);
    if (threadIdx.x == 0 && total > 0)
      s_base = (long long)atomicAdd((unsigned long long*)&out[2],
                                    (unsigned long long)total);
    __syncthreads();
    if (total > 0) {
      pos += s_base;
#pragma unroll
      for (int k = 0; k < KS_ITEMS; k++)
        if (live[k]) pre[pos++] = w[k];
    }
    __syncthreads();
  }
  for (int d = 16; d > 0; d >>= 1) {
    const long long l2 = __shfl_down_sync(0xffffffffu, lo, d);
    const long long h2 = __shfl_down_sync(0xffffffffu, hi, d);
    lo = l2 < lo ? l2 : lo;
    hi = h2 > hi ? h2 : hi;
  }
  if ((threadIdx.x & 31) == 0 && lo <= hi) {
    atomicMin(&out[0], lo);
    atomicMax(&out[1], hi);
  }
}

// ---------------------------------------------------------------------------
// Small path: one block, the prefix in shared memory
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(KS_SMALL_THREADS)
ks_small_k(const long long* __restrict__ pre, long long* __restrict__ out,
           long long vcap) {
  extern __shared__ long long s_keys[];
  __shared__ long long s_warp[32];
  const long long nv = out[2];
  if (nv == 0 || nv > KS_SMALL) return;
  int m = 1;
  while (m < nv) m <<= 1;
  for (int i = threadIdx.x; i < m; i += blockDim.x)
    s_keys[i] = i < nv ? pre[i] : KS_BIG;
  __syncthreads();
  // bitonic sort of m keys, ascending
  for (int k = 2; k <= m; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < m; i += blockDim.x) {
        const int p = i ^ j;
        if (p > i) {
          const long long a = s_keys[i], b = s_keys[p];
          if ((a > b) == ((i & k) == 0)) {
            s_keys[i] = b;
            s_keys[p] = a;
          }
        }
      }
      __syncthreads();
    }
  }
  // each thread a contiguous run of the sorted keys
  const int per = (int)((nv + blockDim.x - 1) / blockDim.x);
  const int lo = threadIdx.x * per;
  const int hi = lo + per < nv ? lo + per : (int)nv;
  long long first = 0, dup = 0;
  for (int i = lo; i < hi; i++) {
    const long long v = s_keys[i];
    if (v == KS_BIG) break;
    if (i > 0 && s_keys[i - 1] == v) dup++;
    else first++;
  }
  long long n_distinct;
  long long rank = ks_block_scan(first, s_warp, &n_distinct);
  for (int i = lo; i < hi && rank < vcap; i++) {
    const long long v = s_keys[i];
    if (v == KS_BIG) break;
    if (i == 0 || s_keys[i - 1] != v) out[KS_HEADER + rank++] = v;
  }
  long long dups;
  ks_block_scan(dup, s_warp, &dups);
  if (threadIdx.x == 0) {
    out[3] = dups;
    out[4] = n_distinct;
  }
}

// ---------------------------------------------------------------------------
// Large path: stable LSD radix passes over the prefix
// ---------------------------------------------------------------------------

// Does pass `shift` run?  Only on the large path, and only while the key
// range has bits at or above `shift`.
__device__ __forceinline__ bool ks_pass_runs(const long long* out,
                                             int shift) {
  const long long nv = out[2];
  if (nv <= KS_SMALL) return false;
  const unsigned long long range =
      (unsigned long long)out[1] - (unsigned long long)out[0];
  return (range >> shift) != 0ULL;
}

__device__ __forceinline__ int ks_digit(long long k, unsigned long long kmin,
                                        int shift) {
  return (int)((((unsigned long long)k - kmin) >> shift) & 255ULL);
}

// The rows [*lo, *hi) of the prefix that block b owns.
__device__ __forceinline__ void ks_chunk(long long nv, long long* lo,
                                         long long* hi) {
  long long per = (nv + gridDim.x - 1) / gridDim.x;
  per = (per + KS_THREADS - 1) / KS_THREADS * KS_THREADS;
  *lo = (long long)blockIdx.x * per;
  *hi = *lo + per < nv ? *lo + per : nv;
}

// hist[d * gridDim.x + b]: keys of block b's chunk whose digit is d.
__global__ void __launch_bounds__(KS_THREADS)
ks_hist_k(const long long* __restrict__ src, const long long* __restrict__ out,
          int shift, long long* __restrict__ hist) {
  if (!ks_pass_runs(out, shift)) return;
  __shared__ int s[256];
  s[threadIdx.x] = 0;
  __syncthreads();
  const unsigned long long kmin = (unsigned long long)out[0];
  long long lo, hi;
  ks_chunk(out[2], &lo, &hi);
  for (long long i = lo + threadIdx.x; i < hi; i += KS_THREADS)
    atomicAdd(&s[ks_digit(src[i], kmin, shift)], 1);
  __syncthreads();
  hist[(long long)threadIdx.x * gridDim.x + blockIdx.x] = s[threadIdx.x];
}

// One block: the exclusive scan of the digit-major histogram in place
// (256 digits x nb blocks).  Each warp scans its digits' runs of nb
// counts (coalesced, with shuffles), the digit totals are scanned, and
// each digit's base is added to its run.
__global__ void __launch_bounds__(1024)
ks_hscan_k(long long* __restrict__ hist, int nb,
           const long long* __restrict__ out, int shift) {
  if (!ks_pass_runs(out, shift)) return;
  __shared__ long long s_tot[256];
  __shared__ long long s_warp[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int d = warp; d < 256; d += 32) {
    long long* h = hist + (long long)d * nb;
    long long carry = 0;
    for (int b0 = 0; b0 < nb; b0 += 32) {
      const int b = b0 + lane;
      const long long v = b < nb ? h[b] : 0;
      long long inc = v;
      for (int o = 1; o < 32; o <<= 1) {
        const long long y = __shfl_up_sync(0xffffffffu, inc, o);
        if (lane >= o) inc += y;
      }
      if (b < nb) h[b] = carry + inc - v;
      carry += __shfl_sync(0xffffffffu, inc, 31);
    }
    if (lane == 0) s_tot[d] = carry;
  }
  __syncthreads();
  long long total;
  const long long base = ks_block_scan(
      threadIdx.x < 256 ? s_tot[threadIdx.x] : 0, s_warp, &total);
  if (threadIdx.x < 256) s_tot[threadIdx.x] = base;
  __syncthreads();
  for (int d = warp; d < 256; d += 32) {
    long long* h = hist + (long long)d * nb;
    const long long add = s_tot[d];
    for (int b = lane; b < nb; b += 32) h[b] += add;
  }
}

// Each key of block b's chunk to offs[d * gridDim.x + b] + (keys before it
// in the chunk with digit d): rounds of 256 keys, ranked within a warp by
// __match_any_sync and across warps by per-warp counts in shared memory.
__global__ void __launch_bounds__(KS_THREADS)
ks_scatter_k(const long long* __restrict__ src, long long* __restrict__ dst,
             const long long* __restrict__ out, int shift,
             const long long* __restrict__ offs) {
  if (!ks_pass_runs(out, shift)) return;
  __shared__ long long s_base[256];
  __shared__ int s_cnt[KS_WARPS][257];
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const unsigned long long kmin = (unsigned long long)out[0];
  long long lo, hi;
  ks_chunk(out[2], &lo, &hi);
  s_base[t] = offs[(long long)t * gridDim.x + blockIdx.x];
  for (int w = 0; w < KS_WARPS; ++w) s_cnt[w][t] = 0;
  if (t < KS_WARPS) s_cnt[t][256] = 0;
  __syncthreads();
  for (long long r0 = lo; r0 < hi; r0 += KS_THREADS) {
    const long long r = r0 + t;
    const bool ok = r < hi;
    const long long k = ok ? src[r] : 0;
    const int d = ok ? ks_digit(k, kmin, shift) : 256;
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    const int rank = __popc(peers & ((1u << lane) - 1u));
    if (lane == __ffs(peers) - 1) s_cnt[warp][d] = __popc(peers);
    __syncthreads();
    if (ok) {
      long long pos = s_base[d] + rank;
      for (int w = 0; w < warp; ++w) pos += s_cnt[w][d];
      dst[pos] = k;
    }
    __syncthreads();
    int total = 0;
    for (int w = 0; w < KS_WARPS; ++w) {
      total += s_cnt[w][t];
      s_cnt[w][t] = 0;
    }
    s_base[t] += total;
    __syncthreads();
  }
}

// The buffer that holds the sorted prefix: pass p reads buf[p & 1] and
// writes the other, and one pass runs per byte of the key range.
__device__ __forceinline__ const long long* ks_sorted(
    const long long* buf0, const long long* buf1, const long long* out) {
  const unsigned long long range =
      (unsigned long long)out[1] - (unsigned long long)out[0];
  int passes = 0;
  while (passes < 8 && (range >> (8 * passes)) != 0ULL) passes++;
  return (passes & 1) ? buf1 : buf0;
}

// per tile of the sorted prefix: [0] first-of-a-run keys below BIG,
// [1] repeats below BIG
__global__ void __launch_bounds__(KS_THREADS)
ks_count_k(const long long* __restrict__ buf0,
           const long long* __restrict__ buf1,
           const long long* __restrict__ out, long long* __restrict__ tiles,
           long long ntiles) {
  const long long n_valid = out[2];
  if (n_valid <= KS_SMALL) return;
  const long long* word = ks_sorted(buf0, buf1, out);
  __shared__ long long s_first[KS_WARPS], s_dup[KS_WARPS];
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
    long long first = 0, dup = 0;
    const long long base = t * KS_TILE + (long long)threadIdx.x * KS_ITEMS;
    for (int k = 0; k < KS_ITEMS; k++) {
      const long long i = base + k;
      if (i >= n_valid) break;
      const long long v = word[i];
      if (v == KS_BIG) continue;
      if (i == 0 || word[i - 1] != v) first++;
      else dup++;
    }
    for (int d = 16; d > 0; d >>= 1) {
      first += __shfl_down_sync(0xffffffffu, first, d);
      dup += __shfl_down_sync(0xffffffffu, dup, d);
    }
    if ((threadIdx.x & 31) == 0) {
      s_first[threadIdx.x >> 5] = first;
      s_dup[threadIdx.x >> 5] = dup;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      long long f = 0, u = 0;
      for (int w = 0; w < KS_WARPS; w++) {
        f += s_first[w];
        u += s_dup[w];
      }
      tiles[2 * t] = f;
      tiles[2 * t + 1] = u;
    }
    __syncthreads();
  }
}

// one block: tile counts -> exclusive tile offsets (in place of the
// first-of-a-run counts); out[3] = dup, out[4] = n_distinct
__global__ void __launch_bounds__(1024)
ks_scan_k(long long* __restrict__ tiles, long long ntiles,
          long long* __restrict__ out) {
  if (out[2] <= KS_SMALL) return;
  __shared__ long long s_warp[32];
  const long long per = (ntiles + 1023) / 1024;
  const long long lo = threadIdx.x * per;
  const long long hi = lo + per < ntiles ? lo + per : ntiles;
  long long sum = 0, dup = 0;
  for (long long t = lo; t < hi; t++) {
    sum += tiles[2 * t];
    dup += tiles[2 * t + 1];
  }
  long long n_distinct, dups;
  long long run = ks_block_scan(sum, s_warp, &n_distinct);
  ks_block_scan(dup, s_warp, &dups);
  for (long long t = lo; t < hi; t++) {
    const long long c = tiles[2 * t];
    tiles[2 * t] = run;
    run += c;
  }
  if (threadIdx.x == 0) {
    out[3] = dups;
    out[4] = n_distinct;
  }
}

// per tile: each first-of-a-run key below BIG at its rank, if below vcap
__global__ void __launch_bounds__(KS_THREADS)
ks_place_k(const long long* __restrict__ buf0,
           const long long* __restrict__ buf1,
           const long long* __restrict__ tiles, long long ntiles,
           long long vcap, long long* __restrict__ out) {
  const long long n_valid = out[2];
  if (n_valid <= KS_SMALL) return;
  const long long* word = ks_sorted(buf0, buf1, out);
  __shared__ long long s_warp[32];
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const long long toff = tiles[2 * t];
    if (toff >= vcap) continue;   // uniform per block: every rank is past
    const long long base = t * KS_TILE + (long long)threadIdx.x * KS_ITEMS;
    long long vals[KS_ITEMS];
    bool flag[KS_ITEMS];
    long long mine = 0;
    for (int k = 0; k < KS_ITEMS; k++) {
      const long long i = base + k;
      flag[k] = false;
      if (i < n_valid) {
        vals[k] = word[i];
        flag[k] = vals[k] != KS_BIG && (i == 0 || word[i - 1] != vals[k]);
      }
      mine += flag[k];
    }
    long long total;
    long long rank = toff + ks_block_scan(mine, s_warp, &total);
    for (int k = 0; k < KS_ITEMS; k++) {
      if (flag[k]) {
        if (rank < vcap) out[KS_HEADER + rank] = vals[k];
        rank++;
      }
    }
  }
}

static int ks_blocks(long long work, int per_sm) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long b = (work + KS_THREADS - 1) / KS_THREADS;
  const long long cap = (long long)sms * per_sm;
  if (b > cap) b = cap;
  return b < 1 ? 1 : (int)b;
}

// key (int32 or int64 by elem), valid and active (bool bytes or null), n
// rows -> out (int64 [5 + vcap]).  pre: int64 [n] scratch; when
// n > KS_SMALL, alt: a second int64 [n], hist: int64 [256 * blocks] and
// tiles: int64 [2 * ceil(n / 1024)] scratch, blocks the large path's
// grid (persistent blocks, at most 2^16).
extern "C" int key_stats(const void* key, int elem, const void* valid,
                         const void* active, long long n, void* pre,
                         void* alt, void* out, long long vcap, void* hist,
                         void* tiles, int blocks, void* stream) {
  if ((elem != 4 && elem != 8) || n < 0 || vcap < 1 || pre == nullptr
      || (n > KS_SMALL && (alt == nullptr || hist == nullptr
                           || tiles == nullptr || blocks < 1
                           || blocks > 65536)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  long long* o = (long long*)out;
  long long* b0 = (long long*)pre;
  long long* b1 = (long long*)alt;
  ks_init<<<ks_blocks(KS_HEADER + vcap, 4), KS_THREADS, 0, s>>>(o, vcap);
  if (n == 0) return (int)cudaGetLastError();
  ks_compact_k<<<ks_blocks((n + KS_ITEMS - 1) / KS_ITEMS, 8), KS_THREADS, 0,
                 s>>>(key, elem, (const uint8_t*)valid,
                      (const uint8_t*)active, n, b0, o);
  cudaError_t err = cudaFuncSetAttribute(
      ks_small_k, cudaFuncAttributeMaxDynamicSharedMemorySize,
      KS_SMALL * (int)sizeof(long long));
  if (err != cudaSuccess) return (int)err;
  ks_small_k<<<1, KS_SMALL_THREADS, KS_SMALL * sizeof(long long), s>>>(
      b0, o, vcap);
  err = cudaGetLastError();
  if (err != cudaSuccess || n <= KS_SMALL) return (int)err;
  long long* h = (long long*)hist;
  const int passes = elem == 4 ? 4 : 8;   // an int32 range has 4 bytes
  for (int p = 0; p < passes; p++) {
    const long long* src = (p & 1) ? b1 : b0;
    long long* dst = (p & 1) ? b0 : b1;
    ks_hist_k<<<blocks, KS_THREADS, 0, s>>>(src, o, 8 * p, h);
    ks_hscan_k<<<1, 1024, 0, s>>>(h, blocks, o, 8 * p);
    ks_scatter_k<<<blocks, KS_THREADS, 0, s>>>(src, dst, o, 8 * p, h);
  }
  const long long ntiles = (n + KS_TILE - 1) / KS_TILE;
  const int grid = ks_blocks(ntiles * KS_THREADS, 8);
  long long* tl = (long long*)tiles;
  ks_count_k<<<grid, KS_THREADS, 0, s>>>(b0, b1, o, tl, ntiles);
  ks_scan_k<<<1, 1024, 0, s>>>(tl, ntiles, o);
  ks_place_k<<<grid, KS_THREADS, 0, s>>>(b0, b1, tl, ntiles, vcap, o);
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
