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
//
// Design: ks_prepare writes each row's int64 key (the sort word: sort.cu
// orders int64 words by their signed value) and its live-and-valid flag,
// and folds min, max and the count into out[0..2] with atomics.  The words
// are then sorted by sort.cu's radix sort_perm with the flag as its live
// mask, so the n_valid valid keys come first in ascending order.
// ks_distinct reads them through the permutation in three kernels: per
// 1,024-row tile, the number of first-of-a-run keys below BIG and of
// repeated keys below BIG; one block scans the tile counts into tile
// offsets and writes dup and n_distinct; per tile, a block scan places
// each first-of-a-run key at its rank, while the rank is below vcap.
// n_valid is read on the device (out[2]), so nothing waits on the host.
//
// Bound: device memory.  ks_prepare reads the key (4 or 8 B), the validity
// and live bytes and writes the 8-byte word and the flag byte; the sort
// makes its radix passes over the words (sort.cu); ks_distinct reads the
// permutation (4 B) and two words at random rows (one sector each) per
// valid row and writes the distinct prefix.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define KS_THREADS 256
#define KS_ITEMS 4
#define KS_TILE (KS_THREADS * KS_ITEMS)
#define KS_HEADER 5
#define KS_BIG LLONG_MAX

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

__global__ void __launch_bounds__(KS_THREADS)
ks_prepare_k(const void* __restrict__ key, int elem,
             const uint8_t* __restrict__ valid,
             const uint8_t* __restrict__ active, long long n,
             long long* __restrict__ word, uint8_t* __restrict__ ok,
             long long* __restrict__ out) {
  long long lo = KS_BIG, hi = -KS_BIG, cnt = 0;
  const long long stride = (long long)gridDim.x * KS_THREADS;
  for (long long i = (long long)blockIdx.x * KS_THREADS + threadIdx.x; i < n;
       i += stride) {
    const long long w = elem == 8 ? ((const long long*)key)[i]
                                  : (long long)((const int*)key)[i];
    const bool live = (valid == nullptr || valid[i]) &&
                      (active == nullptr || active[i]);
    word[i] = w;
    ok[i] = live;
    if (live) {
      lo = w < lo ? w : lo;
      hi = w > hi ? w : hi;
      cnt++;
    }
  }
  for (int d = 16; d > 0; d >>= 1) {
    const long long l2 = __shfl_down_sync(0xffffffffu, lo, d);
    const long long h2 = __shfl_down_sync(0xffffffffu, hi, d);
    lo = l2 < lo ? l2 : lo;
    hi = h2 > hi ? h2 : hi;
    cnt += __shfl_down_sync(0xffffffffu, cnt, d);
  }
  if ((threadIdx.x & 31) == 0 && cnt > 0) {
    atomicMin(&out[0], lo);
    atomicMax(&out[1], hi);
    atomicAdd((unsigned long long*)&out[2], (unsigned long long)cnt);
  }
}

// the sorted valid key at rank i (i < n_valid)
__device__ __forceinline__ long long ks_at(const long long* word,
                                           const int* perm, long long i) {
  return word[perm == nullptr ? i : perm[i]];
}

// per tile: [0] first-of-a-run keys below BIG, [1] repeats below BIG
__global__ void __launch_bounds__(KS_THREADS)
ks_count_k(const long long* __restrict__ word, const int* __restrict__ perm,
           const long long* __restrict__ out, long long* __restrict__ tiles,
           long long ntiles) {
  const long long n_valid = out[2];
  __shared__ long long s_first[KS_THREADS / 32], s_dup[KS_THREADS / 32];
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
    long long first = 0, dup = 0;
    const long long base = t * KS_TILE + (long long)threadIdx.x * KS_ITEMS;
    for (int k = 0; k < KS_ITEMS; k++) {
      const long long i = base + k;
      if (i >= n_valid) break;
      const long long v = ks_at(word, perm, i);
      if (v == KS_BIG) continue;
      if (i == 0 || ks_at(word, perm, i - 1) != v) first++;
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
      for (int w = 0; w < KS_THREADS / 32; w++) {
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
  __shared__ long long s_sum[1024], s_dup[1024];
  const long long per = (ntiles + 1023) / 1024;
  const long long lo = threadIdx.x * per;
  const long long hi = lo + per < ntiles ? lo + per : ntiles;
  long long sum = 0, dup = 0;
  for (long long t = lo; t < hi; t++) {
    sum += tiles[2 * t];
    dup += tiles[2 * t + 1];
  }
  s_sum[threadIdx.x] = sum;
  s_dup[threadIdx.x] = dup;
  __syncthreads();
  for (int d = 1; d < 1024; d <<= 1) {   // inclusive Hillis-Steele scan
    long long a = threadIdx.x >= d ? s_sum[threadIdx.x - d] : 0;
    long long b = threadIdx.x >= d ? s_dup[threadIdx.x - d] : 0;
    __syncthreads();
    s_sum[threadIdx.x] += a;
    s_dup[threadIdx.x] += b;
    __syncthreads();
  }
  long long run = s_sum[threadIdx.x] - sum;   // exclusive
  for (long long t = lo; t < hi; t++) {
    const long long c = tiles[2 * t];
    tiles[2 * t] = run;
    run += c;
  }
  if (threadIdx.x == 1023) {
    out[3] = s_dup[1023];
    out[4] = s_sum[1023];
  }
}

// per tile: each first-of-a-run key below BIG at its rank, if below vcap
__global__ void __launch_bounds__(KS_THREADS)
ks_place_k(const long long* __restrict__ word, const int* __restrict__ perm,
           const long long* __restrict__ tiles, long long ntiles,
           long long vcap, long long* __restrict__ out) {
  const long long n_valid = out[2];
  __shared__ long long s_warp[KS_THREADS / 32];
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
        vals[k] = ks_at(word, perm, i);
        flag[k] = vals[k] != KS_BIG &&
                  (i == 0 || ks_at(word, perm, i - 1) != vals[k]);
      }
      mine += flag[k];
    }
    // block exclusive scan of the per-thread counts
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
    long long inc = mine;
    for (int d = 1; d < 32; d <<= 1) {
      const long long y = __shfl_up_sync(0xffffffffu, inc, d);
      if (lane >= d) inc += y;
    }
    if (lane == 31) s_warp[wid] = inc;
    __syncthreads();
    long long wbase = 0;
    for (int w = 0; w < wid; w++) wbase += s_warp[w];
    long long rank = toff + wbase + inc - mine;
    for (int k = 0; k < KS_ITEMS; k++) {
      if (flag[k]) {
        if (rank < vcap) out[KS_HEADER + rank] = vals[k];
        rank++;
      }
    }
    __syncthreads();
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
// rows -> word (int64 [n]), ok (bool [n]), out[0..2] and the padded
// values of out (int64 [5 + vcap]).
extern "C" int ks_prepare(const void* key, int elem, const void* valid,
                          const void* active, long long n, void* word,
                          void* ok, void* out, long long vcap,
                          void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  ks_init<<<ks_blocks(KS_HEADER + vcap, 4), KS_THREADS, 0, s>>>(
      (long long*)out, vcap);
  if (n > 0) {
    ks_prepare_k<<<ks_blocks(n, 8), KS_THREADS, 0, s>>>(
        key, elem, (const uint8_t*)valid, (const uint8_t*)active, n,
        (long long*)word, (uint8_t*)ok, (long long*)out);
  }
  return (int)cudaGetLastError();
}

// word (int64 [n]) and perm (int32 [n], the valid keys first in
// ascending order; null: word is sorted already) -> out[3], out[4] and
// the distinct values; tiles is int64 scratch of 2 * ceil(n / 1024).
extern "C" int ks_distinct(const void* word, const void* perm, long long n,
                           void* out, long long vcap, void* tiles,
                           void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long ntiles = (n + KS_TILE - 1) / KS_TILE;
  if (ntiles == 0) return (int)cudaGetLastError();
  const int grid = ks_blocks(ntiles * KS_THREADS, 8);
  ks_count_k<<<grid, KS_THREADS, 0, s>>>(
      (const long long*)word, (const int*)perm, (const long long*)out,
      (long long*)tiles, ntiles);
  ks_scan_k<<<1, 1024, 0, s>>>((long long*)tiles, ntiles, (long long*)out);
  ks_place_k<<<grid, KS_THREADS, 0, s>>>(
      (const long long*)word, (const int*)perm, (const long long*)tiles,
      ntiles, vcap, (long long*)out);
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
