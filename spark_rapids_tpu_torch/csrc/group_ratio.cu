// group_ratio: the partial aggregate's skip probe — how many distinct key
// hashes, and how many live rows, among the first rows of the first batch.
//
// Replaces: spark_rapids_tpu/plan/physical.py:2006 _sample_group_ratio,
// whose program sorts where(active, h, INT64_MAX) of the sampled rows'
// 32-bit murmur3 key hashes (widened to int64) and counts the adjacent
// distinct values below INT64_MAX, beside the live-row count.  The two
// counts decide whether the partial aggregate passes its rows through
// unreduced (distinct / live > sql.agg.skipPartialAggRatio), so the count
// here must equal the sort's exactly: it counts distinct hash VALUES (two
// keys whose hashes collide count once, as they do there).
//
// One launch, no sort: an open-addressing set of 2^19 int64 slots in
// device memory (the caller fills it with -1; a hash is a uint32 widened,
// so never -1) takes at most 2^18 sampled rows, so it is at most half full
// and a probe always ends.  A live row atomicCAS'es its hash into the
// first empty slot of its probe sequence unless it meets the same hash on
// the way; each successful insert is one distinct value.  Per block, the
// inserts and the live rows are summed in registers and shared memory and
// added to the two output words with one atomic each, so both scalars ride
// the reference's one fetch.
//
// Bound: device memory.  Per sampled row: 8 bytes of hash and 1 of mask
// read, and one random 32-byte sector of the set touched; 4 MiB of set
// written by the caller's fill.

#include <cuda_runtime.h>
#include <stdint.h>

#define GR_THREADS 256
#define GR_SLOTS (1 << 19)
#define GR_MAX_ROWS (1 << 18)
#define GR_EMPTY 0xffffffffffffffffULL

__device__ __forceinline__ unsigned long long gr_mix(unsigned long long h) {
  h ^= h >> 33;
  h *= 0xff51afd7ed558ccdULL;
  h ^= h >> 33;
  h *= 0xc4ceb9fe1a85ec53ULL;
  return h ^ (h >> 33);
}

__global__ void __launch_bounds__(GR_THREADS)
gr_count(const long long* __restrict__ h, const uint8_t* __restrict__ active,
         long long n, unsigned long long* __restrict__ set,
         unsigned long long* __restrict__ out) {
  unsigned long long distinct = 0, live = 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += stride) {
    if (active != nullptr && !active[r]) continue;
    ++live;
    const unsigned long long key = (unsigned long long)h[r];
    unsigned long long slot = gr_mix(key) & (GR_SLOTS - 1);
    while (true) {
      const unsigned long long prev = atomicCAS(set + slot, GR_EMPTY, key);
      if (prev == GR_EMPTY) {
        ++distinct;
        break;
      }
      if (prev == key) break;
      slot = (slot + 1) & (GR_SLOTS - 1);
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    distinct += __shfl_down_sync(0xffffffffu, distinct, o);
    live += __shfl_down_sync(0xffffffffu, live, o);
  }
  __shared__ unsigned long long s_d[GR_THREADS / 32], s_l[GR_THREADS / 32];
  if ((threadIdx.x & 31) == 0) {
    s_d[threadIdx.x >> 5] = distinct;
    s_l[threadIdx.x >> 5] = live;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < GR_THREADS / 32; ++w) {
      distinct += s_d[w];
      live += s_l[w];
    }
    if (distinct) atomicAdd(out, distinct);
    if (live) atomicAdd(out + 1, live);
  }
}

// Host entry, bound with ctypes.  h: int64 [n] hashes (each in [0, 2^32));
// active: uint8 [n] or nullptr; set: [2^19] words filled with -1; out: two
// int64 words (distinct, live), zeroed by the caller.  n <= 2^18.  Returns
// cudaGetLastError() after the launch.
extern "C" int group_ratio(const void* h, const void* active, long long n,
                           void* set, void* out, void* stream) {
  if (n < 0 || n > GR_MAX_ROWS) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long want = (n + GR_THREADS - 1) / GR_THREADS;
  const int blocks = (int)(want < (long long)sms * 4 ? want : sms * 4);
  gr_count<<<blocks, GR_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(h), static_cast<const uint8_t*>(active),
      n, static_cast<unsigned long long*>(set),
      static_cast<unsigned long long*>(out));
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
