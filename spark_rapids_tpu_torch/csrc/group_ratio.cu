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
// One device operation a call, no sort and no fill: an open-addressing set
// of 2^19 int64 slots takes at most 2^18 sampled rows, so it is at most
// half full and a probe always ends.  The wrapper keeps a scratch per
// (device, stream) with two such sets, filled with all-ones words (-1: an
// empty slot, an unset flag, a ticket no block has taken) once when it is
// made.  A word of the scratch says which set the call inserts into: every
// block reads it first, and the call's last block flips it.  A call
// inserts into that set and empties the other, the one the call before it
// filled (which ended before it on the stream), in 16-byte stores spread
// over every thread.  So the set a call inserts into is always empty, with
// no barrier inside the call, no fill outside it and no host state.
//   * one row a thread (a grid-stride loop past 2^18 threads);
//   * in a warp, lanes with equal hashes are merged first
//     (__match_any_sync): one lane of each run of a key inserts, so a key
//     repeated by neighbouring rows costs one CAS;
//   * a CAS that finds the empty word inserts (one distinct value), one
//     that finds the same hash stops, another probes the next slot.  The
//     hash equal to the empty word is counted by the set's flag word;
//   * each block writes its two counts to its own partial words; the last
//     block through a ticket (which counts the blocks done, plus one)
//     sums them, writes both counts to the output (no zeroed output
//     needed), resets the ticket and flips the set word.
// Both scalars ride the reference's one fetch.  A failed launch makes the
// wrapper drop the stream's scratch, so no call reads a dirty set.
//
// Bound: device memory.  Per sampled row: 8 bytes of hash and 1 of mask
// read; 16 bytes written.  Besides: a random sector of the set per
// inserted value, and the 4 MiB of the other set emptied (both in L2).  At
// 2^18 rows the launch floor, not bytes, bounds a call.

#include <cuda_runtime.h>
#include <stdint.h>

#define GR_THREADS 256
#define GR_SLOTS (1 << 19)
#define GR_MAX_ROWS (1 << 18)
#define GR_MIN_BLOCKS 256   // blocks that empty the other set at least
#define GR_MAX_BLOCKS 1024  // one row a thread at 2^18 rows
#define GR_EMPTY 0xffffffffffffffffULL
// scratch words: two sets of GR_SLOTS slots, a flag word and a pad word
// each (so both sets are 16-byte aligned), the ticket, the set word (its
// low bit: the set the next call inserts into), then two partial words a
// block
#define GR_SET_WORDS (GR_SLOTS + 2)
#define GR_TICKET (2 * GR_SET_WORDS)
#define GR_WHICH (GR_TICKET + 1)
#define GR_PARTS (GR_TICKET + 2)
#define GR_WORDS (GR_PARTS + 2 * GR_MAX_BLOCKS)

__device__ __forceinline__ unsigned long long gr_mix(unsigned long long h) {
  h ^= h >> 33;
  h *= 0xff51afd7ed558ccdULL;
  h ^= h >> 33;
  h *= 0xc4ceb9fe1a85ec53ULL;
  return h ^ (h >> 33);
}

__device__ __forceinline__ unsigned long long block_sum(unsigned long long x,
                                                        unsigned long long* s) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  __syncthreads();  // s is free
  if ((threadIdx.x & 31) == 0) s[threadIdx.x >> 5] = x;
  __syncthreads();
  unsigned long long sum = 0;
  for (int w = 0; w < GR_THREADS / 32; ++w) sum += s[w];
  return sum;
}

__global__ void __launch_bounds__(GR_THREADS)
gr_count(const long long* __restrict__ h, const uint8_t* __restrict__ active,
         long long n, unsigned long long* __restrict__ scratch,
         long long* __restrict__ out) {
  __shared__ unsigned long long s_sum[GR_THREADS / 32];
  __shared__ int s_last;
  // read before this block takes its ticket, so before the last block
  // flips it
  const int which = (int)(__ldcg(scratch + GR_WHICH) & 1);
  unsigned long long* set = scratch + (long long)which * GR_SET_WORDS;
  unsigned long long* other = scratch + (long long)(1 - which) * GR_SET_WORDS;
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * GR_THREADS;
  const long long g = (long long)blockIdx.x * GR_THREADS + threadIdx.x;
  // empty the set the last call filled: its slots and flag word, 16 bytes
  // a store
  for (long long w = g; w < GR_SET_WORDS / 2; w += stride)
    reinterpret_cast<uint4*>(other)[w] =
        make_uint4(0xffffffffu, 0xffffffffu, 0xffffffffu, 0xffffffffu);
  unsigned long long live = 0, distinct = 0;
  for (long long base = (long long)blockIdx.x * GR_THREADS; base < n;
       base += stride) {  // uniform over each warp
    const long long r = base + threadIdx.x;
    const bool in = r < n && (active == nullptr || active[r]);
    const unsigned long long key = in ? (unsigned long long)h[r] : 0;
    const unsigned lanes = __ballot_sync(0xffffffffu, in);
    const unsigned peers = __match_any_sync(0xffffffffu, key) & lanes;
    if (!in) continue;
    ++live;
    if (lane != __ffs(peers) - 1) continue;  // a lower lane has this key
    if (key == GR_EMPTY) {  // the empty word's own value: the flag
      distinct += atomicCAS(set + GR_SLOTS, GR_EMPTY, 1ULL) == GR_EMPTY;
      continue;
    }
    unsigned long long slot = gr_mix(key) & (GR_SLOTS - 1);
    unsigned long long prev = atomicCAS(set + slot, GR_EMPTY, key);
    while (prev != GR_EMPTY && prev != key) {
      slot = (slot + 1) & (GR_SLOTS - 1);
      prev = atomicCAS(set + slot, GR_EMPTY, key);
    }
    distinct += prev == GR_EMPTY;
  }
  const unsigned long long bd = block_sum(distinct, s_sum);
  const unsigned long long bl = block_sum(live, s_sum);
  if (threadIdx.x == 0) {
    scratch[GR_PARTS + 2 * blockIdx.x] = bd;
    scratch[GR_PARTS + 2 * blockIdx.x + 1] = bl;
    __threadfence();
    s_last = atomicAdd(scratch + GR_TICKET, 1ULL) + 1 == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  unsigned long long d = 0, l = 0;
  for (unsigned b = threadIdx.x; b < gridDim.x; b += GR_THREADS) {
    d += __ldcg(scratch + GR_PARTS + 2 * b);
    l += __ldcg(scratch + GR_PARTS + 2 * b + 1);
  }
  d = block_sum(d, s_sum);
  l = block_sum(l, s_sum);
  if (threadIdx.x == 0) {
    out[0] = (long long)d;
    out[1] = (long long)l;
    scratch[GR_TICKET] = GR_EMPTY;  // every block has taken its ticket
    scratch[GR_WHICH] = (unsigned long long)(which ^ 1);
  }
}

// int64 words of one stream's scratch (the wrapper fills it with -1,
// once).
extern "C" long long group_ratio_scratch_words() { return GR_WORDS; }

// Host entry, bound with ctypes.  h: int64 [n] hashes; active: uint8 [n]
// or nullptr; scratch: this stream's GR_WORDS words as the last call on
// the stream left them; out: two int64 words (distinct, live), written.
// n <= 2^18.  Returns cudaGetLastError() after the launch.
extern "C" int group_ratio(const void* h, const void* active, long long n,
                           void* scratch, void* out, void* stream) {
  if (n < 0 || n > GR_MAX_ROWS) return (int)cudaErrorInvalidValue;
  const long long want = (n + GR_THREADS - 1) / GR_THREADS;
  const int blocks = (int)(want < GR_MIN_BLOCKS ? GR_MIN_BLOCKS
                           : want > GR_MAX_BLOCKS ? GR_MAX_BLOCKS : want);
  gr_count<<<blocks, GR_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(h), static_cast<const uint8_t*>(active),
      n, static_cast<unsigned long long*>(scratch),
      static_cast<long long*>(out));
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
