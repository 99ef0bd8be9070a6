// hash_agg: grouped aggregation into one open-addressing hash table that
// serves the whole input stream, and the final aggregate's merge of
// partial buffers into such a table.
//
// Replaces: spark_rapids_tpu/ops/groupby.py:251 group_reduce (with :137
// group_sort_indices, :174 _segment_starts, :193 _reduce_segment) and the
// per-batch partials it leaves to plan/physical.py:2211 _merge_partials —
// the reference's sort-based grouped aggregation — and, for the merge,
// plan/physical.py:2296 _merge_fn, which re-reduces concatenated partials
// with group_reduce.  This is cuDF's design (a device hash table); the
// reference leaves output order unspecified.
//
// Keys are tuples of int64 words (integers, dates, booleans and dictionary
// codes as they are; floats as their order-preserving image, with -0.0 =
// +0.0 and one NaN) plus a null bit per key: a null is its own group and
// its word is taken as 0.
//
// The table.  One record per slot: `stride` int64 words (a power of two),
// word 0 holding the tag in its low half (0 empty, 1 busy, 2 + gid ready)
// and the null bits in its high half, words 1..nkeys the key words, so a
// probe reads one or two sectors.  Each group gets a dense id (gid) from
// the device group counter when its slot is claimed (one atomic per warp
// of claimers), and per gid a value record of W words holds every
// channel's words, and a meta record (slot, null bits, key words) gives
// the output its keys in gid order, so no call sweeps the slots and the
// output needs no compaction of a slot-sized table.  The claimer writes
// the value record from `init`, with its own row's contribution, before
// it publishes the slot (release store of its tag), so nothing is filled
// per call and a group's first row takes no atomic; probes read tags
// relaxed and fence only to read another thread's record.  A table grows
// by hash_agg_reinsert: every gid's slot re-placed into empty records.
//
// The value record (laid out by the caller, ops/groupby.py
// record_layout): the hot words first, where a row adds — a count's, an
// int64 sum's, min's or max's word, a float64 min's or max's image, a
// float64 sum's query-scale pair [lo, hi], a FIRST/LAST row word — then
// the cold words: per float64 sum [float64 word, the call's largest |x|,
// fallback lo, hi], per FIRST/LAST its value word; W a multiple of 4 past
// 2 words, so a record starts on a 32-byte sector and a row of TPC-H Q18's
// shape (a float64 sum and a count) adds into one sector of it.  The
// claimer writes the record's words but a float64 sum's fallback pair,
// which the thread that first raises the call's largest |x| from 0 zeroes:
// a fresh group of a float64 sum alone (the final's merge at Q18) writes
// one sector.
//
// Per row: int64 sums and counts add (wrapping), int64 min/max and the
// float64 min/max images (f64_image: -0.0 below +0.0, NaN to the winning
// end — the reference's segment_min/segment_max semantics) take their
// extreme.  float64 sums are exact integers at the query's scale
// (fixed128.cuh): the first call with finite non-zero values sets each
// channel's scale from its largest |x| (ha_prepare, a read of the float
// columns that returns at once once every scale is set); a value within
// 2^-21..2^19 of that |x| adds once, at its row, into the query-scale
// pair, and the pairs become float64 only at the output (hash_agg_fold,
// over the gids).  Any other finite non-zero value raises its group's
// per-call largest-|x| word in the same pass, and the thread that raises
// it from 0 appends (group, channel) to the call's touched list; ha_rows
// then adds those values at that per-call scale (only a row with such a
// value probes for its group, unless FIRST/LAST gave it its gid; ha_rows
// returns at once when the list is empty and no channel is FIRST/LAST).
// The next call's ha_prepare turns each listed entry into float64 over
// the whole grid and empties the list, and hash_agg_fold does it for the
// last call, from the group's words: no launch of its own, and no call
// touches groups its far values did not reach.  Infinities and NaN go to
// the float64 word with atomicAdd.  Sums are integers, so they are equal
// to the bit from run to run.  The scale words, the list's count and its
// call's rows live in a small per-table array that starts zeroed (no fill
// on the host), with the group count each launch starts from, which the
// previous launch's last block notes: a probe that finds an older group
// reads its record without a fence.  Launches a call: ha_prepare (float64
// sums), ha_update, ha_rows (float64 sums or FIRST/LAST).
//
// FIRST and LAST (the reference's _reduce_segment first/last,
// ops/groupby.py:195; first_valid/last_valid are the same with the value's
// validity as the channel's mask): the hot word picks the row, then the
// row writes its value in ha_rows, a second pass over the rows that only
// calls with FIRST/LAST make (through a per-row gid, rgid).  FIRST: the
// word starts at INT64_MAX; each qualifying row's number lowers it
// (atomicMin), and in ha_rows the row whose number the word holds writes
// the value and sets the word to INT64_MIN, "filled", which no later row
// can lower: the first batch with a qualifying row decides.  LAST: each
// qualifying row raises (call << 40 | row) into a word that starts at -1,
// and the row that holds the word writes the value: every call's last row
// overwrites the earlier ones.  No order-dependent write decides a value.
//
// Few groups.  Before any global atomic, a row adds into its block's
// cache when it can: a direct-mapped shared-memory table of up to 256
// entries (gid & (K - 1)), each the hot words of one gid, claimed once
// with a 32-bit CAS and flushed once per block with device atomics; a gid
// whose entry another gid holds goes to device memory.  At TPC-H Q7's 4
// groups and Q9's 175 every gid keeps an entry, so a block's rows add in
// shared memory (without it, 9.17 and 0.57 ms at those shapes against
// 0.09 and 0.12, tools/agg_bench.py); with millions of groups most rows
// miss and add to device memory, the cache costing a shared read a row
// and one flush of at most 256 entries a block.  Combining a warp's lanes
// of one group first (as grid_agg.cu does) measured slower in front of
// the cache (Q9's shape 0.147 against 0.124 ms, Q7's 0.127 against 0.098)
// and no faster elsewhere: rows add alone.  Every combined result is
// exact and order-free: int64 sums wrap, fixed-point sums are integers,
// min and max do not depend on the order, and FIRST/LAST pick by row
// number.
//
// Each channel's (op, type) is fixed once per call (its class, cls),
// outside the row loop, and each key count of 1 or 2 has its own
// instantiation, whose key words stay in registers.  The merge entry runs
// the same kernels: a partial buffer column is the channel's data and its
// validity the channel's mask, so a sum buffer (a sum's or a count's
// partials, int64 or float64) adds, a min or max buffer takes its extreme,
// and a FIRST or LAST buffer — (value, has) — picks the first or last
// partial row that had a qualifying row, in stream order (the call number
// orders the batches); a wide-decimal SUM's lanes are int64 sum buffers.
//
// Why this layout: the update runs on the merge table built for the final
// aggregate (dense gids, a slot record and a value record), so both
// share one claim routine, one growth and one output in gid order, with no
// pass over a slot-sized table; value words inside the slot record (one
// record a probe, but a slot-sized output to compact and wider records to
// re-place) were not built.  Measured (tools/kernel_ab.py, tools/
// agg_bench.py, H100 80GB HBM3 at 700 W): 4 blocks an SM run every shape
// fastest or near it (2: Q21's keys 0.216 against 0.161 ms, Q9's groups
// 0.185 against 0.118; 8: the merge 1.61 against 1.55); a warp-uniform
// loop beats lanes drifting apart at Q18's shape (0.42 against 0.51 ms);
// a merge's first call pays the scale's extra read (ha_prepare, 18 us of
// 1.48 ms at Q18's final).
//
// Bound: device memory.  Per row: its key words, contributions and masks
// (read once), and one random slot record and value record sector, read
// and written; collisions add probe steps.  A `collide` flag sends every
// key to one bucket, which tests linear probing and the busy wait.

#include <cooperative_groups.h>
#include <cuda/atomic>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "fixed128.cuh"

#define HA_THREADS 256
#define HA_MAX_KEYS 8
#define HA_MAX_CH 32
#define HA_MAX_HOT (2 * HA_MAX_CH)
#define HA_MAX_W (5 * HA_MAX_CH + 4)  // words of a value record
#define HA_CACHE_MAX 256        // cache entries a block
#define HA_CACHE_BYTES (40 * 1024)
#define HA_BLOCKS_PER_SM 4
// words past the float64 sums' 2 nf (largest |x| bits, scale words)
#define HA_W_FBN 0              // the touched (group, channel) count
#define HA_W_G0 1               // the groups before the next launch
#define HA_W_TICKET 2           // blocks done, for the last block's work
#define HA_W_FBROWS 3           // the rows of the list's call (its scales)
#define HA_WORDS_PAST 4

#define OP_SUM 0
#define OP_MIN 1
#define OP_MAX 2
#define OP_COUNT 3
#define OP_FIRST 4
#define OP_LAST 5

// a channel's (op, type), fixed for the call
enum { C_COUNT = 0, C_ISUM, C_IMIN, C_IMAX, C_FMIN, C_FMAX, C_FSUM, C_FIRST,
       C_LAST };
// how a hot word combines (the cache's flush)
enum { K_ADD = 0, K_ADD128, K_HI, K_MIN, K_MAX };

#define HA_FILLED LLONG_MIN  // a FIRST word whose value is written
#define HA_CALL_SHIFT 40     // LAST words: call << 40 | row

#define HM_EMPTY 0
#define HM_BUSY 1
#define HM_GID0 2          // tag = HM_GID0 + gid once the slot is ready

struct HAArgs {
  const long long* word[HA_MAX_KEYS];
  const uint8_t* kvalid[HA_MAX_KEYS];  // nullptr: no nulls
  int nkeys;
  const void* data[HA_MAX_CH];         // nullptr for a count
  const uint8_t* valid[HA_MAX_CH];     // nullptr: every live row
  int cls[HA_MAX_CH];
  int hot[HA_MAX_CH];    // the channel's first hot word
  int cold[HA_MAX_CH];   // float64 sum: its cold words; FIRST/LAST: value
  int fq[HA_MAX_CH];     // float64 sum: its index among them
  int hkind[HA_MAX_HOT]; // per hot word, how it combines
  int nch, nf, W, H, ordered;
  int used;              // words of the record in use (W past padding)
  const uint8_t* active;
  long long n;
  long long call;        // the call's number, from 1
  int collide;
  // the table
  long long* recs;       // [cap, stride] slot records
  int stride;
  long long cap;
  long long* meta;       // [gids, 2 + nkeys]: slot, null bits, keys
  long long* vals;       // [gids, W] value records
  long long init[HA_MAX_W];  // a fresh value record's words (in the
                            // kernel's parameters: read from the constant
                            // bank, not memory, by each claimer)
  unsigned long long* ngroups;
  long long* words;      // [nf] largest |x| bits, [nf] scale words, then
                         // HA_WORDS_PAST words (HA_W_*)
  int* rgid;             // [n] per-row gid (FIRST/LAST), else nullptr
  long long* fblist;     // [n nf] the call's touched gid * nch + channel
  const long long* fbprev;  // the previous call's list (ha_prepare folds)
  int K;                 // cache entries a block (0: none)
};

__device__ __forceinline__ unsigned long long* fb_count(const HAArgs& a) {
  return reinterpret_cast<unsigned long long*>(a.words + 2 * a.nf + HA_W_FBN);
}

// (gid, channel j) onto the call's touched list: one atomic per group of
// threads that arrive together.  Each entry is appended once a call, by
// the thread that raised its largest-|x| word from 0.
__device__ __forceinline__ void fb_touch(const HAArgs& a, long long gid,
                                         int j) {
  namespace cg = cooperative_groups;
  cg::coalesced_group g = cg::coalesced_threads();
  unsigned long long base = 0;
  if (g.thread_rank() == 0) base = atomicAdd(fb_count(a), g.size());
  a.fblist[g.shfl(base, 0) + g.thread_rank()] = gid * a.nch + j;
}

// A touched channel's per-call integer (fallback words w[1..3] of its
// value record's cold words: largest |x|, pair) into its float64 word
// w[0], cleared; a cleared entry (already folded) stays as it is.
__device__ __forceinline__ void fb_fold(unsigned long long* w,
                                        long long rows) {
  if (w[1] == 0ULL) return;
  reinterpret_cast<double*>(w)[0] +=
      fx_to_double(w[2], w[3], fx_scale(w[1], rows));
  w[1] = w[2] = w[3] = 0ULL;
}

// True in one thread of the launch's last block to finish (each block's
// writes fenced before its ticket); that block resets the ticket.
__device__ __forceinline__ bool last_block(const HAArgs& a) {
  __shared__ bool s_last;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    unsigned long long* t = reinterpret_cast<unsigned long long*>(
        a.words + 2 * a.nf + HA_W_TICKET);
    s_last = atomicAdd(t, 1ULL) == (unsigned long long)gridDim.x - 1;
    if (s_last) *t = 0ULL;
  }
  __syncthreads();
  if (s_last) __threadfence();
  return s_last;
}

__device__ __forceinline__ unsigned long long mix64(unsigned long long h) {
  h ^= h >> 30;
  h *= 0xbf58476d1ce4e5b9ULL;
  h ^= h >> 27;
  h *= 0x94d049bb133111ebULL;
  h ^= h >> 31;
  return h;
}

__device__ __forceinline__ unsigned long long hash_tuple(
    const long long* w, int nulls, int nkeys) {
  unsigned long long h = mix64(0x9e3779b97f4a7c15ULL ^ (unsigned)nulls);
  for (int i = 0; i < nkeys; ++i)
    h = mix64(h ^ ((unsigned long long)w[i] + 0x9e3779b97f4a7c15ULL * (i + 1)));
  return h;
}

// int64 image of a double, monotonic with -0.0 below +0.0; NaN maps to
// `nan_image` (INT64_MIN for a min, INT64_MAX for a max: NaN wins).
__device__ __forceinline__ long long f64_image(double x, long long nan_image) {
  if (x != x) return nan_image;
  const long long b = __double_as_longlong(x);
  return b >= 0 ? b : b ^ 0x7fffffffffffffffLL;
}

__device__ __forceinline__ int* hm_tag(long long* recs, int stride,
                                       long long slot) {
  return reinterpret_cast<int*>(recs + slot * stride);
}

// A dense gid for each calling thread: one atomic per group of threads
// that arrive together (cooperative_groups' coalesced group).
__device__ __forceinline__ long long hm_next_gid(
    unsigned long long* ngroups) {
  namespace cg = cooperative_groups;
  cg::coalesced_group g = cg::coalesced_threads();
  unsigned long long base = 0;
  if (g.thread_rank() == 0)
    base = atomicAdd(ngroups, (unsigned long long)g.size());
  return (long long)(g.shfl(base, 0) + g.thread_rank());
}

// The gid of the tuple (w, nulls): found (*claimed -1), or, when CLAIM,
// claimed (*claimed the slot): a fresh gid and its meta record are written
// and the slot is left busy, for the caller to write the value record and
// publish (hm_publish).  Without CLAIM (every group exists) an empty slot
// ends the probe with -1.  g0: the groups that existed when the launch
// began.
template <bool CLAIM>
__device__ __forceinline__ long long hm_find(const HAArgs& a,
                                             const long long* w, int nulls,
                                             int nkeys, long long g0,
                                             long long* claimed) {
  const long long mask = a.cap - 1;
  long long slot =
      a.collide ? 0 : (long long)(hash_tuple(w, nulls, nkeys) & mask);
  *claimed = -1;
  while (true) {
    long long* rec = a.recs + slot * a.stride;
    // a plain (L1-cacheable) read first, when older groups exist: a slot
    // published before this launch (gid < g0) never changes again, so its
    // tag and keys are read without a fence; a stale empty or busy tag is
    // settled by the claim's CAS or the relaxed reads below (with no older
    // group, as in a merge's first call, the relaxed read comes first)
    int s = g0 > 0 ? *hm_tag(a.recs, a.stride, slot) : HM_BUSY;
    if (s >= HM_GID0 && s - HM_GID0 < g0) {
      bool same = reinterpret_cast<const int*>(rec)[1] == nulls;
      for (int i = 0; same && i < nkeys; ++i) same = rec[1 + i] == w[i];
      if (same) return (long long)(s - HM_GID0);
      slot = (slot + 1) & mask;
      continue;
    }
    cuda::atomic_ref<int, cuda::thread_scope_device> tag(
        *hm_tag(a.recs, a.stride, slot));
    // an empty slot goes straight to the claim's CAS, which settles it;
    // a busy or new one is read again, relaxed
    if (s != HM_EMPTY) s = tag.load(cuda::std::memory_order_relaxed);
    if (s == HM_EMPTY) {
      if (!CLAIM) return -1;
      int expected = HM_EMPTY;
      if (tag.compare_exchange_strong(expected, HM_BUSY,
                                      cuda::std::memory_order_relaxed)) {
        const long long gid = hm_next_gid(a.ngroups);
        reinterpret_cast<int*>(rec)[1] = nulls;
        long long* meta = a.meta + gid * (2 + nkeys);
        meta[0] = slot;
        meta[1] = nulls;
        for (int i = 0; i < nkeys; ++i) rec[1 + i] = meta[2 + i] = w[i];
        *claimed = slot;
        return gid;
      }
      s = expected;
    }
    while (s == HM_BUSY) s = tag.load(cuda::std::memory_order_relaxed);
    cuda::atomic_thread_fence(cuda::std::memory_order_acquire,
                              cuda::thread_scope_device);
    bool same = __ldcg(reinterpret_cast<const int*>(rec) + 1) == nulls;
    for (int i = 0; same && i < nkeys; ++i) same = __ldcg(rec + 1 + i) == w[i];
    if (same) return (long long)(s - HM_GID0);
    slot = (slot + 1) & mask;
  }
}

// Makes a claimed slot's records visible: a release store of its gid.
__device__ __forceinline__ void hm_publish(const HAArgs& a, long long slot,
                                           long long gid) {
  cuda::atomic_ref<int, cuda::thread_scope_device> tag(
      *hm_tag(a.recs, a.stride, slot));
  tag.store((int)(HM_GID0 + gid), cuda::std::memory_order_release);
}

// Row r's key words and null bits.
template <int NK>
__device__ __forceinline__ int row_keys(const HAArgs& a, long long r,
                                        long long* w) {
  const int nkeys = NK > 0 ? NK : a.nkeys;
  int nulls = 0;
  for (int i = 0; i < nkeys; ++i) {
    const bool ok = a.kvalid[i] == nullptr || a.kvalid[i][r];
    w[i] = ok ? a.word[i][r] : 0;
    if (!ok) nulls |= 1 << i;
  }
  return nulls;
}

__device__ __forceinline__ bool ch_valid(const HAArgs& a, int j, long long r) {
  return a.valid[j] == nullptr || a.valid[j][r];
}

// The claimer's own row into its group's fresh value record v (plain
// stores: no other thread sees the record before it is published).
__device__ __forceinline__ void contribute_fresh(const HAArgs& a, int j,
                                                 long long r, long long* v,
                                                 const long long* s_scale,
                                                 long long gid) {
  long long* h = v + a.hot[j];
  switch (a.cls[j]) {
    case C_COUNT: *h += 1; break;
    case C_ISUM:
      *h = (long long)((unsigned long long)*h + (unsigned long long)
                       static_cast<const long long*>(a.data[j])[r]);
      break;
    case C_IMIN: {
      const long long x = static_cast<const long long*>(a.data[j])[r];
      if (x < *h) *h = x;
      break;
    }
    case C_IMAX: {
      const long long x = static_cast<const long long*>(a.data[j])[r];
      if (x > *h) *h = x;
      break;
    }
    case C_FMIN: {
      const long long x = f64_image(
          static_cast<const double*>(a.data[j])[r], LLONG_MIN);
      if (x < *h) *h = x;
      break;
    }
    case C_FMAX: {
      const long long x = f64_image(
          static_cast<const double*>(a.data[j])[r], LLONG_MAX);
      if (x > *h) *h = x;
      break;
    }
    case C_FSUM: {
      const double x = static_cast<const double*>(a.data[j])[r];
      long long* c = v + a.cold[j];
      if (!isfinite(x)) {
        reinterpret_cast<double*>(c)[0] += x;
      } else if (x != 0.0) {
        const long long sc = s_scale[a.fq[j]];
        if (fx_in_range(x, sc)) {
          unsigned long long lo, hi;
          fx_int(x, fx_scale_of(sc), &lo, &hi);
          h[0] = (long long)lo;
          h[1] = (long long)hi;
        } else {  // the fallback: its pair zeroed as its |x| word leaves 0
          c[1] = __double_as_longlong(fabs(x));
          c[2] = c[3] = 0;
          fb_touch(a, gid, j);
        }
      }
      break;
    }
    case C_FIRST: *h = r; break;
    default: *h = (a.call << HA_CALL_SHIFT) | r; break;  // C_LAST
  }
}

// The leader's combined contribution of one hot word into `t` (a cache
// entry's words or the value record's), by the word's kind.
__device__ __forceinline__ void add_hot(unsigned long long* t, int kind,
                                        unsigned long long v,
                                        unsigned long long hi) {
  switch (kind) {
    case K_ADD:
      if (v != 0ULL) atomicAdd(t, v);
      break;
    case K_ADD128: fx_add_words(t, v, hi); break;
    case K_MIN: {
      long long* p = reinterpret_cast<long long*>(t);
      if ((long long)v < *p) atomicMin(p, (long long)v);
      break;
    }
    case K_MAX: {
      long long* p = reinterpret_cast<long long*>(t);
      if ((long long)v > *p) atomicMax(p, (long long)v);
      break;
    }
    default: break;  // K_HI: added with its K_ADD128 word
  }
}

// Before ha_update: folds the previous call's touched list (entries are
// distinct, so no two threads fold one record's words) and empties it
// (its last block), and, while a float64 sum's query scale is not set
// (the first calls with rows), takes its channel's largest finite |x|
// over the call's live rows into words[q] (one atomic a block), from which
// ha_update makes the scale, so the first call adds at the query scale
// too.  With no list and every scale set the blocks return at once.
__global__ void __launch_bounds__(HA_THREADS)
ha_prepare(const __grid_constant__ HAArgs a) {
  __shared__ unsigned long long s_max[HA_THREADS / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const unsigned long long pending = *fb_count(a);
  const long long rows = a.words[2 * a.nf + HA_W_FBROWS];
  for (unsigned long long e =
           (unsigned long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < pending; e += (unsigned long long)stride) {
    const long long t = a.fbprev[e];
    const long long g = t / a.nch;
    fb_fold(reinterpret_cast<unsigned long long*>(
                a.vals + g * a.W + a.cold[t - g * a.nch]), rows);
  }
  for (int j = 0; j < a.nch; ++j) {
    if (a.cls[j] != C_FSUM || a.words[a.nf + a.fq[j]] != 0) continue;
    unsigned long long m = 0;
    // four rows a step, their loads issued together
    for (long long r0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         r0 < a.n; r0 += 4 * stride) {
      double x[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const long long r = r0 + u * stride;
        x[u] = r < a.n && (a.active == nullptr || a.active[r]) &&
                       ch_valid(a, j, r)
            ? __ldg(static_cast<const double*>(a.data[j]) + r) : 0.0;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (!fx_finite_nonzero(x[u])) continue;
        const unsigned long long b =
            (unsigned long long)__double_as_longlong(fabs(x[u]));
        m = b > m ? b : m;
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      const unsigned long long o2 = __shfl_down_sync(0xffffffffu, m, o);
      m = o2 > m ? o2 : m;
    }
    if (lane == 0) s_max[warp] = m;
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int w = 1; w < HA_THREADS / 32; ++w) m = s_max[w] > m ? s_max[w] : m;
      if (m) atomicMax(reinterpret_cast<unsigned long long*>(
                           a.words + a.fq[j]), m);
    }
    __syncthreads();
  }
  // every block read the count before its ticket
  if (pending != 0ULL && last_block(a) && threadIdx.x == 0)
    *fb_count(a) = 0ULL;
}

// NK > 0: a table of NK keys, whose words stay in registers; NK == 0: any
// number, a.nkeys.
template <int NK>
__global__ void __launch_bounds__(HA_THREADS)
ha_update(const __grid_constant__ HAArgs a) {
  extern __shared__ long long cache[];  // [K][H] words, then [K] int tags
  __shared__ long long s_scale[HA_MAX_CH];
  const int K = a.K, H = a.H;
  int* tags = reinterpret_cast<int*>(cache + (long long)K * H);
  for (int t = threadIdx.x; t < K * H; t += blockDim.x)
    cache[t] = a.init[t % H];
  for (int t = threadIdx.x; t < K; t += blockDim.x) tags[t] = -1;
  if ((int)threadIdx.x < a.nf) {
    // the channel's query scale: set, or made now from the largest |x|
    // the first calls' fallback left (every block makes the same; block 0
    // keeps it)
    const int q = threadIdx.x;
    long long sc = a.words[a.nf + q];
    if (sc == 0 && a.words[q] != 0) {
      sc = fx_scale_word((unsigned long long)a.words[q]);
      if (blockIdx.x == 0) a.words[a.nf + q] = sc;
    }
    s_scale[q] = sc;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0 && a.nf > 0)
    a.words[2 * a.nf + HA_W_FBROWS] = a.n;  // the scale of this call's list
  __syncthreads();
  const int nkeys = NK > 0 ? NK : a.nkeys;
  // the groups that existed when the launch began (the previous launch's
  // last block noted them)
  const long long g0 = a.words[2 * a.nf + HA_W_G0];
  const int lane = threadIdx.x & 31;
  const long long threads = (long long)gridDim.x * blockDim.x;
  // warp-uniform: a warp takes 32 consecutive rows a step and reconverges
  // before its lanes add (their atomics issue together: measured faster
  // than lanes drifting apart, tools/agg_bench.py)
  for (long long r0 = (long long)blockIdx.x * blockDim.x + (threadIdx.x & ~31);
       r0 < a.n; r0 += threads) {
    const long long r = r0 + lane;
    const bool live = r < a.n && (a.active == nullptr || a.active[r]);
    long long gid = -1, claimed = -1;
    long long* v = nullptr;
    if (live) {
      long long w[NK > 0 ? NK : HA_MAX_KEYS];
      const int nulls = row_keys<NK>(a, r, w);
      gid = hm_find<true>(a, w, nulls, nkeys, g0, &claimed);
      v = a.vals + gid * a.W;
      if (claimed >= 0) {
        // the record's words from the parameters, two a store when the
        // record is 16-byte aligned (W even)
        if ((a.W & 1) == 0) {
          longlong2* v2 = reinterpret_cast<longlong2*>(v);
          for (int i = 0; i < a.used; i += 2)
            v2[i / 2] = make_longlong2(a.init[i], a.init[i + 1]);
        } else {
          for (int i = 0; i < a.used; ++i) v[i] = a.init[i];
        }
        for (int j = 0; j < a.nch; ++j)
          if (ch_valid(a, j, r)) contribute_fresh(a, j, r, v, s_scale, gid);
        hm_publish(a, claimed, gid);
      }
    }
    if (a.rgid != nullptr && r < a.n) a.rgid[r] = (int)gid;
    if (a.nch == 0) continue;
    const bool adds = live && claimed < 0;
    if (__ballot_sync(0xffffffffu, adds) == 0u || !adds) continue;
    // the row's target: its group's cache entry, or the value record
    unsigned long long* hot = reinterpret_cast<unsigned long long*>(v);
    if (K > 0) {
      const int e = (int)(gid & (K - 1));
      int t = tags[e];
      if (t == -1) {
        t = atomicCAS(tags + e, -1, (int)gid);
        if (t == -1) t = (int)gid;
      }
      if (t == (int)gid)
        hot = reinterpret_cast<unsigned long long*>(cache + (long long)e * H);
    }
    for (int j = 0; j < a.nch; ++j) {
      if (!ch_valid(a, j, r)) continue;
      const int cls = a.cls[j];
      unsigned long long* t = hot + a.hot[j];
      if (cls == C_FSUM) {
        const double x = static_cast<const double*>(a.data[j])[r];
        if (!isfinite(x)) {  // inf and NaN sums do not depend on the order
          atomicAdd(reinterpret_cast<double*>(v + a.cold[j]), x);
        } else if (x != 0.0) {
          const long long sc = s_scale[a.fq[j]];
          if (fx_in_range(x, sc)) {
            unsigned long long lo, hi;
            fx_int(x, fx_scale_of(sc), &lo, &hi);
            fx_add_words(t, lo, hi);
          } else {  // rare: the fallback
            // the group's per-call largest |x|; the thread that raises it
            // from 0 zeroes the fallback pair (the claimer does not) and
            // lists the group
            const unsigned long long m =
                (unsigned long long)__double_as_longlong(fabs(x));
            unsigned long long* mw =
                reinterpret_cast<unsigned long long*>(v + a.cold[j] + 1);
            if (m > *mw && atomicMax(mw, m) == 0ULL) {
              mw[1] = mw[2] = 0ULL;
              fb_touch(a, gid, j);
            }
          }
        }
      } else if (cls == C_COUNT) {
        add_hot(t, K_ADD, 1ULL, 0);
      } else if (cls == C_ISUM) {
        add_hot(t, K_ADD, (unsigned long long)
                static_cast<const long long*>(a.data[j])[r], 0);
      } else if (cls == C_IMIN || cls == C_IMAX) {
        add_hot(t, cls == C_IMAX ? K_MAX : K_MIN, (unsigned long long)
                static_cast<const long long*>(a.data[j])[r], 0);
      } else if (cls == C_FMIN || cls == C_FMAX) {
        const bool is_max = cls == C_FMAX;
        add_hot(t, is_max ? K_MAX : K_MIN, (unsigned long long)f64_image(
            static_cast<const double*>(a.data[j])[r],
            is_max ? LLONG_MAX : LLONG_MIN), 0);
      } else {  // FIRST and LAST row words
        add_hot(t, cls == C_LAST ? K_MAX : K_MIN, (unsigned long long)(
            cls == C_FIRST ? r : ((a.call << HA_CALL_SHIFT) | r)), 0);
      }
    }
  }
  if (K > 0) {
    __syncthreads();
    // the cache's entries into their value records, once a block
    for (int t = threadIdx.x; t < K * H; t += blockDim.x) {
      const int e = t / H, w = t % H;
      const int gid = tags[e];
      if (gid < 0) continue;
      const int kind = a.hkind[w];
      unsigned long long* v = reinterpret_cast<unsigned long long*>(
          a.vals + (long long)gid * a.W);
      const unsigned long long* c = reinterpret_cast<const unsigned long long*>(
          cache + (long long)e * H);
      add_hot(v + w, kind, c[w], kind == K_ADD128 ? c[w + 1] : 0ULL);
    }
  }
  // the next launch's starting group count, by the last block
  if (last_block(a) && threadIdx.x == 0)
    a.words[2 * a.nf + HA_W_G0] = (long long)*a.ngroups;
}

// Does row r bring channel j (a float64 sum) a value for the fallback?
__device__ __forceinline__ bool far_value(const HAArgs& a, int j,
                                          long long r) {
  if (a.cls[j] != C_FSUM || !ch_valid(a, j, r)) return false;
  const double x = static_cast<const double*>(a.data[j])[r];
  return fx_finite_nonzero(x) && !fx_in_range(x, a.words[a.nf + a.fq[j]]);
}

// After ha_update, per row: the value writes of the FIRST/LAST rows that
// won their word and, when the call's touched list is not empty, the
// fallback adds of its float64 sums at their group's per-call scale (the
// next call's ha_prepare, or hash_agg_fold, folds them).  A call with
// neither returns at once.

template <int NK>
__global__ void __launch_bounds__(HA_THREADS)
ha_rows(const __grid_constant__ HAArgs a) {
  const bool fb = a.nf > 0 && *fb_count(a) != 0ULL;
  if (!a.ordered && !fb) return;
  const int nkeys = NK > 0 ? NK : a.nkeys;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       r < a.n; r += stride) {
    long long gid;
    if (a.rgid != nullptr) {
      gid = a.rgid[r];
    } else {
      // only the fallback's adds: a row probes only if it has one
      if (a.active != nullptr && !a.active[r]) continue;
      bool far = false;
      for (int j = 0; !far && j < a.nch; ++j) far = far_value(a, j, r);
      if (!far) continue;
      long long w[NK > 0 ? NK : HA_MAX_KEYS], claimed;
      const int nulls = row_keys<NK>(a, r, w);
      gid = hm_find<false>(a, w, nulls, nkeys, LLONG_MAX, &claimed);
    }
    if (gid < 0) continue;
    long long* v = a.vals + gid * a.W;
    for (int j = 0; j < a.nch; ++j) {
      const int cls = a.cls[j];
      if ((cls != C_FIRST && cls != C_LAST && cls != C_FSUM)
          || !ch_valid(a, j, r))
        continue;
      if (cls == C_FSUM) {
        if (!fb || !far_value(a, j, r)) continue;
        unsigned long long* w =
            reinterpret_cast<unsigned long long*>(v + a.cold[j]);
        fx_add(w + 2, static_cast<const double*>(a.data[j])[r],
               fx_scale(w[1], a.n));
        continue;
      }
      const long long mine =
          cls == C_FIRST ? r : ((a.call << HA_CALL_SHIFT) | r);
      if (v[a.hot[j]] != mine) continue;
      v[a.cold[j]] = static_cast<const long long*>(a.data[j])[r];
      if (cls == C_FIRST) v[a.hot[j]] = HA_FILLED;
    }
  }
}

// Each group's query-scale pairs, and the last call's fallback words,
// into their float64 words, cleared.
__global__ void __launch_bounds__(HA_THREADS)
ha_fold(long long* __restrict__ vals, int W, int nf,
        const __grid_constant__ HAArgs a) {
  const long long G = (long long)*a.ngroups;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x; g < G;
       g += stride) {
    long long* v = vals + g * W;
    for (int j = 0; j < a.nch; ++j) {
      if (a.cls[j] != C_FSUM) continue;
      fb_fold(reinterpret_cast<unsigned long long*>(v + a.cold[j]),
              a.words[2 * nf + HA_W_FBROWS]);
      const long long sc = a.words[nf + a.fq[j]];
      unsigned long long* p =
          reinterpret_cast<unsigned long long*>(v + a.hot[j]);
      if (sc == 0 || (p[0] | p[1]) == 0ULL) continue;
      reinterpret_cast<double*>(v + a.cold[j])[0] +=
          fx_to_double(p[0], p[1], fx_scale_of(sc));
      p[0] = p[1] = 0ULL;
    }
  }
}

// Every gid's tuple into an empty table (no tuple repeats, so no compare).
__global__ void __launch_bounds__(HA_THREADS)
hm_reinsert_k(long long* recs, int stride, long long cap, long long* meta,
              int nkeys, int collide,
              const unsigned long long* __restrict__ ngroups) {
  const int M = 2 + nkeys;
  const long long G = (long long)*ngroups;
  const long long mask = cap - 1;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x; g < G;
       g += step) {
    long long* m = meta + g * M;
    const int nulls = (int)m[1];
    long long slot = collide ? 0 : (long long)(
        hash_tuple(m + 2, nulls, nkeys) & mask);
    while (atomicCAS(hm_tag(recs, stride, slot), HM_EMPTY, HM_BUSY)
           != HM_EMPTY)
      slot = (slot + 1) & mask;
    long long* rec = recs + slot * stride;
    reinterpret_cast<int*>(rec)[1] = nulls;
    for (int i = 0; i < nkeys; ++i) rec[1 + i] = m[2 + i];
    m[0] = slot;
    *hm_tag(recs, stride, slot) = (int)(HM_GID0 + g);
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

static cudaError_t grid_for(long long n, int* blocks, int per_sm) {
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const long long want = (n + HA_THREADS - 1) / HA_THREADS;
  const long long cap = (long long)sms * per_sm;
  *blocks = (int)(want < 1 ? 1 : (want < cap ? want : cap));
  return cudaSuccess;
}

static bool pow2(long long x) { return x > 0 && (x & (x - 1)) == 0; }

// The class of (op, float64 flag), -1 if none.
static int class_of(int op, int f64) {
  switch (op) {
    case OP_SUM: return f64 ? C_FSUM : C_ISUM;
    case OP_MIN: return f64 ? C_FMIN : C_IMIN;
    case OP_MAX: return f64 ? C_FMAX : C_IMAX;
    case OP_COUNT: return C_COUNT;
    case OP_FIRST: return C_FIRST;
    case OP_LAST: return C_LAST;
    default: return -1;
  }
}

template <int NK>
static void launch_rows(const HAArgs& a, int blocks, cudaStream_t st) {
  ha_rows<NK><<<blocks, HA_THREADS, 0, st>>>(a);
}

// Host entries, bound with ctypes; every pointer but the pointer arrays
// and the layout arrays points to device memory.  Each returns
// cudaGetLastError() after its launches (0 = launched).

// One batch into a table (the update, and the merge of partial buffers).
// keys: nkeys int64 word columns [n] and their valid masks; channels: nch
// contributions (data nullptr for a count) with valid masks, ops (0 sum,
// 1 min, 2 max, 3 count, 4 first, 5 last) and float64 flags; the value
// record: hot[nch] and cold[nch] word offsets (cold -1 where a channel has
// none), W words, H hot words, init a fresh record (host int64 [W]);
// the table: recs [cap, stride] (empty slots zero), meta [gids, 2 +
// nkeys], vals [gids, W] with room for every group after the call;
// ngroups the device group counter; words [2 nf + 4] int64, zero at the
// table's start and kept across its calls (nf float64 sums' largest |x|
// bits and scale words, the touched list's count, the next launch's
// starting group count, a ticket, the list's call's rows); rgid int32 [n]
// (nullptr unless a channel is FIRST or LAST); fbprev and fblist (nullptr
// when no channel is a float64 sum): the previous call's touched list,
// which this call folds, and int64 [n nf] for this call's (they may be
// one buffer); call: the call's number, from 1.
extern "C" int hash_agg_update(int nkeys, const void* const* words,
                               const void* const* kvalid, int nch,
                               const void* const* data,
                               const void* const* valid, const int* ops,
                               const int* f64, const int* hot,
                               const int* cold, int W, int H,
                               const long long* init, const void* active,
                               long long n, void* recs, int stride,
                               long long cap, int collide, void* meta,
                               void* vals, void* ngroups, void* fwords,
                               void* rgid, const void* fbprev,
                               void* fblist, long long call, void* stream) {
  if (nkeys < 1 || nkeys > HA_MAX_KEYS || nch < 0 || nch > HA_MAX_CH
      || !pow2(cap) || stride < 1 + nkeys || (stride & (stride - 1))
      || W < 0 || W > HA_MAX_W || H < 0 || H > HA_MAX_HOT || H > W
      || call < 1
      || call >= (1LL << 22) || n >= (1LL << HA_CALL_SHIFT)
      || n >= (1LL << 31) || fwords == nullptr)
    return (int)cudaErrorInvalidValue;
  HAArgs a = {};
  for (int i = 0; i < nkeys; ++i) {
    a.word[i] = static_cast<const long long*>(words[i]);
    a.kvalid[i] = static_cast<const uint8_t*>(kvalid[i]);
  }
  a.nkeys = nkeys;
  int hot_seen = 0;
  for (int j = 0; j < nch; ++j) {
    const int cls = class_of(ops[j], f64[j]);
    const int hw = cls == C_FSUM ? 2 : 1;
    const int cw = cls == C_FSUM ? 4 : (cls == C_FIRST || cls == C_LAST);
    if (cls < 0 || ((data[j] == nullptr) != (cls == C_COUNT))
        || hot[j] < 0 || hot[j] + hw > H || (cw > 0) != (cold[j] >= 0)
        || (cw > 0 && (cold[j] < H || cold[j] + cw > W)))
      return (int)cudaErrorInvalidValue;
    a.data[j] = data[j];
    a.valid[j] = static_cast<const uint8_t*>(valid[j]);
    a.cls[j] = cls;
    a.hot[j] = hot[j];
    a.cold[j] = cold[j];
    a.fq[j] = -1;
    const int kind = cls == C_FSUM ? K_ADD128
        : (cls == C_COUNT || cls == C_ISUM) ? K_ADD
        : (cls == C_IMAX || cls == C_FMAX || cls == C_LAST) ? K_MAX : K_MIN;
    a.hkind[hot[j]] = kind;
    if (cls == C_FSUM) {
      a.hkind[hot[j] + 1] = K_HI;
      a.fq[j] = a.nf++;
    }
    hot_seen += hw;
    a.ordered = a.ordered || cls == C_FIRST || cls == C_LAST;
  }
  if (hot_seen != H || (a.ordered && rgid == nullptr)
      || (a.nf > 0 && (fblist == nullptr || fbprev == nullptr)))
    return (int)cudaErrorInvalidValue;
  a.used = H;
  for (int j = 0; j < nch; ++j) {
    // a float64 sum's fallback pair is zeroed when first used, not here
    const int end = a.cls[j] == C_FSUM ? cold[j] + 2
        : (a.cls[j] == C_FIRST || a.cls[j] == C_LAST) ? cold[j] + 1 : 0;
    a.used = end > a.used ? end : a.used;
  }
  if ((W & 1) == 0) a.used += a.used & 1;  // whole 16-byte pairs
  a.nch = nch;
  a.W = W;
  a.H = H;
  a.active = static_cast<const uint8_t*>(active);
  a.n = n;
  a.call = call;
  a.collide = collide;
  a.recs = static_cast<long long*>(recs);
  a.stride = stride;
  a.cap = cap;
  a.meta = static_cast<long long*>(meta);
  a.vals = static_cast<long long*>(vals);
  for (int i = 0; i < W; ++i) a.init[i] = init[i];
  a.ngroups = static_cast<unsigned long long*>(ngroups);
  a.words = static_cast<long long*>(fwords);
  a.rgid = a.ordered ? static_cast<int*>(rgid) : nullptr;
  a.fblist = static_cast<long long*>(fblist);
  a.fbprev = static_cast<const long long*>(fbprev);
  // the cache: as many entries (a power of two, at most HA_CACHE_MAX) as
  // HA_CACHE_BYTES of shared memory hold
  const int entry = 8 * H + 4;
  int K = 0;
  if (H > 0)
    for (K = HA_CACHE_MAX; K > 0 && K * entry > HA_CACHE_BYTES; K >>= 1) {}
  a.K = K;
  if (n == 0) return (int)cudaSuccess;
  // HA_BLOCKS_PER_SM blocks an SM (tools/agg_bench.py)
  int blocks = 1;
  cudaError_t err = grid_for(n, &blocks, HA_BLOCKS_PER_SM);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.nf > 0) {
    int pblocks = 1;
    err = grid_for(n, &pblocks, 16);
    if (err != cudaSuccess) return (int)err;
    ha_prepare<<<pblocks, HA_THREADS, 0, st>>>(a);
  }
  const size_t smem = (size_t)K * entry;
  if (nkeys == 1)
    ha_update<1><<<blocks, HA_THREADS, smem, st>>>(a);
  else if (nkeys == 2)
    ha_update<2><<<blocks, HA_THREADS, smem, st>>>(a);
  else
    ha_update<0><<<blocks, HA_THREADS, smem, st>>>(a);
  if (!a.ordered && a.nf == 0) return (int)cudaGetLastError();
  err = grid_for(n, &blocks, 8);
  if (err != cudaSuccess) return (int)err;
  if (nkeys == 1)
    launch_rows<1>(a, blocks, st);
  else if (nkeys == 2)
    launch_rows<2>(a, blocks, st);
  else
    launch_rows<0>(a, blocks, st);
  return (int)cudaGetLastError();
}

// The float64 sums' query-scale pairs of every group into their float64
// words (the output's fold).  Channels and the record as hash_agg_update
// takes them; gbound bounds the groups (the grid).
extern "C" int hash_agg_fold(int nch, const int* ops, const int* f64,
                             const int* hot, const int* cold, void* vals,
                             int W, void* ngroups, void* fwords,
                             long long gbound, void* stream) {
  if (nch < 0 || nch > HA_MAX_CH || W < 0 || fwords == nullptr)
    return (int)cudaErrorInvalidValue;
  HAArgs a = {};
  for (int j = 0; j < nch; ++j) {
    const int cls = class_of(ops[j], f64[j]);
    if (cls < 0 || (cls == C_FSUM && (hot[j] < 0 || hot[j] + 2 > W
                                      || cold[j] < 0 || cold[j] + 4 > W)))
      return (int)cudaErrorInvalidValue;
    a.cls[j] = cls;
    a.hot[j] = hot[j];
    a.cold[j] = cold[j];
    a.fq[j] = cls == C_FSUM ? a.nf++ : -1;
  }
  a.nch = nch;
  a.ngroups = static_cast<unsigned long long*>(ngroups);
  a.words = static_cast<long long*>(fwords);
  if (a.nf == 0 || gbound <= 0) return (int)cudaSuccess;
  int blocks = 1;
  cudaError_t err = grid_for(gbound, &blocks, 8);
  if (err != cudaSuccess) return (int)err;
  ha_fold<<<blocks, HA_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(vals), W, a.nf, a);
  return (int)cudaGetLastError();
}

// Re-places every gid of a table into empty records of cap slots.
extern "C" int hash_agg_reinsert(int nkeys, void* recs, int stride,
                                 long long cap, int collide, void* meta,
                                 void* ngroups, long long gbound,
                                 void* stream) {
  if (nkeys < 1 || nkeys > HA_MAX_KEYS || !pow2(cap)
      || stride < 1 + nkeys || (stride & (stride - 1)))
    return (int)cudaErrorInvalidValue;
  if (gbound <= 0) return (int)cudaSuccess;
  int blocks = 1;
  cudaError_t err = grid_for(gbound, &blocks, 8);
  if (err != cudaSuccess) return (int)err;
  hm_reinsert_k<<<blocks, HA_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(recs), stride, cap,
      static_cast<long long*>(meta), nkeys, collide,
      static_cast<const unsigned long long*>(ngroups));
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
