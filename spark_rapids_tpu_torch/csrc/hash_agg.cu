// hash_agg: grouped aggregation into one open-addressing hash table that
// serves the whole input stream.
//
// Replaces: spark_rapids_tpu/ops/groupby.py:251 group_reduce (with :137
// group_sort_indices, :174 _segment_starts, :193 _reduce_segment) and the
// per-batch partials it leaves to plan/physical.py:2211 _merge_partials —
// the reference's sort-based grouped aggregation.  This is cuDF's design
// (a device hash table); the reference leaves output order unspecified.
//
// Keys are tuples of int64 words (integers, dates, booleans and dictionary
// codes as they are; floats as their order-preserving image, with -0.0 =
// +0.0 and one NaN) plus a null bit per key: a null is its own group and
// its word is taken as 0.  A slot holds a state word (empty, busy, ready),
// the key words (one column per key) and the null bits.  A row hashes its
// tuple, probes linearly, and either finds a ready slot whose whole tuple
// (null bits included) equals its own, or claims an empty slot with
// atomicCAS (empty -> busy), writes the tuple, and publishes it (release
// store of ready); a row that meets a busy slot waits for it (acquire
// loads), so no tuple is read half written.  Then the row adds into the
// slot's channels: int64 sums and counts with atomicAdd, int64 min/max
// with atomicMin/atomicMax, and float64 min/max as atomicMin/atomicMax over
// an int64 image that orders -0.0 below +0.0 and maps NaN to the winning
// end — the reference's segment_min/segment_max semantics (NaN
// propagates, min prefers -0.0, max +0.0) without a compare-and-swap loop;
// the caller decodes the image.  float64 sums are exact 128-bit fixed
// point per call (fixed128.cuh), so they are equal to the bit from run to
// run: the update pass takes each slot's largest |x|, ha_finish adds the
// scaled integers, ha_fold converts them into the float64 accumulator.
//
// FIRST and LAST (the reference's _reduce_segment first/last,
// ops/groupby.py:195; first_valid/last_valid are the same with the value's
// validity as the channel's mask): per slot an auxiliary int64 word picks
// the row, then the row writes its value.  FIRST: the word starts at
// INT64_MAX; each qualifying row atomicMin's its row number into it, and
// in ha_finish the row whose number the word holds writes the value and
// sets the word to INT64_MIN, "filled", which no later row can lower: the
// first batch with a qualifying row decides.  LAST: each qualifying row
// atomicMax's (call << 40 | row) into a word that starts at -1, and the
// row that holds the word in ha_finish writes the value: every call's last
// row overwrites the earlier ones.  No order-dependent write decides a
// value.  The words move with their slots on a rehash.
//
// Entry points:
//   hash_agg_update  one batch into the table (ha_update, then ha_finish
//                    and ha_fold where the channels need them); adds the
//                    number of groups it created to a device counter (one
//                    atomic per block), so the host can read the exact
//                    group count when it needs to, and never per batch;
//   hash_agg_merge   partial aggregation buffers into a merge table with
//                    their merge ops (plan/physical.py:2296 _merge_fn, which
//                    re-reduces concatenated partials with group_reduce):
//                    the buffer column is the channel's data and its
//                    validity the channel's mask, so a sum buffer (a sum's
//                    or a count's partials, int64 or float64 in exact fixed
//                    point) adds, a min or max buffer takes its extreme,
//                    and a FIRST or LAST buffer — (value, has) — picks the
//                    first or last partial row that had a qualifying row,
//                    in stream order (the call number orders the batches);
//                    a wide-decimal SUM's lanes are int64 sum buffers.  A
//                    count channel (data nullptr) is refused: partials of
//                    a count are summed.  The merge table's layout is its
//                    own (below);
//   hash_agg_rehash  every ready slot of a table into a larger one, with its
//                    channel values and auxiliary words: the table grows
//                    only when the host's upper bound on the groups could
//                    pass the load limit.
// The live slots are compacted into output columns by csrc/compact.cu
// (state == ready is the mask) after the one fetch of the group count.
//
// The merge table (hash_agg_merge, hash_agg_reinsert).  A
// final aggregate merges one table per exchange batch or re-partition
// bucket, so the table is kept across them (ops/groupby.py MergePool) and
// sized by its rows (load <= 0.5), and each group gets a dense id from
// the device group counter when its slot is claimed (one atomic per warp
// of claimers).  A slot is one record of `stride` int64 words (a power of
// two): word 0 holds the tag in its low half (0 empty, 1 busy, 2 + gid
// ready) and the null bits in its high half, words 1..nkeys the key
// words, so a probe reads one or two sectors.  Per gid a value record of W
// words holds every channel's words (accumulator; FIRST/LAST word; the
// three fixed-point words of a float64 sum), written from `init` by the
// claimer, with its own row's contribution, before it publishes the slot
// (so nothing is filled per call, and a group's first row takes no
// atomic); and a meta record (slot, null bits, key words) gives the
// output its keys in gid order.  Probes read tags relaxed and fence only
// to read another thread's record.  The fixed-point fold and the output
// run over the ngroups gids, not the slots; the count is read on the
// device.  A released table's slot records are zeroed by the caller (a
// memset of the table's own slots: at load <= 0.5 that writes fewer
// sectors than clearing its claimed slots one by one);
// hash_agg_reinsert re-places every gid's slot when a table grows.
//
// Bound: device memory.  Per row: its key words, contributions and masks
// (read once), and one random slot (a 32-byte sector of the state, of each
// key column and of each channel, read and written); collisions add probe
// steps.  A `collide` flag sends every key to one bucket, which tests
// linear probing and the busy wait.

#include <cooperative_groups.h>
#include <cuda/atomic>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "fixed128.cuh"

#define HA_THREADS 256
#define HA_MAX_KEYS 8
#define HA_MAX_CH 32

#define HA_EMPTY 0
#define HA_BUSY 1
#define HA_READY 2

#define OP_SUM 0
#define OP_MIN 1
#define OP_MAX 2
#define OP_COUNT 3
#define OP_FIRST 4
#define OP_LAST 5

#define HA_FILLED LLONG_MIN  // a FIRST word whose value is written
#define HA_CALL_SHIFT 40     // LAST words: call << 40 | row

struct HAKeys {
  const long long* word[HA_MAX_KEYS];
  const uint8_t* valid[HA_MAX_KEYS];  // nullptr: no nulls
  int nkeys;
};

struct HAChannels {
  const void* data[HA_MAX_CH];        // nullptr for a count
  const uint8_t* valid[HA_MAX_CH];    // nullptr: every live row
  void* acc[HA_MAX_CH];   // int64, or double for a float64 sum; FIRST and
                          // LAST: the value's 8-byte words
  long long* aux[HA_MAX_CH];            // FIRST/LAST row words [cap]
  unsigned long long* fx[HA_MAX_CH];    // float64 sums: [cap][3] words
  int op[HA_MAX_CH];
  int f64[HA_MAX_CH];
  int nch;
  long long rows;    // the call's row count (fixed-point headroom)
  long long call;    // the call's number, from 1 (LAST words)
};

struct HATable {
  int* state;         // [cap]
  long long* keys;    // [nkeys, cap]
  int* nulls;         // [cap] null bits of the tuple
  long long cap;      // a power of two
};

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

// The slot of the tuple (w, nulls): found, or claimed and written; *fresh
// tells which.
__device__ long long find_or_claim(const HATable& t, const long long* w,
                                   int nulls, int nkeys, bool collide,
                                   bool* fresh) {
  const long long mask = t.cap - 1;
  long long slot =
      collide ? 0 : (long long)(hash_tuple(w, nulls, nkeys) & mask);
  *fresh = false;
  while (true) {
    cuda::atomic_ref<int, cuda::thread_scope_device> st(t.state[slot]);
    int s = st.load(cuda::std::memory_order_acquire);
    if (s == HA_EMPTY) {
      int expected = HA_EMPTY;
      if (st.compare_exchange_strong(expected, HA_BUSY,
                                     cuda::std::memory_order_acq_rel)) {
        for (int i = 0; i < nkeys; ++i) t.keys[i * t.cap + slot] = w[i];
        t.nulls[slot] = nulls;
        st.store(HA_READY, cuda::std::memory_order_release);
        *fresh = true;
        return slot;
      }
      s = expected;
    }
    while (s == HA_BUSY) s = st.load(cuda::std::memory_order_acquire);
    bool same = __ldcg(t.nulls + slot) == nulls;
    for (int i = 0; same && i < nkeys; ++i)
      same = __ldcg(t.keys + i * t.cap + slot) == w[i];
    if (same) return slot;
    slot = (slot + 1) & mask;
  }
}

// int64 image of a double, monotonic with -0.0 below +0.0; NaN maps to
// `nan_image` (INT64_MIN for a min, INT64_MAX for a max: NaN wins).
__device__ __forceinline__ long long f64_image(double x, long long nan_image) {
  if (x != x) return nan_image;
  const long long b = __double_as_longlong(x);
  return b >= 0 ? b : b ^ 0x7fffffffffffffffLL;
}

__global__ void __launch_bounds__(HA_THREADS)
ha_update(const __grid_constant__ HAKeys k,
          const __grid_constant__ HAChannels c, HATable t,
          const uint8_t* __restrict__ active, long long n, int collide,
          unsigned long long* __restrict__ ngroups,
          long long* __restrict__ rslot) {
  long long created = 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += stride) {
    if (active != nullptr && !active[r]) {
      if (rslot != nullptr) rslot[r] = -1;
      continue;
    }
    long long w[HA_MAX_KEYS];
    int nulls = 0;
    for (int i = 0; i < k.nkeys; ++i) {
      const bool ok = k.valid[i] == nullptr || k.valid[i][r];
      w[i] = ok ? k.word[i][r] : 0;
      if (!ok) nulls |= 1 << i;
    }
    bool fresh;
    const long long slot = find_or_claim(t, w, nulls, k.nkeys, collide != 0,
                                         &fresh);
    created += fresh;
    if (rslot != nullptr) rslot[r] = slot;
    for (int j = 0; j < c.nch; ++j) {
      if (c.valid[j] != nullptr && !c.valid[j][r]) continue;
      const int op = c.op[j];
      if (op == OP_COUNT) {
        atomicAdd(static_cast<unsigned long long*>(c.acc[j]) + slot, 1ULL);
      } else if (op == OP_FIRST) {
        long long* word = c.aux[j] + slot;
        if (*word > r) atomicMin(word, r);  // a filled word is INT64_MIN
      } else if (op == OP_LAST) {
        atomicMax(c.aux[j] + slot, (c.call << HA_CALL_SHIFT) | r);
      } else if (c.f64[j]) {
        const double x = static_cast<const double*>(c.data[j])[r];
        if (op == OP_SUM) {
          if (isfinite(x))
            fx_absmax(c.fx[j] + 3 * slot + 2, x);
          else  // inf and NaN sums do not depend on the order
            atomicAdd(static_cast<double*>(c.acc[j]) + slot, x);
        } else if (op == OP_MIN) {
          atomicMin(static_cast<long long*>(c.acc[j]) + slot,
                    f64_image(x, LLONG_MIN));
        } else {
          atomicMax(static_cast<long long*>(c.acc[j]) + slot,
                    f64_image(x, LLONG_MAX));
        }
      } else {
        const long long x = static_cast<const long long*>(c.data[j])[r];
        if (op == OP_SUM)
          atomicAdd(static_cast<unsigned long long*>(c.acc[j]) + slot,
                    (unsigned long long)x);
        else if (op == OP_MIN)
          atomicMin(static_cast<long long*>(c.acc[j]) + slot, x);
        else
          atomicMax(static_cast<long long*>(c.acc[j]) + slot, x);
      }
    }
  }
  for (int o = 16; o > 0; o >>= 1)
    created += __shfl_down_sync(0xffffffffu, created, o);
  __shared__ long long s_created[HA_THREADS / 32];
  if (threadIdx.x % 32 == 0) s_created[threadIdx.x / 32] = created;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < HA_THREADS / 32; ++w) created += s_created[w];
    if (created > 0) atomicAdd(ngroups, (unsigned long long)created);
  }
}

// After ha_update: per row, the fixed-point adds of its finite float64
// sums (every slot's largest |x| is known now) and the value writes of the
// FIRST/LAST rows that won their slot's word.
__global__ void __launch_bounds__(HA_THREADS)
ha_finish(const __grid_constant__ HAChannels c,
          const long long* __restrict__ rslot, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += stride) {
    const long long slot = rslot[r];
    if (slot < 0) continue;
    for (int j = 0; j < c.nch; ++j) {
      if (c.valid[j] != nullptr && !c.valid[j][r]) continue;
      const int op = c.op[j];
      if (op == OP_SUM && c.f64[j]) {
        const double x = static_cast<const double*>(c.data[j])[r];
        unsigned long long* w = c.fx[j] + 3 * slot;
        if (isfinite(x)) fx_add(w, x, fx_scale(w[2], c.rows));
      } else if (op == OP_FIRST || op == OP_LAST) {
        long long* word = c.aux[j] + slot;
        const long long mine =
            op == OP_FIRST ? r : ((c.call << HA_CALL_SHIFT) | r);
        if (*word != mine) continue;
        static_cast<long long*>(c.acc[j])[slot] =
            static_cast<const long long*>(c.data[j])[r];
        if (op == OP_FIRST) *word = HA_FILLED;
      }
    }
  }
}

// Each slot's fixed-point float64 sums of this call into its accumulator;
// the words cleared for the next call.
__global__ void __launch_bounds__(HA_THREADS)
ha_fold(const __grid_constant__ HAChannels c, long long cap) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (int j = 0; j < c.nch; ++j) {
    if (c.op[j] != OP_SUM || !c.f64[j]) continue;
    for (long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         s < cap; s += stride) {
      unsigned long long* w = c.fx[j] + 3 * s;
      if (w[2] == 0ULL) continue;
      static_cast<double*>(c.acc[j])[s] += fx_value(w, c.rows);
      w[0] = w[1] = w[2] = 0ULL;
    }
  }
}

// Channel values and auxiliary words move as 8-byte words (int64 and
// double alike).
__global__ void __launch_bounds__(HA_THREADS)
ha_rehash(HATable from, HATable to, int nkeys, int nch,
          const __grid_constant__ HAChannels old_acc,
          const __grid_constant__ HAChannels new_acc, int collide) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       s < from.cap; s += stride) {
    if (from.state[s] != HA_READY) continue;
    long long w[HA_MAX_KEYS];
    for (int i = 0; i < nkeys; ++i) w[i] = from.keys[i * from.cap + s];
    bool fresh;
    const long long slot = find_or_claim(to, w, from.nulls[s], nkeys,
                                         collide != 0, &fresh);
    for (int j = 0; j < nch; ++j) {
      static_cast<long long*>(new_acc.acc[j])[slot] =
          static_cast<const long long*>(old_acc.acc[j])[s];
      if (old_acc.aux[j] != nullptr) new_acc.aux[j][slot] = old_acc.aux[j][s];
    }
  }
}

// ---------------------------------------------------------------------------
// The merge table
// ---------------------------------------------------------------------------

#define HM_EMPTY 0
#define HM_BUSY 1
#define HM_GID0 2          // tag = HM_GID0 + gid once the slot is ready

struct HMChannels {
  const void* data[HA_MAX_CH];
  const uint8_t* valid[HA_MAX_CH];    // nullptr: every live row
  int op[HA_MAX_CH];
  int f64[HA_MAX_CH];
  int off[HA_MAX_CH];   // the channel's first word in a value record
  int nch;
  int W;                // words of a value record
  long long rows;       // the call's row count (fixed-point headroom)
  long long call;       // the call's number, from 1 (LAST words)
};

struct HMTable {
  long long* recs;          // [cap, stride] slot records
  int stride;               // words per slot record, a power of two
  long long cap;            // slots, a power of two
  long long* meta;          // [gids, 2 + nkeys]: slot, null bits, keys
  long long* vals;          // [gids, W] value records
  const long long* init;    // [W] a fresh value record
};

__device__ __forceinline__ int* hm_tag(const HMTable& t, long long slot) {
  return reinterpret_cast<int*>(t.recs + slot * t.stride);
}

// A dense gid for each calling thread: one atomic per group of threads
// that arrive together (cooperative_groups' coalesced group).
__device__ __forceinline__ long long hm_next_gid(
    unsigned long long* ngroups) {
  namespace cg = cooperative_groups;
  cg::coalesced_group g = cg::coalesced_threads();
  unsigned long long base = 0;
  if (g.thread_rank() == 0) base = atomicAdd(ngroups, (unsigned long long)g.size());
  return (long long)(g.shfl(base, 0) + g.thread_rank());
}

// The gid of the tuple (w, nulls): found (*fresh false), or claimed
// (*fresh true): a fresh gid and its meta record are written and the slot
// is left busy, for the caller to write the value record and publish
// (hm_publish).  Probes load the tag relaxed; only a thread that must read
// another thread's record takes an acquire fence first.
__device__ __forceinline__ long long hm_find_or_claim(
    const HMTable& t, const long long* w, int nulls, int nkeys, bool collide,
    unsigned long long* ngroups, long long* claimed) {
  const int M = 2 + nkeys;
  const long long mask = t.cap - 1;
  long long slot =
      collide ? 0 : (long long)(hash_tuple(w, nulls, nkeys) & mask);
  while (true) {
    long long* rec = t.recs + slot * t.stride;
    cuda::atomic_ref<int, cuda::thread_scope_device> tag(*hm_tag(t, slot));
    int s = tag.load(cuda::std::memory_order_relaxed);
    if (s == HM_EMPTY) {
      int expected = HM_EMPTY;
      if (tag.compare_exchange_strong(expected, HM_BUSY,
                                      cuda::std::memory_order_relaxed)) {
        const long long gid = hm_next_gid(ngroups);
        reinterpret_cast<int*>(rec)[1] = nulls;
        long long* meta = t.meta + gid * M;
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
    if (same) {
      *claimed = -1;
      return (long long)(s - HM_GID0);
    }
    slot = (slot + 1) & mask;
  }
}

// Makes a claimed slot's records visible: a release store of its gid.
__device__ __forceinline__ void hm_publish(const HMTable& t, long long slot,
                                           long long gid) {
  cuda::atomic_ref<int, cuda::thread_scope_device> tag(*hm_tag(t, slot));
  tag.store((int)(HM_GID0 + gid), cuda::std::memory_order_release);
}

// Row r's contribution to channel j: the claimer of a group writes it into
// the group's fresh value record with plain stores before it publishes the
// slot (no other thread can see the record yet); every later row uses
// atomics.  The float64 sums' fixed-point adds and the FIRST/LAST value
// writes follow in hm_finish_k.
__device__ __forceinline__ void hm_contribute(const HMChannels& c, int j,
                                              long long r, long long* a,
                                              bool fresh) {
  const int op = c.op[j];
  if (op == OP_FIRST) {
    if (fresh) a[1] = r;
    else if (a[1] > r) atomicMin(a + 1, r);  // a filled word is INT64_MIN
  } else if (op == OP_LAST) {
    const long long word = (c.call << HA_CALL_SHIFT) | r;
    if (fresh) a[1] = word;
    else atomicMax(a + 1, word);
  } else if (c.f64[j]) {
    const double x = static_cast<const double*>(c.data[j])[r];
    if (op == OP_SUM) {
      unsigned long long* m = reinterpret_cast<unsigned long long*>(a) + 3;
      if (isfinite(x)) {
        if (!fresh) fx_absmax(m, x);
        else if (x != 0.0) *m = (unsigned long long)__double_as_longlong(fabs(x));
      } else if (fresh) {   // inf and NaN sums do not depend on the order
        reinterpret_cast<double*>(a)[0] += x;
      } else {
        atomicAdd(reinterpret_cast<double*>(a), x);
      }
    } else {
      const long long img = f64_image(x, op == OP_MIN ? LLONG_MIN : LLONG_MAX);
      if (fresh) a[0] = op == OP_MIN ? (img < a[0] ? img : a[0])
                                     : (img > a[0] ? img : a[0]);
      else if (op == OP_MIN) atomicMin(a, img);
      else atomicMax(a, img);
    }
  } else {
    const long long x = static_cast<const long long*>(c.data[j])[r];
    if (fresh) {
      if (op == OP_SUM) a[0] = (long long)((unsigned long long)a[0] + (unsigned long long)x);
      else if (op == OP_MIN) a[0] = x < a[0] ? x : a[0];
      else a[0] = x > a[0] ? x : a[0];
    } else if (op == OP_SUM) {
      atomicAdd(reinterpret_cast<unsigned long long*>(a),
                (unsigned long long)x);
    } else if (op == OP_MIN) {
      atomicMin(a, x);
    } else {
      atomicMax(a, x);
    }
  }
}

// NK > 0: a table of NK keys, whose words stay in registers (the common
// one-key case); NK == 0: any number, k.nkeys.
template <int NK>
__global__ void __launch_bounds__(HA_THREADS)
hm_merge_k(const __grid_constant__ HAKeys k,
           const __grid_constant__ HMChannels c, HMTable t,
           const uint8_t* __restrict__ active, long long n, int collide,
           unsigned long long* __restrict__ ngroups,
           int* __restrict__ rgid) {
  const int nkeys = NK > 0 ? NK : k.nkeys;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += stride) {
    if (active != nullptr && !active[r]) {
      if (rgid != nullptr) rgid[r] = -1;
      continue;
    }
    long long w[NK > 0 ? NK : HA_MAX_KEYS];
    int nulls = 0;
    for (int i = 0; i < nkeys; ++i) {
      const bool ok = k.valid[i] == nullptr || k.valid[i][r];
      w[i] = ok ? k.word[i][r] : 0;
      if (!ok) nulls |= 1 << i;
    }
    long long claimed;
    const long long gid = hm_find_or_claim(t, w, nulls, nkeys,
                                           collide != 0, ngroups, &claimed);
    if (rgid != nullptr) rgid[r] = (int)gid;
    long long* v = t.vals + gid * c.W;
    const bool fresh = claimed >= 0;
    if (fresh)
      for (int j = 0; j < c.W; ++j) v[j] = t.init[j];
    for (int j = 0; j < c.nch; ++j) {
      if (c.valid[j] != nullptr && !c.valid[j][r]) continue;
      hm_contribute(c, j, r, v + c.off[j], fresh);
    }
    if (fresh) hm_publish(t, claimed, gid);
  }
}

// After hm_merge_k: per row, the fixed-point adds of its finite float64
// sums and the value writes of the FIRST/LAST rows that won their word.
__global__ void __launch_bounds__(HA_THREADS)
hm_finish_k(const __grid_constant__ HMChannels c, long long* __restrict__ vals,
            const int* __restrict__ rgid, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += stride) {
    const int gid = rgid[r];
    if (gid < 0) continue;
    long long* v = vals + (long long)gid * c.W;
    for (int j = 0; j < c.nch; ++j) {
      if (c.valid[j] != nullptr && !c.valid[j][r]) continue;
      const int op = c.op[j];
      long long* a = v + c.off[j];
      if (op == OP_SUM && c.f64[j]) {
        const double x = static_cast<const double*>(c.data[j])[r];
        unsigned long long* fw = reinterpret_cast<unsigned long long*>(a) + 1;
        if (isfinite(x)) fx_add(fw, x, fx_scale(fw[2], c.rows));
      } else if (op == OP_FIRST || op == OP_LAST) {
        const long long mine =
            op == OP_FIRST ? r : ((c.call << HA_CALL_SHIFT) | r);
        if (a[1] != mine) continue;
        a[0] = static_cast<const long long*>(c.data[j])[r];
        if (op == OP_FIRST) a[1] = HA_FILLED;
      }
    }
  }
}

// Each group's fixed-point float64 sums of this call into its accumulator;
// the words cleared for the next call.  Over the ngroups gids.
__global__ void __launch_bounds__(HA_THREADS)
hm_fold_k(const __grid_constant__ HMChannels c, long long* __restrict__ vals,
          const unsigned long long* __restrict__ ngroups) {
  const long long G = (long long)*ngroups;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x; g < G;
       g += stride) {
    long long* v = vals + g * c.W;
    for (int j = 0; j < c.nch; ++j) {
      if (c.op[j] != OP_SUM || !c.f64[j]) continue;
      unsigned long long* fw =
          reinterpret_cast<unsigned long long*>(v + c.off[j]) + 1;
      if (fw[2] == 0ULL) continue;
      reinterpret_cast<double*>(v + c.off[j])[0] += fx_value(fw, c.rows);
      fw[0] = fw[1] = fw[2] = 0ULL;
    }
  }
}

// Every gid's tuple into an empty table (no tuple repeats, so no compare).
__global__ void __launch_bounds__(HA_THREADS)
hm_reinsert_k(HMTable t, int nkeys, int collide,
              const unsigned long long* __restrict__ ngroups) {
  const int M = 2 + nkeys;
  const long long G = (long long)*ngroups;
  const long long mask = t.cap - 1;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x; g < G;
       g += step) {
    long long* meta = t.meta + g * M;
    const int nulls = (int)meta[1];
    long long slot = collide ? 0 : (long long)(
        hash_tuple(meta + 2, nulls, nkeys) & mask);
    while (true) {
      int expected = HM_EMPTY;
      if (atomicCAS(hm_tag(t, slot), expected, HM_BUSY) == HM_EMPTY) break;
      slot = (slot + 1) & mask;
    }
    long long* rec = t.recs + slot * t.stride;
    reinterpret_cast<int*>(rec)[1] = nulls;
    for (int i = 0; i < nkeys; ++i) rec[1 + i] = meta[2 + i];
    meta[0] = slot;
    *hm_tag(t, slot) = (int)(HM_GID0 + g);
  }
}

static cudaError_t grid_for(long long n, int* blocks, int per_sm) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long want = (n + HA_THREADS - 1) / HA_THREADS;
  const long long cap = (long long)sms * per_sm;
  *blocks = (int)(want < 1 ? 1 : (want < cap ? want : cap));
  return cudaSuccess;
}

static bool pow2(long long x) { return x > 0 && (x & (x - 1)) == 0; }

// Host entries, bound with ctypes; every pointer but the pointer arrays
// points to device memory.  Each returns cudaGetLastError() after its
// launch (0 = launched).

// keys: nkeys int64 word columns [n] and their valid masks; channels: nch
// contributions (data nullptr for a count) with valid masks, ops (0 sum,
// 1 min, 2 max, 3 count, 4 first, 5 last) and float64 flags, their [cap]
// accumulators, FIRST/LAST words aux (nullptr for the other ops) and the
// [cap][3] fixed-point words fx of float64 sums (zero between calls;
// nullptr for the other channels); the table: state, keys [nkeys, cap],
// nulls; ngroups: one device word the kernel adds to; rslot: int64 [n]
// scratch (nullptr when no channel is a float64 sum, FIRST or LAST); call:
// the call's number, from 1.
extern "C" int hash_agg_update(int nkeys, const void* const* words,
                               const void* const* kvalid, int nch,
                               const void* const* data,
                               const void* const* valid, const int* ops,
                               const int* f64, void* const* acc,
                               void* const* aux, void* const* fx,
                               const void* active, long long n, void* state,
                               void* tkeys, void* tnulls, long long cap,
                               int collide, void* ngroups, void* rslot,
                               long long call, void* stream) {
  if (nkeys < 1 || nkeys > HA_MAX_KEYS || nch < 0 || nch > HA_MAX_CH
      || !pow2(cap) || call < 1 || call >= (1LL << 22)
      || n >= (1LL << HA_CALL_SHIFT))
    return (int)cudaErrorInvalidValue;
  HAKeys k = {};
  for (int i = 0; i < nkeys; ++i) {
    k.word[i] = static_cast<const long long*>(words[i]);
    k.valid[i] = static_cast<const uint8_t*>(kvalid[i]);
  }
  k.nkeys = nkeys;
  HAChannels c = {};
  for (int j = 0; j < nch; ++j) {
    const bool ordered = ops[j] == OP_FIRST || ops[j] == OP_LAST;
    const bool fsum = ops[j] == OP_SUM && f64[j];
    if (ops[j] < OP_SUM || ops[j] > OP_LAST
        || ((data[j] == nullptr) != (ops[j] == OP_COUNT))
        || ((aux[j] == nullptr) == ordered) || ((fx[j] == nullptr) == fsum)
        || ((ordered || fsum) && rslot == nullptr))
      return (int)cudaErrorInvalidValue;
    c.data[j] = data[j];
    c.valid[j] = static_cast<const uint8_t*>(valid[j]);
    c.acc[j] = acc[j];
    c.aux[j] = static_cast<long long*>(aux[j]);
    c.fx[j] = static_cast<unsigned long long*>(fx[j]);
    c.op[j] = ops[j];
    c.f64[j] = f64[j];
  }
  c.nch = nch;
  c.rows = n;
  c.call = call;
  if (n == 0) return (int)cudaSuccess;
  HATable t = {static_cast<int*>(state), static_cast<long long*>(tkeys),
               static_cast<int*>(tnulls), cap};
  int blocks = 1;
  cudaError_t err = grid_for(n, &blocks, 8);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  long long* rs = static_cast<long long*>(rslot);
  ha_update<<<blocks, HA_THREADS, 0, st>>>(
      k, c, t, static_cast<const uint8_t*>(active), n, collide,
      static_cast<unsigned long long*>(ngroups), rs);
  if (rs == nullptr) return (int)cudaGetLastError();
  ha_finish<<<blocks, HA_THREADS, 0, st>>>(c, rs, n);
  bool fsum = false;
  for (int j = 0; j < nch; ++j) fsum = fsum || c.fx[j] != nullptr;
  if (fsum) {
    err = grid_for(cap, &blocks, 8);
    if (err != cudaSuccess) return (int)err;
    ha_fold<<<blocks, HA_THREADS, 0, st>>>(c, cap);
  }
  return (int)cudaGetLastError();
}

// Merge-table entries.  keys and channels as hash_agg_update's (every
// channel has data; ops 0 sum, 1 min, 2 max, 4 first, 5 last); offs: each
// channel's first word in a value record of W words, init: a fresh value
// record (device int64 [W]); the table: recs [cap, stride] (empty slots
// zero), meta [gbound, 2 + nkeys], vals [gbound, W], gbound the host's
// bound on the groups after this call (the fold's grid); ngroups: the
// device group counter; rgid: int32 [n] scratch (nullptr when no channel
// is a float64 sum, FIRST or LAST); call: the call's number, from 1.
extern "C" int hash_agg_merge(int nkeys, const void* const* words,
                              const void* const* kvalid, int nch,
                              const void* const* data,
                              const void* const* valid, const int* ops,
                              const int* f64, const int* offs, int W,
                              const void* init, const void* active,
                              long long n, void* recs, int stride,
                              long long cap, int collide, void* meta,
                              void* vals, long long gbound, void* ngroups,
                              void* rgid, long long call, void* stream) {
  if (nkeys < 1 || nkeys > HA_MAX_KEYS || nch < 0 || nch > HA_MAX_CH
      || !pow2(cap) || stride < 1 + nkeys || (stride & (stride - 1))
      || W < 0 || call < 1 || call >= (1LL << 22)
      || n >= (1LL << HA_CALL_SHIFT) || n >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  HAKeys k = {};
  for (int i = 0; i < nkeys; ++i) {
    k.word[i] = static_cast<const long long*>(words[i]);
    k.valid[i] = static_cast<const uint8_t*>(kvalid[i]);
  }
  k.nkeys = nkeys;
  HMChannels c = {};
  bool per_row = false, fsum = false;
  for (int j = 0; j < nch; ++j) {
    const bool ordered = ops[j] == OP_FIRST || ops[j] == OP_LAST;
    const int words_of = ordered ? 2 : (ops[j] == OP_SUM && f64[j]) ? 4 : 1;
    if (ops[j] < OP_SUM || ops[j] > OP_LAST || ops[j] == OP_COUNT
        || data[j] == nullptr || offs[j] < 0 || offs[j] + words_of > W)
      return (int)cudaErrorInvalidValue;
    c.data[j] = data[j];
    c.valid[j] = static_cast<const uint8_t*>(valid[j]);
    c.op[j] = ops[j];
    c.f64[j] = f64[j];
    c.off[j] = offs[j];
    per_row = per_row || ordered || (ops[j] == OP_SUM && f64[j]);
    fsum = fsum || (ops[j] == OP_SUM && f64[j]);
  }
  if (per_row && rgid == nullptr) return (int)cudaErrorInvalidValue;
  c.nch = nch;
  c.W = W;
  c.rows = n;
  c.call = call;
  if (n == 0) return (int)cudaSuccess;
  HMTable t = {static_cast<long long*>(recs), stride, cap,
               static_cast<long long*>(meta), static_cast<long long*>(vals),
               static_cast<const long long*>(init)};
  // two blocks an SM: the random slot probes and claims run faster with
  // fewer warps in flight than with a full SM (measured at Q18's shape)
  int blocks = 1;
  cudaError_t err = grid_for(n, &blocks, 2);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned long long* ng = static_cast<unsigned long long*>(ngroups);
  int* rg = per_row ? static_cast<int*>(rgid) : nullptr;
  if (nkeys == 1)
    hm_merge_k<1><<<blocks, HA_THREADS, 0, st>>>(
        k, c, t, static_cast<const uint8_t*>(active), n, collide, ng, rg);
  else
    hm_merge_k<0><<<blocks, HA_THREADS, 0, st>>>(
        k, c, t, static_cast<const uint8_t*>(active), n, collide, ng, rg);
  if (!per_row) return (int)cudaGetLastError();
  err = grid_for(n, &blocks, 8);
  if (err != cudaSuccess) return (int)err;
  hm_finish_k<<<blocks, HA_THREADS, 0, st>>>(c, t.vals, rg, n);
  if (fsum) {
    err = grid_for(gbound, &blocks, 8);
    if (err != cudaSuccess) return (int)err;
    hm_fold_k<<<blocks, HA_THREADS, 0, st>>>(c, t.vals, ng);
  }
  return (int)cudaGetLastError();
}

// Re-places every gid of a merge table into empty records of cap slots.
extern "C" int hash_agg_reinsert(int nkeys, void* recs, int stride,
                                 long long cap, int collide, void* meta,
                                 void* ngroups, long long gbound,
                                 void* stream) {
  if (nkeys < 1 || nkeys > HA_MAX_KEYS || !pow2(cap)
      || stride < 1 + nkeys || (stride & (stride - 1)))
    return (int)cudaErrorInvalidValue;
  if (gbound <= 0) return (int)cudaSuccess;
  HMTable t = {static_cast<long long*>(recs), stride, cap,
               static_cast<long long*>(meta), nullptr, nullptr};
  int blocks = 1;
  cudaError_t err = grid_for(gbound, &blocks, 8);
  if (err != cudaSuccess) return (int)err;
  hm_reinsert_k<<<blocks, HA_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      t, nkeys, collide, static_cast<const unsigned long long*>(ngroups));
  return (int)cudaGetLastError();
}

// old_*: the full table; new_*: an empty table of new_cap slots (state
// zeroed), accumulators at their identities.  acc and aux arrays hold nch
// pointers (aux: nullptr for a channel without words).
extern "C" int hash_agg_rehash(int nkeys, int nch, void* old_state,
                               void* old_keys, void* old_nulls,
                               long long old_cap,
                               void* const* old_acc, void* const* old_aux,
                               void* new_state, void* new_keys,
                               void* new_nulls, long long new_cap,
                               void* const* new_acc, void* const* new_aux,
                               int collide, void* stream) {
  if (nkeys < 1 || nkeys > HA_MAX_KEYS || nch < 0 || nch > HA_MAX_CH
      || !pow2(old_cap) || !pow2(new_cap) || new_cap < old_cap)
    return (int)cudaErrorInvalidValue;
  HATable from = {static_cast<int*>(old_state),
                  static_cast<long long*>(old_keys),
                  static_cast<int*>(old_nulls), old_cap};
  HATable to = {static_cast<int*>(new_state),
                static_cast<long long*>(new_keys),
                static_cast<int*>(new_nulls), new_cap};
  HAChannels o = {}, w = {};
  for (int j = 0; j < nch; ++j) {
    o.acc[j] = old_acc[j];
    w.acc[j] = new_acc[j];
    if ((old_aux[j] == nullptr) != (new_aux[j] == nullptr))
      return (int)cudaErrorInvalidValue;
    o.aux[j] = static_cast<long long*>(old_aux[j]);
    w.aux[j] = static_cast<long long*>(new_aux[j]);
  }
  o.nch = w.nch = nch;
  int blocks = 1;
  cudaError_t err = grid_for(old_cap, &blocks, 8);
  if (err != cudaSuccess) return (int)err;
  ha_rehash<<<blocks, HA_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      from, to, nkeys, nch, o, w, collide);
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
