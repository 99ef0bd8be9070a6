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
//   hash_agg_merge   partial aggregation buffers into the table with their
//                    merge ops (plan/physical.py:2296 _merge_fn, which
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
//                    a count are summed.  Same device passes as the update;
//   hash_agg_rehash  every ready slot of a table into a larger one, with its
//                    channel values and auxiliary words: the table grows
//                    only when the host's upper bound on the groups could
//                    pass the load limit.
// The live slots are compacted into output columns by csrc/compact.cu
// (state == ready is the mask) after the one fetch of the group count.
//
// Bound: device memory.  Per row: its key words, contributions and masks
// (read once), and one random slot (a 32-byte sector of the state, of each
// key column and of each channel, read and written); collisions add probe
// steps.  A `collide` flag sends every key to one bucket, which tests
// linear probing and the busy wait.

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

// The merge ops: 0 sum, 1 min, 2 max, 4 first, 5 last, over buffer
// columns (every channel has data); otherwise as hash_agg_update.
extern "C" int hash_agg_merge(int nkeys, const void* const* words,
                              const void* const* kvalid, int nch,
                              const void* const* data,
                              const void* const* valid, const int* ops,
                              const int* f64, void* const* acc,
                              void* const* aux, void* const* fx,
                              const void* active, long long n, void* state,
                              void* tkeys, void* tnulls, long long cap,
                              int collide, void* ngroups, void* rslot,
                              long long call, void* stream) {
  for (int j = 0; j < nch && j < HA_MAX_CH; ++j)
    if (ops[j] == OP_COUNT || data[j] == nullptr)
      return (int)cudaErrorInvalidValue;
  return hash_agg_update(nkeys, words, kvalid, nch, data, valid, ops, f64,
                         acc, aux, fx, active, n, state, tkeys, tnulls, cap,
                         collide, ngroups, rslot, call, stream);
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
