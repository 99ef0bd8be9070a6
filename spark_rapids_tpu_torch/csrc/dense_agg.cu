// dense_agg: the dense direct-address grouped aggregation — a primary
// integral key scattered into domain-sized accumulators, residual keys kept
// as claimed value words that prove they depend on the primary, and an
// overflow buffer for rows outside the domain.
//
// Replaces: spark_rapids_tpu/plan/physical.py:1321 _try_dense_grouped_multi
// (its stats program with the sampled functional-dependence probe, the
// per-batch update program and the violation check) and :1084
// _try_dense_grouped (the same with no residual keys).
//
// Entry points:
//   dense_agg_stats   per key column: min, max and count of the live, valid
//                     values (block reduction, one atomic per block); and
//                     per primary candidate, whether one of its values maps
//                     to two different key tuples among the live rows of
//                     the first 2^18 rows (the reference's sampled
//                     distinct(all keys) > distinct(candidate) test, made
//                     exact): an open-addressing table of row numbers per
//                     candidate, claimed with atomicCAS, where a row that
//                     finds its candidate value already claimed compares
//                     every key (validity included) with the claiming row.
//                     Both results come back in the caller's one fetch.
//   dense_agg_update  per live row: slot = key - kmin, or the null slot D
//                     for a null key.  In-domain rows mark the slot's
//                     presence byte and update the slot's record (below).
//                     Rows outside [kmin, kmin + D) go, through an atomic
//                     cursor, to a fixed-capacity overflow buffer with their
//                     key, residuals and contributions, and fold their key
//                     into device min/max words; the caller widens the
//                     domain once and replays the buffer through this same
//                     kernel.
//   dense_agg_check   over the present slots: a residual with both null and
//                     non-null rows, or two values, or a NaN, is a
//                     violation; also counts the present slots (n_groups)
//                     and folds each float64 sum's query-scale integer into
//                     its float64 word (below).
//
// The record.  Everything a live row writes at its slot lives in one record
// of R int64 words per slot, laid out by the caller (ops/groupby.py
// dense_layout) and passed in as word offsets:
//   * the state word (when there are residual keys), one value word per
//     residual and one word per int64 channel (sum, count, min, max);
//   * at an even word, per float64 sum, a pair [low, high]: the channel's
//     128-bit integer at the query's scale (below), where a row adds;
//   * on 32-byte sectors, per float64 sum, [per-call low, high, largest
//     |x| bits, float64 word]: the fallback below, and the float64 part of
//     the sum (per-call folds, infinities and NaN).
//   * R is 1 or 2 words when that is all (a record inside one sector), else
//     a multiple of 4 words, so every record starts on a sector.
// At TPC-H Q3's shape (a float64 sum, a count, two residuals) a live row
// touches two sectors of its record, where it touched eleven arrays
// before; at Q10's (a float64 sum, two residuals) also two.  The presence
// byte stays a dense byte array beside the records: the check and the
// output's compaction sweep every slot, and a byte a slot keeps that sweep
// 32 times smaller than reading one sector of every record.
//
// Residual proof.  A residual's value word starts at DA_EMPTY (INT64_MIN).
// A valid row's value (integers widened to int64; a float64 as its bits,
// with -0.0 taken as +0.0) claims the word with one atomicCAS from
// DA_EMPTY, or, when the word is claimed already, is compared with it: a
// claimed word never changes again, so a plain read that shows a claimed
// value is final and only a read that shows DA_EMPTY needs the CAS.  Every
// int64 bit pattern is a legal value, so a row whose value IS DA_EMPTY
// claims nothing and sets the SEEN_EMPTY bit of the state word instead.
// The state word holds, per residual i, NULL (a null row seen), SEEN_EMPTY
// and NEGZ (a -0.0 seen: the residual decodes to -0.0, the reference's
// scatter-min), and one CONFLICT bit: a value that differs from the claimed
// one, or a NaN.  Bits are set with one atomicOr per row, skipped when a
// plain read shows them set.  The check reports a violation for CONFLICT, a
// residual that is valid (a claimed word or SEEN_EMPTY) and NULL, or
// SEEN_EMPTY beside a claimed word.  Which of two conflicting values claims
// the word depends on timing; the query then leaves the dense path, and
// only the conflict itself is part of the result.
//
// float64 sums are deterministic: each is a sum of integers, which does
// not depend on the order (fixed128.cuh).  The query scale: the first call
// with a finite non-zero x takes its largest |x| (da_prepare, one atomic a
// block) and sets s = 73 - ilogb(max), kept for the query; a finite x with
// |x| 2^s in [2^52, 2^93) (2^-21 to 2^19 times that max) is an integer at
// that scale, so it is added once, at its row, exactly, as a 128-bit
// integer (two 64-bit atomics with a carry), which leaves room for 2^34
// rows a slot.  The lower bound is 2^52 because a smaller |x| 2^s has a
// fraction, which the add would truncate.  Every other finite x (the
// fallback: far below or above the first call's values) joins a per-call
// list, and takes the per-call per-slot scale of fixed128.cuh, exact down
// to about 2^-100 of the slot's largest |x| in the call: da_fb_absmax takes
// its slot's largest |x| and appends the slot to a touched list the first
// time its word leaves zero, da_fb_add adds it at that scale, and da_fold
// converts each touched slot's integer back and adds it to the record's
// float64 word (counts read on the device; a call whose values all lie in
// the query scale's range finds all three lists empty).  Infinities and NaN go to the float64 word with
// atomicAdd (their sums do not depend on the order).  The query tail's
// check (da_check, in stream order after the updates) adds each present
// slot's query-scale integer, converted back, to its float64 word and
// clears it, so the sum is that one word when the output reads it.  So a
// row does one random read-modify-write of its record a call, where the
// per-call scale took three (the largest |x|, the add, the fold) and a
// fold that swept the whole domain (15,003,037 slots at Q3, ~360 MB of
// sectors).  int64 sums wrap modulo 2^64 like the reference's.  Keys and
// integer residuals are int32 or int64 (dates are int32, dictionary codes
// of strings int32, booleans are promoted by the caller); float residuals
// are float64.
//
// Bound: device memory.  The update reads the live rows' columns (only the
// sectors that hold live rows); each live row then does a read-modify-write
// of its record's sectors and its presence byte, at a slot that is random
// in the domain.  The design keeps that to one pass over the record's
// sectors, computes the slot in the thread that reads the row, and writes
// no per-row intermediate.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "fixed128.cuh"

#define DA_THREADS 256
#define DA_MAX_KEYS 8
#define DA_MAX_RES (DA_MAX_KEYS - 1)
#define DA_MAX_CH 16
#define DA_SAMPLE (1 << 18)
#define DA_TABLE (1 << 19)

enum { OP_SUM = 0, OP_MIN = 1, OP_MAX = 2 };

__device__ __forceinline__ long long load_i(const void* p, int elem,
                                            long long r) {
  return elem == 8 ? static_cast<const long long*>(p)[r]
                   : (long long)static_cast<const int*>(p)[r];
}

__device__ __forceinline__ bool is_live(const uint8_t* active, long long r) {
  return active == nullptr || active[r];
}

// ---------------------------------------------------------------------------
// stats
// ---------------------------------------------------------------------------

struct DAKeys {
  const void* data[DA_MAX_KEYS];
  const uint8_t* valid[DA_MAX_KEYS];
  int elem[DA_MAX_KEYS];
  int cand[DA_MAX_KEYS];  // 1: a primary candidate (gets an FD table)
  int table[DA_MAX_KEYS]; // index of the candidate's table, -1 if none
  int nkeys;
};

// stats: [nkeys][3] = min, max, count; preset to INT64_MAX, INT64_MIN, 0.
__global__ void __launch_bounds__(DA_THREADS)
da_minmax(const __grid_constant__ DAKeys k, const uint8_t* __restrict__ active,
          long long n, long long* __restrict__ stats) {
  __shared__ long long s_lo[DA_THREADS / 32], s_hi[DA_THREADS / 32],
      s_cnt[DA_THREADS / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (int c = 0; c < k.nkeys; ++c) {
    long long lo = LLONG_MAX, hi = LLONG_MIN, cnt = 0;
    for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         r < n; r += stride) {
      if (!is_live(active, r)) continue;
      if (k.valid[c] != nullptr && !k.valid[c][r]) continue;
      const long long v = load_i(k.data[c], k.elem[c], r);
      lo = v < lo ? v : lo;
      hi = v > hi ? v : hi;
      ++cnt;
    }
    for (int o = 16; o > 0; o >>= 1) {
      const long long l2 = __shfl_down_sync(0xffffffffu, lo, o);
      const long long h2 = __shfl_down_sync(0xffffffffu, hi, o);
      lo = l2 < lo ? l2 : lo;
      hi = h2 > hi ? h2 : hi;
      cnt += __shfl_down_sync(0xffffffffu, cnt, o);
    }
    if (lane == 0) {
      s_lo[warp] = lo;
      s_hi[warp] = hi;
      s_cnt[warp] = cnt;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int w = 1; w < DA_THREADS / 32; ++w) {
        lo = s_lo[w] < lo ? s_lo[w] : lo;
        hi = s_hi[w] > hi ? s_hi[w] : hi;
        cnt += s_cnt[w];
      }
      if (cnt > 0) {
        atomicMin(stats + 3 * c, lo);
        atomicMax(stats + 3 * c + 1, hi);
        atomicAdd(reinterpret_cast<unsigned long long*>(stats + 3 * c + 2),
                  (unsigned long long)cnt);
      }
    }
    __syncthreads();
  }
}

__device__ __forceinline__ bool same_key(const DAKeys& k, int c, long long a,
                                         long long b) {
  const bool va = k.valid[c] == nullptr || k.valid[c][a];
  const bool vb = k.valid[c] == nullptr || k.valid[c][b];
  if (va != vb) return false;
  return !va || load_i(k.data[c], k.elem[c], a) ==
                    load_i(k.data[c], k.elem[c], b);
}

__device__ __forceinline__ unsigned int slot_hash(const DAKeys& k, int c,
                                                  long long r) {
  unsigned long long x =
      (k.valid[c] == nullptr || k.valid[c][r])
          ? (unsigned long long)load_i(k.data[c], k.elem[c], r)
          : 0x9e3779b97f4a7c15ULL;
  x ^= x >> 33;  // splitmix64's finalizer
  x *= 0xff51afd7ed558ccdULL;
  x ^= x >> 33;
  x *= 0xc4ceb9fe1a85ec53ULL;
  x ^= x >> 33;
  return (unsigned int)x & (DA_TABLE - 1);
}

// tables: [ntables][DA_TABLE] int32 preset to -1; fd: [nkeys] int32 preset
// to 0, set to 1 when a candidate value maps to two key tuples.
__global__ void __launch_bounds__(DA_THREADS)
da_fd(const __grid_constant__ DAKeys k, const uint8_t* __restrict__ active,
      long long n_sample, int* __restrict__ tables, int* __restrict__ fd) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       r < n_sample; r += stride) {
    if (!is_live(active, r)) continue;
    for (int c = 0; c < k.nkeys; ++c) {
      if (!k.cand[c]) continue;
      int* tab = tables + (long long)k.table[c] * DA_TABLE;
      unsigned int h = slot_hash(k, c, r);
      while (true) {
        const int prev = atomicCAS(tab + h, -1, (int)r);
        if (prev == -1) break;  // first row of this value: claimed
        if (same_key(k, c, prev, r)) {
          for (int o = 0; o < k.nkeys; ++o) {
            if (o != c && !same_key(k, o, prev, r)) {
              fd[c] = 1;
              break;
            }
          }
          break;
        }
        h = (h + 1) & (DA_TABLE - 1);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// update
// ---------------------------------------------------------------------------

namespace cg = cooperative_groups;

#define DA_EMPTY LLONG_MIN              // a residual word no row claimed
#define DA_CONFLICT (1ULL << 62)        // state: two values, or a NaN

__device__ __forceinline__ unsigned long long null_bit(int i) {
  return 1ULL << (3 * i);
}
__device__ __forceinline__ unsigned long long seen_empty_bit(int i) {
  return 1ULL << (3 * i + 1);
}
__device__ __forceinline__ unsigned long long negz_bit(int i) {
  return 1ULL << (3 * i + 2);
}

#define DA_NO_SCALE LLONG_MIN  // a float64 channel whose scale is not set
#define DA_FAST_LO 52          // |x| 2^s in [2^52, 2^93): the query scale
#define DA_FAST_HI 92
#define DA_SCALE_TOP 73        // s = 73 - ilogb(the first call's max |x|)

struct DAUpdate {
  const void* key;
  const uint8_t* key_valid;
  int key_elem;
  const void* res[DA_MAX_RES];
  const uint8_t* res_valid[DA_MAX_RES];
  int res_elem[DA_MAX_RES];
  int res_f64[DA_MAX_RES];  // 1: a float64 residual (its bits are claimed)
  int res_off[DA_MAX_RES];  // its value word in the record
  int nres;
  const void* ch[DA_MAX_CH];  // nullptr: a count channel (adds 1)
  const uint8_t* ch_valid[DA_MAX_CH];
  int ch_op[DA_MAX_CH];
  int ch_f64[DA_MAX_CH];
  int ch_off[DA_MAX_CH];  // its word (float64: its per-call sector)
  int ch_q[DA_MAX_CH];    // float64: its query-scale pair's first word
  int ch_fq[DA_MAX_CH];   // float64: its index among the float64 channels
  int fbase[DA_MAX_CH];   // per float64 index, its per-call sector's word
  int fch[DA_MAX_CH];     // per float64 index, its channel
  int nch;
  int nf;          // float64 channels
  long long rows;  // the call's row count (headroom of the per-call scale)
  // records over S = D + 1 slots (slot D: the null key)
  long long kmin;
  long long D;
  long long* rec;
  int R;
  int state_off;
  uint8_t* present;
  // per float64 index: [nf] max |x| bits, then [nf] query scales
  long long* fwords;
  // the call's lists: counts [fallback, touched], fallback (row * nf + q)
  // and touched (slot * nf + q) entries
  unsigned long long* counts;
  long long* fblist;
  long long* tlist;
  // overflow buffer (capacity rows); ocount / obounds are device words
  long long cap;
  unsigned long long* ocount;
  long long* obounds;  // [min, max] preset to INT64_MAX, INT64_MIN
  long long* okey;
  long long* ores[DA_MAX_RES];
  uint8_t* ores_valid[DA_MAX_RES];
  long long* och[DA_MAX_CH];  // 8-byte words (float64 bits or int64)
  uint8_t* och_valid[DA_MAX_CH];
};

__device__ __forceinline__ bool ch_live(const DAUpdate& a, int j,
                                        long long r) {
  return a.ch_valid[j] == nullptr || a.ch_valid[j][r];
}

__device__ __forceinline__ long long ch_bits(const DAUpdate& a, int j,
                                             long long r) {
  return a.ch[j] == nullptr ? 1LL
                            : static_cast<const long long*>(a.ch[j])[r];
}

__device__ void overflow(const DAUpdate& a, long long r, long long key) {
  atomicMin(a.obounds, key);
  atomicMax(a.obounds + 1, key);
  const unsigned long long pos = atomicAdd(a.ocount, 1ULL);
  if (pos >= (unsigned long long)a.cap) return;  // the caller raises
  a.okey[pos] = key;
  for (int i = 0; i < a.nres; ++i) {
    const bool v = a.res_valid[i] == nullptr || a.res_valid[i][r];
    a.ores[i][pos] = load_i(a.res[i], a.res_elem[i], r);
    a.ores_valid[i][pos] = v;
  }
  for (int j = 0; j < a.nch; ++j) {
    a.och_valid[j][pos] = ch_live(a, j, r);
    if (a.och[j] != nullptr) a.och[j][pos] = ch_bits(a, j, r);
  }
}

// The row's slot: key - kmin, or the null key's slot D; false for a key
// outside the domain (an overflow row).
__device__ __forceinline__ bool slot_of(const DAUpdate& a, long long r,
                                        long long* slot, long long* key) {
  *slot = a.D;
  if (a.key_valid == nullptr || a.key_valid[r]) {
    *key = load_i(a.key, a.key_elem, r);
    const unsigned long long d =
        (unsigned long long)*key - (unsigned long long)a.kmin;
    if (*key < a.kmin || d >= (unsigned long long)a.D) return false;
    *slot = (long long)d;
  }
  return true;
}

// Appends one entry to a list: the threads of the warp that get here
// together take their places with one atomic.
__device__ __forceinline__ void append(unsigned long long* count,
                                       long long* list, long long entry) {
  cg::coalesced_group g = cg::coalesced_threads();
  unsigned long long base = 0;
  if (g.thread_rank() == 0)
    base = atomicAdd(count, (unsigned long long)g.size());
  base = g.shfl(base, 0);
  list[base + g.thread_rank()] = entry;
}

__device__ __forceinline__ bool finite_nonzero(double x) {
  const double ax = fabs(x);
  return ax <= 1.7976931348623157e308 && ax != 0.0;
}

// Per float64 channel whose query scale is not set yet, the largest
// finite |x| of the call's live rows (one atomic a block).
__global__ void __launch_bounds__(DA_THREADS)
da_prepare(const __grid_constant__ DAUpdate a,
           const uint8_t* __restrict__ active, long long n) {
  __shared__ unsigned long long s_max[DA_THREADS / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (int q = 0; q < a.nf; ++q) {
    if (a.fwords[a.nf + q] != DA_NO_SCALE) continue;
    const int j = a.fch[q];
    unsigned long long m = 0;
    for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         r < n; r += stride) {
      if (!is_live(active, r) || !ch_live(a, j, r)) continue;
      const double x = static_cast<const double*>(a.ch[j])[r];
      if (!finite_nonzero(x)) continue;
      const unsigned long long b =
          (unsigned long long)__double_as_longlong(fabs(x));
      m = b > m ? b : m;
    }
    for (int o = 16; o > 0; o >>= 1) {
      const unsigned long long o2 = __shfl_down_sync(0xffffffffu, m, o);
      m = o2 > m ? o2 : m;
    }
    if (lane == 0) s_max[warp] = m;
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int w = 1; w < DA_THREADS / 32; ++w) m = s_max[w] > m ? s_max[w] : m;
      if (m) atomicMax(reinterpret_cast<unsigned long long*>(a.fwords + q), m);
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(DA_THREADS)
da_update(const __grid_constant__ DAUpdate a,
          const uint8_t* __restrict__ active, long long n) {
  // each float64 channel's query scale: set, or made now from the first
  // call's max |x| (every block makes the same one; block 0 keeps it)
  __shared__ int s_scale[DA_MAX_CH];
  if ((int)threadIdx.x < a.nf) {
    const int q = threadIdx.x;
    long long sc = a.fwords[a.nf + q];
    if (sc == DA_NO_SCALE && a.fwords[q] != 0) {
      sc = DA_SCALE_TOP - ilogb(__longlong_as_double(a.fwords[q]));
      if (blockIdx.x == 0) a.fwords[a.nf + q] = sc;
    }
    s_scale[q] = sc == DA_NO_SCALE ? INT_MIN : (int)sc;
  }
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += stride) {
    if (!is_live(active, r)) continue;
    long long slot, key;
    if (!slot_of(a, r, &slot, &key)) {
      overflow(a, r, key);
      continue;
    }
    if (!a.present[slot]) a.present[slot] = 1;
    long long* rec = a.rec + slot * a.R;
    for (int j = 0; j < a.nch; ++j) {
      if (!ch_live(a, j, r)) continue;
      if (a.ch_f64[j]) {
        const double x = static_cast<const double*>(a.ch[j])[r];
        if (!isfinite(x)) {  // inf and NaN sums do not depend on the order
          atomicAdd(reinterpret_cast<double*>(rec + a.ch_off[j]) + 3, x);
          continue;
        }
        if (x == 0.0) continue;
        const int q = a.ch_fq[j], sc = s_scale[q];
        const int e = sc == INT_MIN ? INT_MIN : ilogb(x) + sc;
        if (e >= DA_FAST_LO && e <= DA_FAST_HI)
          fx_add(reinterpret_cast<unsigned long long*>(rec + a.ch_q[j]), x,
                 sc);
        else
          append(a.counts, a.fblist, r * a.nf + q);
        continue;
      }
      const long long v = ch_bits(a, j, r);
      long long* acc = rec + a.ch_off[j];
      if (a.ch_op[j] == OP_SUM)
        atomicAdd(reinterpret_cast<unsigned long long*>(acc),
                  (unsigned long long)v);
      else if (a.ch_op[j] == OP_MIN) {
        if (v < *acc) atomicMin(acc, v);
      } else if (v > *acc) {
        atomicMax(acc, v);
      }
    }
    if (a.nres == 0) continue;
    unsigned long long* state =
        reinterpret_cast<unsigned long long*>(rec + a.state_off);
    const unsigned long long seen = *state;  // bits are only ever set
    unsigned long long set = 0;
    for (int i = 0; i < a.nres; ++i) {
      if (a.res_valid[i] != nullptr && !a.res_valid[i][r]) {
        set |= null_bit(i);
        continue;
      }
      long long v;
      if (a.res_f64[i]) {
        const double d = static_cast<const double*>(a.res[i])[r];
        if (d != d) {  // a NaN residual is a violation
          set |= DA_CONFLICT;
          continue;
        }
        v = d == 0.0 ? 0LL : __double_as_longlong(d);
        if (d == 0.0 && __double_as_longlong(d) != 0LL) set |= negz_bit(i);
      } else {
        v = load_i(a.res[i], a.res_elem[i], r);
      }
      if (v == DA_EMPTY) {
        set |= seen_empty_bit(i);
        continue;
      }
      long long* word = rec + a.res_off[i];
      long long claimed = *word;  // a claimed word never changes
      if (claimed == DA_EMPTY)
        claimed = (long long)atomicCAS(
            reinterpret_cast<unsigned long long*>(word),
            (unsigned long long)DA_EMPTY, (unsigned long long)v);
      if (claimed != DA_EMPTY && claimed != v) set |= DA_CONFLICT;
    }
    if (set & ~seen) atomicOr(state, set);
  }
}

// The fallback entries' slots' largest finite |x|; a slot whose word
// leaves zero joins the touched list.
__global__ void __launch_bounds__(DA_THREADS)
da_fb_absmax(const __grid_constant__ DAUpdate a) {
  const unsigned long long count = a.counts[0];
  const unsigned long long stride = (unsigned long long)gridDim.x * blockDim.x;
  for (unsigned long long e = (unsigned long long)blockIdx.x * blockDim.x +
                              threadIdx.x;
       e < count; e += stride) {
    const long long t = a.fblist[e], r = t / a.nf;
    const int q = (int)(t - r * a.nf);
    long long slot, key;
    slot_of(a, r, &slot, &key);
    const unsigned long long b = (unsigned long long)__double_as_longlong(
        fabs(static_cast<const double*>(a.ch[a.fch[q]])[r]));
    unsigned long long* m = reinterpret_cast<unsigned long long*>(
        a.rec + slot * a.R + a.fbase[q] + 2);
    if (b > *m && atomicMax(m, b) == 0ULL)
      append(a.counts + 1, a.tlist, slot * a.nf + q);
  }
}

// The fallback entries added at their slots' own scales.
__global__ void __launch_bounds__(DA_THREADS)
da_fb_add(const __grid_constant__ DAUpdate a) {
  const unsigned long long count = a.counts[0];
  const unsigned long long stride = (unsigned long long)gridDim.x * blockDim.x;
  for (unsigned long long e = (unsigned long long)blockIdx.x * blockDim.x +
                              threadIdx.x;
       e < count; e += stride) {
    const long long t = a.fblist[e], r = t / a.nf;
    const int q = (int)(t - r * a.nf);
    long long slot, key;
    slot_of(a, r, &slot, &key);
    unsigned long long* w = reinterpret_cast<unsigned long long*>(
        a.rec + slot * a.R + a.fbase[q]);
    fx_add(w, static_cast<const double*>(a.ch[a.fch[q]])[r],
           fx_scale(w[2], a.rows));
  }
}

// Each touched entry's per-call sum, back in float64, added to the
// record's float64 word; its words cleared for the next call.  Entries
// are distinct, so no two threads fold one sector.
__global__ void __launch_bounds__(DA_THREADS)
da_fold(const __grid_constant__ DAUpdate a) {
  const unsigned long long count = a.counts[1];
  const unsigned long long stride = (unsigned long long)gridDim.x * blockDim.x;
  for (unsigned long long e = (unsigned long long)blockIdx.x * blockDim.x +
                              threadIdx.x;
       e < count; e += stride) {
    const long long t = a.tlist[e];
    const long long s = t / a.nf;
    const int q = (int)(t - s * a.nf);
    unsigned long long* w = reinterpret_cast<unsigned long long*>(
        a.rec + s * a.R + a.fbase[q]);
    reinterpret_cast<double*>(w)[3] += fx_value(w, a.rows);
    w[0] = w[1] = w[2] = 0ULL;
  }
}

// ---------------------------------------------------------------------------
// violation check and group count
// ---------------------------------------------------------------------------

struct DACheck {
  long long* rec;
  int R;
  int state_off;
  int res_off[DA_MAX_RES];
  int nres;
  int q_off[DA_MAX_CH];    // per float64 index: its query-scale pair
  int acc_off[DA_MAX_CH];  // per float64 index: its float64 word
  int nf;
  const long long* fwords;  // as dense_agg_update keeps it
};

// out: [violation, n_groups], preset to 0.  Also folds each present slot's
// query-scale integers into their float64 words and clears them.
__global__ void __launch_bounds__(DA_THREADS)
da_check(const __grid_constant__ DACheck c,
         const uint8_t* __restrict__ present, long long S,
         long long* __restrict__ out) {
  long long bad = 0, groups = 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x; s < S;
       s += stride) {
    if (!present[s]) continue;
    ++groups;
    long long* rec = c.rec + s * c.R;
    for (int q = 0; q < c.nf; ++q) {
      const long long sc = c.fwords[c.nf + q];
      unsigned long long* p =
          reinterpret_cast<unsigned long long*>(rec + c.q_off[q]);
      if (sc == DA_NO_SCALE || (p[0] | p[1]) == 0ULL) continue;
      reinterpret_cast<double*>(rec + c.acc_off[q])[0] +=
          fx_to_double(p[0], p[1], (int)sc);
      p[0] = p[1] = 0ULL;
    }
    if (c.nres == 0) continue;
    const unsigned long long st = (unsigned long long)rec[c.state_off];
    if (st & DA_CONFLICT) bad = 1;
    for (int i = 0; i < c.nres; ++i) {
      const bool empty_seen = (st & seen_empty_bit(i)) != 0;
      const bool claimed = rec[c.res_off[i]] != DA_EMPTY;
      if ((empty_seen && claimed) ||
          ((empty_seen || claimed) && (st & null_bit(i))))
        bad = 1;
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    bad |= __shfl_down_sync(0xffffffffu, bad, o);
    groups += __shfl_down_sync(0xffffffffu, groups, o);
  }
  __shared__ long long s_bad[DA_THREADS / 32], s_groups[DA_THREADS / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    s_bad[warp] = bad;
    s_groups[warp] = groups;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < DA_THREADS / 32; ++w) {
      bad |= s_bad[w];
      groups += s_groups[w];
    }
    if (bad) atomicMax(out, 1LL);
    if (groups)
      atomicAdd(reinterpret_cast<unsigned long long*>(out + 1),
                (unsigned long long)groups);
  }
}

// ---------------------------------------------------------------------------
// host entries (ctypes); pointer arrays are host arrays of device pointers
// ---------------------------------------------------------------------------

static cudaError_t grid_for(long long n, int per_sm, int* blocks) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long want = (n + DA_THREADS - 1) / DA_THREADS;
  const long long cap = (long long)sms * per_sm;
  *blocks = (int)(want < 1 ? 1 : (want < cap ? want : cap));
  return cudaSuccess;
}

static bool elem_ok(int e) { return e == 4 || e == 8; }

// cand[c] != 0 marks a primary candidate; each gets one table of DA_TABLE
// int32 words in `tables`, in key order.  stats: [nkeys][3] int64, fd:
// [nkeys] int32.
extern "C" int dense_agg_stats(int nkeys, const void* const* data,
                               const void* const* valid, const int* elems,
                               const int* cand, const void* active,
                               long long n, void* stats, void* tables,
                               void* fd, void* stream) {
  if (nkeys < 1 || nkeys > DA_MAX_KEYS) return (int)cudaErrorInvalidValue;
  DAKeys k = {};
  int ntables = 0;
  for (int c = 0; c < nkeys; ++c) {
    if (!elem_ok(elems[c])) return (int)cudaErrorInvalidValue;
    k.data[c] = data[c];
    k.valid[c] = static_cast<const uint8_t*>(valid[c]);
    k.elem[c] = elems[c];
    k.cand[c] = cand[c] != 0;
    k.table[c] = k.cand[c] ? ntables++ : -1;
  }
  k.nkeys = nkeys;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* act = static_cast<const uint8_t*>(active);
  int blocks = 1;
  cudaError_t err = grid_for(n, 8, &blocks);
  if (err != cudaSuccess) return (int)err;
  da_minmax<<<blocks, DA_THREADS, 0, s>>>(k, act, n,
                                          static_cast<long long*>(stats));
  err = cudaGetLastError();
  if (err != cudaSuccess || ntables == 0) return (int)err;
  const long long n_sample = n < DA_SAMPLE ? n : DA_SAMPLE;
  err = grid_for(n_sample, 4, &blocks);
  if (err != cudaSuccess) return (int)err;
  da_fd<<<blocks, DA_THREADS, 0, s>>>(k, act, n_sample,
                                      static_cast<int*>(tables),
                                      static_cast<int*>(fd));
  return (int)cudaGetLastError();
}

static bool word_ok(int off, int R) { return off >= 0 && off < R; }

// Inputs: the primary key, nres residual columns (res_f64[i]: float64,
// else integers of res_elem[i] bytes), nch contribution channels (ch[j]
// nullptr = a count; ops 0 sum, 1 min, 2 max; ch_f64[j] = float64 sum).
// Records: rec [S][R] int64 (S = D + 1), laid out by the caller: res_off
// [nres] and ch_off [nch] word offsets (a float64 channel's offset is its
// per-call sector [low, high, largest |x|, float64 word], on a multiple of
// 4 with R one too), ch_q [nch] a float64 channel's query-scale pair (an
// even word), state_off the state word; present [S].  fwords: [nf] max |x|
// bits preset to 0, then [nf] scales preset to DA_NO_SCALE, kept across
// calls.  work: 2 + 2 n nf int64 words (the two counts, the fallback and
// touched lists).  Overflow: okey [cap], ores/ores_valid [nres][cap], och
// (nullptr for counts) and och_valid [nch][cap], ocount and obounds device
// words.  The per-call sectors' first three words are zero between calls.
extern "C" int dense_agg_update(
    const void* key, const void* key_valid, int key_elem, int nres,
    const void* const* res, const void* const* res_valid,
    const int* res_elem, const int* res_f64, const int* res_off, int nch,
    const void* const* ch, const void* const* ch_valid, const int* ch_op,
    const int* ch_f64, const int* ch_off, const int* ch_q,
    const void* active, long long n, long long kmin, long long D, void* rec,
    int R, int state_off, void* present, long long cap, void* ocount,
    void* obounds, void* okey, void* const* ores, void* const* ores_valid,
    void* const* och, void* const* och_valid, void* fwords, void* work,
    void* stream) {
  if (!elem_ok(key_elem) || nres < 0 || nres > DA_MAX_RES || nch < 0 ||
      nch > DA_MAX_CH || D < 1 || cap < 0 || R < 1 ||
      (nres > 0 && !word_ok(state_off, R)))
    return (int)cudaErrorInvalidValue;
  DAUpdate a = {};
  a.key = key;
  a.key_valid = static_cast<const uint8_t*>(key_valid);
  a.key_elem = key_elem;
  for (int i = 0; i < nres; ++i) {
    if (!elem_ok(res_elem[i]) || (res_f64[i] && res_elem[i] != 8) ||
        !word_ok(res_off[i], R))
      return (int)cudaErrorInvalidValue;
    a.res[i] = res[i];
    a.res_valid[i] = static_cast<const uint8_t*>(res_valid[i]);
    a.res_elem[i] = res_elem[i];
    a.res_f64[i] = res_f64[i] != 0;
    a.res_off[i] = res_off[i];
    a.ores[i] = static_cast<long long*>(ores[i]);
    a.ores_valid[i] = static_cast<uint8_t*>(ores_valid[i]);
  }
  a.nres = nres;
  for (int j = 0; j < nch; ++j) {
    if (ch_op[j] < OP_SUM || ch_op[j] > OP_MAX ||
        (ch_f64[j] && (ch_op[j] != OP_SUM || ch[j] == nullptr ||
                       ch_off[j] % 4 != 0 || R % 4 != 0 ||
                       ch_off[j] + 4 > R || ch_q[j] % 2 != 0 ||
                       !word_ok(ch_q[j] + 1, R))) ||
        !word_ok(ch_off[j], R))
      return (int)cudaErrorInvalidValue;
    a.ch[j] = ch[j];
    a.ch_valid[j] = static_cast<const uint8_t*>(ch_valid[j]);
    a.ch_op[j] = ch_op[j];
    a.ch_f64[j] = ch_f64[j] != 0;
    a.ch_off[j] = ch_off[j];
    a.ch_q[j] = ch_q[j];
    a.ch_fq[j] = -1;
    if (a.ch_f64[j]) {
      a.fbase[a.nf] = ch_off[j];
      a.fch[a.nf] = j;
      a.ch_fq[j] = a.nf++;
    }
    a.och[j] = static_cast<long long*>(och[j]);
    a.och_valid[j] = static_cast<uint8_t*>(och_valid[j]);
  }
  a.nch = nch;
  if (a.nf > 0 && (fwords == nullptr || work == nullptr))
    return (int)cudaErrorInvalidValue;
  a.rows = n;
  a.kmin = kmin;
  a.D = D;
  a.rec = static_cast<long long*>(rec);
  a.R = R;
  a.state_off = state_off;
  a.present = static_cast<uint8_t*>(present);
  a.fwords = static_cast<long long*>(fwords);
  a.counts = static_cast<unsigned long long*>(work);
  a.fblist = static_cast<long long*>(work) + 2;
  a.tlist = a.fblist + n * a.nf;
  a.cap = cap;
  a.ocount = static_cast<unsigned long long*>(ocount);
  a.obounds = static_cast<long long*>(obounds);
  a.okey = static_cast<long long*>(okey);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* act = static_cast<const uint8_t*>(active);
  int blocks = 1;
  cudaError_t err = grid_for(n, 8, &blocks);
  if (err != cudaSuccess) return (int)err;
  if (a.nf > 0) {
    err = cudaMemsetAsync(work, 0, 2 * sizeof(unsigned long long), st);
    if (err != cudaSuccess) return (int)err;
    da_prepare<<<blocks, DA_THREADS, 0, st>>>(a, act, n);
  }
  da_update<<<blocks, DA_THREADS, 0, st>>>(a, act, n);
  if (a.nf > 0) {
    err = grid_for(n * a.nf, 4, &blocks);
    if (err != cudaSuccess) return (int)err;
    da_fb_absmax<<<blocks, DA_THREADS, 0, st>>>(a);
    da_fb_add<<<blocks, DA_THREADS, 0, st>>>(a);
    da_fold<<<blocks, DA_THREADS, 0, st>>>(a);
  }
  return (int)cudaGetLastError();
}

// The records' float64 channels: q_off and acc_off [nf] per float64
// channel, fwords as dense_agg_update keeps it (nullptr when nf is 0).
extern "C" int dense_agg_check(int nres, const int* res_off, void* rec,
                               int R, int state_off, const void* present,
                               long long S, int nf, const int* q_off,
                               const int* acc_off, const void* fwords,
                               void* out, void* stream) {
  if (nres < 0 || nres > DA_MAX_RES || S < 1 || R < 1 ||
      (nres > 0 && !word_ok(state_off, R)) || nf < 0 || nf > DA_MAX_CH ||
      (nf > 0 && fwords == nullptr))
    return (int)cudaErrorInvalidValue;
  DACheck c = {};
  for (int i = 0; i < nres; ++i) {
    if (!word_ok(res_off[i], R)) return (int)cudaErrorInvalidValue;
    c.res_off[i] = res_off[i];
  }
  for (int q = 0; q < nf; ++q) {
    if (q_off[q] % 2 != 0 || !word_ok(q_off[q] + 1, R) ||
        !word_ok(acc_off[q], R))
      return (int)cudaErrorInvalidValue;
    c.q_off[q] = q_off[q];
    c.acc_off[q] = acc_off[q];
  }
  c.nf = nf;
  c.fwords = static_cast<const long long*>(fwords);
  c.rec = static_cast<long long*>(rec);
  c.R = R;
  c.state_off = state_off;
  c.nres = nres;
  int blocks = 1;
  cudaError_t err = grid_for(S, 4, &blocks);
  if (err != cudaSuccess) return (int)err;
  da_check<<<blocks, DA_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      c, static_cast<const uint8_t*>(present), S,
      static_cast<long long*>(out));
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
