// dense_agg: the dense direct-address grouped aggregation — a primary
// integral key scattered into domain-sized accumulators, residual keys kept
// as min/max channels that prove they depend on the primary, and an
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
//                     for a null key.  In-domain rows atomicAdd the float64
//                     sums, atomicAdd / atomicMin / atomicMax the int64
//                     channels, atomicMin / atomicMax each residual's vmin
//                     and vmax (and 32-bit validity words) and set the
//                     slot's presence byte.  Rows outside [kmin, kmin + D)
//                     go, through an atomic cursor, to a fixed-capacity
//                     overflow buffer with their key, residuals and
//                     contributions, and fold their key into device min/max
//                     words; the caller widens the domain once and replays
//                     the buffer through this same kernel.
//   dense_agg_check   over the slots: a present slot whose residual has
//                     both null and non-null rows, or two values, is a
//                     violation; also counts the present slots (n_groups).
//
// Float residuals (physical.py:1288 takes kind "f", :1537 checks them):
// a float64 residual's channels hold the int64 image of its value that
// orders floats with -0.0 just below +0.0 (hash_agg.cu's f64_image), so
// vmin decodes to the reference's scatter-min (which prefers -0.0), and
// the check takes images -1 and 0 (-0.0 and +0.0) as equal, as the
// reference's float comparison does.  A NaN drives vmin to INT64_MIN and
// vmax to INT64_MAX, images no number has: the check sees two values, a
// violation, as the reference treats any NaN residual.
//
// Bound: device memory.  The update reads each row's live mask, key,
// residuals and contribution columns once and does a read-modify-write of
// one 32-byte sector per channel at the row's slot, which is random in the
// domain: at TPC-H Q3 (~15 M slots, 5% live rows, one float64 sum, one
// count, two residuals) the slot sectors of the live rows dominate.  The
// design does each row's work in the thread that reads it, so the slot
// index is computed once and no per-row intermediate is written; residual
// min/max atomics are skipped when a plain read shows they cannot change
// the word, which is the common case (a residual depends on its key).
//
// float64 atomics add in no fixed order: sums may differ from run to run in
// the last bits.  int64 sums wrap modulo 2^64 like the reference's.  Keys
// and integer residuals are int32 or int64 (dates are int32, dictionary
// codes of strings int32, booleans are promoted by the caller); residuals
// are widened to int64 in their channels; float residuals are float64.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

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

struct DAUpdate {
  const void* key;
  const uint8_t* key_valid;
  int key_elem;
  const void* res[DA_MAX_RES];
  const uint8_t* res_valid[DA_MAX_RES];
  int res_elem[DA_MAX_RES];
  int res_f64[DA_MAX_RES];  // 1: a float64 residual (channels hold images)
  int nres;
  const void* ch[DA_MAX_CH];  // nullptr: a count channel (adds 1)
  const uint8_t* ch_valid[DA_MAX_CH];
  int ch_op[DA_MAX_CH];
  int ch_f64[DA_MAX_CH];
  int nch;
  // accumulators over S = D + 1 slots (slot D: the null key)
  long long kmin;
  long long D;
  void* acc[DA_MAX_CH];
  uint8_t* present;
  long long* vmin[DA_MAX_RES];
  long long* vmax[DA_MAX_RES];
  int* vdmin[DA_MAX_RES];
  int* vdmax[DA_MAX_RES];
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

#define F64_NEG_ZERO_IMAGE (-1LL)

// int64 image of a float64, monotonic, with -0.0 (image -1) just below
// +0.0 (image 0); not called for NaN.
__device__ __forceinline__ long long f64_image(double x) {
  const long long b = __double_as_longlong(x);
  return b >= 0 ? b : b ^ 0x7fffffffffffffffLL;
}

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

__global__ void __launch_bounds__(DA_THREADS)
da_update(const __grid_constant__ DAUpdate a,
          const uint8_t* __restrict__ active, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += stride) {
    if (!is_live(active, r)) continue;
    long long slot = a.D;  // the null key's slot
    if (a.key_valid == nullptr || a.key_valid[r]) {
      const long long key = load_i(a.key, a.key_elem, r);
      const unsigned long long d =
          (unsigned long long)key - (unsigned long long)a.kmin;
      if (key < a.kmin || d >= (unsigned long long)a.D) {
        overflow(a, r, key);
        continue;
      }
      slot = (long long)d;
    }
    a.present[slot] = 1;
    for (int j = 0; j < a.nch; ++j) {
      if (!ch_live(a, j, r)) continue;
      if (a.ch_f64[j]) {
        atomicAdd(static_cast<double*>(a.acc[j]) + slot,
                  static_cast<const double*>(a.ch[j])[r]);
        continue;
      }
      const long long v = ch_bits(a, j, r);
      long long* acc = static_cast<long long*>(a.acc[j]) + slot;
      if (a.ch_op[j] == OP_SUM)
        atomicAdd(reinterpret_cast<unsigned long long*>(acc),
                  (unsigned long long)v);
      else if (a.ch_op[j] == OP_MIN)
        atomicMin(acc, v);
      else
        atomicMax(acc, v);
    }
    for (int i = 0; i < a.nres; ++i) {
      const bool v = a.res_valid[i] == nullptr || a.res_valid[i][r];
      if (v) {
        long long lo, hi;
        if (a.res_f64[i]) {
          const double d = static_cast<const double*>(a.res[i])[r];
          const bool nan = d != d;
          lo = nan ? LLONG_MIN : f64_image(d);
          hi = nan ? LLONG_MAX : lo;
        } else {
          lo = hi = load_i(a.res[i], a.res_elem[i], r);
        }
        if (lo < a.vmin[i][slot]) atomicMin(a.vmin[i] + slot, lo);
        if (hi > a.vmax[i][slot]) atomicMax(a.vmax[i] + slot, hi);
        if (a.vdmax[i][slot] == 0) atomicMax(a.vdmax[i] + slot, 1);
      } else if (a.vdmin[i][slot] == 1) {
        atomicMin(a.vdmin[i] + slot, 0);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// violation check and group count
// ---------------------------------------------------------------------------

struct DACheck {
  const long long* vmin[DA_MAX_RES];
  const long long* vmax[DA_MAX_RES];
  const int* vdmin[DA_MAX_RES];
  const int* vdmax[DA_MAX_RES];
  int res_f64[DA_MAX_RES];
  int nres;
};

// Two channel values that are one key: equal, or -0.0 and +0.0.
__device__ __forceinline__ bool same_value(long long lo, long long hi,
                                           int f64) {
  return lo == hi || (f64 && lo == F64_NEG_ZERO_IMAGE && hi == 0);
}

// out: [violation, n_groups], preset to 0.
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
    for (int i = 0; i < c.nres; ++i) {
      if (c.vdmax[i][s] == 1 &&
          (c.vdmin[i][s] == 0 ||
           !same_value(c.vmin[i][s], c.vmax[i][s], c.res_f64[i])))
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

// Inputs: the primary key, nres residual columns (res_f64[i]: float64,
// else integers of res_elem[i] bytes), nch contribution
// channels (ch[j] nullptr = a count; ops 0 sum, 1 min, 2 max; ch_f64[j]
// = float64 sum).  Accumulators: acc[j] [S] (S = D + 1), present [S],
// vmin/vmax [nres][S] int64, vdmin/vdmax [nres][S] int32.  Overflow:
// okey [cap], ores/ores_valid [nres][cap], och (nullptr for counts) and
// och_valid [nch][cap], ocount and obounds device words.
extern "C" int dense_agg_update(
    const void* key, const void* key_valid, int key_elem, int nres,
    const void* const* res, const void* const* res_valid,
    const int* res_elem, const int* res_f64, int nch, const void* const* ch,
    const void* const* ch_valid, const int* ch_op, const int* ch_f64,
    const void* active, long long n, long long kmin, long long D,
    void* const* acc, void* present, void* const* vmin, void* const* vmax,
    void* const* vdmin, void* const* vdmax, long long cap, void* ocount,
    void* obounds, void* okey, void* const* ores, void* const* ores_valid,
    void* const* och, void* const* och_valid, void* stream) {
  if (!elem_ok(key_elem) || nres < 0 || nres > DA_MAX_RES || nch < 0 ||
      nch > DA_MAX_CH || D < 1 || cap < 0)
    return (int)cudaErrorInvalidValue;
  DAUpdate a = {};
  a.key = key;
  a.key_valid = static_cast<const uint8_t*>(key_valid);
  a.key_elem = key_elem;
  for (int i = 0; i < nres; ++i) {
    if (!elem_ok(res_elem[i]) || (res_f64[i] && res_elem[i] != 8))
      return (int)cudaErrorInvalidValue;
    a.res[i] = res[i];
    a.res_valid[i] = static_cast<const uint8_t*>(res_valid[i]);
    a.res_elem[i] = res_elem[i];
    a.res_f64[i] = res_f64[i] != 0;
    a.vmin[i] = static_cast<long long*>(vmin[i]);
    a.vmax[i] = static_cast<long long*>(vmax[i]);
    a.vdmin[i] = static_cast<int*>(vdmin[i]);
    a.vdmax[i] = static_cast<int*>(vdmax[i]);
    a.ores[i] = static_cast<long long*>(ores[i]);
    a.ores_valid[i] = static_cast<uint8_t*>(ores_valid[i]);
  }
  a.nres = nres;
  for (int j = 0; j < nch; ++j) {
    if (ch_op[j] < OP_SUM || ch_op[j] > OP_MAX ||
        (ch_f64[j] && (ch_op[j] != OP_SUM || ch[j] == nullptr)))
      return (int)cudaErrorInvalidValue;
    a.ch[j] = ch[j];
    a.ch_valid[j] = static_cast<const uint8_t*>(ch_valid[j]);
    a.ch_op[j] = ch_op[j];
    a.ch_f64[j] = ch_f64[j];
    a.acc[j] = acc[j];
    a.och[j] = static_cast<long long*>(och[j]);
    a.och_valid[j] = static_cast<uint8_t*>(och_valid[j]);
  }
  a.nch = nch;
  a.kmin = kmin;
  a.D = D;
  a.present = static_cast<uint8_t*>(present);
  a.cap = cap;
  a.ocount = static_cast<unsigned long long*>(ocount);
  a.obounds = static_cast<long long*>(obounds);
  a.okey = static_cast<long long*>(okey);
  int blocks = 1;
  cudaError_t err = grid_for(n, 8, &blocks);
  if (err != cudaSuccess) return (int)err;
  da_update<<<blocks, DA_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<const uint8_t*>(active), n);
  return (int)cudaGetLastError();
}

extern "C" int dense_agg_check(int nres, const void* const* vmin,
                               const void* const* vmax,
                               const void* const* vdmin,
                               const void* const* vdmax, const int* res_f64,
                               const void* present, long long S, void* out,
                               void* stream) {
  if (nres < 0 || nres > DA_MAX_RES || S < 1)
    return (int)cudaErrorInvalidValue;
  DACheck c = {};
  for (int i = 0; i < nres; ++i) {
    c.vmin[i] = static_cast<const long long*>(vmin[i]);
    c.vmax[i] = static_cast<const long long*>(vmax[i]);
    c.vdmin[i] = static_cast<const int*>(vdmin[i]);
    c.vdmax[i] = static_cast<const int*>(vdmax[i]);
    c.res_f64[i] = res_f64[i] != 0;
  }
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
