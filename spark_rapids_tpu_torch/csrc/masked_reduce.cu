// masked_reduce: K columns -> K scalars over the live rows of one batch,
// combined into a device accumulator that lives for the whole query.
//
// Replaces: spark_rapids_tpu/ops/groupby.py:396 ungrouped_reduce, which the
// JAX package fuses with the filter stage in plan/physical.py:843
// _execute_ungrouped (per-batch scalars, then _merge_scalars :943).
//
// Bound: device memory.  Each input byte is read once: n x 1 B of active
// mask, and per live row 8 B per data column and 1 B per validity mask
// (by 32-byte sector), over 3.35 TB/s on an H100 SXM.  At TPC-H Q6 (2% of
// 4,194,304 rows live, a float64 sum and a count) that is ~6.8 MB, 2 us:
// what is left is latency and launches, and the design is about those.
//
// Design: ONE kernel per call, deterministic (repeated runs are equal to
// the bit, like the reference's):
//   * units of 16 rows: a thread loads the active mask 16 bytes at a time
//     (uint4) and turns it into a 16-bit word of live rows; a word with no
//     live row costs that one load (at 2% live, 72% of words).  A mask
//     whose data_ptr is not 16-byte aligned (a view at a storage offset)
//     has a head unit (rows before the first aligned word) and a tail unit
//     (rows after the last), read a byte a row;
//   * per column, the (op, type) is chosen once per unit, outside the
//     rows: the unit's live rows are walked by a fully unrolled 16-step
//     loop whose loads are predicated on the live bits, so every data and
//     validity load of a word's live rows is issued before the first is
//     used (several loads in flight per thread).  A count without a
//     validity mask is popc of the word; FIRST and LAST without one are
//     the word's first or last live bit, with no load at all;
//   * a thread's partial of each column lives in dynamic shared memory
//     sized to the call's k (k x 256 x 8 B), one slot per thread and
//     column, so registers do not grow with k or with the 16-column
//     maximum (accumulators in registers, templated on k, took ~100 s to
//     compile, up to 102 registers a thread, and ran F1u's five columns
//     at 3x Q6's two);
//   * grid: 256-thread blocks over the units, capped at the blocks that
//     fit on the card at once (SM count x occupancy for the call's shared
//     memory, queried once per process and k), so at Q6's size each
//     thread takes about one 16-row unit and a larger batch loops.
//     tools/masked_reduce_bench.py times variants (PERF.md §6): one or
//     two blocks an SM, 6 or 8 blocks an SM under launch bounds, 128
//     threads a block and 8 or 4 rows a load step all ran no faster;
//     without the row loop the call takes ~80% of its time at Q6: the
//     launch, the blocks' reductions and ticket, and the last block's
//     dependent loads are the floor of this one-launch design;
//   * each block reduces its threads' partials in a fixed order (every
//     column's warp shuffles, one barrier, then thread j over column j's
//     warp partials) and writes one partial per column, column-major; the
//     last block to finish, found by a ticket (__threadfence, atomicAdd),
//     reduces them the same way (thread t first over blocks t, t + 256,
//     ... in order), combines the result into the accumulator and resets
//     the ticket for the next call.
// Ops: sum, min, max on float64 or int64 columns, count (rows where the
// column's validity mask holds; no data is read), and first and last
// (ungrouped FIRST/LAST, the reference's _reduce_segment first/last and
// first_valid/last_valid of ops/groupby.py:333, merged across batches as
// plan/physical.py:943 _merge_scalars does): the row numbers whose mask
// holds reduce by int64 min (FIRST) or max (LAST); the last block reads
// the value at the picked row and merges it with the accumulator's: FIRST
// keeps an earlier batch's value when that batch had a qualifying row (its
// `has` word is set), LAST takes this batch's whenever it has one.  int64
// sums wrap like the reference's.  float64 min/max follow jnp.min/jnp.max
// over values masked with +-inf (ops/groupby.py:29 _SENTINELS): a NaN
// anywhere makes the result NaN, and -0.0 sorts below +0.0.
// The kernel launches on the caller's stream, does not synchronize and
// allocates nothing; the wrapper owns the scratch (partials and ticket,
// kept per process and stream) and the accumulator.  acc_h is touched only
// when a column picks.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#define MR_MAX_COLS 16
#define MR_THREADS 256
#define MR_UNIT 16  // rows per unit: one uint4 of the active mask
#define MR_STEP 16  // rows of a unit whose loads are issued together
#define MR_STEP_MASK ((1u << MR_STEP) - 1u)

enum { OP_SUM = 0, OP_MIN = 1, OP_MAX = 2, OP_COUNT = 3, OP_FIRST = 4,
       OP_LAST = 5 };

// a column's (op, type), fixed for the launch
enum { C_SUM_F64 = 0, C_SUM_I64, C_MIN_F64, C_MAX_F64, C_MIN_I64,
       C_MAX_I64, C_COUNT, C_FIRST, C_LAST };

struct MRArgs {
  const void* data[MR_MAX_COLS];      // double* or long long*; unused by count
  const uint8_t* valid[MR_MAX_COLS];  // nullptr: every row valid
  int cls[MR_MAX_COLS];
  int value_f64[MR_MAX_COLS];  // a picked value's type
};

union Slot {
  double f;
  long long i;
};

__device__ __forceinline__ double nan_value() {
  return __longlong_as_double(0x7ff8000000000000LL);
}

__device__ __forceinline__ double min_f64(double a, double b) {
  if (isnan(a) || isnan(b)) return nan_value();
  if (a < b) return a;
  if (b < a) return b;
  return signbit(a) ? a : b;  // equal: -0.0 wins a min
}

__device__ __forceinline__ double max_f64(double a, double b) {
  if (isnan(a) || isnan(b)) return nan_value();
  if (a > b) return a;
  if (b > a) return b;
  return signbit(a) ? b : a;  // equal: +0.0 wins a max
}

__device__ __forceinline__ Slot identity(int cls) {
  Slot s;
  switch (cls) {
    case C_MIN_F64: s.f = INFINITY; break;
    case C_MAX_F64: s.f = -INFINITY; break;
    case C_SUM_F64: s.f = 0.0; break;
    case C_MIN_I64: case C_FIRST: s.i = LLONG_MAX; break;
    case C_MAX_I64: case C_LAST: s.i = LLONG_MIN; break;
    default: s.i = 0;  // int64 sums and counts
  }
  return s;
}

__device__ __forceinline__ Slot combine(Slot a, Slot b, int cls) {
  Slot r;
  switch (cls) {
    case C_SUM_F64: r.f = a.f + b.f; break;
    case C_MIN_F64: r.f = min_f64(a.f, b.f); break;
    case C_MAX_F64: r.f = max_f64(a.f, b.f); break;
    case C_MIN_I64: case C_FIRST: r.i = a.i < b.i ? a.i : b.i; break;
    case C_MAX_I64: case C_LAST: r.i = a.i > b.i ? a.i : b.i; break;
    default:  // int64 sums and counts wrap modulo 2^64
      r.i = (long long)((unsigned long long)a.i + (unsigned long long)b.i);
  }
  return r;
}

// ---------------------------------------------------------------------------
// one unit: rows [base, base + 16), live bits m (bit b: row base + b)
// ---------------------------------------------------------------------------

// The validity bits of the live rows m among [base, base + MR_STEP).
__device__ __forceinline__ unsigned valid_step(const uint8_t* __restrict__ v,
                                               long long base, unsigned m) {
  uint8_t b[MR_STEP];
#pragma unroll
  for (int i = 0; i < MR_STEP; ++i) b[i] = (m >> i) & 1u ? v[base + i] : 0;
  unsigned out = 0;
#pragma unroll
  for (int i = 0; i < MR_STEP; ++i) out |= (b[i] != 0 ? 1u : 0u) << i;
  return out;
}

// The live rows' validity bits over the unit (all of m without a
// validity mask).
__device__ __forceinline__ unsigned valid_bits(const uint8_t* __restrict__ v,
                                               long long base, unsigned m) {
  if (v == nullptr) return m;
  unsigned out = 0;
#pragma unroll
  for (int h = 0; h < MR_UNIT; h += MR_STEP) {
    const unsigned mh = (m >> h) & MR_STEP_MASK;
    if (mh != 0) out |= valid_step(v, base + h, mh) << h;
  }
  return out;
}

// The values and validity of the live rows m among [base, base +
// MR_STEP), every load issued before any is used.
template <typename T>
__device__ __forceinline__ unsigned load_step(const T* __restrict__ d,
                                              const uint8_t* __restrict__ v,
                                              long long base, unsigned m,
                                              T (&x)[MR_STEP]) {
#pragma unroll
  for (int i = 0; i < MR_STEP; ++i)
    x[i] = (m >> i) & 1u ? __ldg(d + base + i) : T(0);
  return v == nullptr ? m : valid_step(v, base, m);
}

// Folds the unit's live valid values of column d into r, a step of rows at
// a time, in row order.
template <typename T, class Fold>
__device__ __forceinline__ void fold_rows(const T* __restrict__ d,
                                          const uint8_t* __restrict__ v,
                                          long long base, unsigned m,
                                          const Fold& fold) {
#pragma unroll
  for (int h = 0; h < MR_UNIT; h += MR_STEP) {
    const unsigned mh = (m >> h) & MR_STEP_MASK;
    if (mh == 0) continue;
    T x[MR_STEP];
    const unsigned ok = load_step(d, v, base + h, mh, x);
#pragma unroll
    for (int i = 0; i < MR_STEP; ++i)
      if ((ok >> i) & 1u) fold(x[i]);
  }
}

__device__ __forceinline__ void unit_column(const MRArgs& a, int j, int cls,
                                            long long base, unsigned m,
                                            Slot& acc) {
  switch (cls) {
    case C_SUM_F64: {
      double s = 0.0;
      fold_rows(static_cast<const double*>(a.data[j]), a.valid[j], base, m,
                [&](double x) { s += x; });
      acc.f += s;
      break;
    }
    case C_MIN_F64:
    case C_MAX_F64: {
      double r = acc.f;
      fold_rows(static_cast<const double*>(a.data[j]), a.valid[j], base, m,
                [&](double x) {
                  r = cls == C_MIN_F64 ? min_f64(r, x) : max_f64(r, x);
                });
      acc.f = r;
      break;
    }
    case C_SUM_I64:
    case C_MIN_I64:
    case C_MAX_I64: {
      Slot r = acc;
      fold_rows(static_cast<const long long*>(a.data[j]), a.valid[j], base,
                m, [&](long long x) {
                  Slot y;
                  y.i = x;
                  r = combine(r, y, cls);
                });
      acc = r;
      break;
    }
    case C_COUNT:
      acc.i += __popc(valid_bits(a.valid[j], base, m));
      break;
    case C_FIRST:
    case C_LAST: {
      const unsigned ok = valid_bits(a.valid[j], base, m);
      if (ok != 0) {
        Slot y;
        y.i = base + (cls == C_FIRST ? __ffs(ok) - 1 : 31 - __clz(ok));
        acc = combine(acc, y, cls);
      }
      break;
    }
    default:
      break;
  }
}

// The 16-bit live word of a uint4 of bool bytes.
__device__ __forceinline__ unsigned live_bits(uint4 w) {
  const unsigned x[4] = {w.x, w.y, w.z, w.w};
  unsigned m = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const unsigned ones = __vcmpne4(x[q], 0u) & 0x01010101u;
    m |= ((ones * 0x01020408u) >> 24 & 0xfu) << (4 * q);
  }
  return m;
}

__device__ __forceinline__ Slot shfl_down(Slot v, int delta) {
  Slot r;
  r.i = __shfl_down_sync(0xffffffffu, v.i, delta);
  return r;
}

// Reduces one value per lane over the warp by a fixed tree; the result is
// valid in lane 0.
__device__ __forceinline__ Slot warp_reduce(Slot v, int cls) {
  for (int d = 16; d > 0; d >>= 1) v = combine(v, shfl_down(v, d), cls);
  return v;
}

// The block's reduction of s_acc (k columns of MR_THREADS slots) in a
// fixed order: every column's warp shuffles, one barrier, then thread j
// over column j's warp partials in warp order; the result is valid in
// thread j < k.
__device__ __forceinline__ Slot block_partial(
    const MRArgs& a, int k, const Slot* s_acc,
    Slot (*s_warp)[MR_THREADS / 32]) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  for (int j = 0; j < k; ++j) {
    const Slot v = warp_reduce(s_acc[j * MR_THREADS + t], a.cls[j]);
    if (lane == 0) s_warp[j][warp] = v;
  }
  __syncthreads();
  Slot v;
  v.i = 0;
  if (t < k) {
    v = s_warp[t][0];
    for (int w = 1; w < MR_THREADS / 32; ++w)
      v = combine(v, s_warp[t][w], a.cls[t]);
  }
  return v;
}

// Units: 0 is the head (rows [0, head)), 1..nwords the aligned words,
// nwords + 1 the tail (rows [head + 16 nwords, n)).  Thread t's partial of
// column j is s_acc[j][t] (dynamic shared memory, k x MR_THREADS slots).
__global__ void __launch_bounds__(MR_THREADS)
mr_reduce(const __grid_constant__ MRArgs a, int k,
          const uint8_t* __restrict__ active, long long n, long long head,
          long long nwords, Slot* __restrict__ partials,
          unsigned* __restrict__ ticket, double* __restrict__ acc_f,
          long long* __restrict__ acc_i, long long* __restrict__ acc_h) {
  extern __shared__ Slot s_acc[];
  const int t = threadIdx.x;
  for (int j = 0; j < k; ++j) s_acc[j * MR_THREADS + t] = identity(a.cls[j]);
  const long long units = nwords + 2;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tail = head + nwords * MR_UNIT;
  for (long long u = (long long)blockIdx.x * blockDim.x + t; u < units;
       u += stride) {
    long long base;
    unsigned m = 0;
    if (u == 0 || u == units - 1) {  // a partial unit, a byte a row
      base = u == 0 ? 0 : tail;
      const long long len = (u == 0 ? head : n - tail);
      for (int i = 0; i < len; ++i) m |= (active[base + i] != 0) << i;
    } else {
      base = head + (u - 1) * MR_UNIT;
      m = live_bits(__ldg(reinterpret_cast<const uint4*>(active + base)));
    }
    if (m == 0) continue;
    for (int j = 0; j < k; ++j) {
      Slot acc = s_acc[j * MR_THREADS + t];
      unit_column(a, j, a.cls[j], base, m, acc);
      s_acc[j * MR_THREADS + t] = acc;
    }
  }

  __shared__ Slot s_warp[MR_MAX_COLS][MR_THREADS / 32];
  __shared__ bool s_last;
  Slot v = block_partial(a, k, s_acc, s_warp);
  if (t < k) {
    partials[(long long)t * gridDim.x + blockIdx.x] = v;
    __threadfence();
  }
  __syncthreads();
  if (t == 0) s_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  // the last block: thread t combines blocks t, t + 256, ... of each
  // column in block order, then the block's fixed reduction; thread j
  // merges column j into the accumulator
  for (int j = 0; j < k; ++j) {
    const int cls = a.cls[j];
    const long long* col = &partials[(long long)j * gridDim.x].i;
    Slot r = identity(cls);
    for (int b = t; b < (int)gridDim.x; b += MR_THREADS) {
      Slot p;
      p.i = __ldcg(col + b);
      r = combine(r, p, cls);
    }
    s_acc[j * MR_THREADS + t] = r;
  }
  v = block_partial(a, k, s_acc, s_warp);
  if (t < k) {
    const int j = t, cls = a.cls[j];
    if (cls == C_FIRST || cls == C_LAST) {
      const bool first = cls == C_FIRST;
      const bool found = first ? v.i != LLONG_MAX : v.i != LLONG_MIN;
      if (found && (!first || acc_h[j] == 0)) {
        // the value's 8-byte word, in the slot of its type
        const long long bits = static_cast<const long long*>(a.data[j])[v.i];
        if (a.value_f64[j])
          acc_f[j] = __longlong_as_double(bits);
        else
          acc_i[j] = bits;
        acc_h[j] = 1;
      }
    } else if (cls == C_SUM_F64 || cls == C_MIN_F64 || cls == C_MAX_F64) {
      Slot cur;
      cur.f = acc_f[j];
      acc_f[j] = combine(cur, v, cls).f;
    } else {
      Slot cur;
      cur.i = acc_i[j];
      acc_i[j] = combine(cur, v, cls).i;
    }
  }
  if (t == 0) *ticket = 0u;  // for the next call on the stream
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// Host entry, bound with ctypes.  Pointers are device pointers except the
// four per-column arrays (host arrays of k entries).  `scratch` holds
// scratch_blocks * MR_MAX_COLS 8-byte partials and then the ticket (one
// 32-bit word, zero between calls: the kernel resets it); acc_h holds the
// FIRST/LAST columns' "some batch had a qualifying row" words (int64 [k];
// may be nullptr when no column is first or last).  Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int masked_reduce(const void* active, long long n, int k,
                             const void* const* data,
                             const void* const* valid, const int* ops,
                             const int* is_f64, void* scratch,
                             int scratch_blocks, void* acc_f, void* acc_i,
                             void* acc_h, void* stream) {
  if (k < 1 || k > MR_MAX_COLS || scratch_blocks < 1 || n < 0)
    return (int)cudaErrorInvalidValue;
  MRArgs a = {};
  for (int j = 0; j < k; ++j) {
    const int op = ops[j];
    if (op < OP_SUM || op > OP_LAST || ((data[j] == nullptr) != (op == OP_COUNT))
        || ((op == OP_FIRST || op == OP_LAST) && acc_h == nullptr))
      return (int)cudaErrorInvalidValue;
    a.data[j] = data[j];
    a.valid[j] = static_cast<const uint8_t*>(valid[j]);
    const bool f = is_f64[j] != 0;
    a.cls[j] = op == OP_COUNT ? C_COUNT : op == OP_FIRST ? C_FIRST
             : op == OP_LAST ? C_LAST
             : op == OP_SUM ? (f ? C_SUM_F64 : C_SUM_I64)
             : op == OP_MIN ? (f ? C_MIN_F64 : C_MIN_I64)
                            : (f ? C_MAX_F64 : C_MAX_I64);
    a.value_f64[j] = f;
  }
  if (n == 0) return (int)cudaSuccess;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(active);
  long long head = (long long)((MR_UNIT - addr % MR_UNIT) % MR_UNIT);
  if (head > n) head = n;
  const long long nwords = (n - head) / MR_UNIT;
  const size_t smem = (size_t)k * MR_THREADS * sizeof(Slot);
  // the blocks that fit on the card at once for this k, queried once per
  // process and device
  static int cap[64][MR_MAX_COLS + 1];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int blocks = dev < 64 ? cap[dev][k] : 0;
  if (blocks == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, mr_reduce, MR_THREADS, smem);
    if (err != cudaSuccess) return (int)err;
    blocks = sms * (per_sm > 0 ? per_sm : 1);
    if (dev < 64) cap[dev][k] = blocks;
  }
  const long long want = (nwords + 2 + MR_THREADS - 1) / MR_THREADS;
  if (want < blocks) blocks = (int)want;
  if (blocks > scratch_blocks) blocks = scratch_blocks;
  Slot* partials = static_cast<Slot*>(scratch);
  unsigned* ticket = reinterpret_cast<unsigned*>(
      partials + (size_t)scratch_blocks * MR_MAX_COLS);
  mr_reduce<<<blocks, MR_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      a, k, static_cast<const uint8_t*>(active), n, head, nwords, partials,
      ticket, static_cast<double*>(acc_f), static_cast<long long*>(acc_i),
      static_cast<long long*>(acc_h));
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
