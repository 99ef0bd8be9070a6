// masked_reduce: K columns -> K scalars over the live rows of one batch,
// combined into a device accumulator that lives for the whole query.
//
// Replaces: spark_rapids_tpu/ops/groupby.py:396 ungrouped_reduce, which the
// JAX package fuses with the filter stage in plan/physical.py:843
// _execute_ungrouped (per-batch scalars, then _merge_scalars :943).
//
// Bound: device memory.  Each input byte is read once: n x (1 B active mask
// + 8 B per data column + 1 B per validity mask), over 3.35 TB/s on an H100
// SXM.  At TPC-H Q6 the sum column plus the mask is 9 B a row.
//
// Design.  A deterministic two-pass reduction, so that repeated runs are
// bit-identical like the reference's:
//   1. mr_partials: a grid-stride loop over rows with per-thread partials
//      in registers (the column loop is unrolled to MR_MAX_COLS so the
//      partials never spill to local memory), then a warp-shuffle and
//      shared-memory reduction per block; one partial per (block, column)
//      goes to scratch.  The grid size depends on n only.
//   2. mr_finish: one block reduces the partials of each column in a fixed
//      order and combines the result into the accumulator.
// Ops: sum, min, max on float64 or int64 columns, count (rows where
// the column's validity mask holds; no data is read), and first and last
// (ungrouped FIRST/LAST, the reference's _reduce_segment first/last and
// first_valid/last_valid of ops/groupby.py:333, merged across batches as
// plan/physical.py:943 _merge_scalars does): the host entry turns them
// into an int64 min (FIRST) or max (LAST) of the row numbers whose mask
// holds (the value's validity for the ignore-nulls forms, none otherwise),
// so the reduction is the integer one; mr_finish reads the value at the
// picked row and merges it with the accumulator's: FIRST keeps an earlier
// batch's value when that batch had a qualifying row (its `has` word is
// set), LAST takes this batch's whenever it has one.  int64 sums wrap
// like the reference's.  float64 min/max follow jnp.min/jnp.max over
// values masked with +-inf (ops/groupby.py:29 _SENTINELS): a NaN anywhere
// makes the result NaN, and -0.0 sorts below +0.0.
// The kernels launch on the caller's stream, do not synchronize and
// allocate nothing; the wrapper owns the scratch and the accumulator.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#define MR_MAX_COLS 16
#define MR_THREADS 256

enum { OP_SUM = 0, OP_MIN = 1, OP_MAX = 2, OP_COUNT = 3, OP_FIRST = 4,
       OP_LAST = 5 };

enum { PICK_NONE = 0, PICK_FIRST = 1, PICK_LAST = 2 };

struct MRArgs {
  const void* data[MR_MAX_COLS];      // double* or long long*; unused by count
  const uint8_t* valid[MR_MAX_COLS];  // nullptr: every row valid
  int op[MR_MAX_COLS];                // sum, min, max or count
  int is_f64[MR_MAX_COLS];            // the reduction's type
  int pick[MR_MAX_COLS];   // FIRST/LAST: row numbers reduce (as int64)
  int value_f64[MR_MAX_COLS];  // a picked value's type
  int k;
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

__device__ __forceinline__ Slot identity(int op, int is_f64) {
  Slot s;
  if (is_f64) {
    s.f = op == OP_MIN ? INFINITY : (op == OP_MAX ? -INFINITY : 0.0);
  } else {
    s.i = op == OP_MIN ? LLONG_MAX : (op == OP_MAX ? LLONG_MIN : 0LL);
  }
  return s;
}

__device__ __forceinline__ Slot combine(Slot a, Slot b, int op, int is_f64) {
  Slot r;
  if (is_f64) {
    r.f = op == OP_SUM ? a.f + b.f
                       : (op == OP_MIN ? min_f64(a.f, b.f) : max_f64(a.f, b.f));
  } else if (op == OP_MIN) {
    r.i = a.i < b.i ? a.i : b.i;
  } else if (op == OP_MAX) {
    r.i = a.i > b.i ? a.i : b.i;
  } else {  // sum and count wrap modulo 2^64
    r.i = (long long)((unsigned long long)a.i + (unsigned long long)b.i);
  }
  return r;
}

__device__ __forceinline__ Slot shfl_down(Slot v, int delta) {
  Slot r;
  r.i = __shfl_down_sync(0xffffffffu, v.i, delta);
  return r;
}

// Reduces one value per thread; the result is valid in thread 0.
__device__ Slot block_reduce(Slot v, int op, int is_f64, Slot* smem) {
  for (int d = 16; d > 0; d >>= 1) v = combine(v, shfl_down(v, d), op, is_f64);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // smem may still be read by the previous call
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? smem[lane] : identity(op, is_f64);
    for (int d = 16; d > 0; d >>= 1)
      v = combine(v, shfl_down(v, d), op, is_f64);
  }
  return v;
}

__global__ void __launch_bounds__(MR_THREADS)
mr_partials(MRArgs a, const uint8_t* __restrict__ active, long long n,
            Slot* __restrict__ partials) {
  Slot acc[MR_MAX_COLS];
#pragma unroll
  for (int j = 0; j < MR_MAX_COLS; ++j) acc[j] = identity(a.op[j], a.is_f64[j]);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += stride) {
    if (!active[r]) continue;
#pragma unroll
    for (int j = 0; j < MR_MAX_COLS; ++j) {
      if (j < a.k && (a.valid[j] == nullptr || a.valid[j][r])) {
        Slot x;
        if (a.op[j] == OP_COUNT) {
          x.i = 1;
        } else if (a.pick[j]) {
          x.i = r;
        } else if (a.is_f64[j]) {
          x.f = static_cast<const double*>(a.data[j])[r];
        } else {
          x.i = static_cast<const long long*>(a.data[j])[r];
        }
        acc[j] = combine(acc[j], x, a.op[j], a.is_f64[j]);
      }
    }
  }
  __shared__ Slot smem[32];
#pragma unroll
  for (int j = 0; j < MR_MAX_COLS; ++j) {
    if (j < a.k) {  // uniform across the block
      Slot v = block_reduce(acc[j], a.op[j], a.is_f64[j], smem);
      if (threadIdx.x == 0) partials[(long long)blockIdx.x * a.k + j] = v;
    }
  }
}

__global__ void __launch_bounds__(MR_THREADS)
mr_finish(MRArgs a, const Slot* __restrict__ partials, int nblocks,
          double* __restrict__ acc_f, long long* __restrict__ acc_i,
          long long* __restrict__ acc_h) {
  __shared__ Slot smem[32];
#pragma unroll
  for (int j = 0; j < MR_MAX_COLS; ++j) {
    if (j < a.k) {
      const int op = a.op[j], f = a.is_f64[j];
      Slot v = identity(op, f);
      for (int b = threadIdx.x; b < nblocks; b += blockDim.x)
        v = combine(v, partials[(long long)b * a.k + j], op, f);
      v = block_reduce(v, op, f, smem);
      if (threadIdx.x == 0 && a.pick[j]) {
        const bool first = a.pick[j] == PICK_FIRST;
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
      } else if (threadIdx.x == 0) {
        Slot cur;
        if (f) {
          cur.f = acc_f[j];
          acc_f[j] = combine(cur, v, op, f).f;
        } else {
          cur.i = acc_i[j];
          acc_i[j] = combine(cur, v, op, f).i;
        }
      }
    }
  }
}

// Host entry, bound with ctypes.  Pointers are device pointers except the
// four per-column arrays (host arrays of k entries).  `partials` is scratch
// of nblocks * k 8-byte slots; acc_h holds the FIRST/LAST columns' "some
// batch had a qualifying row" words (int64 [k]).  Returns
// cudaGetLastError() after the launches (0 = launched).
extern "C" int masked_reduce(const void* active, long long n, int k,
                             const void* const* data,
                             const void* const* valid, const int* ops,
                             const int* is_f64, void* partials, int nblocks,
                             void* acc_f, void* acc_i, void* acc_h,
                             void* stream) {
  if (k < 1 || k > MR_MAX_COLS || nblocks < 1)
    return (int)cudaErrorInvalidValue;
  MRArgs a = {};
  for (int j = 0; j < k; ++j) {
    if (ops[j] < OP_SUM || ops[j] > OP_LAST
        || ((data[j] == nullptr) != (ops[j] == OP_COUNT)))
      return (int)cudaErrorInvalidValue;
    a.data[j] = data[j];
    a.valid[j] = static_cast<const uint8_t*>(valid[j]);
    const bool first = ops[j] == OP_FIRST, last = ops[j] == OP_LAST;
    a.pick[j] = first ? PICK_FIRST : (last ? PICK_LAST : PICK_NONE);
    a.op[j] = first ? OP_MIN : (last ? OP_MAX : ops[j]);
    a.is_f64[j] = a.pick[j] ? 0 : is_f64[j];
    a.value_f64[j] = is_f64[j];
  }
  a.k = k;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  mr_partials<<<nblocks, MR_THREADS, 0, s>>>(
      a, static_cast<const uint8_t*>(active), n, static_cast<Slot*>(partials));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mr_finish<<<1, MR_THREADS, 0, s>>>(a, static_cast<const Slot*>(partials),
                                     nblocks, static_cast<double*>(acc_f),
                                     static_cast<long long*>(acc_i),
                                     static_cast<long long*>(acc_h));
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
