// wide_decimal: 128-bit decimal arithmetic, comparison and the finalize of
// wide sums, elementwise over int64 limb columns.
//
// Replaces: spark_rapids_tpu/ops/wide_decimal.py:39-132 (from_scaled64,
// add, neg, sub, eq/lt/le/gt/ge, mul_pow10 through 16-bit limbs), which
// the reference traces into its stage programs, and the host
// reconstruction of wide sums in spark_rapids_tpu/aggfns.py:131-156
// finalize_host (Python ints per group), done here on the device.
//
// A wide decimal (18 < precision <= 38) is an [n, 2] int64 column [lo, hi]
// of the scaled two's-complement value; a narrow one (precision <= 18) an
// [n] int64 column, sign-extended when it joins a wide computation.  The
// card has native 128-bit integers (__int128), so every operation is the
// integer operation itself, modulo 2^128 like the reference's lane
// arithmetic: the results are equal to the bit.
//
// Entry points:
//   wd_elementwise  per row: lift both operands (narrow or wide; one row
//                   broadcasts), multiply each by its 10^k, then lift
//                   (copy), add, subtract, negate, or compare; where the
//                   optional validity mask is 0 the output is zero limbs
//                   (or false).
//   wd_sum_finalize per group: the lane sums of a SUM (2 lanes: the low 32
//                   bits and the signed high part of narrow inputs; 4
//                   lanes: four 32-bit chunks of wide inputs, the last
//                   signed) recombined exactly; a group with no valid row,
//                   or whose total needs more than `precision` digits (or
//                   more than 128 bits), is null, and a device word records
//                   that a non-empty group overflowed (ANSI mode raises).
//
// Bound: device memory; per row one read of each operand (8 or 16 B), one
// write of the result (16 B, or 1 B for a comparison) and of the mask
// byte.  The arithmetic is a few integer instructions per row.

#include <cuda_runtime.h>
#include <stdint.h>

#define WD_THREADS 256

enum { WD_LIFT = 0, WD_ADD, WD_SUB, WD_NEG, WD_EQ, WD_LT, WD_LE, WD_GT,
       WD_GE };

typedef __int128 i128;
typedef unsigned __int128 u128;

struct Operand {
  const long long* data;
  long long rows;  // 1: broadcast
  int wide;        // [rows, 2] limbs, else [rows] scaled int64
  u128 scale;      // 10^k, modulo 2^128
};

__device__ __forceinline__ i128 load(const Operand& o, long long r) {
  const long long i = o.rows == 1 ? 0 : r;
  i128 v;
  if (o.wide) {
    const u128 lo = (unsigned long long)o.data[2 * i];
    const u128 hi = (unsigned long long)o.data[2 * i + 1];
    v = (i128)(lo | (hi << 64));
  } else {
    v = (i128)o.data[i];  // sign-extends
  }
  return (i128)((u128)v * o.scale);  // wraps modulo 2^128
}

__device__ __forceinline__ void store(long long* out, long long r, i128 v) {
  out[2 * r] = (long long)(unsigned long long)(u128)v;
  out[2 * r + 1] = (long long)(unsigned long long)((u128)v >> 64);
}

__global__ void __launch_bounds__(WD_THREADS)
wd_elementwise_kernel(int op, Operand a, Operand b,
                      const uint8_t* __restrict__ valid, long long n,
                      void* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += stride) {
    const bool ok = valid == nullptr || valid[r];
    const i128 x = load(a, r);
    const i128 y = (op == WD_LIFT || op == WD_NEG) ? (i128)0 : load(b, r);
    if (op >= WD_EQ) {
      bool c = op == WD_EQ ? x == y
             : op == WD_LT ? x < y
             : op == WD_LE ? x <= y
             : op == WD_GT ? x > y
                           : x >= y;
      static_cast<uint8_t*>(out)[r] = ok && c;
      continue;
    }
    i128 v = op == WD_LIFT ? x
           : op == WD_ADD  ? (i128)((u128)x + (u128)y)
           : op == WD_SUB  ? (i128)((u128)x - (u128)y)
                           : (i128)((u128)0 - (u128)x);
    store(static_cast<long long*>(out), r, ok ? v : (i128)0);
  }
}

__global__ void __launch_bounds__(WD_THREADS)
wd_sum_finalize_kernel(int nlanes, const long long* __restrict__ l0,
                       const long long* __restrict__ l1,
                       const long long* __restrict__ l2,
                       const long long* __restrict__ l3,
                       const long long* __restrict__ count, long long m,
                       i128 bound, long long* __restrict__ out,
                       uint8_t* __restrict__ out_valid,
                       int* __restrict__ overflowed) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x; g < m;
       g += stride) {
    i128 total;
    bool fits = true;
    if (nlanes == 2) {  // hi * 2^32 + lo: at most 2^95 in magnitude
      total = (i128)l1[g] * ((i128)1 << 32) + (i128)l0[g];
    } else {
      // (h1 * 2^32 + h0) * 2^64 + (l1 * 2^32 + l0), l0, l1, h0 >= 0
      const i128 low = (i128)l1[g] * ((i128)1 << 32) + (i128)l0[g];
      const i128 high = (i128)l3[g] * ((i128)1 << 32) + (i128)l2[g]
                        + (low >> 64);
      fits = high >= -((i128)1 << 63) && high < ((i128)1 << 63);
      total = (i128)(((u128)high << 64) | ((u128)low & ~(u128)0 >> 64));
    }
    const bool some = count[g] > 0;
    const bool inside = fits && total < bound && total > -bound;
    const bool ok = some && inside;
    if (some && !inside) atomicOr(overflowed, 1);
    store(out, g, ok ? total : (i128)0);
    out_valid[g] = ok;
  }
}

static cudaError_t grid_for(long long n, int* blocks) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long want = (n + WD_THREADS - 1) / WD_THREADS;
  const long long cap = (long long)sms * 16;
  *blocks = (int)(want < 1 ? 1 : (want < cap ? want : cap));
  return cudaSuccess;
}

static u128 pow10_128(int k) {
  u128 p = 1;
  for (int i = 0; i < k; ++i) p *= 10;
  return p;
}

// Host entries, bound with ctypes; pointers point to device memory except
// `lanes` (a host array of nlanes device pointers).  Each returns
// cudaGetLastError() after its launch (0 = launched).

// op: 0 lift, 1 add, 2 sub, 3 neg, 4 eq, 5 lt, 6 le, 7 gt, 8 ge.  Operand
// a (and b, nullptr for lift and neg): rows 1 or n, wide 1 for [rows, 2]
// limbs, k its 10^k.  out: int64 [n, 2], or uint8 [n] for a comparison.
extern "C" int wd_elementwise(int op, const void* a, long long a_rows,
                              int a_wide, int ka, const void* b,
                              long long b_rows, int b_wide, int kb,
                              const void* valid, long long n, void* out,
                              void* stream) {
  if (op < WD_LIFT || op > WD_GE || ka < 0 || ka > 38 || kb < 0 || kb > 38
      || a == nullptr || (a_rows != 1 && a_rows != n)
      || ((b == nullptr) != (op == WD_LIFT || op == WD_NEG))
      || (b != nullptr && b_rows != 1 && b_rows != n))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  Operand x = {static_cast<const long long*>(a), a_rows, a_wide,
               pow10_128(ka)};
  Operand y = {static_cast<const long long*>(b), b_rows, b_wide,
               pow10_128(kb)};
  int blocks = 1;
  cudaError_t err = grid_for(n, &blocks);
  if (err != cudaSuccess) return (int)err;
  wd_elementwise_kernel<<<blocks, WD_THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      op, x, y, static_cast<const uint8_t*>(valid), n, out);
  return (int)cudaGetLastError();
}

// lanes: 2 or 4 int64 [m] lane sums; count: int64 [m] valid rows per
// group; out int64 [m, 2], out_valid uint8 [m]; overflowed: one int32
// device word, zeroed by the caller.
extern "C" int wd_sum_finalize(int nlanes, const void* const* lanes,
                               const void* count, long long m, int precision,
                               void* out, void* out_valid, void* overflowed,
                               void* stream) {
  if ((nlanes != 2 && nlanes != 4) || precision < 1 || precision > 38)
    return (int)cudaErrorInvalidValue;
  if (m == 0) return (int)cudaSuccess;
  const long long* l[4] = {nullptr, nullptr, nullptr, nullptr};
  for (int i = 0; i < nlanes; ++i)
    l[i] = static_cast<const long long*>(lanes[i]);
  int blocks = 1;
  cudaError_t err = grid_for(m, &blocks);
  if (err != cudaSuccess) return (int)err;
  wd_sum_finalize_kernel<<<blocks, WD_THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      nlanes, l[0], l[1], l[2], l[3], static_cast<const long long*>(count),
      m, (i128)pow10_128(precision), static_cast<long long*>(out),
      static_cast<uint8_t*>(out_valid), static_cast<int*>(overflowed));
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
