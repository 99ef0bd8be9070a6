// fixed128: order-free float64 sums as exact 128-bit fixed-point integers,
// shared by dense_agg.cu, hash_agg.cu and grid_agg.cu.
//
// Float atomics add in no fixed order, so a float64 sum made with them may
// differ from run to run in its last bits, and a query that compares a
// recomputed sum with one it collected earlier (TPC-H Q15's
// total_revenue = max) then depends on the run.  Integer addition does not
// depend on the order.  So within one call (one batch) a kernel first takes
// each slot's largest finite |x| (fx_absmax: an atomicMax on the bits of a
// non-negative double, which order as unsigned integers); each finite x is
// then scaled by 2^k, k from that |x| and the call's row count so that no
// partial sum reaches 2^126, and added exactly as a 128-bit two's-
// complement integer (fx_add: two 64-bit atomics with a carry); a fold per
// call (fx_value) converts each slot's integer back to float64 and adds it
// to the slot's float64 accumulator, and the caller clears the words.
// Calls run in stream order, so the accumulator sees the same additions in
// every run: sums are equal to the bit from run to run.  Infinities and NaN
// bypass the fixed point (their sums do not depend on the order).  The
// loss: bits below the slot's largest |x| x 2^-100 or so.
//
// dense_agg.cu adds most x at one scale for the whole query instead, and
// folds at the query's tail (its header): only an x that is an integer at
// that scale takes it, so those adds lose nothing; every other x takes the
// per-call scale above.
//
// A slot's words are three uint64: [lo, hi, largest |x| bits].
//
// The query scale of hash_agg.cu and grid_agg.cu (dense_agg.cu keeps its
// own copy): per float64 channel, s = FX_SCALE_TOP - ilogb(the first
// call's largest finite |x|), kept for the query in a device word that
// starts at 0 (fx_scale_word).  A finite x with |x| 2^s in [2^52, 2^93)
// (fx_in_range: 2^-21 to 2^19 times that largest |x|) is an integer at
// that scale and adds exactly, once, at its row; sums of up to 2^34 rows a
// slot stay below 2^127.  Every other finite non-zero x takes the per-call
// scale above (the fallback).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// The scale exponent of a slot whose largest finite |x| has the bits
// m_bits: |x| * 2^k < 2^(126 - h) for its every x, h bits holding the
// call's row count, so no sum of the slot's rows reaches 2^126.
__device__ __forceinline__ int fx_scale(unsigned long long m_bits,
                                        long long rows) {
  const double m = __longlong_as_double((long long)m_bits);
  if (!(m > 0.0)) return 0;
  const int h = 64 - __clzll((unsigned long long)rows);
  return 125 - h - ilogb(m);
}

// Raises the slot's largest finite |x| word to |x| (finite, non-zero x).
__device__ __forceinline__ void fx_absmax(unsigned long long* m, double x) {
  const double a = fabs(x);
  if (!(a <= 1.7976931348623157e308) || a == 0.0) return;  // not finite
  const unsigned long long b = (unsigned long long)__double_as_longlong(a);
  if (b > *m) atomicMax(m, b);
}

// Adds the 128-bit two's-complement integer (lo, hi) to the word pair w.
__device__ __forceinline__ void fx_add_words(unsigned long long* w,
                                             unsigned long long lo,
                                             unsigned long long hi) {
  if (lo == 0ULL && hi == 0ULL) return;
  const unsigned long long old = atomicAdd(w, lo);
  atomicAdd(w + 1, hi + (old + lo < old ? 1ULL : 0ULL));
}

// The 128-bit two's-complement integer (lo, hi) of x * 2^k (finite; the
// fraction, if any, truncated).
__device__ __forceinline__ void fx_int(double x, int k,
                                       unsigned long long* lo,
                                       unsigned long long* hi) {
  const double y = fabs(scalbn(x, k));
  const double hi_d = trunc(y * 0x1p-64);
  *hi = __double2ull_rz(hi_d);
  *lo = __double2ull_rz(y - hi_d * 0x1p64);
  if (x < 0.0) {  // two's complement of the 128-bit magnitude
    *lo = ~*lo + 1ULL;
    *hi = ~*hi + (*lo == 0ULL ? 1ULL : 0ULL);
  }
}

// x * 2^k (finite) added exactly to the 128-bit word pair w.
__device__ __forceinline__ void fx_add(unsigned long long* w, double x,
                                       int k) {
  unsigned long long lo, hi;
  fx_int(x, k, &lo, &hi);
  fx_add_words(w, lo, hi);
}

// The float64 value of the 128-bit two's-complement integer (lo, hi)
// scaled by 2^-k.
__device__ __forceinline__ double fx_to_double(unsigned long long lo,
                                               unsigned long long hi, int k) {
  const bool neg = (long long)hi < 0;
  if (neg) {
    lo = ~lo + 1ULL;
    hi = ~hi + (lo == 0ULL ? 1ULL : 0ULL);
  }
  const double mag = (double)hi * 0x1p64 + (double)lo;
  return scalbn(neg ? -mag : mag, -k);
}

#define FX_FAST_LO 52
#define FX_FAST_HI 92
#define FX_SCALE_TOP 73
#define FX_SCALE_BIAS (1LL << 32)  // a scale word: 0 none, else s + bias

// The scale word (a set query scale s, stored as s + FX_SCALE_BIAS, so a
// zeroed word means no scale yet) made from the largest finite |x| bits
// m_bits (non-zero).
__device__ __forceinline__ long long fx_scale_word(
    unsigned long long m_bits) {
  return FX_SCALE_TOP - ilogb(__longlong_as_double((long long)m_bits))
      + FX_SCALE_BIAS;
}

__device__ __forceinline__ int fx_scale_of(long long word) {
  return (int)(word - FX_SCALE_BIAS);
}

// Whether finite non-zero x adds exactly at the query scale of `word` (0:
// no scale yet, so no).
__device__ __forceinline__ bool fx_in_range(double x, long long word) {
  if (word == 0) return false;
  const long long e = ilogb(x) + fx_scale_of(word);
  return e >= FX_FAST_LO && e <= FX_FAST_HI;
}

// Finite and non-zero.
__device__ __forceinline__ bool fx_finite_nonzero(double x) {
  const double a = fabs(x);
  return a <= 1.7976931348623157e308 && a != 0.0;
}

// The float64 value of a slot's words [lo, hi, largest |x| bits] for a
// call of `rows` rows; 0 when the slot saw no finite non-zero x.
__device__ __forceinline__ double fx_value(const unsigned long long* w,
                                           long long rows) {
  const unsigned long long m_bits = w[2];
  if (m_bits == 0ULL) return 0.0;
  return fx_to_double(w[0], w[1], fx_scale(m_bits, rows));
}
