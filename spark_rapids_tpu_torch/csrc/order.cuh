// order.cuh: the order-preserving views of one key value that sort.cu (the
// full device sort) and window_scan.cu (segment and peer boundaries) share.
//
//   key_view  the reference's groupby.py:43 sortable_view as an int64 whose
//             signed order is the value's order: integers (1, 2, 4 or 8
//             bytes, signed; booleans as 0/1) sign-extended; floats as
//             their bit pattern with negatives mapped to MIN - bits, -0.0
//             folded into +0.0 and every NaN one value above +inf.  A
//             float32 view stays within int32, as the reference's does.
//             Subnormals keep their bits (no flush to zero).
//
// Included by each kernel source, which is compiled into its own library.

#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define OK_KIND_INT 0
#define OK_KIND_FLOAT 1

__device__ __forceinline__ long long key_view(const void* p, int elem,
                                              int kind, long long r) {
  if (kind == OK_KIND_FLOAT) {
    if (elem == 8) {
      double d = static_cast<const double*>(p)[r];
      if (d != d) return LLONG_MAX;
      if (d == 0.0) d = 0.0;  // -0.0 -> +0.0
      const long long b = __double_as_longlong(d);
      return b < 0 ? LLONG_MIN - b : b;
    }
    float f = static_cast<const float*>(p)[r];
    if (f != f) return (long long)INT_MAX;
    if (f == 0.0f) f = 0.0f;
    const int b = __float_as_int(f);
    return (long long)(b < 0 ? INT_MIN - b : b);
  }
  switch (elem) {
    case 1: return (long long)static_cast<const int8_t*>(p)[r];
    case 2: return (long long)static_cast<const int16_t*>(p)[r];
    case 4: return (long long)static_cast<const int*>(p)[r];
    default: return static_cast<const long long*>(p)[r];
  }
}
