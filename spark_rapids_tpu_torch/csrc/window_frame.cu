// window_frame: the bounds of each row's window frame, and the sums and
// min/max over bounded frames.
//
// Replaces: spark_rapids_tpu/ops/window.py:203 rows_positions, :214
// range_positions (with :311 _lex_searchsorted), :344 positional_sum,
// :355 sliding_sum and :372 sliding_minmax.  Rows are in the window's
// sorted order; seg_start/seg_end are window_scan.cu's partition bounds.
//
// Entry points:
//   frame_rows    ROWS BETWEEN lo AND hi: [i + lo, i + hi] clamped to the
//                 row's partition (an unbounded side is the partition's
//                 edge).
//   frame_range   RANGE BETWEEN lo AND hi over one integral or date order
//                 key, one thread per row: the partition's valid block
//                 (its nulls sit first or last, found by a binary search
//                 on the validity), then a lower bound of key + lo and an
//                 upper bound of key + hi within it.  A descending key is
//                 negated first, so PRECEDING adds as Spark's desc ranges
//                 do; key + delta saturates to +-2^62 on overflow as the
//                 reference's _sat_add does; an unbounded side is the
//                 partition's edge, nulls included; a null key's frame is
//                 exactly its partition's null rows.
//   frame_sum     sum (int64 or float64) or count over [lo, hi]: the
//                 difference of the partition's running sum (window_scan's
//                 segmented scan of the same contributions) at hi and
//                 lo - 1, as the reference's prefix difference, but reset
//                 at each partition, so a float sum's error follows the
//                 partition's running total, not the column's.  An empty
//                 frame gives 0.
//   frame_minmax  min or max over [lo, hi] by a direct loop over the frame
//                 (NaN propagates), and whether any row contributed.  The
//                 loop costs the frame's width per row: 7 rows for ROWS
//                 -6..0, a few for RANGE -30..0 days over a supplier's
//                 ~600 lineitems; a wide RANGE frame over dense keys would
//                 need the reference's sparse table instead.
//
// Bound: device memory; one thread per row, every read but the binary
// searches coalesced.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>
#include <string.h>

#define WF_THREADS 256
#define WF_SAT (1ll << 62)

static cudaError_t wf_grid(long long n, int per_sm, int* blocks) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long want = (n + WF_THREADS - 1) / WF_THREADS;
  const long long cap = (long long)sms * per_sm;
  *blocks = (int)(want < 1 ? 1 : (want < cap ? want : cap));
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// frame bounds
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(WF_THREADS)
wf_rows(long long lo, long long hi, int lo_unb, int hi_unb,
        const int* __restrict__ seg_start, const int* __restrict__ seg_end,
        long long n, int* __restrict__ lo_out, int* __restrict__ hi_out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const long long s = seg_start[i], e = seg_end[i];
    long long a = lo_unb ? s : i + lo;
    long long b = hi_unb ? e : i + hi;
    if (a < s) a = s;
    if (b > e) b = e;
    // an empty frame keeps hi < lo within int32
    if (a > e + 1) a = e + 1;
    if (b < s - 1) b = s - 1;
    lo_out[i] = (int)a;
    hi_out[i] = (int)b;
  }
}

__device__ __forceinline__ long long wf_key(const void* p, int elem,
                                            long long r, int desc) {
  const long long k = elem == 8 ? static_cast<const long long*>(p)[r]
                                : (long long)static_cast<const int*>(p)[r];
  return desc ? (long long)(0ull - (unsigned long long)k) : k;
}

__device__ __forceinline__ long long wf_sat_add(long long a, long long d) {
  const long long t = (long long)((unsigned long long)a
                                  + (unsigned long long)d);
  if (d >= 0) return t < a ? WF_SAT : t;
  return t > a ? -WF_SAT : t;
}

__global__ void __launch_bounds__(WF_THREADS)
wf_range(const void* __restrict__ key, int elem,
         const uint8_t* __restrict__ valid, int desc, int nulls_first,
         long long lo, long long hi, int lo_unb, int hi_unb,
         const int* __restrict__ seg_start, const int* __restrict__ seg_end,
         long long n, int* __restrict__ lo_out, int* __restrict__ hi_out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const long long s = seg_start[i], e = seg_end[i];
    long long vs = s, ve = e;  // the partition's valid block
    if (valid != nullptr) {
      // nulls first: F..F T..T (first valid row); last: T..T F..F
      long long a = s, b = e + 1;
      while (a < b) {
        const long long mid = (a + b) >> 1;
        const bool before = nulls_first ? !valid[mid] : valid[mid];
        if (before) a = mid + 1; else b = mid;
      }
      if (nulls_first) vs = a; else ve = a - 1;
    }
    long long a_out, b_out;
    if (valid == nullptr || valid[i]) {
      const long long k = wf_key(key, elem, i, desc);
      if (lo_unb) {
        a_out = s;
      } else {
        const long long t = wf_sat_add(k, lo);
        long long a = vs, b = ve + 1;  // first row with key >= t
        while (a < b) {
          const long long mid = (a + b) >> 1;
          if (wf_key(key, elem, mid, desc) < t) a = mid + 1; else b = mid;
        }
        a_out = a;
      }
      if (hi_unb) {
        b_out = e;
      } else {
        const long long t = wf_sat_add(k, hi);
        long long a = vs, b = ve + 1;  // first row with key > t
        while (a < b) {
          const long long mid = (a + b) >> 1;
          if (wf_key(key, elem, mid, desc) <= t) a = mid + 1; else b = mid;
        }
        b_out = a - 1;
      }
    } else if (nulls_first) {
      a_out = s;
      b_out = vs - 1;
    } else {
      a_out = ve + 1;
      b_out = e;
    }
    lo_out[i] = (int)a_out;
    hi_out[i] = (int)b_out;
  }
}

// ---------------------------------------------------------------------------
// framed sums and min/max
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(WF_THREADS)
wf_sum(const T* __restrict__ run, const T* __restrict__ vals,
       const uint8_t* __restrict__ mask, const int* __restrict__ lo,
       const int* __restrict__ hi, long long n, T* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const long long a = lo[i], b = hi[i];
    if (b < a) {
      out[i] = (T)0;
      continue;
    }
    const bool in = mask == nullptr || mask[a];
    const T first = in ? (vals == nullptr ? (T)1 : vals[a]) : (T)0;
    out[i] = run[b] - run[a] + first;
  }
}

template <typename T>
__device__ __forceinline__ T wf_pick(int is_max, T a, T b) {
  return is_max ? (b > a ? b : a) : (b < a ? b : a);
}

template <>
__device__ __forceinline__ double wf_pick<double>(int is_max, double a,
                                                  double b) {
  if (a != a) return a;
  if (b != b) return b;
  return is_max ? (b > a ? b : a) : (b < a ? b : a);
}

template <typename T>
__global__ void __launch_bounds__(WF_THREADS)
wf_minmax(const T* __restrict__ vals, const uint8_t* __restrict__ mask,
          int is_max, T identity, const int* __restrict__ lo,
          const int* __restrict__ hi, long long n, T* __restrict__ out,
          uint8_t* __restrict__ out_valid) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    T acc = identity;
    bool any = false;
    for (long long j = lo[i]; j <= hi[i]; ++j) {
      if (mask != nullptr && !mask[j]) continue;
      acc = wf_pick<T>(is_max, acc, vals[j]);
      any = true;
    }
    out[i] = acc;
    out_valid[i] = any;
  }
}

// ---------------------------------------------------------------------------
// host entries (ctypes); each returns cudaGetLastError() after its
// launches (0 = launched)
// ---------------------------------------------------------------------------

// lo_out, hi_out: [n] int32.
extern "C" int frame_rows(long long lo, long long hi, int lo_unb, int hi_unb,
                          const void* seg_start, const void* seg_end,
                          long long n, void* lo_out, void* hi_out,
                          void* stream) {
  if (n < 0 || seg_start == nullptr || seg_end == nullptr ||
      lo_out == nullptr || hi_out == nullptr)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  int blocks = 1;
  cudaError_t err = wf_grid(n, 16, &blocks);
  if (err != cudaSuccess) return (int)err;
  wf_rows<<<blocks, WF_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      lo, hi, lo_unb, hi_unb, static_cast<const int*>(seg_start),
      static_cast<const int*>(seg_end), n, static_cast<int*>(lo_out),
      static_cast<int*>(hi_out));
  return (int)cudaGetLastError();
}

// key: the sorted order key, int32 (int, date) or int64 (bigint,
// timestamp); valid: its validity or nullptr.
extern "C" int frame_range(const void* key, int elem, const void* valid,
                           int desc, int nulls_first, long long lo,
                           long long hi, int lo_unb, int hi_unb,
                           const void* seg_start, const void* seg_end,
                           long long n, void* lo_out, void* hi_out,
                           void* stream) {
  if ((elem != 4 && elem != 8) || n < 0 || key == nullptr ||
      seg_start == nullptr || seg_end == nullptr || lo_out == nullptr ||
      hi_out == nullptr)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  int blocks = 1;
  cudaError_t err = wf_grid(n, 16, &blocks);
  if (err != cudaSuccess) return (int)err;
  wf_range<<<blocks, WF_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      key, elem, static_cast<const uint8_t*>(valid), desc, nulls_first, lo,
      hi, lo_unb, hi_unb, static_cast<const int*>(seg_start),
      static_cast<const int*>(seg_end), n, static_cast<int*>(lo_out),
      static_cast<int*>(hi_out));
  return (int)cudaGetLastError();
}

// is_f64: 0 int64, 1 float64.  run: the partition's inclusive running sum
// of the contributions (vals where mask, else 0; vals == nullptr: 1 where
// mask, a count); out: [n] of the type.
extern "C" int frame_sum(int is_f64, const void* run, const void* vals,
                         const void* mask, const void* lo, const void* hi,
                         long long n, void* out, void* stream) {
  if (n < 0 || run == nullptr || lo == nullptr || hi == nullptr ||
      out == nullptr || (is_f64 && vals == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  int blocks = 1;
  cudaError_t err = wf_grid(n, 16, &blocks);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  const int* l = static_cast<const int*>(lo);
  const int* h = static_cast<const int*>(hi);
  if (is_f64)
    wf_sum<double><<<blocks, WF_THREADS, 0, s>>>(
        static_cast<const double*>(run), static_cast<const double*>(vals), m,
        l, h, n, static_cast<double*>(out));
  else
    wf_sum<long long><<<blocks, WF_THREADS, 0, s>>>(
        static_cast<const long long*>(run),
        static_cast<const long long*>(vals), m, l, h, n,
        static_cast<long long*>(out));
  return (int)cudaGetLastError();
}

// identity_bits: the op's identity as int64 bits of the type; out: [n];
// out_valid: [n] uint8, whether a row contributed.
extern "C" int frame_minmax(int is_f64, int is_max, const void* vals,
                            const void* mask, long long identity_bits,
                            const void* lo, const void* hi, long long n,
                            void* out, void* out_valid, void* stream) {
  if (n < 0 || vals == nullptr || lo == nullptr || hi == nullptr ||
      out == nullptr || out_valid == nullptr)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  int blocks = 1;
  cudaError_t err = wf_grid(n, 16, &blocks);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  const int* l = static_cast<const int*>(lo);
  const int* h = static_cast<const int*>(hi);
  uint8_t* ov = static_cast<uint8_t*>(out_valid);
  if (is_f64) {
    double identity;
    memcpy(&identity, &identity_bits, sizeof(identity));
    wf_minmax<double><<<blocks, WF_THREADS, 0, s>>>(
        static_cast<const double*>(vals), m, is_max, identity, l, h, n,
        static_cast<double*>(out), ov);
  } else {
    wf_minmax<long long><<<blocks, WF_THREADS, 0, s>>>(
        static_cast<const long long*>(vals), m, is_max, identity_bits, l, h,
        n, static_cast<long long*>(out), ov);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
