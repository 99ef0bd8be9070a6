// explode: the rows of an explode (Generate) over one chunk of its output
// — every sibling column gathered by the output row's parent, and the
// row's list element.
//
// Replaces: spark_rapids_tpu/plan/exec_nodes.py:466
// GenerateExec._gather_fn (every device column of the batch gathered by a
// parent row index in one program) together with the element column that
// GenerateExec.execute builds on the host and uploads per chunk
// (:494-528).  The reference uploads a host-built parent index, 8 bytes
// per output row.  Here the host passes what the list offsets already give
// it, per parent row: `starts`, the int64 [n + 1] first output row of each
// parent (its running count of output rows), and, only under OUTER, the
// int64 [n + 1] element offsets `eoffs` (where an empty or null list still
// takes one output row, so starts and offsets differ).  Without OUTER a
// row's element is its own output row number, as the elements of the
// non-null lists lie contiguous and in order.
//
// One thread per output row of the chunk [lo, lo + m).  Thread 0 of each
// block finds, by binary search over `starts`, the parents of the block's
// first and last rows; every thread then searches only between them (the
// pattern of cond_join.cu cond_expand), so a long list and a run of empty
// ones cost the same per row.  The row's parent p is the last p with
// starts[p] <= row.  Its element is eoffs[p] + (row - starts[p]) (row
// itself without OUTER); under OUTER a parent with no elements gives one
// row with a null element.  A null element is written as 0 and marked
// invalid, as the reference fills it.  Sibling columns move 1, 2, 4 or 8
// bytes per row (wide decimal limbs as two 8-byte columns), with their
// validity bytes.
//
// Bound: device memory.  Per output row: its element (read and written)
// and its validity byte, and each sibling column's value and validity at
// the parent (read by sector: consecutive rows share a parent) and at the
// row (written).  The starts are read once per block search, a few
// sectors per block.

#include <cuda_runtime.h>
#include <stdint.h>

#define EX_THREADS 256
#define EX_MAX_COLS 16

struct EXArgs {
  const void* in[EX_MAX_COLS];
  void* out[EX_MAX_COLS];
  const uint8_t* vin[EX_MAX_COLS];  // nullptr: no validity mask
  uint8_t* vout[EX_MAX_COLS];
  int elem[EX_MAX_COLS];
  int ncols;
};

__device__ __forceinline__ void move_elem(void* dst, const void* src, int elem,
                                          long long to, long long from) {
  switch (elem) {
    case 8:
      static_cast<long long*>(dst)[to] =
          static_cast<const long long*>(src)[from];
      break;
    case 4:
      static_cast<int*>(dst)[to] = static_cast<const int*>(src)[from];
      break;
    case 2:
      static_cast<short*>(dst)[to] = static_cast<const short*>(src)[from];
      break;
    default:
      static_cast<uint8_t*>(dst)[to] = static_cast<const uint8_t*>(src)[from];
  }
}

__device__ __forceinline__ void zero_elem(void* dst, int elem, long long to) {
  switch (elem) {
    case 8: static_cast<long long*>(dst)[to] = 0; break;
    case 4: static_cast<int*>(dst)[to] = 0; break;
    case 2: static_cast<short*>(dst)[to] = 0; break;
    default: static_cast<uint8_t*>(dst)[to] = 0;
  }
}

// The largest p in [a, b] with starts[p] <= r (starts non-decreasing,
// starts[a] <= r).
__device__ __forceinline__ long long parent_of(const long long* starts,
                                               long long a, long long b,
                                               long long r) {
  while (a < b) {
    const long long mid = (a + b + 1) >> 1;
    if (starts[mid] <= r) a = mid; else b = mid - 1;
  }
  return a;
}

__global__ void __launch_bounds__(EX_THREADS)
explode_k(const __grid_constant__ EXArgs a,
          const long long* __restrict__ starts,
          const long long* __restrict__ eoffs, long long n, long long lo,
          long long m, const void* __restrict__ values,
          const uint8_t* __restrict__ values_valid, int elem_bytes,
          void* __restrict__ out_values, uint8_t* __restrict__ out_valid) {
  __shared__ long long first_parent, last_parent;
  const long long j0 = (long long)blockIdx.x * EX_THREADS;
  if (threadIdx.x == 0) {
    const long long r0 = lo + j0;
    const long long r1 = lo + min(j0 + EX_THREADS, m) - 1;
    first_parent = parent_of(starts, 0, n - 1, r0);
    last_parent = parent_of(starts, first_parent, n - 1, r1);
  }
  __syncthreads();
  const long long j = j0 + threadIdx.x;
  if (j >= m) return;
  const long long r = lo + j;
  const long long p = parent_of(starts, first_parent, last_parent, r);
  if (values != nullptr) {
    long long e = r;
    bool ok = true;
    if (eoffs != nullptr) {
      const long long e0 = eoffs[p];
      ok = eoffs[p + 1] > e0;  // OUTER: an empty or null list's one row
      e = e0 + (r - starts[p]);
    }
    if (ok && values_valid != nullptr) ok = values_valid[e] != 0;
    if (ok)
      move_elem(out_values, values, elem_bytes, j, e);
    else
      zero_elem(out_values, elem_bytes, j);
    if (out_valid != nullptr) out_valid[j] = ok;
  }
  for (int c = 0; c < a.ncols; ++c) {
    move_elem(a.out[c], a.in[c], a.elem[c], j, p);
    if (a.vin[c] != nullptr) a.vout[c][j] = a.vin[c][p];
  }
}

static bool elem_ok(int e) { return e == 1 || e == 2 || e == 4 || e == 8; }

// Host entry, bound with ctypes.  `starts` (and `eoffs` under OUTER, else
// nullptr) are int64 [n + 1] device arrays; `values` (nullptr: no element
// column in this call) holds the batch's flat elements, `values_valid`
// their validity or nullptr, `out_valid` the element validity to write or
// nullptr.  `in`, `out`, `vin`, `vout` and `elems` are host arrays of the
// sibling columns ([n] in, [m] out).  Returns cudaGetLastError().
extern "C" int explode(long long n, const void* starts, const void* eoffs,
                       long long lo, long long m, const void* values,
                       const void* values_valid, int elem_bytes,
                       void* out_values, void* out_valid, int ncols,
                       const void* const* in, void* const* out,
                       const void* const* vin, void* const* vout,
                       const int* elems, void* stream) {
  if (n <= 0 || lo < 0 || m < 0 || ncols < 0 || ncols > EX_MAX_COLS ||
      (values != nullptr && !elem_ok(elem_bytes)))
    return (int)cudaErrorInvalidValue;
  EXArgs a = {};
  for (int c = 0; c < ncols; ++c) {
    if (!elem_ok(elems[c]) || (vin[c] == nullptr) != (vout[c] == nullptr))
      return (int)cudaErrorInvalidValue;
    a.in[c] = in[c];
    a.out[c] = out[c];
    a.vin[c] = static_cast<const uint8_t*>(vin[c]);
    a.vout[c] = static_cast<uint8_t*>(vout[c]);
    a.elem[c] = elems[c];
  }
  a.ncols = ncols;
  const long long blocks = (m + EX_THREADS - 1) / EX_THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (m > 0)
    explode_k<<<(unsigned)blocks, EX_THREADS, 0,
                static_cast<cudaStream_t>(stream)>>>(
        a, static_cast<const long long*>(starts),
        static_cast<const long long*>(eoffs), n, lo, m, values,
        static_cast<const uint8_t*>(values_valid), elem_bytes, out_values,
        static_cast<uint8_t*>(out_valid));
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
