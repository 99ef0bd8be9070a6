// sort: the full device sort — order images of the sort keys, the stable
// permutation that orders the rows by them, the primary key's range image
// in output order, and the gather that applies a permutation to columns.
//
// Replaces: spark_rapids_tpu/plan/exec_nodes.py:219 _sort_perm (a jitted
// lexsort of groupby.py:82 sort_indices_for_keys over groupby.py:43
// sortable_view images) and :161 _range_key_fn, as SortExec (:27, in-core
// and range-partitioned out-of-core) and the window operator
// (ops/window.py:35 SortedWindowContext) run them.
//
// Images (sort_image): per key, the reference's words, each an int64 whose
// signed order is the key's order:
//   * a key of at most 4 bytes folds its null flag above its 32-bit view
//     into ONE word, (flag << 32) + (view + 2^31), as :113-121 does (5
//     radix bytes);
//   * an 8-byte key gives its view (8 bytes) and, when it has a validity
//     mask, a separate flag word (1 byte) above it;
//   * desc complements the view (~view), never the float;
//   * flag = nulls_first ? valid : !valid, so nulls go first or last as the
//     order says, whatever the direction.  A null row keeps its payload's
//     view, as the reference's lexsort does.
// Permutation (sort_perm): a stable LSD radix sort of int32 row numbers,
// radix.cuh's one-sweep sort: per word from the least significant, ONE
// kernel (os_gather_hist over SOWord) gathers the word's radix digits in
// the current order and counts all of its bytes, then one pass kernel per
// byte; last, when there is a live mask, the dead flag as a 1-byte
// word, so dead rows park after every live row.  Stability (the passes rank
// equal digits by position, without atomics) keeps ties in input order,
// which makes the permutation equal the reference's lexsort exactly.  A
// byte whose digit is the same in every row is skipped on the device: its
// pass kernel reads the byte's counts and exits, so keys that vary in 2-3
// of their 8 bytes run 2-3 passes, and the host never waits.
// Range key (sort_range_key): _range_key_fn's view of the primary key in
// output order (desc complemented, nulls as INT64_MIN or INT64_MAX).
// Gather (sort_gather): out[c][i] = in[c][perm[i]] for up to 16 columns of
// 1, 2, 4 or 8-byte elements with their validity bytes.
//
// Bound: device memory.  The function must read the keys once and write
// the permutation (and the gathered columns) once.  The sort moves more:
// per running pass the word and the row number are read and written (24
// B/row, in coalesced runs); per word its gather reads the image at a
// random row (one sector per row) beside the permutation.  A skipped pass
// costs one launch whose blocks read 1 KB of counts and exit.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "order.cuh"
#include "radix.cuh"

#define SO_THREADS 256
#define SO_MAX_COLS 16
#define SO_MAX_PASSES 512

__device__ __forceinline__ unsigned long long so_radix(long long w,
                                                       int bytes) {
  return bytes == 8 ? (unsigned long long)w ^ 0x8000000000000000ull
                    : (unsigned long long)w;
}

static cudaError_t so_grid(long long n, int per_sm, int* blocks) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long want = (n + SO_THREADS - 1) / SO_THREADS;
  const long long cap = (long long)sms * per_sm;
  *blocks = (int)(want < 1 ? 1 : (want < cap ? want : cap));
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// images
// ---------------------------------------------------------------------------

// word[i] (and flag_word[i] for an 8-byte key with nulls) of row i.
__global__ void __launch_bounds__(SO_THREADS)
so_image(const void* __restrict__ data, const uint8_t* __restrict__ valid,
         int elem, int kind, int desc, int nulls_first, long long n,
         long long* __restrict__ word, long long* __restrict__ flag_word) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const bool ok = valid == nullptr || valid[i];
    const long long flag = nulls_first ? (ok ? 1 : 0) : (ok ? 0 : 1);
    long long v = key_view(data, elem, kind, i);
    if (elem <= 4) {
      int v32 = (int)v;
      if (desc) v32 = ~v32;
      word[i] = (flag << 32) + ((long long)v32 + 2147483648ll);
    } else {
      word[i] = desc ? ~v : v;
      if (flag_word != nullptr) flag_word[i] = flag;
    }
  }
}

// ---------------------------------------------------------------------------
// permutation
// ---------------------------------------------------------------------------

// out[i] = i: the permutation of a sort with no pass.
__global__ void __launch_bounds__(SO_THREADS)
so_iota(int* __restrict__ out, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    out[i] = (int)i;
}

// The radix digits of one word at row r (word == nullptr: the dead flag).
struct SOWord {
  const long long* word;
  int bytes;
  const uint8_t* active;
  __device__ __forceinline__ unsigned long long operator()(long long r) const {
    return word != nullptr ? so_radix(word[r], bytes)
                           : (unsigned long long)(active[r] ? 0 : 1);
  }
};

__global__ void __launch_bounds__(SO_THREADS)
so_copy_perm(const __grid_constant__ OSBufs b, const int* __restrict__ state,
             int p, long long n, int* __restrict__ out) {
  const int* __restrict__ perm = b.vals[state[p]];
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    out[i] = perm[i];
}

// ---------------------------------------------------------------------------
// range key, gather
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(SO_THREADS)
so_range_key(const void* __restrict__ data, const uint8_t* __restrict__ valid,
             int elem, int kind, int desc, int nulls_first,
             const int* __restrict__ perm, long long n,
             long long* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const long long r = perm == nullptr ? i : perm[i];
    if (valid != nullptr && !valid[r]) {
      out[i] = nulls_first ? LLONG_MIN : LLONG_MAX;
      continue;
    }
    const long long v = key_view(data, elem, kind, r);
    out[i] = desc ? ~v : v;
  }
}

struct SOCols {
  const void* in[SO_MAX_COLS];
  void* out[SO_MAX_COLS];
  const uint8_t* vin[SO_MAX_COLS];
  uint8_t* vout[SO_MAX_COLS];
  int elem[SO_MAX_COLS];
  int ncols;
};

__global__ void __launch_bounds__(SO_THREADS)
so_gather(const __grid_constant__ SOCols c, const int* __restrict__ perm,
          long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const long long r = perm[i];
    for (int k = 0; k < c.ncols; ++k) {
      switch (c.elem[k]) {
        case 1:
          static_cast<uint8_t*>(c.out[k])[i] =
              static_cast<const uint8_t*>(c.in[k])[r];
          break;
        case 2:
          static_cast<uint16_t*>(c.out[k])[i] =
              static_cast<const uint16_t*>(c.in[k])[r];
          break;
        case 4:
          static_cast<uint32_t*>(c.out[k])[i] =
              static_cast<const uint32_t*>(c.in[k])[r];
          break;
        default:
          static_cast<unsigned long long*>(c.out[k])[i] =
              static_cast<const unsigned long long*>(c.in[k])[r];
      }
      if (c.vout[k] != nullptr) c.vout[k][i] = c.vin[k][r];
    }
  }
}

// ---------------------------------------------------------------------------
// host entries (ctypes); each returns cudaGetLastError() after its
// launches (0 = launched)
// ---------------------------------------------------------------------------

static bool so_key_ok(int elem, int kind) {
  if (kind == OK_KIND_FLOAT) return elem == 4 || elem == 8;
  return kind == OK_KIND_INT &&
         (elem == 1 || elem == 2 || elem == 4 || elem == 8);
}

// word: [n] int64 out; flag_word: [n] int64 out for an 8-byte key with a
// validity mask (nullptr otherwise).
extern "C" int sort_image(const void* data, const void* valid, int elem,
                          int kind, int desc, int nulls_first, long long n,
                          void* word, void* flag_word, void* stream) {
  if (!so_key_ok(elem, kind) || n < 0 ||
      (elem <= 4 && flag_word != nullptr))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  if (word == nullptr || data == nullptr) return (int)cudaErrorInvalidValue;
  int blocks = 1;
  cudaError_t err = so_grid(n, 16, &blocks);
  if (err != cudaSuccess) return (int)err;
  so_image<<<blocks, SO_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      data, static_cast<const uint8_t*>(valid), elem, kind, desc,
      nulls_first, n, static_cast<long long*>(word),
      static_cast<long long*>(flag_word));
  return (int)cudaGetLastError();
}

// Scratch bytes of sort_perm for n rows and `passes` passes (the words'
// radix bytes, + 1 with a live mask).
extern "C" long long sort_perm_scratch(long long n, int passes) {
  return (long long)os_scratch(n, passes, nullptr, nullptr);
}

// Rows of one tile of the one-sweep pass.
extern "C" int sort_tile_rows() { return OS_TILE; }

// words[w]: [n] int64 images, most significant first, each with its radix
// byte count (1..8; a word of fewer than 8 bytes is non-negative and below
// 2^(8 * bytes)); active: [n] bool or nullptr; perm: [n] int32 out;
// scratch: sort_perm_scratch(n, passes) bytes.
extern "C" int sort_perm(int nwords, const void* const* words,
                         const int* bytes, const void* active, long long n,
                         void* perm, void* scratch, long long scratch_bytes,
                         void* stream) {
  if (nwords < 0 || n < 0 || n >= INT_MAX || perm == nullptr)
    return (int)cudaErrorInvalidValue;
  int passes = active != nullptr ? 1 : 0;
  for (int w = 0; w < nwords; ++w) {
    if (bytes[w] < 1 || bytes[w] > 8 || words[w] == nullptr)
      return (int)cudaErrorInvalidValue;
    passes += bytes[w];
  }
  if (passes > SO_MAX_PASSES) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int blocks = 1;
  cudaError_t err = so_grid(n, 8, &blocks);
  if (err != cudaSuccess) return (int)err;
  int* out = static_cast<int*>(perm);
  if (passes == 0) {
    so_iota<<<blocks, SO_THREADS, 0, s>>>(out, n);
    return (int)cudaGetLastError();
  }
  OSScratch sc;
  if (scratch == nullptr ||
      (long long)os_scratch(n, passes, scratch, &sc) > scratch_bytes)
    return (int)cudaErrorInvalidValue;
  int hblocks = 1;
  err = os_hist_blocks(n, &hblocks);
  if (err == cudaSuccess) err = os_clear(sc, s);
  if (err != cudaSuccess) return (int)err;
  const uint8_t* act = static_cast<const uint8_t*>(active);
  int p = 0;
  // least significant word first; the dead flag last (most significant)
  for (int step = nwords - 1; step >= -1; --step) {
    if (step < 0 && act == nullptr) break;
    SOWord src;
    src.word = step >= 0 ? static_cast<const long long*>(words[step])
                         : nullptr;
    src.bytes = step >= 0 ? bytes[step] : 1;
    src.active = act;
    os_gather_hist<SOWord><<<hblocks, OS_HIST_THREADS, 0, s>>>(
        sc.b, sc.state, p, p == 0, src, src.bytes, n, sc.hist);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    for (int byte = 0; byte < src.bytes; ++byte, ++p) {
      err = os_pass_launch(sc, p, n, 8 * byte, s);
      if (err != cudaSuccess) return (int)err;
    }
  }
  so_copy_perm<<<blocks, SO_THREADS, 0, s>>>(sc.b, sc.state, p, n, out);
  return (int)cudaGetLastError();
}

// out: [n] int64, the primary key's range image at row perm[i] (perm ==
// nullptr: row i).
extern "C" int sort_range_key(const void* data, const void* valid, int elem,
                              int kind, int desc, int nulls_first,
                              const void* perm, long long n, void* out,
                              void* stream) {
  if (!so_key_ok(elem, kind) || n < 0 || out == nullptr)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  int blocks = 1;
  cudaError_t err = so_grid(n, 16, &blocks);
  if (err != cudaSuccess) return (int)err;
  so_range_key<<<blocks, SO_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      data, static_cast<const uint8_t*>(valid), elem, kind, desc,
      nulls_first, static_cast<const int*>(perm), n,
      static_cast<long long*>(out));
  return (int)cudaGetLastError();
}

// in/out: ncols column pointers; vin/vout: validity bytes or nullptr
// (vout must be given where vin is); perm: [n] int32 row numbers.
extern "C" int sort_gather(int ncols, const void* const* in,
                           void* const* out, const void* const* vin,
                           void* const* vout, const int* elems,
                           const void* perm, long long n, void* stream) {
  if (ncols < 1 || ncols > SO_MAX_COLS || n < 0 || perm == nullptr)
    return (int)cudaErrorInvalidValue;
  SOCols c = {};
  for (int k = 0; k < ncols; ++k) {
    const int e = elems[k];
    if ((e != 1 && e != 2 && e != 4 && e != 8) || in[k] == nullptr ||
        out[k] == nullptr || ((vin[k] == nullptr) != (vout[k] == nullptr)))
      return (int)cudaErrorInvalidValue;
    c.in[k] = in[k];
    c.out[k] = out[k];
    c.vin[k] = static_cast<const uint8_t*>(vin[k]);
    c.vout[k] = static_cast<uint8_t*>(vout[k]);
    c.elem[k] = e;
  }
  c.ncols = ncols;
  if (n == 0) return (int)cudaSuccess;
  int blocks = 1;
  cudaError_t err = so_grid(n, 16, &blocks);
  if (err != cudaSuccess) return (int)err;
  so_gather<<<blocks, SO_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      c, static_cast<const int*>(perm), n);
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
