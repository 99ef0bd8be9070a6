// sort_join: the sort-based match state of an equi-join on any key tuple —
// the build side stably sorted by its keys once, each probe row's match
// range found by binary search, and the build rows no probe row matched.
//
// Replaces: spark_rapids_tpu/plan/join_exec.py:932 BroadcastJoinExec.
// _match_state (the sorted broadcast path: lexsort of the build by
// (validity, key image), two searchsorted per probe batch) with :1674
// _float_orderable, and :626 SortMergeJoinExec._match_state (the union
// group-id kernel of the shuffled join) with :750 _unmatched_build_mask.
// Both produce (lo, matches, b_perm): the build rows ordered by key, each
// key's rows in build order, and per probe row its first position and
// count in that order.
//
// Key images: each key column becomes an int64 word whose signed order is
// the reference's: integers, dates and dictionary codes as they are;
// float64 as _float_orderable of f64_bit_pattern (-0.0 and subnormals as
// +0.0, one NaN), float32 likewise over 32 bits.  Equal images are equal
// keys under Spark's join semantics (NaN = NaN, -0.0 = +0.0).
//
// Entry points:
//   sort_build     a stable LSD radix sort of row numbers over (invalid,
//                  key 0, ..., key k-1), radix.cuh's one-sweep sort (shared
//                  with sort.cu): per key from the last, ONE kernel gathers
//                  its images' radix digits in the current order and counts
//                  every byte of them, then one pass kernel per byte (4 for
//                  4-byte keys, 8 for 8-byte ones); last the invalid flag
//                  (a dead row or a null key) as a 1-byte word, so invalid
//                  rows park at the end, ordered by key.  A byte whose
//                  digit is the same in every row (a constant high byte,
//                  the flag when every row is valid) is skipped on the
//                  device: its pass kernel reads the byte's counts and
//                  exits.  Outputs the sorted images of every key, b_perm
//                  and n_valid (the valid rows, counted by a block
//                  reduction).
//   sort_probe     one thread per probe row: lower and upper bound of its
//                  key tuple in the sorted images [0, n_valid) by binary
//                  search, giving lo and matches (0 for a dead or null-key
//                  row, lo = -1 without a match); semi and anti write the
//                  selection, inner and outer joins the row's output count
//                  (an outer join's miss counts 1, a dead row 0).
//   sort_unmatched marks b_perm[lo, lo + matches) of every probe row as
//                  hit, then writes the live build rows no probe row hit
//                  and counts them (a full outer join's unmatched build
//                  rows).
//
// Bound: device memory.  The build moves 24 bytes per row and running
// pass (the 8-byte image and 4-byte row number, read and written, in
// coalesced runs) plus one random image read per row and key; a skipped
// pass is one launch whose blocks read 1 KB of counts and exit.  The probe
// reads log2(n_valid) images per row and key at dependent random positions
// (the top levels stay in L2).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "radix.cuh"

#define SJ_THREADS 256
#define SJ_MAX_KEYS 8

#define SJ_INNER 0
#define SJ_SEMI 1
#define SJ_ANTI 2
#define SJ_OUTER 3

#define KIND_INT 0
#define KIND_FLOAT 1

struct SJKeys {
  const void* data[SJ_MAX_KEYS];
  const uint8_t* valid[SJ_MAX_KEYS];  // nullptr: no nulls
  int elem[SJ_MAX_KEYS];              // 4 or 8
  int kind[SJ_MAX_KEYS];
  int nkeys;
};

// ---------------------------------------------------------------------------
// key images
// ---------------------------------------------------------------------------

__device__ __forceinline__ long long image(const SJKeys& k, int c,
                                           long long r) {
  const void* p = k.data[c];
  if (k.kind[c] == KIND_FLOAT) {
    if (k.elem[c] == 8) {
      const double d = static_cast<const double*>(p)[r];
      long long b;
      if (d != d)
        b = 0x7ff8000000000000ll;
      else if (fabs(d) < 2.2250738585072014e-308)
        b = 0;
      else
        b = __double_as_longlong(d);
      return b < 0 ? ~b : (long long)((unsigned long long)b | 0x8000000000000000ull);
    }
    const float d = static_cast<const float*>(p)[r];
    int b;
    if (d != d)
      b = INT_MAX;
    else if (fabsf(d) < 1.17549435e-38f)
      b = 0;
    else
      b = __float_as_int(d);
    return (long long)(b < 0 ? ~b : (int)((unsigned int)b | 0x80000000u));
  }
  return k.elem[c] == 8 ? static_cast<const long long*>(p)[r]
                        : (long long)static_cast<const int*>(p)[r];
}

__device__ __forceinline__ bool row_valid(const SJKeys& k,
                                          const uint8_t* active,
                                          long long r) {
  if (active != nullptr && !active[r]) return false;
  for (int c = 0; c < k.nkeys; ++c)
    if (k.valid[c] != nullptr && !k.valid[c][r]) return false;
  return true;
}

// The image's radix digits as an unsigned word: its signed order becomes
// unsigned (4-byte keys: their low 32 bits).
__device__ __forceinline__ unsigned long long radix_word(long long s,
                                                         int elem) {
  return elem == 8 ? (unsigned long long)s ^ 0x8000000000000000ull
                   : (unsigned long long)((unsigned int)s ^ 0x80000000u);
}

// ---------------------------------------------------------------------------
// build: flags, images in the current order
// ---------------------------------------------------------------------------

// flag[r] = 0 for a valid row, 1 otherwise; n_valid += valid rows.
__global__ void __launch_bounds__(SJ_THREADS)
sj_flags(const __grid_constant__ SJKeys k, const uint8_t* __restrict__ active,
         long long n, unsigned long long* __restrict__ flags,
         unsigned long long* __restrict__ n_valid) {
  __shared__ unsigned long long s_cnt[SJ_THREADS / 32];
  unsigned long long cnt = 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += stride) {
    const bool ok = row_valid(k, active, r);
    flags[r] = ok ? 0ull : 1ull;
    cnt += ok;
  }
  for (int o = 16; o > 0; o >>= 1) cnt += __shfl_down_sync(0xffffffffu, cnt, o);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) s_cnt[warp] = cnt;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < SJ_THREADS / 32; ++w) cnt += s_cnt[w];
    if (cnt) atomicAdd(n_valid, cnt);
  }
}

// The radix digits of key c's image at row r, or (flags != nullptr) the
// invalid flag of row r.
struct SJWord {
  SJKeys k;
  int c;
  const unsigned long long* flags;
  __device__ __forceinline__ unsigned long long operator()(long long r) const {
    return flags != nullptr ? flags[r]
                            : radix_word(image(k, c, r), k.elem[c]);
  }
};

// b_perm[i] = the row at sorted position i (the current side after pass
// p - 1); out[c][i] = image of key c at that row.
__global__ void __launch_bounds__(SJ_THREADS)
sj_sorted_images(const __grid_constant__ SJKeys k,
                 const __grid_constant__ OSBufs b,
                 const int* __restrict__ state, int p, long long n,
                 int* __restrict__ b_perm, long long* __restrict__ out) {
  const int* __restrict__ perm = b.vals[state[p]];
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int r = perm[i];
    b_perm[i] = r;
    for (int c = 0; c < k.nkeys; ++c) out[(long long)c * n + i] = image(k, c, r);
  }
}

// ---------------------------------------------------------------------------
// probe
// ---------------------------------------------------------------------------

struct SJSorted {
  const long long* words;  // [nkeys][nb] sorted images
  long long nb;
  const unsigned long long* n_valid;
};

// -1, 0, 1: the probe tuple against sorted position j.
__device__ __forceinline__ int cmp_tuple(const SJSorted& s,
                                         const long long* img, int nkeys,
                                         long long j) {
  for (int c = 0; c < nkeys; ++c) {
    const long long w = s.words[(long long)c * s.nb + j];
    if (img[c] < w) return -1;
    if (img[c] > w) return 1;
  }
  return 0;
}

__global__ void __launch_bounds__(SJ_THREADS)
sj_probe(const __grid_constant__ SJKeys k, const uint8_t* __restrict__ active,
         long long n, const __grid_constant__ SJSorted s, int mode,
         int* __restrict__ lo_out, int* __restrict__ matches_out,
         int* __restrict__ cnt, uint8_t* __restrict__ sel) {
  const long long nv = (long long)*s.n_valid;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += stride) {
    const bool live = active == nullptr || active[r];
    long long first = 0, m = 0;
    if (row_valid(k, active, r) && nv > 0) {
      long long img[SJ_MAX_KEYS];
      for (int c = 0; c < k.nkeys; ++c) img[c] = image(k, c, r);
      long long a = 0, b = nv;  // lower bound
      while (a < b) {
        const long long mid = (a + b) >> 1;
        if (cmp_tuple(s, img, k.nkeys, mid) > 0) a = mid + 1; else b = mid;
      }
      first = a;
      b = nv;  // upper bound
      while (a < b) {
        const long long mid = (a + b) >> 1;
        if (cmp_tuple(s, img, k.nkeys, mid) >= 0) a = mid + 1; else b = mid;
      }
      m = a - first;
    }
    lo_out[r] = m > 0 ? (int)first : -1;
    matches_out[r] = (int)m;
    if (mode == SJ_SEMI) {
      sel[r] = m > 0;
    } else if (mode == SJ_ANTI) {
      sel[r] = live && m == 0;
    } else if (cnt != nullptr) {
      cnt[r] = mode == SJ_OUTER ? (live ? (m > 0 ? (int)m : 1) : 0) : (int)m;
    }
  }
}

// ---------------------------------------------------------------------------
// unmatched build rows
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(SJ_THREADS)
sj_mark(const int* __restrict__ lo, const int* __restrict__ matches,
        long long n, const int* __restrict__ b_perm,
        uint8_t* __restrict__ hit) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += stride) {
    const int m = matches[r];
    for (int j = 0; j < m; ++j) hit[b_perm[lo[r] + j]] = 1;
  }
}

__global__ void __launch_bounds__(SJ_THREADS)
sj_unhit(const uint8_t* __restrict__ hit, const uint8_t* __restrict__ active,
         long long nb, uint8_t* __restrict__ mask,
         unsigned long long* __restrict__ count) {
  __shared__ unsigned long long s_cnt[SJ_THREADS / 32];
  unsigned long long cnt = 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < nb;
       r += stride) {
    const bool out = (active == nullptr || active[r]) && !hit[r];
    mask[r] = out;
    cnt += out;
  }
  for (int o = 16; o > 0; o >>= 1) cnt += __shfl_down_sync(0xffffffffu, cnt, o);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) s_cnt[warp] = cnt;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < SJ_THREADS / 32; ++w) cnt += s_cnt[w];
    if (cnt) atomicAdd(count, cnt);
  }
}

// ---------------------------------------------------------------------------
// host entries (ctypes); pointer arrays are host arrays of device pointers;
// each returns cudaGetLastError() after its launches (0 = launched)
// ---------------------------------------------------------------------------

static cudaError_t grid_for(long long n, int per_sm, int* blocks) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long want = (n + SJ_THREADS - 1) / SJ_THREADS;
  const long long cap = (long long)sms * per_sm;
  *blocks = (int)(want < 1 ? 1 : (want < cap ? want : cap));
  return cudaSuccess;
}

static int fill_keys(SJKeys* k, int nkeys, const void* const* data,
                     const void* const* valid, const int* elems,
                     const int* kinds) {
  if (nkeys < 1 || nkeys > SJ_MAX_KEYS) return 0;
  for (int c = 0; c < nkeys; ++c) {
    if ((elems[c] != 4 && elems[c] != 8) ||
        (kinds[c] != KIND_INT && kinds[c] != KIND_FLOAT))
      return 0;
    k->data[c] = data[c];
    k->valid[c] = static_cast<const uint8_t*>(valid[c]);
    k->elem[c] = elems[c];
    k->kind[c] = kinds[c];
  }
  k->nkeys = nkeys;
  return 1;
}

// Scratch bytes of sort_build for n rows and `passes` passes (the keys'
// bytes + 1): the one-sweep sort's, then the [n] uint64 flags.
extern "C" long long sort_build_scratch(long long n, int passes) {
  return (long long)(os_scratch(n, passes, nullptr, nullptr) +
                     os_align((size_t)(n > 0 ? n : 1) * 8));
}

// Sorts the n build rows.  words: [nkeys][n] int64 out (sorted images);
// b_perm: [n] int32 out; n_valid: one uint64 word, zeroed by the caller;
// scratch: sort_build_scratch(n, sum of elems + 1) bytes.
extern "C" int sort_build(int nkeys, const void* const* data,
                          const void* const* valid, const int* elems,
                          const int* kinds, const void* active, long long n,
                          void* words, void* b_perm, void* n_valid,
                          void* scratch, long long scratch_bytes,
                          void* stream) {
  SJKeys k = {};
  if (!fill_keys(&k, nkeys, data, valid, elems, kinds) || n < 0 ||
      n >= INT_MAX)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  int passes = 1;
  for (int c = 0; c < nkeys; ++c) passes += k.elem[c];
  OSScratch sc;
  const size_t sort_bytes = os_scratch(n, passes, scratch, &sc);
  if (scratch == nullptr ||
      sort_build_scratch(n, passes) > scratch_bytes)
    return (int)cudaErrorInvalidValue;
  unsigned long long* fl = reinterpret_cast<unsigned long long*>(
      static_cast<char*>(scratch) + sort_bytes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* act = static_cast<const uint8_t*>(active);
  int blocks = 1, hblocks = 1;
  cudaError_t err = grid_for(n, 8, &blocks);
  if (err == cudaSuccess) err = os_hist_blocks(n, &hblocks);
  if (err == cudaSuccess) err = os_clear(sc, s);
  if (err != cudaSuccess) return (int)err;
  sj_flags<<<blocks, SJ_THREADS, 0, s>>>(
      k, act, n, fl, static_cast<unsigned long long*>(n_valid));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  int p = 0;
  // each key's bytes from the last key, then the invalid flag
  for (int step = 0; step <= nkeys; ++step) {
    const bool flag_pass = step == nkeys;
    SJWord src;
    src.k = k;
    src.c = flag_pass ? 0 : nkeys - 1 - step;
    src.flags = flag_pass ? fl : nullptr;
    const int bytes = flag_pass ? 1 : k.elem[src.c];
    os_gather_hist<SJWord><<<hblocks, OS_HIST_THREADS, 0, s>>>(
        sc.b, sc.state, p, p == 0, src, bytes, n, sc.hist);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    for (int b = 0; b < bytes; ++b, ++p) {
      err = os_pass_launch(sc, p, n, 8 * b, s);
      if (err != cudaSuccess) return (int)err;
    }
  }
  sj_sorted_images<<<blocks, SJ_THREADS, 0, s>>>(
      k, sc.b, sc.state, p, n, static_cast<int*>(b_perm),
      static_cast<long long*>(words));
  return (int)cudaGetLastError();
}

// mode 0 inner, 1 semi, 2 anti, 3 outer.  lo, matches: [n] int32 out;
// cnt: [n] int32 out (inner, outer; may be nullptr); sel: [n] out (semi,
// anti).  words: [nkeys][nb] from sort_build; n_valid its device word.
extern "C" int sort_probe(int nkeys, const void* const* data,
                          const void* const* valid, const int* elems,
                          const int* kinds, const void* active, long long n,
                          const void* words, long long nb,
                          const void* n_valid, int mode, void* lo,
                          void* matches, void* cnt, void* sel,
                          void* stream) {
  SJKeys k = {};
  if (!fill_keys(&k, nkeys, data, valid, elems, kinds) || n < 0 || nb < 0 ||
      mode < SJ_INNER || mode > SJ_OUTER || lo == nullptr ||
      matches == nullptr ||
      ((mode == SJ_SEMI || mode == SJ_ANTI) && sel == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  SJSorted sorted;
  sorted.words = static_cast<const long long*>(words);
  sorted.nb = nb;
  sorted.n_valid = static_cast<const unsigned long long*>(n_valid);
  int blocks = 1;
  cudaError_t err = grid_for(n, 16, &blocks);
  if (err != cudaSuccess) return (int)err;
  sj_probe<<<blocks, SJ_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      k, static_cast<const uint8_t*>(active), n, sorted, mode,
      static_cast<int*>(lo), static_cast<int*>(matches),
      static_cast<int*>(cnt), static_cast<uint8_t*>(sel));
  return (int)cudaGetLastError();
}

// hit: [nb] uint8 scratch, zeroed by the caller; mask: [nb] out; count: one
// uint64 word, zeroed by the caller.
extern "C" int sort_unmatched(const void* lo, const void* matches,
                              long long n, const void* b_perm, long long nb,
                              const void* active, void* hit, void* mask,
                              void* count, void* stream) {
  if (n < 0 || nb < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int blocks = 1;
  cudaError_t err;
  if (n > 0) {
    err = grid_for(n, 16, &blocks);
    if (err != cudaSuccess) return (int)err;
    sj_mark<<<blocks, SJ_THREADS, 0, s>>>(
        static_cast<const int*>(lo), static_cast<const int*>(matches), n,
        static_cast<const int*>(b_perm), static_cast<uint8_t*>(hit));
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (nb == 0) return (int)cudaSuccess;
  err = grid_for(nb, 8, &blocks);
  if (err != cudaSuccess) return (int)err;
  sj_unhit<<<blocks, SJ_THREADS, 0, s>>>(
      static_cast<const uint8_t*>(hit), static_cast<const uint8_t*>(active),
      nb, static_cast<uint8_t*>(mask),
      static_cast<unsigned long long*>(count));
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
