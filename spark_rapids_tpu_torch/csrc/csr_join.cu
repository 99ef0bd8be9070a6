// csr_join: the broadcast join over a build side that repeats keys — the
// starts of each slot of the key domain and a stable build permutation,
// the probe, the expansion into gather maps, and the gathers; and the
// stable placement of rows by partition id of a shuffle exchange.
//
// Replaces: spark_rapids_tpu/plan/join_exec.py:1040 _csr_match_state (the
// counts/starts tables over key - kmin and the stable lexsort of build rows
// by slot, :1085; the probe's (lo, matches)), :690 _semi_anti, :697
// _outer_join with :1649 _expand_rows (the gather maps pi, bi with -1 for a
// left join's unmatched rows), and :1904 _gather_cols.
//
// Entry points, in the order a join calls them:
//   csr_build      per build row its slot key - kmin, or D when the row is
//                  dead, null or outside the domain (CJWord, computed where
//                  it is read); a stable LSD sort of the rows by slot on
//                  radix.cuh's one-sweep pass: one counting kernel over all
//                  of the slot's bytes, then one pass kernel per byte of
//                  bit_length(D), the first reading the keys itself (a
//                  constant byte exits on the device); then cj_starts, a
//                  merge path over the sorted slots and the slot numbers
//                  0..D, writes starts[s] (the first sorted position whose
//                  slot is >= s, so every empty slot too, and starts[D] the
//                  live rows) and copies the permutation out: b_perm, the
//                  live rows grouped by slot, each slot's rows in build
//                  order, the rows with no slot last, as the reference's
//                  lexsort on (slot, row).  No atomics decide an order, so
//                  the result is fixed; the host launches the same kernels
//                  whatever the data and never waits;
//   csr_probe      per probe row its slot's (lo, matches) from starts[idx]
//                  and starts[idx + 1] (one sector), 0 matches when the row
//                  is dead, null or outside the domain; semi and anti write
//                  the selection (anti keeps null-key rows, as _semi_anti
//                  does); inner and left write the row's output count (a
//                  left join's miss counts 1) and lo (-1: no match);
//   csr_scan       exclusive scan of int32 counts into int64 offsets, with
//                  the total in out[n] (block scans, a scan of the block
//                  sums in one block, and a pass that adds them);
//   csr_expand     the output rows of every probe row: pi = its probe row,
//                  bi = b_perm[lo + k] or -1: expand.cuh's merge path by
//                  output row (shared with cond_join.cu), int64 pi;
//   csr_gather     per output row and column, data and validity gathered
//                  at idx (idx < 0: a null row): a thread reads 4 rows'
//                  indices once, then per column (its element size chosen
//                  once, outside the rows) issues the 4 rows' loads before
//                  it stores them;
//   partition_perm the rows stably ordered by partition id (the id is the
//                  digit: one byte up to 255 partitions), on the one-sweep
//                  pass: a counting kernel, and one pass per byte, the
//                  first reading the ids, the last writing the
//                  permutation.
//
// Bound: device memory.  The build reads the keys and masks twice (the
// count and the first pass), moves 24 B a row in each later pass (8-byte
// word and 4-byte row number, read and written) and 16 B a row into
// b_perm, plus 8 B a slot of starts; the probe reads each probe row's key
// and one 32-byte sector of starts; the expansion writes 12 B per output
// row and reads one 4 B b_perm word per match (a key's rows are
// contiguous); the gathers read one sector per output row and column.
//
// Keys are int32 or int64 (dates are int32 days).  Row numbers are int32
// (the build side has fewer than 2^31 rows); offsets are int64.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "expand.cuh"
#include "radix.cuh"

#define CJ_THREADS 256
#define CJ_MAX_COLS 16
#define CJ_TILE 2048          // merge-path items a block (8 a thread)
#define CJ_GATHER_ROWS 4      // rows a thread of csr_gather
#define SCAN_THREADS 512
#define SCAN_ITEMS 8
#define SCAN_TILE (SCAN_THREADS * SCAN_ITEMS)

#define CJ_INNER 0
#define CJ_SEMI 1
#define CJ_ANTI 2
#define CJ_LEFT 3

__device__ __forceinline__ long long load_key(const void* p, int elem,
                                              long long r) {
  return elem == 8 ? static_cast<const long long*>(p)[r]
                   : (long long)static_cast<const int*>(p)[r];
}

// True when key k lies in [kmin, kmin + D); idx receives k - kmin.
__device__ __forceinline__ bool in_domain(long long k, long long kmin,
                                          long long D, long long* idx) {
  if (k < kmin) return false;
  const unsigned long long d =
      (unsigned long long)k - (unsigned long long)kmin;
  if (d >= (unsigned long long)D) return false;
  *idx = (long long)d;
  return true;
}

// ---------------------------------------------------------------------------
// Build: the slot of a row, the sort, the starts
// ---------------------------------------------------------------------------

// The slot of build row r: key - kmin, or D for a dead, null or
// out-of-domain row.
struct CJWord {
  const void* keys;
  const uint8_t* key_valid;
  const uint8_t* active;
  long long kmin, D;
  int elem;
  __device__ __forceinline__ unsigned long long operator()(long long r) const {
    long long idx = D;
    if ((active == nullptr || active[r]) &&
        (key_valid == nullptr || key_valid[r]))
      in_domain(load_key(keys, elem, r), kmin, D, &idx);
    return (unsigned long long)idx;
  }
};

// The merge path of the sorted slots (n rows, each in [0, D]) and the slot
// numbers 0..D: slot s comes before row i when s <= slot(i).  Block b takes
// items [b CJ_TILE, (b + 1) CJ_TILE) of the merged sequence: rows
// [i0, i1) and slots [s0, s1); starts[s] = i0 + the rows of [i0, i1)
// whose slot is below s, found by binary search in shared memory; and
// b_perm[i] = the row at sorted position i.
__global__ void __launch_bounds__(CJ_THREADS)
cj_starts(const __grid_constant__ OSBufs b, const int* __restrict__ state,
          int p, long long n, long long D, long long* __restrict__ starts,
          int* __restrict__ b_perm) {
  __shared__ int s_slot[CJ_TILE];
  __shared__ long long s_split[2];
  const int t = threadIdx.x, warp = t >> 5;
  const long long total = n + D + 1;
  const long long d0 = (long long)blockIdx.x * CJ_TILE;
  const long long d1 = d0 + CJ_TILE < total ? d0 + CJ_TILE : total;
  const int side = n > 0 ? state[p] : 0;
  const unsigned long long* __restrict__ slot = b.keys[side];
  if (warp < 2) {
    // rows among the first d items: row i is there when
    // i + slot(i) + 1 < d
    const long long d = warp == 0 ? d0 : d1;
    const long long lo = d - (D + 1) > 0 ? d - (D + 1) : 0;
    const long long hi = d < n ? d : n;
    const long long i = warp_search(
        lo, hi, [&](long long i) { return (long long)slot[i] < d - 1 - i; });
    if ((t & 31) == 0) s_split[warp] = i;
  }
  __syncthreads();
  const long long i0 = s_split[0], i1 = s_split[1];
  const long long s0 = d0 - i0, s1 = d1 - i1;
  const int rows = (int)(i1 - i0);
  const int* __restrict__ perm = b.vals[side];
  for (int k = t; k < rows; k += CJ_THREADS) {
    s_slot[k] = (int)slot[i0 + k];
    b_perm[i0 + k] = perm[i0 + k];
  }
  __syncthreads();
  for (long long s = s0 + t; s < s1; s += CJ_THREADS) {
    int a = 0, z = rows;  // lower bound of s
    while (a < z) {
      const int mid = (a + z) >> 1;
      if (s_slot[mid] < s) a = mid + 1; else z = mid;
    }
    starts[s] = i0 + a;
  }
}

// ---------------------------------------------------------------------------
// Probe
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(CJ_THREADS)
cj_probe(const void* __restrict__ keys, int elem,
         const uint8_t* __restrict__ key_valid,
         const uint8_t* __restrict__ active, long long n, long long kmin,
         long long D, const long long* __restrict__ starts, int mode,
         int* __restrict__ lo, int* __restrict__ cnt,
         uint8_t* __restrict__ sel) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += stride) {
    const bool row_live = active == nullptr || active[r];
    long long idx = 0, first = 0;
    int matches = 0;
    if (row_live && (key_valid == nullptr || key_valid[r]) &&
        in_domain(load_key(keys, elem, r), kmin, D, &idx)) {
      first = starts[idx];
      matches = (int)(starts[idx + 1] - first);
    }
    if (mode == CJ_SEMI) {
      sel[r] = matches > 0;
    } else if (mode == CJ_ANTI) {
      sel[r] = row_live && matches == 0;
    } else {
      lo[r] = matches > 0 ? (int)first : -1;
      cnt[r] = mode == CJ_LEFT ? (row_live ? (matches > 0 ? matches : 1) : 0)
                               : matches;
    }
  }
}

// ---------------------------------------------------------------------------
// Exclusive scan: int32 in, int64 out (out[n] = total)
// ---------------------------------------------------------------------------

// Scans one SCAN_TILE tile per block; writes the tile's total to sums.
__global__ void __launch_bounds__(SCAN_THREADS)
scan_tiles(const int* __restrict__ in, long long* __restrict__ out,
           long long n, long long* __restrict__ sums) {
  __shared__ long long s_warp[SCAN_THREADS / 32];
  const long long base = (long long)blockIdx.x * SCAN_TILE
                         + (long long)threadIdx.x * SCAN_ITEMS;
  long long vals[SCAN_ITEMS];
  long long run = 0;
#pragma unroll
  for (int i = 0; i < SCAN_ITEMS; ++i) {
    const long long r = base + i;
    vals[i] = run;
    run += r < n ? in[r] : 0;
  }
  // block-wide exclusive scan of the per-thread totals
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  long long incl = run;
  for (int o = 1; o < 32; o <<= 1) {
    const long long v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    long long w = lane < SCAN_THREADS / 32 ? s_warp[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const long long v = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += v;
    }
    if (lane < SCAN_THREADS / 32) s_warp[lane] = w;  // inclusive per warp
  }
  __syncthreads();
  const long long offset =
      (incl - run) + (warp > 0 ? s_warp[warp - 1] : 0);
#pragma unroll
  for (int i = 0; i < SCAN_ITEMS; ++i) {
    const long long r = base + i;
    if (r < n) out[r] = offset + vals[i];
  }
  if (threadIdx.x == SCAN_THREADS - 1)
    sums[blockIdx.x] = offset + run;
}

// One block: exclusive scan of the tile totals in place, chunk by chunk
// with a carry; total[0] receives the grand total.
__global__ void __launch_bounds__(1024)
scan_sums(long long* __restrict__ sums, long long nb,
          long long* __restrict__ total) {
  __shared__ long long s_warp[32];
  __shared__ long long s_carry;
  if (threadIdx.x == 0) s_carry = 0;
  __syncthreads();
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (long long c = 0; c < nb; c += 1024) {
    const long long r = c + threadIdx.x;
    const long long v = r < nb ? sums[r] : 0;
    long long incl = v;
    for (int o = 1; o < 32; o <<= 1) {
      const long long u = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += u;
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      long long w = s_warp[lane];
      for (int o = 1; o < 32; o <<= 1) {
        const long long u = __shfl_up_sync(0xffffffffu, w, o);
        if (lane >= o) w += u;
      }
      s_warp[lane] = w;
    }
    __syncthreads();
    const long long excl = s_carry + incl - v
                           + (warp > 0 ? s_warp[warp - 1] : 0);
    if (r < nb) sums[r] = excl;
    __syncthreads();
    if (threadIdx.x == 1023) s_carry = excl + v;
    __syncthreads();
  }
  if (threadIdx.x == 0) *total = s_carry;
}

__global__ void __launch_bounds__(SCAN_THREADS)
scan_add(long long* __restrict__ out, long long n,
         const long long* __restrict__ sums) {
  const long long add = sums[blockIdx.x];
  const long long base = (long long)blockIdx.x * SCAN_TILE;
  for (int i = threadIdx.x; i < SCAN_TILE; i += SCAN_THREADS) {
    const long long r = base + i;
    if (r < n) out[r] += add;
  }
}

// ---------------------------------------------------------------------------
// Gathers
// ---------------------------------------------------------------------------

struct CJCols {
  const void* data[CJ_MAX_COLS];
  const uint8_t* valid[CJ_MAX_COLS];  // nullptr: the column has no nulls
  void* out[CJ_MAX_COLS];
  uint8_t* out_valid[CJ_MAX_COLS];    // nullptr: no output validity
  int elem[CJ_MAX_COLS];
  int ncols;
};

// One column's element at CJ_GATHER_ROWS rows: every load issued, then
// every store.
template <typename T>
__device__ __forceinline__ void gather_rows(void* dst, const void* src,
                                            const long long (&row)[CJ_GATHER_ROWS],
                                            const long long (&at)[CJ_GATHER_ROWS],
                                            unsigned ok, unsigned in) {
  T x[CJ_GATHER_ROWS];
#pragma unroll
  for (int u = 0; u < CJ_GATHER_ROWS; ++u)
    x[u] = (ok >> u) & 1u ? static_cast<const T*>(src)[at[u]] : T(0);
#pragma unroll
  for (int u = 0; u < CJ_GATHER_ROWS; ++u)
    if ((in >> u) & 1u) static_cast<T*>(dst)[row[u]] = x[u];
}

// idx is int64 (IDX 8: pi) or int32 (IDX 4: bi).  Thread t of a block
// takes rows base + t + u CJ_THREADS, u < CJ_GATHER_ROWS.
template <int IDX>
__global__ void __launch_bounds__(CJ_THREADS)
cj_gather(const __grid_constant__ CJCols c, const void* __restrict__ idx,
          long long n) {
  const long long tile = (long long)CJ_THREADS * CJ_GATHER_ROWS;
  for (long long base = (long long)blockIdx.x * tile; base < n;
       base += (long long)gridDim.x * tile) {
    long long row[CJ_GATHER_ROWS], at[CJ_GATHER_ROWS];
    unsigned in = 0, ok = 0;
#pragma unroll
    for (int u = 0; u < CJ_GATHER_ROWS; ++u) {
      row[u] = base + threadIdx.x + (long long)u * CJ_THREADS;
      at[u] = -1;
      if (row[u] < n) {
        in |= 1u << u;
        at[u] = IDX == 8 ? static_cast<const long long*>(idx)[row[u]]
                         : (long long)static_cast<const int*>(idx)[row[u]];
        if (at[u] >= 0) ok |= 1u << u;
      }
    }
    for (int j = 0; j < c.ncols; ++j) {
      switch (c.elem[j]) {
        case 8: gather_rows<long long>(c.out[j], c.data[j], row, at, ok, in);
                break;
        case 4: gather_rows<int>(c.out[j], c.data[j], row, at, ok, in);
                break;
        case 2: gather_rows<short>(c.out[j], c.data[j], row, at, ok, in);
                break;
        default: gather_rows<uint8_t>(c.out[j], c.data[j], row, at, ok, in);
      }
      uint8_t* ov = c.out_valid[j];
      if (ov == nullptr) continue;
      const uint8_t* v = c.valid[j];
      uint8_t x[CJ_GATHER_ROWS];
#pragma unroll
      for (int u = 0; u < CJ_GATHER_ROWS; ++u)
        x[u] = (ok >> u) & 1u ? (v == nullptr ? 1 : v[at[u]]) : 0;
#pragma unroll
      for (int u = 0; u < CJ_GATHER_ROWS; ++u)
        if ((in >> u) & 1u) ov[row[u]] = x[u] != 0;
    }
  }
}

// ---------------------------------------------------------------------------
// Partition placement
// ---------------------------------------------------------------------------

// A row's partition id in [0, nparts] as the sort word.
struct PPWord {
  const int* pids;
  __device__ __forceinline__ unsigned long long operator()(long long r) const {
    return (unsigned long long)(unsigned)pids[r];
  }
};

// ---------------------------------------------------------------------------
// Host entries, bound with ctypes; every pointer but the column pointer
// arrays points to device memory.  Each returns cudaGetLastError() after
// its launches (0 = launched).
// ---------------------------------------------------------------------------

static cudaError_t grid_for(long long n, int* blocks, int per_sm) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long want = (n + CJ_THREADS - 1) / CJ_THREADS;
  const long long cap = (long long)sms * per_sm;
  *blocks = (int)(want < 1 ? 1 : (want < cap ? want : cap));
  return cudaSuccess;
}

// One-sweep passes of a value below 2^(8 bytes): the bytes of
// bit_length(max).
static int sort_bytes(long long max) {
  int bits = 0;
  while (bits < 63 && (max >> bits) != 0) ++bits;
  return bits == 0 ? 1 : (bits + 7) / 8;
}

// Scratch bytes of csr_build for n build rows over D slots.
extern "C" long long csr_build_scratch(long long n, long long D) {
  return (long long)os_scratch(n, sort_bytes(D), nullptr, nullptr);
}

// starts: [D + 1] int64 out; b_perm: [n] int32 out; scratch:
// csr_build_scratch(n, D) bytes.
extern "C" int csr_build(const void* keys, int elem, const void* key_valid,
                         const void* active, long long n, long long kmin,
                         long long D, void* starts, void* b_perm,
                         void* scratch, long long scratch_bytes,
                         void* stream) {
  if ((elem != 4 && elem != 8) || D < 1 || D >= INT_MAX || n < 0 ||
      n >= INT_MAX || csr_build_scratch(n, D) > scratch_bytes ||
      scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int passes = sort_bytes(D);
  OSScratch sc;
  os_scratch(n, passes, scratch, &sc);
  cudaError_t err;
  if (n > 0) {
    CJWord src;
    src.keys = keys;
    src.key_valid = static_cast<const uint8_t*>(key_valid);
    src.active = static_cast<const uint8_t*>(active);
    src.kmin = kmin;
    src.D = D;
    src.elem = elem;
    int hblocks = 1;
    err = os_hist_blocks(n, &hblocks);
    if (err == cudaSuccess) err = os_clear(sc, s);
    if (err != cudaSuccess) return (int)err;
    os_gather_hist<CJWord, false><<<hblocks, OS_HIST_THREADS, 0, s>>>(
        sc.b, sc.state, 0, 1, src, passes, n, sc.hist);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    for (int p = 0; p < passes; ++p) {
      err = os_pass_launch_src(sc, p, n, 8 * p, s, src, p == 0, nullptr);
      if (err != cudaSuccess) return (int)err;
    }
  }
  const long long tiles = (n + D + 1 + CJ_TILE - 1) / CJ_TILE;
  cj_starts<<<(unsigned)tiles, CJ_THREADS, 0, s>>>(
      sc.b, sc.state, passes, n, D, static_cast<long long*>(starts),
      static_cast<int*>(b_perm));
  return (int)cudaGetLastError();
}

// out: [n + 1] int64; sums: ceil(n / SCAN_TILE) int64 words of scratch.
extern "C" int csr_scan(const void* in, long long n, void* out, void* sums,
                        void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long nb = n <= 0 ? 1 : (n + SCAN_TILE - 1) / SCAN_TILE;
  long long* o = static_cast<long long*>(out);
  long long* sm = static_cast<long long*>(sums);
  scan_tiles<<<(unsigned)nb, SCAN_THREADS, 0, s>>>(
      static_cast<const int*>(in), o, n, sm);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scan_sums<<<1, 1024, 0, s>>>(sm, nb, o + n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scan_add<<<(unsigned)nb, SCAN_THREADS, 0, s>>>(o, n, sm);
  return (int)cudaGetLastError();
}

// mode 1/2 (semi, anti): sel [n]; mode 0/3 (inner, left): lo, cnt [n].
// starts: [D + 1] from csr_build.
extern "C" int csr_probe(const void* keys, int elem, const void* key_valid,
                         const void* active, long long n, long long kmin,
                         long long D, const void* starts, int mode, void* lo,
                         void* cnt, void* sel, void* stream) {
  if ((elem != 4 && elem != 8) || D < 1 || mode < CJ_INNER
      || mode > CJ_LEFT)
    return (int)cudaErrorInvalidValue;
  if ((mode == CJ_SEMI || mode == CJ_ANTI) ? sel == nullptr
                                           : (lo == nullptr || cnt == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  int blocks = 1;
  cudaError_t err = grid_for(n, &blocks, 16);
  if (err != cudaSuccess) return (int)err;
  cj_probe<<<blocks, CJ_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      keys, elem, static_cast<const uint8_t*>(key_valid),
      static_cast<const uint8_t*>(active), n, kmin, D,
      static_cast<const long long*>(starts), mode, static_cast<int*>(lo),
      static_cast<int*>(cnt), static_cast<uint8_t*>(sel));
  return (int)cudaGetLastError();
}

// offsets: [n + 1] int64 (csr_scan of the probe's counts), total =
// offsets[n] (the caller's one fetch); pi: int64, bi: int32, both [total].
extern "C" int csr_expand(const void* offsets, const void* lo,
                          const void* b_perm, long long n, long long total,
                          void* pi, void* bi, void* stream) {
  if (n < 0 || total < 0) return (int)cudaErrorInvalidValue;
  return (int)ex_expand_launch<long long>(offsets, lo, b_perm, n, total, pi,
                                          bi,
                                          static_cast<cudaStream_t>(stream));
}

extern "C" int csr_gather(const void* idx, int idx_elem, long long n,
                          int ncols, const void* const* data,
                          const void* const* valid, const int* elems,
                          void* const* out, void* const* out_valid,
                          void* stream) {
  if ((idx_elem != 4 && idx_elem != 8) || ncols < 0 || ncols > CJ_MAX_COLS)
    return (int)cudaErrorInvalidValue;
  CJCols c = {};
  for (int j = 0; j < ncols; ++j) {
    const int e = elems[j];
    if (e != 1 && e != 2 && e != 4 && e != 8)
      return (int)cudaErrorInvalidValue;
    c.data[j] = data[j];
    c.valid[j] = static_cast<const uint8_t*>(valid[j]);
    c.out[j] = out[j];
    c.out_valid[j] = static_cast<uint8_t*>(out_valid[j]);
    c.elem[j] = e;
  }
  c.ncols = ncols;
  if (n == 0 || ncols == 0) return (int)cudaSuccess;
  int blocks = 1;
  cudaError_t err =
      grid_for((n + CJ_GATHER_ROWS - 1) / CJ_GATHER_ROWS, &blocks, 16);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (idx_elem == 8)
    cj_gather<8><<<blocks, CJ_THREADS, 0, s>>>(c, idx, n);
  else
    cj_gather<4><<<blocks, CJ_THREADS, 0, s>>>(c, idx, n);
  return (int)cudaGetLastError();
}

// Scratch bytes of partition_perm for n rows and ids up to nparts.
extern "C" long long partition_perm_scratch(long long n, long long nparts) {
  const int passes = sort_bytes(nparts);
  return (long long)os_scratch(n, passes, nullptr, nullptr, passes > 1);
}

// pids: [n] int32 in [0, nparts]; perm: [n] int32 out; scratch:
// partition_perm_scratch(n, nparts) bytes.
extern "C" int partition_perm(const void* pids, long long n, long long nparts,
                              void* perm, void* scratch,
                              long long scratch_bytes, void* stream) {
  if (n < 0 || n >= INT_MAX || nparts < 0 || nparts >= INT_MAX ||
      scratch == nullptr || partition_perm_scratch(n, nparts) > scratch_bytes)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int passes = sort_bytes(nparts);
  OSScratch sc;
  os_scratch(n, passes, scratch, &sc, passes > 1);
  PPWord src;
  src.pids = static_cast<const int*>(pids);
  int hblocks = 1;
  cudaError_t err = os_hist_blocks(n, &hblocks);
  if (err == cudaSuccess) err = os_clear(sc, s);
  if (err != cudaSuccess) return (int)err;
  os_gather_hist<PPWord, false><<<hblocks, OS_HIST_THREADS, 0, s>>>(
      sc.b, sc.state, 0, 1, src, passes, n, sc.hist);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  for (int p = 0; p < passes; ++p) {
    err = os_pass_launch_src(sc, p, n, 8 * p, s, src, p == 0,
                             p == passes - 1 ? static_cast<int*>(perm)
                                             : nullptr);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
