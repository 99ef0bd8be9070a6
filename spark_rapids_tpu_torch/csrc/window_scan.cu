// window_scan: the segment structure of a window's sorted rows and the
// segmented scans its functions are built from.
//
// Replaces: spark_rapids_tpu/ops/window.py:35 SortedWindowContext (segment
// and peer starts from groupby.py:174 _segment_starts, their positions by
// cummax/cummin), :95-133 the rank family, :135 shift (lag/lead), :159
// _segmented_scan, :171 running_sum, :177 running_minmax and :187
// partition_reduce.  The rows come in (partition keys, order keys) order
// from sort.cu; every output is in that order.
//
// Entry points:
//   win_flags      seg_start[i] = row i starts a partition (a partition key
//                  differs from row i - 1), peer_start[i] = it starts a
//                  peer group (a partition or order key differs).  Keys
//                  compare by order.cuh's view; two nulls are equal
//                  whatever their payload, a null and a value differ.
//   win_scan       an inclusive scan, three phases: per-tile aggregates,
//                  one block that scans them into per-tile carries, and a
//                  pass that rescans each tile from its carry.  Values are
//                  int32, int64 or float64 (sum, min or max; min/max
//                  propagate NaN as jnp.minimum/maximum do) and reset at
//                  partition starts; or they are generated from the flags:
//                  start positions (forward max of i where a group starts),
//                  end positions (backward min of i where a group ends) and
//                  the count of peer starts within a partition (dense
//                  rank).
//   win_take       out[i] = src[idx[i]]: a partition reduction (the scan at
//                  the partition's last row) or a RANGE running frame (the
//                  scan at the peer group's last row) gathered back.
//   win_rank       row_number, rank, dense_rank, percent_rank, cume_dist
//                  and ntile, elementwise from the positions.
//   win_shift      lag/lead: the value `offset` rows back within the
//                  partition, else the default (a column) or null.
//
// Bound: device memory.  A scan reads its input twice (the tile aggregates,
// then the rescan) and writes once; the carries are ~1/2048 of the rows.
// Simple first: a thread scans 8 consecutive rows, so a warp's loads are
// strided by 8 elements (L1 absorbs most of it).

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "order.cuh"

#define WS_THREADS 256
#define WS_ITEMS 8
#define WS_TILE (WS_THREADS * WS_ITEMS)
#define WS_CARRY_THREADS 1024
#define WS_MAX_KEYS 16

#define WS_SUM 0
#define WS_MIN 1
#define WS_MAX 2

#define WS_LD_VALUES 0
#define WS_LD_START_POS 1
#define WS_LD_END_POS 2
#define WS_LD_FLAG_COUNT 3

#define WS_T_I32 0
#define WS_T_I64 1
#define WS_T_F64 2

static cudaError_t ws_grid(long long n, int per_sm, int* blocks) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long want = (n + WS_THREADS - 1) / WS_THREADS;
  const long long cap = (long long)sms * per_sm;
  *blocks = (int)(want < 1 ? 1 : (want < cap ? want : cap));
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// flags
// ---------------------------------------------------------------------------

struct WSKeys {
  const void* data[WS_MAX_KEYS];
  const uint8_t* valid[WS_MAX_KEYS];
  int elem[WS_MAX_KEYS];
  int kind[WS_MAX_KEYS];
  int npart;  // the first npart keys are partition keys
  int nkeys;
};

__device__ __forceinline__ bool ws_key_differs(const WSKeys& k, int c,
                                               long long i) {
  if (k.valid[c] != nullptr) {
    const bool a = k.valid[c][i - 1], b = k.valid[c][i];
    if (a != b) return true;
    if (!a) return false;  // two nulls are one group
  }
  return key_view(k.data[c], k.elem[c], k.kind[c], i - 1) !=
         key_view(k.data[c], k.elem[c], k.kind[c], i);
}

__global__ void __launch_bounds__(WS_THREADS)
ws_flags(const __grid_constant__ WSKeys k, long long n,
         uint8_t* __restrict__ seg_start, uint8_t* __restrict__ peer_start) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    bool seg = i == 0, peer = i == 0;
    if (i > 0) {
      for (int c = 0; c < k.npart && !seg; ++c) seg = ws_key_differs(k, c, i);
      peer = seg;
      for (int c = k.npart; c < k.nkeys && !peer; ++c)
        peer = ws_key_differs(k, c, i);
    }
    seg_start[i] = seg;
    peer_start[i] = peer;
  }
}

// ---------------------------------------------------------------------------
// segmented scan
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ T ws_apply(int op, T a, T b) {
  if (op == WS_SUM) return a + b;
  if (op == WS_MIN) return b < a ? b : a;
  return b > a ? b : a;
}

template <>
__device__ __forceinline__ double ws_apply<double>(int op, double a,
                                                   double b) {
  if (op == WS_SUM) return a + b;
  if (a != a) return a;  // NaN propagates
  if (b != b) return b;
  if (op == WS_MIN) return b < a ? b : a;
  return b > a ? b : a;
}

// (av, af) := (av, af) then (bv, bf): a reset in b discards a.
template <typename T>
__device__ __forceinline__ void ws_then(int op, T& av, int& af, T bv,
                                        int bf) {
  av = bf ? bv : ws_apply<T>(op, av, bv);
  af |= bf;
}

template <typename T>
struct WSIn {
  const T* vals;          // WS_LD_VALUES
  const uint8_t* mask;    // WS_LD_VALUES: rows that contribute (nullptr all)
  const uint8_t* flags;   // the group starts the positions come from;
                          // WS_LD_FLAG_COUNT: the flags counted
  const uint8_t* reset;   // partition starts (nullptr: no resets)
  long long n;
  T identity;
  int op;
  int mode;
  int reverse;            // scan from the last row back
};

template <typename T>
__device__ __forceinline__ long long ws_row(const WSIn<T>& in, long long j) {
  return in.reverse ? in.n - 1 - j : j;
}

template <typename T>
__device__ __forceinline__ void ws_load(const WSIn<T>& in, long long j,
                                        T& v, int& f) {
  const long long i = ws_row(in, j);
  switch (in.mode) {
    case WS_LD_VALUES:
      v = (in.mask == nullptr || in.mask[i]) ? in.vals[i] : in.identity;
      break;
    case WS_LD_START_POS:
      v = in.flags[i] ? (T)i : (T)0;
      break;
    case WS_LD_END_POS:
      v = (i == in.n - 1 || in.flags[i + 1]) ? (T)i : (T)(in.n - 1);
      break;
    default:
      v = (T)in.flags[i];
  }
  f = (in.reset != nullptr && in.reset[i]) ? 1 : 0;
}

// Block-wide exclusive scan of each thread's (v, f); returns the block's
// total in (tv, tf).  Any blockDim.x that is a multiple of 32, <= 1024.
template <typename T>
__device__ __forceinline__ void ws_block_exclusive(int op, T identity, T& v,
                                                   int& f, T& tv, int& tf) {
  __shared__ T s_v[32];
  __shared__ int s_f[32];
  __shared__ T s_tv;
  __shared__ int s_tf;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int warps = blockDim.x / 32;
  T iv = v;
  int iff = f;
  for (int o = 1; o < 32; o <<= 1) {
    const T pv = __shfl_up_sync(0xffffffffu, iv, o);
    const int pf = __shfl_up_sync(0xffffffffu, iff, o);
    if (lane >= o) {
      T a = pv;
      int af = pf;
      ws_then<T>(op, a, af, iv, iff);
      iv = a;
      iff = af;
    }
  }
  T ev = __shfl_up_sync(0xffffffffu, iv, 1);
  int ef = __shfl_up_sync(0xffffffffu, iff, 1);
  if (lane == 0) {
    ev = identity;
    ef = 0;
  }
  if (lane == 31) {
    s_v[warp] = iv;
    s_f[warp] = iff;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    T run = identity;
    int rf = 0;
    for (int w = 0; w < warps; ++w) {
      const T wv = s_v[w];
      const int wf = s_f[w];
      s_v[w] = run;  // exclusive prefix of warp w
      s_f[w] = rf;
      ws_then<T>(op, run, rf, wv, wf);
    }
    s_tv = run;
    s_tf = rf;
  }
  __syncthreads();
  T pv = s_v[warp];
  int pf = s_f[warp];
  ws_then<T>(op, pv, pf, ev, ef);
  v = pv;
  f = pf;
  tv = s_tv;
  tf = s_tf;
  __syncthreads();
}

// Phase 1: each tile's aggregate.
template <typename T>
__global__ void __launch_bounds__(WS_THREADS)
ws_tiles(const __grid_constant__ WSIn<T> in, T* __restrict__ agg_v,
         int* __restrict__ agg_f) {
  const long long base = (long long)blockIdx.x * WS_TILE
                         + (long long)threadIdx.x * WS_ITEMS;
  T v = in.identity;
  int f = 0;
  for (int k = 0; k < WS_ITEMS; ++k) {
    const long long j = base + k;
    if (j >= in.n) break;
    T x;
    int xf;
    ws_load<T>(in, j, x, xf);
    ws_then<T>(in.op, v, f, x, xf);
  }
  T tv;
  int tf;
  ws_block_exclusive<T>(in.op, in.identity, v, f, tv, tf);
  if (threadIdx.x == 0) {
    agg_v[blockIdx.x] = tv;
    agg_f[blockIdx.x] = tf;
  }
}

// Phase 2: one block; the tiles' aggregates become exclusive carries, in
// place, chunk by chunk with a running carry.
template <typename T>
__global__ void __launch_bounds__(WS_CARRY_THREADS)
ws_carries(T* __restrict__ agg_v, int* __restrict__ agg_f, long long nb,
           T identity, int op) {
  __shared__ T s_run;
  __shared__ int s_runf;
  if (threadIdx.x == 0) {
    s_run = identity;
    s_runf = 0;
  }
  __syncthreads();
  for (long long c = 0; c < nb; c += blockDim.x) {
    const long long r = c + threadIdx.x;
    T v = r < nb ? agg_v[r] : identity;
    int f = r < nb ? agg_f[r] : 0;
    T tv;
    int tf;
    ws_block_exclusive<T>(op, identity, v, f, tv, tf);
    T cv = s_run;
    int cf = s_runf;
    ws_then<T>(op, cv, cf, v, f);
    if (r < nb) {
      agg_v[r] = cv;
      agg_f[r] = cf;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      T nv = s_run;
      int nf = s_runf;
      ws_then<T>(op, nv, nf, tv, tf);
      s_run = nv;
      s_runf = nf;
    }
    __syncthreads();
  }
}

// Phase 3: rescan each tile from its carry and write every row.
template <typename T>
__global__ void __launch_bounds__(WS_THREADS)
ws_apply_tiles(const __grid_constant__ WSIn<T> in,
               const T* __restrict__ carry_v, const int* __restrict__ carry_f,
               T* __restrict__ out) {
  const long long base = (long long)blockIdx.x * WS_TILE
                         + (long long)threadIdx.x * WS_ITEMS;
  T v = in.identity;
  int f = 0;
  for (int k = 0; k < WS_ITEMS; ++k) {
    const long long j = base + k;
    if (j >= in.n) break;
    T x;
    int xf;
    ws_load<T>(in, j, x, xf);
    ws_then<T>(in.op, v, f, x, xf);
  }
  T tv;
  int tf;
  ws_block_exclusive<T>(in.op, in.identity, v, f, tv, tf);
  T run = carry_v[blockIdx.x];
  int rf = carry_f[blockIdx.x];
  ws_then<T>(in.op, run, rf, v, f);
  for (int k = 0; k < WS_ITEMS; ++k) {
    const long long j = base + k;
    if (j >= in.n) break;
    T x;
    int xf;
    ws_load<T>(in, j, x, xf);
    ws_then<T>(in.op, run, rf, x, xf);
    out[ws_row(in, j)] = run;
  }
}

static long long ws_tiles_for(long long n) {
  return n <= 0 ? 1 : (n + WS_TILE - 1) / WS_TILE;
}

template <typename T>
static cudaError_t ws_scan(const WSIn<T>& in, T* out, void* agg_v,
                           int* agg_f, cudaStream_t s) {
  const long long nb = ws_tiles_for(in.n);
  T* av = static_cast<T*>(agg_v);
  ws_tiles<T><<<(unsigned)nb, WS_THREADS, 0, s>>>(in, av, agg_f);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ws_carries<T><<<1, WS_CARRY_THREADS, 0, s>>>(av, agg_f, nb, in.identity,
                                               in.op);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ws_apply_tiles<T><<<(unsigned)nb, WS_THREADS, 0, s>>>(in, av, agg_f, out);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// take, ranks, shift
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(WS_THREADS)
ws_take(const void* __restrict__ src, int elem, const int* __restrict__ idx,
        long long n, void* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const long long r = idx[i];
    if (elem == 8)
      static_cast<long long*>(out)[i] = static_cast<const long long*>(src)[r];
    else if (elem == 4)
      static_cast<int*>(out)[i] = static_cast<const int*>(src)[r];
    else
      static_cast<uint8_t*>(out)[i] = static_cast<const uint8_t*>(src)[r];
  }
}

#define WS_ROW_NUMBER 0
#define WS_RANK 1
#define WS_DENSE_RANK 2
#define WS_PERCENT_RANK 3
#define WS_CUME_DIST 4
#define WS_NTILE 5

struct WSPos {
  const int* seg_start;
  const int* seg_end;
  const int* peer_start;
  const int* peer_end;
  const int* dense;  // WS_DENSE_RANK: the peer-start count
};

__global__ void __launch_bounds__(WS_THREADS)
ws_rank(const __grid_constant__ WSPos p, int fn, long long tiles,
        long long n, void* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const long long s = p.seg_start[i];
    switch (fn) {
      case WS_ROW_NUMBER:
        static_cast<int*>(out)[i] = (int)(i - s + 1);
        break;
      case WS_RANK:
        static_cast<int*>(out)[i] = (int)(p.peer_start[i] - s + 1);
        break;
      case WS_DENSE_RANK:
        static_cast<int*>(out)[i] = p.dense[i];
        break;
      case WS_PERCENT_RANK: {
        const double rows1 = (double)(p.seg_end[i] - s);
        const double r = (double)(p.peer_start[i] - s);
        static_cast<double*>(out)[i] = rows1 > 0 ? r / rows1 : 0.0;
        break;
      }
      case WS_CUME_DIST:
        static_cast<double*>(out)[i] =
            (double)(p.peer_end[i] - s + 1) / (double)(p.seg_end[i] - s + 1);
        break;
      default: {  // Spark NTile: the first size % tiles buckets get a row more
        const long long size = p.seg_end[i] - s + 1;
        const long long rn0 = i - s;
        const long long base = size / tiles, rem = size % tiles;
        const long long big = base + 1;
        const long long tile =
            rn0 < big * rem ? rn0 / big
                            : rem + (rn0 - big * rem) / (base > 0 ? base : 1);
        static_cast<int*>(out)[i] = (int)(tile + 1);
      }
    }
  }
}

__device__ __forceinline__ void ws_copy(const void* src, long long r,
                                        void* dst, long long i, int elem) {
  switch (elem) {
    case 1:
      static_cast<uint8_t*>(dst)[i] = static_cast<const uint8_t*>(src)[r];
      break;
    case 2:
      static_cast<uint16_t*>(dst)[i] = static_cast<const uint16_t*>(src)[r];
      break;
    case 4:
      static_cast<uint32_t*>(dst)[i] = static_cast<const uint32_t*>(src)[r];
      break;
    default:
      static_cast<unsigned long long*>(dst)[i] =
          static_cast<const unsigned long long*>(src)[r];
  }
}

// out[i] = data[i - offset] within the partition, else dflt[i] (dflt ==
// nullptr: null).  out_valid is written for every row.
__global__ void __launch_bounds__(WS_THREADS)
ws_shift(const void* __restrict__ data, const uint8_t* __restrict__ valid,
         int elem, long long offset, const void* __restrict__ dflt,
         const uint8_t* __restrict__ dflt_valid,
         const int* __restrict__ seg_start, const int* __restrict__ seg_end,
         long long n, void* __restrict__ out,
         uint8_t* __restrict__ out_valid) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const long long src = i - offset;
    const bool in_seg = src >= seg_start[i] && src <= seg_end[i];
    if (in_seg) {
      ws_copy(data, src, out, i, elem);
      out_valid[i] = valid == nullptr ? 1 : valid[src];
    } else if (dflt != nullptr) {
      ws_copy(dflt, i, out, i, elem);
      out_valid[i] = dflt_valid == nullptr ? 1 : dflt_valid[i];
    } else {
      ws_copy(data, i, out, i, elem);  // any payload under a null
      out_valid[i] = 0;
    }
  }
}

// ---------------------------------------------------------------------------
// host entries (ctypes); each returns cudaGetLastError() after its
// launches (0 = launched)
// ---------------------------------------------------------------------------

// Keys in sorted order: the first npart are partition keys, the rest order
// keys.  seg_start, peer_start: [n] uint8 out.
extern "C" int win_flags(int npart, int nkeys, const void* const* data,
                         const void* const* valid, const int* elems,
                         const int* kinds, long long n, void* seg_start,
                         void* peer_start, void* stream) {
  if (nkeys < 0 || nkeys > WS_MAX_KEYS || npart < 0 || npart > nkeys ||
      n < 0)
    return (int)cudaErrorInvalidValue;
  WSKeys k = {};
  for (int c = 0; c < nkeys; ++c) {
    const int e = elems[c], kd = kinds[c];
    const bool ok = kd == OK_KIND_FLOAT ? (e == 4 || e == 8)
                    : kd == OK_KIND_INT
                        ? (e == 1 || e == 2 || e == 4 || e == 8)
                        : false;
    if (!ok || data[c] == nullptr) return (int)cudaErrorInvalidValue;
    k.data[c] = data[c];
    k.valid[c] = static_cast<const uint8_t*>(valid[c]);
    k.elem[c] = e;
    k.kind[c] = kd;
  }
  k.npart = npart;
  k.nkeys = nkeys;
  if (n == 0) return (int)cudaSuccess;
  int blocks = 1;
  cudaError_t err = ws_grid(n, 16, &blocks);
  if (err != cudaSuccess) return (int)err;
  ws_flags<<<blocks, WS_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      k, n, static_cast<uint8_t*>(seg_start),
      static_cast<uint8_t*>(peer_start));
  return (int)cudaGetLastError();
}

// type: 0 int32, 1 int64, 2 float64; op: 0 sum, 1 min, 2 max; mode: 0
// values (vals, mask), 1 start positions of `flags`, 2 end positions of
// `flags` (run backward), 3 the count of `flags`.  reset: partition starts
// or nullptr.  identity: the op's identity as int64 bits of the type.
// out: [n] of the type.  Scratch: agg_v ceil(n / 2048) 8-byte words,
// agg_f as many int32.
extern "C" int win_scan(int type, int op, int mode, const void* vals,
                        const void* mask, const void* flags,
                        const void* reset, long long identity_bits,
                        long long n, void* out, void* agg_v, void* agg_f,
                        void* stream) {
  if (type < WS_T_I32 || type > WS_T_F64 || op < WS_SUM || op > WS_MAX ||
      mode < WS_LD_VALUES || mode > WS_LD_FLAG_COUNT || n < 0 ||
      n >= INT_MAX || out == nullptr ||
      (mode == WS_LD_VALUES ? vals == nullptr : flags == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  const uint8_t* fl = static_cast<const uint8_t*>(flags);
  const uint8_t* rs = static_cast<const uint8_t*>(reset);
  int* af = static_cast<int*>(agg_f);
  const int rev = mode == WS_LD_END_POS;
  if (type == WS_T_I32) {
    WSIn<int> in = {static_cast<const int*>(vals), m, fl, rs, n,
                    (int)identity_bits, op, mode, rev};
    return (int)ws_scan<int>(in, static_cast<int*>(out), agg_v, af, s);
  }
  if (type == WS_T_I64) {
    WSIn<long long> in = {static_cast<const long long*>(vals), m, fl, rs, n,
                          identity_bits, op, mode, rev};
    return (int)ws_scan<long long>(in, static_cast<long long*>(out), agg_v,
                                   af, s);
  }
  double identity;
  memcpy(&identity, &identity_bits, sizeof(identity));
  WSIn<double> in = {static_cast<const double*>(vals), m, fl, rs, n,
                     identity, op, mode, rev};
  return (int)ws_scan<double>(in, static_cast<double*>(out), agg_v, af, s);
}

// out[i] = src[idx[i]], elements of 1, 4 or 8 bytes; idx int32.
extern "C" int win_take(const void* src, int elem, const void* idx,
                        long long n, void* out, void* stream) {
  if ((elem != 1 && elem != 4 && elem != 8) || n < 0 || src == nullptr ||
      idx == nullptr || out == nullptr)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  int blocks = 1;
  cudaError_t err = ws_grid(n, 16, &blocks);
  if (err != cudaSuccess) return (int)err;
  ws_take<<<blocks, WS_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      src, elem, static_cast<const int*>(idx), n, out);
  return (int)cudaGetLastError();
}

// fn: 0 row_number, 1 rank, 2 dense_rank, 3 percent_rank, 4 cume_dist,
// 5 ntile(tiles).  Positions are int32 [n]; dense: the peer-start count
// (dense_rank only).  out: int32 [n], float64 for 3 and 4.
extern "C" int win_rank(int fn, long long tiles, const void* seg_start,
                        const void* seg_end, const void* peer_start,
                        const void* peer_end, const void* dense, long long n,
                        void* out, void* stream) {
  if (fn < WS_ROW_NUMBER || fn > WS_NTILE || n < 0 || out == nullptr ||
      seg_start == nullptr || (fn == WS_NTILE && tiles < 1) ||
      ((fn == WS_PERCENT_RANK || fn == WS_CUME_DIST || fn == WS_NTILE) &&
       seg_end == nullptr) ||
      ((fn == WS_RANK || fn == WS_PERCENT_RANK) && peer_start == nullptr) ||
      (fn == WS_CUME_DIST && peer_end == nullptr) ||
      (fn == WS_DENSE_RANK && dense == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  WSPos p = {static_cast<const int*>(seg_start),
             static_cast<const int*>(seg_end),
             static_cast<const int*>(peer_start),
             static_cast<const int*>(peer_end),
             static_cast<const int*>(dense)};
  int blocks = 1;
  cudaError_t err = ws_grid(n, 16, &blocks);
  if (err != cudaSuccess) return (int)err;
  ws_rank<<<blocks, WS_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      p, fn, tiles, n, out);
  return (int)cudaGetLastError();
}

// lag (offset > 0) / lead (offset < 0).  data/valid: the sorted column;
// dflt/dflt_valid: the default as a column, or nullptr (null).  out: [n]
// elements; out_valid: [n] uint8.
extern "C" int win_shift(const void* data, const void* valid, int elem,
                         long long offset, const void* dflt,
                         const void* dflt_valid, const void* seg_start,
                         const void* seg_end, long long n, void* out,
                         void* out_valid, void* stream) {
  if ((elem != 1 && elem != 2 && elem != 4 && elem != 8) || n < 0 ||
      data == nullptr || out == nullptr || out_valid == nullptr ||
      seg_start == nullptr || seg_end == nullptr)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  int blocks = 1;
  cudaError_t err = ws_grid(n, 16, &blocks);
  if (err != cudaSuccess) return (int)err;
  ws_shift<<<blocks, WS_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      data, static_cast<const uint8_t*>(valid), elem, offset, dflt,
      static_cast<const uint8_t*>(dflt_valid),
      static_cast<const int*>(seg_start), static_cast<const int*>(seg_end),
      n, out, static_cast<uint8_t*>(out_valid));
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
