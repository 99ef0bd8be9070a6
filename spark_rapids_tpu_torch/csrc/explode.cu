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
// Design: expand.cuh's merge path, by output row.  The output rows
// [0, total) and the parents' ends starts[p + 1] form one merged sequence
// (an end comes before row j when it is <= j).  The chunk [lo, lo + m) is
// the items from where row lo falls to just past row lo + m - 1: warps 0
// and 1 of each block find the ends before those two rows (warp_search,
// once a block).  The blocks, sized to the card's resident blocks, take
// runs of the chunk's tiles of EX_TILE items, EX_GROUP tiles at a time:
// the group's splits (its tiles' parents [r0, r1] and rows [j0, j1)) are
// found at once, a warp_search a warp, so a tile waits on no search of its
// own.  Per tile the parents' starts (and eoffs) are staged in shared
// memory, each thread walks 8 items of the tile and notes
// each row's parent there, so a long list spreads over the whole grid and
// a run of empty lists costs one item each.  Then each column is written
// as one run of the tile's rows in aligned 16-byte stores (a word at the
// tile's edge shared with the next tile by single elements), validity
// bytes 16 a store: the element column from values[e] (e = row without
// OUTER, eoffs[p] + row - starts[p] under it; every load of a thread is
// issued before its first store), each sibling column from its values and
// validity at the tile's parents, read once and coalesced into shared
// memory.  A null element (a null or empty list under OUTER, or a null
// value) is written as 0 and invalid, as the reference fills it.  Sibling
// columns move 1, 2, 4 or 8 bytes per row (wide decimal limbs as two
// 8-byte columns), with their validity bytes, up to EX_MAX_COLS a launch.
//
// Bound: device memory.  Per output row: its element (read and written)
// and its validity byte, and each sibling column's value and validity
// (written).  Per parent: its start (and element offset), and each sibling
// column's value and validity (read).  The searches read a few sectors of
// starts a block and a tile.  EX_MIN_BLOCKS keeps 4 blocks an SM resident
// (at most 64 registers a thread, where ptxas spills: a 40-byte stack
// frame, 116 bytes of spill stores and 92 of loads a thread; 3 blocks an
// SM with no spill and 5 each ran slower at X1o's first chunk).

#include <cuda_runtime.h>
#include <stdint.h>

#include "expand.cuh"

#define EX_MAX_COLS 16
#define EX_ITEMS (EX_TILE / EX_THREADS)  // merge-path items a thread walks
constexpr int EX_GROUP = 7;  // tiles whose splits a block finds at once
static_assert(EX_GROUP < EX_THREADS / 32, "a warp a split of a group");
constexpr int EX_MIN_BLOCKS = 4;  // resident blocks an SM at least

struct EXArgs {
  const void* in[EX_MAX_COLS];
  void* out[EX_MAX_COLS];
  const uint8_t* vin[EX_MAX_COLS];  // nullptr: no validity mask
  uint8_t* vout[EX_MAX_COLS];
  int elem[EX_MAX_COLS];
  int ncols;
};

template <int E> struct Bits;
template <> struct Bits<8> { typedef unsigned long long T; };
template <> struct Bits<4> { typedef unsigned int T; };
template <> struct Bits<2> { typedef unsigned short T; };
template <> struct Bits<1> { typedef unsigned char T; };

// 16 bytes of V = 16 / E elements, packed in registers.
template <int E, typename T, int V>
__device__ __forceinline__ uint4 pack16(const T (&t)[V]) {
  unsigned w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if constexpr (E == 8) {
      w[k] = (unsigned)(k & 1 ? t[k >> 1] >> 32 : t[k >> 1]);
    } else {
      unsigned x = 0;
#pragma unroll
      for (int i = 0; i < 4 / E; ++i)
        x |= (unsigned)t[k * (4 / E) + i] << (8 * E * i);
      w[k] = x;
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Writes outputs [a, b) of a column of E-byte elements (16-byte aligned),
// get(o) giving output o: a thread takes every EX_THREADS-th 16-byte word
// of the run, gathers all of its words' values into registers, then
// stores each whole word at once and the run's two edge words by element.
template <int E, class Get>
__device__ __forceinline__ void put_run(void* __restrict__ out, long long a,
                                        long long b, const Get& get) {
  typedef typename Bits<E>::T T;
  constexpr int V = 16 / E;
  constexpr int W = (EX_TILE / V + 1 + EX_THREADS - 1) / EX_THREADS;
  const long long w0 = a / V, w1 = (b + V - 1) / V;
  T v[W][V];
#pragma unroll
  for (int u = 0; u < W; ++u) {
    const long long w = w0 + threadIdx.x + (long long)u * EX_THREADS;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const long long o = w * V + i;
      v[u][i] = w < w1 && o >= a && o < b ? get(o) : T(0);
    }
  }
#pragma unroll
  for (int u = 0; u < W; ++u) {
    const long long w = w0 + threadIdx.x + (long long)u * EX_THREADS;
    if (w >= w1) break;
    if (w * V >= a && w * V + V <= b) {
      reinterpret_cast<uint4*>(out)[w] = pack16<E>(v[u]);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const long long o = w * V + i;
        if (o >= a && o < b) static_cast<T*>(out)[o] = v[u][i];
      }
    }
  }
}

// dst[k] = src(k) for k < count <= EX_TILE + 2, every load of a thread
// issued before its first store.
template <typename T, class Src>
__device__ __forceinline__ void stage(T* dst, int count, const Src& src) {
  constexpr int U = (EX_TILE + 2 + EX_THREADS - 1) / EX_THREADS;
  T x[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int k = threadIdx.x + u * EX_THREADS;
    x[u] = k < count ? src(k) : T(0);
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int k = threadIdx.x + u * EX_THREADS;
    if (k < count) dst[k] = x[u];
  }
}

struct ExTile {
  long long lo, j0;  // the chunk's first row, the tile's first row
  const long long* s_off;
  const long long* s_eo;
  const uint16_t* s_par;
};

// The element column of the tile's rows: chunk outputs [a, b).
template <int E>
__device__ __forceinline__ void put_elements(
    const ExTile& tl, long long a, long long b, const void* __restrict__ values,
    const uint8_t* __restrict__ vv, bool outer, void* __restrict__ out,
    uint8_t* s_ok) {
  typedef typename Bits<E>::T T;
  const T* __restrict__ vals = static_cast<const T*>(values);
  put_run<E>(out, a, b, [&](long long o) -> T {
    const long long j = tl.lo + o;
    const int i = (int)(j - tl.j0);
    long long e = j;
    bool ok = true;
    if (outer) {
      const int k = tl.s_par[i];
      const long long e0 = tl.s_eo[k];
      ok = tl.s_eo[k + 1] > e0;  // an empty or null list's one row
      e = e0 + (j - tl.s_off[k]);
    }
    T x = 0;
    if (ok) {
      x = vals[e];
      if (vv != nullptr) ok = vv[e] != 0;
    }
    s_ok[i] = ok;
    return ok ? x : T(0);
  });
}

// Sibling column c's values (and validity) at the tile's parents
// [r0, r0 + rows], staged, then written by row.
template <int E>
__device__ __forceinline__ void put_sibling(
    const ExTile& tl, long long a, long long b, long long r0, int rows,
    long long n, const void* __restrict__ in, const uint8_t* __restrict__ vin,
    void* __restrict__ out, uint8_t* __restrict__ vout, void* s_val,
    uint8_t* s_vb) {
  typedef typename Bits<E>::T T;
  const T* __restrict__ src = static_cast<const T*>(in);
  T* sv = static_cast<T*>(s_val);
  const int count = (int)(r0 + rows < n ? rows + 1 : n - r0);  // p < n
  stage(sv, count, [&](int k) -> T { return src[r0 + k]; });
  if (vin != nullptr)
    stage(s_vb, count, [&](int k) -> uint8_t { return vin[r0 + k]; });
  __syncthreads();
  const long long base = tl.lo - tl.j0;  // tile row of chunk output o: o + base
  put_run<E>(out, a, b, [&](long long o) -> T {
    return sv[tl.s_par[o + base]];
  });
  if (vout != nullptr)
    put_run<1>(vout, a, b, [&](long long o) -> unsigned char {
      return s_vb[tl.s_par[o + base]];
    });
}

// The ends before merge-path item d of a chunk [lo, lo + m) whose items
// hold the ends [base, pend]: at least d - lo - m (the rows before d are
// at most lo + m) and at most d - lo (they are at least lo).  Called by a
// whole warp.
__device__ __forceinline__ long long ends_before(
    const long long* __restrict__ starts, long long d, long long lo,
    long long m, long long base, long long pend) {
  const long long a = d - lo - m > base ? d - lo - m : base;
  const long long z = d - lo < pend ? d - lo : pend;
  return warp_search(
      a, z, [&](long long r) { return r + starts[r + 1] < d; });
}

__global__ void __launch_bounds__(EX_THREADS, EX_MIN_BLOCKS)
explode_k(const __grid_constant__ EXArgs args,
          const long long* __restrict__ starts,
          const long long* __restrict__ eoffs, long long n, long long lo,
          long long m, const void* __restrict__ values,
          const uint8_t* __restrict__ values_valid, int elem_bytes,
          void* __restrict__ out_values, uint8_t* __restrict__ out_valid) {
  __shared__ long long s_off[EX_TILE + 1];  // starts[r0 .. r1]
  __shared__ union {
    long long eo[EX_TILE + 2];              // eoffs[r0 .. r1 + 1]
    unsigned long long val[EX_TILE + 1];    // a sibling at r0 .. r1
  } s_u;
  __shared__ uint16_t s_par[EX_TILE];       // a row's parent - r0
  __shared__ uint8_t s_ok[EX_TILE];         // a row's element validity
  __shared__ uint8_t s_vb[EX_TILE + 1];     // a sibling's validity
  __shared__ long long s_split[EX_GROUP + 1], s_range[2];
  const int t = threadIdx.x, warp = t >> 5;
  // the ends before row lo and before row lo + m - 1
  if (warp < 2) {
    const long long row = warp == 0 ? lo : lo + m - 1;
    const long long c = warp_search(
        0, n, [&](long long p) { return starts[p + 1] <= row; });
    if ((t & 31) == 0) s_range[warp] = c;
  }
  __syncthreads();
  const long long base = s_range[0], pend = s_range[1];
  const long long g0 = lo + base, items = m + (pend - base);
  const bool outer = eoffs != nullptr;
  // this block's tiles: a run of them, in groups of EX_GROUP
  const long long tiles = (items + EX_TILE - 1) / EX_TILE;
  const long long per = (tiles + gridDim.x - 1) / gridDim.x;
  const long long t0 = blockIdx.x * per;
  const long long t1 = t0 + per < tiles ? t0 + per : tiles;
  for (long long tg = t0; tg < t1; tg += EX_GROUP) {
    const int nt = (int)(t1 - tg < EX_GROUP ? t1 - tg : EX_GROUP);
    if (warp <= nt) {
      const long long d = g0 + (tg + warp) * EX_TILE;
      const long long c = ends_before(starts, d < g0 + items ? d : g0 + items,
                                      lo, m, base, pend);
      if ((t & 31) == 0) s_split[warp] = c;
    }
    __syncthreads();
    for (int q = 0; q < nt; ++q) {
      const long long d0 = g0 + (tg + q) * EX_TILE;
      const long long d1 = d0 + EX_TILE < g0 + items ? d0 + EX_TILE
                                                     : g0 + items;
      const long long r0 = s_split[q], r1 = s_split[q + 1];
      const long long j0 = d0 - r0, j1 = d1 - r1;
      const int rows = (int)(r1 - r0), nout = (int)(j1 - j0);
      stage(s_off, rows + 1, [&](int k) { return starts[r0 + k]; });
      if (outer && values != nullptr)
        stage(s_u.eo, (int)(r0 + rows + 1 <= n ? rows + 2 : n + 1 - r0),
              [&](int k) { return eoffs[r0 + k]; });
      __syncthreads();
      {  // this thread's items [x, x + EX_ITEMS) of the tile
        const int all = nout + rows;
        const int x = t * EX_ITEMS < all ? t * EX_ITEMS : all;
        const int xe = x + EX_ITEMS < all ? x + EX_ITEMS : all;
        int ka = x - nout > 0 ? x - nout : 0, kz = x < rows ? x : rows;
        while (ka < kz) {  // the ends before item x
          const int mid = (ka + kz) >> 1;
          if (mid + (s_off[mid + 1] - j0) < x) ka = mid + 1; else kz = mid;
        }
        int k = ka;
        long long j = j0 + (x - k);
        for (int pos = x; pos < xe; ++pos) {
          if (k < rows && s_off[k + 1] <= j) {
            ++k;
          } else {
            s_par[j - j0] = (uint16_t)k;
            ++j;
          }
        }
      }
      __syncthreads();
      const ExTile tl = {lo, j0, s_off, s_u.eo, s_par};
      const long long a = j0 - lo, b = j1 - lo;  // the tile's chunk outputs
      if (values != nullptr) {
        switch (elem_bytes) {
          case 8: put_elements<8>(tl, a, b, values, values_valid, outer,
                                  out_values, s_ok); break;
          case 4: put_elements<4>(tl, a, b, values, values_valid, outer,
                                  out_values, s_ok); break;
          case 2: put_elements<2>(tl, a, b, values, values_valid, outer,
                                  out_values, s_ok); break;
          default: put_elements<1>(tl, a, b, values, values_valid, outer,
                                   out_values, s_ok);
        }
        __syncthreads();
        if (out_valid != nullptr)
          put_run<1>(out_valid, a, b, [&](long long o) -> unsigned char {
            return s_ok[o - a];
          });
      }
      for (int c = 0; c < args.ncols; ++c) {
        __syncthreads();  // the last readers of s_u and s_vb are done
        switch (args.elem[c]) {
          case 8: put_sibling<8>(tl, a, b, r0, rows, n, args.in[c],
                                 args.vin[c], args.out[c], args.vout[c],
                                 s_u.val, s_vb); break;
          case 4: put_sibling<4>(tl, a, b, r0, rows, n, args.in[c],
                                 args.vin[c], args.out[c], args.vout[c],
                                 s_u.val, s_vb); break;
          case 2: put_sibling<2>(tl, a, b, r0, rows, n, args.in[c],
                                 args.vin[c], args.out[c], args.vout[c],
                                 s_u.val, s_vb); break;
          default: put_sibling<1>(tl, a, b, r0, rows, n, args.in[c],
                                  args.vin[c], args.out[c], args.vout[c],
                                  s_u.val, s_vb);
        }
      }
      __syncthreads();  // the tile's shared arrays are free again
    }
  }
}

static bool elem_ok(int e) { return e == 1 || e == 2 || e == 4 || e == 8; }

static bool aligned16(const void* p) {
  return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Blocks of explode_k resident on the card at once (queried once a
// device).
static int ex_resident_blocks(int dev, int* out) {
  static int cached[64] = {0};
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (cached[dev] == 0) {
    int sms = 0, per_sm = 0;
    cudaError_t err =
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, explode_k,
                                                          EX_THREADS, 0);
    if (err != cudaSuccess) return (int)err;
    cached[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  *out = cached[dev];
  return 0;
}

// Host entry, bound with ctypes.  `starts` (and `eoffs` under OUTER, else
// nullptr) are int64 [n + 1] device arrays with lo + m <= starts[n];
// `values` (nullptr: no element column in this call) holds the batch's
// flat elements, `values_valid` their validity or nullptr, `out_valid` the
// element validity to write or nullptr.  `in`, `out`, `vin`, `vout` and
// `elems` are host arrays of the sibling columns ([n] in, [m] out).  Every
// output must be 16-byte aligned.  Returns cudaGetLastError().
extern "C" int explode(long long n, const void* starts, const void* eoffs,
                       long long lo, long long m, const void* values,
                       const void* values_valid, int elem_bytes,
                       void* out_values, void* out_valid, int ncols,
                       const void* const* in, void* const* out,
                       const void* const* vin, void* const* vout,
                       const int* elems, void* stream) {
  if (n <= 0 || lo < 0 || m < 0 || ncols < 0 || ncols > EX_MAX_COLS ||
      (values != nullptr && !elem_ok(elem_bytes)) || !aligned16(out_values) ||
      !aligned16(out_valid))
    return (int)cudaErrorInvalidValue;
  EXArgs a = {};
  for (int c = 0; c < ncols; ++c) {
    if (!elem_ok(elems[c]) || (vin[c] == nullptr) != (vout[c] == nullptr) ||
        !aligned16(out[c]) || !aligned16(vout[c]))
      return (int)cudaErrorInvalidValue;
    a.in[c] = in[c];
    a.out[c] = out[c];
    a.vin[c] = static_cast<const uint8_t*>(vin[c]);
    a.vout[c] = static_cast<uint8_t*>(vout[c]);
    a.elem[c] = elems[c];
  }
  a.ncols = ncols;
  if (m == 0) return (int)cudaSuccess;
  int dev = 0, resident = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err == 0) err = ex_resident_blocks(dev, &resident);
  if (err != 0) return err;
  // the chunk's items: its m rows and at most n ends (m under OUTER, where
  // every parent takes a row)
  const long long ends = eoffs != nullptr && m < n ? m : n;
  const long long tiles = (m + ends + EX_TILE - 1) / EX_TILE;
  const long long blocks = tiles < resident ? tiles : resident;
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
