// radix.cuh: the exclusive scan and the stable LSD radix pass that
// csr_join.cu (the CSR build's slot order, shuffle partition placement) and
// sort_join.cu (the sorted build over 64-bit key images) share.
//
//   scan_i32    exclusive scan of int32 counts into int64 offsets, the
//               total in out[n]: block scans, a scan of the block sums in
//               one block, and a pass that adds them;
//   radix_pass  one stable 8-bit pass of int32 values by the digit at
//               `shift` of their keys (int32 or uint64): per-tile digit
//               histograms, their scan (digit major), and a scatter that
//               ranks equal digits in row order (__match_any_sync within a
//               warp, per-warp counts in shared memory across warps, a
//               running base across the tile's rounds), so the order is
//               fixed without atomics.  vals_in == nullptr: the values are
//               the row numbers.
//   radix_pass_sel
//               the same pass over a pair of ping-pong buffers whose
//               current side is read on the device (state[p]), so a pass
//               whose digit is the same in every row moves nothing: its
//               scatter sees one digit holding all n rows, writes nothing
//               and leaves state[p + 1] = state[p]; otherwise it writes
//               the other side and flips it.  The host launches the same
//               kernels either way and never waits (sort.cu).
//
// Included by each kernel source, which is compiled into its own library.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define SCAN_THREADS 512
#define SCAN_ITEMS 8
#define SCAN_TILE (SCAN_THREADS * SCAN_ITEMS)
#define RS_THREADS 256
#define RS_WARPS (RS_THREADS / 32)
#define RS_ITEMS 16
#define RS_TILE (RS_THREADS * RS_ITEMS)

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

static long long scan_blocks(long long n) {
  return n <= 0 ? 1 : (n + SCAN_TILE - 1) / SCAN_TILE;
}

// out[0..n) = exclusive scan of in, out[n] = total; sums: scan_blocks(n)
// int64 words of scratch.
static cudaError_t scan_i32(const int* in, long long* out, long long n,
                            long long* sums, cudaStream_t s) {
  const long long nb = scan_blocks(n);
  scan_tiles<<<(unsigned)nb, SCAN_THREADS, 0, s>>>(in, out, n, sums);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  scan_sums<<<1, 1024, 0, s>>>(sums, nb, out + n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  scan_add<<<(unsigned)nb, SCAN_THREADS, 0, s>>>(out, n, sums);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Stable LSD radix pass: 8 bits of int32 or uint64 keys, int32 values
// ---------------------------------------------------------------------------

template <typename K>
__device__ __forceinline__ int rs_digit(K key, int shift) {
  return static_cast<int>((key >> shift) & static_cast<K>(255));
}

// hist[d * nblocks + b]: rows of tile b whose digit is d.
template <typename K>
__device__ __forceinline__ void rs_hist_tile(const K* __restrict__ keys,
                                             long long n, int shift,
                                             int* __restrict__ hist,
                                             int nblocks) {
  __shared__ int s[256];
  s[threadIdx.x] = 0;
  __syncthreads();
  const long long tile = (long long)blockIdx.x * RS_TILE;
  for (int i = 0; i < RS_ITEMS; ++i) {
    const long long r = tile + (long long)i * RS_THREADS + threadIdx.x;
    if (r < n) atomicAdd(&s[rs_digit(keys[r], shift)], 1);
  }
  __syncthreads();
  hist[(long long)threadIdx.x * nblocks + blockIdx.x] = s[threadIdx.x];
}

template <typename K>
__global__ void __launch_bounds__(RS_THREADS)
rs_hist(const K* __restrict__ keys, long long n, int shift,
        int* __restrict__ hist, int nblocks) {
  rs_hist_tile<K>(keys, n, shift, hist, nblocks);
}

// Row r of tile b goes to offs[d * nblocks + b] + (rows before r in tile
// b with digit d).
template <typename K>
__device__ __forceinline__ void rs_scatter_tile(
    const K* __restrict__ keys_in, const int* __restrict__ vals_in,
    K* __restrict__ keys_out, int* __restrict__ vals_out, long long n,
    int shift, const long long* __restrict__ offs, int nblocks,
    long long* s_base, int (*s_cnt)[257]) {
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  s_base[t] = offs[(long long)t * nblocks + blockIdx.x];
  for (int w = 0; w < RS_WARPS; ++w) s_cnt[w][t] = 0;
  if (t < RS_WARPS) s_cnt[t][256] = 0;
  __syncthreads();
  const long long tile = (long long)blockIdx.x * RS_TILE;
  for (int i = 0; i < RS_ITEMS; ++i) {
    const long long r = tile + (long long)i * RS_THREADS + t;
    const bool ok = r < n;
    const K k = ok ? keys_in[r] : static_cast<K>(0);
    const int d = ok ? rs_digit(k, shift) : 256;
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    const int rank = __popc(peers & ((1u << lane) - 1u));
    if (lane == __ffs(peers) - 1) s_cnt[warp][d] = __popc(peers);
    __syncthreads();
    if (ok) {
      long long pos = s_base[d] + rank;
      for (int w = 0; w < warp; ++w) pos += s_cnt[w][d];
      keys_out[pos] = k;
      vals_out[pos] = vals_in == nullptr ? (int)r : vals_in[r];
    }
    __syncthreads();
    int total = 0;
    for (int w = 0; w < RS_WARPS; ++w) {
      total += s_cnt[w][t];
      s_cnt[w][t] = 0;
    }
    s_base[t] += total;
    __syncthreads();
  }
}

template <typename K>
__global__ void __launch_bounds__(RS_THREADS)
rs_scatter(const K* __restrict__ keys_in, const int* __restrict__ vals_in,
           K* __restrict__ keys_out, int* __restrict__ vals_out,
           long long n, int shift, const long long* __restrict__ offs,
           int nblocks) {
  __shared__ long long s_base[256];
  __shared__ int s_cnt[RS_WARPS][257];
  rs_scatter_tile<K>(keys_in, vals_in, keys_out, vals_out, n, shift, offs,
                     nblocks, s_base, s_cnt);
}

// Ping-pong buffers whose current side is state[p] (0 or 1).
template <typename K>
struct RSBufs {
  K* keys[2];
  int* vals[2];
};

template <typename K>
__global__ void __launch_bounds__(RS_THREADS)
rs_hist_sel(const __grid_constant__ RSBufs<K> b, const int* __restrict__ state,
            int p, long long n, int shift, int* __restrict__ hist,
            int nblocks) {
  rs_hist_tile<K>(b.keys[state[p]], n, shift, hist, nblocks);
}

// A pass whose digit holds all n rows is the identity: every block sees
// it from the scanned offsets (digit d's total is offs[(d + 1) * nblocks]
// - offs[d * nblocks]) and skips; block 0 records the side for pass p + 1.
template <typename K>
__global__ void __launch_bounds__(RS_THREADS)
rs_scatter_sel(const __grid_constant__ RSBufs<K> b, int* __restrict__ state,
               int p, long long n, int shift,
               const long long* __restrict__ offs, int nblocks) {
  __shared__ long long s_base[256];
  __shared__ int s_cnt[RS_WARPS][257];
  const int t = threadIdx.x;
  const int side = state[p];
  const long long total = offs[(long long)(t + 1) * nblocks]
                          - offs[(long long)t * nblocks];
  const int skip = __syncthreads_or(total == n);
  if (blockIdx.x == 0 && t == 0) state[p + 1] = skip ? side : 1 - side;
  if (skip) return;
  rs_scatter_tile<K>(b.keys[side], b.vals[side], b.keys[1 - side],
                     b.vals[1 - side], n, shift, offs, nblocks, s_base,
                     s_cnt);
}

static long long sort_tiles(long long n) {
  return n <= 0 ? 1 : (n + RS_TILE - 1) / RS_TILE;
}

// One pass over bits [shift, shift + 8) of n rows.  Scratch: hist
// 256 * sort_tiles(n) int32, offs 256 * sort_tiles(n) + 1 int64, sums
// scan_blocks(256 * sort_tiles(n)) int64.
template <typename K>
static cudaError_t radix_pass(const K* keys_in, const int* vals_in,
                              K* keys_out, int* vals_out, long long n,
                              int shift, int* hist, long long* offs,
                              long long* sums, cudaStream_t s) {
  const long long tiles = sort_tiles(n);
  rs_hist<K><<<(unsigned)tiles, RS_THREADS, 0, s>>>(keys_in, n, shift, hist,
                                                    (int)tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = scan_i32(hist, offs, 256 * tiles, sums, s);
  if (err != cudaSuccess) return err;
  rs_scatter<K><<<(unsigned)tiles, RS_THREADS, 0, s>>>(
      keys_in, vals_in, keys_out, vals_out, n, shift, offs, (int)tiles);
  return cudaGetLastError();
}

// One skippable pass (pass number p) over bits [shift, shift + 8) of the
// current side of `b`.  Scratch as radix_pass.
template <typename K>
static cudaError_t radix_pass_sel(const RSBufs<K>& b, int* state, int p,
                                  long long n, int shift, int* hist,
                                  long long* offs, long long* sums,
                                  cudaStream_t s) {
  const long long tiles = sort_tiles(n);
  rs_hist_sel<K><<<(unsigned)tiles, RS_THREADS, 0, s>>>(b, state, p, n,
                                                        shift, hist,
                                                        (int)tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = scan_i32(hist, offs, 256 * tiles, sums, s);
  if (err != cudaSuccess) return err;
  rs_scatter_sel<K><<<(unsigned)tiles, RS_THREADS, 0, s>>>(
      b, state, p, n, shift, offs, (int)tiles);
  return cudaGetLastError();
}
