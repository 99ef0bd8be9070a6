// dense_probe_bench: the dense join's probe as csrc/dense_join.cu had it
// before its redesign (one row a thread a grid-stride step, a per-element
// switch on the payload's element size), in variants that each leave out
// one part, on the card at TPC-H Q3's second join at SF10: a 15,003,036-slot
// int32 table (~9.7% of the slots live), one 4,194,304-row lineitem batch
// of int64 keys drawn over the domain (~54% of the rows live), three
// payload columns of 8, 4 and 8 bytes.  Which part sets the probe's time:
//
//   base         the probe as it was;
//   no_payload   no payload column (the lookups and the selection only);
//   all_empty    every slot empty (-1): the lookups, never a gather;
//   l2_table     the table read at (slot mod 4,194,304): an L2-sized
//                16 MB array holding the same share of live slots;
//   l2_no_pay    l2_table without the payload;
//   stream       the streamed bytes alone: the mask and keys read, the
//                selection and the payload's elements written (no lookup);
//
// each the mean of 20 runs between one pair of events after a warm-up,
// over 4 copies of the probe's keys and mask (past twice the L2).
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//       -o build/dense_probe_bench tools/dense_probe_bench.cu
//   build/dense_probe_bench
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

#define THREADS 256
#define NCOLS 3

#define CK(x)                                                          \
  do {                                                                 \
    cudaError_t e_ = (x);                                              \
    if (e_ != cudaSuccess) {                                           \
      fprintf(stderr, "%s:%d %s\n", __FILE__, __LINE__,                \
              cudaGetErrorString(e_));                                 \
      return 1;                                                        \
    }                                                                  \
  } while (0)

struct Payload {
  const void* data[NCOLS];
  void* out[NCOLS];
  int elem[NCOLS];
  int ncols;
};

__device__ __forceinline__ uint64_t mix(uint64_t x) {
  x ^= x >> 33;
  x *= 0xff51afd7ed558ccdull;
  x ^= x >> 33;
  x *= 0xc4ceb9fe1a85ec53ull;
  return x ^ (x >> 33);
}

__device__ __forceinline__ double unit(uint64_t seed, long long i) {
  return (double)(mix(seed * 0x9e3779b97f4a7c15ull + (uint64_t)i) >> 11)
         * (1.0 / 9007199254740992.0);
}

// table[s] = s where live (a build row per slot), else -1
__global__ void fill_table(int* t, long long D, double live, uint64_t seed) {
  for (long long s = blockIdx.x * (long long)blockDim.x + threadIdx.x; s < D;
       s += (long long)gridDim.x * blockDim.x)
    t[s] = unit(seed, s) < live ? (int)s : -1;
}

__global__ void fill_probe(long long* k, uint8_t* a, long long n, long long D,
                           uint64_t seed) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    k[i] = 1 + (long long)(unit(seed, i) * D);
    a[i] = unit(seed + 1, i) < 0.54;
  }
}

__device__ __forceinline__ void copy_elem(void* dst, const void* src,
                                          int elem, long long to,
                                          long long from, bool matched) {
  switch (elem) {
    case 8:
      static_cast<long long*>(dst)[to] =
          matched ? static_cast<const long long*>(src)[from] : 0LL;
      break;
    case 4:
      static_cast<int*>(dst)[to] =
          matched ? static_cast<const int*>(src)[from] : 0;
      break;
    case 2:
      static_cast<short*>(dst)[to] =
          matched ? static_cast<const short*>(src)[from] : (short)0;
      break;
    default:
      static_cast<uint8_t*>(dst)[to] =
          matched ? static_cast<const uint8_t*>(src)[from] : (uint8_t)0;
  }
}

// The probe before the redesign (inner join, int64 keys, no key validity);
// WRAP > 0 reads the table at slot % WRAP; LOOKUP false skips the table.
template <long long WRAP, bool LOOKUP>
__global__ void __launch_bounds__(THREADS)
probe(const __grid_constant__ Payload p, const long long* __restrict__ keys,
      const uint8_t* __restrict__ active, long long n, long long kmin,
      long long D, const int* __restrict__ table,
      uint8_t* __restrict__ out_sel) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += stride) {
    int bi = -1;
    const bool row_live = active[r];
    const long long k = keys[r];
    if (LOOKUP) {
      if (row_live && k >= kmin && k - kmin < D)
        bi = table[WRAP > 0 ? (k - kmin) % WRAP : k - kmin];
    } else if (row_live) {
      bi = (int)((k - kmin) & 1) - 1;  // no table read; rows stay unmatched
    }
    const bool matched = bi >= 0;
    out_sel[r] = matched;
#pragma unroll 4
    for (int j = 0; j < p.ncols; ++j)
      copy_elem(p.out[j], p.data[j], p.elem[j], r, bi, matched);
  }
}

int main() {
  const long long D = 15003036, n = 4194304;
  const int copies = 4, reps = 20;
  int dev = 0, sms = 0;
  CK(cudaGetDevice(&dev));
  CK(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  int *table, *empty;
  CK(cudaMalloc(&table, D * 4));
  CK(cudaMalloc(&empty, D * 4));
  fill_table<<<1024, 256>>>(table, D, 0.097, 7);
  CK(cudaMemset(empty, 0xff, D * 4));
  long long* keys[copies];
  uint8_t* act[copies];
  for (int c = 0; c < copies; ++c) {
    CK(cudaMalloc(&keys[c], n * 8));
    CK(cudaMalloc(&act[c], n));
    fill_probe<<<1024, 256>>>(keys[c], act[c], n, D, 11 + 2 * c);
  }
  Payload pay = {}, none = {};
  const int elems[NCOLS] = {8, 4, 8};
  for (int j = 0; j < NCOLS; ++j) {
    void *d, *o;
    CK(cudaMalloc(&d, D * elems[j]));
    CK(cudaMemset(d, 1, D * elems[j]));
    CK(cudaMalloc(&o, n * elems[j]));
    pay.data[j] = d;
    pay.out[j] = o;
    pay.elem[j] = elems[j];
  }
  pay.ncols = NCOLS;
  uint8_t* sel;
  CK(cudaMalloc(&sel, n));
  CK(cudaDeviceSynchronize());
  const int blocks = sms * 16;
  cudaEvent_t a, b;
  CK(cudaEventCreate(&a));
  CK(cudaEventCreate(&b));
  printf("{\"shape\": \"Q3 join 2: %lld slots, 9.7%% live; %lld probe rows, "
         "54%% live; payload 8+4+8 B\", \"blocks\": %d}\n", D, n, blocks);
  for (int v = 0; v < 6; ++v) {
    const char* names[] = {"base", "no_payload", "all_empty", "l2_table",
                           "l2_no_pay", "stream"};
    for (int r = -1; r < reps; ++r) {
      if (r == 0) CK(cudaEventRecord(a));
      const int c = (r + copies) % copies;
      switch (v) {
        case 0:
          probe<0, true><<<blocks, THREADS>>>(pay, keys[c], act[c], n, 1, D,
                                              table, sel);
          break;
        case 1:
          probe<0, true><<<blocks, THREADS>>>(none, keys[c], act[c], n, 1, D,
                                              table, sel);
          break;
        case 2:
          probe<0, true><<<blocks, THREADS>>>(pay, keys[c], act[c], n, 1, D,
                                              empty, sel);
          break;
        case 3:
          probe<4194304, true><<<blocks, THREADS>>>(pay, keys[c], act[c], n,
                                                    1, D, table, sel);
          break;
        case 4:
          probe<4194304, true><<<blocks, THREADS>>>(none, keys[c], act[c],
                                                    n, 1, D, table, sel);
          break;
        default:
          probe<0, false><<<blocks, THREADS>>>(pay, keys[c], act[c], n, 1, D,
                                               table, sel);
      }
      CK(cudaGetLastError());
    }
    CK(cudaEventRecord(b));
    CK(cudaEventSynchronize(b));
    float ms = 0;
    CK(cudaEventElapsedTime(&ms, a, b));
    printf("{\"variant\": \"%s\", \"ms\": %.4f}\n", names[v], ms / reps);
  }
  return 0;
}
