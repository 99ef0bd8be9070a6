// sample: the Bernoulli keep mask of a sampled batch, bit for bit the
// reference's draw.
//
// Replaces: spark_rapids_tpu/plan/exec_nodes.py:310 SampleExec.execute,
// which keeps row i of the idx-th child batch where
//   jax.random.uniform(fold_in(PRNGKey(seed), idx), (capacity,))[i]
//     < fraction
// in float64 (the reference enables x64), and ANDs that into the batch's
// selection.  JAX draws with threefry2x32 in its partitionable form
// (jax/_src/prng.py:1184): row i's 64 bits are threefry2x32(key, (hi32(i),
// lo32(i))) as out0 << 32 | out1, so row i's draw does not depend on the
// capacity.  The float is (bits >> 12 | 0x3FF0000000000000) as a double,
// minus 1.0 (jax/_src/random.py:435 _uniform).  The batch key,
// fold_in(PRNGKey(seed), idx), is computed on the host
// (ops/sample.py batch_key) and passed as two words.
//
// One thread per row, grid-stride.  A row that is not live (past
// num_rows, or dropped by the selection) is written 0 without drawing.
//
// Bound: operations.  A live row costs 20 threefry rounds (an add, a
// funnel shift, an xor), 6 key injections (2 adds each, the round
// constants folded per batch) and the bits-to-double step (2 shifts and an
// or, then a float64 subtract and compare): 43 shifts and logic operations,
// which only the ALU pipe issues, and 32 adds, which it or the FMA pipe (as
// IMAD) issues; against 2 bytes of memory (the selection byte read and the
// mask byte written).  At 64 results a clock an SM for each pipe (compute
// capability 9.0), 132 SMs and 1,980 MHz, the ALU pipe's 43 a row are the
// larger share: one 4,194,304-row batch takes at least 10.8 us, against
// 8.4 MB (2.5 us at 3.35 TB/s).  tools/sass_count.py counts what the
// compiled row loop issues by pipe.

#include <cuda_runtime.h>
#include <stdint.h>

#define SM_THREADS 256

#define TF_ROUND(r)                 \
  x0 += x1;                         \
  x1 = __funnelshift_l(x1, x1, r);  \
  x1 ^= x0;

// threefry2x32 with 20 rounds, as jax/_src/prng.py:863-897 unrolls it.
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k1;
  x1 += k2 + 1u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k2;
  x1 += k0 + 2u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k0;
  x1 += k1 + 3u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k1;
  x1 += k2 + 4u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k2;
  x1 += k0 + 5u;
}

__global__ void __launch_bounds__(SM_THREADS)
sample_mask_k(uint32_t k0, uint32_t k1, double fraction,
              const uint8_t* __restrict__ sel, long long num_rows,
              long long cap, uint8_t* __restrict__ out) {
  const long long stride = (long long)gridDim.x * SM_THREADS;
  for (long long i = (long long)blockIdx.x * SM_THREADS + threadIdx.x;
       i < cap; i += stride) {
    uint8_t keep = 0;
    if (i < num_rows && (sel == nullptr || sel[i])) {
      uint32_t x0 = (uint32_t)((unsigned long long)i >> 32);
      uint32_t x1 = (uint32_t)i;
      threefry2x32(k0, k1, x0, x1);
      const unsigned long long bits =
          ((unsigned long long)x0 << 32) | (unsigned long long)x1;
      const double u =
          __longlong_as_double((long long)((bits >> 12) |
                                           0x3FF0000000000000ull)) - 1.0;
      keep = u < fraction;
    }
    out[i] = keep;
  }
}

// Threefry2x32 of a vector of counters (the known-answer check): out0[i],
// out1[i] = threefry2x32((k0, k1), (x0[i], x1[i])).
__global__ void __launch_bounds__(SM_THREADS)
threefry_k(uint32_t k0, uint32_t k1, const uint32_t* __restrict__ x0,
           const uint32_t* __restrict__ x1, long long n,
           uint32_t* __restrict__ out0, uint32_t* __restrict__ out1) {
  const long long i = (long long)blockIdx.x * SM_THREADS + threadIdx.x;
  if (i >= n) return;
  uint32_t a = x0[i], b = x1[i];
  threefry2x32(k0, k1, a, b);
  out0[i] = a;
  out1[i] = b;
}

static unsigned grid_for(long long n) {
  const long long blocks = (n + SM_THREADS - 1) / SM_THREADS;
  return (unsigned)(blocks < 132 * 32 ? blocks : 132 * 32);
}

// Host entry, bound with ctypes.  `sel` is bool [num_rows] or nullptr;
// `out` is bool [cap] (cap >= num_rows).  Returns cudaGetLastError().
extern "C" int sample_mask(long long k0, long long k1, double fraction,
                           const void* sel, long long num_rows, long long cap,
                           void* out, void* stream) {
  if (num_rows < 0 || cap < num_rows) return (int)cudaErrorInvalidValue;
  if (cap > 0)
    sample_mask_k<<<grid_for(cap), SM_THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        (uint32_t)k0, (uint32_t)k1, fraction,
        static_cast<const uint8_t*>(sel), num_rows, cap,
        static_cast<uint8_t*>(out));
  return (int)cudaGetLastError();
}

extern "C" int threefry(long long k0, long long k1, const void* x0,
                        const void* x1, long long n, void* out0, void* out1,
                        void* stream) {
  if (n < 0 || n >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  if (n > 0)
    threefry_k<<<(unsigned)((n + SM_THREADS - 1) / SM_THREADS), SM_THREADS,
                 0, static_cast<cudaStream_t>(stream)>>>(
        (uint32_t)k0, (uint32_t)k1, static_cast<const uint32_t*>(x0),
        static_cast<const uint32_t*>(x1), n, static_cast<uint32_t*>(out0),
        static_cast<uint32_t*>(out1));
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
