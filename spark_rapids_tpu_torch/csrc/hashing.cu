// hashing: Spark-exact row hashes of key columns — murmur3 (Murmur3_x86_32,
// seed 42) for hash partitioning and xxhash64 (seed 42) for the shuffled
// join's sub-partitions — with the partition id of each row and the rows
// per partition.
//
// Replaces: spark_rapids_tpu/ops/hashing.py:156 hash_value, :180
// hash_columns, :190 spark_partition_id (murmur3), :239 xxhash64_value,
// :265 xxhash64_columns, with the float normalizations :80
// _normalize_float_bits and :102 f64_bit_pattern; and the partition-id
// programs that call them (plan/exchange_exec.py:102 _pid_fn, the
// sub-partition ids of plan/join_exec.py:362 _sub_partition_join, the
// aggregate's re-partition bucket ids plan/physical.py:2169
// _split_by_key_hash, the mesh exchange's parallel/exchange.py:26
// hash_ids).
//
// Entry point:
//   hash_rows  one thread per row folds every key column into the running
//              hash, left to right.  A null leaves the hash as it was.
//              Per column type (elem bytes, is_float):
//                1/2/4-byte integers (bool, int8, int16, int32, dates,
//                dictionary codes): one 4-byte block, sign-extended;
//                8-byte integers: murmur3 the low then the high word,
//                xxhash64 the 8-byte path;
//                float32: its bits after -0.0 -> +0.0, NaN -> 0x7FC00000
//                and subnormals -> +0.0 (the reference runs with
//                flush-to-zero, so a subnormal equals zero there), then
//                the 4-byte path;
//                float64: the same normalizations (NaN ->
//                0x7FF8000000000000), then the 8-byte path.
//              Writes the hash (optional: uint32 as int64 for murmur3, the
//              64 bits for xxhash64), and, when nparts > 0, the partition
//              id (murmur3: pmod of the hash as int32, as Spark's
//              HashPartitioning; xxhash64: pmod of the hash as int64;
//              xxhash64 % n (algo 2): the remainder of the UNSIGNED 64-bit
//              hash, which _split_by_key_hash takes as
//              (h % uint64(n)).astype(int32) and which torch cannot take,
//              having no uint64 remainder) with
//              nparts for an inactive row, and adds each row to its
//              partition's count (a block histogram in shared memory, one
//              atomic per block and partition: a count is order-free).
//
// Bound: device memory.  A row reads its key words, validity and active
// byte once and writes 4 bytes of id (8 of hash); the hash arithmetic is a
// few dozen integer operations per key, far under the card's integer rate.
// No fast-math: the float normalizations compare exact bit patterns.

#include <cuda_runtime.h>
#include <stdint.h>

#define HS_THREADS 256
#define HS_MAX_KEYS 8
#define HS_MAX_PARTS 4096

#define ALGO_MURMUR3 0
#define ALGO_XXHASH64 1
#define ALGO_XXHASH64_UMOD 2

struct HSKeys {
  const void* data[HS_MAX_KEYS];
  const uint8_t* valid[HS_MAX_KEYS];  // nullptr: no nulls
  int elem[HS_MAX_KEYS];
  int is_float[HS_MAX_KEYS];
  int nkeys;
};

// ---------------------------------------------------------------------------
// murmur3 (Murmur3_x86_32)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ uint32_t mix_k1(uint32_t k1) {
  k1 *= 0xcc9e2d51u;
  k1 = rotl32(k1, 15);
  return k1 * 0x1b873593u;
}

__device__ __forceinline__ uint32_t mix_h1(uint32_t h1, uint32_t k1) {
  h1 ^= k1;
  h1 = rotl32(h1, 13);
  return h1 * 5u + 0xe6546b64u;
}

__device__ __forceinline__ uint32_t fmix32(uint32_t h1, uint32_t len) {
  h1 ^= len;
  h1 ^= h1 >> 16;
  h1 *= 0x85ebca6bu;
  h1 ^= h1 >> 13;
  h1 *= 0xc2b2ae35u;
  return h1 ^ (h1 >> 16);
}

__device__ __forceinline__ uint32_t murmur_int(uint32_t x, uint32_t h) {
  return fmix32(mix_h1(h, mix_k1(x)), 4);
}

__device__ __forceinline__ uint32_t murmur_long(uint64_t x, uint32_t h) {
  uint32_t h1 = mix_h1(h, mix_k1((uint32_t)(x & 0xffffffffull)));
  h1 = mix_h1(h1, mix_k1((uint32_t)(x >> 32)));
  return fmix32(h1, 8);
}

// ---------------------------------------------------------------------------
// xxhash64 (the 4- and 8-byte single-value paths)
// ---------------------------------------------------------------------------

#define XP1 0x9E3779B185EBCA87ull
#define XP2 0xC2B2AE3D27D4EB4Full
#define XP3 0x165667B19E3779F9ull
#define XP4 0x85EBCA77C2B2AE63ull
#define XP5 0x27D4EB2F165667C5ull

__device__ __forceinline__ uint64_t rotl64(uint64_t x, int r) {
  return (x << r) | (x >> (64 - r));
}

__device__ __forceinline__ uint64_t xx_avalanche(uint64_t h) {
  h ^= h >> 33;
  h *= XP2;
  h ^= h >> 29;
  h *= XP3;
  return h ^ (h >> 32);
}

__device__ __forceinline__ uint64_t xx_long(uint64_t x, uint64_t seed) {
  uint64_t h = seed + XP5 + 8ull;
  const uint64_t k1 = rotl64(x * XP2, 31) * XP1;
  h = rotl64(h ^ k1, 27) * XP1 + XP4;
  return xx_avalanche(h);
}

__device__ __forceinline__ uint64_t xx_int(uint32_t x, uint64_t seed) {
  uint64_t h = seed + XP5 + 4ull;
  h ^= (uint64_t)x * XP1;
  h = rotl64(h, 23) * XP2 + XP3;
  return xx_avalanche(h);
}

// ---------------------------------------------------------------------------
// key words
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t f32_bits(float d) {
  // -0.0, +0.0 and subnormals -> +0.0's bits; every NaN -> 0x7FC00000
  if (d != d) return 0x7fc00000u;
  if (fabsf(d) < 1.17549435e-38f) return 0u;
  return __float_as_uint(d);
}

__device__ __forceinline__ uint64_t f64_bits(double d) {
  // -0.0, +0.0 and subnormals -> 0; every NaN -> 0x7FF8000000000000
  if (d != d) return 0x7ff8000000000000ull;
  if (fabs(d) < 2.2250738585072014e-308) return 0ull;
  return (uint64_t)__double_as_longlong(d);
}

// The column's value at row r as the hash's input: *wide says whether it
// takes the 8-byte path.
__device__ __forceinline__ uint64_t key_word(const HSKeys& k, int c,
                                             long long r, bool* wide) {
  const void* p = k.data[c];
  *wide = k.elem[c] == 8;
  if (k.is_float[c]) {
    return *wide ? f64_bits(static_cast<const double*>(p)[r])
                 : (uint64_t)f32_bits(static_cast<const float*>(p)[r]);
  }
  switch (k.elem[c]) {
    case 8:
      return (uint64_t)static_cast<const long long*>(p)[r];
    case 4:
      return (uint32_t)static_cast<const int*>(p)[r];
    case 2:
      return (uint32_t)(int)static_cast<const short*>(p)[r];
    default:
      return (uint32_t)(int)static_cast<const int8_t*>(p)[r];
  }
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(HS_THREADS)
hs_rows(const __grid_constant__ HSKeys k, const uint8_t* __restrict__ active,
        long long n, int algo, unsigned long long seed, int nparts,
        long long* __restrict__ hash_out, int* __restrict__ pid_out,
        unsigned long long* __restrict__ counts) {
  extern __shared__ unsigned int s_cnt[];
  const bool counting = counts != nullptr;
  if (counting) {
    for (int p = threadIdx.x; p <= nparts; p += blockDim.x) s_cnt[p] = 0;
    __syncthreads();
  }
  const long long stride = (long long)gridDim.x * blockDim.x;
  // every thread runs the same number of rounds, so the block barrier
  // below is reached by all of them
  for (long long base = (long long)blockIdx.x * blockDim.x; base < n;
       base += stride) {
    const long long r = base + threadIdx.x;
    if (r < n) {
      uint32_t h32 = (uint32_t)seed;
      uint64_t h64 = seed;
      for (int c = 0; c < k.nkeys; ++c) {
        if (k.valid[c] != nullptr && !k.valid[c][r]) continue;
        bool wide;
        const uint64_t w = key_word(k, c, r, &wide);
        if (algo == ALGO_MURMUR3)
          h32 = wide ? murmur_long(w, h32) : murmur_int((uint32_t)w, h32);
        else
          h64 = wide ? xx_long(w, h64) : xx_int((uint32_t)w, h64);
      }
      if (hash_out != nullptr)
        hash_out[r] = algo == ALGO_MURMUR3 ? (long long)h32 : (long long)h64;
      if (nparts > 0) {
        int pid = nparts;
        if (active == nullptr || active[r]) {
          if (algo == ALGO_MURMUR3) {
            const int m = (int)h32 % nparts;
            pid = m < 0 ? m + nparts : m;
          } else if (algo == ALGO_XXHASH64) {
            const long long m = (long long)h64 % (long long)nparts;
            pid = (int)(m < 0 ? m + nparts : m);
          } else {
            pid = (int)(h64 % (unsigned long long)nparts);
          }
        }
        if (pid_out != nullptr) pid_out[r] = pid;
        if (counting) atomicAdd(s_cnt + pid, 1u);
      }
    }
  }
  if (counting) {
    __syncthreads();
    for (int p = threadIdx.x; p <= nparts; p += blockDim.x)
      if (s_cnt[p]) atomicAdd(counts + p, (unsigned long long)s_cnt[p]);
  }
}

static cudaError_t grid_for(long long n, int per_sm, int* blocks) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long want = (n + HS_THREADS - 1) / HS_THREADS;
  const long long cap = (long long)sms * per_sm;
  *blocks = (int)(want < 1 ? 1 : (want < cap ? want : cap));
  return cudaSuccess;
}

// Host entry, bound with ctypes; data/valid are host arrays of device
// pointers.  hash_out: [n] int64 or nullptr; pid_out: [n] int32 or nullptr;
// counts: [nparts + 1] uint64 (added to, not reset) or nullptr.  Returns
// cudaGetLastError() after the launch.
extern "C" int hash_rows(int nkeys, const void* const* data,
                         const void* const* valid, const int* elems,
                         const int* is_float, const void* active, long long n,
                         int algo, long long seed, int nparts, void* hash_out,
                         void* pid_out, void* counts, void* stream) {
  if (nkeys < 1 || nkeys > HS_MAX_KEYS || n < 0 ||
      algo < ALGO_MURMUR3 || algo > ALGO_XXHASH64_UMOD || nparts < 0 ||
      nparts > HS_MAX_PARTS || ((pid_out != nullptr || counts != nullptr) &&
                                nparts == 0))
    return (int)cudaErrorInvalidValue;
  HSKeys k = {};
  for (int c = 0; c < nkeys; ++c) {
    const int e = elems[c];
    if (e != 1 && e != 2 && e != 4 && e != 8) return (int)cudaErrorInvalidValue;
    if (is_float[c] && e != 4 && e != 8) return (int)cudaErrorInvalidValue;
    k.data[c] = data[c];
    k.valid[c] = static_cast<const uint8_t*>(valid[c]);
    k.elem[c] = e;
    k.is_float[c] = is_float[c] != 0;
  }
  k.nkeys = nkeys;
  if (n == 0) return (int)cudaSuccess;
  int blocks = 1;
  cudaError_t err = grid_for(n, 8, &blocks);
  if (err != cudaSuccess) return (int)err;
  const size_t shared =
      counts != nullptr ? (size_t)(nparts + 1) * sizeof(unsigned int) : 0;
  hs_rows<<<blocks, HS_THREADS, shared, static_cast<cudaStream_t>(stream)>>>(
      k, static_cast<const uint8_t*>(active), n, algo,
      (unsigned long long)seed, nparts, static_cast<long long*>(hash_out),
      static_cast<int*>(pid_out),
      static_cast<unsigned long long*>(counts));
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
