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
//   hash_rows  each thread takes HS_ROWS neighbouring rows and folds every
//              key column into their running hashes, left to right.  A
//              null leaves the hash as it was.  Per column kind:
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
// Design.  A thread's rows are read together: the live mask and each
// validity mask as one 4-byte word, each key as one or two 16-byte loads
// (a 2- or 1-byte key as one 8- or 4-byte load) when every pointer is
// 16-byte aligned, element by element otherwise (a view at an odd offset)
// and in the ragged last rows.  A column's kind is dispatched once per
// HS_ROWS rows, and the algorithm is a template parameter.  Partition ids
// take no division: the remainder is Lemire's direct computation
// (fastmod), (M x mod 2^64) d / 2^64 with M = floor((2^64 - 1) / d) + 1,
// exact for x < 2^52 when d <= 2^12 (Lemire, Kaser and Kurz, "Faster
// Remainder by Direct Computation", 2019); a 64-bit hash is folded as
// fastmod((fastmod(hi) << 32) | lo), and a signed hash is biased by 2^31
// or 2^63 and the bias's remainder taken off again.  The wrapper computes
// M and that remainder once per call (ops/hashing.py _divisor, whose
// Python model of this rule the CPU tests hold to %); this entry checks
// them.  Counts: the lanes of a warp that share an id find each other
// (__match_any_sync) and one of them adds their number, so a hot key
// costs one shared atomic a warp, not 32.  The SM count is queried once.
//
// Bound: device memory.  A row reads its key words, validity and active
// byte once and writes 4 bytes of id (8 of hash); the hash arithmetic is a
// few dozen integer operations per key, far under the card's integer rate.
// No fast-math: the float normalizations compare exact bit patterns.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#define HS_THREADS 256
#define HS_MAX_KEYS 8
#define HS_MAX_PARTS 4096

#define ALGO_MURMUR3 0
#define ALGO_XXHASH64 1
#define ALGO_XXHASH64_UMOD 2

#define HS_ROWS 8            // rows a thread
#define HS_BLOCKS_PER_SM 8   // blocks an SM, at most

// key kinds: how a column's element becomes the hash's input
#define KIND_I8 0   // bool, int8
#define KIND_I16 1
#define KIND_I32 2  // int32, dates, dictionary codes
#define KIND_I64 3
#define KIND_F32 4
#define KIND_F64 5

struct HSKeys {
  const void* data[HS_MAX_KEYS];
  const uint8_t* valid[HS_MAX_KEYS];  // nullptr: no nulls
  int kind[HS_MAX_KEYS];
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

template <int KIND> struct HSKind;
template <> struct HSKind<KIND_I8> { typedef uint8_t T; };
template <> struct HSKind<KIND_I16> { typedef unsigned short T; };
template <> struct HSKind<KIND_I32> { typedef unsigned T; };
template <> struct HSKind<KIND_I64> { typedef unsigned long long T; };
template <> struct HSKind<KIND_F32> { typedef unsigned T; };
template <> struct HSKind<KIND_F64> { typedef unsigned long long T; };

// An element's bits as the hash's input.
template <int KIND, typename T>
__device__ __forceinline__ uint64_t key_word(T v) {
  if (KIND == KIND_I8) return (uint32_t)(int)(int8_t)v;
  if (KIND == KIND_I16) return (uint32_t)(int)(short)v;
  if (KIND == KIND_I32) return (uint32_t)v;
  if (KIND == KIND_F32) return f32_bits(__uint_as_float((unsigned)v));
  if (KIND == KIND_F64)
    return f64_bits(__longlong_as_double((long long)v));
  return (uint64_t)v;
}

// HS_ROWS elements from row r on: whole (all in range, 16-byte aligned
// base) as 16-byte accesses (or one of 8 or 4 bytes), else one by one
// (zero past the last row).
template <typename T>
__device__ __forceinline__ void load_rows(const T* p, long long r, int rows,
                                          bool whole, T (&v)[HS_ROWS]) {
  constexpr int B = (int)sizeof(T) * HS_ROWS;
  if (whole) {
    if constexpr (B >= 16) {
      const uint4* q = reinterpret_cast<const uint4*>(p + r);
      uint4 a[B / 16];
#pragma unroll
      for (int i = 0; i < B / 16; ++i) a[i] = __ldcs(q + i);
      memcpy(v, a, B);
    } else if constexpr (B == 8) {
      const uint2 a = __ldcs(reinterpret_cast<const uint2*>(p + r));
      memcpy(v, &a, 8);
    } else {
      const unsigned a = __ldcs(reinterpret_cast<const unsigned*>(p + r));
      memcpy(v, &a, 4);
    }
  } else {
#pragma unroll
    for (int i = 0; i < HS_ROWS; ++i) v[i] = i < rows ? p[r + i] : (T)0;
  }
}

template <typename T>
__device__ __forceinline__ void store_rows(T* p, long long r, int rows,
                                           bool whole,
                                           const T (&v)[HS_ROWS]) {
  constexpr int B = (int)sizeof(T) * HS_ROWS;
  if (whole && B >= 16) {
#pragma unroll
    for (int i = 0; i < B / 16; ++i) {
      uint4 q;
      memcpy(&q, reinterpret_cast<const char*>(v) + 16 * i, 16);
      reinterpret_cast<uint4*>(p + r)[i] = q;
    }
  } else {
#pragma unroll
    for (int i = 0; i < HS_ROWS; ++i)
      if (i < rows) p[r + i] = v[i];
  }
}

// A mask's HS_ROWS bytes as flags (nullptr: all set).
__device__ __forceinline__ void flag_rows(const uint8_t* m, long long r,
                                          int rows, bool whole,
                                          bool (&f)[HS_ROWS]) {
  if (m == nullptr) {
#pragma unroll
    for (int i = 0; i < HS_ROWS; ++i) f[i] = true;
    return;
  }
  uint8_t b[HS_ROWS];
  load_rows<uint8_t>(m, r, rows, whole, b);
#pragma unroll
  for (int i = 0; i < HS_ROWS; ++i) f[i] = b[i] != 0;
}

template <int ALGO>
__device__ __forceinline__ uint64_t fold(uint64_t h, uint64_t w, bool wide) {
  if (ALGO == ALGO_MURMUR3)
    return wide ? murmur_long(w, (uint32_t)h)
                : murmur_int((uint32_t)w, (uint32_t)h);
  return wide ? xx_long(w, h) : xx_int((uint32_t)w, h);
}

// Fold key column c of a thread's rows into their hashes.
template <int ALGO, int KIND>
__device__ __forceinline__ void fold_key(const HSKeys& k, int c, long long r,
                                         int rows, bool whole,
                                         uint64_t (&h)[HS_ROWS]) {
  typedef typename HSKind<KIND>::T T;
  T v[HS_ROWS];
  bool ok[HS_ROWS];
  load_rows<T>(static_cast<const T*>(k.data[c]), r, rows, whole, v);
  flag_rows(k.valid[c], r, rows, whole, ok);
#pragma unroll
  for (int i = 0; i < HS_ROWS; ++i) {
    const uint64_t f = fold<ALGO>(h[i], key_word<KIND>(v[i]),
                                  KIND == KIND_I64 || KIND == KIND_F64);
    h[i] = ok[i] ? f : h[i];
  }
}

// ---------------------------------------------------------------------------
// partition ids without division
// ---------------------------------------------------------------------------

// x mod d for x < 2^52 and 1 <= d <= 2^12, M = floor((2^64 - 1) / d) + 1
// (mod 2^64): the high 64 bits of (M x mod 2^64) d, from two 32 x 32-bit
// products (d < 2^32).
__device__ __forceinline__ uint32_t fastmod(uint64_t x, uint64_t M,
                                            uint32_t d) {
  const uint64_t low = M * x;
  const uint64_t p0 = (uint64_t)(uint32_t)low * d;
  const uint64_t p1 = (low >> 32) * d;
  return (uint32_t)((p1 + (p0 >> 32)) >> 32);
}

// The partition of hash h among d: murmur3's pmod of (int32) h, xxhash64's
// pmod of (int64) h, or the unsigned remainder; `bias` is 2^31 mod d, 2^63
// mod d or 0.
template <int ALGO>
__device__ __forceinline__ int part_of(uint64_t h, uint32_t d, uint64_t M,
                                       uint32_t bias) {
  uint32_t r;
  if (ALGO == ALGO_MURMUR3) {
    r = fastmod((uint32_t)h ^ 0x80000000u, M, d);
  } else {
    const uint64_t a = ALGO == ALGO_XXHASH64 ? h ^ 0x8000000000000000ull : h;
    r = fastmod(((uint64_t)fastmod(a >> 32, M, d) << 32) | (a & 0xffffffffull),
                M, d);
  }
  return (int)(r >= bias ? r - bias : r + d - bias);
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

template <int ALGO, bool VEC>
__global__ void __launch_bounds__(HS_THREADS)
hs_rows(const __grid_constant__ HSKeys k, const uint8_t* __restrict__ active,
        long long n, unsigned long long seed, int nparts,
        unsigned long long magic, unsigned bias,
        long long* __restrict__ hash_out, int* __restrict__ pid_out,
        unsigned long long* __restrict__ counts) {
  extern __shared__ unsigned int s_cnt[];
  const bool counting = counts != nullptr;
  if (counting) {
    for (int p = threadIdx.x; p <= nparts; p += blockDim.x) s_cnt[p] = 0;
    __syncthreads();
  }
  const int lane = threadIdx.x & 31;
  const long long step = (long long)HS_THREADS * HS_ROWS;
  const long long stride = (long long)gridDim.x * step;
  // every thread runs the same number of rounds, so the warp and block
  // collectives below are reached by all of them
  for (long long base = (long long)blockIdx.x * step; base < n;
       base += stride) {
    const long long r = base + (long long)threadIdx.x * HS_ROWS;
    const int rows = r >= n ? 0 : (n - r < HS_ROWS ? (int)(n - r) : HS_ROWS);
    const bool whole = VEC && rows == HS_ROWS;
    uint64_t h[HS_ROWS];
#pragma unroll
    for (int i = 0; i < HS_ROWS; ++i)
      h[i] = ALGO == ALGO_MURMUR3 ? (uint64_t)(uint32_t)seed : seed;
    if (rows > 0) {
      for (int c = 0; c < k.nkeys; ++c) {
        switch (k.kind[c]) {
          case KIND_I64: fold_key<ALGO, KIND_I64>(k, c, r, rows, whole, h);
            break;
          case KIND_I32: fold_key<ALGO, KIND_I32>(k, c, r, rows, whole, h);
            break;
          case KIND_F64: fold_key<ALGO, KIND_F64>(k, c, r, rows, whole, h);
            break;
          case KIND_F32: fold_key<ALGO, KIND_F32>(k, c, r, rows, whole, h);
            break;
          case KIND_I16: fold_key<ALGO, KIND_I16>(k, c, r, rows, whole, h);
            break;
          default: fold_key<ALGO, KIND_I8>(k, c, r, rows, whole, h);
        }
      }
      if (hash_out != nullptr) {
        long long o[HS_ROWS];
#pragma unroll
        for (int i = 0; i < HS_ROWS; ++i) o[i] = (long long)h[i];
        store_rows<long long>(hash_out, r, rows, whole, o);
      }
    }
    if (nparts > 0) {
      bool live[HS_ROWS];
      flag_rows(rows > 0 ? active : nullptr, r, rows, whole, live);
      int pid[HS_ROWS];
#pragma unroll
      for (int i = 0; i < HS_ROWS; ++i)
        pid[i] = i >= rows ? -1
                 : live[i] ? part_of<ALGO>(h[i], (uint32_t)nparts, magic, bias)
                           : nparts;
      if (pid_out != nullptr && rows > 0)
        store_rows<int>(pid_out, r, rows, whole, pid);
      if (counting) {
        // the lanes of one id find each other; the lowest adds their number
#pragma unroll
        for (int i = 0; i < HS_ROWS; ++i) {
          const unsigned peers = __match_any_sync(0xffffffffu, pid[i]);
          if (pid[i] >= 0 && lane == __ffs(peers) - 1)
            atomicAdd(s_cnt + pid[i], (unsigned)__popc(peers));
        }
      }
    }
  }
  if (counting) {
    __syncthreads();
    for (int p = threadIdx.x; p <= nparts; p += blockDim.x)
      if (s_cnt[p]) atomicAdd(counts + p, (unsigned long long)s_cnt[p]);
  }
}

// The device's SM count, queried once.
static cudaError_t sm_count(int* sms) {
  static int cached = 0;
  if (cached == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&cached, cudaDevAttrMultiProcessorCount,
                                   dev);
    if (err != cudaSuccess) return err;
  }
  *sms = cached;
  return cudaSuccess;
}

static bool aligned16(const void* p) {
  return ((uintptr_t)p & 15) == 0;
}

template <int ALGO>
static void hs_launch(bool vec, int blocks, size_t shared, cudaStream_t st,
                      const HSKeys& k, const uint8_t* active, long long n,
                      unsigned long long seed, int nparts,
                      unsigned long long magic, unsigned bias,
                      long long* hash_out, int* pid_out,
                      unsigned long long* counts) {
  if (vec)
    hs_rows<ALGO, true><<<blocks, HS_THREADS, shared, st>>>(
        k, active, n, seed, nparts, magic, bias, hash_out, pid_out, counts);
  else
    hs_rows<ALGO, false><<<blocks, HS_THREADS, shared, st>>>(
        k, active, n, seed, nparts, magic, bias, hash_out, pid_out, counts);
}

// Host entry, bound with ctypes; data/valid are host arrays of device
// pointers.  magic and bias: the partition rule's constants for nparts
// (M = floor((2^64 - 1) / nparts) + 1 mod 2^64; 2^31 mod nparts for
// murmur3, 2^63 mod nparts for xxhash64, 0 for algo 2), checked here.
// hash_out: [n] int64 or nullptr; pid_out: [n] int32 or nullptr; counts:
// [nparts + 1] uint64 (added to, not reset) or nullptr.  Returns
// cudaGetLastError() after the launch.
extern "C" int hash_rows(int nkeys, const void* const* data,
                         const void* const* valid, const int* elems,
                         const int* is_float, const void* active, long long n,
                         int algo, long long seed, int nparts,
                         long long magic, int bias, void* hash_out,
                         void* pid_out, void* counts, void* stream) {
  if (nkeys < 1 || nkeys > HS_MAX_KEYS || n < 0 ||
      algo < ALGO_MURMUR3 || algo > ALGO_XXHASH64_UMOD || nparts < 0 ||
      nparts > HS_MAX_PARTS || ((pid_out != nullptr || counts != nullptr) &&
                                nparts == 0))
    return (int)cudaErrorInvalidValue;
  if (nparts > 0) {
    const unsigned long long d = (unsigned long long)nparts;
    const unsigned long long want =
        algo == ALGO_MURMUR3 ? (1ull << 31) % d
        : algo == ALGO_XXHASH64 ? (1ull << 63) % d : 0ull;
    if ((unsigned long long)magic != ~0ull / d + 1ull ||
        (unsigned long long)bias != want)
      return (int)cudaErrorInvalidValue;
  }
  HSKeys k = {};
  bool vec = aligned16(active) && aligned16(hash_out) && aligned16(pid_out);
  for (int c = 0; c < nkeys; ++c) {
    const int e = elems[c];
    if (e != 1 && e != 2 && e != 4 && e != 8) return (int)cudaErrorInvalidValue;
    if (is_float[c] && e != 4 && e != 8) return (int)cudaErrorInvalidValue;
    k.data[c] = data[c];
    k.valid[c] = static_cast<const uint8_t*>(valid[c]);
    k.kind[c] = is_float[c] ? (e == 8 ? KIND_F64 : KIND_F32)
                : e == 8 ? KIND_I64 : e == 4 ? KIND_I32
                : e == 2 ? KIND_I16 : KIND_I8;
    vec = vec && aligned16(data[c]) && aligned16(valid[c]);
  }
  k.nkeys = nkeys;
  if (n == 0) return (int)cudaSuccess;
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  const long long step = (long long)HS_THREADS * HS_ROWS;
  const long long want = (n + step - 1) / step;
  const long long cap = (long long)sms * HS_BLOCKS_PER_SM;
  const int blocks = (int)(want < cap ? want : cap);
  const size_t shared =
      counts != nullptr ? (size_t)(nparts + 1) * sizeof(unsigned int) : 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* act = static_cast<const uint8_t*>(active);
  long long* ho = static_cast<long long*>(hash_out);
  int* po = static_cast<int*>(pid_out);
  unsigned long long* co = static_cast<unsigned long long*>(counts);
  const unsigned long long sd = (unsigned long long)seed;
  const unsigned long long mg = (unsigned long long)magic;
  if (algo == ALGO_MURMUR3)
    hs_launch<ALGO_MURMUR3>(vec, blocks, shared, st, k, act, n, sd, nparts,
                            mg, (unsigned)bias, ho, po, co);
  else if (algo == ALGO_XXHASH64)
    hs_launch<ALGO_XXHASH64>(vec, blocks, shared, st, k, act, n, sd, nparts,
                             mg, (unsigned)bias, ho, po, co);
  else
    hs_launch<ALGO_XXHASH64_UMOD>(vec, blocks, shared, st, k, act, n, sd,
                                  nparts, mg, (unsigned)bias, ho, po, co);
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
