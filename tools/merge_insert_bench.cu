// merge_insert_bench: variants of the merge table's insert pass
// (csrc/hash_agg.cu hm_merge_k) timed at Q18's final shape on the card:
// 4,194,304 int64 keys drawn from 15,000,000 (about 3,660,000 groups) into
// 2^23 16-byte slot records, one float64 sum channel's largest-|x| word.
// MODE bits: 1 relaxed tag loads, CAS and publish (unsafe, for the fence's
// cost); 2 gid = slot (values indexed by slot, no counter); 4 no value
// atomic; 8 no meta or value init; 16 the claimer writes its own |x| word;
// 32 relaxed probes with an acquire fence only before reading another
// thread's record; 64 gid = the claiming row (no counter, holes).  Each
// variant runs at 2 and 8 blocks an SM and at one row a thread.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//       -o build/merge_insert_bench tools/merge_insert_bench.cu
//   build/merge_insert_bench
#include <cooperative_groups.h>
#include <cuda/atomic>
#include <cuda_runtime.h>
#include <stdio.h>
#include <stdlib.h>
#include <vector>
#include <random>

__device__ __forceinline__ unsigned long long mix64(unsigned long long h) {
  h ^= h >> 30; h *= 0xbf58476d1ce4e5b9ULL; h ^= h >> 27;
  h *= 0x94d049bb133111ebULL; h ^= h >> 31; return h;
}
__device__ __forceinline__ long long next_gid(unsigned long long* ng) {
  namespace cg = cooperative_groups;
  cg::coalesced_group g = cg::coalesced_threads();
  unsigned long long base = 0;
  if (g.thread_rank() == 0) base = atomicAdd(ng, (unsigned long long)g.size());
  return (long long)(g.shfl(base, 0) + g.thread_rank());
}
__device__ __forceinline__ void absmax(unsigned long long* m, double x) {
  const double a = fabs(x);
  if (!(a <= 1.7976931348623157e308) || a == 0.0) return;
  const unsigned long long b = (unsigned long long)__double_as_longlong(a);
  if (b > *m) atomicMax(m, b);
}

template <int MODE>
__global__ void __launch_bounds__(256) ins(const long long* keys, const double* x, long long n,
    long long* recs, long long cap, long long* meta, long long* vals,
    unsigned long long* ng, int* rgid) {
  const bool relaxed = MODE & 1, byslot = MODE & 2, novals = MODE & 4, noinit = MODE & 8;
  const bool claimmax = MODE & 16, lazyacq = MODE & 32, rowgid = MODE & 64;
  long long created = 0;
  const long long mask = cap - 1;
  for (long long r = blockIdx.x * 256LL + threadIdx.x; r < n; r += (long long)gridDim.x * 256) {
    const long long w = keys[r];
    long long slot = (long long)(mix64(mix64(0x9e3779b97f4a7c15ULL) ^ ((unsigned long long)w + 0x9e3779b97f4a7c15ULL)) & mask);
    long long gid;
    while (true) {
      long long* rec = recs + slot * 2;
      cuda::atomic_ref<int, cuda::thread_scope_device> tag(*reinterpret_cast<int*>(rec));
      int s = (relaxed || lazyacq) ? tag.load(cuda::std::memory_order_relaxed) : tag.load(cuda::std::memory_order_acquire);
      if (s == 0) {
        int e = 0;
        bool ok = (relaxed || lazyacq) ? tag.compare_exchange_strong(e, 1, cuda::std::memory_order_relaxed)
                          : tag.compare_exchange_strong(e, 1, cuda::std::memory_order_acq_rel);
        if (ok) {
          gid = byslot ? slot : rowgid ? r : next_gid(ng);
          created++;
          rec[1] = w;
          if (!noinit) {
            long long* m = meta + gid * 3; m[0] = slot; m[1] = 0; m[2] = w;
            long long* v = vals + gid * 4; v[0] = 0; v[1] = 0; v[2] = 0;
            const double a = fabs(x[r]);
            v[3] = claimmax && a <= 1.7976931348623157e308 ? __double_as_longlong(a) : 0;
          }
          if (relaxed) tag.store((int)(2 + gid), cuda::std::memory_order_relaxed);
          else tag.store((int)(2 + gid), cuda::std::memory_order_release);
          if (claimmax) { rgid[r] = (int)gid; goto next; }
          break;
        }
        s = e;
      }
      while (s == 1) s = relaxed ? tag.load(cuda::std::memory_order_relaxed) : tag.load(cuda::std::memory_order_acquire);
      if (lazyacq) cuda::atomic_thread_fence(cuda::std::memory_order_acquire, cuda::thread_scope_device);
      if (__ldcg(rec + 1) == w) { gid = s - 2; break; }
      slot = (slot + 1) & mask;
    }
    rgid[r] = (int)gid;
    if (rowgid) meta[r * 3] = -1;
    if (!novals) absmax(reinterpret_cast<unsigned long long*>(vals + gid * 4) + 3, x[r]);
  next:;
  }
  if (rowgid) {
    for (int o = 16; o > 0; o >>= 1) created += __shfl_down_sync(0xffffffffu, created, o);
    if ((threadIdx.x & 31) == 0 && created) atomicAdd(ng, (unsigned long long)created);
  }
}

template <int MODE>
float run(const long long* k, const double* x, long long n, long long* recs, long long cap,
          long long* meta, long long* vals, unsigned long long* ng, int* rg, int blocks) {
  cudaEvent_t a, b; cudaEventCreate(&a); cudaEventCreate(&b);
  float total = 0;
  for (int rep = 0; rep < 6; rep++) {
    cudaMemset(recs, 0, cap * 16); cudaMemset(ng, 0, 8); cudaMemset(vals, 0, cap * 32);
    cudaEventRecord(a);
    ins<MODE><<<blocks, 256>>>(k, x, n, recs, cap, meta, vals, ng, rg);
    cudaEventRecord(b); cudaEventSynchronize(b);
    float ms; cudaEventElapsedTime(&ms, a, b);
    if (rep) total += ms;
  }
  unsigned long long g; cudaMemcpy(&g, ng, 8, cudaMemcpyDeviceToHost);
  printf("mode %3d (row gid %d, relaxed %d, gid=slot %d, no value atomic %d, no init %d, claimer max %d, lazy acquire %d) blocks %d: %.4f ms, groups %llu\n",
         MODE, (MODE >> 6) & 1, MODE & 1, (MODE >> 1) & 1, (MODE >> 2) & 1, (MODE >> 3) & 1, (MODE >> 4) & 1, (MODE >> 5) & 1, blocks, total / 5, g);
  return total / 5;
}

int main() {
  const long long n = 4 << 20, cap = 1 << 23;
  std::vector<long long> hk(n); std::vector<double> hx(n);
  std::mt19937_64 g(18);
  for (long long i = 0; i < n; i++) { hk[i] = 1 + (long long)(g() % 15000000ULL); hx[i] = 1 + (double)(g() % 50); }
  long long *k, *recs, *meta, *vals; double* x; unsigned long long* ng; int* rg;
  cudaMalloc(&k, n * 8); cudaMalloc(&x, n * 8); cudaMalloc(&recs, cap * 16);
  cudaMalloc(&meta, cap * 24); cudaMalloc(&vals, cap * 32); cudaMalloc(&ng, 8); cudaMalloc(&rg, n * 4);
  cudaMemcpy(k, hk.data(), n * 8, cudaMemcpyHostToDevice);
  cudaMemcpy(x, hx.data(), n * 8, cudaMemcpyHostToDevice);
  int sms; cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  for (int blocks : {sms * 2, sms * 8, (int)((n + 255) / 256)}) {
    run<0>(k, x, n, recs, cap, meta, vals, ng, rg, blocks);
    run<1>(k, x, n, recs, cap, meta, vals, ng, rg, blocks);
    run<2>(k, x, n, recs, cap, meta, vals, ng, rg, blocks);
    run<4>(k, x, n, recs, cap, meta, vals, ng, rg, blocks);
    run<8>(k, x, n, recs, cap, meta, vals, ng, rg, blocks);
    run<15>(k, x, n, recs, cap, meta, vals, ng, rg, blocks);
    run<16>(k, x, n, recs, cap, meta, vals, ng, rg, blocks);
    run<32>(k, x, n, recs, cap, meta, vals, ng, rg, blocks);
    run<48>(k, x, n, recs, cap, meta, vals, ng, rg, blocks);
    run<112>(k, x, n, recs, cap, meta, vals, ng, rg, blocks);
  }
  printf("err %s\n", cudaGetErrorString(cudaGetLastError()));
  return 0;
}
