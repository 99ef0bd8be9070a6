// onesweep_bench: one pass of csrc/radix.cuh's one-sweep sort alone on the
// card, beside a plain copy of the same 12 bytes a row.  n random 64-bit
// keys (xorshift), int32 row numbers: the gather-histogram kernel, then
// the 8 byte passes, each timed between its own pair of events, 10 runs
// after one warm-up; the sorted
// keys are checked at the end.  tools/onesweep_bench.sh builds it over
// variants of the header (-I points at the header's directory).
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//       -I spark_rapids_tpu_torch/csrc -o build/onesweep_bench \
//       tools/onesweep_bench.cu
//   build/onesweep_bench [n]
#include <cuda_runtime.h>
#include <stdio.h>
#include <stdlib.h>
#include <vector>

#include "radix.cuh"

struct Keys {
  const unsigned long long* k;
  __device__ unsigned long long operator()(long long r) const { return k[r]; }
};

__global__ void copy12(const unsigned long long* ki, const int* vi,
                       unsigned long long* ko, int* vo, long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    ko[i] = ki[i];
    vo[i] = vi[i];
  }
}

int main(int argc, char** argv) {
  const long long n = argc > 1 ? atoll(argv[1]) : 4194304;
  const int passes = 8, reps = 10;
  std::vector<unsigned long long> h(n);
  unsigned long long x = 88172645463325252ull;
  for (long long i = 0; i < n; ++i) {
    x ^= x << 13;
    x ^= x >> 7;
    x ^= x << 17;
    h[i] = x;
  }
  unsigned long long* src;
  cudaMalloc(&src, n * 8);
  cudaMemcpy(src, h.data(), n * 8, cudaMemcpyHostToDevice);
  void* scratch;
  cudaMalloc(&scratch, os_scratch(n, passes, nullptr, nullptr));
  OSScratch sc;
  os_scratch(n, passes, scratch, &sc);
  int hb;
  os_hist_blocks(n, &hb);
  cudaEvent_t e[passes + 2];
  for (auto& ev : e) cudaEventCreate(&ev);
  float tot[passes + 1] = {0};
  for (int r = 0; r <= reps; ++r) {
    os_clear(sc, 0);
    cudaEventRecord(e[0]);
    os_gather_hist<Keys><<<hb, OS_HIST_THREADS>>>(sc.b, sc.state, 0, 1,
                                                  Keys{src}, 8, n, sc.hist);
    cudaEventRecord(e[1]);
    for (int p = 0; p < passes; ++p) {
      os_pass_launch(sc, p, n, 8 * p, 0);
      cudaEventRecord(e[2 + p]);
    }
    cudaEventSynchronize(e[passes + 1]);
    for (int i = 0; r > 0 && i <= passes; ++i) {
      float ms;
      cudaEventElapsedTime(&ms, e[i], e[i + 1]);
      tot[i] += ms;
    }
  }
  int side;
  cudaMemcpy(&side, sc.state + passes, 4, cudaMemcpyDeviceToHost);
  std::vector<unsigned long long> out(n);
  cudaMemcpy(out.data(), sc.b.keys[side], n * 8, cudaMemcpyDeviceToHost);
  bool sorted = true;
  for (long long i = 1; i < n; ++i) sorted &= out[i - 1] <= out[i];
  float mean = 0;
  for (int p = 0; p < passes; ++p) mean += tot[1 + p] / reps / passes;
  printf("n %lld: gather_hist %.4f ms, pass mean %.4f ms (", n,
         tot[0] / reps, mean);
  for (int p = 0; p < passes; ++p)
    printf("%s%.4f", p ? " " : "", tot[1 + p] / reps);
  printf("), sorted %s, %s\n", sorted ? "yes" : "NO",
         cudaGetErrorString(cudaGetLastError()));
  float ms;
  cudaEventRecord(e[0]);
  for (int r = 0; r < reps; ++r)
    copy12<<<132 * 8, 256>>>(sc.b.keys[0], sc.b.vals[0], sc.b.keys[1],
                             sc.b.vals[1], n);
  cudaEventRecord(e[1]);
  cudaEventSynchronize(e[1]);
  cudaEventElapsedTime(&ms, e[0], e[1]);
  printf("copy of 12 B a row %.4f ms\n", ms / reps);
  return 0;
}
