// The int8 mma.sync rate of a card: each warp runs chains of independent
// m16n8k32 s8 products on registers only (no loads), so the time is the
// tensor cores' alone. Built and called by
// tools/int8_conv_experiments.py --mma_peak.
#include <cuda_runtime.h>

namespace {

template <int ACC>
__global__ void __launch_bounds__(256) mma_peak_kernel(int* out, int iters,
                                                       int seed) {
  int acc[ACC][4] = {};
  const int a[4] = {seed, seed + 1, seed + 2, seed + 3};
  const int b0 = seed * 3, b1 = seed * 5;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < ACC; ++j) {
      asm volatile(
          "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
          "{%0, %1, %2, %3};\n"
          : "+r"(acc[j][0]), "+r"(acc[j][1]), "+r"(acc[j][2]),
            "+r"(acc[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
    }
  }
  int sum = 0;
  for (int j = 0; j < ACC; ++j) sum += acc[j][0] + acc[j][3];
  if (sum == 12345) out[0] = sum;  // keeps the products
}

}  // namespace

extern "C" {

// int8 TOPS of `ctas_per_sm` CTAs of 256 threads an SM, each warp 16
// independent accumulators, over `iters` rounds; negative: a cudaError_t.
double mma_peak_tops(int ctas_per_sm, int iters) {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  int* out = nullptr;
  if (cudaMalloc(&out, sizeof(int)) != cudaSuccess) return -1.0;
  const dim3 grid(sms * ctas_per_sm);
  mma_peak_kernel<16><<<grid, 256>>>(out, 16, 1);  // warm-up
  cudaEvent_t start, end;
  cudaEventCreate(&start);
  cudaEventCreate(&end);
  cudaEventRecord(start);
  mma_peak_kernel<16><<<grid, 256>>>(out, iters, 1);
  cudaEventRecord(end);
  cudaEventSynchronize(end);
  float ms = 0.0f;
  cudaEventElapsedTime(&ms, start, end);
  const cudaError_t err = cudaGetLastError();
  cudaEventDestroy(start);
  cudaEventDestroy(end);
  cudaFree(out);
  if (err != cudaSuccess) return -static_cast<double>(err);
  const double ops = 2.0 * 16 * 8 * 32 * 16 * static_cast<double>(iters) *
                     8 * grid.x;
  return ops / (ms * 1e-3) / 1e12;
}

}  // extern "C"
