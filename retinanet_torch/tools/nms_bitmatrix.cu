// Hard greedy NMS by a suppression bit matrix: the alternative to the sweep
// kernel of csrc/nms.cu that tools/nms_experiments.py times beside it. The
// package does not call it.
//
// One CTA of 256 threads per lane, k <= 256, hard mode, score_threshold >=
// -1e10. The n candidates above the threshold are ordered as the sweep orders
// them (score descending, lower index first). Then every thread fills words
// of the n x n/32 matrix: bit j of row i says that candidate j > i has IoU
// with candidate i above the threshold (the same _rn arithmetic as
// csrc/nms.cu). Last, warp 0 scans the order: a candidate not yet removed is
// picked and ORs its row into the removed set. All the IoUs are computed in
// parallel, n^2 / 2 of them whatever the number of picks; the sweep computes
// only those of the rounds a lane runs, one round after the other.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kCap = 256;
constexpr int kWords = kCap / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float box_area(float x1, float y1, float x2,
                                          float y2) {
  return __fmul_rn(fmaxf(__fsub_rn(x2, x1), 0.0f),
                   fmaxf(__fsub_rn(y2, y1), 0.0f));
}

__global__ void __launch_bounds__(kCap)
    nms_bitmatrix_kernel(const float* __restrict__ boxes,
                         const float* __restrict__ scores, int k, int max_det,
                         float iou_thr, float score_thr,
                         int* __restrict__ out_idx,
                         float* __restrict__ out_scores,
                         int* __restrict__ out_valid) {
  __shared__ float sc[kCap], x1[kCap], y1[kCap], x2[kCap], y2[kCap],
      area[kCap];
  __shared__ int order[kCap];
  __shared__ unsigned mask[kCap * kWords];

  const int lane = blockIdx.x;
  const int tid = threadIdx.x;
  const int wl = tid & 31;
  const float s = tid < k ? scores[static_cast<size_t>(lane) * k + tid]
                          : -INFINITY;
  sc[tid] = s;
  __syncthreads();
  const bool above = tid < k && s > score_thr;
  const int n = __syncthreads_count(above);
  const bool in_order =
      __syncthreads_and(tid + 1 >= k || s >= sc[tid + 1]) != 0;
  if (above) {
    int rank = tid;
    if (!in_order) {
      rank = 0;
      for (int m = 0; m < k; ++m) {
        const float o = sc[m];
        rank += (o > s || (o == s && m < tid)) ? 1 : 0;
      }
    }
    order[rank] = tid;
  }
  __syncthreads();
  if (tid < n) {
    const float4 b = reinterpret_cast<const float4*>(
        boxes)[static_cast<size_t>(lane) * k + order[tid]];
    x1[tid] = b.x;
    y1[tid] = b.y;
    x2[tid] = b.z;
    y2[tid] = b.w;
    area[tid] = box_area(b.x, b.y, b.z, b.w);
  }
  __syncthreads();

  const int words = (n + 31) >> 5;
  for (int item = tid; item < n * kWords; item += kCap) {
    const int i = item / kWords, w = item % kWords;
    if (w < (i >> 5) || w >= words) continue;
    const float bx1 = x1[i], by1 = y1[i], bx2 = x2[i], by2 = y2[i],
                barea = area[i];
    unsigned bits = 0;
    for (int b = 0; b < 32; ++b) {
      const int j = 32 * w + b;
      if (j <= i || j >= n) continue;
      const float iw =
          fmaxf(__fsub_rn(fminf(bx2, x2[j]), fmaxf(bx1, x1[j])), 0.0f);
      const float ih =
          fmaxf(__fsub_rn(fminf(by2, y2[j]), fmaxf(by1, y1[j])), 0.0f);
      const float inter = __fmul_rn(iw, ih);
      float iou = 0.0f;
      if (inter > 0.0f) {
        const float uni =
            fmaxf(__fsub_rn(__fadd_rn(barea, area[j]), inter), 1e-8f);
        iou = __fdiv_rn(inter, uni);
      }
      if (iou > iou_thr) bits |= 1u << b;
    }
    mask[item] = bits;
  }
  __syncthreads();
  if (tid >= 32) return;

  int* idx_row = out_idx + static_cast<size_t>(lane) * max_det;
  float* score_row = out_scores + static_cast<size_t>(lane) * max_det;
  unsigned removed = 0;  // thread w < kWords: the removed bits of word w
  int picks = 0;
  for (int w = 0; w < words && picks < max_det; ++w) {
    const unsigned in_range =
        n - 32 * w >= 32 ? kFull : (1u << (n - 32 * w)) - 1u;
    unsigned avail = ~__shfl_sync(kFull, removed, w) & in_range;
    while (avail != 0 && picks < max_det) {
      const int b = __ffs(avail) - 1;
      const int i = 32 * w + b;
      if (wl == 0) {
        const int j = order[i];
        idx_row[picks] = j;
        score_row[picks] = sc[j];
      }
      ++picks;
      if (wl >= (i >> 5) && wl < words) removed |= mask[i * kWords + wl];
      avail = ~__shfl_sync(kFull, removed, w) & in_range & ~((2u << b) - 1u);
    }
  }
  for (int r = picks + wl; r < max_det; r += 32) {
    idx_row[r] = 0;
    score_row[r] = -1.0f;
  }
  if (wl == 0) out_valid[lane] = picks;
}

}  // namespace

extern "C" {

// The interface of nms_sweep_launch in csrc/nms.cu; k above 256 is refused.
int nms_bitmatrix_launch(const float* boxes, const float* scores, int lanes,
                         int k, int max_det, float iou_thr, float score_thr,
                         int* out_idx, float* out_scores, int* out_valid,
                         int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (k > kCap) return static_cast<int>(cudaErrorInvalidValue);
  nms_bitmatrix_kernel<<<lanes, kCap, 0, static_cast<cudaStream_t>(stream)>>>(
      boxes, scores, k, max_det, iou_thr, score_thr, out_idx, out_scores,
      out_valid);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
