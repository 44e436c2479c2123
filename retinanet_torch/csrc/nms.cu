// Greedy (soft-)NMS over independent lanes, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel retinanet_tpu/ops/pallas/nms_kernel.py:36
// (_nms_kernel, entry pallas_nms). Same function as the plain PyTorch
// version retinanet_torch/ops/nms.py:batched_nms, bit for bit on the
// selection: first-index argmax, the same IoU arithmetic in the same order
// (no FMA contraction: every product and sum below is an explicit _rn
// intrinsic), expf (not __expf) for the soft decay, and the same -1e10
// suppression constant.
//
// Design: one CTA per lane. The lane's k candidates are loaded once into
// shared memory as five planes (x1, y1, x2, y2, score; 20 B a candidate) and
// never leave it until the lane is done. Each thread owns the candidates
// j = tid, tid + blockDim, ... Each round:
//   1. every thread takes the first-index argmax of its own candidates;
//   2. a warp-shuffle argmax (ties to the lower index), then lane 0 of each
//      warp posts its pair to a double-buffered partials array;
//   3. one __syncthreads; every warp reduces the partials itself, so the
//      pick needs no second barrier to be broadcast;
//   4. if the pick is not above score_threshold the lane is frozen, which
//      ends the loop for the whole CTA (the pick is uniform);
//   5. each thread suppresses its own candidates against the pick.
// One barrier a round; the candidates ride no global memory in the loop.
// The ragged k edge is masked by the loops themselves, so inputs need no
// padding, and nothing is allocated here.
//
// Bound on an H100 at the flagship shape (L = 640 lanes, k = 256, 100
// rounds): about 3.8 MB moved (1.1 us at 3.35 TB/s) and about 20 f32
// operations per candidate per round, 3.3e8 in all (4.9 us at 67 TFLOP/s).
// The kernel is limited instead by the latency of the 100 dependent rounds:
// each is a reduction across the CTA and one barrier.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr float kNegInf = -1e10f;  // the JAX package's _NEG_INF

enum Mode { kHard = 0, kSoftGaussian = 1, kSoftHard = 2 };

__device__ __forceinline__ void take_better(float& v, int& i, float ov,
                                            int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    take_better(v, i, ov, oi);
  }
}

__device__ __forceinline__ float box_area(float x1, float y1, float x2,
                                          float y2) {
  return __fmul_rn(fmaxf(__fsub_rn(x2, x1), 0.0f),
                   fmaxf(__fsub_rn(y2, y1), 0.0f));
}

__global__ void __launch_bounds__(kMaxThreads)
    nms_lanes_kernel(const float* __restrict__ boxes,
                     const float* __restrict__ scores, int k, int max_det,
                     float iou_thr, float score_thr, float two_sigma,
                     int mode, int* __restrict__ out_idx,
                     float* __restrict__ out_scores,
                     int* __restrict__ out_valid) {
  extern __shared__ float planes[];
  float* x1 = planes;
  float* y1 = x1 + k;
  float* x2 = y1 + k;
  float* y2 = x2 + k;
  float* sc = y2 + k;
  __shared__ float part_v[2][kMaxWarps];
  __shared__ int part_i[2][kMaxWarps];

  const int lane = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int warp = tid >> 5;
  const int wl = tid & 31;
  const int nwarps = nthreads >> 5;

  const float* lb = boxes + static_cast<size_t>(lane) * k * 4;
  const float* ls = scores + static_cast<size_t>(lane) * k;
  for (int j = tid; j < k; j += nthreads) {
    x1[j] = lb[4 * j + 0];
    y1[j] = lb[4 * j + 1];
    x2[j] = lb[4 * j + 2];
    y2[j] = lb[4 * j + 3];
    sc[j] = ls[j];
  }
  __syncthreads();

  int* idx_row = out_idx + static_cast<size_t>(lane) * max_det;
  float* score_row = out_scores + static_cast<size_t>(lane) * max_det;
  int rounds = 0;
  for (int r = 0; r < max_det; ++r) {
    float v = -INFINITY;
    int bi = INT_MAX;
    for (int j = tid; j < k; j += nthreads) take_better(v, bi, sc[j], j);
    warp_argmax(v, bi);
    const int buf = r & 1;
    if (wl == 0) {
      part_v[buf][warp] = v;
      part_i[buf][warp] = bi;
    }
    __syncthreads();
    v = wl < nwarps ? part_v[buf][wl] : -INFINITY;
    bi = wl < nwarps ? part_i[buf][wl] : INT_MAX;
    warp_argmax(v, bi);
    if (!(v > score_thr)) break;  // v and bi are the same in every thread
    if (tid == 0) {
      idx_row[r] = bi;
      score_row[r] = v;
    }
    rounds = r + 1;

    const float bx1 = x1[bi], by1 = y1[bi], bx2 = x2[bi], by2 = y2[bi];
    const float barea = box_area(bx1, by1, bx2, by2);
    for (int j = tid; j < k; j += nthreads) {
      const float cx1 = x1[j], cy1 = y1[j], cx2 = x2[j], cy2 = y2[j];
      const float iw =
          fmaxf(__fsub_rn(fminf(bx2, cx2), fmaxf(bx1, cx1)), 0.0f);
      const float ih =
          fmaxf(__fsub_rn(fminf(by2, cy2), fmaxf(by1, cy1)), 0.0f);
      const float inter = __fmul_rn(iw, ih);
      const float uni = fmaxf(
          __fsub_rn(__fadd_rn(barea, box_area(cx1, cy1, cx2, cy2)), inter),
          1e-8f);
      const float iou = __fdiv_rn(inter, uni);
      float s = sc[j];
      if (mode == kHard) {
        if (iou > iou_thr) s = kNegInf;
      } else if (mode == kSoftGaussian) {
        float scale = expf(__fdiv_rn(-__fmul_rn(iou, iou), two_sigma));
        if (iou > iou_thr) scale = 0.0f;
        s = __fmul_rn(s, scale);
      } else {
        s = __fmul_rn(s, iou <= iou_thr ? 1.0f : 0.0f);
      }
      sc[j] = j == bi ? kNegInf : s;
    }
  }

  for (int r = rounds + tid; r < max_det; r += nthreads) {
    idx_row[r] = 0;  // -1 for empty, clamped to 0 as the JAX kernel does
    score_row[r] = -1.0f;
  }
  if (tid == 0) out_valid[lane] = rounds;
}

}  // namespace

extern "C" {

// Launches on `stream` (a cudaStream_t) and returns cudaGetLastError(), or
// the error of the set-up calls; the caller raises when it is not 0.
int nms_lanes_launch(const float* boxes, const float* scores, int lanes,
                     int k, int max_det, float iou_thr, float score_thr,
                     float two_sigma, int mode, int* out_idx,
                     float* out_scores, int* out_valid, int device,
                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = k >= kMaxThreads ? kMaxThreads : ((k + 31) / 32) * 32;
  const size_t smem = static_cast<size_t>(5) * k * sizeof(float);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(nms_lanes_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  nms_lanes_kernel<<<lanes, threads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      boxes, scores, k, max_det, iou_thr, score_thr, two_sigma, mode,
      out_idx, out_scores, out_valid);
  return static_cast<int>(cudaGetLastError());
}

const char* nms_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
