// Anchor <-> ground-truth IoU matching for the label encoder, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel
// retinanet_tpu/ops/pallas/matching_kernel.py:41 (_match_kernel, entry
// pallas_match, vmapped over the batch by data/label_encoder.py). Same
// function as the plain PyTorch version
// retinanet_torch/ops/match.py:match_lanes_plain, bit for bit on all four
// outputs: the IoU is computed in the order of data/box_utils.compute_iou
// with every product, sum and quotient an explicit _rn intrinsic (no FMA
// contraction), and both argmaxes take the lowest index on ties.
//
// For each image b: per anchor the best IoU over the valid boxes and the
// lowest box index attaining it; per box the best IoU over the anchors and
// the lowest anchor index attaining it. An invalid box counts as IoU -1:
// with no valid box an anchor gets (-1, 0), an invalid box gets (-1, 0).
// Valid boxes may sit anywhere in the row, not only in a prefix.
//
// Design. The TPU kernel walks the anchor tiles one after the other and
// carries the per-box bests in scratch memory; here the tiles run in
// parallel. One CTA per (image, tile of 256 anchors):
//   1. warp 0 compacts the indices of the image's valid boxes into shared
//      memory (ballot + popcount), then all threads stage those boxes'
//      corners and areas there once;
//   2. each thread owns one anchor and loops over the valid boxes in index
//      order: a strict > keeps the lowest box index, and the per-anchor
//      result needs no reduction;
//   3. per box, each warp that saw any IoU above 0 reduces (IoU bits, lowest
//      anchor index) with two redux.sync instructions, and its lane 0 posts
//      the pair as one 64-bit key (IoU bits high: monotone as unsigned for
//      IoU in [0, 1]; ~anchor index low, so the lowest index wins a tie)
//      with atomicMax to the CTA's key in shared memory;
//   4. the CTA posts each nonzero key with one atomicMax to global memory.
// A second small kernel decodes the keys. A key still 0 is a valid box
// whose IoU is 0 with every anchor: the answer is (0, anchor 0), which is
// the first-index argmax of a row of zeros. atomicMax commutes, so the
// result does not depend on the order in which the CTAs run.
//
// Bound on an H100 at the flagship shape (A = 76,725 anchors, B = 8 images,
// G = 100 boxes, about 7 valid): A*16 + B*G*17 bytes in, B*A*8 + B*G*8 out,
// 6.2 MB, 1.8 us at 3.35 TB/s; about 25 f32 operations per (anchor, valid
// box) pair, 0.1 to 1.5 G operations, 1.6 to 23 us at 67 TFLOP/s. Bytes bound
// it for the usual dozen boxes an image, operations when all 100 are valid.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// Shared memory for G boxes: the compacted index, four corners, the area
// (4 B each) and the 64-bit key.
constexpr int kBytesPerBox = 6 * 4 + 8;

__global__ void __launch_bounds__(kThreads)
    match_kernel(const float* __restrict__ anchors,
                 const float* __restrict__ gt_boxes,
                 const uint8_t* __restrict__ gt_valid, int num_anchors,
                 int num_gt, float* __restrict__ max_iou,
                 int* __restrict__ argmax_gt,
                 unsigned long long* __restrict__ keys) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* s_key = smem;                        // [num_gt]
  float* s_x1 = reinterpret_cast<float*>(s_key + num_gt);  // [num_gt] each
  float* s_y1 = s_x1 + num_gt;
  float* s_x2 = s_y1 + num_gt;
  float* s_y2 = s_x2 + num_gt;
  float* s_area = s_y2 + num_gt;
  int* s_idx = reinterpret_cast<int*>(s_area + num_gt);
  __shared__ int s_count;

  const int image = blockIdx.y;
  const int tid = threadIdx.x;
  const int wl = tid & 31;
  const float* boxes = gt_boxes + static_cast<size_t>(image) * num_gt * 4;
  const uint8_t* valid = gt_valid + static_cast<size_t>(image) * num_gt;

  if (tid < 32) {
    int count = 0;
    for (int base = 0; base < num_gt; base += 32) {
      const int g = base + wl;
      const bool v = g < num_gt && valid[g] != 0;
      const unsigned m = __ballot_sync(kFull, v);
      if (v) s_idx[count + __popc(m & ((1u << wl) - 1u))] = g;
      count += __popc(m);
    }
    if (wl == 0) s_count = count;
  }
  __syncthreads();
  const int count = s_count;
  for (int j = tid; j < count; j += kThreads) {
    const float* box = boxes + 4 * s_idx[j];
    const float cx = box[0], cy = box[1], w = box[2], h = box[3];
    const float hw = __fmul_rn(w, 0.5f), hh = __fmul_rn(h, 0.5f);
    s_x1[j] = __fsub_rn(cx, hw);
    s_y1[j] = __fsub_rn(cy, hh);
    s_x2[j] = __fadd_rn(cx, hw);
    s_y2[j] = __fadd_rn(cy, hh);
    s_area[j] = __fmul_rn(w, h);
    s_key[j] = 0ull;
  }
  __syncthreads();

  const int a = blockIdx.x * kThreads + tid;
  const bool live = a < num_anchors;
  float ax1 = 0.f, ay1 = 0.f, ax2 = 0.f, ay2 = 0.f, a_area = 0.f;
  if (live) {
    const float4 box = reinterpret_cast<const float4*>(anchors)[a];
    const float hw = __fmul_rn(box.z, 0.5f), hh = __fmul_rn(box.w, 0.5f);
    ax1 = __fsub_rn(box.x, hw);
    ay1 = __fsub_rn(box.y, hh);
    ax2 = __fadd_rn(box.x, hw);
    ay2 = __fadd_rn(box.y, hh);
    a_area = __fmul_rn(box.z, box.w);
  }

  float best = -1.0f;
  int best_g = 0;
  for (int j = 0; j < count; ++j) {
    const float iw =
        fmaxf(__fsub_rn(fminf(s_x2[j], ax2), fmaxf(s_x1[j], ax1)), 0.0f);
    const float ih =
        fmaxf(__fsub_rn(fminf(s_y2[j], ay2), fmaxf(s_y1[j], ay1)), 0.0f);
    const float inter = __fmul_rn(iw, ih);
    const float uni =
        fmaxf(__fsub_rn(__fadd_rn(s_area[j], a_area), inter), 1e-8f);
    float iou = fminf(fmaxf(__fdiv_rn(inter, uni), 0.0f), 1.0f);
    if (!live) iou = 0.0f;
    if (live && iou > best) {
      best = iou;
      best_g = s_idx[j];
    }
    if (__any_sync(kFull, iou > 0.0f)) {
      const unsigned bits = __float_as_uint(iou);
      const unsigned top = __reduce_max_sync(kFull, bits);
      const unsigned first = __reduce_min_sync(
          kFull, bits == top ? static_cast<unsigned>(a) : 0xffffffffu);
      if (wl == 0) {
        atomicMax(&s_key[j],
                  (static_cast<unsigned long long>(top) << 32) | ~first);
      }
    }
  }
  if (live) {
    const size_t out = static_cast<size_t>(image) * num_anchors + a;
    max_iou[out] = best;
    argmax_gt[out] = best_g;
  }

  __syncthreads();
  unsigned long long* image_keys = keys + static_cast<size_t>(image) * num_gt;
  for (int j = tid; j < count; j += kThreads) {
    if (s_key[j] != 0ull) atomicMax(&image_keys[s_idx[j]], s_key[j]);
  }
}

__global__ void decode_keys_kernel(const unsigned long long* __restrict__ keys,
                                   const uint8_t* __restrict__ gt_valid,
                                   int total, float* __restrict__ gt_best_iou,
                                   int* __restrict__ gt_best_anchor) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  if (gt_valid[i] == 0) {
    gt_best_iou[i] = -1.0f;
    gt_best_anchor[i] = 0;
    return;
  }
  const unsigned long long key = keys[i];
  if (key == 0ull) {  // IoU 0 with every anchor: first index of a zero row
    gt_best_iou[i] = 0.0f;
    gt_best_anchor[i] = 0;
    return;
  }
  gt_best_iou[i] = __uint_as_float(static_cast<unsigned>(key >> 32));
  gt_best_anchor[i] = static_cast<int>(~static_cast<unsigned>(key));
}

}  // namespace

extern "C" {

// Launches both kernels on `stream` (a cudaStream_t) and returns
// cudaGetLastError(), or the error of the set-up calls; the caller raises
// when it is not 0. `keys` is scratch of batch * num_gt 64-bit words that the
// caller has set to 0.
int match_lanes_launch(const float* anchors, const float* gt_boxes,
                       const uint8_t* gt_valid, int batch, int num_anchors,
                       int num_gt, float* max_iou, int* argmax_gt,
                       unsigned long long* keys, float* gt_best_iou,
                       int* gt_best_anchor, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = static_cast<size_t>(kBytesPerBox) * num_gt;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(match_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((num_anchors + kThreads - 1) / kThreads, batch);
  match_kernel<<<grid, kThreads, smem, s>>>(anchors, gt_boxes, gt_valid,
                                            num_anchors, num_gt, max_iou,
                                            argmax_gt, keys);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int total = batch * num_gt;
  decode_keys_kernel<<<(total + 255) / 256, 256, 0, s>>>(
      keys, gt_valid, total, gt_best_iou, gt_best_anchor);
  return static_cast<int>(cudaGetLastError());
}

const char* match_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
