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
// parallel, and the whole function is one launch. One CTA of 128 threads
// per (image, tile of 384 consecutive anchors), each thread owning three
// anchors 128 apart. At the flagship shape that is 1,600 CTAs, all resident
// at once: with one anchor a thread it was 2.3 waves of CTAs that mostly
// wait (two global loads, three barriers, a fence and a ticket each).
//   1. the CTA reduces its anchors' corners to the tile's bounding box
//      (shuffles, then one barrier); the anchors need be in no order;
//   2. all threads read the image's boxes, 128 at a time, and keep a box
//      only if it is valid and may touch the tile: it is dropped iff
//      bx2 <= tx1 || bx1 >= tx2 || by2 <= ty1 || by1 >= ty2. For such a box
//      the intersection's width or height is exactly 0 with every anchor of
//      the tile, so its IoU is exactly 0: it can neither raise an anchor's
//      best nor post a key. A NaN corner makes every comparison false and
//      keeps the box. The kept boxes are compacted into shared memory in
//      index order (ballot + popcount per warp, the warps' counts summed
//      after one barrier), so that the lowest box index still wins a tie.
//      A tile is a strip of one pyramid level, so most boxes are dropped;
//   3. each thread loops over the kept boxes, one read of a box serving its
//      three anchors: a strict > keeps the lowest box index, and the
//      per-anchor result needs no reduction. It starts at (0, lowest valid
//      index of the image), which is what the first valid box gives an
//      anchor that no kept box touches, and at (-1, 0) in an image with no
//      valid box;
//   4. per box the warp votes on intersection > 0 before anything else: a
//      warp whose pairs all miss skips the division, the clamp and the
//      reduction. The others reduce (IoU bits, lowest anchor index) with
//      two redux.sync instructions, and lane 0 posts the pair as one 64-bit
//      key (IoU bits high: monotone as unsigned for IoU in [0, 1]; ~anchor
//      index low, so the lowest index wins a tie) with atomicMax to the
//      CTA's key in shared memory;
//   5. the CTA posts each nonzero key with one atomicMax to global memory;
//      after a barrier thread 0 fences and takes a ticket of its image, and
//      the per-anchor results are stored meanwhile. The CTA that draws the
//      last ticket decodes the image's keys into the
//      per-box outputs and leaves keys and ticket at 0 again, so the
//      scratch needs no memset between calls. A key still 0 is a valid box
//      whose IoU is 0 with every anchor (one dropped by every tile, say):
//      the answer is (0, anchor 0), the first-index argmax of a row of
//      zeros. atomicMax commutes, so the result does not depend on the
//      order in which the CTAs run.
//
// Bound on an H100 at the flagship shape (A = 76,725 anchors, B = 8 images,
// G = 100 boxes, about 7 valid): A*16 + B*G*17 bytes in, B*A*8 + B*G*8 out,
// 6.2 MB, 1.8 us at 3.35 TB/s; about 25 f32 operations per (anchor, valid
// box) pair, 0.1 to 1.5 G operations, 1.6 to 23 us at 67 TFLOP/s. Bytes bound
// it for the usual dozen boxes an image, operations when all 100 are valid.
// The bound counts every pair; the tile test is how the kernel gets under
// the operations it would otherwise spend. Anchors and boxes must be finite
// for the plain version's answer.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 3;                   // anchors of a thread
constexpr int kTile = kPerThread * kThreads;    // anchors of a CTA
constexpr unsigned kFull = 0xffffffffu;

// Shared memory for G boxes: the 64-bit key, four corners, the area and the
// box index (4 B each).
constexpr int kBytesPerBox = 8 + 6 * 4;

struct Corners {
  float x1, y1, x2, y2, area;
};

// A centre-format box in the arithmetic of data/box_utils.compute_iou.
__device__ __forceinline__ Corners corners_of(float4 box) {
  const float hw = __fmul_rn(box.z, 0.5f), hh = __fmul_rn(box.w, 0.5f);
  return {__fsub_rn(box.x, hw), __fsub_rn(box.y, hh), __fadd_rn(box.x, hw),
          __fadd_rn(box.y, hh), __fmul_rn(box.z, box.w)};
}

__global__ void __launch_bounds__(kThreads)
    match_kernel(const float4* __restrict__ anchors,
                 const float4* __restrict__ gt_boxes,
                 const uint8_t* __restrict__ gt_valid, int num_anchors,
                 int num_gt, float* __restrict__ max_iou,
                 int* __restrict__ argmax_gt, float* __restrict__ gt_best_iou,
                 int* __restrict__ gt_best_anchor,
                 unsigned long long* __restrict__ keys,
                 unsigned long long* __restrict__ tickets) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* s_key = smem;                        // [num_gt]
  float* s_x1 = reinterpret_cast<float*>(s_key + num_gt);  // [num_gt] each
  float* s_y1 = s_x1 + num_gt;
  float* s_x2 = s_y1 + num_gt;
  float* s_y2 = s_x2 + num_gt;
  float* s_area = s_y2 + num_gt;
  int* s_idx = reinterpret_cast<int*>(s_area + num_gt);
  __shared__ float4 s_tile[kWarps];
  __shared__ int s_kept[2][kWarps];
  __shared__ int s_first_valid;
  __shared__ bool s_last;

  const int image = blockIdx.y;
  const int tid = threadIdx.x;
  const int wl = tid & 31;
  const int warp = tid >> 5;
  const float4* boxes = gt_boxes + static_cast<size_t>(image) * num_gt;
  const uint8_t* valid = gt_valid + static_cast<size_t>(image) * num_gt;

  // 1. this thread's anchors, and the tile's bounding box
  const int a0 = blockIdx.x * kTile + tid;  // then a0 + kThreads, ...
  Corners an[kPerThread];
  float tx1 = INFINITY, ty1 = INFINITY, tx2 = -INFINITY, ty2 = -INFINITY;
#pragma unroll
  for (int t = 0; t < kPerThread; ++t) {
    const int a = a0 + t * kThreads;
    an[t] = corners_of(a < num_anchors ? anchors[a]
                                       : make_float4(0.f, 0.f, 0.f, 0.f));
    if (a < num_anchors) {
      tx1 = fminf(tx1, an[t].x1);
      ty1 = fminf(ty1, an[t].y1);
      tx2 = fmaxf(tx2, an[t].x2);
      ty2 = fmaxf(ty2, an[t].y2);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    tx1 = fminf(tx1, __shfl_xor_sync(kFull, tx1, off));
    ty1 = fminf(ty1, __shfl_xor_sync(kFull, ty1, off));
    tx2 = fmaxf(tx2, __shfl_xor_sync(kFull, tx2, off));
    ty2 = fmaxf(ty2, __shfl_xor_sync(kFull, ty2, off));
  }
  if (wl == 0) s_tile[warp] = make_float4(tx1, ty1, tx2, ty2);
  if (tid == 0) s_first_valid = INT_MAX;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const float4 part = s_tile[w];
    tx1 = fminf(tx1, part.x);
    ty1 = fminf(ty1, part.y);
    tx2 = fmaxf(tx2, part.z);
    ty2 = fmaxf(ty2, part.w);
  }

  // 2. the valid boxes that may touch the tile, compacted in index order
  int kept = 0;
  for (int base = 0, chunk = 0; base < num_gt; base += kThreads, ++chunk) {
    const int g = base + tid;
    const bool v = g < num_gt && valid[g] != 0;
    Corners bx = {0.f, 0.f, 0.f, 0.f, 0.f};
    bool keep = false;
    if (v) {
      bx = corners_of(boxes[g]);
      keep = !(bx.x2 <= tx1 || bx.x1 >= tx2 || bx.y2 <= ty1 || bx.y1 >= ty2);
    }
    const unsigned valid_mask = __ballot_sync(kFull, v);
    const unsigned keep_mask = __ballot_sync(kFull, keep);
    if (wl == 0) {
      s_kept[chunk & 1][warp] = __popc(keep_mask);
      if (valid_mask != 0) {
        atomicMin(&s_first_valid, base + 32 * warp + __ffs(valid_mask) - 1);
      }
    }
    __syncthreads();
    int pos = kept;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = s_kept[chunk & 1][w];
      if (w < warp) pos += c;
      kept += c;
    }
    if (keep) {
      pos += __popc(keep_mask & ((1u << wl) - 1u));
      s_x1[pos] = bx.x1;
      s_y1[pos] = bx.y1;
      s_x2[pos] = bx.x2;
      s_y2[pos] = bx.y2;
      s_area[pos] = bx.area;
      s_idx[pos] = g;
      s_key[pos] = 0ull;
    }
  }
  __syncthreads();
  const int first_valid = s_first_valid;

  // 3. and 4. the anchors against the kept boxes
  float best[kPerThread];
  int best_g[kPerThread];
#pragma unroll
  for (int t = 0; t < kPerThread; ++t) {
    best[t] = first_valid == INT_MAX ? -1.0f : 0.0f;
    best_g[t] = first_valid == INT_MAX ? 0 : first_valid;
  }
  for (int j = 0; j < kept; ++j) {
    const float bx1 = s_x1[j], by1 = s_y1[j], bx2 = s_x2[j], by2 = s_y2[j];
    float inter[kPerThread];
    bool hit = false;
#pragma unroll
    for (int t = 0; t < kPerThread; ++t) {
      const float iw =
          fmaxf(__fsub_rn(fminf(bx2, an[t].x2), fmaxf(bx1, an[t].x1)), 0.0f);
      const float ih =
          fmaxf(__fsub_rn(fminf(by2, an[t].y2), fmaxf(by1, an[t].y1)), 0.0f);
      // an anchor past the end has corners 0: it meets a box that covers
      // the origin, and is masked here
      inter[t] = a0 + t * kThreads < num_anchors ? __fmul_rn(iw, ih) : 0.0f;
      hit = hit || inter[t] > 0.0f;
    }
    if (!__any_sync(kFull, hit)) continue;
    const float barea = s_area[j];
    const int g = s_idx[j];
    unsigned bits = 0;   // this thread's best IoU with the box, as bits
    unsigned mine = 0xffffffffu;  // and its lowest anchor attaining it
#pragma unroll
    for (int t = 0; t < kPerThread; ++t) {
      // without an intersection the quotient is 0 / max(u, 1e-8), exactly 0
      float iou = 0.0f;
      if (inter[t] > 0.0f) {
        const float uni = fmaxf(
            __fsub_rn(__fadd_rn(barea, an[t].area), inter[t]), 1e-8f);
        iou = fminf(fmaxf(__fdiv_rn(inter[t], uni), 0.0f), 1.0f);
      }
      if (iou > best[t]) {
        best[t] = iou;
        best_g[t] = g;
      }
      if (__float_as_uint(iou) > bits) {
        bits = __float_as_uint(iou);
        mine = static_cast<unsigned>(a0 + t * kThreads);
      }
    }
    const unsigned top = __reduce_max_sync(kFull, bits);
    if (top == 0u) continue;  // every quotient underflowed to 0
    const unsigned first =
        __reduce_min_sync(kFull, bits == top ? mine : 0xffffffffu);
    if (wl == 0) {
      atomicMax(&s_key[j],
                (static_cast<unsigned long long>(top) << 32) | ~first);
    }
  }
  // 5. the CTA's keys to the image's, then the last CTA of the image decodes
  __syncthreads();
  unsigned long long* image_keys = keys + static_cast<size_t>(image) * num_gt;
  for (int j = tid; j < kept; j += kThreads) {
    if (s_key[j] != 0ull) atomicMax(&image_keys[s_idx[j]], s_key[j]);
  }
  __syncthreads();
  if (tid == 0) {
    __threadfence();  // the CTA's keys before its ticket
    s_last = atomicAdd(&tickets[image], 1ull) == gridDim.x - 1;
    __threadfence();  // the ticket before the reads of the other CTAs' keys
  }
  // the per-anchor results go out while the ticket is on its way, and after
  // the fence, which would else wait for these stores too
#pragma unroll
  for (int t = 0; t < kPerThread; ++t) {
    const int a = a0 + t * kThreads;
    if (a < num_anchors) {
      const size_t out = static_cast<size_t>(image) * num_anchors + a;
      max_iou[out] = best[t];
      argmax_gt[out] = best_g[t];
    }
  }
  __syncthreads();
  if (!s_last) return;
  for (int g = tid; g < num_gt; g += kThreads) {
    const size_t out = static_cast<size_t>(image) * num_gt + g;
    if (valid[g] == 0) {
      gt_best_iou[out] = -1.0f;
      gt_best_anchor[out] = 0;
      continue;
    }
    const unsigned long long key = atomicExch(&image_keys[g], 0ull);
    if (key == 0ull) {  // IoU 0 with every anchor: first index of a zero row
      gt_best_iou[out] = 0.0f;
      gt_best_anchor[out] = 0;
      continue;
    }
    gt_best_iou[out] = __uint_as_float(static_cast<unsigned>(key >> 32));
    gt_best_anchor[out] = static_cast<int>(~static_cast<unsigned>(key));
  }
  if (tid == 0) tickets[image] = 0ull;
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` (a cudaStream_t) and returns
// cudaGetLastError(), or the error of the set-up calls; the caller raises
// when it is not 0. `scratch` holds batch * num_gt + batch 64-bit words (the
// keys, then a ticket per image) that are 0 before the launch; the kernel
// leaves them 0. `anchors` and `gt_boxes` must be aligned to 16 bytes.
int match_lanes_launch(const float* anchors, const float* gt_boxes,
                       const uint8_t* gt_valid, int batch, int num_anchors,
                       int num_gt, float* max_iou, int* argmax_gt,
                       float* gt_best_iou, int* gt_best_anchor,
                       unsigned long long* scratch, int device,
                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = static_cast<size_t>(kBytesPerBox) * num_gt;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(match_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((num_anchors + kTile - 1) / kTile, batch);
  match_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(anchors),
      reinterpret_cast<const float4*>(gt_boxes), gt_valid, num_anchors,
      num_gt, max_iou, argmax_gt, gt_best_iou, gt_best_anchor, scratch,
      scratch + static_cast<size_t>(batch) * num_gt);
  return static_cast<int>(cudaGetLastError());
}

const char* match_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
