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
// Two designs, both kernels of this file; the wrapper
// (ops/nms_kernel.py:nms_design) picks one from the mode and the shape.
//
// Bound on an H100 at the flagship shape (L = 640 lanes, k = 256, 100
// rounds): about 3.8 MB moved (1.1 us at 3.35 TB/s) and about 20 f32
// operations per candidate per round, 3.3e8 in all (4.9 us at 67 TFLOP/s).
// What limits either design is the chain of dependent rounds, so each
// makes a round as short as it can.
//
// nms_sweep_kernel: hard mode, k <= 1024, score_threshold >= -1e10. Greedy
// hard NMS visits its candidates in one fixed order (score descending,
// lower index first among equals), because a suppressed candidate sits at
// -1e10 and can never be picked again. So the next pick is the first
// candidate of that order still alive, and no round needs an arg-max. One
// warp owns a lane:
//   1. the k scores go to shared memory; one vote finds out whether they
//      are in that order already (the serving path hands in top-k's
//      output), else the candidates are ranked by counting, with float
//      compares so that -0.0 ties with 0.0;
//   2. the n candidates above the threshold, a prefix of the order, are
//      staged by rank as four corner planes and an area plane; thread t
//      owns ranks t, t + 32, ... (in registers up to 8 a thread) and keeps
//      one alive bit for each;
//   3. a round is one redux.sync (the lowest alive rank), a broadcast read
//      of the pick's box, and the IoU of the candidates of higher rank
//      against it. IoU is symmetric bit for bit (min, max, the product
//      and the sum of areas commute), so "the pick against the later ones"
//      decides as "the pick against all" does. Only "IoU > threshold" is
//      needed, and `over_threshold` answers that exactly as the IEEE
//      division would while dividing only within a hair of the threshold.
// No barrier, no float compare across threads. One warp a lane leaves a
// scheduler one or two warps, so what bounds a round is the length of its
// dependent chain: the slots are computed without a branch on the data, so
// that their arithmetic overlaps, and the rounds run in up to eight stages,
// each unrolled without the slots of 32 ranks that its picks have passed
// and without those that n leaves empty. A lane ends after max_det picks or
// with no bit alive.
//
// nms_lanes_kernel: the round kernel, for the soft modes (scores decay, so
// the order changes from round to round), k up to 8192, and hard mode with
// a threshold under -1e10 (there the plain version goes on picking
// suppressed candidates). One CTA per lane; the k candidates stay in
// shared memory as five planes (20 B a candidate); each thread owns the
// candidates j = tid, tid + blockDim, ... Each round:
//   1. every thread takes the first-index argmax of its own candidates;
//   2. a warp-shuffle argmax (ties to the lower index), then lane 0 of each
//      warp posts its pair to a double-buffered partials array;
//   3. one __syncthreads; every warp reduces the partials itself, so the
//      pick needs no second barrier to be broadcast;
//   4. if the pick is not above score_threshold the lane is frozen, which
//      ends the loop for the whole CTA (the pick is uniform);
//   5. each thread suppresses its own candidates against the pick.
//
// The ragged k edge is masked by the loops themselves, so inputs need no
// padding, and nothing is allocated here. Scores must not be NaN and boxes
// must be finite: outside that, neither design promises the plain
// version's answer.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr float kNegInf = -1e10f;  // the JAX package's _NEG_INF
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNoRank = 0xffffffffu;
constexpr int kSweepMaxCandidates = 1024;  // 32 alive bits a thread
constexpr int kSweepPlanes = 7;  // scores, order, four corners, area

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

// Whether the IEEE quotient inter / uni exceeds thr, for inter >= 0 and
// 1e-8 <= uni < 2^126: what `__fdiv_rn(inter, uni) > thr` says, mostly
// without the division. The fast quotient is within 2 ulp of the true one
// and rounding is monotone, so a fast quotient further than `margin` =
// 1e-5 |thr| + 1e-30 (dozens of ulp) from thr lies on the side of thr where
// the IEEE quotient lies. Nearer than that, or with a NaN (the margin of a
// lane with an area of 1e30 or more is NaN), the division itself decides.
__device__ __forceinline__ bool over_threshold(float inter, float uni,
                                               float thr, float margin) {
  float q = __fdividef(inter, uni);
  if (!(fabsf(__fsub_rn(q, thr)) >= margin)) q = __fdiv_rn(inter, uni);
  return q > thr;
}

// The lowest rank with its alive bit set, over the warp; kNoRank if none.
__device__ __forceinline__ unsigned lowest_alive(unsigned alive, int wl) {
  return __reduce_min_sync(
      kFull, alive != 0
                 ? static_cast<unsigned>(((__ffs(alive) - 1) << 5) + wl)
                 : kNoRank);
}

// What a thread holds of its lane: the planes by rank, its own candidates
// (ranks wl, wl + 32, ...) in registers where they fit, and their alive bits.
template <int CPT>
struct SweepThread {
  static constexpr bool kInRegs = CPT <= 8;  // else the planes are read
  const float *x1, *y1, *x2, *y2, *area;
  float rx1[CPT], ry1[CPT], rx2[CPT], ry2[CPT], rarea[CPT];
  unsigned alive;  // bit i: the candidate of rank 32 * i + wl can be picked
};

// The rounds of a lane whose n candidates lie in the first WIDTH slots of 32
// ranks; returns the number of picks. A pick never lies under an earlier
// one. So the rounds run in stages, each unrolled for itself: a stage holds
// the rounds whose pick lies in its kPer slots, and computes only the slots
// from its first on. Within a round no branch depends on the data, so that
// the slots' arithmetic overlaps: a bit set in `hit` for a dead rank, or for
// one at or past n (whose registers repeat rank 0), changes nothing.
template <int CPT, int WIDTH>
__device__ __forceinline__ int sweep_rounds(
    SweepThread<CPT>& t, const int* order, const float* sc, int wl,
    int max_det, float iou_thr, float margin, int* idx_row,
    float* score_row) {
  constexpr int kStages = WIDTH < 8 ? WIDTH : 8;
  constexpr int kPer = WIDTH / kStages;
  int picks = 0;
  unsigned pick = lowest_alive(t.alive, wl);
#pragma unroll
  for (int stage = 0; stage < kStages; ++stage) {
    while (picks < max_det && pick < 32u * kPer * (stage + 1)) {
      if (wl == 0) {
        const int j = order[pick];
        idx_row[picks] = j;
        score_row[picks] = sc[j];
      }
      ++picks;
      if (wl == static_cast<int>(pick & 31u)) t.alive &= ~(1u << (pick >> 5));
      const float bx1 = t.x1[pick], by1 = t.y1[pick], bx2 = t.x2[pick],
                  by2 = t.y2[pick], barea = t.area[pick];
      unsigned hit = 0;
#pragma unroll
      for (int i = stage * kPer; i < WIDTH; ++i) {
        const int r = 32 * i + wl;
        const float cx1 = t.kInRegs ? t.rx1[i] : t.x1[r];
        const float cy1 = t.kInRegs ? t.ry1[i] : t.y1[r];
        const float cx2 = t.kInRegs ? t.rx2[i] : t.x2[r];
        const float cy2 = t.kInRegs ? t.ry2[i] : t.y2[r];
        const float carea = t.kInRegs ? t.rarea[i] : t.area[r];
        const float iw =
            fmaxf(__fsub_rn(fminf(bx2, cx2), fmaxf(bx1, cx1)), 0.0f);
        const float ih =
            fmaxf(__fsub_rn(fminf(by2, cy2), fmaxf(by1, cy1)), 0.0f);
        const float inter = __fmul_rn(iw, ih);
        const float uni =
            fmaxf(__fsub_rn(__fadd_rn(barea, carea), inter), 1e-8f);
        if (over_threshold(inter, uni, iou_thr, margin)) hit |= 1u << i;
      }
      t.alive &= ~hit;
      pick = lowest_alive(t.alive, wl);
    }
  }
  return picks;
}

// CPT candidates a thread: ranks wl, wl + 32, ..., so a lane holds up to
// 32 * CPT. 32 / CPT lanes share a CTA, 28 KB of shared memory whatever CPT.
template <int CPT>
__global__ void __launch_bounds__(32 * (32 / CPT))
    nms_sweep_kernel(const float* __restrict__ boxes,
                     const float* __restrict__ scores, int lanes, int k,
                     int max_det, float iou_thr, float score_thr,
                     int* __restrict__ out_idx,
                     float* __restrict__ out_scores,
                     int* __restrict__ out_valid) {
  constexpr int kCap = 32 * CPT;
  extern __shared__ float planes[];

  const int warp = threadIdx.x >> 5;
  const int wl = threadIdx.x & 31;
  const int lane = blockIdx.x * (blockDim.x >> 5) + warp;
  if (lane >= lanes) return;  // a whole warp; no CTA barrier below

  float* sc = planes + static_cast<size_t>(warp) * kSweepPlanes * kCap;
  int* order = reinterpret_cast<int*>(sc + kCap);  // rank -> candidate
  float* x1 = sc + 2 * kCap;
  float* y1 = x1 + kCap;
  float* x2 = y1 + kCap;
  float* y2 = x2 + kCap;
  float* area = y2 + kCap;

  const float* ls = scores + static_cast<size_t>(lane) * k;
  for (int j = wl; j < k; j += 32) sc[j] = ls[j];
  __syncwarp();
  bool in_order = true;
  int above = 0;
  for (int j = wl; j < k; j += 32) {
    const float s = sc[j];
    if (j + 1 < k && !(s >= sc[j + 1])) in_order = false;
    above += s > score_thr ? 1 : 0;
  }
  in_order = __all_sync(kFull, in_order);
  const int n = __reduce_add_sync(kFull, above);

  if (in_order) {
    for (int r = wl; r < n; r += 32) order[r] = r;
  } else {
    // rank by counting: every score is read once for this thread's CPT
    float mine[CPT];
    int rank[CPT];
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      mine[i] = 32 * i + wl < k ? sc[32 * i + wl] : -INFINITY;
      rank[i] = 0;
    }
    for (int m = 0; m < k; ++m) {
      const float o = sc[m];
#pragma unroll
      for (int i = 0; i < CPT; ++i) {
        rank[i] += (o > mine[i] || (o == mine[i] && m < 32 * i + wl)) ? 1 : 0;
      }
    }
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      if (32 * i + wl < k && mine[i] > score_thr) order[rank[i]] = 32 * i + wl;
    }
  }
  __syncwarp();
  const float4* lb =
      reinterpret_cast<const float4*>(boxes) + static_cast<size_t>(lane) * k;
  bool tame = true;  // every area under 1e30, so every union under 2^126
  for (int r = wl; r < n; r += 32) {
    const float4 b = lb[order[r]];
    x1[r] = b.x;
    y1[r] = b.y;
    x2[r] = b.z;
    y2[r] = b.w;
    area[r] = box_area(b.x, b.y, b.z, b.w);
    tame = tame && area[r] < 1e30f;
  }
  tame = __all_sync(kFull, tame);
  __syncwarp();  // the vote orders no memory

  SweepThread<CPT> t;
  t.x1 = x1, t.y1 = y1, t.x2 = x2, t.y2 = y2, t.area = area;
  t.alive = 0;
#pragma unroll
  for (int i = 0; i < CPT; ++i) {
    const int r = 32 * i + wl;
    if (r < n) t.alive |= 1u << i;
    if (t.kInRegs) {
      const int rr = r < n ? r : 0;
      t.rx1[i] = x1[rr];
      t.ry1[i] = y1[rr];
      t.rx2[i] = x2[rr];
      t.ry2[i] = y2[rr];
      t.rarea[i] = area[rr];
    }
  }

  int* idx_row = out_idx + static_cast<size_t>(lane) * max_det;
  float* score_row = out_scores + static_cast<size_t>(lane) * max_det;
  const float margin =
      tame ? __fadd_rn(__fmul_rn(1e-5f, fabsf(iou_thr)), 1e-30f) : NAN;
  // the unrolled rounds as narrow as n allows: a trained model leaves few
  // candidates above the threshold
  const int slots = (n + 31) >> 5;
  int picks;
  if (8 * slots <= CPT) {
    picks = sweep_rounds<CPT, CPT / 8>(t, order, sc, wl, max_det, iou_thr,
                                       margin, idx_row, score_row);
  } else if (4 * slots <= CPT) {
    picks = sweep_rounds<CPT, CPT / 4>(t, order, sc, wl, max_det, iou_thr,
                                       margin, idx_row, score_row);
  } else if (2 * slots <= CPT) {
    picks = sweep_rounds<CPT, CPT / 2>(t, order, sc, wl, max_det, iou_thr,
                                       margin, idx_row, score_row);
  } else {
    picks = sweep_rounds<CPT, CPT>(t, order, sc, wl, max_det, iou_thr,
                                   margin, idx_row, score_row);
  }

  for (int r = picks + wl; r < max_det; r += 32) {
    idx_row[r] = 0;
    score_row[r] = -1.0f;
  }
  if (wl == 0) out_valid[lane] = picks;
}

template <int CPT>
cudaError_t launch_sweep(const float* boxes, const float* scores, int lanes,
                         int k, int max_det, float iou_thr, float score_thr,
                         int* out_idx, float* out_scores, int* out_valid,
                         cudaStream_t stream) {
  constexpr int kWarps = 32 / CPT;
  const size_t smem =
      static_cast<size_t>(kWarps) * kSweepPlanes * 32 * CPT * sizeof(float);
  nms_sweep_kernel<CPT><<<(lanes + kWarps - 1) / kWarps, 32 * kWarps, smem,
                          stream>>>(boxes, scores, lanes, k, max_det, iou_thr,
                                    score_thr, out_idx, out_scores,
                                    out_valid);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Each launches on `stream` (a cudaStream_t) and returns
// cudaGetLastError(), or the error of the set-up calls; the caller raises
// when it is not 0.
int nms_rounds_launch(const float* boxes, const float* scores, int lanes,
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

// `boxes` must be aligned to 16 bytes; k above 1024 is refused.
int nms_sweep_launch(const float* boxes, const float* scores, int lanes,
                     int k, int max_det, float iou_thr, float score_thr,
                     int* out_idx, float* out_scores, int* out_valid,
                     int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (k > kSweepMaxCandidates) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k <= 256) {
    err = launch_sweep<8>(boxes, scores, lanes, k, max_det, iou_thr,
                          score_thr, out_idx, out_scores, out_valid, s);
  } else if (k <= 512) {
    err = launch_sweep<16>(boxes, scores, lanes, k, max_det, iou_thr,
                           score_thr, out_idx, out_scores, out_valid, s);
  } else {
    err = launch_sweep<32>(boxes, scores, lanes, k, max_det, iou_thr,
                           score_thr, out_idx, out_scores, out_valid, s);
  }
  return static_cast<int>(err);
}

const char* nms_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
