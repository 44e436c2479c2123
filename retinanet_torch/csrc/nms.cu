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
// Three designs, all kernels of this file; the wrapper
// (ops/nms_kernel.py:nms_design) picks one from the mode and the shape.
//
// Bound on an H100 at the flagship shape (L = 640 lanes, k = 256, 100
// rounds): about 3.8 MB moved (1.1 us at 3.35 TB/s) and about 20 f32
// operations per candidate per round, 3.3e8 in all (4.9 us at 67 TFLOP/s).
// What limits every design is the chain of dependent rounds, so each
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
// nms_decay_kernel: the soft modes, k <= 1024, score_threshold >= 0. It
// replaces the soft branch of _nms_kernel (retinanet_tpu/ops/pallas/
// nms_kernel.py:74-80): each round picks the first-index arg-max, and every
// candidate's score takes scale = exp(-IoU^2 / (2 sigma)) (zero past the IoU
// threshold), or with sigma = 0 is kept only while IoU <= threshold. Every
// scale lies in [0, 1], so with a threshold >= 0 a score that is not above
// the threshold never rises above it again: it leaves the lane for good.
// Its bound at the flagship's soft shape (L = 640, k = 256, 100 rounds): the
// same 3.8 MB (1.1 us at 3.35 TB/s); per (alive candidate, round) the IoU,
// 20 f32 operations (at most 3.3e8, 4.9 us at 67 TFLOP/s); for each such
// pair whose boxes intersect, two IEEE divisions and an exp, three MUFU
// operations (rcp, rcp, ex2), at 16 a clock on each of 132 SMs at 1.98 GHz
// (4.18e12/s: at most 4.9e7, 11.8 us, if every pair intersected). What
// limits it is again the chain of up to 100 dependent rounds: a warp's
// arg-max, a broadcast, and a decay whose divisions and exp each take a few
// dozen cycles on one thread's path. One warp owns a lane and is a CTA
// (four lanes a CTA measured no faster), so nothing crosses a warp:
//   1. the candidates above the threshold are staged, in index order, at
//      positions 0 .. n-1 (a ballot and a popcount each 32), as four
//      corner planes, an area plane, the scores and their indices; thread t
//      owns positions t, t + 32, ..., their scores in registers (up to 32)
//      and, for k <= 256, their boxes too; a candidate that leaves has its
//      score set to +0.0;
//   2. alive scores are > 0, so their bits order as the floats do: a
//      thread's key is the bits of its largest score (the first position
//      among equals: strict >), `__reduce_max_sync` finds the best,
//      `__reduce_min_sync` the lowest position holding it, which is the
//      lowest index: the tie-break of torch.argmax and of the Pallas kernel;
//   3. the pick's box is one broadcast read; each thread takes the IoU
//      terms of its own positions. A pair with no intersection keeps its
//      score (its scale is exactly 1), and so does nothing of a candidate
//      gone; the other pairs, a few in ten on random boxes, go to a queue
//      in shared memory (a ballot a slot; a pair not queued is written to
//      the thread's spare slot, so that no store branches), and the warp
//      computes their scales 32 at a time, so that a round's divisions and
//      exps are one or two dependent chains and not one a slot (each
//      thread's own pairs in turn measured 1.5-2x slower). The scale is
//      the round kernel's arithmetic (`__fdiv_rn`, `expf`, `__fmul_rn`, no
//      contraction), so both designs give the same bits. With sigma = 0
//      only `over_threshold` is needed. The pick's score becomes +0.0.
// A lane ends after max_det picks or when no key is above 0. The slots are
// unrolled as few as n allows, as in the sweep (on an H100 with about
// five candidates a lane, 5.3 us at L = 640 against 7.2 with every slot;
// at par at full width). At k = 256 a round takes
// ~0.64 us with one lane: one warp's ~380 instructions, most of them the
// IoU terms and the queue's places of eight slots, at about one
// instruction in three cycles (tools/nms_experiments.py --soft, its cuts).
//
// nms_lanes_kernel: the round kernel, for k up to 8192, the soft modes with
// a negative threshold (a decayed negative score rises towards 0), and hard
// mode with a threshold under -1e10 (there the plain version goes on
// picking suppressed candidates). One CTA per lane; the k candidates stay
// in shared memory as five planes (20 B a candidate); each thread owns the
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
constexpr int kDecayMaxCandidates = 1024;  // 32 scores a thread

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

// What a warp holds of its lane in shared memory, by position (the
// candidates above the threshold in index order).
struct DecayLane {
  float* qi;  // the staged scores; then each round's queue: intersections,
              // then the scales computed from them
  float* qu;  // each round's queue: unions
  const int* order;  // position -> candidate
  const float *x1, *y1, *x2, *y2, *area;
};

// A lane's shared memory, for CPT candidates a thread.
template <int CPT>
struct DecayCta {
  // A queue holds up to 32 * CPT pairs and, past them, a slot for each
  // thread that a pair it does not queue is written to, so that no store
  // branches.
  static constexpr int kQueue = 32 * CPT + 32;
  // A lane's floats: the two queue planes (the first holds the staged
  // scores until the rounds start), then the indices, the four corners and
  // the area, by position.
  static constexpr int kLaneFloats = 2 * kQueue + 6 * 32 * CPT;
};

// The Gaussian scale of a pair: the round kernel's arithmetic, bit for bit.
__device__ __forceinline__ float gaussian_scale(float inter, float uni,
                                                float iou_thr,
                                                float two_sigma) {
  const float q = __fdiv_rn(inter, uni);  // the round kernel's IoU
  const float scale = expf(__fdiv_rn(-__fmul_rn(q, q), two_sigma));
  return q > iou_thr ? 0.0f : scale;
}

// A decayed score, or +0.0 once it is not above the threshold: gone for
// good.
__device__ __forceinline__ float still_above(float v, float score_thr) {
  return v > score_thr ? v : 0.0f;
}

// The rounds of a lane whose n candidates lie in the first WIDTH slots of 32
// positions; returns the number of picks. A slot of a position at or past n
// holds the score +0.0 and whatever its planes hold: a score of 0 stays 0.
template <int CPT, int WIDTH, bool GAUSSIAN>
__device__ __forceinline__ int decay_rounds(
    const DecayLane& l, int n, int wl, int max_det, float iou_thr,
    float score_thr, float two_sigma, float margin, int* idx_row,
    float* score_row) {
  constexpr bool in_regs = CPT <= 8;  // the boxes too, else read by position
  // without an intersection the IoU is 0 and the scale exactly 1, unless 0
  // is past the IoU threshold: then every pair needs its scale
  const float no_overlap = iou_thr >= 0.0f ? 0.0f : -1.0f;
  const unsigned below = (1u << wl) - 1u;
  const int spare = 32 * CPT + wl;  // this thread's slot past the queue
  float s[WIDTH], rx1[WIDTH], ry1[WIDTH], rx2[WIDTH], ry2[WIDTH],
      rarea[WIDTH];
#pragma unroll
  for (int i = 0; i < WIDTH; ++i) {
    const int p = 32 * i + wl;
    s[i] = p < n ? l.qi[p] : 0.0f;
    if (in_regs) {
      const int q = p < n ? p : 0;
      rx1[i] = l.x1[q];
      ry1[i] = l.y1[q];
      rx2[i] = l.x2[q];
      ry2[i] = l.y2[q];
      rarea[i] = l.area[q];
    }
  }
  int picks = 0;
  for (; picks < max_det; ++picks) {
    float best = 0.0f;
    int slot = 0;
#pragma unroll
    for (int i = 0; i < WIDTH; ++i) {
      if (s[i] > best) {  // strict: the lower position among equals
        best = s[i];
        slot = i;
      }
    }
    // alive scores are > 0, so their bits order as the floats do
    const unsigned key = __float_as_uint(best);
    const unsigned top = __reduce_max_sync(kFull, key);
    if (top == 0u) break;  // no candidate alive
    const unsigned pick = __reduce_min_sync(
        kFull, key == top ? static_cast<unsigned>((slot << 5) + wl) : kNoRank);
    if (wl == 0) {
      idx_row[picks] = l.order[pick];
      score_row[picks] = __uint_as_float(top);
    }
    const float bx1 = l.x1[pick], by1 = l.y1[pick], bx2 = l.x2[pick],
                by2 = l.y2[pick], barea = l.area[pick];
    __syncwarp();  // the last queue is read before this one is written
    unsigned need = 0;  // slots whose pair needs the divisions and the exp
    int queued = 0;
    int at[WIDTH];  // a slot's place in the queue
#pragma unroll
    for (int i = 0; i < WIDTH; ++i) {
      const int p = 32 * i + wl;
      const float cx1 = in_regs ? rx1[i] : l.x1[p];
      const float cy1 = in_regs ? ry1[i] : l.y1[p];
      const float cx2 = in_regs ? rx2[i] : l.x2[p];
      const float cy2 = in_regs ? ry2[i] : l.y2[p];
      const float carea = in_regs ? rarea[i] : l.area[p];
      const float iw =
          fmaxf(__fsub_rn(fminf(bx2, cx2), fmaxf(bx1, cx1)), 0.0f);
      const float ih =
          fmaxf(__fsub_rn(fminf(by2, cy2), fmaxf(by1, cy1)), 0.0f);
      const float inter = __fmul_rn(iw, ih);
      const float uni =
          fmaxf(__fsub_rn(__fadd_rn(barea, carea), inter), 1e-8f);
      if (p == static_cast<int>(pick)) s[i] = 0.0f;
      if (GAUSSIAN) {
        // queued, so that the warp shares out the divisions and exps
        const bool needed = s[i] > 0.0f && inter > no_overlap;
        const unsigned ballot = __ballot_sync(kFull, needed);
        at[i] = needed ? queued + __popc(ballot & below) : spare;
        l.qi[at[i]] = inter;
        l.qu[at[i]] = uni;
        queued += __popc(ballot);
        need |= needed ? 1u << i : 0u;
      } else if (over_threshold(inter, uni, iou_thr, margin)) {
        s[i] = 0.0f;
      }
    }
    if (GAUSSIAN && queued > 0) {
      __syncwarp();
      for (int q = wl; q < queued; q += 32) {
        l.qi[q] = gaussian_scale(l.qi[q], l.qu[q], iou_thr, two_sigma);
      }
      __syncwarp();
#pragma unroll
      for (int i = 0; i < WIDTH; ++i) {
        const float v = still_above(__fmul_rn(s[i], l.qi[at[i]]), score_thr);
        s[i] = need >> i & 1u ? v : s[i];
      }
    }
  }
  return picks;
}

template <int CPT, bool GAUSSIAN>
__device__ __forceinline__ int decay_lane(const DecayLane& l, int n, int wl,
                                          int max_det, float iou_thr,
                                          float score_thr, float two_sigma,
                                          float margin, int* idx_row,
                                          float* score_row) {
  // the unrolled slots as few as n allows: a trained model's scores leave
  // few candidates above the threshold
  const int width = (n + 31) / 32;
  if (8 * width <= CPT) {
    return decay_rounds<CPT, CPT / 8, GAUSSIAN>(l, n, wl, max_det, iou_thr,
                                                score_thr, two_sigma, margin,
                                                idx_row, score_row);
  }
  if (4 * width <= CPT) {
    return decay_rounds<CPT, CPT / 4, GAUSSIAN>(l, n, wl, max_det, iou_thr,
                                                score_thr, two_sigma, margin,
                                                idx_row, score_row);
  }
  if (2 * width <= CPT) {
    return decay_rounds<CPT, CPT / 2, GAUSSIAN>(l, n, wl, max_det, iou_thr,
                                                score_thr, two_sigma, margin,
                                                idx_row, score_row);
  }
  return decay_rounds<CPT, CPT, GAUSSIAN>(l, n, wl, max_det, iou_thr,
                                          score_thr, two_sigma, margin,
                                          idx_row, score_row);
}

// CPT candidates a thread, so a lane holds up to 32 * CPT. A CTA is one
// warp and one lane.
template <int CPT>
__global__ void __launch_bounds__(32)
    nms_decay_kernel(const float* __restrict__ boxes,
                     const float* __restrict__ scores, int k,
                     int max_det, float iou_thr, float score_thr,
                     float two_sigma, int mode, int* __restrict__ out_idx,
                     float* __restrict__ out_scores,
                     int* __restrict__ out_valid) {
  constexpr int kCap = 32 * CPT;
  constexpr int kChunk = 8;  // slots whose loads are in flight together
  extern __shared__ float sc[];

  const int wl = threadIdx.x;
  const int lane = blockIdx.x;

  float* qu = sc + DecayCta<CPT>::kQueue;
  int* order = reinterpret_cast<int*>(qu + DecayCta<CPT>::kQueue);
  float* x1 = reinterpret_cast<float*>(order + kCap);
  float* y1 = x1 + kCap;
  float* x2 = y1 + kCap;
  float* y2 = x2 + kCap;
  float* area = y2 + kCap;
  const DecayLane l{sc, qu, order, x1, y1, x2, y2, area};

  // every score and box read once; those above the threshold staged in
  // index order
  const float* ls = scores + static_cast<size_t>(lane) * k;
  const float4* lb =
      reinterpret_cast<const float4*>(boxes) + static_cast<size_t>(lane) * k;
  const unsigned below = (1u << wl) - 1u;
  int n = 0;
  bool tame = true;  // every area under 1e30, so every union under 2^126
#pragma unroll
  for (int c = 0; c < CPT; c += kChunk) {
    float cs[kChunk];
    float4 cb[kChunk];
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const int j = 32 * (c + u) + wl;
      cs[u] = j < k ? ls[j] : 0.0f;
      cb[u] = j < k ? lb[j] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const int j = 32 * (c + u) + wl;
      const bool above = j < k && cs[u] > score_thr;
      const unsigned ballot = __ballot_sync(kFull, above);
      if (above) {
        const int p = n + __popc(ballot & below);
        sc[p] = cs[u];
        order[p] = j;
        x1[p] = cb[u].x;
        y1[p] = cb[u].y;
        x2[p] = cb[u].z;
        y2[p] = cb[u].w;
        area[p] = box_area(cb[u].x, cb[u].y, cb[u].z, cb[u].w);
        tame = tame && area[p] < 1e30f;
      }
      n += __popc(ballot);
    }
  }
  tame = __all_sync(kFull, tame);
  __syncwarp();  // the vote orders no memory

  int* idx_row = out_idx + static_cast<size_t>(lane) * max_det;
  float* score_row = out_scores + static_cast<size_t>(lane) * max_det;
  const float margin =
      tame ? __fadd_rn(__fmul_rn(1e-5f, fabsf(iou_thr)), 1e-30f) : NAN;
  const int picks =
      mode == kSoftGaussian
          ? decay_lane<CPT, true>(l, n, wl, max_det, iou_thr, score_thr,
                                  two_sigma, margin, idx_row, score_row)
          : decay_lane<CPT, false>(l, n, wl, max_det, iou_thr, score_thr,
                                   two_sigma, margin, idx_row, score_row);

  for (int r = picks + wl; r < max_det; r += 32) {
    idx_row[r] = 0;
    score_row[r] = -1.0f;
  }
  if (wl == 0) out_valid[lane] = picks;
}

template <int CPT>
cudaError_t launch_decay(const float* boxes, const float* scores, int lanes,
                         int k, int max_det, float iou_thr, float score_thr,
                         float two_sigma, int mode, int* out_idx,
                         float* out_scores, int* out_valid,
                         cudaStream_t stream) {
  const size_t smem = DecayCta<CPT>::kLaneFloats * sizeof(float);
  nms_decay_kernel<CPT><<<lanes, 32, smem, stream>>>(
      boxes, scores, k, max_det, iou_thr, score_thr, two_sigma, mode, out_idx,
      out_scores, out_valid);
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

// `boxes` must be aligned to 16 bytes; k above 1024, a threshold under 0
// (or NaN) and hard mode are refused.
int nms_decay_launch(const float* boxes, const float* scores, int lanes,
                     int k, int max_det, float iou_thr, float score_thr,
                     float two_sigma, int mode, int* out_idx,
                     float* out_scores, int* out_valid, int device,
                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (k > kDecayMaxCandidates || !(score_thr >= 0.0f) ||
      (mode != kSoftGaussian && mode != kSoftHard)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k <= 256) {
    err = launch_decay<8>(boxes, scores, lanes, k, max_det, iou_thr,
                          score_thr, two_sigma, mode, out_idx, out_scores,
                          out_valid, s);
  } else if (k <= 512) {
    err = launch_decay<16>(boxes, scores, lanes, k, max_det, iou_thr,
                           score_thr, two_sigma, mode, out_idx, out_scores,
                           out_valid, s);
  } else {
    err = launch_decay<32>(boxes, scores, lanes, k, max_det, iou_thr,
                           score_thr, two_sigma, mode, out_idx, out_scores,
                           out_valid, s);
  }
  return static_cast<int>(err);
}

const char* nms_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
