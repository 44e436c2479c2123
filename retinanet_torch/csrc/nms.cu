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
// Five designs, all kernels of this file; the wrapper
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
// nms_scan_kernel: hard mode, k > 1024 (the exact-parity lane, nms_top_k
// up to every config's pre_nms_top_k of 5000, and any k past it),
// score_threshold >= -1e10. It takes the round kernel's hard lanes past
// 1,024 candidates, and through it that part of _nms_kernel. As in the
// sweep, a candidate is kept iff no pick before it in the fixed order has
// IoU > threshold, so a lane needs only the IoUs of the candidates it
// visits against its picks, and stops after max_det picks: at k = 5000 a
// zero-bias request's lane decides ~130 candidates, not 100 rounds of
// 5000. What bounds it is then the scores' one read (the order needs every
// one: 12.8 MB at L = 640, 3.8 us) and a chain of picks. A CTA of kScanWarps
// warps a lane, nothing staged but the picks:
//   1. one vote over the scores: in (score desc, index asc) order already
//      (top-k's output: every PerClassHardNMS lane), and n, the candidates
//      above the threshold (in order, the first n);
//   2. a lane not in order (a global lane, whose score is the best of its
//      classes) sorts its n candidates' 64-bit keys (score desc, -0.0 as
//      0.0, then index) by a bitonic network over the CTA, in a scratch of
//      the wrapper's; the passes of stride under kSortBlock run in shared
//      memory, a block of keys at a time;
//   3. chunks of 32 * kScanWarps ranks: each thread tests its candidate,
//      read from device memory, against the picks made before the chunk
//      (in shared memory; the warp stops once every candidate of it is
//      suppressed), then warp 0 resolves the chunk in order: each warp's
//      survivors against the chunk's earlier picks, then leader by leader
//      (the lowest survivor by a ballot is the next pick and suppresses
//      the later ones). `over_threshold` decides every pair exactly, its
//      margin dropped for a pair with an area of 1e30 or more.
// Two barriers a chunk; a lane ends after max_det picks or its n ranks.
//
// nms_compact_kernel: the soft modes, 1024 < k <= 8192, score_threshold >=
// 0. It takes the round kernel's soft lanes past 1,024 candidates (the
// exact-parity lane in PerClassSoftNMS and GlobalSoftNMS), and through it
// that part of _nms_kernel's soft branch. The decay design's reasoning
// with the candidates past a warp's registers: its bound is the same count
// (20 f32 operations an alive pair, 3 MUFU operations an intersecting one;
// at L = 640, k = 5000 ~3.2e8 alive pairs, 96 us), and what limits it is
// the chain of up to 100 rounds over ~5,000 candidates each. A CTA of
// kCompactWarps warps a lane, one barrier a round:
//   1. the candidates above the threshold are staged in index order in
//      shared memory, position p in slot p / T of thread p % T (T the
//      CTA's threads): a box, an area, a score, a 16-bit index (26 B a
//      candidate, 130 KB at k = 5000);
//   2. a round's pick: each thread's best slot (the first among equal
//      scores), each warp's (largest score bits, lowest index) by two
//      `redux` to double-buffered partials with its box, one barrier, and
//      every warp reduces the partials itself;
//   3. each thread takes the IoU terms of its own slots against the pick's
//      box; each warp queues its intersecting pairs and computes their
//      scales 32 at a time (the round kernel's arithmetic, so the two
//      designs give the same bits), flushing the queue before it could
//      overflow; with sigma = 0 only `over_threshold`;
//   4. a candidate at or under the threshold is +0.0; the thread finds
//      its next best in a pass without stores, and once a quarter of its
//      slots are gone they leave (the others keep their order), so a round
//      touches the candidates still alive and at most a third as many
//      gone. (Compacting after every death cost ~1 us a round: the pick's
//      thread shifted its later slots each round.)
// A lane ends after max_det picks or when no score is above 0.
//
// nms_lanes_kernel: the round kernel, for k up to 8192: the soft modes with
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
constexpr int kScanWarps = 4;      // a scan lane's CTA: 128 threads
constexpr int kSortBlock = 2048;   // keys a scan lane sorts on chip at once
constexpr int kCompactWarps = 16;  // a compact lane's CTA: 512 threads
constexpr int kCompactMaxCandidates = 8192;  // 26 B a candidate on chip

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

// IoU(p, c) > thr for a pick p and a candidate c, with their areas: the
// round kernel's terms (IoU is symmetric bit for bit) and the sweep's exact
// test.
__device__ __forceinline__ bool suppresses(float4 p, float pa, float4 c,
                                           float ca, float iou_thr,
                                           float margin) {
  const float iw = fmaxf(__fsub_rn(fminf(p.z, c.z), fmaxf(p.x, c.x)), 0.0f);
  const float ih = fmaxf(__fsub_rn(fminf(p.w, c.w), fmaxf(p.y, c.y)), 0.0f);
  const float inter = __fmul_rn(iw, ih);
  const float uni = fmaxf(__fsub_rn(__fadd_rn(pa, ca), inter), 1e-8f);
  return over_threshold(inter, uni, iou_thr, margin);
}

// A candidate's sort key in the scan: ascending keys are scores descending
// (-0.0 as 0.0, which the arg-max ties with it), then lower index first.
__device__ __forceinline__ unsigned long long scan_key(float s, int j) {
  unsigned u = __float_as_uint(__fadd_rn(s, 0.0f));
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);  // ascends with the float
  return static_cast<unsigned long long>(~u) << 32 | static_cast<unsigned>(j);
}

// One CTA of WARPS warps a lane; a block of kSortBlock sort keys in shared
// memory, then `cap` = min(max_det, k) picks, then a chunk of 32 * WARPS
// candidates: boxes, areas, scores and indices.
template <int WARPS>
struct ScanCta {
  static constexpr int kThreads = 32 * WARPS;
  static size_t bytes(int cap) {
    return static_cast<size_t>(kSortBlock) * 8 +
           static_cast<size_t>(cap) * 20 + static_cast<size_t>(kThreads) * 28;
  }
};

// Bitonic compare-exchanges of the keys `k` (an ascending sort overall) at
// one stride, for the sequence's size `size`; `base` is k[0]'s place in the
// lane.
template <int THREADS>
__device__ __forceinline__ void bitonic_pass(unsigned long long* k, int n,
                                             int base, int size, int stride) {
  for (int i = threadIdx.x; i < n / 2; i += THREADS) {
    const int lo = 2 * i - (i & (stride - 1));
    const unsigned long long a = k[lo], b = k[lo + stride];
    if ((a > b) == (((base + lo) & size) == 0)) {
      k[lo] = b;
      k[lo + stride] = a;
    }
  }
  __syncthreads();
}

// The same pass over a whole block of kSortBlock keys in shared memory:
// every key a thread exchanges is read before any is written (a pass
// touches each key once), so the loads of its exchanges overlap.
template <int THREADS>
__device__ __forceinline__ void bitonic_block_pass(unsigned long long* k,
                                                   int base, int size,
                                                   int stride) {
  constexpr int kPer = kSortBlock / 2 / THREADS;
  unsigned long long a[kPer], b[kPer];
  int lo[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int i = threadIdx.x + u * THREADS;
    lo[u] = 2 * i - (i & (stride - 1));
    a[u] = k[lo[u]];
    b[u] = k[lo[u] + stride];
  }
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    if ((a[u] > b[u]) == (((base + lo[u]) & size) == 0)) {
      k[lo[u]] = b[u];
      k[lo[u] + stride] = a[u];
    }
  }
  __syncthreads();
}

// The passes of the sizes `first` .. `last` whose strides are under
// `block`, done block by block in shared memory (`sk`).
template <int THREADS>
__device__ void bitonic_blocks(unsigned long long* lk, unsigned long long* sk,
                               int width, int block, int first, int last) {
  for (int base = 0; base < width; base += block) {
    for (int p = threadIdx.x; p < block; p += THREADS) sk[p] = lk[base + p];
    __syncthreads();
    for (int size = first; size <= last; size <<= 1) {
      for (int stride = (size < block ? size : block) >> 1; stride > 0;
           stride >>= 1) {
        if (block == kSortBlock) {
          bitonic_block_pass<THREADS>(sk, base, size, stride);
        } else {
          bitonic_pass<THREADS>(sk, block, base, size, stride);
        }
      }
    }
    for (int p = threadIdx.x; p < block; p += THREADS) lk[base + p] = sk[p];
    __syncthreads();
  }
}

template <int WARPS>
__global__ void __launch_bounds__(32 * WARPS)
    nms_scan_kernel(const float* __restrict__ boxes,
                    const float* __restrict__ scores, int k, int max_det,
                    int cap, float iou_thr, float score_thr, int sort_cap,
                    unsigned long long* __restrict__ keys,
                    int* __restrict__ out_idx,
                    float* __restrict__ out_scores,
                    int* __restrict__ out_valid) {
  constexpr int kThreads = 32 * WARPS;
  extern __shared__ float4 scan_smem[];
  unsigned long long* sk = reinterpret_cast<unsigned long long*>(scan_smem);
  float4* pbox = scan_smem + kSortBlock / 2;  // the picks, in the order made
  float4* cbox = pbox + cap;          // this chunk's candidates, by rank
  float* parea = reinterpret_cast<float*>(cbox + kThreads);
  float* carea = parea + cap;
  float* cscore = carea + kThreads;
  int* cidx = reinterpret_cast<int*>(cscore + kThreads);
  __shared__ unsigned survivors[WARPS];
  __shared__ int warp_above[WARPS];
  __shared__ int staged, shared_picks, shared_tame;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wl = tid & 31;
  const int lane = blockIdx.x;
  const float* ls = scores + static_cast<size_t>(lane) * k;
  const float4* lb =
      reinterpret_cast<const float4*>(boxes) + static_cast<size_t>(lane) * k;

  // 1. one vote: in (score desc, index asc) order already? And n, the
  //    candidates above the threshold (in order: the first n)
  bool in_order = true;
  int above = 0;
  for (int j = tid; j < k; j += kThreads) {
    const float s = ls[j];
    if (j + 1 < k && !(s >= ls[j + 1])) in_order = false;
    above += s > score_thr ? 1 : 0;
  }
  above = __reduce_add_sync(kFull, above);
  if (wl == 0) warp_above[warp] = above;
  in_order = __syncthreads_and(in_order);
  int n = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) n += warp_above[w];

  // 2. else the n candidates' keys into this lane's scratch, and a bitonic
  //    sort of them over the CTA: the passes whose stride is under
  //    kSortBlock in shared memory, a block of keys at a time, the others
  //    through the scratch
  unsigned long long* lk = keys + static_cast<size_t>(lane) * sort_cap;
  if (!in_order) {
    if (tid == 0) staged = 0;
    __syncthreads();
    const unsigned below = (1u << wl) - 1u;
    for (int j0 = 32 * warp; j0 < k; j0 += kThreads) {
      const int j = j0 + wl;
      const float s = j < k ? ls[j] : 0.0f;
      const bool take = j < k && s > score_thr;
      const unsigned ballot = __ballot_sync(kFull, take);
      int at = 0;
      if (wl == 0 && ballot != 0u) at = atomicAdd(&staged, __popc(ballot));
      at = __shfl_sync(kFull, at, 0);
      if (take) lk[at + __popc(ballot & below)] = scan_key(s, j);
    }
    int width = 1;
    while (width < n) width <<= 1;
    for (int p = n + tid; p < width; p += kThreads) lk[p] = ~0ull;
    __syncthreads();
    const int block = width < kSortBlock ? width : kSortBlock;
    bitonic_blocks<kThreads>(lk, sk, width, block, 2, block);
    for (int size = 2 * block; size <= width; size <<= 1) {
      for (int stride = size >> 1; stride >= block; stride >>= 1) {
        bitonic_pass<kThreads>(lk, width, 0, size, stride);
      }
      bitonic_blocks<kThreads>(lk, sk, width, block, size, size);
    }
  }

  // 3. the scan: chunk after chunk of ranks, each candidate tested against
  //    the picks made before its chunk by its own thread, then the chunk's
  //    survivors resolved in order by warp 0
  int* idx_row = out_idx + static_cast<size_t>(lane) * max_det;
  float* score_row = out_scores + static_cast<size_t>(lane) * max_det;
  const float margin = __fadd_rn(__fmul_rn(1e-5f, fabsf(iou_thr)), 1e-30f);
  int picks = 0;
  bool tame = true;  // every pick's area under 1e30 (see over_threshold)
  for (int base = 0; base < n && picks < max_det; base += kThreads) {
    const int r = base + tid;
    int c = 0;
    float4 b = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float s = 0.0f;
    if (r < n) {
      c = in_order ? r : static_cast<int>(lk[r] & 0xffffffffull);
      b = lb[c];
      s = ls[c];
    }
    const float area = box_area(b.x, b.y, b.z, b.w);
    bool alive = r < n;
    const float m = tame && area < 1e30f ? margin : NAN;
    for (int p = 0; p < picks; p += 4) {
      if (!__any_sync(kFull, alive)) break;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (p + u < picks &&
            suppresses(pbox[p + u], parea[p + u], b, area, iou_thr, m)) {
          alive = false;
        }
      }
    }
    cbox[tid] = b;
    carea[tid] = area;
    cscore[tid] = s;
    cidx[tid] = c;
    const unsigned ballot = __ballot_sync(kFull, alive);
    if (wl == 0) survivors[warp] = ballot;
    __syncthreads();
    if (warp == 0) {
      const int first = picks;  // the picks made before this chunk
      for (int w = 0; w < WARPS && picks < max_det; ++w) {
        if (survivors[w] == 0u) continue;
        const int q = 32 * w + wl;
        const float4 cb = cbox[q];
        const float ca = carea[q];
        bool al = survivors[w] >> wl & 1u;
        const float cm = tame && ca < 1e30f ? margin : NAN;
        for (int p = first; p < picks; ++p) {
          if (al && suppresses(pbox[p], parea[p], cb, ca, iou_thr, cm)) {
            al = false;
          }
        }
        unsigned left = __ballot_sync(kFull, al);
        while (left != 0u && picks < max_det) {
          const int lead = 32 * w + __ffs(left) - 1;  // the next pick
          const float4 kb = cbox[lead];
          const float ka = carea[lead];
          if (wl == 0) {
            pbox[picks] = kb;
            parea[picks] = ka;
            idx_row[picks] = cidx[lead];
            score_row[picks] = cscore[lead];
          }
          ++picks;
          tame = tame && ka < 1e30f;
          if (q == lead) al = false;
          const float pm = ka < 1e30f && ca < 1e30f ? margin : NAN;
          if (al && suppresses(kb, ka, cb, ca, iou_thr, pm)) al = false;
          left = __ballot_sync(kFull, al);
        }
        __syncwarp();  // this sub-chunk's picks are read by the next
      }
      if (wl == 0) {
        shared_picks = picks;
        shared_tame = tame;
      }
    }
    __syncthreads();
    picks = shared_picks;
    tame = shared_tame != 0;
  }

  for (int r = picks + tid; r < max_det; r += kThreads) {
    idx_row[r] = 0;
    score_row[r] = -1.0f;
  }
  if (tid == 0) out_valid[lane] = picks;
}

template <int WARPS>
cudaError_t launch_scan(const float* boxes, const float* scores, int lanes,
                        int k, int max_det, float iou_thr, float score_thr,
                        int sort_cap, unsigned long long* keys, int* out_idx,
                        float* out_scores, int* out_valid,
                        cudaStream_t stream) {
  const int cap = max_det < k ? max_det : k;
  const size_t smem = ScanCta<WARPS>::bytes(cap);
  cudaError_t err = cudaFuncSetAttribute(
      nms_scan_kernel<WARPS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  nms_scan_kernel<WARPS><<<lanes, 32 * WARPS, smem, stream>>>(
      boxes, scores, k, max_det, cap, iou_thr, score_thr, sort_cap, keys,
      out_idx, out_scores, out_valid);
  return cudaGetLastError();
}

// One CTA of WARPS warps a lane. Thread t owns the slots at t, t + T, ...
// (T = 32 * WARPS); `slots` a thread, so the lane holds slots * T
// candidates: boxes, areas, scores, then each warp's queue (intersections,
// unions, slots), then the candidates' indices (16 bits: k <= 8192).
template <int WARPS>
struct CompactCta {
  static constexpr int kThreads = 32 * WARPS;
  static constexpr int kQueue = 64;  // pairs a warp queues before scaling
  static constexpr int kQueueSlots = kQueue + 32;  // and a spare a thread
  static size_t bytes(int slots) {
    const size_t cap = static_cast<size_t>(slots) * kThreads;
    return cap * 26 + static_cast<size_t>(WARPS) * kQueueSlots * 10;
  }
};

// Each warp's best of a round (double-buffered by the round's parity):
// score bits, index, box and area.
template <int WARPS>
struct CompactParts {
  unsigned key[2][WARPS], idx[2][WARPS];
  float4 box[2][WARPS];
  float area[2][WARPS];
};

// The rounds of a lane whose thread holds `m` slots; returns the picks.
template <int WARPS, bool GAUSSIAN>
__device__ __forceinline__ int compact_rounds(
    CompactParts<WARPS>& parts, float4* box, float* area, float* sc,
    unsigned short* idx, float* qi, float* qu, unsigned short* qa, int m,
    int max_det, float iou_thr, float score_thr, float two_sigma,
    float margin, int* idx_row, float* score_row) {
  constexpr int kThreads = CompactCta<WARPS>::kThreads;
  constexpr int kQueue = CompactCta<WARPS>::kQueue;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wl = tid & 31;
  const unsigned below = (1u << wl) - 1u;
  // without an intersection the IoU is 0 and the scale exactly 1, unless 0
  // is past the IoU threshold: then every pair needs its scale
  const float no_overlap = iou_thr >= 0.0f ? 0.0f : -1.0f;

  // this thread's best slot: its slots hold ascending indices, so the
  // first among equal scores is the lowest index
  float best = 0.0f;
  int best_at = tid;
  for (int i = 0; i < m; ++i) {
    const int a = i * kThreads + tid;
    if (sc[a] > best) {
      best = sc[a];
      best_at = a;
    }
  }
  int picks = 0;
  for (; picks < max_det; ++picks) {
    // the pick: the largest score's bits (alive scores are > 0), then the
    // lowest index holding it; each warp's best to the partials
    const int buf = picks & 1;
    const unsigned key = __float_as_uint(best);
    const unsigned wtop = __reduce_max_sync(kFull, key);
    const unsigned mine =
        key == wtop && key != 0u ? static_cast<unsigned>(idx[best_at])
                                 : kNoRank;
    const unsigned widx = __reduce_min_sync(kFull, mine);
    const bool holder = mine == widx && mine != kNoRank;
    if (wl == 0) {
      parts.key[buf][warp] = wtop;
      parts.idx[buf][warp] = widx;
    }
    if (holder) {
      parts.box[buf][warp] = box[best_at];
      parts.area[buf][warp] = area[best_at];
    }
    if (WARPS > 1) {
      __syncthreads();
    } else {
      __syncwarp();
    }
    const unsigned pk = wl < WARPS ? parts.key[buf][wl] : 0u;
    const unsigned pi = wl < WARPS ? parts.idx[buf][wl] : kNoRank;
    const unsigned top = __reduce_max_sync(kFull, pk);
    if (top == 0u) break;  // no candidate alive
    const unsigned pick = __reduce_min_sync(kFull, pk == top ? pi : kNoRank);
    const int from = __ffs(__ballot_sync(kFull, wl < WARPS && pk == top &&
                                                    pi == pick)) - 1;
    if (tid == 0) {
      idx_row[picks] = static_cast<int>(pick);
      score_row[picks] = __uint_as_float(top);
    }
    const float4 pb = parts.box[buf][from];
    const float pa = parts.area[buf][from];
    if (holder && warp == from) sc[best_at] = 0.0f;  // the pick leaves

    // the decay of this thread's slots; the warp's intersecting pairs are
    // queued and their scales computed 32 at a time
    const int width = __reduce_max_sync(kFull, static_cast<unsigned>(m));
    int queued = 0;
    for (int i = 0; i < width; ++i) {
      if (GAUSSIAN && queued > kQueue - 32) {
        __syncwarp();
        for (int q = wl; q < queued; q += 32) {
          const int a = qa[q];
          sc[a] = still_above(
              __fmul_rn(sc[a], gaussian_scale(qi[q], qu[q], iou_thr,
                                              two_sigma)),
              score_thr);
        }
        __syncwarp();
        queued = 0;
      }
      const int a = i * kThreads + tid;  // past m: a stale slot, not used
      const float s = sc[a];
      const float4 c = box[a];
      const float ca = area[a];
      const float iw =
          fmaxf(__fsub_rn(fminf(pb.z, c.z), fmaxf(pb.x, c.x)), 0.0f);
      const float ih =
          fmaxf(__fsub_rn(fminf(pb.w, c.w), fmaxf(pb.y, c.y)), 0.0f);
      const float inter = __fmul_rn(iw, ih);
      const float uni = fmaxf(__fsub_rn(__fadd_rn(pa, ca), inter), 1e-8f);
      if (GAUSSIAN) {
        const bool needed = i < m && s > 0.0f && inter > no_overlap;
        const unsigned ballot = __ballot_sync(kFull, needed);
        if (ballot != 0u) {
          const int at =
              needed ? queued + __popc(ballot & below) : kQueue + wl;
          qi[at] = inter;
          qu[at] = uni;
          qa[at] = static_cast<unsigned short>(a);
          queued += __popc(ballot);
        }
      } else if (i < m && s > 0.0f &&
                 over_threshold(inter, uni, iou_thr, margin)) {
        sc[a] = 0.0f;
      }
    }
    if (GAUSSIAN && queued != 0) {
      __syncwarp();
      for (int q = wl; q < queued; q += 32) {
        const int a = qa[q];
        sc[a] = still_above(
            __fmul_rn(sc[a],
                      gaussian_scale(qi[q], qu[q], iou_thr, two_sigma)),
            score_thr);
      }
    }
    __syncwarp();

    // the thread's next best (a pass without stores, so that its loads
    // overlap); once a quarter of its slots are gone, the candidates gone
    // leave them and the others keep their order
    best = 0.0f;
    best_at = tid;
    int gone = 0;
    for (int i = 0; i < m; ++i) {
      const int a = i * kThreads + tid;
      const float s = sc[a];
      gone += s > 0.0f ? 0 : 1;
      if (s > best) {
        best = s;
        best_at = a;
      }
    }
    if (4 * gone > m) {
      int kept = 0;
      for (int i = 0; i < m; ++i) {
        const int a = i * kThreads + tid;
        const float s = sc[a];
        if (s > 0.0f) {
          const int to = kept * kThreads + tid;
          if (to != a) {
            box[to] = box[a];
            area[to] = area[a];
            sc[to] = s;
            idx[to] = idx[a];
          }
          if (a == best_at) best_at = to;
          ++kept;
        }
      }
      m = kept;
    }
  }
  return picks;
}

template <int WARPS>
__global__ void __launch_bounds__(32 * WARPS)
    nms_compact_kernel(const float* __restrict__ boxes,
                       const float* __restrict__ scores, int k, int slots,
                       int max_det, float iou_thr, float score_thr,
                       float two_sigma, int mode, int* __restrict__ out_idx,
                       float* __restrict__ out_scores,
                       int* __restrict__ out_valid) {
  constexpr int kThreads = CompactCta<WARPS>::kThreads;
  constexpr int kQueueSlots = CompactCta<WARPS>::kQueueSlots;
  extern __shared__ float4 compact_smem[];
  __shared__ int warp_n[WARPS];
  __shared__ CompactParts<WARPS> parts;
  const int cap = slots * kThreads;
  const int lane = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wl = tid & 31;
  float4* box = compact_smem;
  float* area = reinterpret_cast<float*>(box + cap);
  float* sc = area + cap;
  float* qi = sc + cap + warp * kQueueSlots;
  float* qu = sc + cap + (WARPS + warp) * kQueueSlots;
  unsigned short* qa = reinterpret_cast<unsigned short*>(
                           sc + cap + 2 * WARPS * kQueueSlots) +
                       warp * kQueueSlots;
  unsigned short* idx = reinterpret_cast<unsigned short*>(
                            sc + cap + 2 * WARPS * kQueueSlots) +
                        WARPS * kQueueSlots;

  // the candidates above the threshold staged in index order: position p
  // is slot p / T of thread p % T
  const float* ls = scores + static_cast<size_t>(lane) * k;
  const float4* lb = reinterpret_cast<const float4*>(boxes) +
                     static_cast<size_t>(lane) * k;
  const unsigned below = (1u << wl) - 1u;
  int n = 0;
  bool tame = true;  // every area under 1e30, so every union under 2^126
  for (int j0 = 0; j0 < k; j0 += kThreads) {
    const int j = j0 + tid;
    const float s = j < k ? ls[j] : 0.0f;
    const bool take = j < k && s > score_thr;
    const unsigned ballot = __ballot_sync(kFull, take);
    if (wl == 0) warp_n[warp] = __popc(ballot);
    __syncthreads();
    int at = n, total = n;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      at += w < warp ? warp_n[w] : 0;
      total += warp_n[w];
    }
    if (take) {
      const int p = at + __popc(ballot & below);
      const float4 b = lb[j];
      box[p] = b;
      area[p] = box_area(b.x, b.y, b.z, b.w);
      sc[p] = s;
      idx[p] = static_cast<unsigned short>(j);
      tame = tame && area[p] < 1e30f;
    }
    n = total;
    __syncthreads();  // warp_n is written again
  }
  tame = __syncthreads_and(tame);

  int* idx_row = out_idx + static_cast<size_t>(lane) * max_det;
  float* score_row = out_scores + static_cast<size_t>(lane) * max_det;
  const float margin =
      tame ? __fadd_rn(__fmul_rn(1e-5f, fabsf(iou_thr)), 1e-30f) : NAN;
  const int m = n > tid ? (n - tid + kThreads - 1) / kThreads : 0;
  const int picks =
      mode == kSoftGaussian
          ? compact_rounds<WARPS, true>(parts, box, area, sc, idx, qi, qu, qa,
                                        m, max_det, iou_thr, score_thr,
                                        two_sigma, margin, idx_row, score_row)
          : compact_rounds<WARPS, false>(parts, box, area, sc, idx, qi, qu,
                                         qa, m, max_det, iou_thr, score_thr,
                                         two_sigma, margin, idx_row,
                                         score_row);

  for (int r = picks + tid; r < max_det; r += kThreads) {
    idx_row[r] = 0;
    score_row[r] = -1.0f;
  }
  if (tid == 0) out_valid[lane] = picks;
}

template <int WARPS>
cudaError_t launch_compact(const float* boxes, const float* scores,
                           int lanes, int k, int max_det, float iou_thr,
                           float score_thr, float two_sigma, int mode,
                           int* out_idx, float* out_scores, int* out_valid,
                           cudaStream_t stream) {
  const int slots = (k + CompactCta<WARPS>::kThreads - 1) /
                    CompactCta<WARPS>::kThreads;
  const size_t smem = CompactCta<WARPS>::bytes(slots);
  cudaError_t err = cudaFuncSetAttribute(
      nms_compact_kernel<WARPS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  nms_compact_kernel<WARPS><<<lanes, 32 * WARPS, smem, stream>>>(
      boxes, scores, k, slots, max_det, iou_thr, score_thr, two_sigma, mode,
      out_idx, out_scores, out_valid);
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

// `boxes` must be aligned to 16 bytes; `keys` holds `sort_cap` 64-bit words
// a lane, sort_cap >= k. A threshold under -1e10 is refused (the scan is
// hard mode's), and so is a lane whose picks, min(max_det, k), do not fit in
// shared memory.
int nms_scan_launch(const float* boxes, const float* scores, int lanes,
                    int k, int max_det, float iou_thr, float score_thr,
                    int sort_cap, void* keys, int* out_idx,
                    float* out_scores, int* out_valid, int device,
                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!(score_thr >= kNegInf) || sort_cap < k) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  err = launch_scan<kScanWarps>(
      boxes, scores, lanes, k, max_det, iou_thr, score_thr, sort_cap,
      static_cast<unsigned long long*>(keys), out_idx, out_scores, out_valid,
      static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}

// `boxes` must be aligned to 16 bytes; k above 8192, a threshold under 0
// (or NaN) and hard mode are refused.
int nms_compact_launch(const float* boxes, const float* scores, int lanes,
                       int k, int max_det, float iou_thr, float score_thr,
                       float two_sigma, int mode, int* out_idx,
                       float* out_scores, int* out_valid, int device,
                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (k > kCompactMaxCandidates || !(score_thr >= 0.0f) ||
      (mode != kSoftGaussian && mode != kSoftHard)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  err = launch_compact<kCompactWarps>(
      boxes, scores, lanes, k, max_det, iou_thr, score_thr, two_sigma, mode,
      out_idx, out_scores, out_valid, static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}

const char* nms_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
