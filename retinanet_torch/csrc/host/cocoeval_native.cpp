// The COCO bbox matcher of eval/coco.py in C++ (the port's own copy of
// native/cocoeval_native.cpp). One call matches every (image, category)
// group at every IoU threshold and area range:
//
//   * a group's IoU matrix is computed once and serves the 4 area ranges;
//   * the greedy matching, sequential over the detections in score order,
//     runs as plain loops.
//
// Its outputs equal COCOEval._evaluate_img's (the numpy spec) bit for bit:
// gts stably sorted non-ignored first in each area range (numpy's
// mergesort), crowd gts matched by IoA and matchable again, the running
// best taken with `iou >= best` (a later tie wins), the scan stopped once
// a non-ignored match exists and the ignored gts begin, and an unmatched
// detection ignored when its "area" lies outside the range. The IoU is
// box_iou_xywh's float64 arithmetic in its order; the library is built with
// -ffp-contract=off, so that no multiply and add are fused into one FMA
// and an IoU that numpy computes as exactly 0.5 stays 0.5.
//
// Inputs are flat arrays over the groups; each group's detections arrive
// sorted by descending score (stably) and cut to max(MAX_DETS).
//
// Build (retinanet_torch/eval/native.py does it at first use):
//   g++ -O3 -march=native -ffp-contract=off -shared -fPIC \
//       -o libcocoeval_native.so cocoeval_native.cpp

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// eval/coco.py:box_iou_xywh for one pair, in numpy's order of operations
inline double box_iou(const double* d, const double* g, bool crowd) {
  const double dx2 = d[0] + d[2], dy2 = d[1] + d[3];
  const double gx2 = g[0] + g[2], gy2 = g[1] + g[3];
  double ix = (dx2 < gx2 ? dx2 : gx2) - (d[0] > g[0] ? d[0] : g[0]);
  double iy = (dy2 < gy2 ? dy2 : gy2) - (d[1] > g[1] ? d[1] : g[1]);
  if (ix < 0) ix = 0;
  if (iy < 0) iy = 0;
  const double inter = ix * iy;
  const double d_area = d[2] * d[3];
  const double g_area = g[2] * g[3];
  const double uni = crowd ? d_area : (d_area + g_area) - inter;
  if (!(uni > 0)) return 0.0;
  return inter / (uni > 1e-10 ? uni : 1e-10);
}

}  // namespace

extern "C" int coco_match_groups(
    int64_t n_groups,
    const int64_t* dt_off,         // [n_groups + 1] offsets into dt arrays
    const int64_t* gt_off,         // [n_groups + 1] offsets into gt arrays
    const double* dt_boxes,        // [sumD * 4] xywh, score-descending
    const double* dt_areas,        // [sumD] the detections' "area"
    const double* gt_boxes,        // [sumG * 4] xywh
    const double* gt_areas,        // [sumG] the annotations' "area"
    const uint8_t* gt_iscrowd,     // [sumG]
    const uint8_t* gt_ignore_base, // [sumG] iscrowd or the ignore flag
    int32_t n_area,
    const double* area_lo,         // [n_area]
    const double* area_hi,         // [n_area]
    int32_t n_thr,
    const double* thrs,            // [n_thr]
    uint8_t* dt_matched,           // out [n_area, n_thr, sumD]
    uint8_t* dt_ignore,            // out [n_area, n_thr, sumD]
    int32_t* num_gt) {             // out [n_area, n_groups]
  const int64_t sum_d = dt_off[n_groups];

  std::vector<double> iou;       // D x G, reused across groups
  std::vector<int64_t> order;    // gt indices, non-ignored first (stable)
  std::vector<uint8_t> ig_s;     // ignore flag in sorted order
  std::vector<uint8_t> crowd_s;  // iscrowd in sorted order
  std::vector<uint8_t> claimed;  // a gt matched at this threshold

  for (int64_t grp = 0; grp < n_groups; ++grp) {
    const int64_t d0 = dt_off[grp], g0 = gt_off[grp];
    const int64_t D = dt_off[grp + 1] - d0;
    const int64_t G = gt_off[grp + 1] - g0;

    iou.resize(static_cast<size_t>(D * G));
    for (int64_t d = 0; d < D; ++d)
      for (int64_t g = 0; g < G; ++g)
        iou[d * G + g] = box_iou(dt_boxes + (d0 + d) * 4,
                                 gt_boxes + (g0 + g) * 4,
                                 gt_iscrowd[g0 + g] != 0);
    order.resize(static_cast<size_t>(G));
    ig_s.resize(static_cast<size_t>(G));
    crowd_s.resize(static_cast<size_t>(G));
    claimed.resize(static_cast<size_t>(G));

    for (int32_t a = 0; a < n_area; ++a) {
      const double lo = area_lo[a], hi = area_hi[a];
      int64_t n_keep = 0;
      for (int64_t g = 0; g < G; ++g) {
        const double area = gt_areas[g0 + g];
        ig_s[g] = gt_ignore_base[g0 + g] || area < lo || area > hi;
        if (!ig_s[g]) order[n_keep++] = g;
      }
      num_gt[static_cast<int64_t>(a) * n_groups + grp] =
          static_cast<int32_t>(n_keep);
      for (int64_t g = 0, tail = n_keep; g < G; ++g)
        if (ig_s[g]) order[tail++] = g;
      for (int64_t gi = 0; gi < G; ++gi) {
        ig_s[gi] = gi >= n_keep;
        crowd_s[gi] = gt_iscrowd[g0 + order[gi]];
      }

      for (int32_t t = 0; t < n_thr; ++t) {
        const int64_t row = (static_cast<int64_t>(a) * n_thr + t) * sum_d;
        uint8_t* m_out = dt_matched + row + d0;
        uint8_t* i_out = dt_ignore + row + d0;
        std::memset(claimed.data(), 0, claimed.size());
        const double thr0 = thrs[t] < 1 - 1e-10 ? thrs[t] : 1 - 1e-10;
        for (int64_t d = 0; d < D; ++d) {
          double best = thr0;
          int64_t m = -1;
          const double* iou_row = iou.data() + d * G;
          for (int64_t gi = 0; gi < G; ++gi) {
            if (claimed[gi] && !crowd_s[gi]) continue;
            if (m > -1 && !ig_s[m] && ig_s[gi]) break;
            const double v = iou_row[order[gi]];
            if (v < best) continue;
            best = v;
            m = gi;
          }
          if (m >= 0) {
            claimed[m] = 1;
            m_out[d] = 1;
            i_out[d] = ig_s[m];
          } else {
            const double area = dt_areas[d0 + d];
            m_out[d] = 0;
            i_out[d] = area < lo || area > hi;
          }
        }
      }
    }
  }
  return 0;
}
