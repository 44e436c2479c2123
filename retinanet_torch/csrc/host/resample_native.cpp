// Fused bilinear resample + crop + horizontal-flip + pad for the host
// input pipeline, on uint8 images (the port's own copy of the uint8 lane
// of native/resample_native.cpp: the same arithmetic, so the same pixels
// bit for bit when built with the same flags).
//
// The geometry is tf.image.resize (bilinear, half-pixel centers,
// clamp-at-edge) to round(src*scale), then an integer crop at
// (off_y, off_x), then top-left pad. This computes the identical sampling
// directly into the target canvas:
//
//   fy = (y + off_y + 0.5) / sy - 0.5
//   u  = (x + off_x + 0.5) / sx - 0.5
//   fx = flip ? (sw - 1) - u : u        // mirror-then-resize == resize
//                                       // at mirrored coords (exact in
//                                       // float bilinear)
//
// Separable: each needed source row is horizontally resampled once into
// a float row cache (monotonic fy -> each source row is computed at most
// once), the vertical lerp + store runs per output row. Float weights.
// Runs entirely outside the GIL.
//
// Build (retinanet_torch/data/host_codec.py does it at first use):
//   g++ -O3 -march=native -shared -fPIC -o libresample_native.so \
//       resample_native.cpp

#include <cmath>
#include <cstdint>
#include <vector>

using u8 = unsigned char;

extern "C" {

int resample_bilinear_u8(const u8* src, int sh, int sw, u8* dst, int dh,
                         int dw, int vh, int vw, double sy, double sx,
                         double off_y, double off_x, int flip,
                         const float* pad) {
  if (sh <= 0 || sw <= 0 || vh > dh || vw > dw || vh < 0 || vw < 0 ||
      sy <= 0.0 || sx <= 0.0) {
    return -1;
  }
  // Per-output-x source taps, clamped at the edges.
  std::vector<int> x0(vw), x1(vw);
  std::vector<float> wx(vw);
  for (int x = 0; x < vw; ++x) {
    double u = (x + off_x + 0.5) / sx - 0.5;
    if (flip) u = (sw - 1) - u;
    if (u <= 0.0) {
      x0[x] = x1[x] = 0;
      wx[x] = 0.0f;
    } else if (u >= sw - 1) {
      x0[x] = x1[x] = sw - 1;
      wx[x] = 0.0f;
    } else {
      int i = static_cast<int>(u);
      x0[x] = i;
      x1[x] = i + 1;
      wx[x] = static_cast<float>(u - i);
    }
  }

  std::vector<float> row_a(static_cast<size_t>(vw) * 3);
  std::vector<float> row_b(static_cast<size_t>(vw) * 3);
  int cached_a = -1, cached_b = -1;
  auto hrow = [&](int r, float* out) {
    const u8* s = src + static_cast<size_t>(r) * sw * 3;
    for (int x = 0; x < vw; ++x) {
      const u8* p0 = s + static_cast<size_t>(x0[x]) * 3;
      const u8* p1 = s + static_cast<size_t>(x1[x]) * 3;
      const float w = wx[x];
      out[x * 3 + 0] = p0[0] + w * (static_cast<float>(p1[0]) - p0[0]);
      out[x * 3 + 1] = p0[1] + w * (static_cast<float>(p1[1]) - p0[1]);
      out[x * 3 + 2] = p0[2] + w * (static_cast<float>(p1[2]) - p0[2]);
    }
  };

  u8 pad_t[3];
  for (int c = 0; c < 3; ++c) pad_t[c] = static_cast<u8>(pad[c]);

  for (int y = 0; y < vh; ++y) {
    double fy = (y + off_y + 0.5) / sy - 0.5;
    int y0, y1;
    float wy;
    if (fy <= 0.0) {
      y0 = y1 = 0;
      wy = 0.0f;
    } else if (fy >= sh - 1) {
      y0 = y1 = sh - 1;
      wy = 0.0f;
    } else {
      y0 = static_cast<int>(fy);
      y1 = y0 + 1;
      wy = static_cast<float>(fy - y0);
    }
    if (cached_a != y0 && cached_b == y0) {
      row_a.swap(row_b);
      std::swap(cached_a, cached_b);
    }
    if (cached_a != y0) {
      hrow(y0, row_a.data());
      cached_a = y0;
    }
    const float* a = row_a.data();
    const float* b = a;
    if (y1 != y0) {
      if (cached_b != y1) {
        hrow(y1, row_b.data());
        cached_b = y1;
      }
      b = row_b.data();
    }
    u8* d = dst + static_cast<size_t>(y) * dw * 3;
    const int n = vw * 3;
    for (int x = 0; x < n; ++x) {
      const float v = a[x] + wy * (b[x] - a[x]);
      d[x] = static_cast<u8>(v + 0.5f);  // v is a convex combo of [0,255]
    }
    for (int x = vw; x < dw; ++x) {
      d[x * 3 + 0] = pad_t[0];
      d[x * 3 + 1] = pad_t[1];
      d[x * 3 + 2] = pad_t[2];
    }
  }
  for (int y = vh; y < dh; ++y) {
    u8* d = dst + static_cast<size_t>(y) * dw * 3;
    for (int x = 0; x < dw; ++x) {
      d[x * 3 + 0] = pad_t[0];
      d[x * 3 + 1] = pad_t[1];
      d[x * 3 + 2] = pad_t[2];
    }
  }
  return 0;
}

}  // extern "C"
