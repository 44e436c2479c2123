// Decoded JPEG component planes -> interleaved RGB, the way libjpeg-turbo
// does it by default (jdsample.c with do_fancy_upsampling, jdcolor.c
// ycc_rgb_convert / gray_rgb_convert), so that a decoder which stops at the
// planes (nvJPEG) ends in libjpeg's pixels up to its IDCT's rounding.
//
// Upsampling of a component to the luma grid, chosen as libjpeg chooses:
//   same size          -> copy
//   2x horizontally    -> triangle filter (h2v1 fancy) if wider than 2
//   2x vertically      -> triangle filter (h1v2 fancy)
//   2x both            -> triangle filter (h2v2 fancy) if wider than 2
//   any other integers -> replication
// The row above the first and below the last is the edge row itself, as in
// libjpeg's context rows. Header only: included by jpeg_nvjpeg.cpp and by
// the CPU test's libjpeg harness (tests/jpeg_ycc_check.cpp).

#pragma once

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <vector>

namespace ycc {

struct Plane {
  const unsigned char* data;
  size_t pitch;
  int width, height;   // the component's own (downsampled) size
  int h_expand, v_expand;  // luma samples per component sample
};

namespace detail {

inline const unsigned char* row(const Plane& p, int r) {
  r = std::min(std::max(r, 0), p.height - 1);  // edge rows repeat
  return p.data + static_cast<size_t>(r) * p.pitch;
}

// Output row `y` of plane `p` upsampled to at least `width` samples.
inline void upsample_row(const Plane& p, int y, int width,
                         unsigned char* out) {
  const int dw = p.width;
  if (p.h_expand == 1 && p.v_expand == 1) {
    std::copy(row(p, y), row(p, y) + width, out);
    return;
  }
  if (p.h_expand == 2 && p.v_expand == 1 && dw > 2) {
    const unsigned char* in = row(p, y);
    out[0] = in[0];
    out[1] = static_cast<unsigned char>((in[0] * 3 + in[1] + 2) >> 2);
    for (int x = 1; x < dw - 1; ++x) {
      const int v = in[x] * 3;
      out[2 * x] = static_cast<unsigned char>((v + in[x - 1] + 1) >> 2);
      out[2 * x + 1] = static_cast<unsigned char>((v + in[x + 1] + 2) >> 2);
    }
    out[2 * dw - 2] =
        static_cast<unsigned char>((in[dw - 1] * 3 + in[dw - 2] + 1) >> 2);
    out[2 * dw - 1] = in[dw - 1];
    return;
  }
  if (p.h_expand == 1 && p.v_expand == 2) {
    const int r = y >> 1;
    const bool below = y & 1;
    const unsigned char* in0 = row(p, r);
    const unsigned char* in1 = row(p, below ? r + 1 : r - 1);
    const int bias = below ? 2 : 1;
    for (int x = 0; x < dw; ++x) {
      out[x] = static_cast<unsigned char>((in0[x] * 3 + in1[x] + bias) >> 2);
    }
    return;
  }
  if (p.h_expand == 2 && p.v_expand == 2 && dw > 2) {
    const int r = y >> 1;
    const unsigned char* in0 = row(p, r);
    const unsigned char* in1 = row(p, (y & 1) ? r + 1 : r - 1);
    int last = 0;
    int cur = in0[0] * 3 + in1[0];
    int next = in0[1] * 3 + in1[1];
    out[0] = static_cast<unsigned char>((cur * 4 + 8) >> 4);
    out[1] = static_cast<unsigned char>((cur * 3 + next + 7) >> 4);
    last = cur;
    cur = next;
    for (int x = 1; x < dw - 1; ++x) {
      next = in0[x + 1] * 3 + in1[x + 1];
      out[2 * x] = static_cast<unsigned char>((cur * 3 + last + 8) >> 4);
      out[2 * x + 1] = static_cast<unsigned char>((cur * 3 + next + 7) >> 4);
      last = cur;
      cur = next;
    }
    out[2 * dw - 2] = static_cast<unsigned char>((cur * 3 + last + 8) >> 4);
    out[2 * dw - 1] = static_cast<unsigned char>((cur * 4 + 7) >> 4);
    return;
  }
  const unsigned char* in = row(p, y / p.v_expand);
  for (int x = 0; x < width; ++x) out[x] = in[x / p.h_expand];
}

struct Tables {
  int cr_r[256], cb_b[256];
  int32_t cr_g[256], cb_g[256];
  Tables() {
    const int32_t half = 1 << 15;
    auto fix = [](double v) {
      return static_cast<int32_t>(v * 65536.0 + 0.5);
    };
    for (int i = 0; i < 256; ++i) {
      const int32_t x = i - 128;
      cr_r[i] = (fix(1.40200) * x + half) >> 16;
      cb_b[i] = (fix(1.77200) * x + half) >> 16;
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + half;
    }
  }
};

inline unsigned char clamp255(int v) {
  return static_cast<unsigned char>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

}  // namespace detail

// planes: 1 (grayscale) or 3 (Y, Cb, Cr); out: (height, width, 3) RGB.
inline void planes_to_rgb(const Plane* planes, int n, int width, int height,
                          unsigned char* out) {
  static const detail::Tables t;
  // an upsampled row is `width` samples, or one more where a 2x
  // component's last sample covers a column past an odd width
  std::vector<unsigned char> buf(3 * (static_cast<size_t>(width) + 8));
  unsigned char* up[3] = {buf.data(), buf.data() + width + 8,
                          buf.data() + 2 * (width + 8)};
  for (int y = 0; y < height; ++y) {
    unsigned char* o = out + static_cast<size_t>(y) * width * 3;
    if (n == 1) {
      const unsigned char* g = detail::row(planes[0], y);
      for (int x = 0; x < width; ++x) {
        o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = g[x];
      }
      continue;
    }
    for (int c = 0; c < 3; ++c) {
      detail::upsample_row(planes[c], y, width, up[c]);
    }
    const unsigned char *yy = up[0], *cb = up[1], *cr = up[2];
    for (int x = 0; x < width; ++x) {
      const int l = yy[x];
      o[3 * x] = detail::clamp255(l + t.cr_r[cr[x]]);
      o[3 * x + 1] =
          detail::clamp255(l + ((t.cb_g[cb[x]] + t.cr_g[cr[x]]) >> 16));
      o[3 * x + 2] = detail::clamp255(l + t.cb_b[cb[x]]);
    }
  }
}

}  // namespace ycc
