// Test harness for retinanet_torch/csrc/host/jpeg_ycc.h on the CPU: libjpeg
// decodes a JPEG only as far as its component planes (raw_data_out), and
// ycc::planes_to_rgb finishes it. tests/test_torch_jpeg_cuda.py holds the
// result to libjpeg's own RGB decode of the same JPEG, which it must equal
// bit for bit: the nvJPEG route finishes its planes with the same code.
// rgb_libjpeg decodes with libjpeg's other IDCT or without its fancy
// upsampling, the two ways in which nvJPEG's pixels can differ.
//
//   g++ -O3 -shared -fPIC -I retinanet_torch/csrc/host -o libjpeg_ycc_check.so \
//       tests/jpeg_ycc_check.cpp -ljpeg

#include <csetjmp>
#include <cstdio>
#include <vector>

#include <jpeglib.h>

#include "jpeg_ycc.h"

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf jump;
};

void on_error(j_common_ptr cinfo) {
  longjmp(reinterpret_cast<ErrorMgr*>(cinfo->err)->jump, 1);
}

}  // namespace

extern "C" {

// (h, w, 3) RGB into `out` (capacity bytes). Returns 0 on success, -1 on a
// libjpeg error, -2 if `out` is too small or the JPEG is not 1 or 3
// components.
int rgb_via_planes(const unsigned char* data, long len, unsigned char* out,
                   long capacity) {
  jpeg_decompress_struct cinfo;
  ErrorMgr err;
  cinfo.err = jpeg_std_error(&err.pub);
  err.pub.error_exit = on_error;
  std::vector<std::vector<unsigned char>> store;
  if (setjmp(err.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);
  const int n = cinfo.num_components;
  if ((n != 1 && n != 3) ||
      static_cast<long>(cinfo.image_width) * cinfo.image_height * 3 >
          capacity) {
    jpeg_destroy_decompress(&cinfo);
    return -2;
  }
  cinfo.raw_data_out = TRUE;
  jpeg_start_decompress(&cinfo);
  const int group = cinfo.max_v_samp_factor * DCTSIZE;
  std::vector<size_t> pitch(n);
  std::vector<std::vector<JSAMPROW>> rows(n);
  for (int c = 0; c < n; ++c) {
    const jpeg_component_info& comp = cinfo.comp_info[c];
    pitch[c] = comp.width_in_blocks * DCTSIZE;
    const size_t lines =
        static_cast<size_t>(cinfo.total_iMCU_rows) * comp.v_samp_factor *
        DCTSIZE;
    store.emplace_back(pitch[c] * lines);
    for (size_t r = 0; r < lines; ++r) {
      rows[c].push_back(store[c].data() + r * pitch[c]);
    }
  }
  for (JDIMENSION imcu = 0; imcu < cinfo.total_iMCU_rows; ++imcu) {
    JSAMPARRAY planes[3];
    for (int c = 0; c < n; ++c) {
      planes[c] = rows[c].data() +
                  imcu * cinfo.comp_info[c].v_samp_factor * DCTSIZE;
    }
    jpeg_read_raw_data(&cinfo, planes, group);
  }
  ycc::Plane p[3];
  for (int c = 0; c < n; ++c) {
    const jpeg_component_info& comp = cinfo.comp_info[c];
    p[c] = {store[c].data(), pitch[c],
            static_cast<int>(comp.downsampled_width),
            static_cast<int>(comp.downsampled_height),
            cinfo.max_h_samp_factor / comp.h_samp_factor,
            cinfo.max_v_samp_factor / comp.v_samp_factor};
  }
  ycc::planes_to_rgb(p, n, static_cast<int>(cinfo.image_width),
                     static_cast<int>(cinfo.image_height), out);
  jpeg_abort_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// libjpeg's RGB decode with its float IDCT (`float_dct`) or its integer
// one, with or without fancy upsampling. Returns as rgb_via_planes.
int rgb_libjpeg(const unsigned char* data, long len, unsigned char* out,
                long capacity, int float_dct, int fancy) {
  jpeg_decompress_struct cinfo;
  ErrorMgr err;
  cinfo.err = jpeg_std_error(&err.pub);
  err.pub.error_exit = on_error;
  if (setjmp(err.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);
  if (static_cast<long>(cinfo.image_width) * cinfo.image_height * 3 >
      capacity) {
    jpeg_destroy_decompress(&cinfo);
    return -2;
  }
  cinfo.out_color_space = JCS_RGB;
  cinfo.dct_method = float_dct ? JDCT_FLOAT : JDCT_ISLOW;
  cinfo.do_fancy_upsampling = fancy ? TRUE : FALSE;
  jpeg_start_decompress(&cinfo);
  const size_t stride = static_cast<size_t>(cinfo.output_width) * 3;
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = out + cinfo.output_scanline * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

}  // extern "C"
