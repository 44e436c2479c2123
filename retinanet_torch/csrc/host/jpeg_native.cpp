// JPEG <-> RGB for the host input pipeline, through libjpeg(-turbo).
//
// The port's own copy of the decoder the JAX package uses
// (native/jpeg_native.cpp), so the pixels are the same bit for bit, plus an
// encoder for the synthetic dataset writer through the same library. Every
// call runs outside the GIL (ctypes releases it for the call's duration)
// and writes RGB directly into the caller's buffer.
//
// Build (retinanet_torch/data/host_codec.py does it at first use):
//   g++ -O3 -march=native -shared -fPIC -o libjpeg_native.so \
//       jpeg_native.cpp -ljpeg

#include <csetjmp>
#include <cstdio>
#include <cstdlib>
#include <cstring>

#include <jpeglib.h>
#include <jerror.h>

namespace {

struct ErrorCtx {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};

void on_error(j_common_ptr cinfo) {
  ErrorCtx* ctx = reinterpret_cast<ErrorCtx*>(cinfo->err);
  longjmp(ctx->jump, 1);
}

void silence(j_common_ptr, int) {}

// a warning that the data ended early: libjpeg goes on as if it had ended
// there, with the rest of the image grey
struct EofCtx {
  ErrorCtx err;
  bool eof = false;
};

void note_eof(j_common_ptr cinfo, int level) {
  if (level < 0 && cinfo->err->msg_code == JWRN_JPEG_EOF)
    reinterpret_cast<EofCtx*>(cinfo->err)->eof = true;
}

}  // namespace

extern "C" {

// Parse the header only. Returns 0 and fills (*w, *h) on success, -1 on
// malformed data. Cheap (no DCT work).
int jpg_dims(const unsigned char* data, long len, int* w, int* h) {
  jpeg_decompress_struct cinfo;
  ErrorCtx err;
  cinfo.err = jpeg_std_error(&err.mgr);
  err.mgr.error_exit = on_error;
  err.mgr.emit_message = silence;
  if (setjmp(err.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(data),
               static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  *w = static_cast<int>(cinfo.image_width);
  *h = static_cast<int>(cinfo.image_height);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Full decode into the caller-allocated RGB buffer (h * w * 3 bytes,
// C-contiguous, row-major). Returns 0 on success, -1 on malformed data,
// -2 if the buffer is too small for the decoded dimensions.
int jpg_decode_rgb(const unsigned char* data, long len, unsigned char* out,
                   long out_capacity, int* w, int* h) {
  jpeg_decompress_struct cinfo;
  ErrorCtx err;
  cinfo.err = jpeg_std_error(&err.mgr);
  err.mgr.error_exit = on_error;
  err.mgr.emit_message = silence;
  if (setjmp(err.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(data),
               static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  cinfo.out_color_space = JCS_RGB;  // grayscale/CMYK sources upconvert
  jpeg_start_decompress(&cinfo);
  const long width = cinfo.output_width;
  const long height = cinfo.output_height;
  const long row_bytes = width * cinfo.output_components;
  if (cinfo.output_components != 3 ||
      height * row_bytes > out_capacity) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return -2;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = out + static_cast<long>(cinfo.output_scanline) * row_bytes;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  *w = static_cast<int>(width);
  *h = static_cast<int>(height);
  return 0;
}

// The size of a JPEG whose every scanline decodes from the data given:
// the whole image is decoded (into one scratch row) and refused when the
// data ends before its last scanline, as OpenCV's cv2.imdecode refuses it,
// or when libjpeg fails. Returns 0 and fills (*w, *h), or -1.
int jpg_size(const unsigned char* data, long len, int* w, int* h) {
  jpeg_decompress_struct cinfo;
  EofCtx ctx;
  JSAMPROW row = nullptr;
  cinfo.err = jpeg_std_error(&ctx.err.mgr);
  ctx.err.mgr.error_exit = on_error;
  ctx.err.mgr.emit_message = note_eof;
  if (setjmp(ctx.err.jump)) {
    jpeg_destroy_decompress(&cinfo);
    free(row);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(data),
               static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  row = static_cast<JSAMPROW>(
      malloc(static_cast<size_t>(cinfo.output_width) *
             cinfo.output_components));
  while (!ctx.eof && row != nullptr &&
         cinfo.output_scanline < cinfo.output_height)
    jpeg_read_scanlines(&cinfo, &row, 1);
  const bool whole = !ctx.eof && row != nullptr;
  *w = static_cast<int>(cinfo.output_width);
  *h = static_cast<int>(cinfo.output_height);
  jpeg_abort_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  free(row);
  return whole ? 0 : -1;
}

// Baseline encode of an (h, w, 3) RGB image at `quality` with the
// library's defaults (4:2:0 chroma), into the caller's buffer. Returns 0
// and the byte count in *out_len, -1 on a library error, -2 if the buffer
// is too small.
int jpg_encode_rgb(const unsigned char* rgb, int w, int h, int quality,
                   unsigned char* out, long out_capacity, long* out_len) {
  jpeg_compress_struct cinfo;
  ErrorCtx err;
  unsigned char* mem = nullptr;
  unsigned long mem_len = 0;
  cinfo.err = jpeg_std_error(&err.mgr);
  err.mgr.error_exit = on_error;
  err.mgr.emit_message = silence;
  if (setjmp(err.jump)) {
    jpeg_destroy_compress(&cinfo);
    free(mem);
    return -1;
  }
  jpeg_create_compress(&cinfo);
  jpeg_mem_dest(&cinfo, &mem, &mem_len);
  cinfo.image_width = static_cast<JDIMENSION>(w);
  cinfo.image_height = static_cast<JDIMENSION>(h);
  cinfo.input_components = 3;
  cinfo.in_color_space = JCS_RGB;
  jpeg_set_defaults(&cinfo);
  jpeg_set_quality(&cinfo, quality, TRUE);
  jpeg_start_compress(&cinfo, TRUE);
  const long row_bytes = static_cast<long>(w) * 3;
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row = const_cast<unsigned char*>(rgb) +
                   static_cast<long>(cinfo.next_scanline) * row_bytes;
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  int rc = 0;
  if (static_cast<long>(mem_len) > out_capacity) {
    rc = -2;
  } else {
    memcpy(out, mem, mem_len);
    *out_len = static_cast<long>(mem_len);
  }
  free(mem);
  return rc;
}

}  // extern "C"
