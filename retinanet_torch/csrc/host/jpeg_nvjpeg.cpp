// JPEG <-> RGB for the host input pipeline, through nvJPEG of the CUDA
// toolkit: the route on a machine whose system has no libjpeg to build
// against. The same C interface as jpeg_native.cpp (jpg_dims, jpg_size,
// jpg_decode_rgb, jpg_encode_rgb), so one Python wrapper serves both.
//
// Decode: nvjpegDecode stops at the component planes (Y, Cb, Cr at their
// own sizes, or Y alone), which come down to pinned host memory; there
// jpeg_ycc.h upsamples the chroma and converts to RGB as libjpeg does by
// default (fancy upsampling, libjpeg's integer YCbCr tables), so the pixels
// differ from libjpeg's only by the IDCT's rounding. nvJPEG's own RGB
// output replicates the chroma samples instead, up to ~70 levels off at
// sharp colour edges. A subsampling that nvJPEG cannot name
// (NVJPEG_CSS_UNKNOWN, 4:1:0 vertical) takes nvJPEG's own RGB output.
// Encode: the host image is copied up and nvjpegEncodeImage writes a
// baseline 4:2:0 JPEG at the given quality.
//
// The pipeline calls these from several worker threads at once and builds
// a new thread pool for every training trial and every evaluation, while
// the train step runs on the same card. So nothing here may synchronise
// the device or tear down per thread:
//   * a call leases a context (its own non-blocking stream, decoder and
//     encoder state and output buffer) from a process-wide pool and gives
//     it back on return; contexts live until the process exits, so a
//     thread that ends frees nothing;
//   * every device and pinned buffer, nvJPEG's own included (nvjpegCreateEx
//     with the allocators below), comes from a cache that never gives
//     memory back to CUDA: no cudaFree or cudaFreeHost runs after start-up.
//     Sizes are rounded up to a power of two, so a few sizes serve every
//     image. A block that nvJPEG frees during a call may still be read by
//     work queued on that call's stream, so the free waits for that stream
//     (not the device) before the block can be handed out again.
// Every call synchronises its own stream before it returns; none holds the
// GIL.
//
// Build (retinanet_torch/data/host_codec.py does it at first use):
//   g++ -O3 -shared -fPIC -I/usr/local/cuda/include -o libjpeg_nvjpeg.so \
//       jpeg_nvjpeg.cpp -L/usr/local/cuda/lib64 -lnvjpeg -lcudart

#include <cstring>
#include <map>
#include <mutex>
#include <unordered_map>
#include <vector>

#include <cuda_runtime.h>
#include <nvjpeg.h>

#include "jpeg_ycc.h"

namespace {

// The stream of the context this thread holds (null outside a call).
thread_local cudaStream_t t_stream = nullptr;

size_t round_up_pow2(size_t bytes) {
  size_t n = 4096;
  while (n < bytes) n <<= 1;
  return n;
}

// Blocks of one kind (device, or pinned with given flags), never freed.
class BlockCache {
 public:
  template <typename Alloc>
  int take(void** p, size_t bytes, unsigned int flags, Alloc alloc) {
    bytes = round_up_pow2(bytes);
    std::lock_guard<std::mutex> lock(mu_);
    auto& sizes = free_[flags];
    auto it = sizes.find(bytes);
    if (it != sizes.end()) {
      *p = it->second;
      sizes.erase(it);
      return 0;
    }
    void* q = nullptr;
    if (alloc(&q, bytes, flags) != cudaSuccess) return 1;
    owner_[q] = {bytes, flags};
    *p = q;
    return 0;
  }

  int give(void* p) {
    if (p == nullptr) return 0;
    // work queued on this call's stream may still touch the block
    if (t_stream != nullptr) cudaStreamSynchronize(t_stream);
    std::lock_guard<std::mutex> lock(mu_);
    auto it = owner_.find(p);
    if (it == owner_.end()) return 1;
    free_[it->second.second].emplace(it->second.first, p);
    return 0;
  }

 private:
  std::mutex mu_;
  std::map<unsigned int, std::multimap<size_t, void*>> free_;
  std::unordered_map<void*, std::pair<size_t, unsigned int>> owner_;
};

BlockCache g_device, g_pinned;

int dev_malloc(void** p, size_t bytes) {
  return g_device.take(p, bytes, 0, [](void** q, size_t n, unsigned int) {
    return cudaMalloc(q, n);
  });
}
int dev_free(void* p) { return g_device.give(p); }
int pinned_malloc(void** p, size_t bytes, unsigned int flags) {
  return g_pinned.take(p, bytes, flags,
                       [](void** q, size_t n, unsigned int f) {
                         return cudaHostAlloc(q, n, f);
                       });
}
int pinned_free(void* p) { return g_pinned.give(p); }

nvjpegHandle_t g_handle = nullptr;
std::once_flag g_once;
nvjpegStatus_t g_create_status = NVJPEG_STATUS_SUCCESS;

nvjpegHandle_t handle() {
  std::call_once(g_once, [] {
    nvjpegDevAllocator_t dev = {dev_malloc, dev_free};
    nvjpegPinnedAllocator_t pinned = {pinned_malloc, pinned_free};
    g_create_status = nvjpegCreateEx(NVJPEG_BACKEND_DEFAULT, &dev, &pinned,
                                     0, &g_handle);
  });
  return g_create_status == NVJPEG_STATUS_SUCCESS ? g_handle : nullptr;
}

struct Context {
  cudaStream_t stream = nullptr;
  nvjpegJpegState_t dec = nullptr;
  nvjpegEncoderState_t enc = nullptr;
  nvjpegEncoderParams_t params = nullptr;
  void* buf = nullptr;   // device: decoded planes or RGB, image to encode
  size_t buf_bytes = 0;
  void* host = nullptr;  // pinned: the planes on their way to jpeg_ycc.h
  size_t host_bytes = 0;

  bool init(nvjpegHandle_t h) {
    return cudaStreamCreateWithFlags(&stream, cudaStreamNonBlocking) ==
               cudaSuccess &&
           nvjpegJpegStateCreate(h, &dec) == NVJPEG_STATUS_SUCCESS &&
           nvjpegEncoderStateCreate(h, &enc, stream) ==
               NVJPEG_STATUS_SUCCESS &&
           nvjpegEncoderParamsCreate(h, &params, stream) ==
               NVJPEG_STATUS_SUCCESS &&
           nvjpegEncoderParamsSetSamplingFactors(params, NVJPEG_CSS_420,
                                                 stream) ==
               NVJPEG_STATUS_SUCCESS;
  }

  // Grows the buffers through the caches: an old block goes back to its
  // cache, so growing never frees memory.
  bool reserve(size_t bytes) {
    if (bytes <= buf_bytes) return true;
    dev_free(buf);
    buf = nullptr;
    buf_bytes = 0;
    if (dev_malloc(&buf, bytes) != 0) return false;
    buf_bytes = round_up_pow2(bytes);
    return true;
  }

  bool reserve_host(size_t bytes) {
    if (bytes <= host_bytes) return true;
    pinned_free(host);
    host = nullptr;
    host_bytes = 0;
    if (pinned_malloc(&host, bytes, cudaHostAllocDefault) != 0) return false;
    host_bytes = round_up_pow2(bytes);
    return true;
  }
};

std::mutex g_pool_mu;
std::vector<Context*> g_idle;

// A context for the length of one call; back to the pool on return.
class Lease {
 public:
  explicit Lease(nvjpegHandle_t h) {
    if (h == nullptr) return;
    {
      std::lock_guard<std::mutex> lock(g_pool_mu);
      if (!g_idle.empty()) {
        ctx_ = g_idle.back();
        g_idle.pop_back();
      }
    }
    if (ctx_ == nullptr) {
      ctx_ = new Context();
      if (!ctx_->init(h)) {
        // a half-built context is leaked, not destroyed: destroying its
        // states could free device memory mid-run
        ctx_ = nullptr;
        return;
      }
    }
    t_stream = ctx_->stream;
  }
  ~Lease() {
    if (ctx_ == nullptr) return;
    t_stream = nullptr;
    std::lock_guard<std::mutex> lock(g_pool_mu);
    g_idle.push_back(ctx_);
  }
  Context* get() const { return ctx_; }

 private:
  Context* ctx_ = nullptr;
};

// Chroma samples per luma sample, (h, v), of a 3-component subsampling;
// false where nvJPEG cannot name it.
bool chroma_expansion(nvjpegChromaSubsampling_t css, int* h, int* v) {
  switch (css) {
    case NVJPEG_CSS_444: *h = 1; *v = 1; return true;
    case NVJPEG_CSS_422: *h = 2; *v = 1; return true;
    case NVJPEG_CSS_420: *h = 2; *v = 2; return true;
    case NVJPEG_CSS_440: *h = 1; *v = 2; return true;
    case NVJPEG_CSS_411: *h = 4; *v = 1; return true;
    case NVJPEG_CSS_410: *h = 4; *v = 2; return true;
    default: return false;
  }
}

}  // namespace

extern "C" {

// Parse the header only. Returns 0 and fills (*w, *h) on success, -1 on
// malformed data.
int jpg_dims(const unsigned char* data, long len, int* w, int* h) {
  nvjpegHandle_t hd = handle();
  if (hd == nullptr) return -3;
  int n = 0;
  nvjpegChromaSubsampling_t css;
  int widths[NVJPEG_MAX_COMPONENT], heights[NVJPEG_MAX_COMPONENT];
  if (nvjpegGetImageInfo(hd, data, static_cast<size_t>(len), &n, &css,
                         widths, heights) != NVJPEG_STATUS_SUCCESS) {
    return -1;
  }
  *w = widths[0];
  *h = heights[0];
  return 0;
}

// Full decode into the caller's host RGB buffer (h * w * 3 bytes). Returns
// 0 on success, -1 on malformed data, -2 if the buffer is too small, -3 on
// a CUDA or nvJPEG failure.
int jpg_decode_rgb(const unsigned char* data, long len, unsigned char* out,
                   long out_capacity, int* w, int* h) {
  nvjpegHandle_t hd = handle();
  Lease lease(hd);
  Context* c = lease.get();
  if (c == nullptr) return -3;
  int n = 0;
  nvjpegChromaSubsampling_t css;
  int widths[NVJPEG_MAX_COMPONENT], heights[NVJPEG_MAX_COMPONENT];
  if (nvjpegGetImageInfo(hd, data, static_cast<size_t>(len), &n, &css,
                         widths, heights) != NVJPEG_STATUS_SUCCESS) {
    return -1;
  }
  const int width = widths[0], height = heights[0];
  const size_t rgb_bytes = static_cast<size_t>(width) * height * 3;
  if (static_cast<long>(rgb_bytes) > out_capacity) return -2;
  int hx = 1, vx = 1;
  const bool planar = n == 1 || (n == 3 && chroma_expansion(css, &hx, &vx));
  nvjpegImage_t img;
  memset(&img, 0, sizeof(img));
  size_t offset[3] = {0, 0, 0};
  size_t bytes = rgb_bytes;
  if (planar) {
    bytes = 0;
    for (int k = 0; k < n; ++k) {
      offset[k] = bytes;
      bytes += static_cast<size_t>(widths[k]) * heights[k];
    }
    if (!c->reserve_host(bytes)) return -3;
  }
  if (!c->reserve(bytes)) return -3;
  unsigned char* dev = static_cast<unsigned char*>(c->buf);
  if (planar) {
    for (int k = 0; k < n; ++k) {
      img.channel[k] = dev + offset[k];
      img.pitch[k] = static_cast<size_t>(widths[k]);
    }
  } else {
    img.channel[0] = dev;
    img.pitch[0] = static_cast<size_t>(width) * 3;
  }
  const nvjpegOutputFormat_t format =
      !planar ? NVJPEG_OUTPUT_RGBI : (n == 1 ? NVJPEG_OUTPUT_Y
                                             : NVJPEG_OUTPUT_YUV);
  if (nvjpegDecode(hd, c->dec, data, static_cast<size_t>(len), format, &img,
                   c->stream) != NVJPEG_STATUS_SUCCESS) {
    cudaStreamSynchronize(c->stream);
    return -1;
  }
  void* dst = planar ? c->host : static_cast<void*>(out);
  if (cudaMemcpyAsync(dst, dev, bytes, cudaMemcpyDeviceToHost, c->stream) !=
      cudaSuccess) return -3;
  if (cudaStreamSynchronize(c->stream) != cudaSuccess) return -3;
  if (planar) {
    const unsigned char* host = static_cast<unsigned char*>(c->host);
    ycc::Plane planes[3];
    for (int k = 0; k < n; ++k) {
      planes[k] = {host + offset[k], static_cast<size_t>(widths[k]),
                   widths[k], heights[k], k == 0 ? 1 : hx, k == 0 ? 1 : vx};
    }
    ycc::planes_to_rgb(planes, n, width, height, out);
  }
  *w = width;
  *h = height;
  return 0;
}

// The size of a JPEG that decodes whole: jpeg_native.cpp's contract,
// through a full decode into a scratch buffer; refused (-1) wherever
// nvJPEG refuses the data.
int jpg_size(const unsigned char* data, long len, int* w, int* h) {
  int width = 0, height = 0;
  if (jpg_dims(data, len, &width, &height) != 0) return -1;
  std::vector<unsigned char> rgb(static_cast<size_t>(width) * height * 3);
  if (jpg_decode_rgb(data, len, rgb.data(), static_cast<long>(rgb.size()),
                     w, h) != 0)
    return -1;
  return 0;
}

// Baseline 4:2:0 encode of an (h, w, 3) RGB host image at `quality` into
// the caller's buffer. Returns 0 and the byte count in *out_len, -1 on an
// nvJPEG failure, -2 if the buffer is too small, -3 on a CUDA failure.
int jpg_encode_rgb(const unsigned char* rgb, int w, int h, int quality,
                   unsigned char* out, long out_capacity, long* out_len) {
  nvjpegHandle_t hd = handle();
  Lease lease(hd);
  Context* c = lease.get();
  if (c == nullptr) return -3;
  const size_t bytes = static_cast<size_t>(w) * h * 3;
  if (!c->reserve(bytes)) return -3;
  if (cudaMemcpyAsync(c->buf, rgb, bytes, cudaMemcpyHostToDevice,
                      c->stream) != cudaSuccess) return -3;
  if (nvjpegEncoderParamsSetQuality(c->params, quality, c->stream) !=
      NVJPEG_STATUS_SUCCESS) return -1;
  nvjpegImage_t img;
  memset(&img, 0, sizeof(img));
  img.channel[0] = static_cast<unsigned char*>(c->buf);
  img.pitch[0] = static_cast<size_t>(w) * 3;
  if (nvjpegEncodeImage(hd, c->enc, c->params, &img, NVJPEG_INPUT_RGBI, w, h,
                        c->stream) != NVJPEG_STATUS_SUCCESS) {
    cudaStreamSynchronize(c->stream);
    return -1;
  }
  size_t length = 0;
  if (nvjpegEncodeRetrieveBitstream(hd, c->enc, nullptr, &length,
                                    c->stream) != NVJPEG_STATUS_SUCCESS) {
    cudaStreamSynchronize(c->stream);
    return -1;
  }
  if (cudaStreamSynchronize(c->stream) != cudaSuccess) return -3;
  if (static_cast<long>(length) > out_capacity) return -2;
  if (nvjpegEncodeRetrieveBitstream(hd, c->enc, out, &length, c->stream) !=
      NVJPEG_STATUS_SUCCESS) {
    cudaStreamSynchronize(c->stream);
    return -1;
  }
  if (cudaStreamSynchronize(c->stream) != cudaSuccess) return -3;
  *out_len = static_cast<long>(length);
  return 0;
}

}  // extern "C"
