// Real int8 convolution of the int8-activation serving lane, for Hopper
// (sm_90a).
//
// Replaces the XLA path of retinanet_tpu/export/quantize.py:100
// (make_int8_conv_interceptor, real_int8=True): per-tensor int8 activations
// against per-output-channel int8 weights, lax.conv_general_dilated with
// preferred_element_type=int32 (:147), then float32 requantization plus
// bias. No Pallas kernel did this on the TPU (the MXU took s8 x s8 -> s32
// from XLA); stock PyTorch has no CUDA int8 convolution, so the port writes
// it.
//
// Same function as the plain PyTorch version
// retinanet_torch/ops/int8_conv.py:int8_conv2d_plain, bit for bit:
//   q   = clamp(rint(x / s_a), -127, 127)          per input element;
//   acc = sum over (kh, kw, c) of q * w, in int32   exact in any order;
//   y   = float(acc) * scale[o] (+ bias[o])         two roundings, then a
//                                                   cast to float32/bf16.
// Every step is an explicit _rn intrinsic (__fdiv_rn, __int2float_rn,
// __fmul_rn, __fadd_rn, __float2bfloat16_rn), so nvcc neither contracts the
// epilogue into an FMA nor rounds the quotient otherwise; the quantization
// multiplies by the reciprocal only where an error bound shows the same
// integer (`quantize`). The caller bounds kh * kw * C * 127^2 below 2^31.
//
// Layouts: x is NHWC (float32 or bfloat16), y is NHWC with O channels.
// Dense weights (groups 1) are packed once, when the lane is built, as
// (O, K_pad) int32 words: for each output channel its kh * kw taps in
// (row, column) order, each tap `c_tap` int8 channels (C rounded up to a
// multiple of 32 when C > 16, to a multiple of 4 otherwise), then zero
// words up to a multiple of 32 words (128 bytes). Channels past C and words
// past K are zero, which is exact: a zero weight adds nothing. Depthwise
// weights (groups = C = O) are (kh * kw, C) int8.
//
// Bound. The flagship's int8 convs do about 75 GMAC a 640^2 image: 0.08 ms
// at the 1,979 int8 TOPS of the tensor cores. Activations and weights are a
// few MB a conv, so at batch 8 the 102 convs of a request are bound by
// bytes in all (1.05 ms against 0.61 ms of operations, chip_smoke.py phase
// 12); the stem and the strided 1x1 projections, with few terms a sum,
// most of all. Only wgmma reaches the int8 tensor-core rate on Hopper
// (mma.sync gets well under half of it), and only TMA keeps the copies off
// the threads that issue the products. Quantizing once in a pass of its
// own adds a write and a read of the int8 input to those bytes (~0.5 ms a
// batch-8 request); fusing it into the previous layer is later work.
//
// Five designs, picked by the wrapper from the shape alone
// (ops/int8_conv_kernel.py:int8_design):
//   * "wgmma", every dense conv with C > 16: (1) a quantizing pass writes
//     the int8 input as (N, QH, QW, c_tap) bytes, each element quantized
//     once; for a strided 1x1 conv only the pixels the conv reads (the
//     subsampled input, then a plain GEMM operand); (2) a persistent,
//     warp-specialised implicit GEMM, one CTA an SM walking 128-pixel x
//     BN-channel tiles (BN 64, 128 or 256 from O), 384 threads: one
//     producer thread issues TMA copies into a ring of 3-8 stages guarded
//     by mbarriers, two consumer warpgroups (64 rows each, accumulators in
//     registers, setmaxnreg 232 against the producer's 40) issue
//     wgmma.mma_async m64nBNk32 s8 x s8 -> s32 from shared memory. A stage
//     is one filter tap x CH channels (CH 32, 64 or 128, the swizzle's
//     width): A through an im2col-mode tensor map over the int8 input (128
//     consecutive output pixels, across rows and images; the box's corners
//     carry the padding, TMA's out-of-bounds zero fill is the zero
//     padding, the traversal stride is the conv's stride), or a tiled map
//     for a 1x1 conv; B through a tiled map over the packed weights; the
//     descriptors match the swizzle. The epilogue requantizes 128 bytes of
//     each row at a time into one of two swizzled staging buffers and one
//     thread stores it by TMA, so that the stores run under the next
//     tile's products; the ring runs on across tiles. The GEMM is a
//     programmatic dependent launch: its prologue overlaps the pass's
//     tail;
//   * "mma_sync", dense convs with C < 4 (the stems, C = 3): the input is
//     quantized into (N, H, W, ceil(C / 4)) int32 words, then an implicit
//     GEMM with mma.sync m16n8k32: one CTA of 8 warps a 128 x 128 tile,
//     stages of 16 words (64 int8 terms) copied with cp.async two deep
//     (the gather zero-fills the padding), K-major rows padded against
//     bank conflicts. Its taps are 4 bytes: the wgmma design would copy 49
//     taps of 32-byte rows a stem tile, and runs the stem 3.3x slower
//     (tools/int8_conv_experiments.py); this one beats cuDNN bf16 there
//     (and "narrow" measured faster still; ROADMAP queues that routing);
//   * "narrow", dense convs with 4 <= C <= 16 (MobileDet's and
//     EfficientNet's 1x1 expansions and projections, their squeeze-excite
//     convs, MobileDet's 3x3 and 5x5 convs on 8 or 16 channels): the same
//     XLA path (quantize.py:100, the conv at :147). Bound by bytes: a few
//     terms a sum (at most 25 taps x 16 channels), so the operations are
//     1-2% of the bytes' time at 1,979 int8 TOPS; the largest, lite2's 1x1
//     256^2 x 16 -> 96 at batch 8, moves 117 MB (0.035 ms at 3.35 TB/s),
//     most of it the output. The mma_sync GEMM ran these at 2.4-2.9x
//     cuDNN bf16, for five reasons, each answered here: (1) two launches
//     and the int8 input written and read back: one launch, no scratch, the
//     input box quantized once into shared memory; (2) 128-channel B tiles
//     for O of 8-128: units of 32 channels, n-tiles of 8 up to O only; (3)
//     stages of 16 K words where a 1x1 conv has 2-4: K is the taps, two 16-
//     byte taps a k32 step, a 1x1 conv one step; (4) 4-byte cp.async
//     copies: the box comes by one TMA copy (16-byte rows; threads' loads
//     only where TMA cannot take the input, and on 1-pixel maps, where
//     encoding a tensor map costs more host time than the copy); (5) no
//     Hopper machinery: persistent CTAs sized by the occupancy calculator,
//     a ring of raw boxes on mbarriers, TMA stores from a swizzled staging
//     tile (two in turn), a programmatic dependent launch. A work item is a
//     tile of output pixels of one image, or, for a 1x1 conv at stride 1
//     without pads, a run of pixels across rows and images. The products
//     are mma.sync m16n8k32 s8 with A by ldmatrix from the quantized
//     pixels, each lane addressing its own output pixel's tap (the im2col
//     gather lives in the addresses): the tensor cores are far from the
//     bound here, and wgmma's 64-row tiles and shared-memory descriptors
//     would buy nothing on convs bound by bytes. A quantized pixel is 16
//     bytes (zeros past C) and the weights are widened to match as they are
//     loaded, so that an ldmatrix row is one tap at every C; the pixels of
//     a row are stored by column phase of the stride, so that consecutive
//     outputs read consecutive 16-byte rows on 32 banks at stride 2 too;
//   * "depthwise" (groups = C = O), square windows of 1, 3 or 5 at stride 1
//     or 2 with C % 8 == 0 and a 16-byte aligned input: a stencil, bound by
//     bytes (no sum crosses channels, so no tensor core helps). A work item
//     is a tile of output pixels of one image x a chunk of channels. A CTA
//     (persistent, 256 threads, a fixed chunk while the grid is a multiple
//     of the chunks) walks its items: one thread brings each item's input
//     box (the tile plus its halo) by a tiled 4-D TMA copy over the NHWC
//     input into a ring of raw boxes guarded by mbarriers, the box's
//     origin set by the conv's pads, so that TMA's out-of-bounds zero fill
//     is the zero padding (0 quantizes to 0); all threads quantize the box
//     once into int8 planes in shared memory, one plane a channel, four
//     pixels of a row a word (the product by 1 / s_a rounded by adding
//     1.5 * 2^23, no conversion instruction; the division only for the
//     elements within 3e-5 of a tie, 1e-4 to 2e-3 of a lane's bfloat16
//     inputs, each byte patched after the words are stored, so that the
//     rest of the warp runs on); a thread then keeps one channel's weights in
//     registers as dp4a words (built once a CTA) and takes 4 x 4 output
//     blocks, four taps of a window row in one __dp4a (the weight words
//     shifted to each output's place in the row, so that no input word is
//     shifted); the epilogue writes a staging tile that one thread stores
//     by TMA (which clips the tile at the plane's and the channels' edges).
//     The next item's copy runs under this item's products and stores. A
//     programmatic dependent launch: barriers and weights overlap the
//     previous kernel's tail;
//   * "depthwise_generic", every other depthwise conv (any window and
//     stride, C not a multiple of 8, an unaligned input): the same tile
//     and int8 planes, the box loaded and quantized by the threads' own
//     loads, the window taken in blocks of at most 16 x 16 taps (each
//     block's box quantized once, the sums kept in shared memory across
//     blocks), int32 multiply-adds, plain stores.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include <atomic>
#include <chrono>
#include <cmath>
#include <cstring>
#include <map>
#include <mutex>
#include <utility>

// One conv as the wrapper describes it (ops/int8_conv_kernel.py:_Args);
// outside the unnamed namespace, since the exported functions take it.
struct Int8ConvArgs {
  int n, h, w, c;        // input, NHWC
  int oh, ow, o;         // output
  int kh, kw, stride;    // window
  int pad_t, pad_l;      // padding before each axis (the rest is implied)
  int design;            // Design
  int k_pad;             // dense: int32 words of a packed weight row
  // wgmma: the quantized input (n, qh, qw, c_tap) int8, pixel (qy, qx)
  // from input pixel (qy, qx); for a strided 1x1 conv (sub > 1, and then a
  // 1x1 conv at stride 1 over q) from (qy * sub - pad_t, qx * sub - pad_l)
  int qh, qw, c_tap, sub;
  // wgmma: the conv over the quantized input: its stride and the im2col
  // box's corners (lower = -pad before, upper = pad after - (k - 1))
  int q_stride, lower_w, lower_h, upper_w, upper_h;
  int tile_n;            // wgmma: BN
  int chunk;             // wgmma: int8 channels a stage, 32, 64 or 128
  // depthwise (ops/int8_conv_kernel.py:depthwise_plan): a work item is
  // tile_h x tile_w output pixels x dw_chunk channels; its input box is
  // box_h x box_w pixels (a window block of taps_h x taps_w taps); the
  // quantized box is dw_chunk planes of box_h rows of row_pitch bytes,
  // plane_pitch bytes apart; shared memory: `stages` raw boxes from 0,
  // the planes at q_off, the staging tile (or the sums) at out_off, the
  // barriers at bar_off, smem bytes in all
  int tile_h, tile_w, dw_chunk, box_h, box_w, taps_h, taps_w;
  int row_pitch, plane_pitch, stages, q_off, out_off, bar_off, smem;
  // narrow (ops/int8_conv_kernel.py:narrow_plan), with the fields above: a
  // work item is tile_h x tile_w output pixels of one image (flat: a 1x1
  // conv at stride 1 without pads, whose n * h * w pixels are one row);
  // its box_h x box_w input pixels are quantized into 16-byte pixels, rows
  // of row_pitch bytes at q_off; the weights, widened to 16 bytes a tap,
  // o_pad rows of w_pitch bytes at w_off (k_steps k32 steps a row); scale
  // and bias at sb_off; the taps' byte offsets at tap_off; out_bufs
  // staging tiles at out_off, rows of o_box channels (one TMA store box);
  // the input by TMA into `stages` raw boxes (tma_in), the output by TMA
  // stores (tma_out), else by the threads
  int flat, w_off, w_pitch, sb_off, tap_off, k_steps, o_pad, o_box;
  int out_bufs, tma_in, tma_out;
  // (narrow also reads tile_n: output channels a warp's unit, 32, 64 or
  // 128)
};

namespace {

constexpr int kBM = 128;       // mma_sync: output pixels a CTA
constexpr int kBN = 128;       // mma_sync: output channels a CTA
constexpr int kBK = 16;        // mma_sync: 32-bit words of K a stage
constexpr int kPad = 4;        // mma_sync: words of padding a smem row
constexpr int kThreads = 256;  // mma_sync: 8 warps, 2 x 4, each 64 x 32
constexpr int kDwThreads = 256;  // depthwise: threads a CTA
constexpr int kDwBlock = 4;     // depthwise: a thread's block, 4 x 4 outputs
constexpr int kNarrowThreads = 256;  // narrow: threads a CTA, 8 warps
constexpr int kUnitM = 2;  // narrow: m16 fragments of a warp's unit
constexpr int kQuantThreads = 256;

constexpr int kTileM = 128;        // wgmma: output pixels a tile
constexpr int kConsumers = 256;    // wgmma: two consumer warpgroups
constexpr int kWgThreads = 384;    // ... and one producer warpgroup
constexpr int kSmemLimit = 232448; // a block's shared memory on sm_90
constexpr int kMaxDevices = 64;    // devices a process may launch on

// wgmma design: the epilogue stages a tile's outputs 128 bytes of each
// row at a time, in two buffers of 128 rows in the 128-byte swizzle
constexpr int kOutBuf = kTileM * 128;
constexpr int kStageOut = 2 * kOutBuf;
// ... and reads the scale and bias of a tile's channels from shared memory
constexpr int kSb = 2 * 256 * 4;

// a tile of 128 pixels x BN channels, stages of CH channels: as many
// stages of the ring as the rest of shared memory holds, up to 8
template <int BN, int CH>
struct WgTile {
  static constexpr int kABytes = kTileM * CH;
  static constexpr int kBBytes = BN * CH;
  static constexpr int kFree = kSmemLimit - 1024 - 256 - kStageOut - kSb;
  static constexpr int kStages =
      kFree / (kABytes + kBBytes) < 8 ? kFree / (kABytes + kBBytes) : 8;
  static constexpr int kRing = kStages * (kABytes + kBBytes);
  static constexpr int kSmem =
      kRing + kStageOut + kSb + 2 * kStages * 8 + 1024;
  static_assert(kStages >= 3, "the ring holds at least three stages");
};

enum Design {
  kDepthwise = 0,
  kMmaSync = 1,
  kWgmma = 2,
  kDepthwiseGeneric = 3,
  kNarrow = 4
};

// What the wgmma kernel reads of Int8ConvArgs.
struct WgShape {
  long long m;           // output pixels, n * oh * ow
  int oh, ow, o;
  int kw, taps, chunks, c_tap;
  int q_stride, lower_w, lower_h;
  int gemm;              // A by a tiled map over q as (m, c_tap): a 1x1 conv
  int tma_store;         // y stored by TMA: O's rows are 16-byte aligned
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
// two neighbours in one store; `p` aligned to two elements
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// The activation's scale s_a, and inv = 1 / s_a rounded to float (NaN
// where s_a or inv is not a normal float).
struct Scale {
  float s, inv;
};

// clamp(rint(v / s_a), -127, 127) as an int, rint rounding half to even as
// torch.round and jnp.round do; bit for bit what __fdiv_rn gives, with
// fewer divisions. t = v * inv lies within 3 * 2^-24 |v / s_a| of the
// correctly rounded quotient d: below 128, within 2.5e-5. So where t is
// under 128 and more than 1e-4 from a half-integer, rint(d) = rint(t).
// Anywhere else (near a tie, clipped, NaN) the division decides.
__device__ __forceinline__ int quantize(float v, Scale sc) {
  const float t = __fmul_rn(v, sc.inv);
  const float r = rintf(t);
  const float q = fabsf(t) < 128.0f && fabsf(t - r) < 0.4999f
                      ? r
                      : rintf(__fdiv_rn(v, sc.s));
  return static_cast<int>(fminf(fmaxf(q, -127.0f), 127.0f));
}

__device__ __forceinline__ int pack4(int q0, int q1, int q2, int q3) {
  return (q0 & 0xff) | ((q1 & 0xff) << 8) | ((q2 & 0xff) << 16) |
         (static_cast<unsigned>(q3) << 24);
}

// Four consecutive channels from `p`, quantized and packed; channels at or
// past `left` are zero. VEC: `left` >= 4 and `p` aligned to four elements.
template <bool VEC>
__device__ __forceinline__ int load_word(const float* p, int left,
                                         Scale sc) {
  if constexpr (VEC) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    return pack4(quantize(v.x, sc), quantize(v.y, sc), quantize(v.z, sc),
                 quantize(v.w, sc));
  } else {
    int q[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) q[j] = j < left ? quantize(p[j], sc) : 0;
    return pack4(q[0], q[1], q[2], q[3]);
  }
}

template <bool VEC>
__device__ __forceinline__ int load_word(const __nv_bfloat16* p, int left,
                                         Scale sc) {
  if constexpr (VEC) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
    return pack4(quantize(__low2float(lo), sc),
                 quantize(__high2float(lo), sc),
                 quantize(__low2float(hi), sc),
                 quantize(__high2float(hi), sc));
  } else {
    int q[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      q[j] = j < left ? quantize(__bfloat162float(p[j]), sc) : 0;
    }
    return pack4(q[0], q[1], q[2], q[3]);
  }
}

// Sixteen consecutive channels from `p` as 16 int8 bytes; channels at or
// past `left` are zero. VEC: `left` >= 16 and `p` aligned to 16 bytes.
template <bool VEC>
__device__ __forceinline__ int4 load_vec16(const float* p, int left,
                                           Scale sc) {
  return make_int4(load_word<VEC>(p, left, sc),
                   load_word<VEC>(p + 4, left - 4, sc),
                   load_word<VEC>(p + 8, left - 8, sc),
                   load_word<VEC>(p + 12, left - 12, sc));
}

template <bool VEC>
__device__ __forceinline__ int4 load_vec16(const __nv_bfloat16* p, int left,
                                           Scale sc) {
  if constexpr (VEC) {
    int w[4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // two 16-byte loads of 8 channels
      const uint4 raw = reinterpret_cast<const uint4*>(p)[i];
      const unsigned part[4] = {raw.x, raw.y, raw.z, raw.w};
      float f[8];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const __nv_bfloat162 two =
            *reinterpret_cast<const __nv_bfloat162*>(&part[e]);
        f[2 * e] = __low2float(two);
        f[2 * e + 1] = __high2float(two);
      }
      w[2 * i] = pack4(quantize(f[0], sc), quantize(f[1], sc),
                       quantize(f[2], sc), quantize(f[3], sc));
      w[2 * i + 1] = pack4(quantize(f[4], sc), quantize(f[5], sc),
                           quantize(f[6], sc), quantize(f[7], sc));
    }
    return make_int4(w[0], w[1], w[2], w[3]);
  } else {
    return make_int4(load_word<false>(p, left, sc),
                     load_word<false>(p + 4, left - 4, sc),
                     load_word<false>(p + 8, left - 8, sc),
                     load_word<false>(p + 12, left - 12, sc));
  }
}

// One m16n8k32 int8 tensor-core product, accumulated in int32 (exact: the
// caller bounds every sum below 2^31).
__device__ __forceinline__ void mma_s8(int (&c)[4], const int (&a)[4],
                                       int b0, int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x (NHWC) -> q: (N, H, W, ceil(C / 4)) int32 words, four quantized
// channels a word, the channels past C zero. VEC: C % 4 == 0 and x aligned
// to four elements. The caller keeps `words` below 2^31.
template <typename TIn, bool VEC>
__global__ void __launch_bounds__(kQuantThreads)
    quantize_words_kernel(const TIn* __restrict__ x, int* __restrict__ q,
                          Scale sc, unsigned words, int c, unsigned cw) {
  for (unsigned idx = blockIdx.x * blockDim.x + threadIdx.x; idx < words;
       idx += gridDim.x * blockDim.x) {
    const unsigned pixel = idx / cw;
    const int ch = static_cast<int>(idx - pixel * cw) * 4;
    q[idx] = load_word<VEC>(x + static_cast<size_t>(pixel) * c + ch, c - ch,
                            sc);
  }
}

__device__ __forceinline__ unsigned smem_address(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// four 8x8 matrices of 16-byte rows from shared memory, lanes 8q..8q+7
// giving the row addresses of matrix q; register q holds row lane / 4,
// bytes 4 (lane % 4) .. +3 of matrix q
__device__ __forceinline__ void ldmatrix_x4(int (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_address(p)));
}

// cp.async of 16 (or 4) bytes; `bytes_read` 0 fills the destination with
// zeros and reads nothing
__device__ __forceinline__ void copy16(void* dst, const void* src,
                                       bool read) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_address(dst)),
               "l"(src), "r"(read ? 16 : 0));
}

__device__ __forceinline__ void copy4(void* dst, const void* src, bool read) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_address(dst)),
               "l"(src), "r"(read ? 4 : 0));
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Implicit GEMM over the quantized words `q`: A (pixels x K words) is
// gathered from the input windows, B (channels x K words) is the packed
// weights. Stages of kBK words are copied into shared memory with cp.async
// two deep, so that the next stage's copies run under this stage's MMAs,
// A one 4-byte copy a word (a tap is ceil(C / 4) <= 4 words).
template <typename TOut>
__global__ void __launch_bounds__(kThreads)
    int8_conv_gemm_kernel(const int* __restrict__ q,
                          const int* __restrict__ w,
                          const float* __restrict__ scale,
                          const float* __restrict__ bias,
                          TOut* __restrict__ y, Int8ConvArgs s, int k_pad) {
  // K-major tiles, each row padded by kPad words: the fragment loads of a
  // warp (8 rows x 4 words) then fall on 32 different banks
  __shared__ __align__(16) int a_tile[2][kBM][kBK + kPad];
  __shared__ __align__(16) int b_tile[2][kBN][kBK + kPad];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;       // the fragments' row group
  const int t = lane & 3;        // the thread in the group
  const int warp_m = (warp & 1) * (kBM / 2);
  const int warp_n = (warp >> 1) * (kBN / 4);
  const int m0 = blockIdx.x * kBM;
  const int o0 = blockIdx.y * kBN;
  const int pixels = s.oh * s.ow;
  const long long m_total = static_cast<long long>(s.n) * pixels;
  const int cw = (s.c + 3) >> 2;
  const int k_words = s.kh * s.kw * cw;

  // copies: this thread's row of both tiles, words [half, half + 8) of a
  // stage
  const int row = tid >> 1;
  const int half = (tid & 1) * 8;
  const long long m_load = m0 + row;
  const bool m_ok = m_load < m_total;
  int ih0 = 0, iw0 = 0;
  const int* q_img = q;
  if (m_ok) {
    const int img = static_cast<int>(m_load / pixels);
    const int rem = static_cast<int>(m_load - static_cast<long long>(img) *
                                                  pixels);
    ih0 = (rem / s.ow) * s.stride - s.pad_t;
    iw0 = (rem % s.ow) * s.stride - s.pad_l;
    q_img = q + static_cast<long long>(img) * s.h * s.w * cw;
  }
  const bool o_ok = o0 + row < s.o;
  const int* w_row = o_ok ? w + static_cast<long long>(o0 + row) * k_pad + half
                          : w;

  auto copy_stage = [&](int buf, int k0) {
    int* a_dst = &a_tile[buf][row][half];
    const int k = k0 + half;
    int cwi = k % cw;
    int tap = k / cw;
    int tr = tap / s.kw;
    int tc = tap - tr * s.kw;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int ih = ih0 + tr;
      const int iw = iw0 + tc;
      const bool read = m_ok && k + j < k_words && ih >= 0 && ih < s.h &&
                        iw >= 0 && iw < s.w;
      copy4(a_dst + j,
            read ? q_img + (static_cast<long long>(ih) * s.w + iw) * cw +
                       cwi
                 : q,
            read);
      if (++cwi == cw) {
        cwi = 0;
        if (++tc == s.kw) {
          tc = 0;
          ++tr;
        }
      }
    }
    int* b_dst = &b_tile[buf][row][half];
    copy16(b_dst, w_row + (o_ok ? k0 : 0), o_ok);
    copy16(b_dst + 4, w_row + (o_ok ? k0 + 4 : 0), o_ok);
    copy_commit();
  };

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;
    }
  }

  // the stages that hold some of the K words (the packed rows run on to a
  // multiple of 32 words for the wgmma design's stages)
  const int k_loop = (k_words + kBK - 1) / kBK * kBK;
  copy_stage(0, 0);
  int buf = 0;
  for (int k0 = 0; k0 < k_loop; k0 += kBK) {
    if (k0 + kBK < k_loop) {
      copy_stage(buf ^ 1, k0 + kBK);
      copy_wait<1>();
    } else {
      copy_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 8) {  // two k32 steps a stage
      // ldmatrix.x4: lanes 8q..8q+7 address the rows of 8x8 matrix q. A:
      // matrices (rows 0-7 | 8-15) x (words 0-3 | 4-7) of a 16-row tile,
      // which are a0..a3; B: (words 0-3 | 4-7) x (tile 2p | 2p+1), which
      // are b0, b1 of two 8-channel tiles
      int a[4][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ldmatrix_x4(a[i], &a_tile[buf][warp_m + i * 16 + (lane & 15)]
                                  [kk + (lane >> 4) * 4]);
      }
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        int r[4];
        ldmatrix_x4(r, &b_tile[buf][warp_n + p * 16 + (lane & 7)
                                    + (lane >> 4) * 8]
                                   [kk + ((lane >> 3) & 1) * 4]);
        b[2 * p][0] = r[0];
        b[2 * p][1] = r[1];
        b[2 * p + 1][0] = r[2];
        b[2 * p + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a[i], b[j][0], b[j][1]);
      }
    }
    __syncthreads();  // the next copy into this buffer waits for the MMAs
    buf ^= 1;
  }

  // epilogue: (row g, channels 2t, 2t+1) and row g + 8 of each fragment;
  // the two channels in one store where both exist and O is even
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int o = o0 + warp_n + j * 8 + 2 * t;
    if (o >= s.o) continue;
    const bool pair = o + 1 < s.o && (s.o & 1) == 0;
    float sc[2], bi[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int oe = o + e < s.o ? o + e : o;
      sc[e] = scale[oe];
      bi[e] = bias != nullptr ? bias[oe] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long m = m0 + warp_m + i * 16 + g + 8 * h;
        if (m >= m_total) continue;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          v[e] = __fmul_rn(__int2float_rn(acc[i][j][2 * h + e]), sc[e]);
          if (bias != nullptr) v[e] = __fadd_rn(v[e], bi[e]);
        }
        TOut* dst = y + m * s.o + o;
        if (pair) {
          store2(dst, v[0], v[1]);
        } else {
          store(dst, v[0]);
          if (o + 1 < s.o) store(dst + 1, v[1]);
        }
      }
    }
  }
}

// -- the wgmma design ---------------------------------------------------------

// x (NHWC) -> q: (N, QH, QW, c_tap) int8, 16 channels a thread, the
// channels past C zero. Pixel (qy, qx) of q is input pixel (qy, qx), or
// (qy * sub - pad_t, qx * sub - pad_l) for a strided 1x1 conv (sub > 1),
// zero outside the input. VEC: C % 16 == 0 and x aligned to 16 bytes. The
// caller keeps `vecs` below 2^31.
template <typename TIn, bool VEC>
__global__ void __launch_bounds__(kQuantThreads)
    quantize_bytes_kernel(const TIn* __restrict__ x, int4* __restrict__ q,
                          Scale sc, unsigned vecs, Int8ConvArgs a) {
  const unsigned per_pixel = a.c_tap / 16;
  // q is x quantized, element for element
  const bool same = a.sub == 1 && a.c == a.c_tap;
  for (unsigned idx = blockIdx.x * blockDim.x + threadIdx.x; idx < vecs;
       idx += gridDim.x * blockDim.x) {
    int4 v = make_int4(0, 0, 0, 0);
    if (same) {
      v = load_vec16<VEC>(x + 16 * static_cast<size_t>(idx), 16, sc);
    } else {
      const unsigned pixel = idx / per_pixel;
      const int ch = static_cast<int>(idx - pixel * per_pixel) * 16;
      const unsigned rest = pixel / a.qw;
      const int qx = static_cast<int>(pixel - rest * a.qw);
      const unsigned img = rest / a.qh;
      const int qy = static_cast<int>(rest - img * a.qh);
      const int ih = a.sub > 1 ? qy * a.sub - a.pad_t : qy;
      const int iw = a.sub > 1 ? qx * a.sub - a.pad_l : qx;
      if (ih >= 0 && ih < a.h && iw >= 0 && iw < a.w && ch < a.c) {
        v = load_vec16<VEC>(
            x + ((static_cast<size_t>(img) * a.h + ih) * a.w + iw) * a.c +
                ch,
            a.c - ch, sc);
      }
    }
    q[idx] = v;
  }
  // the GEMM that reads q may start its prologue now (it waits for this
  // grid's memory before its first copy)
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_address(bar)),
               "r"(count)
               : "memory");
}

// arrive and add `bytes` to the transactions this phase waits for
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_address(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_address(bar))
               : "memory");
}

// until the phase of parity `parity` has completed (a fresh barrier counts
// the phase before its first, of parity 1, as completed)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned addr = smem_address(bar);
  unsigned done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA: one box of the im2col map, 128 pixels from (w, h, n) in the
// traversal order, each shifted by the tap (off_w, off_h), channels
// [c, c + 128), into `dst`; completes `bar`'s transactions
__device__ __forceinline__ void tma_load_im2col(void* dst,
                                                const CUtensorMap* map,
                                                uint64_t* bar, int c, int w,
                                                int h, int n,
                                                unsigned short off_w,
                                                unsigned short off_h) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.im2col.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2], {%7, %8};\n" ::
          "r"(smem_address(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_address(bar)), "r"(c),
      "r"(w), "r"(h), "r"(n), "h"(off_w), "h"(off_h)
      : "memory");
}

// TMA: one box of a tiled 2-D map at (x0, x1), innermost first
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int x0, int x1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_address(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_address(bar)), "r"(x0),
      "r"(x1)
      : "memory");
}

// TMA: a box of shared memory to the tiled 2-D map at (x0, x1); the
// elements past the map's edges are not written
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             const void* src, int x0,
                                             int x1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, "
      "%3}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_address(src)), "r"(x0), "r"(x1)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// until at most N bulk stores are still reading shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// byte b of row r of a 128-byte-swizzled box (1024-byte aligned)
__device__ __forceinline__ int sw128(int r, int b) {
  return r * 128 + ((((b >> 4) ^ r) & 7) << 4) + (b & 15);
}

// The wgmma descriptor of a K-major tile of CH-byte rows in the CH-byte
// swizzle that TMA wrote (CH 128, 64 or 32): start address, stride between
// 8-row groups 8 CH bytes, layout 1, 2 or 3 (128B, 64B, 32B swizzle). The
// leading offset is unused for a swizzled K-major tile. Adding 2 steps 32
// bytes (one k32 step) along K.
template <int CH>
__device__ __forceinline__ uint64_t swizzled_desc(const void* tile) {
  static_assert(CH == 128 || CH == 64 || CH == 32, "a swizzle's width");
  constexpr uint64_t layout = CH == 128 ? 1 : CH == 64 ? 2 : 3;
  const uint64_t addr = smem_address(tile);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) |
         (uint64_t(8 * CH >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving the accumulators across a wgmma fence or
// wait
template <int R>
__device__ __forceinline__ void fence_accumulators(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define WG_D8(i)                                                        \
  "+r"(d[(i) + 0]), "+r"(d[(i) + 1]), "+r"(d[(i) + 2]), "+r"(d[(i) + 3]), \
      "+r"(d[(i) + 4]), "+r"(d[(i) + 5]), "+r"(d[(i) + 6]), "+r"(d[(i) + 7])

// wgmma.mma_async m64nBNk32, s8 x s8 -> s32, both operands K-major in
// shared memory, accumulating into d (scale-d 1). Thread t of the
// warpgroup holds rows 16 (t / 32) + (t % 32) / 4 (+ 8) and columns 8 j +
// 2 (t % 4) (+ 1): d[4 j + 2 h + e] is (row + 8 h, column + e).
template <int BN>
struct Wgmma;

template <>
struct Wgmma<64> {
  // d: this thread's 32 int32 accumulators of the 64 x 64 tile
  static __device__ __forceinline__ void mma(int (&d)[32], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p;\n}\n"
        : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24)
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  // d: this thread's 64 int32 accumulators of the 64 x 128 tile
  static __device__ __forceinline__ void mma(int (&d)[64], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p;\n}\n"
        : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24),
          WG_D8(32), WG_D8(40), WG_D8(48), WG_D8(56)
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<256> {
  // d: this thread's 128 int32 accumulators of the 64 x 256 tile
  static __device__ __forceinline__ void mma(int (&d)[128], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, "
        "%104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p;\n}\n"
        : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24),
          WG_D8(32), WG_D8(40), WG_D8(48), WG_D8(56),
          WG_D8(64), WG_D8(72), WG_D8(80), WG_D8(88),
          WG_D8(96), WG_D8(104), WG_D8(112), WG_D8(120)
        : "l"(a), "l"(b), "r"(1));
  }
};

#undef WG_D8

// The implicit GEMM of the wgmma design, persistent: CTA b takes tiles b,
// b + gridDim.x, ... of the (M / 128) x (O / BN) tiles, M first. Tile t:
// the 128 output pixels from m0 = 128 (t % m_tiles) (in (n, oh, ow) order,
// across rows and images) by the BN channels from o0 = BN (t / m_tiles).
// K runs over (tap, CH-channel chunk) stages; TMA zero-fills A past
// c_tap, so that the weights of the next tap that B brings there add
// nothing. The ring runs on across tiles, so that the producer loads the
// next tile's stages while the consumers requantize and store this one.
template <int BN, int CH, typename TOut>
__global__ void __launch_bounds__(kWgThreads, 1)
    int8_conv_wgmma_kernel(const __grid_constant__ CUtensorMap a_map,
                           const __grid_constant__ CUtensorMap b_map,
                           const __grid_constant__ CUtensorMap y_map,
                           const float* __restrict__ scale,
                           const float* __restrict__ bias,
                           TOut* __restrict__ y, WgShape s) {
  using Tile = WgTile<BN, CH>;
  constexpr int kStages = Tile::kStages;
  extern __shared__ uint8_t smem_raw[];
  // the swizzle repeats every 1024 bytes of the shared address: align
  uint8_t* smem = smem_raw + ((1024 - (smem_address(smem_raw) & 1023)) & 1023);
  uint8_t* a_ring = smem;
  uint8_t* b_ring = smem + kStages * Tile::kABytes;
  uint8_t* out = smem + Tile::kRing;
  float* sb = reinterpret_cast<float*>(out + kStageOut);  // scale, bias
  uint64_t* full = reinterpret_cast<uint64_t*>(out + kStageOut + kSb);
  uint64_t* empty = full + kStages;

  const int tid = threadIdx.x;
  const int k_iters = s.taps * s.chunks;
  const int m_tiles = static_cast<int>((s.m + kTileM - 1) / kTileM);
  const int tiles = m_tiles * ((s.o + BN - 1) / BN);
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);                // the producer's expect_tx
      mbar_init(&empty[i], kConsumers / 32); // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // producer warpgroup: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == kConsumers) {
      // q is the quantizing pass's output: wait for that grid (launched
      // before this one, which may start early) to finish and flush
      asm volatile("griddepcontrol.wait;\n" ::: "memory");
      const int pixels = s.oh * s.ow;
      int it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const long long m0 = static_cast<long long>(t % m_tiles) * kTileM;
        const int o0 = (t / m_tiles) * BN;
        const int n0 = static_cast<int>(m0 / pixels);
        const int rem = static_cast<int>(m0 - static_cast<long long>(n0) *
                                                  pixels);
        // the first pixel's window origin: lower corner + output position
        // x stride (tests/test_torch_int8_design.py models it)
        const int w0 = s.lower_w + (rem % s.ow) * s.q_stride;
        const int h0 = s.lower_h + (rem / s.ow) * s.q_stride;
        for (int k = 0; k < k_iters; ++k, ++it) {
          const int st = it % kStages;
          mbar_wait(&empty[st], ((it / kStages) & 1) ^ 1);
          mbar_expect_tx(&full[st], Tile::kABytes + Tile::kBBytes);
          const int tap = k / s.chunks;
          const int ci = k - tap * s.chunks;
          uint8_t* a_dst = a_ring + st * Tile::kABytes;
          if (s.gemm) {
            tma_load_2d(a_dst, &a_map, &full[st], ci * CH,
                        static_cast<int>(m0));
          } else {
            tma_load_im2col(a_dst, &a_map, &full[st], ci * CH, w0, h0,
                            n0, static_cast<unsigned short>(tap % s.kw),
                            static_cast<unsigned short>(tap / s.kw));
          }
          tma_load_2d(b_ring + st * Tile::kBBytes, &b_map, &full[st],
                      tap * s.c_tap + ci * CH, o0);
        }
      }
    }
    return;
  }

  // consumer warpgroups: rows [64 wg, 64 wg + 64) of each tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wg = tid / 128;
  const int warp = (tid / 32) % 4;
  const int lane = tid % 32;
  int it = 0;
  int ep = 0;  // epilogue parts so far: the staging buffer's parity
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long m0 = static_cast<long long>(t % m_tiles) * kTileM;
    const int o0 = (t / m_tiles) * BN;
    // this tile's scale and bias, a channel a thread, for the epilogue
    // (loaded now, to arrive under the products)
    float sc_t = 0.0f, bi_t = 0.0f;
    if (tid < BN && o0 + tid < s.o) {
      sc_t = scale[o0 + tid];
      if (bias != nullptr) bi_t = bias[o0 + tid];
    }
    int acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    for (int k = 0; k < k_iters; ++k, ++it) {
      const int st = it % kStages;
      mbar_wait(&full[st], (it / kStages) & 1);
      const uint64_t da =
          swizzled_desc<CH>(a_ring + st * Tile::kABytes + wg * 64 * CH);
      const uint64_t db = swizzled_desc<CH>(b_ring + st * Tile::kBBytes);
      fence_accumulators(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < CH / 32; ++kk) {
        Wgmma<BN>::mma(acc, da + 2 * kk, db + 2 * kk);
      }
      wgmma_commit();
      // this stage's products run on; the previous stage's are done
      wgmma_wait<1>();
      fence_accumulators(acc);
      if (k > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % kStages]);
    }
    wgmma_wait<0>();
    fence_accumulators(acc);
    if (lane == 0) mbar_arrive(&empty[(it - 1) % kStages]);

    // epilogue, 128 bytes of each row at a time: requantize into a
    // staging buffer (once the store that last read it is done), then one
    // thread stores it to y (row m has O channels) by TMA, which runs on
    // under the next part and the next tile's products. Where O's rows are
    // not 16-byte aligned, every consumer copies it, an element a thread.
    constexpr int kCols = 128 / static_cast<int>(sizeof(TOut));
    const int r0 = wg * 64 + warp * 16 + lane / 4;
    // the last tile's epilogue read sb before its last barrier
    if (tid < BN) {
      sb[tid] = sc_t;
      sb[BN + tid] = bi_t;
    }
#pragma unroll
    for (int part = 0; part < BN / kCols; ++part, ++ep) {
      uint8_t* buf = out + (ep & 1) * kOutBuf;
      if (tid == 0) bulk_wait_read<1>();
      asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
#pragma unroll
      for (int jj = 0; jj < kCols / 8; ++jj) {
        const int j = part * (kCols / 8) + jj;
        const int col = 8 * jj + 2 * (lane % 4);
        const float2 sc =
            *reinterpret_cast<const float2*>(sb + part * kCols + col);
        const float2 bi =
            *reinterpret_cast<const float2*>(sb + BN + part * kCols + col);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v0 = __fmul_rn(__int2float_rn(acc[4 * j + 2 * h]), sc.x);
          float v1 = __fmul_rn(__int2float_rn(acc[4 * j + 2 * h + 1]), sc.y);
          if (bias != nullptr) {
            v0 = __fadd_rn(v0, bi.x);
            v1 = __fadd_rn(v1, bi.y);
          }
          const int r = r0 + 8 * h;
          store2(reinterpret_cast<TOut*>(
                     buf + sw128(r, col * static_cast<int>(sizeof(TOut)))),
                 v0, v1);
        }
      }
      // the async proxy (TMA) reads what the threads wrote
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
      const int c0 = o0 + part * kCols;
      if (s.tma_store) {
        if (tid == 0) tma_store_2d(&y_map, buf, c0, static_cast<int>(m0));
      } else if (c0 < s.o) {
        const int rows = static_cast<int>(
            min(static_cast<long long>(kTileM), s.m - m0));
        const int cols = min(kCols, s.o - c0);
        TOut* y0 = y + m0 * s.o + c0;
        for (int idx = tid; idx < rows * kCols; idx += kConsumers) {
          const int r = idx / kCols;
          const int cidx = idx % kCols;
          if (cidx < cols) {
            y0[static_cast<long long>(r) * s.o + cidx] =
                *reinterpret_cast<const TOut*>(
                    buf + sw128(r, cidx * static_cast<int>(sizeof(TOut))));
          }
        }
      }
    }
  }
  if (tid == 0) bulk_wait_read<0>();  // shared memory outlives the stores
}

// -- the depthwise designs ---------------------------------------------------

// What the depthwise kernels read of Int8ConvArgs.
struct DwShape {
  int n, h, w, c, oh, ow;
  int kh, kw, stride, pad_t, pad_l;
  int tile_h, tile_w, chunk, box_h, box_w, taps_h, taps_w;
  int row_pitch, plane_pitch, stages, q_off, out_off, bar_off;
  int tiles_y, tiles_x, chunks, items;
};

// One work item: image n, output tile (ty, tx), channel chunk ci.
struct DwItem {
  int n, ty, tx, ci;
};

__device__ __forceinline__ DwItem dw_item(const DwShape& s, int item) {
  DwItem d;
  d.ci = item % s.chunks;
  int rest = item / s.chunks;
  d.tx = rest % s.tiles_x;
  rest /= s.tiles_x;
  d.ty = rest % s.tiles_y;
  d.n = rest / s.tiles_y;
  return d;
}

// quantize(v, sc) into the low byte of `byte`, without a conversion
// instruction or a branch; false where only the division can decide. t is
// clamped before the rounding (the same integer: rint is monotonic and the
// bounds are integers), and tc + 1.5 * 2^23 rounds tc to an integer half
// to even in the low bits of the sum: 0x4B400000 + rint(tc), whose low
// byte is the int8. t = v * inv lies within 3 * 2^-24 |v / s_a| of the
// rounded quotient: below 128, within 2.29e-5. So no doubt arises where
// |t| >= 128 (both clip) or where t is more than 3e-5 from a
// half-integer; elsewhere, and on NaN, it does.
__device__ __forceinline__ bool quantize_sure(float v, Scale sc,
                                              unsigned& byte) {
  const float t = __fmul_rn(v, sc.inv);
  const float tc = fminf(fmaxf(t, -127.0f), 127.0f);
  const float m = __fadd_rn(tc, 12582912.0f);
  const float r = __fsub_rn(m, 12582912.0f);
  byte = __float_as_uint(m);
  return fabsf(t) >= 128.0f || fabsf(__fsub_rn(t, r)) < 0.49997f;
}

// The 16-byte group of TIn values `raw16` as floats
__device__ __forceinline__ void unpack16(const uint4& raw16, float* f,
                                         const float*) {
  f[0] = __uint_as_float(raw16.x);
  f[1] = __uint_as_float(raw16.y);
  f[2] = __uint_as_float(raw16.z);
  f[3] = __uint_as_float(raw16.w);
}
__device__ __forceinline__ void unpack16(const uint4& raw16, float* f,
                                         const __nv_bfloat16*) {
  const unsigned part[4] = {raw16.x, raw16.y, raw16.z, raw16.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    // a bfloat16 is the high half of its float
    f[2 * e] = __uint_as_float(part[e] << 16);
    f[2 * e + 1] = __uint_as_float(part[e] & 0xFFFF0000u);
  }
}

// the low bytes of four words, in order, as one word
__device__ __forceinline__ unsigned pack_low_bytes(unsigned b0, unsigned b1,
                                                   unsigned b2, unsigned b3) {
  return __byte_perm(__byte_perm(b0, b1, 0x0040), __byte_perm(b2, b3, 0x0040),
                     0x5410);
}

// float(acc) for |acc| < 2^22, exact, without a conversion instruction
__device__ __forceinline__ float exact_float(int acc) {
  return __fsub_rn(__int_as_float(0x4B400000 + acc), 12582912.0f);
}

// TMA: the box of a tiled 4-D map at (c, x, y, n) into `dst`; completes
// `bar`'s transactions. Coordinates outside the tensor read zeros.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c, int x,
                                            int y, int n) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_address(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_address(bar)), "r"(c),
      "r"(x), "r"(y), "r"(n)
      : "memory");
}

// TMA: a box of shared memory to the tiled 4-D map at (c, x, y, n); the
// elements past the map's edges are not written
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             const void* src, int c, int x,
                                             int y, int n) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, "
      "%4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_address(src)), "r"(c), "r"(x), "r"(y), "r"(n)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// The input box of `item` (the tile's window origins, minus the pads, with
// the halo) into `dst` by TMA; `bar` expects its bytes.
template <typename TIn>
__device__ __forceinline__ void dw_load_box(const CUtensorMap* x_map,
                                            uint8_t* dst, uint64_t* bar,
                                            const DwShape& s, int item) {
  const DwItem d = dw_item(s, item);
  mbar_expect_tx(bar, static_cast<unsigned>(s.box_h * s.box_w * s.chunk *
                                            static_cast<int>(sizeof(TIn))));
  tma_load_4d(dst, x_map, bar, d.ci * s.chunk,
              d.tx * s.tile_w * s.stride - s.pad_l,
              d.ty * s.tile_h * s.stride - s.pad_t, d.n);
}

// Does word k of a block's input row (bytes 4k .. 4k + 3 from the block's
// first column) hold a tap of output i (bytes S i .. S i + K - 1)?
template <int K, int S>
__host__ __device__ constexpr bool dw_overlaps(int i, int k) {
  return 4 * k <= S * i + K - 1 && 4 * k + 3 >= S * i;
}

// One raw box (box_h x box_w pixels x chunk channels of TIn, as TMA wrote
// it) -> the int8 planes q[c][y][x], each element quantized once. A unit is
// four pixels of a row x one 16-byte group of channels: four 16-byte
// loads, then one word a channel (four pixels) into its plane.
template <typename TIn>
__device__ __forceinline__ void dw_quantize_box(const TIn* raw, uint8_t* q,
                                                const DwShape& s, Scale sc) {
  constexpr int kV = 16 / static_cast<int>(sizeof(TIn));
  // unit u: channel group u % groups (a power of two) of pixel group
  // p = u / groups, row p / x4s (by a multiply-high: p < 2^14, x4s <= 64)
  const int group_bits = __ffs(s.chunk / kV) - 1;
  const int x4s = (s.box_w + 3) / 4;
  const unsigned x4s_magic = 0xFFFFFFFFu / static_cast<unsigned>(x4s) + 1;
  const int units = (s.box_h * x4s) << group_bits;
  for (int u = threadIdx.x; u < units; u += kDwThreads) {
    const int g = u & ((1 << group_bits) - 1);
    const int p = u >> group_bits;
    const int yy = static_cast<int>(__umulhi(static_cast<unsigned>(p),
                                             x4s_magic));
    const int x0 = 4 * (p - yy * x4s);
    const TIn* src = raw + (yy * s.box_w + x0) * s.chunk + g * kV;
    unsigned b[4][kV];
    unsigned doubt = 0;  // bit j kV + e: element e of pixel j is in doubt
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float f[kV];
      if (x0 + j < s.box_w) {
        unpack16(*reinterpret_cast<const uint4*>(src + j * s.chunk), f,
                 src);
      } else {
#pragma unroll
        for (int e = 0; e < kV; ++e) f[e] = 0.0f;
      }
#pragma unroll
      for (int e = 0; e < kV; ++e) {
        if (!quantize_sure(f[e], sc, b[j][e])) doubt |= 1u << (j * kV + e);
      }
    }
    uint8_t* dst = q + g * kV * s.plane_pitch + yy * s.row_pitch + x0;
#pragma unroll
    for (int e = 0; e < kV; ++e) {
      *reinterpret_cast<unsigned*>(dst + e * s.plane_pitch) =
          pack_low_bytes(b[0][e], b[1][e], b[2][e], b[3][e]);
    }
    // rare (within 3e-5 of a tie, or NaN): the division decides those
    // elements alone, each byte written again
    while (doubt != 0) {
      const int i = __ffs(doubt) - 1;
      doubt &= doubt - 1;
      const int j = i / kV;
      const int e = i - j * kV;
      dst[e * s.plane_pitch + j] = static_cast<uint8_t>(
          quantize(to_float(src[j * s.chunk + e]), sc));
    }
  }
}

// The "depthwise" design: a K x K window at stride S. A thread takes
// channel `cl` of the CTA's chunk (for the whole run of the CTA) and the
// 4 x 4 output blocks b = worker, worker + workers, ... of each tile. For
// output (j, i) of a block, window row r reads bytes S i .. S i + K - 1 of
// the block's input row 4 S by + S j + r, from byte 4 S bx: the words k
// that hold them, each dotted (__dp4a) with a weight word wt[r][i][k]
// that has w[r][q] at byte 4 k + b where q = 4 k + b - S i, zeros
// elsewhere. Sums of at most 25 products of |127| stay exact.
template <typename TIn, typename TOut, int K, int S>
__global__ void __launch_bounds__(kDwThreads, 3)
    int8_conv_dw_kernel(const __grid_constant__ CUtensorMap x_map,
                        const __grid_constant__ CUtensorMap y_map,
                        const int8_t* __restrict__ w,
                        const float* __restrict__ scale,
                        const float* __restrict__ bias, Scale sc, DwShape s) {
  constexpr int kRows = (kDwBlock - 1) * S + K;   // input rows of a block
  constexpr int kWords = (3 * S + K + 3) / 4;     // words of each
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((128 - (smem_address(smem_raw) & 127)) & 127);
  const int raw_stride = s.q_off / s.stages;
  uint8_t* q = smem + s.q_off;
  TOut* out = reinterpret_cast<TOut*>(smem + s.out_off);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + s.bar_off);
  const int tid = threadIdx.x;
  const int workers = kDwThreads / s.chunk;
  const int worker = tid / s.chunk;
  const int cl = tid - worker * s.chunk;

  if (tid == 0) {
    for (int i = 0; i < s.stages; ++i) mbar_init(&full[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    // x is the previous kernel's output: wait for that grid (this one may
    // start early) to finish and flush
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
    for (int i = 0; i < s.stages; ++i) {
      const int item = blockIdx.x + i * gridDim.x;
      if (item < s.items) {
        dw_load_box<TIn>(&x_map, smem + i * raw_stride, &full[i], s, item);
      }
    }
  }

  int wt[K][kDwBlock][kWords];
  float sc_c = 0.0f, bi_c = 0.0f;
  int chunk_now = -1;
  const int bcols = s.tile_w / kDwBlock;
  const int blocks = s.tile_h / kDwBlock * bcols;
  int it = 0;
  for (int item = blockIdx.x; item < s.items; item += gridDim.x, ++it) {
    const DwItem d = dw_item(s, item);
    if (d.ci != chunk_now) {
      // this channel's weights as dp4a words, its scale and bias: once a
      // CTA while its chunk stays
      chunk_now = d.ci;
      const int ch = d.ci * s.chunk + cl;
      int wb[K][K];
#pragma unroll
      for (int r = 0; r < K; ++r) {
#pragma unroll
        for (int c = 0; c < K; ++c) {
          wb[r][c] = ch < s.c ? static_cast<int>(w[(r * K + c) * s.c + ch]) : 0;
        }
      }
#pragma unroll
      for (int r = 0; r < K; ++r) {
#pragma unroll
        for (int i = 0; i < kDwBlock; ++i) {
#pragma unroll
          for (int k = 0; k < kWords; ++k) {
            if (!dw_overlaps<K, S>(i, k)) continue;
            unsigned word = 0;
#pragma unroll
            for (int b = 0; b < 4; ++b) {
              const int c = 4 * k + b - S * i;
              if (c >= 0 && c < K) word |= (wb[r][c] & 0xFFu) << (8 * b);
            }
            wt[r][i][k] = static_cast<int>(word);
          }
        }
      }
      sc_c = ch < s.c ? scale[ch] : 0.0f;
      bi_c = ch < s.c && bias != nullptr ? bias[ch] : 0.0f;
    }
    const int st = it % s.stages;
    mbar_wait(&full[st], (it / s.stages) & 1);
    dw_quantize_box(reinterpret_cast<const TIn*>(smem + st * raw_stride), q,
                    s, sc);
    // the previous item's store has read the staging tile
    if (tid == 0) bulk_wait_read<0>();
    __syncthreads();  // q is whole, the raw box free, the staging tile free
    if (tid == 0 && item + s.stages * gridDim.x < s.items) {
      dw_load_box<TIn>(&x_map, smem + st * raw_stride, &full[st], s,
                       item + s.stages * gridDim.x);
    }

    const uint8_t* qc = q + cl * s.plane_pitch;
    for (int b = worker; b < blocks; b += workers) {
      const int by = b / bcols;
      const int bx = b - by * bcols;
      const uint8_t* q0 =
          qc + kDwBlock * by * S * s.row_pitch + kDwBlock * bx * S;
      int acc[kDwBlock][kDwBlock];
#pragma unroll
      for (int j = 0; j < kDwBlock; ++j) {
#pragma unroll
        for (int i = 0; i < kDwBlock; ++i) acc[j][i] = 0;
      }
#pragma unroll
      for (int yy = 0; yy < kRows; ++yy) {
        const int* row = reinterpret_cast<const int*>(q0 + yy * s.row_pitch);
        int wd[kWords];
#pragma unroll
        for (int k = 0; k < kWords; ++k) wd[k] = row[k];
#pragma unroll
        for (int j = 0; j < kDwBlock; ++j) {
          const int r = yy - j * S;
          if (r < 0 || r >= K) continue;
#pragma unroll
          for (int i = 0; i < kDwBlock; ++i) {
#pragma unroll
            for (int k = 0; k < kWords; ++k) {
              if (dw_overlaps<K, S>(i, k)) {
                acc[j][i] = __dp4a(wd[k], wt[r][i][k], acc[j][i]);
              }
            }
          }
        }
      }
      // epilogue: requantize into the staging tile (tile_h, tile_w, chunk)
#pragma unroll
      for (int j = 0; j < kDwBlock; ++j) {
#pragma unroll
        for (int i = 0; i < kDwBlock; ++i) {
          float v = __fmul_rn(exact_float(acc[j][i]), sc_c);
          if (bias != nullptr) v = __fadd_rn(v, bi_c);
          store(out + ((kDwBlock * by + j) * s.tile_w + kDwBlock * bx + i) *
                          s.chunk + cl,
                v);
        }
      }
    }
    // the async proxy (TMA) reads what the threads wrote
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // the staging tile is whole; q may be overwritten
    if (tid == 0) {
      tma_store_4d(&y_map, out, d.ci * s.chunk, d.tx * s.tile_w,
                   d.ty * s.tile_h, d.n);
    }
  }
  if (tid == 0) bulk_wait_read<0>();  // shared memory outlives the stores
}

// The "depthwise_generic" design: any window and stride, any C, any
// alignment. The same items and int8 planes; the threads load and quantize
// each window block's box themselves (zeros outside the input and past C),
// a thread sums its channel at the outputs p = worker, worker + workers,
// ... of the tile with int32 multiply-adds, and keeps the sums in shared
// memory (at out_off) across window blocks.
template <typename TIn, typename TOut>
__global__ void __launch_bounds__(kDwThreads)
    int8_conv_dw_generic_kernel(const TIn* __restrict__ x,
                                const int8_t* __restrict__ w,
                                const float* __restrict__ scale,
                                const float* __restrict__ bias,
                                TOut* __restrict__ y, Scale sc, DwShape s) {
  extern __shared__ uint8_t smem_raw[];
  int8_t* q = reinterpret_cast<int8_t*>(smem_raw + s.q_off);
  int* sums = reinterpret_cast<int*>(smem_raw + s.out_off);
  const int tid = threadIdx.x;
  const int workers = kDwThreads / s.chunk;
  const int worker = tid / s.chunk;
  const int cl = tid - worker * s.chunk;
  const int outs = s.tile_h * s.tile_w;
  const int box = s.box_h * s.box_w * s.chunk;
  for (int item = blockIdx.x; item < s.items; item += gridDim.x) {
    const DwItem d = dw_item(s, item);
    const int c0 = d.ci * s.chunk;
    const int ch = c0 + cl;
    const int iy0 = d.ty * s.tile_h * s.stride - s.pad_t;
    const int ix0 = d.tx * s.tile_w * s.stride - s.pad_l;
    const TIn* x_img = x + static_cast<size_t>(d.n) * s.h * s.w * s.c;
    for (int p = worker; p < outs; p += workers) sums[p * s.chunk + cl] = 0;
    for (int r0 = 0; r0 < s.kh; r0 += s.taps_h) {
      for (int wc0 = 0; wc0 < s.kw; wc0 += s.taps_w) {
        __syncthreads();  // q is free
        for (int u = tid; u < box; u += kDwThreads) {
          const int c = u % s.chunk;
          const int pix = u / s.chunk;
          const int yy = pix / s.box_w;
          const int xx = pix - yy * s.box_w;
          const int iy = iy0 + r0 + yy;
          const int ix = ix0 + wc0 + xx;
          int v = 0;
          if (iy >= 0 && iy < s.h && ix >= 0 && ix < s.w && c0 + c < s.c) {
            v = quantize(to_float(x_img[(static_cast<size_t>(iy) * s.w + ix) *
                                            s.c + c0 + c]),
                         sc);
          }
          q[c * s.plane_pitch + yy * s.row_pitch + xx] =
              static_cast<int8_t>(v);
        }
        __syncthreads();  // q is whole
        const int rows = min(s.taps_h, s.kh - r0);
        const int cols = min(s.taps_w, s.kw - wc0);
        for (int p = worker; p < outs; p += workers) {
          const int oy = p / s.tile_w;
          const int ox = p - oy * s.tile_w;
          const int8_t* qp = q + cl * s.plane_pitch +
                             oy * s.stride * s.row_pitch + ox * s.stride;
          int sum = 0;
          if (ch < s.c) {
            for (int r = 0; r < rows; ++r) {
              for (int c = 0; c < cols; ++c) {
                sum += static_cast<int>(qp[r * s.row_pitch + c]) *
                       static_cast<int>(
                           w[((r0 + r) * s.kw + wc0 + c) * s.c + ch]);
              }
            }
          }
          sums[p * s.chunk + cl] += sum;
        }
      }
    }
    if (ch >= s.c) continue;
    const float sc_c = scale[ch];
    const float bi_c = bias != nullptr ? bias[ch] : 0.0f;
    for (int p = worker; p < outs; p += workers) {
      const int oy = d.ty * s.tile_h + p / s.tile_w;
      const int ox = d.tx * s.tile_w + p % s.tile_w;
      if (oy >= s.oh || ox >= s.ow) continue;
      float v = __fmul_rn(__int2float_rn(sums[p * s.chunk + cl]), sc_c);
      if (bias != nullptr) v = __fadd_rn(v, bi_c);
      store(y + ((static_cast<size_t>(d.n) * s.oh + oy) * s.ow + ox) * s.c +
                ch,
            v);
    }
  }
}

// -- the narrow design --------------------------------------------------------

// What the narrow kernel reads of Int8ConvArgs: the conv over the input as
// the kernel views it, (vn, vh, vw, c) -> (vn, voh, vow, o); a flat conv is
// one row of n * h * w pixels.
struct NarrowShape {
  int vn, vh, vw, c;
  int voh, vow, o;
  int kh, kw, stride, pad_t, pad_l;
  int tile_h, tile_w, box_h, box_w, row_pitch;
  int k_steps, w_pitch, o_pad, o_box, out_bufs, stages, tma_out;
  int q_off, w_off, sb_off, tap_off, out_off, bar_off;
  int tiles_y, tiles_x, items;
};

// One work item: image n (0 in a flat conv), output tile (ty, tx).
struct NarrowItem {
  int n, ty, tx;
};

__device__ __forceinline__ NarrowItem narrow_item(const NarrowShape& s,
                                                  int item) {
  NarrowItem d;
  d.tx = item % s.tiles_x;
  const int rest = item / s.tiles_x;
  d.ty = rest % s.tiles_y;
  d.n = rest / s.tiles_y;
  return d;
}

// Bytes of one staging tile: tile_h x tile_w pixels x ceil(o_pad / o_box)
// rows of o_box channels under TMA (the channels past O have a place, never
// stored), rows of o channels for the threads' store; a multiple of 1024
// (the 128-byte swizzle's period).
__host__ __device__ inline int narrow_staging_bytes(const NarrowShape& s,
                                                    int out_bytes) {
  const int chunks = s.tma_out ? (s.o_pad + s.o_box - 1) / s.o_box : 1;
  const int bytes = s.tile_h * s.tile_w * chunks * s.o_box * out_bytes;
  return (bytes + 1023) / 1024 * 1024;
}

// four 8x8 matrices of 16-bit pairs to shared memory: lanes 8q..8q+7 give
// the row addresses of matrix q; register q holds row lane / 4, elements
// 2 (lane % 4) and 2 (lane % 4) + 1 of matrix q (the inverse of ldmatrix)
__device__ __forceinline__ void stmatrix_x4(void* p, unsigned r0,
                                            unsigned r1, unsigned r2,
                                            unsigned r3) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::
          "r"(smem_address(p)),
      "r"(r0), "r"(r1), "r"(r2), "r"(r3)
      : "memory");
}

// two floats rounded to a bfloat16 pair, the first in the low half
__device__ __forceinline__ unsigned bf16_pair(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned*>(&v);
}

// Where box pixel (yy, xx) starts in the quantized box: a row holds the
// pixels of column phase 0 of the stride, then phase 1, ... (pw pixels a
// phase, 16 bytes each), so that the 8 consecutive outputs an ldmatrix
// phase reads, `stride` pixels apart in the input, are 8 consecutive
// 16-byte rows on 32 banks at any stride.
__device__ __forceinline__ int narrow_pixel(const NarrowShape& s, int pw,
                                            int yy, int xx) {
  const int place = s.stride == 1   ? xx
                    : s.stride == 2 ? (xx & 1) * pw + (xx >> 1)
                                    : (xx % s.stride) * pw + xx / s.stride;
  return yy * s.row_pitch + place * 16;
}

// u / d for u < 2^16 and 0 < d <= 256, by a multiply-high with
// magic = 2^32 / d rounded up (the error stays under 1 / d)
__device__ __forceinline__ int narrow_div(int u, unsigned magic) {
  return static_cast<int>(__umulhi(static_cast<unsigned>(u), magic));
}

// One raw box (box_h x box_w pixels x c channels of TIn, as TMA wrote it:
// c * sizeof(TIn) a multiple of 16) -> 16-byte quantized pixels, the bytes
// past c zero; a thread a pixel, each element quantized once (the division
// only for the elements in doubt, each byte written again).
template <typename TIn>
__device__ __forceinline__ void narrow_quantize_raw(const TIn* raw,
                                                    uint8_t* q,
                                                    const NarrowShape& s,
                                                    Scale sc, int pw) {
  constexpr int kV = 16 / static_cast<int>(sizeof(TIn));
  const int vecs = s.c / kV;
  const int pixels = s.box_h * s.box_w;
  const unsigned magic = 0xFFFFFFFFu / static_cast<unsigned>(s.box_w) + 1;
  for (int u = threadIdx.x; u < pixels; u += kNarrowThreads) {
    const int yy = narrow_div(u, magic);
    const int xx = u - yy * s.box_w;
    const TIn* src = raw + u * s.c;
    float f[16];
#pragma unroll
    for (int v = 0; v < 16 / kV; ++v) {
      if (v < vecs) {
        unpack16(reinterpret_cast<const uint4*>(src)[v], f + v * kV, src);
      } else {
#pragma unroll
        for (int e = 0; e < kV; ++e) f[v * kV + e] = 0.0f;
      }
    }
    unsigned b[16];
    unsigned doubt = 0;  // bit e: element e is in doubt
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      b[e] = 0;  // (elements past 8 of a pixel of c <= 8: zero, unread)
      if ((e < 8 || s.c > 8) && !quantize_sure(f[e], sc, b[e])) {
        doubt |= 1u << e;
      }
    }
    uint8_t* dst = q + narrow_pixel(s, pw, yy, xx);
    *reinterpret_cast<uint4*>(dst) = make_uint4(
        pack_low_bytes(b[0], b[1], b[2], b[3]),
        pack_low_bytes(b[4], b[5], b[6], b[7]),
        pack_low_bytes(b[8], b[9], b[10], b[11]),
        pack_low_bytes(b[12], b[13], b[14], b[15]));
    for (; doubt != 0; doubt &= doubt - 1) {
      const int e = __ffs(doubt) - 1;
      dst[e] = static_cast<uint8_t>(quantize(to_float(src[e]), sc));
    }
  }
}

// The same box loaded by the threads from x (any alignment, any c): zeros
// outside the input, which is the zero padding.
template <typename TIn>
__device__ __forceinline__ void narrow_quantize_global(
    const TIn* __restrict__ x, uint8_t* q, const NarrowShape& s, Scale sc,
    int pw, int n, int iy0, int ix0) {
  const int pixels = s.box_h * s.box_w;
  const unsigned magic = 0xFFFFFFFFu / static_cast<unsigned>(s.box_w) + 1;
  for (int u = threadIdx.x; u < pixels; u += kNarrowThreads) {
    const int yy = narrow_div(u, magic);
    const int xx = u - yy * s.box_w;
    const int iy = iy0 + yy;
    const int ix = ix0 + xx;
    const bool inside = iy >= 0 && iy < s.vh && ix >= 0 && ix < s.vw;
    const TIn* src =
        x + ((static_cast<size_t>(n) * s.vh + (inside ? iy : 0)) * s.vw +
             (inside ? ix : 0)) *
                s.c;
    int b[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      b[e] = inside && e < s.c ? quantize(to_float(src[e]), sc) : 0;
    }
    *reinterpret_cast<uint4*>(q + narrow_pixel(s, pw, yy, xx)) =
        make_uint4(static_cast<unsigned>(pack4(b[0], b[1], b[2], b[3])),
                   static_cast<unsigned>(pack4(b[4], b[5], b[6], b[7])),
                   static_cast<unsigned>(pack4(b[8], b[9], b[10], b[11])),
                   static_cast<unsigned>(pack4(b[12], b[13], b[14], b[15])));
  }
}

// The input box of `item` (the tile's window origins, minus the pads, with
// the halo) into `dst` by TMA; `bar` expects its bytes.
template <typename TIn>
__device__ __forceinline__ void narrow_load_box(const CUtensorMap* x_map,
                                                uint8_t* dst, uint64_t* bar,
                                                const NarrowShape& s,
                                                int item) {
  const NarrowItem d = narrow_item(s, item);
  mbar_expect_tx(bar, static_cast<unsigned>(s.box_h * s.box_w * s.c *
                                            static_cast<int>(sizeof(TIn))));
  tma_load_4d(dst, x_map, bar, 0, d.tx * s.tile_w * s.stride - s.pad_l,
              d.ty * s.tile_h * s.stride - s.pad_t, d.n);
}

// The "narrow" design: a dense conv with 4 <= C <= 16, one launch. A CTA
// (persistent, 256 threads) widens the packed weights into shared memory
// once (16 bytes a tap, zeros past c_tap: two taps a k32 step), then walks
// its items: the input box by TMA into a ring of raw boxes (or loaded by
// the threads), quantized once into 16-byte pixels; each warp takes units
// of 16 output pixels x 32 channels, `mma.sync` m16n8k32 s8 over k_steps
// steps, its A fragments by `ldmatrix` straight from the quantized pixels
// (each lane addresses its own output pixel's tap: the im2col gather is in
// the addresses), B by `ldmatrix` from the weights; the epilogue
// requantizes into a staging tile (rows of o_box channels, swizzled as
// the TMA store's map says) that one thread stores by TMA, or the threads
// store it clipped at the edges.
template <typename TIn, typename TOut, bool kTmaIn, int kTileN>
__global__ void __launch_bounds__(kNarrowThreads, 2)
    int8_conv_narrow_kernel(const __grid_constant__ CUtensorMap x_map,
                            const __grid_constant__ CUtensorMap y_map,
                            const TIn* __restrict__ x,
                            const int* __restrict__ w, int k_pad,
                            const float* __restrict__ scale,
                            const float* __restrict__ bias,
                            TOut* __restrict__ y, Scale sc, NarrowShape s) {
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle of the staging tile repeats every 1024 bytes
  uint8_t* smem =
      smem_raw + ((1024 - (smem_address(smem_raw) & 1023)) & 1023);
  const int raw_stride = s.stages > 0 ? s.q_off / s.stages : 0;
  uint8_t* q = smem + s.q_off;
  uint8_t* wsm = smem + s.w_off;
  float4* sb = reinterpret_cast<float4*>(smem + s.sb_off);
  int* toff = reinterpret_cast<int*>(smem + s.tap_off);
  uint8_t* out = smem + s.out_off;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + s.bar_off);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int taps = s.kh * s.kw;
  const int cw = (s.c + 3) >> 2;  // int32 words of a packed tap
  const int pw = s.row_pitch / (16 * s.stride);

  if (kTmaIn && tid == 0) {
    for (int i = 0; i < s.stages; ++i) mbar_init(&full[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // x is the previous kernel's output: wait for that grid (this one may
    // start early) to finish, then put the first boxes in flight while
    // the threads bring the weights
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
    for (int i = 0; i < s.stages; ++i) {
      const int item = blockIdx.x + i * gridDim.x;
      if (item < s.items) {
        narrow_load_box<TIn>(&x_map, smem + i * raw_stride, &full[i], s,
                             item);
      }
    }
  }
  // the weights widened (row o: tap t at bytes 16 t .. 16 t + 15, its
  // c_tap channels then zeros; zero rows past O), a tap a thread (its cw
  // words loaded together); scale and bias as (scale[o], scale[o + 1],
  // bias[o], bias[o + 1]) a channel pair; each tap's byte offset in the
  // quantized box (a tap past the window reads the first: its weights are
  // zero). Nothing here is the previous kernel's output, so it overlaps
  // that kernel's tail.
  const int slots = 2 * s.k_steps;
  for (int i = tid; i < s.o_pad * slots; i += kNarrowThreads) {
    const int o = i / slots;
    const int tap = i - o * slots;
    int v[4] = {0, 0, 0, 0};
    if (o < s.o && tap < taps) {
      const int* src = w + static_cast<long long>(o) * k_pad + tap * cw;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j < cw) v[j] = src[j];
      }
    }
    *reinterpret_cast<int4*>(wsm + o * s.w_pitch + 16 * tap) =
        make_int4(v[0], v[1], v[2], v[3]);
  }
  for (int i = tid; i < s.o_pad / 2; i += kNarrowThreads) {
    const int o = 2 * i;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (o < s.o) v.x = scale[o];
    if (o + 1 < s.o) v.y = scale[o + 1];
    if (bias != nullptr && o < s.o) v.z = bias[o];
    if (bias != nullptr && o + 1 < s.o) v.w = bias[o + 1];
    sb[i] = v;
  }
  for (int i = tid; i < 2 * s.k_steps; i += kNarrowThreads) {
    int off = 0;
    if (i < taps) {
      const int r = i / s.kw;
      const int c = i - r * s.kw;
      off = r * s.row_pitch + ((c % s.stride) * pw + c / s.stride) * 16;
    }
    toff[i] = off;
  }
  // x is the previous kernel's output, and y may be memory that it still
  // reads: every thread waits for that grid before it reads x or writes y
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  __syncthreads();

  const int tm = s.tile_h * s.tile_w;
  const int mfrags = tm / 16;
  const int mgroups = (mfrags + kUnitM - 1) / kUnitM;
  const int units = mgroups * ((s.o_pad + kTileN - 1) / kTileN);
  const int chunks = (s.o + s.o_box - 1) / s.o_box;  // TMA stores an item
  const int rb = s.o_box * static_cast<int>(sizeof(TOut));  // a staging row
  const int staging = narrow_staging_bytes(s, static_cast<int>(sizeof(TOut)));
  const int g = lane >> 2;  // the fragments' row group
  const int t = lane & 3;   // the thread in the group
  // the TMA store's swizzle (rows of 32, 64 or 128 bytes: 16-byte unit u of
  // byte a is u ^ ((a >> 7) & mask)). A lane's rows are g + 8 h of a
  // 16-row fragment, so that its term is the same at every row it writes:
  // (g rb >> 7) & mask. The threads' store reads rows plain.
  const int mask = s.tma_out ? rb / 16 - 1 : 0;
  const int xor16 = (((g * rb) >> 7) & mask) << 4;
  // a channel's staging box and place: o_box is a power of two under TMA
  const int box_shift = __ffs(s.o_box) - 1;
  // every |acc| < 2^22 (|q| <= 127, |w| <= 128): float(acc) by
  // `exact_float`, an integer and a float add, not the conversion unit (an
  // eighth of the add's rate); 5x5 windows over 16 channels reach 6.5e6
  // and convert
  const bool exact_add = taps * s.c * 127 * 128 < (1 << 22);
  // bfloat16 rows of whole 16-byte units of 8 channels: the epilogue stores
  // 4 matrices of 8 pixels x 8 channels an instruction (stmatrix), lane l
  // addressing row l % 8 of matrix l / 8, whose swizzle term is its own
  constexpr bool kMatrices = sizeof(TOut) == 2;
  const bool matrices = kMatrices && s.tma_out;
  const int r8 = lane & 7;
  const int xor_r8 = (((r8 * rb) >> 7) & mask) << 4;
  int it = 0;
  for (int item = blockIdx.x; item < s.items; item += gridDim.x, ++it) {
    const NarrowItem d = narrow_item(s, item);
    if constexpr (kTmaIn) {
      const int st = it % s.stages;
      mbar_wait(&full[st], (it / s.stages) & 1);
      narrow_quantize_raw(reinterpret_cast<const TIn*>(smem + st * raw_stride),
                          q, s, sc, pw);
    } else {
      narrow_quantize_global(x, q, s, sc, pw, d.n,
                             d.ty * s.tile_h * s.stride - s.pad_t,
                             d.tx * s.tile_w * s.stride - s.pad_l);
    }
    uint8_t* stage = out + (s.out_bufs > 1 ? (it & 1) : 0) * staging;
    // the store that last read this staging tile is done
    if (tid == 0 && s.tma_out) {
      if (s.out_bufs > 1) {
        bulk_wait_read<1>();
      } else {
        bulk_wait_read<0>();
      }
    }
    __syncthreads();  // q is whole, the raw box free, the staging tile free
    if (kTmaIn && tid == 0 && item + s.stages * gridDim.x < s.items) {
      const int st = it % s.stages;
      narrow_load_box<TIn>(&x_map, smem + st * raw_stride, &full[st], s,
                           item + s.stages * gridDim.x);
    }

    // float(acc) * scale (+ bias) of channels o, o + 1 from their float4
    auto requant = [&](int a0, int a1, const float4& sbj, float& v0,
                       float& v1) {
      v0 = __fmul_rn(exact_add ? exact_float(a0) : __int2float_rn(a0),
                     sbj.x);
      v1 = __fmul_rn(exact_add ? exact_float(a1) : __int2float_rn(a1),
                     sbj.y);
      if (bias != nullptr) {
        v0 = __fadd_rn(v0, sbj.z);
        v1 = __fadd_rn(v1, sbj.w);
      }
    };
    // the epilogue of fragment mf (channels from n0): (row g, channels 2t,
    // 2t + 1) and row g + 8 of each tile, requantized into the staging tile
    auto epilogue = [&](int mf, int n0, const int (&ac)[kTileN / 8][4]) {
      if (matrices) {
        // tiles 2 jp and 2 jp + 1, rows g and g + 8: four matrices
#pragma unroll
        for (int jp = 0; jp < kTileN / 16; ++jp) {
          if (n0 + jp * 16 >= s.o_pad) break;  // the same in every lane
          unsigned r[4];
#pragma unroll
          for (int q4 = 0; q4 < 4; ++q4) {
            const int j = 2 * jp + q4 / 2;
            float v0, v1;
            requant(ac[j][2 * (q4 % 2)], ac[j][2 * (q4 % 2) + 1],
                    sb[(n0 + j * 8 + 2 * t) >> 1], v0, v1);
            r[q4] = bf16_pair(v0, v1);
          }
          // this lane's row: matrix (tile 2 jp + q / 2, half q % 2), q =
          // lane / 8
          const int o = n0 + jp * 16 + (lane >> 4) * 8;
          const int chunk = o >> box_shift;
          uint8_t* row = stage + chunk * tm * rb +
                         (mf * 16 + ((lane >> 3) & 1) * 8 + r8) * rb +
                         (((o - chunk * s.o_box) * 2) ^ xor_r8);
          stmatrix_x4(row, r[0], r[1], r[2], r[3]);
        }
        return;
      }
      uint8_t* rows = stage + (mf * 16 + g) * rb;
#pragma unroll
      for (int j = 0; j < kTileN / 8; ++j) {
        const int o = n0 + j * 8 + 2 * t;
        if (o >= s.o) continue;
        const int chunk = s.tma_out ? o >> box_shift : 0;
        const int oc = o - chunk * s.o_box;
        const bool pair = o + 1 < s.o && (s.o_box & 1) == 0;
        const float4 sbj = sb[o >> 1];  // scale, scale, bias, bias
        uint8_t* col = rows + chunk * tm * rb +
                       ((oc * static_cast<int>(sizeof(TOut))) ^ xor16);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v0, v1;
          requant(ac[j][2 * h], ac[j][2 * h + 1], sbj, v0, v1);
          TOut* dst = reinterpret_cast<TOut*>(col + 8 * h * rb);
          if (pair) {
            store2(dst, v0, v1);
          } else {
            store(dst, v0);  // rows of odd length: the threads' store
            if (o + 1 < s.o) store(dst + 1, v1);
          }
        }
      }
    };

    // a warp's unit: kUnitM fragments of 16 output pixels x kTileN
    // channels, each B fragment serving kUnitM products
    for (int u = warp; u < units; u += kNarrowThreads / 32) {
      const int mf0 = (u % mgroups) * kUnitM;
      const int n0 = (u / mgroups) * kTileN;
      // ldmatrix.x4 of A: lanes 8q..8q+7 address matrix q = (rows 0-7 |
      // 8-15) x (tap 2 kk | 2 kk + 1), so lane l gives output pixel
      // 16 mf + l % 16 at tap 2 kk + l / 16 (a fragment past the tile reads
      // the last one's pixels, its products unused)
      const uint8_t* a_row[kUnitM];
#pragma unroll
      for (int i = 0; i < kUnitM; ++i) {
        const int p = min(mf0 + i, mfrags - 1) * 16 + (lane & 15);
        const int oy = p / s.tile_w;
        a_row[i] = q + oy * s.stride * s.row_pitch + (p - oy * s.tile_w) * 16;
      }
      int acc[kUnitM][kTileN / 8][4];
#pragma unroll
      for (int i = 0; i < kUnitM; ++i) {
#pragma unroll
        for (int j = 0; j < kTileN / 8; ++j) {
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;
        }
      }
      for (int kk = 0; kk < s.k_steps; ++kk) {
        int a[kUnitM][4];
#pragma unroll
        for (int i = 0; i < kUnitM; ++i) {
          ldmatrix_x4(a[i], a_row[i] + toff[2 * kk + (lane >> 4)]);
        }
#pragma unroll
        for (int np = 0; np < kTileN / 16; ++np) {
          if (n0 + np * 16 >= s.o_pad) break;  // the same in every lane
          // B: (bytes 0-15 | 16-31) x (channels of tile 2 np | 2 np + 1)
          int r[4];
          ldmatrix_x4(r, wsm + (n0 + np * 16 + (lane & 7) + (lane >> 4) * 8) *
                                   s.w_pitch +
                             kk * 32 + ((lane >> 3) & 1) * 16);
#pragma unroll
          for (int i = 0; i < kUnitM; ++i) {
            mma_s8(acc[i][2 * np], a[i], r[0], r[1]);
            mma_s8(acc[i][2 * np + 1], a[i], r[2], r[3]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kUnitM; ++i) {
        if (mf0 + i < mfrags) epilogue(mf0 + i, n0, acc[i]);
      }
    }
    if (s.tma_out) {
      // the async proxy (TMA) reads what the threads wrote
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    __syncthreads();  // the staging tile whole, q free for the next box
    if (s.tma_out) {
      if (tid == 0) {
        for (int ch = 0; ch < chunks; ++ch) {
          tma_store_4d(&y_map, stage + ch * tm * rb, ch * s.o_box,
                       d.tx * s.tile_w, d.ty * s.tile_h, d.n);
        }
      }
    } else {
      // rows of o channels, clipped at the output's edges
      const TOut* src = reinterpret_cast<const TOut*>(stage);
      for (int i = tid; i < tm * s.o; i += kNarrowThreads) {
        const int pp = i / s.o;
        const int oy = d.ty * s.tile_h + pp / s.tile_w;
        const int ox = d.tx * s.tile_w + pp % s.tile_w;
        if (oy < s.voh && ox < s.vow) {
          y[((static_cast<size_t>(d.n) * s.voh + oy) * s.vow + ox) * s.o +
            (i - pp * s.o)] = src[i];
        }
      }
    }
  }
  if (tid == 0 && s.tma_out) bulk_wait_read<0>();  // smem outlives the stores
}

// -- host ---------------------------------------------------------------------

// Errors past cudaError_t's: a tensor map the driver refused (kEncodeError
// + its CUresult), or no driver entry point for the encoders
constexpr int kEncodeError = 100000;
constexpr int kNoDriverEntry = 200000;

using EncodeIm2col = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const int*, const int*, cuuint32_t, cuuint32_t,
    const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
    CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// the driver's encoders, from the libcuda.so.1 that the CUDA runtime has
// loaded into the process
void* driver_symbol(const char* name) {
  static void* const lib = [] {
    void* l = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    return l != nullptr ? l : dlopen("libcuda.so.1", RTLD_NOW);
  }();
  return lib == nullptr ? nullptr : dlsym(lib, name);
}

// A 1x1 conv at stride 1 without padding over q (every 1x1 conv, once a
// strided one is subsampled) is a plain GEMM: its A is q as (m, c_tap).
bool gemm_input(const Int8ConvArgs& a) {
  return a.kh == 1 && a.kw == 1 && a.q_stride == 1 && a.lower_w == 0 &&
         a.lower_h == 0 && a.upper_w == 0 && a.upper_h == 0;
}

// Both tensor maps of one wgmma conv: A, the im2col map over the quantized
// input q (n, qh, qw, c_tap) int8, or for a GEMM input the tiled map over
// q as (n qh qw, c_tap); B, the tiled map over the packed weights (o, 4
// k_pad) bytes. Returns 0 or an error past cudaError_t's.
int encode_maps(const Int8ConvArgs& a, const void* q, const void* w,
                CUtensorMap* am, CUtensorMap* bm) {
  static const auto im2col = reinterpret_cast<EncodeIm2col>(
      driver_symbol("cuTensorMapEncodeIm2col"));
  static const auto tiled = reinterpret_cast<EncodeTiled>(
      driver_symbol("cuTensorMapEncodeTiled"));
  if (im2col == nullptr || tiled == nullptr) return kNoDriverEntry;
  const cuuint64_t c_tap = static_cast<cuuint64_t>(a.c_tap);
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const cuuint32_t chunk = static_cast<cuuint32_t>(a.chunk);
  const CUtensorMapSwizzle swizzle =
      chunk == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                   : chunk == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                 : CU_TENSOR_MAP_SWIZZLE_32B;
  CUresult r;
  if (gemm_input(a)) {
    const cuuint64_t dims[2] = {c_tap, static_cast<cuuint64_t>(a.n) *
                                           a.qh * a.qw};
    const cuuint64_t strides[1] = {c_tap};
    const cuuint32_t box[2] = {chunk, kTileM};
    r = tiled(am, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(q),
              dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
              swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  } else {
    const cuuint64_t dims[4] = {c_tap, static_cast<cuuint64_t>(a.qw),
                                static_cast<cuuint64_t>(a.qh),
                                static_cast<cuuint64_t>(a.n)};
    const cuuint64_t strides[3] = {dims[0], dims[0] * dims[1],
                                   dims[0] * dims[1] * dims[2]};
    const int lower[2] = {a.lower_w, a.lower_h};
    const int upper[2] = {a.upper_w, a.upper_h};
    const cuuint32_t steps[4] = {1, static_cast<cuuint32_t>(a.q_stride),
                                 static_cast<cuuint32_t>(a.q_stride), 1};
    r = im2col(am, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<void*>(q),
               dims, strides, lower, upper, chunk, kTileM, steps,
               CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  }
  if (r != CUDA_SUCCESS) return kEncodeError + static_cast<int>(r);
  const cuuint64_t b_dims[2] = {4 * static_cast<cuuint64_t>(a.k_pad),
                                static_cast<cuuint64_t>(a.o)};
  const cuuint64_t b_strides[1] = {b_dims[0]};
  const cuuint32_t b_box[2] = {chunk, static_cast<cuuint32_t>(a.tile_n)};
  r = tiled(bm, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(w),
            b_dims, b_strides, b_box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r != CUDA_SUCCESS ? kEncodeError + static_cast<int>(r) : 0;
}

// The tiled map of the output y (m, o), bfloat16 or float32, in boxes of
// 128 rows x 128 bytes in the 128-byte swizzle: what a part of the wgmma
// epilogue stages. O's rows must be 16-byte aligned.
int encode_output_map(void* y, bool bf16, int o, long long m,
                      CUtensorMap* ym) {
  static const auto tiled = reinterpret_cast<EncodeTiled>(
      driver_symbol("cuTensorMapEncodeTiled"));
  if (tiled == nullptr) return kNoDriverEntry;
  const cuuint32_t elem = bf16 ? 2 : 4;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(o),
                              static_cast<cuuint64_t>(m)};
  const cuuint64_t strides[1] = {dims[0] * elem};
  const cuuint32_t box[2] = {128 / elem, kTileM};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = tiled(
      ym, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
               : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      2, y, dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_NONE,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r != CUDA_SUCCESS ? kEncodeError + static_cast<int>(r) : 0;
}

// one CTA an SM at most, each walking its share of the tiles
template <int BN, int CH, typename TOut>
int launch_wgmma_tile(const CUtensorMap& am, const CUtensorMap& bm,
                      const CUtensorMap& ym, const float* scale,
                      const float* bias, TOut* y, const WgShape& s,
                      int device, cudaStream_t stream) {
  constexpr int kSmem = WgTile<BN, CH>::kSmem;
  auto kernel = int8_conv_wgmma_kernel<BN, CH, TOut>;
  // the shared-memory attribute is set, and the SM count read, once a
  // device and instance: at every call they would add host time to each
  // of a request's launches
  static std::atomic<int> sms_of[kMaxDevices];  // zero: not yet read
  if (device < 0 || device >= kMaxDevices) {
    return static_cast<int>(cudaErrorInvalidDevice);
  }
  int sms = sms_of[device].load(std::memory_order_relaxed);
  cudaError_t err;
  if (sms == 0) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err != cudaSuccess) return static_cast<int>(err);
    sms_of[device].store(sms, std::memory_order_relaxed);
  }
  const long long tiles =
      (s.m + kTileM - 1) / kTileM * ((s.o + BN - 1) / BN);
  // a programmatic dependent launch: the prologue (barriers, registers)
  // overlaps the tail of the quantizing pass
  cudaLaunchAttribute early;
  early.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  early.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(tiles < sms ? tiles : sms));
  config.blockDim = dim3(kWgThreads);
  config.dynamicSmemBytes = kSmem;
  config.stream = stream;
  config.attrs = &early;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, kernel, am, bm, ym, scale, bias, y, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int CH, typename TOut>
int launch_wgmma_chunk(const CUtensorMap& am, const CUtensorMap& bm,
                       const CUtensorMap& ym, const float* scale,
                       const float* bias, TOut* y, const WgShape& s,
                       int tile_n, int device, cudaStream_t stream) {
  switch (tile_n) {
    case 64:
      return launch_wgmma_tile<64, CH, TOut>(am, bm, ym, scale, bias, y, s,
                                             device, stream);
    case 128:
      return launch_wgmma_tile<128, CH, TOut>(am, bm, ym, scale, bias, y, s,
                                              device, stream);
    case 256:
      return launch_wgmma_tile<256, CH, TOut>(am, bm, ym, scale, bias, y, s,
                                              device, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename TIn, typename TOut>
int launch_wgmma(const Int8ConvArgs& a, const TIn* x, const void* w,
                 const float* scale, const float* bias, TOut* y, void* q,
                 Scale sc, int device, cudaStream_t stream) {
  // 1. the int8 input the conv reads, once
  const long long vecs =
      static_cast<long long>(a.n) * a.qh * a.qw * (a.c_tap / 16);
  if (vecs >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  long long blocks = (vecs + kQuantThreads - 1) / kQuantThreads;
  if (blocks > 132 * 64) blocks = 132 * 64;  // grid-stride beyond that
  int4* qt = static_cast<int4*>(q);
  if (a.c % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0) {
    quantize_bytes_kernel<TIn, true>
        <<<static_cast<unsigned>(blocks), kQuantThreads, 0, stream>>>(
            x, qt, sc, static_cast<unsigned>(vecs), a);
  } else {
    quantize_bytes_kernel<TIn, false>
        <<<static_cast<unsigned>(blocks), kQuantThreads, 0, stream>>>(
            x, qt, sc, static_cast<unsigned>(vecs), a);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // 2. the implicit GEMM
  CUtensorMap am, bm, ym;
  int enc = encode_maps(a, q, w, &am, &bm);
  if (enc != 0) return enc;
  const long long m = static_cast<long long>(a.n) * a.oh * a.ow;
  const bool tma_store = (a.o * sizeof(TOut)) % 16 == 0;
  memset(&ym, 0, sizeof(ym));  // unread without a TMA store
  if (tma_store) {
    enc = encode_output_map(y, sizeof(TOut) == 2, a.o, m, &ym);
    if (enc != 0) return enc;
  }
  const WgShape s{m, a.oh, a.ow, a.o,
                  a.kw, a.kh * a.kw, (a.c_tap + a.chunk - 1) / a.chunk,
                  a.c_tap, a.q_stride, a.lower_w, a.lower_h, gemm_input(a),
                  tma_store};
  switch (a.chunk) {
    case 32:
      return launch_wgmma_chunk<32, TOut>(am, bm, ym, scale, bias, y, s,
                                          a.tile_n, device, stream);
    case 64:
      return launch_wgmma_chunk<64, TOut>(am, bm, ym, scale, bias, y, s,
                                          a.tile_n, device, stream);
    case 128:
      return launch_wgmma_chunk<128, TOut>(am, bm, ym, scale, bias, y, s,
                                           a.tile_n, device, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename TIn, typename TOut>
int launch_mma_sync(const Int8ConvArgs& a, const TIn* x, const void* w,
                    const float* scale, const float* bias, TOut* y, void* q,
                    Scale sc, cudaStream_t stream) {
  // 1. the quantized words of the whole input, once
  const int cw = (a.c + 3) / 4;
  const long long words = static_cast<long long>(a.n) * a.h * a.w * cw;
  if (words >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  long long blocks = (words + kQuantThreads - 1) / kQuantThreads;
  if (blocks > 132 * 64) blocks = 132 * 64;  // grid-stride beyond that
  int* qt = static_cast<int*>(q);
  if (a.c % 4 == 0 &&
      reinterpret_cast<uintptr_t>(x) % (4 * sizeof(TIn)) == 0) {
    quantize_words_kernel<TIn, true>
        <<<static_cast<unsigned>(blocks), kQuantThreads, 0, stream>>>(
            x, qt, sc, static_cast<unsigned>(words), a.c, cw);
  } else {
    quantize_words_kernel<TIn, false>
        <<<static_cast<unsigned>(blocks), kQuantThreads, 0, stream>>>(
            x, qt, sc, static_cast<unsigned>(words), a.c, cw);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // 2. the implicit GEMM on the tensor cores
  const long long m_total = static_cast<long long>(a.n) * a.oh * a.ow;
  const dim3 grid(static_cast<unsigned>((m_total + kBM - 1) / kBM),
                  static_cast<unsigned>((a.o + kBN - 1) / kBN));
  int8_conv_gemm_kernel<TOut><<<grid, kThreads, 0, stream>>>(
      qt, static_cast<const int*>(w), scale, bias, y, a, a.k_pad);
  return static_cast<int>(cudaGetLastError());
}

DwShape dw_shape(const Int8ConvArgs& a) {
  DwShape s{a.n,        a.h,           a.w,          a.c,
            a.oh,       a.ow,          a.kh,         a.kw,
            a.stride,   a.pad_t,       a.pad_l,      a.tile_h,
            a.tile_w,   a.dw_chunk,    a.box_h,      a.box_w,
            a.taps_h,   a.taps_w,      a.row_pitch,  a.plane_pitch,
            a.stages,   a.q_off,       a.out_off,    a.bar_off,
            0,          0,             0,            0};
  s.tiles_y = (a.oh + a.tile_h - 1) / a.tile_h;
  s.tiles_x = (a.ow + a.tile_w - 1) / a.tile_w;
  s.chunks = (a.c + a.dw_chunk - 1) / a.dw_chunk;
  const long long items =
      static_cast<long long>(a.n) * s.tiles_y * s.tiles_x * s.chunks;
  s.items = items < (1LL << 31) ? static_cast<int>(items) : -1;
  return s;
}

// The tiled 4-D map of an NHWC tensor (dims C, W, H, N; bfloat16 or float32)
// in boxes of (chunk, box_w, box_h, 1), unswizzled unless `swizzle` says;
// coordinates outside it read zeros.
int encode_nhwc_map(const void* t, bool bf16, int n, int h, int w, int c,
                    int chunk, int box_w, int box_h, bool promote,
                    CUtensorMap* map,
                    CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_NONE) {
  static const auto tiled = reinterpret_cast<EncodeTiled>(
      driver_symbol("cuTensorMapEncodeTiled"));
  if (tiled == nullptr) return kNoDriverEntry;
  const cuuint64_t elem = bf16 ? 2 : 4;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(c),
                              static_cast<cuuint64_t>(w),
                              static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[3] = {dims[0] * elem, dims[0] * dims[1] * elem,
                                 dims[0] * dims[1] * dims[2] * elem};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(chunk),
                             static_cast<cuuint32_t>(box_w),
                             static_cast<cuuint32_t>(box_h), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = tiled(
      map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      4, const_cast<void*>(t), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      promote ? CU_TENSOR_MAP_L2_PROMOTION_L2_256B
              : CU_TENSOR_MAP_L2_PROMOTION_NONE,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r != CUDA_SUCCESS ? kEncodeError + static_cast<int>(r) : 0;
}

// One kernel's launch facts, kept across calls (asked at every call they
// would add host time to each launch): the shared-memory attribute, set
// once a device, and the resident CTAs at each size, asked once.
struct LaunchFacts {
  std::mutex lock;
  bool smem_set[kMaxDevices] = {};
  std::map<std::pair<int, int>, int> resident;  // (device, smem) -> CTAs
};

// CTAs of `kernel` that `device` holds at once with `threads` threads and
// `smem` bytes a CTA (the occupancy calculator's CTAs an SM x the SMs), or
// a negated error.
template <typename Kernel>
int resident_ctas(Kernel kernel, LaunchFacts& facts, int device, int smem,
                  int threads) {
  if (device < 0 || device >= kMaxDevices) {
    return -static_cast<int>(cudaErrorInvalidDevice);
  }
  std::lock_guard<std::mutex> guard(facts.lock);
  if (!facts.smem_set[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (err != cudaSuccess) return -static_cast<int>(err);
    facts.smem_set[device] = true;
  }
  const auto key = std::make_pair(device, smem);
  const auto found = facts.resident.find(key);
  if (found != facts.resident.end()) return found->second;
  int per_sm = 0, sms = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, threads, static_cast<size_t>(smem));
  if (err != cudaSuccess) return -static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (per_sm < 1) return -static_cast<int>(cudaErrorInvalidConfiguration);
  facts.resident[key] = per_sm * sms;
  return per_sm * sms;
}

// A persistent grid: every item if the device holds them all at once,
// else the CTAs it holds, cut to a multiple of the chunks, so that each
// CTA keeps one chunk (and its weights) for all its items.
int dw_grid(const DwShape& s, int resident) {
  if (s.items <= resident) return s.items;
  return resident >= s.chunks ? resident - resident % s.chunks : resident;
}

template <typename TIn, typename TOut, int K, int S>
int launch_dw_window(const CUtensorMap& xm, const CUtensorMap& ym,
                     const int8_t* w, const float* scale, const float* bias,
                     Scale sc, const DwShape& s, int smem, int device,
                     cudaStream_t stream) {
  auto kernel = int8_conv_dw_kernel<TIn, TOut, K, S>;
  static LaunchFacts facts;
  const int resident = resident_ctas(kernel, facts, device, smem,
                                     kDwThreads);
  if (resident < 0) return -resident;
  // a programmatic dependent launch: the prologue (barriers, weights)
  // overlaps the previous kernel's tail
  cudaLaunchAttribute early;
  early.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  early.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(dw_grid(s, resident)));
  config.blockDim = dim3(kDwThreads);
  config.dynamicSmemBytes = static_cast<size_t>(smem);
  config.stream = stream;
  config.attrs = &early;
  config.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&config, kernel, xm, ym, w, scale,
                                           bias, sc, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename TIn, typename TOut>
int launch_depthwise(const Int8ConvArgs& a, const TIn* x, const void* w,
                     const float* scale, const float* bias, TOut* y,
                     Scale sc, int device, cudaStream_t stream) {
  const DwShape s = dw_shape(a);
  if (s.items < 0 || a.smem > kSmemLimit) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int8_t* wq = static_cast<const int8_t*>(w);
  if (a.design == kDepthwiseGeneric) {
    auto kernel = int8_conv_dw_generic_kernel<TIn, TOut>;
    static LaunchFacts facts;
    const int resident = resident_ctas(kernel, facts, device, a.smem,
                                       kDwThreads);
    if (resident < 0) return -resident;
    kernel<<<static_cast<unsigned>(dw_grid(s, resident)), kDwThreads, a.smem,
             stream>>>(x, wq, scale, bias, y, sc, s);
    return static_cast<int>(cudaGetLastError());
  }
  CUtensorMap xm, ym;
  int enc = encode_nhwc_map(x, sizeof(TIn) == 2, a.n, a.h, a.w, a.c,
                            a.dw_chunk, a.box_w, a.box_h, true, &xm);
  if (enc != 0) return enc;
  enc = encode_nhwc_map(y, sizeof(TOut) == 2, a.n, a.oh, a.ow, a.c,
                        a.dw_chunk, a.tile_w, a.tile_h, false, &ym);
  if (enc != 0) return enc;
  switch (a.kh * 10 + a.stride) {
#define DW_CASE(K, S)                                                     \
  case K * 10 + S:                                                        \
    return launch_dw_window<TIn, TOut, K, S>(xm, ym, wq, scale, bias, sc, \
                                             s, a.smem, device, stream);
    DW_CASE(1, 1)
    DW_CASE(1, 2)
    DW_CASE(3, 1)
    DW_CASE(3, 2)
    DW_CASE(5, 1)
    DW_CASE(5, 2)
#undef DW_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

NarrowShape narrow_shape(const Int8ConvArgs& a) {
  NarrowShape s{};
  const long long pixels = static_cast<long long>(a.n) * a.h * a.w;
  const long long outs = static_cast<long long>(a.n) * a.oh * a.ow;
  s.vn = a.flat ? 1 : a.n;
  s.vh = a.flat ? 1 : a.h;
  s.vw = a.flat ? static_cast<int>(pixels < (1LL << 31) ? pixels : -1) : a.w;
  s.voh = a.flat ? 1 : a.oh;
  s.vow = a.flat ? s.vw : a.ow;
  s.c = a.c;
  s.o = a.o;
  s.kh = a.kh;
  s.kw = a.kw;
  s.stride = a.stride;
  s.pad_t = a.pad_t;
  s.pad_l = a.pad_l;
  s.tile_h = a.tile_h;
  s.tile_w = a.tile_w;
  s.box_h = a.box_h;
  s.box_w = a.box_w;
  s.row_pitch = a.row_pitch;
  s.k_steps = a.k_steps;
  s.w_pitch = a.w_pitch;
  s.o_pad = a.o_pad;
  s.o_box = a.o_box;
  s.out_bufs = a.out_bufs;
  s.stages = a.stages;
  s.tma_out = a.tma_out;
  s.q_off = a.q_off;
  s.w_off = a.w_off;
  s.sb_off = a.sb_off;
  s.tap_off = a.tap_off;
  s.out_off = a.out_off;
  s.bar_off = a.bar_off;
  s.tiles_y = (s.voh + a.tile_h - 1) / a.tile_h;
  s.tiles_x = (s.vow + a.tile_w - 1) / a.tile_w;
  const long long items =
      static_cast<long long>(s.vn) * s.tiles_y * s.tiles_x;
  s.items = s.vw > 0 && outs < (1LL << 31) && items < (1LL << 31)
                ? static_cast<int>(items)
                : -1;
  return s;
}

// a persistent grid: every item if the device holds them all at once,
// else the CTAs it holds
template <typename TIn, typename TOut, bool kTmaIn, int kTileN>
int launch_narrow_kernel(const CUtensorMap& xm, const CUtensorMap& ym,
                         const TIn* x, const int* w, int k_pad,
                         const float* scale, const float* bias, TOut* y,
                         Scale sc, const NarrowShape& s, int smem,
                         int device, cudaStream_t stream) {
  auto kernel = int8_conv_narrow_kernel<TIn, TOut, kTmaIn, kTileN>;
  static LaunchFacts facts;
  const int resident =
      resident_ctas(kernel, facts, device, smem, kNarrowThreads);
  if (resident < 0) return -resident;
  // a programmatic dependent launch: the prologue (barriers, weights)
  // overlaps the previous kernel's tail
  cudaLaunchAttribute early;
  early.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  early.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim =
      dim3(static_cast<unsigned>(s.items < resident ? s.items : resident));
  config.blockDim = dim3(kNarrowThreads);
  config.dynamicSmemBytes = static_cast<size_t>(smem);
  config.stream = stream;
  config.attrs = &early;
  config.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&config, kernel, xm, ym, x, w,
                                           k_pad, scale, bias, y, sc, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The swizzle of the output map whose box rows are `bytes` long: the one
// of that width (the staging tile is written in it), none for 16 bytes.
CUtensorMapSwizzle narrow_out_swizzle(int bytes) {
  return bytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
         : bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
         : bytes == 32 ? CU_TENSOR_MAP_SWIZZLE_32B
                       : CU_TENSOR_MAP_SWIZZLE_NONE;
}

template <typename TIn, typename TOut>
int launch_narrow(const Int8ConvArgs& a, const TIn* x, const void* w,
                  const float* scale, const float* bias, TOut* y, Scale sc,
                  int device, cudaStream_t stream) {
  const NarrowShape s = narrow_shape(a);
  const int rb = a.o_box * static_cast<int>(sizeof(TOut));
  if (s.items < 0 || a.smem > kSmemLimit || a.c > 16 ||
      (a.tma_in && a.stages < 1) ||
      (a.tma_out && (rb % 16 != 0 || rb > 128 || (rb & (rb - 1)) != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap xm, ym;
  memset(&xm, 0, sizeof(xm));  // unread without TMA
  memset(&ym, 0, sizeof(ym));
  if (a.tma_in) {
    if (reinterpret_cast<uintptr_t>(x) % 16 != 0) {
      return static_cast<int>(cudaErrorMisalignedAddress);
    }
    const int enc = encode_nhwc_map(x, sizeof(TIn) == 2, s.vn, s.vh, s.vw,
                                    a.c, a.c, a.box_w, a.box_h, true, &xm);
    if (enc != 0) return enc;
  }
  if (a.tma_out) {
    if (reinterpret_cast<uintptr_t>(y) % 16 != 0) {
      return static_cast<int>(cudaErrorMisalignedAddress);
    }
    const int enc = encode_nhwc_map(y, sizeof(TOut) == 2, s.vn, s.voh,
                                    s.vow, a.o, a.o_box, a.tile_w, a.tile_h,
                                    false, &ym, narrow_out_swizzle(rb));
    if (enc != 0) return enc;
  }
  const int* wi = static_cast<const int*>(w);
  switch (a.tile_n * 2 + a.tma_in) {
#define NARROW_CASE(N, TMA)                                                 \
  case N * 2 + TMA:                                                         \
    return launch_narrow_kernel<TIn, TOut, (TMA != 0), N>(                  \
        xm, ym, x, wi, a.k_pad, scale, bias, y, sc, s, a.smem, device,      \
        stream);
    NARROW_CASE(32, 0)
    NARROW_CASE(32, 1)
    NARROW_CASE(64, 0)
    NARROW_CASE(64, 1)
#undef NARROW_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename TIn, typename TOut>
int launch_typed(const Int8ConvArgs& a, const void* x, const void* w,
                 const float* scale, const float* bias, void* y, void* q,
                 Scale sc, int device, cudaStream_t stream) {
  const TIn* xt = static_cast<const TIn*>(x);
  TOut* yt = static_cast<TOut*>(y);
  switch (a.design) {
    case kWgmma:
      return launch_wgmma<TIn, TOut>(a, xt, w, scale, bias, yt, q, sc,
                                     device, stream);
    case kMmaSync:
      return launch_mma_sync<TIn, TOut>(a, xt, w, scale, bias, yt, q, sc,
                                        stream);
    case kDepthwise:
    case kDepthwiseGeneric:
      return launch_depthwise<TIn, TOut>(a, xt, w, scale, bias, yt, sc,
                                         device, stream);
    case kNarrow:
      return launch_narrow<TIn, TOut>(a, xt, w, scale, bias, yt, sc, device,
                                      stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Launches one convolution described by `a` (Int8ConvArgs above) on
// `stream` (a cudaStream_t) and returns 0, a cudaError_t, or an error of
// the tensor maps' encoding (int8_conv_error_string names each); the
// caller raises when it is not 0. x and y are NHWC; `x_bf16` / `y_bf16`
// pick bfloat16 over float32. `bias` may be null. `w` is packed as the
// header says. `q` is scratch for the quantized input of a dense conv,
// 16-byte aligned: n * qh * qw * c_tap bytes for the wgmma design, n * h *
// w * ceil(c / 4) int32 words for mma_sync (unused, and may be null, for
// the narrow and depthwise designs).
int int8_conv_launch(const Int8ConvArgs* a, const void* x, int x_bf16,
                     const void* w, const float* scale, const float* bias,
                     void* y, int y_bf16, void* q, float s_a, int device,
                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float inv = 1.0f / s_a;
  const Scale sc{s_a, std::isnormal(s_a) && std::isnormal(inv) ? inv : NAN};
  if (x_bf16) {
    return y_bf16 ? launch_typed<__nv_bfloat16, __nv_bfloat16>(
                        *a, x, w, scale, bias, y, q, sc, device, st)
                  : launch_typed<__nv_bfloat16, float>(
                        *a, x, w, scale, bias, y, q, sc, device, st);
  }
  return y_bf16 ? launch_typed<float, __nv_bfloat16>(*a, x, w, scale, bias, y,
                                                     q, sc, device, st)
                : launch_typed<float, float>(*a, x, w, scale, bias, y, q, sc,
                                             device, st);
}

// Host nanoseconds that encoding the tensor maps of a wgmma conv takes (A,
// B and the output y, bfloat16 when y_bf16), the mean of `reps` encodings
// (nothing is launched); negative: the error of the first, negated.
double int8_conv_encode_ns(const Int8ConvArgs* a, const void* q, const void* w,
                           void* y, int y_bf16, int reps) {
  CUtensorMap am, bm, ym;
  const long long m = static_cast<long long>(a->n) * a->oh * a->ow;
  auto encode = [&] {
    const int err = encode_maps(*a, q, w, &am, &bm);
    return err != 0 ? err : encode_output_map(y, y_bf16, a->o, m, &ym);
  };
  const int first = encode();
  if (first != 0) return -static_cast<double>(first);
  const auto start = std::chrono::steady_clock::now();
  for (int i = 0; i < reps; ++i) encode();
  const std::chrono::duration<double, std::nano> took =
      std::chrono::steady_clock::now() - start;
  return took.count() / reps;
}

const char* int8_conv_error_string(int err) {
  if (err == kNoDriverEntry) {
    return "no cuTensorMapEncodeIm2col / cuTensorMapEncodeTiled in "
           "libcuda.so.1";
  }
  if (err >= kEncodeError) {
    using ErrorString = CUresult (*)(CUresult, const char**);
    static const auto error_string = reinterpret_cast<ErrorString>(
        driver_symbol("cuGetErrorString"));
    const char* msg = nullptr;
    if (error_string != nullptr) {
      error_string(static_cast<CUresult>(err - kEncodeError), &msg);
    }
    return msg != nullptr ? msg : "the driver refused a tensor map";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
