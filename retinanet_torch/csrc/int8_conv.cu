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
// Three designs, picked by the wrapper from the shape alone
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
//   * "mma_sync", dense convs with C <= 16 (the stem, C = 3): the input is
//     quantized into (N, H, W, ceil(C / 4)) int32 words, then an implicit
//     GEMM with mma.sync m16n8k32: one CTA of 8 warps a 128 x 128 tile,
//     stages of 16 words (64 int8 terms) copied with cp.async two deep
//     (the gather zero-fills the padding), K-major rows padded against
//     bank conflicts. Its taps are 4 bytes: the wgmma design would copy 49
//     taps of 32-byte rows a stem tile, and runs the stem 3.3x slower
//     (tools/int8_conv_experiments.py); this one beats cuDNN bf16 there;
//   * "depthwise": one thread an output element, channels fastest, a loop
//     over the kh * kw taps, int32 multiply-adds.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include <atomic>
#include <chrono>
#include <cmath>
#include <cstring>

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
};

namespace {

constexpr int kBM = 128;       // mma_sync: output pixels a CTA
constexpr int kBN = 128;       // mma_sync: output channels a CTA
constexpr int kBK = 16;        // mma_sync: 32-bit words of K a stage
constexpr int kPad = 4;        // mma_sync: words of padding a smem row
constexpr int kThreads = 256;  // mma_sync: 8 warps, 2 x 4, each 64 x 32
constexpr int kDwThreads = 256;
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

enum Design { kDepthwise = 0, kMmaSync = 1, kWgmma = 2 };

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
// two deep, so that the next stage's copies run under this stage's MMAs.
// VEC8: ceil(C / 4) % 8 == 0, so the 8 words a thread copies for a stage
// lie in one tap and are 32-byte aligned (two 16-byte copies); otherwise
// one 4-byte copy a word.
template <typename TOut, bool VEC8>
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
    if constexpr (VEC8) {
      const int tap = k / cw;
      const int ih = ih0 + tap / s.kw;
      const int iw = iw0 + tap % s.kw;
      const bool read = m_ok && k < k_words && ih >= 0 && ih < s.h &&
                        iw >= 0 && iw < s.w;
      const int* src =
          read ? q_img + (static_cast<long long>(ih) * s.w + iw) * cw +
                     (k - tap * cw)
               : q;
      copy16(a_dst, src, read);
      copy16(a_dst + 4, src + (read ? 4 : 0), read);
    } else {
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

template <typename TIn, typename TOut>
__global__ void __launch_bounds__(kDwThreads)
    int8_conv_depthwise_kernel(const TIn* __restrict__ x,
                               const int8_t* __restrict__ w,
                               const float* __restrict__ scale,
                               const float* __restrict__ bias,
                               TOut* __restrict__ y, Scale sc,
                               Int8ConvArgs s) {
  const long long total =
      static_cast<long long>(s.n) * s.oh * s.ow * s.c;
  for (long long idx = blockIdx.x * static_cast<long long>(blockDim.x) +
                       threadIdx.x;
       idx < total; idx += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int ch = static_cast<int>(idx % s.c);
    const long long m = idx / s.c;
    const int ow = static_cast<int>(m % s.ow);
    const long long t = m / s.ow;
    const int oh = static_cast<int>(t % s.oh);
    const int img = static_cast<int>(t / s.oh);
    const TIn* x_img = x + static_cast<long long>(img) * s.h * s.w * s.c;
    const int ih0 = oh * s.stride - s.pad_t;
    const int iw0 = ow * s.stride - s.pad_l;
    int acc = 0;
    for (int r = 0; r < s.kh; ++r) {
      const int ih = ih0 + r;
      if (ih < 0 || ih >= s.h) continue;
      for (int q = 0; q < s.kw; ++q) {
        const int iw = iw0 + q;
        if (iw < 0 || iw >= s.w) continue;
        const int xq = quantize(
            to_float(x_img[(static_cast<long long>(ih) * s.w + iw) * s.c +
                           ch]),
            sc);
        acc += xq * static_cast<int>(w[(r * s.kw + q) * s.c + ch]);
      }
    }
    float v = __fmul_rn(__int2float_rn(acc), scale[ch]);
    if (bias != nullptr) v = __fadd_rn(v, bias[ch]);
    store(y + idx, v);
  }
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
  if (cw % 8 == 0) {
    int8_conv_gemm_kernel<TOut, true><<<grid, kThreads, 0, stream>>>(
        qt, static_cast<const int*>(w), scale, bias, y, a, a.k_pad);
  } else {
    int8_conv_gemm_kernel<TOut, false><<<grid, kThreads, 0, stream>>>(
        qt, static_cast<const int*>(w), scale, bias, y, a, a.k_pad);
  }
  return static_cast<int>(cudaGetLastError());
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
    case kDepthwise: {
      const long long total =
          static_cast<long long>(a.n) * a.oh * a.ow * a.c;
      long long blocks = (total + kDwThreads - 1) / kDwThreads;
      if (blocks > 132 * 64) blocks = 132 * 64;  // grid-stride beyond that
      int8_conv_depthwise_kernel<TIn, TOut>
          <<<static_cast<unsigned>(blocks), kDwThreads, 0, stream>>>(
              xt, static_cast<const int8_t*>(w), scale, bias, yt, sc, a);
      return static_cast<int>(cudaGetLastError());
    }
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
// w * ceil(c / 4) int32 words for mma_sync (unused when depthwise).
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
