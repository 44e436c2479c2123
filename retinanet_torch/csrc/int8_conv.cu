// Real int8 convolution of the int8-activation serving lane, for Hopper
// (sm_90a).
//
// Replaces the XLA path of retinanet_tpu/export/quantize.py:100
// (make_int8_conv_interceptor, real_int8=True): per-tensor int8 activations
// against per-output-channel int8 weights, lax.conv_general_dilated with
// preferred_element_type=int32, then float32 requantization plus bias. No
// Pallas kernel did this on the TPU (the MXU took s8 x s8 -> s32 from XLA);
// stock PyTorch has no CUDA int8 convolution, so the port writes it.
//
// Same function as the plain PyTorch version
// retinanet_torch/ops/int8_conv.py:int8_conv2d_plain, bit for bit:
//   q   = clamp(rint(x / s_a), -127, 127)          per input element;
//   acc = sum over (kh, kw, c) of q * w, in int32   exact in any order;
//   y   = float(acc) * scale[o] (+ bias[o])         two roundings, then a
//                                                   cast to float32/bf16.
// Every step is an explicit _rn intrinsic (__fdiv_rn, __int2float_rn,
// __fmul_rn, __fadd_rn, __float2bfloat16_rn), so nvcc neither turns the
// division into a multiply by the reciprocal nor contracts the epilogue
// into an FMA. The caller bounds kh * kw * C * 127^2 below 2^31.
//
// Layouts: x is NHWC (float32 or bfloat16), y is NHWC with O channels.
// Dense weights (groups 1) are packed once, when the lane is built, as
// (O, K_pad) int32 words: for each output channel its kh * kw * ceil(C / 4)
// words in (tap, channel) order, four input channels a word, then zeros up
// to a multiple of 16 words (the channels past C and the words past K are
// zero, which is exact: a zero weight adds nothing). Depthwise weights
// (groups = C = O) are (kh * kw, C) int8.
//
// Bound. The flagship's int8 convs do about 75 GMAC a 640^2 image: 0.08 ms
// at the 1,979 int8 TOPS of the tensor cores. Activations and weights are a
// few MB a conv, so most dense convs are bound by operations; the stem and
// the strided 1x1 projections, with few terms a sum, by bytes.
//
// Design (right and simple first; wgmma / TMA is later work):
//   * dense, two kernels on the caller's stream: (1) the input quantized
//     once into (N, H, W, ceil(C / 4)) int32 words (scratch of the
//     wrapper's), each element divided once; (2) an implicit GEMM, M = N *
//     OH * OW output pixels by O output channels by K words, on the tensor
//     cores with mma.sync m16n8k32 (s8 x s8 -> s32). One CTA of 8 warps a
//     128 x 128 tile of (pixels, channels), each warp 64 x 32 (4 x 4
//     fragments); a stage is 16 words (64 int8 terms) of K of both operands,
//     copied into shared memory with cp.async two stages deep (the gather
//     of the input windows zero-fills the padding), K-major with rows
//     padded so that the fragment loads hit 32 banks; the epilogue
//     requantizes. A first version quantized inside the GEMM's gather and
//     divided each element up to kh * kw * ceil(O / 128) times: the
//     divisions, not the MMAs, set its pace (PERF.md);
//   * depthwise: one thread an output element, channels fastest, a loop
//     over the kh * kw taps, int32 multiply-adds.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;       // output pixels a CTA
constexpr int kBN = 128;       // output channels a CTA
constexpr int kBK = 16;        // 32-bit words of K a stage (64 int8 terms)
constexpr int kPad = 4;        // words of padding a shared-memory row
constexpr int kThreads = 256;  // 8 warps, 2 x 4, each 64 x 32 outputs
constexpr int kDwThreads = 256;
constexpr int kQuantThreads = 256;

struct Shape {
  int n, h, w, c;      // input, NHWC
  int oh, ow, o;       // output
  int kh, kw, stride;  // window
  int pad_t, pad_l;    // padding before each axis (the rest is implied)
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

// clamp(rint(v / s_a), -127, 127) as an int: rint rounds half to even, as
// torch.round and jnp.round do.
__device__ __forceinline__ int quantize(float v, float s_a) {
  const float q = rintf(__fdiv_rn(v, s_a));
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
                                         float s_a) {
  if constexpr (VEC) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    return pack4(quantize(v.x, s_a), quantize(v.y, s_a), quantize(v.z, s_a),
                 quantize(v.w, s_a));
  } else {
    int q[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) q[j] = j < left ? quantize(p[j], s_a) : 0;
    return pack4(q[0], q[1], q[2], q[3]);
  }
}

template <bool VEC>
__device__ __forceinline__ int load_word(const __nv_bfloat16* p, int left,
                                         float s_a) {
  if constexpr (VEC) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
    return pack4(quantize(__low2float(lo), s_a),
                 quantize(__high2float(lo), s_a),
                 quantize(__low2float(hi), s_a),
                 quantize(__high2float(hi), s_a));
  } else {
    int q[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      q[j] = j < left ? quantize(__bfloat162float(p[j]), s_a) : 0;
    }
    return pack4(q[0], q[1], q[2], q[3]);
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
// to four elements.
template <typename TIn, bool VEC>
__global__ void __launch_bounds__(kQuantThreads)
    quantize_words_kernel(const TIn* __restrict__ x, int* __restrict__ q,
                          float s_a, long long words, int c, int cw) {
  for (long long idx = blockIdx.x * static_cast<long long>(blockDim.x) +
                       threadIdx.x;
       idx < words; idx += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long pixel = idx / cw;
    const int ch = static_cast<int>(idx - pixel * cw) * 4;
    q[idx] = load_word<VEC>(x + pixel * c + ch, c - ch, s_a);
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
                          TOut* __restrict__ y, Shape s, int k_pad) {
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

  copy_stage(0, 0);
  int buf = 0;
  for (int k0 = 0; k0 < k_pad; k0 += kBK) {
    if (k0 + kBK < k_pad) {
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

template <typename TIn, typename TOut>
__global__ void __launch_bounds__(kDwThreads)
    int8_conv_depthwise_kernel(const TIn* __restrict__ x,
                               const int8_t* __restrict__ w,
                               const float* __restrict__ scale,
                               const float* __restrict__ bias,
                               TOut* __restrict__ y, float s_a, Shape s) {
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
            s_a);
        acc += xq * static_cast<int>(w[(r * s.kw + q) * s.c + ch]);
      }
    }
    float v = __fmul_rn(__int2float_rn(acc), scale[ch]);
    if (bias != nullptr) v = __fadd_rn(v, bias[ch]);
    store(y + idx, v);
  }
}

template <typename TIn, typename TOut>
cudaError_t launch_typed(const void* x, const void* w, const float* scale,
                         const float* bias, void* y, void* q, float s_a,
                         const Shape& s, bool depthwise,
                         cudaStream_t stream) {
  const TIn* xt = static_cast<const TIn*>(x);
  TOut* yt = static_cast<TOut*>(y);
  if (depthwise) {
    const long long total =
        static_cast<long long>(s.n) * s.oh * s.ow * s.c;
    long long blocks = (total + kDwThreads - 1) / kDwThreads;
    if (blocks > 132 * 64) blocks = 132 * 64;  // grid-stride beyond that
    int8_conv_depthwise_kernel<TIn, TOut>
        <<<static_cast<unsigned>(blocks), kDwThreads, 0, stream>>>(
            xt, static_cast<const int8_t*>(w), scale, bias, yt, s_a, s);
    return cudaGetLastError();
  }
  // 1. the quantized words of the whole input, once
  const int cw = (s.c + 3) / 4;
  const long long words = static_cast<long long>(s.n) * s.h * s.w * cw;
  long long blocks = (words + kQuantThreads - 1) / kQuantThreads;
  if (blocks > 132 * 64) blocks = 132 * 64;  // grid-stride beyond that
  int* qt = static_cast<int*>(q);
  if (s.c % 4 == 0 &&
      reinterpret_cast<uintptr_t>(x) % (4 * sizeof(TIn)) == 0) {
    quantize_words_kernel<TIn, true>
        <<<static_cast<unsigned>(blocks), kQuantThreads, 0, stream>>>(
            xt, qt, s_a, words, s.c, cw);
  } else {
    quantize_words_kernel<TIn, false>
        <<<static_cast<unsigned>(blocks), kQuantThreads, 0, stream>>>(
            xt, qt, s_a, words, s.c, cw);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // 2. the implicit GEMM on the tensor cores
  const long long m_total = static_cast<long long>(s.n) * s.oh * s.ow;
  const dim3 grid(static_cast<unsigned>((m_total + kBM - 1) / kBM),
                  static_cast<unsigned>((s.o + kBN - 1) / kBN));
  const int k_pad = (s.kh * s.kw * cw + kBK - 1) / kBK * kBK;
  if (cw % 8 == 0) {
    int8_conv_gemm_kernel<TOut, true><<<grid, kThreads, 0, stream>>>(
        qt, static_cast<const int*>(w), scale, bias, yt, s, k_pad);
  } else {
    int8_conv_gemm_kernel<TOut, false><<<grid, kThreads, 0, stream>>>(
        qt, static_cast<const int*>(w), scale, bias, yt, s, k_pad);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches one convolution on `stream` (a cudaStream_t) and returns
// cudaGetLastError(), or the error of cudaSetDevice; the caller raises when
// it is not 0. x and y are NHWC; `x_bf16` / `y_bf16` pick bfloat16 over
// float32. `bias` may be null. `w` is packed as the header says. `q` is
// scratch for the quantized input of a dense conv, n * h * w_in *
// ceil(c / 4) int32 words, 16-byte aligned (unused when depthwise).
int int8_conv_launch(const void* x, int x_bf16, const void* w,
                     const float* scale, const float* bias, void* y,
                     int y_bf16, void* q, float s_a, int n, int h, int w_in,
                     int c,
                     int oh, int ow, int o, int kh, int kw, int stride,
                     int pad_t, int pad_l, int depthwise, int device,
                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Shape s{n, h, w_in, c, oh, ow, o, kh, kw, stride, pad_t, pad_l};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    err = y_bf16 ? launch_typed<__nv_bfloat16, __nv_bfloat16>(
                       x, w, scale, bias, y, q, s_a, s, depthwise, st)
                 : launch_typed<__nv_bfloat16, float>(
                       x, w, scale, bias, y, q, s_a, s, depthwise, st);
  } else {
    err = y_bf16 ? launch_typed<float, __nv_bfloat16>(
                       x, w, scale, bias, y, q, s_a, s, depthwise, st)
                 : launch_typed<float, float>(x, w, scale, bias, y, q, s_a,
                                              s, depthwise, st);
  }
  return static_cast<int>(err);
}

const char* int8_conv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
