// Top-k selection over the rows of a (B, N, C) tensor, for Hopper (sm_90a).
//
// Replaces no Pallas kernel. It replaces two XLA paths of the JAX package:
// approx_max_k_packed / lax.approx_max_k (the default serving lane,
// retinanet_tpu/ops/postprocess.py:54) and lax.top_k (the exact lane, the
// skip_nms export lane, the top-k over the NMS survivors). The function is
// that of the plain PyTorch version retinanet_torch/ops/topk.py:
// top_k_rows_plain, bit for bit: for each row (b, c), the elements
// x[b, 0..N-1, c], the k largest keys (value key, then the lower index),
// in descending key order, with the value each key keeps. Value keys:
//   packed: orderable_u16(bf16) >> drop   (drop 0 or 1, from N)
//   bf16:   orderable_u16(bf16)
//   f32:    orderable_u32(float)          (the floats' total order)
//
// Bound on an H100: one read of the rows, B * N * C * itemsize bytes, plus
// the outputs; at the flagship's batch 8 (N = 76,725 anchors, C = 80
// classes, bf16) 98.2 MB, 0.0293 ms at 3.35 TB/s.
//
// Design, simple and right first. One CTA of 1024 threads a row; the row
// is read in place (element stride C), so that neither the (B, C, N)
// transpose nor a float32 copy of the bf16 lane is made. The CTAs of one
// image read the same sectors at about the same time, so the strided
// reads are served by L2 more than by device memory.
//   1. Radix select of the k-th value key, 8 bits a pass from the top (2
//      passes for bf16 keys, 4 for f32): a histogram of the elements that
//      share the prefix found so far, in shared memory (warp-aggregated
//      atomics, so that a row of equal values does not serialise on one
//      bin), then one warp finds the bin where the count from the top
//      reaches k. After the last pass T is the k-th value key and `need`
//      the number of elements with key T to take.
//   2. One ordered compaction pass: chunks of 1024 elements in index
//      order, a block scan of (key > T, key == T); every element above T
//      and the first `need` elements equal to T (the lower indices) go to
//      shared memory as 64-bit keys (value key << 32 | ~index). The pass
//      ends once all of them are found.
//   3. A bitonic sort of those k keys (padded to a power of two with 0,
//      below every real key), descending, in shared memory; the keys
//      unpack into the index and the value.
// k is at most 8192 (64 KB of shared memory).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 8192;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t orderable16(uint32_t bits) {
  return (bits & 0x8000u) ? (~bits & 0xFFFFu) : (bits | 0x8000u);
}

__device__ __forceinline__ uint32_t unorderable16(uint32_t code) {
  return (code & 0x8000u) ? (code & 0x7FFFu) : (~code & 0xFFFFu);
}

__device__ __forceinline__ uint32_t orderable32(uint32_t bits) {
  return (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
}

__device__ __forceinline__ uint32_t unorderable32(uint32_t code) {
  return (code & 0x80000000u) ? (code & 0x7FFFFFFFu) : ~code;
}

template <bool F32>
__device__ __forceinline__ uint32_t value_key(const void* x, long long off,
                                              int drop) {
  if (F32) {
    return orderable32(__ldg(static_cast<const unsigned int*>(x) + off));
  }
  return orderable16(__ldg(static_cast<const unsigned short*>(x) + off)) >>
         drop;
}

// Exclusive block-wide prefix sum of v; *total gets the sum over the block.
__device__ __forceinline__ uint32_t block_exclusive_scan(uint32_t v,
                                                         uint32_t* warp_sums,
                                                         uint32_t* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t t = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += t;
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    uint32_t s = warp_sums[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t t = __shfl_up_sync(kFull, s, o);
      if (lane >= o) s += t;
    }
    warp_sums[lane] = s;
  }
  __syncthreads();
  const uint32_t base = warp ? warp_sums[warp - 1] : 0u;
  *total = warp_sums[kWarps - 1];
  __syncthreads();  // warp_sums is written again by the next call
  return base + inc - v;
}

template <bool F32>
__global__ void __launch_bounds__(kThreads)
    topk_rows_kernel(const void* __restrict__ x, int n, int c, int k,
                     int drop, void* __restrict__ out_vals,
                     int* __restrict__ out_idx) {
  extern __shared__ unsigned long long keys[];  // next power of two >= k
  __shared__ uint32_t hist[256];
  __shared__ uint32_t warp_sums[kWarps];
  __shared__ uint32_t sel_digit, sel_need;

  const int tid = threadIdx.x, lane = tid & 31;
  const long long row = blockIdx.x;
  const long long b = row / c, col = row % c;
  const long long base = b * static_cast<long long>(n) * c + col;
  const int key_bits = F32 ? 32 : 16;

  // 1. radix select of the k-th value key
  uint32_t prefix = 0, prefix_mask = 0, need = static_cast<uint32_t>(k);
  for (int shift = key_bits - 8; shift >= 0; shift -= 8) {
    for (int i = tid; i < 256; i += kThreads) hist[i] = 0;
    __syncthreads();
    // every lane of a warp takes the same number of turns
    for (int i = tid; i - lane < n; i += kThreads) {
      const bool valid = i < n;
      uint32_t key = 0;
      if (valid) key = value_key<F32>(x, base + static_cast<long long>(i) * c,
                                      drop);
      const bool take = valid && (key & prefix_mask) == prefix;
      const unsigned takers = __ballot_sync(kFull, take);
      if (take) {
        const uint32_t bin = (key >> shift) & 255u;
        const unsigned peers = __match_any_sync(takers, bin);
        if (lane == __ffs(peers) - 1) atomicAdd(&hist[bin], __popc(peers));
      }
    }
    __syncthreads();
    if (tid < 32) {
      // lane l owns bins 255 - 8l down to 248 - 8l
      uint32_t own = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) own += hist[255 - 8 * lane - j];
      uint32_t inc = own;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const uint32_t t = __shfl_up_sync(kFull, inc, o);
        if (lane >= o) inc += t;
      }
      uint32_t above = inc - own;  // elements in the bins above lane's own
      if (above < need && need <= inc) {
        for (int j = 0; j < 8; ++j) {
          const uint32_t bin = 255 - 8 * lane - j;
          if (above + hist[bin] >= need) {
            sel_digit = bin;
            sel_need = need - above;
            break;
          }
          above += hist[bin];
        }
      }
    }
    __syncthreads();
    prefix |= sel_digit << shift;
    prefix_mask |= 255u << shift;
    need = sel_need;
    __syncthreads();  // sel_* and hist are written again in the next pass
  }
  const uint32_t kth = prefix;
  const uint32_t above_count = static_cast<uint32_t>(k) - need;

  // 2. ordered compaction of the k winners
  uint32_t gt_base = 0, eq_base = 0;
  for (int i0 = 0; i0 < n; i0 += kThreads) {
    const int i = i0 + tid;
    uint32_t key = 0, gt = 0, eq = 0;
    if (i < n) {
      key = value_key<F32>(x, base + static_cast<long long>(i) * c, drop);
      gt = key > kth;
      eq = key == kth;
    }
    uint32_t total;
    const uint32_t pre = block_exclusive_scan(gt | (eq << 16), warp_sums,
                                              &total);
    const unsigned long long packed =
        (static_cast<unsigned long long>(key) << 32) |
        (0xFFFFFFFFu - static_cast<uint32_t>(i));
    if (gt) keys[gt_base + (pre & 0xFFFFu)] = packed;
    if (eq) {
      const uint32_t slot = eq_base + (pre >> 16);
      if (slot < need) keys[above_count + slot] = packed;
    }
    gt_base += total & 0xFFFFu;
    eq_base += total >> 16;
    if (gt_base == above_count && eq_base >= need) break;  // block-uniform
  }

  // 3. bitonic sort of the k keys, descending
  int p = 1;
  while (p < k) p <<= 1;
  for (int i = k + tid; i < p; i += kThreads) keys[i] = 0ull;
  __syncthreads();
  for (int size = 2; size <= p; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = tid; t < p / 2; t += kThreads) {
        const int lo = 2 * t - (t & (stride - 1));
        const int hi = lo + stride;
        const bool descending = (lo & size) == 0;
        const unsigned long long a = keys[lo], e = keys[hi];
        if ((a < e) == descending) {
          keys[lo] = e;
          keys[hi] = a;
        }
      }
      __syncthreads();
    }
  }

  const long long out = row * k;
  for (int j = tid; j < k; j += kThreads) {
    const unsigned long long e = keys[j];
    const uint32_t key = static_cast<uint32_t>(e >> 32);
    out_idx[out + j] =
        static_cast<int>(0xFFFFFFFFu - static_cast<uint32_t>(e));
    if (F32) {
      static_cast<unsigned int*>(out_vals)[out + j] = unorderable32(key);
    } else {
      static_cast<unsigned short*>(out_vals)[out + j] =
          static_cast<unsigned short>(unorderable16(key << drop));
    }
  }
}

template <bool F32>
cudaError_t run(const void* x, long long rows, int n, int c, int k, int drop,
                void* out_vals, int* out_idx, cudaStream_t stream) {
  int p = 1;
  while (p < k) p <<= 1;
  const size_t smem = static_cast<size_t>(p) * sizeof(unsigned long long);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        topk_rows_kernel<F32>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  topk_rows_kernel<F32><<<static_cast<unsigned>(rows), kThreads, smem,
                          stream>>>(x, n, c, k, drop, out_vals, out_idx);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` (a cudaStream_t) and returns cudaGetLastError(), or
// the error of the set-up calls; the caller raises when it is not 0.
// mode: 0 packed, 1 bf16, 2 f32. x is (batch, n, c), contiguous; out_vals
// and out_idx are (batch, c, k).
int topk_rows_launch(const void* x, int batch, int n, int c, int k, int mode,
                     int drop, void* out_vals, int* out_idx, int device,
                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (k < 1 || k > kMaxK || k > n || mode < 0 || mode > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long rows = static_cast<long long>(batch) * c;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = mode == 2
            ? run<true>(x, rows, n, c, k, drop, out_vals, out_idx, s)
            : run<false>(x, rows, n, c, k, drop, out_vals, out_idx, s);
  return static_cast<int>(err);
}

const char* topk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
