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
// classes, bf16) 98.2 MB, 0.0293 ms at 3.35 TB/s. Two designs, picked by
// shape alone (retinanet_torch/ops/topk_kernel.py:topk_design):
//
// "row" (short rows: the top-k over the NMS survivors, 8,000 float32 keys
// a request, k = 100). What bounds it is latency, not bytes (32 KB a row):
// the launch, one read of the row, and the chain of steps and barriers on
// one SM, where each instruction runs in all 32 warps. So one CTA a row
// reads it from global memory once, into registers: kRowItems consecutive
// keys a thread (8 in the kernel for rows of at most 8,192 keys), with
// 16-byte loads when the row is contiguous (C = 1) and aligned, else in
// place at stride C. A row longer than kRowTile = 16,384 keys (only when
// C > 320) is read in tiles of kRowTile, each read again in every pass. A
// thread keeps a mask of its keys that share the prefix resolved so far
// and one of those above it, so that later passes and the compaction
// touch only those.
//   1. Radix select of the k-th value key, kRowDigitBits = 11 bits a pass
//      from the top (3 passes for f32 keys, 2 for 16-bit): a histogram of
//      2,048 bins in shared memory, an atomic a key. A thread sums its
//      bins and zeroes them; the one thread whose bins reach k from the
//      top (a scan of the threads' sums) picks the digit: three barriers a
//      pass, no warp idle in the scan. The passes stop early when the bin
//      found holds exactly the winners still needed.
//   2. The k winners as value key << 32 | ~index into shared memory: the
//      keys above the k-th prefix, and those at it when all of them win,
//      or else the first of the equal keys at it by index; their slots by
//      one scan in index order (tiles, warps, lanes).
//   3. For k <= kRankSortMax = 128 (every config's max_detections), each
//      winner's place is the count of the winners above it, counted by
//      kRankLanes = 8 lanes and summed by shuffles (no barrier; one warp's
//      bitonic network in registers was slower, PERF.md); larger k, a
//      bitonic sort of the CTA in shared memory.
//
// "slab" (long rows: every per-class and global lane). What bounds the
// rows is the bytes, and a CTA a row cannot reach them: its loads are 2
// bytes at a stride of C elements, so a 32-byte sector brings 2 useful
// bytes, and a lane of a few rows leaves most SMs idle. So the slab design
// reads each image's contiguous (N, C) slab whole, with 16-byte loads that
// neighbouring threads take from neighbouring addresses, and spreads every
// row over all the CTAs. It selects on the unique key
//   e = value key << I | (2^I - 1 - index),   I = bit_length(N - 1),
// so that exactly k elements qualify and a compaction may go in any order.
// Two launches a selection:
//   slab_select_kernel, cooperative (one persistent CTA of 512 threads an
//   SM, grid-wide barriers between phases; each CTA owns one contiguous
//   range of the (B, N, C) elements):
//     0. zero the scratch (the wrapper's one torch.empty);
//     then levels, each one read of the slab and one choice:
//     pass: every row still "deep" adds the next D bits of e of the
//       elements that match its prefix into a histogram of the CTA's range
//       in shared memory (16-bit counters two to a word, C x 2^D of them
//       in 160 KB: D = 10 at C = 80, 16 at C = 1; rows for the image's deep
//       rows only; a thread of a one-class lane keeps its run of equal
//       bins in a register before each atomic), flushed into the row's
//       global histogram; every row "ready" writes the elements whose key
//       is at or above its prefix into its candidate buffer, staged in the
//       rest of the shared room (entries of each thread's own, then one
//       shared atomic a candidate and one global atomic a class at a
//       flush). The vectors go to the threads with a stride that is a
//       multiple of C / gcd(C, 8), so a thread meets the same classes in
//       every vector and keeps their rows' tests in registers.
//     choice: a deep row's histogram scanned from the top for the digit
//       where the count reaches k, in two rounds of parallel loads (a warp
//       a row up to 2,048 bins, a CTA a row above). m, the row's elements
//       at or above the new prefix, is known exactly: the row becomes
//       ready when m fits its buffer (capacity, 16,384 keys by default),
//       else it stays deep.
//     A row is usually ready after one level, so the slab is read twice
//     (histogram, then candidates); a row whose buffer would overflow (a
//     row of one value, rows of ties) reads the slab again for the next D
//     bits, at the same speed, until it fits.
//   slab_final_kernel, a CTA a row: radix select over the rest of e inside
//     the row's candidates (11 bits a pass, shared histogram), then the
//     exactly k winners into shared memory and bitonic_sort_desc.
// What bounds it now (H100, PERF.md): the levels' reads run at 1-2 TB/s,
// held by the per-element work of bf16 (a shared atomic an element in the
// histogram level) and by the candidates' staging, and the final kernel
// and the barriers add ~0.1 ms.
// Both designs take any k <= N. The k winners are sorted in shared memory
// up to kSortOnChipMax keys (the next power of two >= k, 8 B each: 128 KB);
// past it (the "wide" launches) they are sorted in a scratch of the
// wrapper's, (rows, next power of two >= k) 64-bit keys, by the same
// bitonic network: the passes of stride under kSortBlock a block of keys at
// a time in shared memory, the others through global memory.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

namespace cg = cooperative_groups;

constexpr int kSortOnChipMax = 16384;  // winners sorted in shared memory
constexpr int kSortBlock = 16384;      // a wide sort's block: 128 KB
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

// ------------------------------------------------------------------ slab

constexpr int kSlabThreads = 512;
constexpr int kSlabWarps = kSlabThreads / 32;
constexpr int kSlabMaxLevels = 16;
constexpr int kSlabStamps = 4 + 2 * kSlabMaxLevels;
constexpr int kFinalBits = 11;
constexpr int kFinalBins = 1 << kFinalBits;
// the shared histogram's budget (C x 2^D 16-bit counters) and the most
// dynamic shared memory a launch asks for (with C <= 320 classes' tests)
constexpr int kSlabHistBytes = 160 * 1024;
constexpr int kSlabMaxClasses = 320;
constexpr int kSlabSmemMax = kSlabHistBytes + kSlabMaxClasses * 24;
// a CTA takes at least this many elements
constexpr long long kSlabMinRange = 32768;
// a chunk holds at most this many anchors, so that no 16-bit counter of
// the shared histogram reaches 65,536
constexpr long long kChunkAnchors = 65528;

enum : uint32_t { kIdle = 0, kDeep = 1, kReady = 2, kDone = 3 };

struct RowState {               // 32 bytes a row
  unsigned long long prefix;    // the top `done` bits of e that k-th has
  uint32_t done;                // bits of e resolved
  uint32_t need;                // winners still to take at the prefix
  uint32_t m;                   // elements whose e is at or above it
  uint32_t state;
  uint32_t cnt;                 // candidates written
  uint32_t pad;
};

struct SlabArgs {
  const void* x;
  long long total;              // B * N * C elements
  uint32_t image;               // N * C
  int batch, n, c, k, drop;
  int vbits, ibits, hbits, capr, levels;
  unsigned long long* buf;      // rows x capr candidates
  uint32_t* ghist;              // rows x 2^hbits
  RowState* rs;
  // rows deep or ready after each level's choice, then rows still deep
  uint32_t* active;             // 2 x kSlabMaxLevels
  unsigned long long* stamps;   // %globaltimer at each phase's end
  unsigned long long* sort_keys;  // rows x sort_cap, k > kSortOnChipMax
  int sort_cap;                 // the next power of two >= k
};

// What every active row of a level shares: the bits resolved (done) and
// the digit's width (dl). kFirst: level 0, every row deep; kNarrow: the
// tests need the 32-bit value key alone; kWide: the 64-bit unique key.
enum : int { kFirst = 0, kNarrow = 1, kWide = 2 };

struct Level {
  int dl;
  uint32_t sv;      // the value key's shift to the prefix (<= 31)
  uint32_t sw;      // the unique key's shift to the prefix
  uint32_t dmask;   // 2^dl - 1
  uint32_t smask;   // 2^(dl-1) - 1: a class's words in the histogram
};

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

template <bool F32>
__device__ __forceinline__ uint32_t key_of(uint32_t bits, int drop) {
  return F32 ? orderable32(bits) : orderable16(bits) >> drop;
}

template <bool F32>
__device__ __forceinline__ uint32_t element_of(const uint4& w, int j) {
  const uint32_t word = j < (F32 ? 1 : 2)   ? w.x
                        : j < (F32 ? 2 : 4) ? w.y
                        : j < (F32 ? 3 : 6) ? w.z
                                            : w.w;
  return F32 ? word : (word >> ((j & 1) << 4)) & 0xFFFFu;
}

template <bool F32>
__device__ __forceinline__ uint32_t scalar_of(const void* x, long long f) {
  return F32 ? __ldg(static_cast<const unsigned int*>(x) + f)
             : __ldg(static_cast<const unsigned short*>(x) + f);
}

__host__ __device__ __forceinline__ int pow2_at_least(int k) {
  int p = 1;
  while (p < k) p <<= 1;
  return p;
}

// Sorts keys[0..k) descending in shared memory, padded with 0 (below every
// real key) to the next power of two: all nthreads threads of the CTA, a
// barrier a stage.
__device__ void bitonic_sort_desc(unsigned long long* keys, int k, int tid,
                                  int nthreads) {
  const int p = pow2_at_least(k);
  for (int i = k + tid; i < p; i += nthreads) keys[i] = 0ull;
  __syncthreads();
  for (int size = 2; size <= p; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = tid; t < p / 2; t += nthreads) {
        const int lo = 2 * t - (t & (stride - 1));
        const int hi = lo + stride;
        const bool descending = (lo & size) == 0;
        const unsigned long long x0 = keys[lo], x1 = keys[hi];
        if ((x0 < x1) == descending) {
          keys[lo] = x1;
          keys[hi] = x0;
        }
      }
      __syncthreads();
    }
  }
}

// The passes of sizes first .. last whose strides are under kSortBlock,
// over keys[0..p) (p a multiple of kSortBlock) in global memory, a block at
// a time in shared memory (sk); descending overall, as bitonic_sort_desc.
__device__ void wide_sort_blocks(unsigned long long* keys,
                                 unsigned long long* sk, int p, int first,
                                 int last, int tid, int nthreads) {
  for (int base = 0; base < p; base += kSortBlock) {
    for (int i = tid; i < kSortBlock; i += nthreads) sk[i] = keys[base + i];
    __syncthreads();
    for (int size = first; size <= last; size <<= 1) {
      for (int stride = (size < kSortBlock ? size : kSortBlock) >> 1;
           stride > 0; stride >>= 1) {
        for (int t = tid; t < kSortBlock / 2; t += nthreads) {
          const int lo = 2 * t - (t & (stride - 1));
          const int hi = lo + stride;
          const bool descending = ((base + lo) & size) == 0;
          const unsigned long long x0 = sk[lo], x1 = sk[hi];
          if ((x0 < x1) == descending) {
            sk[lo] = x1;
            sk[hi] = x0;
          }
        }
        __syncthreads();
      }
    }
    for (int i = tid; i < kSortBlock; i += nthreads) keys[base + i] = sk[i];
    __syncthreads();
  }
}

// bitonic_sort_desc for k > kSortOnChipMax: keys[0..k) in global memory
// (room for the next power of two p), sk kSortBlock keys of shared memory.
// The network is the same; only where each pass runs differs.
__device__ void bitonic_sort_desc_wide(unsigned long long* keys,
                                       unsigned long long* sk, int k,
                                       int tid, int nthreads) {
  const int p = pow2_at_least(k);
  for (int i = k + tid; i < p; i += nthreads) keys[i] = 0ull;
  __syncthreads();
  wide_sort_blocks(keys, sk, p, 2, kSortBlock, tid, nthreads);
  for (int size = 2 * kSortBlock; size <= p; size <<= 1) {
    for (int stride = size >> 1; stride >= kSortBlock; stride >>= 1) {
      for (int t = tid; t < p / 2; t += nthreads) {
        const int lo = 2 * t - (t & (stride - 1));
        const int hi = lo + stride;
        const bool descending = (lo & size) == 0;
        const unsigned long long x0 = keys[lo], x1 = keys[hi];
        if ((x0 < x1) == descending) {
          keys[lo] = x1;
          keys[hi] = x0;
        }
      }
      __syncthreads();
    }
    wide_sort_blocks(keys, sk, p, size, size, tid, nthreads);
  }
}

// A thread's run of equal bins: one atomic when the bin changes.
// PACKED: two 16-bit counters a word, idx = 2 * word + half.
template <bool PACKED>
__device__ __forceinline__ void run_flush(uint32_t* hist, int idx,
                                          uint32_t cnt) {
  if (PACKED) {
    atomicAdd(&hist[idx >> 1], cnt << ((idx & 1) << 4));
  } else {
    atomicAdd(&hist[idx], cnt);
  }
}

template <bool PACKED>
__device__ __forceinline__ void run_add(uint32_t* hist, int& run_idx,
                                        uint32_t& run_cnt, int idx) {
  if (idx == run_idx) {
    ++run_cnt;
    return;
  }
  if (run_cnt) run_flush<PACKED>(hist, run_idx, run_cnt);
  run_idx = idx;
  run_cnt = 1;
}

// The runs' last flush, summed over the warp's lanes of each bin first.
template <bool PACKED>
__device__ __forceinline__ void run_close(uint32_t* hist, int& run_idx,
                                          uint32_t& run_cnt) {
  const int lane = threadIdx.x & 31;
  unsigned pending = __ballot_sync(kFull, run_cnt != 0);
  while (pending) {
    const int src = __ffs(pending) - 1;
    const int idx = __shfl_sync(kFull, run_idx, src);
    const bool mine = run_cnt != 0 && run_idx == idx;
    const uint32_t sum = __reduce_add_sync(kFull, mine ? run_cnt : 0u);
    if (lane == src) run_flush<PACKED>(hist, idx, sum);
    if (mine) run_cnt = 0;
    pending = __ballot_sync(kFull, run_cnt != 0);
  }
  run_idx = -1;
}

// The packed histogram's counter of (deep row hidx of the image, digit):
// the row's 2^(dl-1) words, the pair index XOR-ed with the class's bits
// above the vector, so that the lanes of a warp (neighbouring vectors:
// classes 8 apart in bf16) fall on different banks when their digits
// agree.
template <bool F32>
__device__ __forceinline__ int hist_slot(uint32_t hidx, uint32_t cls,
                                         uint32_t digit, const Level& L) {
  const uint32_t q = ((digit >> 1) ^ (cls >> (F32 ? 2 : 3))) & L.smask;
  return static_cast<int>((((hidx << (L.dl - 1)) + q) << 1) | (digit & 1u));
}

__device__ __forceinline__ void store_candidate(const SlabArgs& a,
                                                uint32_t row,
                                                unsigned long long e) {
  const uint32_t pos = atomicAdd(&a.rs[row].cnt, 1u);
  if (pos < static_cast<uint32_t>(a.capr)) {
    a.buf[static_cast<long long>(row) * a.capr + pos] = e;
  }
}

// The CTA's candidates, staged in shared memory (the room the image's
// deep rows leave of the histogram): each thread has `per` entries of its
// own, so that a candidate costs two shared stores and no atomic while the
// slab streams. `stage_flush` gives each staged candidate its place (a
// shared atomic on its class's count, one global atomic a class) and
// writes it to its row's buffer. A candidate that finds its thread's
// entries full goes to its buffer at once.
struct Stage {
  bool on;
  uint32_t per;
  unsigned long long* e;
  uint32_t* meta;       // class, then rank within the class << 16
  uint32_t* count;      // a class's staged candidates
  uint32_t* base;       // a class's place in its row's buffer
};

__device__ __forceinline__ void add_candidate(const SlabArgs& a,
                                              const Stage& st,
                                              uint32_t& staged,
                                              uint32_t row0, uint32_t cls,
                                              unsigned long long e) {
  if (st.on && staged < st.per) {
    const uint32_t i = threadIdx.x * st.per + staged++;
    st.e[i] = e;
    st.meta[i] = cls;
    return;
  }
  store_candidate(a, row0 + cls, e);
}

// Every thread of the CTA calls it.
__device__ void stage_flush(const SlabArgs& a, const Stage& st,
                            uint32_t& staged, uint32_t row0) {
  const uint32_t first = threadIdx.x * st.per;
  __syncthreads();
  for (uint32_t i = first; i < first + staged; ++i) {
    const uint32_t cls = st.meta[i];
    st.meta[i] = cls | (atomicAdd(&st.count[cls], 1u) << 16);
  }
  __syncthreads();
  for (int cl = threadIdx.x; cl < a.c; cl += kSlabThreads) {
    const uint32_t n = st.count[cl];
    if (n) {
      st.base[cl] = atomicAdd(&a.rs[row0 + cl].cnt, n);
      st.count[cl] = 0u;
    }
  }
  __syncthreads();
  for (uint32_t i = first; i < first + staged; ++i) {
    const uint32_t meta = st.meta[i];
    const uint32_t cls = meta & 0xFFFFu;
    const uint32_t pos = st.base[cls] + (meta >> 16);
    if (pos < static_cast<uint32_t>(a.capr)) {
      a.buf[static_cast<long long>(row0 + cls) * a.capr + pos] = st.e[i];
    }
  }
  staged = 0;
  __syncthreads();
}

template <bool F32>
__device__ __forceinline__ unsigned long long unique_key(const SlabArgs& a,
                                                         uint32_t vkey,
                                                         uint32_t anchor) {
  return (static_cast<unsigned long long>(vkey) << a.ibits) |
         (((1u << a.ibits) - 1u) - anchor);
}

// One element against its row (kind 0 none, 1 deep, 2 ready): a count in
// the histogram (deep, prefix matched) or a candidate (ready, at or above
// the prefix). For the few elements before and after a range's vectors.
template <bool F32, int MODE>
__device__ __forceinline__ void test_element(
    const SlabArgs& a, const Level& L, const Stage& st, uint32_t& staged,
    uint32_t* hist, uint32_t row0, uint32_t vkey, uint32_t anchor,
    uint32_t cls, uint32_t kind, uint32_t hidx, unsigned long long prefix) {
  const unsigned long long e = unique_key<F32>(a, vkey, anchor);
  bool deep_hit = MODE == kFirst, ready_hit = false;
  if (MODE == kNarrow) {
    const uint32_t top = vkey >> L.sv;
    deep_hit = kind == 1u && top == static_cast<uint32_t>(prefix);
    ready_hit = kind == 2u && top >= static_cast<uint32_t>(prefix);
  } else if (MODE == kWide) {
    deep_hit = kind == 1u && (e >> L.sw) == prefix;
    ready_hit = kind == 2u && (e >> L.sw) >= prefix;
  }
  if (deep_hit) {
    const uint32_t digit =
        MODE == kFirst    ? vkey >> (a.vbits - L.dl)
        : MODE == kNarrow ? (vkey >> (L.sv - L.dl)) & L.dmask
                          : static_cast<uint32_t>(e >> (L.sw - L.dl)) &
                                L.dmask;
    const int slot = hist_slot<F32>(hidx, cls, digit, L);
    atomicAdd(&hist[slot >> 1], 1u << ((slot & 1) << 4));
  }
  if (ready_hit) add_candidate(a, st, staged, row0, cls, e);
}

// Elements [c0, c1) of image b. The vectors go to the threads with a
// stride that is a multiple of the class period, so that a thread meets
// the same classes in every vector: what a test needs of an element's row
// (its class, histogram words, prefix) is worked out once a
// chunk and kept in registers, one set a vector slot. The next round's
// loads are in flight while a round is tested.
template <bool F32, int MODE, bool RUNS>
__device__ void visit_range(const SlabArgs& a, const Level& L,
                            const Stage& st, const uint32_t* s_kind,
                            const unsigned long long* s_pref,
                            uint32_t* hist, int b, long long c0,
                            long long c1) {
  constexpr int kVec = F32 ? 4 : 8;
  constexpr int kSize = F32 ? 4 : 2;
  constexpr int kVecLog = F32 ? 2 : 3;
  constexpr int kU = F32 ? 4 : 2;   // 16 elements a thread a round
  using Prefix = typename std::conditional<MODE == kWide, unsigned long long,
                                           uint32_t>::type;
  const int tid = threadIdx.x;
  const uint32_t c = static_cast<uint32_t>(a.c);
  uint32_t staged = 0;
  const long long img0 = static_cast<long long>(b) * a.image;
  const uint32_t row0 = static_cast<uint32_t>(b) * c;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(a.x);
  const long long mis = static_cast<long long>((addr & 15u) / kSize);
  long long f_al = ((c0 + mis + kVec - 1) / kVec) * kVec - mis;
  if (f_al > c1) f_al = c1;
  const uint32_t nv = static_cast<uint32_t>((c1 - f_al) / kVec);
  const long long tail0 = f_al + static_cast<long long>(nv) * kVec;
  int run_idx = -1;
  uint32_t run_cnt = 0;

  // the unaligned head and the tail, fewer than kVec elements each
  if (tid < 2 * kVec) {
    const int part = tid / kVec, i = tid % kVec;
    const long long s = part ? tail0 : c0;
    const long long cnt = part ? c1 - tail0 : f_al - c0;
    if (i < cnt) {
      const uint32_t e = static_cast<uint32_t>(s + i - img0);
      const uint32_t anchor = e / c, cls = e - anchor * c;
      test_element<F32, MODE>(
          a, L, st, staged, hist, row0,
          key_of<F32>(scalar_of<F32>(a.x, s + i), a.drop), anchor, cls,
          MODE == kFirst ? 0u : s_kind[cls] & 3u,
          MODE == kFirst ? cls : s_kind[cls] >> 2,
          MODE == kFirst ? 0ull : s_pref[cls]);
    }
  }

  // the vectors: thread t takes t, t + S, t + 2S, ... (S a multiple of the
  // period P = C / gcd(C, kVec), so its first element's class is fixed)
  uint32_t g = c, r = kVec;
  while (r) {
    const uint32_t t = g % r;
    g = r;
    r = t;
  }
  const uint32_t period = c / g;
  const uint32_t stride = (kSlabThreads / period) * period;
  const uint32_t apr = stride * kVec / c;  // anchors a vector slot moves on
  const bool mine = static_cast<uint32_t>(tid) < stride;
  const uint32_t e0 =
      static_cast<uint32_t>(f_al - img0) + static_cast<uint32_t>(tid) * kVec;
  const uint32_t anchor0 = e0 / c;
  // slot j of a vector: its class, its anchor's offset, its histogram
  // words (base and swizzle), its row's kind and prefix
  uint32_t cls_of[kVec], da_of[kVec], base_of[kVec], swz_of[kVec];
  uint32_t ready_mask = 0, deep_mask = 0;
  Prefix pref[kVec];
  {
    uint32_t cls = e0 - anchor0 * c, da = 0;
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      cls_of[j] = cls;
      da_of[j] = da;
      swz_of[j] = (cls >> kVecLog) & L.smask;
      if (MODE != kFirst) {
        ready_mask |= static_cast<uint32_t>((s_kind[cls] & 3u) == 2u) << j;
        deep_mask |= static_cast<uint32_t>((s_kind[cls] & 3u) == 1u) << j;
        pref[j] = static_cast<Prefix>(s_pref[cls]);
        base_of[j] = (s_kind[cls] >> 2) << (L.dl - 1);
      } else {
        base_of[j] = cls << (L.dl - 1);
      }
      if (++cls == c) {
        cls = 0;
        ++da;
      }
    }
  }
  const uint4* xv = reinterpret_cast<const uint4*>(
      static_cast<const char*>(a.x) + f_al * kSize);
  const uint32_t per_round = stride * kU;
  const uint32_t rounds = (nv + per_round - 1) / per_round;
  uint4 cur[kU], nxt[kU];
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    const uint32_t vi = u * stride + tid;
    cur[u] = mine && vi < nv ? __ldg(xv + vi) : make_uint4(0, 0, 0, 0);
  }
  for (uint32_t rnd = 0; rnd < rounds; ++rnd) {
    if (rnd + 1 < rounds) {
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const uint32_t vi = (rnd + 1) * per_round + u * stride + tid;
        nxt[u] = mine && vi < nv ? __ldg(xv + vi) : make_uint4(0, 0, 0, 0);
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const uint32_t vi = rnd * per_round + u * stride + tid;
      if (!mine || vi >= nv) continue;
      if (MODE == kFirst) {
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          const uint32_t digit =
              key_of<F32>(element_of<F32>(cur[u], j), a.drop) >>
              (a.vbits - L.dl);
          const uint32_t word = base_of[j] + ((digit >> 1) ^ swz_of[j]);
          if (RUNS) {
            run_add<true>(hist, run_idx, run_cnt,
                          static_cast<int>((word << 1) | (digit & 1u)));
          } else {
            atomicAdd(&hist[word], (digit & 1u) ? 0x10000u : 1u);
          }
        }
        continue;
      }
      // every element's tests, a bit each; the rare hits after
      const uint32_t anchor_v = anchor0 + (rnd * kU + u) * apr;
      uint32_t ready_hits = 0, deep_hits = 0;
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const uint32_t vkey =
            key_of<F32>(element_of<F32>(cur[u], j), a.drop);
        if (MODE == kNarrow) {
          const uint32_t top = vkey >> L.sv;
          const uint32_t p = static_cast<uint32_t>(pref[j]);
          ready_hits |= static_cast<uint32_t>(top >= p) << j;
          deep_hits |= static_cast<uint32_t>(top == p) << j;
        } else {
          const unsigned long long top =
              unique_key<F32>(a, vkey, anchor_v + da_of[j]) >> L.sw;
          ready_hits |= static_cast<uint32_t>(top >= pref[j]) << j;
          deep_hits |= static_cast<uint32_t>(top == pref[j]) << j;
        }
      }
      ready_hits &= ready_mask;
      deep_hits &= deep_mask;
      if (deep_hits) {
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          if (!((deep_hits >> j) & 1u)) continue;
          const uint32_t vkey =
              key_of<F32>(element_of<F32>(cur[u], j), a.drop);
          const uint32_t digit =
              MODE == kNarrow
                  ? (vkey >> (L.sv - L.dl)) & L.dmask
                  : static_cast<uint32_t>(
                        unique_key<F32>(a, vkey, anchor_v + da_of[j]) >>
                        (L.sw - L.dl)) & L.dmask;
          const uint32_t word = base_of[j] + ((digit >> 1) ^ swz_of[j]);
          if (RUNS) {
            run_add<true>(hist, run_idx, run_cnt,
                          static_cast<int>((word << 1) | (digit & 1u)));
          } else {
            atomicAdd(&hist[word], (digit & 1u) ? 0x10000u : 1u);
          }
        }
      }
      if (ready_hits) {
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          if (!((ready_hits >> j) & 1u)) continue;
          add_candidate(
              a, st, staged, row0, cls_of[j],
              unique_key<F32>(
                  a, key_of<F32>(element_of<F32>(cur[u], j), a.drop),
                  anchor_v + da_of[j]));
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) cur[u] = nxt[u];
    // flush while every thread's entries hold a round's candidates (when
    // a round has more elements than a thread has entries: whenever one
    // is staged)
    const uint32_t gap = kU * kVec < st.per ? kU * kVec : st.per;
    if (st.on && __syncthreads_or(staged + gap > st.per)) {
      stage_flush(a, st, staged, row0);
    }
  }
  if (st.on) stage_flush(a, st, staged, row0);
  if (RUNS) run_close<true>(hist, run_idx, run_cnt);
}

// One level's read of the slab by this CTA: its range, cut at images and
// at kChunkAnchors.
// Exclusive prefix sum of v over the slab CTA (its warp sums in
// warp_sums, kSlabWarps of them).
__device__ __forceinline__ uint32_t slab_block_scan(uint32_t v,
                                                   uint32_t* warp_sums) {
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
    uint32_t s = lane < kSlabWarps ? warp_sums[lane] : 0u;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t t = __shfl_up_sync(kFull, s, o);
      if (lane >= o) s += t;
    }
    if (lane < kSlabWarps) warp_sums[lane] = s;
  }
  __syncthreads();
  const uint32_t base = warp ? warp_sums[warp - 1] : 0u;
  __syncthreads();  // warp_sums is written again by the next call
  return base + inc - v;
}

template <bool F32, int MODE>
__device__ void slab_pass(const SlabArgs& a, const Level& L, uint32_t* hist,
                          uint32_t* s_kind, unsigned long long* s_pref,
                          uint32_t* s_deep_cls, uint32_t* warp_sums,
                          Stage st) {
  const int tid = threadIdx.x;
  const long long per =
      ((a.total + gridDim.x - 1) / gridDim.x + 63) / 64 * 64;
  const long long lo = static_cast<long long>(blockIdx.x) * per;
  const long long hi = lo + per < a.total ? lo + per : a.total;
  const uint32_t room = (static_cast<uint32_t>(a.c) << a.hbits) >> 1;
  for (long long s0 = lo; s0 < hi;) {
    const int b = static_cast<int>(s0 / a.image);
    const long long img_end =
        (static_cast<long long>(b) + 1) * a.image < hi
            ? (static_cast<long long>(b) + 1) * a.image
            : hi;
    // the image's rows: deep ones get histogram rows (hidx, in class
    // order), and the stage takes the rest of the room
    int deeps = a.c, readies = 0;
    if (MODE != kFirst) {
      uint32_t kind = 0;
      unsigned long long prefix = 0;
      if (tid < a.c) {
        const RowState* rs = &a.rs[b * a.c + tid];
        const uint32_t state = __ldcg(&rs->state);
        kind = state == kDeep ? 1u : (state == kReady ? 2u : 0u);
        prefix = __ldcg(&rs->prefix);
      }
      const uint32_t hidx = slab_block_scan(kind == 1u, warp_sums);
      if (tid < a.c) {
        s_kind[tid] = kind | (hidx << 2);
        s_pref[tid] = prefix;
        if (kind == 1u) s_deep_cls[hidx] = tid;
      }
      deeps = __syncthreads_count(kind == 1u);
      readies = __syncthreads_count(kind == 2u);
    }
    const uint32_t words = static_cast<uint32_t>(deeps) << (L.dl - 1);
    const uint32_t used = (words + 1u) & ~1u;
    st.on = readies > 0;
    st.per = (room - used) * 4u / 12u / kSlabThreads;
    st.e = reinterpret_cast<unsigned long long*>(hist + used);
    st.meta = reinterpret_cast<uint32_t*>(st.e + st.per * kSlabThreads);
    if (deeps || readies) {
      const long long step = kChunkAnchors * a.c;
      for (long long c0 = s0; c0 < img_end; c0 += step) {
        const long long c1 = c0 + step < img_end ? c0 + step : img_end;
        if (deeps) {
          for (uint32_t i = tid; i < words; i += kSlabThreads) hist[i] = 0u;
          __syncthreads();
        }
        if (a.c == 1) {   // a thread's elements share a row: runs
          visit_range<F32, MODE, true>(a, L, st, s_kind, s_pref, hist, b, c0,
                                       c1);
        } else {
          visit_range<F32, MODE, false>(a, L, st, s_kind, s_pref, hist, b,
                                        c0, c1);
        }
        __syncthreads();
        if (deeps) {
          uint32_t* g = a.ghist + (static_cast<size_t>(b) * a.c << a.hbits);
          for (uint32_t i = tid; i < words; i += kSlabThreads) {
            const uint32_t v = hist[i];
            if (!v) continue;
            const uint32_t hidx = i >> (L.dl - 1);
            const uint32_t cl = MODE == kFirst ? hidx : s_deep_cls[hidx];
            const uint32_t q =
                (i & L.smask) ^ ((cl >> (F32 ? 2 : 3)) & L.smask);
            uint32_t* row = g + (static_cast<size_t>(cl) << a.hbits) + 2 * q;
            if (v & 0xFFFFu) atomicAdd(row, v & 0xFFFFu);
            if (v >> 16) atomicAdd(row + 1, v >> 16);
          }
          __syncthreads();
        }
      }
    }
    s0 = img_end;
    __syncthreads();  // the rows' tables are written again
  }
}

// Warp-wide: in bins top, top - 1, ..., top - per + 1 (per <= 128, a
// power of two), with `above0` elements above `top`, the bin where the
// count from the top reaches need. Every lane returns the same.
__device__ __forceinline__ void pick_in_chunk(const uint32_t* h, int top,
                                              int per, uint32_t need,
                                              uint32_t above0,
                                              uint32_t& digit,
                                              uint32_t& above,
                                              uint32_t& count) {
  const int lane = threadIdx.x & 31;
  const int sub = per > 32 ? per / 32 : 1;
  const int mine = top - lane * sub;
  const bool owns = lane * sub < per;
  uint32_t cnt[4] = {0u, 0u, 0u, 0u};
  uint32_t own = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (owns && q < sub) {
      cnt[q] = __ldcg(h + mine - q);
      own += cnt[q];
    }
  }
  uint32_t inc = own;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t t = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += t;
  }
  uint32_t ab = above0 + inc - own;
  const unsigned hit =
      __ballot_sync(kFull, owns && ab < need && need <= ab + own);
  const int src = __ffs(hit) - 1;
  uint32_t d = 0, n = 0;
  if (lane == src) {
    bool found = false;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (q < sub && !found) {
        if (ab + cnt[q] >= need) {
          d = mine - q;
          n = cnt[q];
          found = true;
        } else {
          ab += cnt[q];
        }
      }
    }
  }
  digit = __shfl_sync(kFull, d, src);
  count = __shfl_sync(kFull, n, src);
  above = __shfl_sync(kFull, ab, src);
}

__device__ __forceinline__ void settle_row(const SlabArgs& a, RowState* st,
                                           int dl, uint32_t digit,
                                           uint32_t above, uint32_t count,
                                           uint32_t need, uint32_t* s_misc) {
  const unsigned long long prefix = (__ldcg(&st->prefix) << dl) | digit;
  const uint32_t new_need = need - above;
  const uint32_t m = static_cast<uint32_t>(a.k) - new_need + count;
  const bool deep = m > static_cast<uint32_t>(a.capr);
  st->prefix = prefix;
  st->done = __ldcg(&st->done) + dl;
  st->need = new_need;
  st->m = m;
  st->state = deep ? kDeep : kReady;
  atomicAdd(&s_misc[0], 1u);
  if (deep) atomicAdd(&s_misc[1], 1u);
}

// Every deep row: the digit where the count from the top reaches need, in
// two rounds of parallel loads (chunk sums, then the chosen chunk's bins):
// a warp a row for up to 2,048 bins, a CTA a row above (up to 65,536).
__device__ void slab_choose(const SlabArgs& a, int level, int dl,
                            uint32_t* s_misc) {
  const int tid = threadIdx.x, lane = tid & 31;
  const int rows = a.batch * a.c;
  const int nb = 1 << dl;
  if (tid == 0) s_misc[0] = s_misc[1] = 0u;
  __syncthreads();
  if (nb <= 2048) {
    const int gw = blockIdx.x * kSlabWarps + (tid >> 5);
    const int nw = gridDim.x * kSlabWarps;
    const int per = nb >= 32 ? nb / 32 : 1;
    const int owners = nb / per;
    for (int r = gw; r < rows; r += nw) {
      RowState* st = &a.rs[r];
      const uint32_t state = __ldcg(&st->state);
      if (state == kReady) {
        if (lane == 0) st->state = kDone;
        continue;
      }
      if (state != kDeep) continue;
      uint32_t* h = a.ghist + (static_cast<size_t>(r) << a.hbits);
      const int top = nb - 1 - lane * per;
      uint32_t own = 0;
      if (lane < owners) {
        if (per >= 4) {
          const uint4* hv = reinterpret_cast<const uint4*>(h + top - per + 1);
#pragma unroll 4
          for (int q = 0; q < per / 4; ++q) {
            const uint4 v = __ldcg(hv + q);
            own += v.x + v.y + v.z + v.w;
          }
        } else {
          for (int j = 0; j < per; ++j) own += __ldcg(h + top - j);
        }
      }
      uint32_t inc = own;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const uint32_t t = __shfl_up_sync(kFull, inc, o);
        if (lane >= o) inc += t;
      }
      const uint32_t need = __ldcg(&st->need);
      const uint32_t above = inc - own;
      const unsigned hit = __ballot_sync(
          kFull, lane < owners && above < need && need <= inc);
      const int src = __ffs(hit) - 1;
      uint32_t digit, ab, count;
      pick_in_chunk(h, __shfl_sync(kFull, top, src), per, need,
                    __shfl_sync(kFull, above, src), digit, ab, count);
      __syncwarp();
      if (lane < owners) {
        if (per >= 4) {
          uint4* hv = reinterpret_cast<uint4*>(h + top - per + 1);
          for (int q = 0; q < per / 4; ++q) hv[q] = make_uint4(0, 0, 0, 0);
        } else {
          for (int j = 0; j < per; ++j) h[top - j] = 0u;
        }
      }
      if (lane == 0) settle_row(a, st, dl, digit, ab, count, need, s_misc);
    }
  } else {
    const int per = nb / kSlabThreads;  // 8 to 128
    uint32_t* warp_sums = s_misc + 4;
    for (int r = blockIdx.x; r < rows; r += gridDim.x) {
      RowState* st = &a.rs[r];
      const uint32_t state = __ldcg(&st->state);
      if (state == kReady) {
        if (tid == 0) st->state = kDone;
        continue;
      }
      if (state != kDeep) continue;
      uint32_t* h = a.ghist + (static_cast<size_t>(r) << a.hbits);
      const int top = nb - 1 - tid * per;
      const uint4* hv = reinterpret_cast<const uint4*>(h + top - per + 1);
      uint32_t own = 0;
#pragma unroll 4
      for (int q = 0; q < per / 4; ++q) {
        const uint4 v = __ldcg(hv + q);
        own += v.x + v.y + v.z + v.w;
      }
      const uint32_t above = slab_block_scan(own, warp_sums);
      const uint32_t need = __ldcg(&st->need);
      if (above < need && need <= above + own) {
        s_misc[2] = static_cast<uint32_t>(top);
        s_misc[3] = above;
      }
      __syncthreads();
      if (tid < 32) {
        uint32_t digit, ab, count;
        pick_in_chunk(h, static_cast<int>(s_misc[2]), per, need, s_misc[3],
                      digit, ab, count);
        if (tid == 0) settle_row(a, st, dl, digit, ab, count, need, s_misc);
      }
      __syncthreads();
      uint4* hw = reinterpret_cast<uint4*>(h + top - per + 1);
      for (int q = 0; q < per / 4; ++q) hw[q] = make_uint4(0, 0, 0, 0);
    }
  }
  __syncthreads();
  if (tid == 0) {
    if (s_misc[0]) atomicAdd(&a.active[level], s_misc[0]);
    if (s_misc[1]) atomicAdd(&a.active[kSlabMaxLevels + level], s_misc[1]);
  }
}

__device__ __forceinline__ void grid_barrier() {
  __threadfence();
  cg::this_grid().sync();
}

template <bool F32>
__global__ void __launch_bounds__(kSlabThreads, 1)
    slab_select_kernel(SlabArgs a) {
  extern __shared__ uint32_t slab_smem[];
  __shared__ uint32_t s_misc[4 + kSlabWarps];
  // s_pref (C x 8 bytes), s_kind, the deep rows' classes, the stage's
  // counts and bases (C x 4 bytes each, rounded to 16), then the room of
  // the histogram and the stage
  const int c4 = (a.c + 3) & ~3;
  unsigned long long* s_pref = reinterpret_cast<unsigned long long*>(slab_smem);
  uint32_t* s_kind = slab_smem + 2 * a.c;
  uint32_t* s_deep_cls = s_kind + c4;
  Stage st;
  st.on = false;
  st.count = s_deep_cls + c4;
  st.base = st.count + c4;
  uint32_t* hist = st.base + c4;
  const int tid = threadIdx.x;
  const bool stamp = blockIdx.x == 0 && tid == 0;
  const int rows = a.batch * a.c;
  const bool start_deep = a.n > a.capr;
  if (stamp) a.stamps[0] = global_ns();
  for (int cl = tid; cl < a.c; cl += kSlabThreads) st.count[cl] = 0u;

  // 0. the scratch
  {
    const long long gtid = static_cast<long long>(blockIdx.x) * kSlabThreads
                           + tid;
    const long long nthreads =
        static_cast<long long>(gridDim.x) * kSlabThreads;
    uint4* gh = reinterpret_cast<uint4*>(a.ghist);
    const long long hv = (static_cast<long long>(rows) << a.hbits) / 4;
    for (long long i = gtid; i < hv; i += nthreads) {
      gh[i] = make_uint4(0, 0, 0, 0);
    }
    for (long long r = gtid; r < rows; r += nthreads) {
      RowState st;
      st.prefix = 0ull;
      st.done = 0u;
      st.need = static_cast<uint32_t>(a.k);
      st.m = static_cast<uint32_t>(a.n);
      st.state = start_deep ? kDeep : kReady;
      st.cnt = 0u;
      st.pad = 0u;
      a.rs[r] = st;
    }
    if (blockIdx.x == 0) {
      for (int i = tid; i < 2 * kSlabMaxLevels; i += kSlabThreads) {
        a.active[i] = 0u;
      }
      for (int i = tid + 1; i < kSlabStamps; i += kSlabThreads) {
        a.stamps[i] = i == kSlabStamps - 2 ? ~0ull : 0ull;
      }
    }
  }
  grid_barrier();
  if (stamp) a.stamps[1] = global_ns();

  const int vw = a.vbits + a.ibits;
  for (int level = 0; level < a.levels; ++level) {
    // every row active in this level has resolved the same bits
    int done = start_deep ? level * a.hbits : 0;
    done = done < vw ? done : vw;
    int dl = vw - done;
    dl = dl > a.hbits ? a.hbits : (dl < 1 ? 1 : dl);
    const bool has_deep =
        start_deep &&
        (level == 0 || __ldcg(&a.active[kSlabMaxLevels + level - 1]) > 0u);
    Level L;
    L.dl = dl;
    L.sv = done < a.vbits ? a.vbits - done : 0u;
    if (L.sv > 31u) L.sv = 31u;  // done == 0: the prefix is 0
    L.sw = vw - done;
    L.dmask = (1u << dl) - 1u;
    L.smask = (1u << (dl - 1)) - 1u;
    if (level == 0 && start_deep) {
      slab_pass<F32, kFirst>(a, L, hist, s_kind, s_pref, s_deep_cls,
                             s_misc + 4, st);
    } else if (done <= a.vbits && (!has_deep || done + dl <= a.vbits)) {
      slab_pass<F32, kNarrow>(a, L, hist, s_kind, s_pref, s_deep_cls,
                             s_misc + 4, st);
    } else {
      slab_pass<F32, kWide>(a, L, hist, s_kind, s_pref, s_deep_cls,
                             s_misc + 4, st);
    }
    grid_barrier();
    if (stamp) a.stamps[2 + 2 * level] = global_ns();
    slab_choose(a, level, dl, s_misc);
    grid_barrier();
    if (stamp) a.stamps[3 + 2 * level] = global_ns();
    if (__ldcg(&a.active[level]) == 0u) break;  // the same in every CTA
  }
}

// Block-wide: the digit of hist[0..nb) where the count from the top
// reaches need. Every thread returns the same (digit, above, count).
__device__ void block_pick(const uint32_t* hist, int nb, uint32_t need,
                           uint32_t* warp_sums, uint32_t* out,
                           uint32_t& digit, uint32_t& above,
                           uint32_t& count) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x, nwarps = nthreads >> 5;
  const int per = (nb + nthreads - 1) / nthreads;
  const int top = nb - 1 - tid * per;
  uint32_t own = 0;
  for (int j = 0; j < per && top - j >= 0; ++j) own += hist[top - j];
  uint32_t inc = own;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t t = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += t;
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    uint32_t s = lane < nwarps ? warp_sums[lane] : 0u;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t t = __shfl_up_sync(kFull, s, o);
      if (lane >= o) s += t;
    }
    warp_sums[lane] = s;
  }
  __syncthreads();
  inc += warp ? warp_sums[warp - 1] : 0u;
  uint32_t ab = inc - own;
  if (ab < need && need <= inc) {
    for (int j = 0; j < per && top - j >= 0; ++j) {
      const uint32_t c = hist[top - j];
      if (ab + c >= need) {
        out[0] = top - j;
        out[1] = ab;
        out[2] = c;
        break;
      }
      ab += c;
    }
  }
  __syncthreads();
  digit = out[0];
  above = out[1];
  count = out[2];
  __syncthreads();  // out and warp_sums are written again by the next call
}

// WIDE: the winners sorted in a.sort_keys (k > kSortOnChipMax), the
// shared memory a block of the sort.
template <bool F32, bool WIDE>
__global__ void slab_final_kernel(SlabArgs a, void* __restrict__ out_vals,
                                  int* __restrict__ out_idx) {
  extern __shared__ unsigned long long final_smem[];
  unsigned long long* keys =
      WIDE ? a.sort_keys + static_cast<long long>(blockIdx.x) * a.sort_cap
           : final_smem;  // next power of two >= k
  __shared__ uint32_t hist[kFinalBins];
  __shared__ uint32_t warp_sums[32];
  __shared__ uint32_t picked[3];
  __shared__ uint32_t filled;
  const int tid = threadIdx.x, lane = tid & 31;
  const int nthreads = blockDim.x;
  const int r = blockIdx.x;
  const int k = a.k;
  const int vbits_w = a.vbits + a.ibits;
  if (tid == 0) {
    atomicMin(&a.stamps[kSlabStamps - 2], global_ns());
    filled = 0u;
  }
  __syncthreads();
  const RowState st = a.rs[r];
  const uint32_t m =
      st.cnt < static_cast<uint32_t>(a.capr) ? st.cnt : a.capr;
  const unsigned long long* cand =
      a.buf + static_cast<long long>(r) * a.capr;
  unsigned long long prefix = st.prefix;
  uint32_t done = st.done, need = st.need;
  uint32_t bin_count = m - (static_cast<uint32_t>(k) - need);

  // 1. radix select over the rest of e, inside the candidates
  while (bin_count != need && done < static_cast<uint32_t>(vbits_w)) {
    int dl = vbits_w - static_cast<int>(done);
    dl = dl > kFinalBits ? kFinalBits : dl;
    const int nb = 1 << dl;
    for (int i = tid; i < nb; i += nthreads) hist[i] = 0u;
    __syncthreads();
    const int shift = vbits_w - static_cast<int>(done);
    int run_idx = -1;
    uint32_t run_cnt = 0;
    // four loads in flight a thread
    for (uint32_t i0 = tid; i0 < m; i0 += 4 * nthreads) {
      unsigned long long e[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint32_t i = i0 + q * nthreads;
        e[q] = i < m ? cand[i] : 0ull;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (i0 + q * nthreads < m && (e[q] >> shift) == prefix) {
          run_add<false>(hist, run_idx, run_cnt,
                         static_cast<int>((e[q] >> (shift - dl)) & (nb - 1)));
        }
      }
    }
    run_close<false>(hist, run_idx, run_cnt);
    __syncthreads();
    uint32_t digit, above, count;
    block_pick(hist, nb, need, warp_sums, picked, digit, above, count);
    prefix = (prefix << dl) | digit;
    done += dl;
    need -= above;
    bin_count = count;
  }

  // 2. the k winners: e at or above the prefix, exactly k of them
  const unsigned long long thr = prefix << (vbits_w - static_cast<int>(done));
  for (uint32_t i0 = 0; i0 < m; i0 += 4 * nthreads) {
    unsigned long long e[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint32_t i = i0 + q * nthreads + tid;
      e[q] = i < m ? cand[i] : 0ull;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const bool win = i0 + q * nthreads + tid < m && e[q] >= thr;
      const unsigned ballot = __ballot_sync(kFull, win);
      uint32_t base = 0;
      if (lane == 0 && ballot) base = atomicAdd(&filled, __popc(ballot));
      base = __shfl_sync(kFull, base, 0);
      const uint32_t slot = base + __popc(ballot & ((1u << lane) - 1u));
      if (win && slot < static_cast<uint32_t>(k)) keys[slot] = e[q];
    }
  }

  // 3. bitonic sort, descending
  if (WIDE) {
    __syncthreads();  // the winners' global stores are read by the sort
    bitonic_sort_desc_wide(keys, final_smem, k, tid, nthreads);
  } else {
    bitonic_sort_desc(keys, k, tid, nthreads);
  }

  const long long out = static_cast<long long>(r) * k;
  const uint32_t imask = (1u << a.ibits) - 1u;
  for (int j = tid; j < k; j += nthreads) {
    const unsigned long long e = keys[j];
    const uint32_t key = static_cast<uint32_t>(e >> a.ibits);
    out_idx[out + j] = static_cast<int>(imask - static_cast<uint32_t>(e & imask));
    if (F32) {
      static_cast<unsigned int*>(out_vals)[out + j] = unorderable32(key);
    } else {
      static_cast<unsigned short*>(out_vals)[out + j] =
          static_cast<unsigned short>(unorderable16(key << a.drop));
    }
  }
  __syncthreads();
  if (tid == 0) atomicMax(&a.stamps[kSlabStamps - 1], global_ns());
}

// The scratch's layout, in bytes from its start, each part 16-aligned.
struct SlabLayout {
  size_t buf, ghist, rs, active, stamps, total;
};

__host__ SlabLayout slab_layout(long long rows, int hbits, int capr) {
  auto up = [](size_t v) { return (v + 15) / 16 * 16; };
  SlabLayout l;
  l.buf = 0;
  l.ghist = up(l.buf + static_cast<size_t>(rows) * capr * 8);
  l.rs = up(l.ghist + (static_cast<size_t>(rows) << hbits) * 4);
  l.active = up(l.rs + static_cast<size_t>(rows) * sizeof(RowState));
  l.stamps = up(l.active + 2 * kSlabMaxLevels * 4);
  l.total = up(l.stamps + kSlabStamps * 8);
  return l;
}

template <bool F32>
cudaError_t run_slab(SlabArgs a, int device, void* out_vals, int* out_idx,
                     cudaStream_t stream) {
  const size_t c4 = (static_cast<size_t>(a.c) + 3) & ~static_cast<size_t>(3);
  const size_t smem = static_cast<size_t>(a.c) * 8 + 4 * c4 * 4 +
                      ((static_cast<size_t>(a.c) << a.hbits) >> 1) * 4;
  if (smem > static_cast<size_t>(kSlabSmemMax)) return cudaErrorInvalidValue;
  // on the current device, every launch (a process may use several cards)
  cudaError_t err = cudaFuncSetAttribute(
      slab_select_kernel<F32>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSlabSmemMax);
  if (err != cudaSuccess) return err;
  const bool wide = a.k > kSortOnChipMax;
  const int p = pow2_at_least(a.k);
  const size_t final_smem =
      static_cast<size_t>(wide ? kSortBlock : p) * sizeof(unsigned long long);
  const auto final_kernel =
      wide ? slab_final_kernel<F32, true> : slab_final_kernel<F32, false>;
  err = cudaFuncSetAttribute(final_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(final_smem));
  if (err != cudaSuccess) return err;
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, slab_select_kernel<F32>, kSlabThreads, smem);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  long long grid = static_cast<long long>(per_sm) * sms;
  const long long want = (a.total + kSlabMinRange - 1) / kSlabMinRange;
  if (want < grid) grid = want < 1 ? 1 : want;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(slab_select_kernel<F32>),
      dim3(static_cast<unsigned>(grid)), dim3(kSlabThreads), args, smem,
      stream);
  if (err != cudaSuccess) return err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  int threads = p / 2;
  threads = threads < 256 ? 256 : (threads > 1024 ? 1024 : threads);
  final_kernel<<<static_cast<unsigned>(a.batch * a.c), threads, final_smem,
                 stream>>>(a, out_vals, out_idx);
  return cudaGetLastError();
}

// ------------------------------------------------------------------- row

constexpr int kRowThreads = 1024;
constexpr int kRowWarps = kRowThreads / 32;
constexpr int kRowItems = 16;               // the most keys a thread holds
constexpr int kRowTile = kRowThreads * kRowItems;   // a CTA's keys at once
constexpr int kRowDigitBits = 11;
constexpr int kRowBins = 1 << kRowDigitBits;
constexpr int kRowBinsPerThread = kRowBins / kRowThreads;
constexpr int kRankSortMax = 128;                   // k ranked by counting
constexpr int kRankLanes = kRowThreads / kRankSortMax;  // lanes a winner

// A thread's run of tile t: `cnt` keys of the row from index `lo` on, into
// key[0..cnt). 16-byte loads when the row is contiguous and aligned.
template <bool F32, int ITEMS>
__device__ __forceinline__ int row_load(uint32_t (&key)[ITEMS],
                                        const void* x, long long base, int c,
                                        int drop, bool vec, long long lo,
                                        long long hi, int per) {
  constexpr int V = F32 ? 4 : 8;
  long long left = hi - lo;
  const int cnt = left <= 0 ? 0 : (left < per ? static_cast<int>(left) : per);
#pragma unroll
  for (int v = 0; v < ITEMS / V; ++v) {
    if (v * V < cnt) {
      if (vec && v * V + V <= cnt) {
        const long long f = base + lo + v * V;
        const uint4 w = __ldg(reinterpret_cast<const uint4*>(
            static_cast<const char*>(x) + f * (F32 ? 4 : 2)));
#pragma unroll
        for (int q = 0; q < V; ++q) {
          key[v * V + q] = key_of<F32>(element_of<F32>(w, q), drop);
        }
      } else {
#pragma unroll
        for (int q = 0; q < V; ++q) {
          if (v * V + q < cnt) {
            key[v * V + q] = key_of<F32>(
                scalar_of<F32>(x, base + (lo + v * V + q) * c), drop);
          }
        }
      }
    }
  }
  return cnt;
}

template <bool F32>
__device__ __forceinline__ void row_write(unsigned long long e, long long at,
                                          int drop, void* out_vals,
                                          int* out_idx) {
  const uint32_t key = static_cast<uint32_t>(e >> 32);
  out_idx[at] = static_cast<int>(0xFFFFFFFFu - static_cast<uint32_t>(e));
  if (F32) {
    static_cast<unsigned int*>(out_vals)[at] = unorderable32(key);
  } else {
    static_cast<unsigned short*>(out_vals)[at] =
        static_cast<unsigned short>(unorderable16(key << drop));
  }
}

// The "row" design: a row of the (B, N, C) input on one CTA, in registers,
// up to ITEMS consecutive keys a thread. A thread keeps two masks over its
// keys: `live`, those that share the prefix resolved so far, and `win`,
// those above it.
// WIDE: the winners in sort_keys (the row's next power of two >= k of
// them, k > kSortOnChipMax), the shared memory a block of their sort.
template <bool F32, int ITEMS, bool WIDE>
__global__ void __launch_bounds__(kRowThreads, 1)
    row_select_kernel(const void* __restrict__ x, int n, int c, int k,
                      int drop, void* __restrict__ out_vals,
                      int* __restrict__ out_idx,
                      unsigned long long* __restrict__ sort_keys) {
  extern __shared__ unsigned long long row_smem[];
  unsigned long long* keys =
      WIDE ? sort_keys + static_cast<long long>(blockIdx.x) * pow2_at_least(k)
           : row_smem;  // the k winners
  __shared__ uint4 hist_words[kRowBins / 4];
  __shared__ uint32_t wtot[kRowWarps];          // a warp's bins
  __shared__ uint32_t etot[2][kRowWarps];       // a warp's ties, by tile
  __shared__ uint32_t sel[3];                   // a pass's digit, count, need
  uint32_t* hist = reinterpret_cast<uint32_t*>(hist_words);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned row = blockIdx.x;
  // (image, class) of the row; no division for a row a whole image
  const unsigned img = c == 1 ? row : row / static_cast<unsigned>(c);
  const long long base = static_cast<long long>(img) * n * c + (row - img * c);
  const int key_bits = F32 ? 32 : 16 - drop;
  constexpr int V = F32 ? 4 : 8;

  // the row's tiles, the keys a thread holds
  const int tiles = (n + kRowTile - 1) / kRowTile;
  const int first = min(n, kRowTile);
  const int per = ((first + kRowThreads - 1) / kRowThreads + V - 1) / V * V;
  const bool vec =
      c == 1 && ((reinterpret_cast<uintptr_t>(x) + base * (F32 ? 4 : 2)) &
                 15u) == 0;
  auto run_lo = [&](int t) {
    return static_cast<long long>(t) * kRowTile +
           static_cast<long long>(tid) * per;
  };
  auto run_hi = [&](int t) {
    return min(static_cast<long long>(n),
               static_cast<long long>(t + 1) * kRowTile);
  };

  uint32_t key[ITEMS];
  uint32_t live = 0, win = 0;
  uint32_t prefix = 0, pmask = 0;
  // a tile read again: its masks from the prefix resolved so far
  auto load = [&](int t) {
    const int cnt = row_load<F32, ITEMS>(key, x, base, c, drop, vec,
                                         run_lo(t), run_hi(t), per);
    live = win = 0;
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const uint32_t kp = key[j] & pmask;
      if (j < cnt) {
        live |= static_cast<uint32_t>(kp == prefix) << j;
        win |= static_cast<uint32_t>(kp > prefix) << j;
      }
    }
  };
  if (tiles == 1) load(0);
  for (int i = tid; i < kRowBins / 4; i += kRowThreads) {
    hist_words[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();

  // 1. radix select, kRowDigitBits a pass from the top. The resolved bits
  // are pmask; prefix holds the k-th key's; need: winners still to take
  // among the keys that share it, count: how many do.
  uint32_t need = static_cast<uint32_t>(k), count = 0, digit = 0;
  int top = key_bits;
  for (;;) {
    const int shift = top > kRowDigitBits ? top - kRowDigitBits : 0;
    const uint32_t dmask = (1u << (top - shift)) - 1u;
    for (int t = 0; t < tiles; ++t) {
      if (tiles > 1) load(t);
      if (live) {
#pragma unroll
        for (int j = 0; j < ITEMS; ++j) {
          if ((live >> j) & 1u) {
            atomicAdd(&hist[(key[j] >> shift) & dmask], 1u);
          }
        }
      }
    }
    __syncthreads();
    // a thread's kRowBinsPerThread bins, from the top, zeroed for the next
    // pass by their one reader; the bins above them in its warp by a scan
    const int b0 = kRowBins - 1 - kRowBinsPerThread * tid;
    uint32_t v[kRowBinsPerThread], own = 0;
#pragma unroll
    for (int q = 0; q < kRowBinsPerThread; ++q) {
      v[q] = hist[b0 - q];
      own += v[q];
    }
#pragma unroll
    for (int q = 0; q < kRowBinsPerThread; ++q) hist[b0 - q] = 0u;
    uint32_t inc = own;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t u = __shfl_up_sync(kFull, inc, o);
      if (lane >= o) inc += u;
    }
    if (lane == 31) wtot[warp] = inc;
    __syncthreads();
    // the one thread whose bins reach need from the top picks the digit
    const uint32_t wt = lane < kRowWarps ? wtot[lane] : 0u;
    uint32_t above = __reduce_add_sync(kFull, lane < warp ? wt : 0u) + inc -
                     own;
    if (above < need && need <= above + own) {
#pragma unroll
      for (int q = 0; q < kRowBinsPerThread; ++q) {
        if (above < need && need <= above + v[q]) {
          sel[0] = b0 - q;
          sel[1] = v[q];
          sel[2] = need - above;
        }
        above += v[q];
      }
    }
    __syncthreads();
    digit = sel[0];
    count = sel[1];
    need = sel[2];
    prefix |= digit << shift;
    pmask |= dmask << shift;
    // a resident row's masks: its live keys above the digit win, those
    // off the digit drop out
    if (tiles == 1 && live) {
#pragma unroll
      for (int j = 0; j < ITEMS; ++j) {
        if ((live >> j) & 1u) {
          const uint32_t bin = (key[j] >> shift) & dmask;
          win |= static_cast<uint32_t>(bin > digit) << j;
          if (bin != digit) live &= ~(1u << j);
        }
      }
    }
    top = shift;
    if (top == 0 || count == need) break;
  }

  // 2. the k winners into shared memory as value key << 32 | ~index. The
  // keys above the prefix (win), and those at it (live) when all of them
  // win, in any order (the sort orders them); otherwise the live keys are
  // equal and the lower indices win. Slots of both by one scan in index
  // order (the tiles, the warps, the lanes), the two counts packed in one
  // word.
  const bool ordered = count != need;
  const uint32_t above = static_cast<uint32_t>(k) - need;
  uint32_t gt_base = 0, eq_base = 0;
  for (int t = 0; t < tiles; ++t) {
    if (tiles > 1) load(t);
    const long long lo = run_lo(t);
    const uint32_t ng = __popc(win) + (ordered ? 0u : __popc(live));
    const uint32_t ne = ordered ? __popc(live) : 0u;
    const uint32_t pk = ng | (ne << 16);
    uint32_t inc = pk;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t u = __shfl_up_sync(kFull, inc, o);
      if (lane >= o) inc += u;
    }
    if (lane == 31) etot[t & 1][warp] = inc;
    __syncthreads();
    const uint32_t mine = lane < kRowWarps ? etot[t & 1][lane] : 0u;
    const uint32_t pre =
        __reduce_add_sync(kFull, lane < warp ? mine : 0u) + inc - pk;
    const uint32_t total = __reduce_add_sync(kFull, mine);
    uint32_t gslot = gt_base + (pre & 0xFFFFu);
    uint32_t eslot = eq_base + (pre >> 16);
    gt_base += total & 0xFFFFu;
    eq_base += total >> 16;
    const uint32_t taken = win | live;
    if (taken) {
#pragma unroll
      for (int j = 0; j < ITEMS; ++j) {
        if ((taken >> j) & 1u) {
          const unsigned long long e =
              (static_cast<unsigned long long>(key[j]) << 32) |
              (0xFFFFFFFFu - static_cast<uint32_t>(lo + j));
          if (((win >> j) & 1u) || !ordered) {
            keys[gslot++] = e;
          } else {
            if (eslot < need) keys[above + eslot] = e;
            ++eslot;
          }
        }
      }
    }
  }
  __syncthreads();

  // 3. the k winners sorted, descending, and written
  const long long out = static_cast<long long>(row) * k;
  if (k <= kRankSortMax) {
    // a winner's place: the winners above it (the keys are unique),
    // counted by kRankLanes lanes, each over every kRankLanes-th winner
    if (warp * 32 >= k * kRankLanes) return;
    const int i = tid / kRankLanes, sub = tid % kRankLanes;
    const unsigned long long mine = i < k ? keys[i] : ~0ull;
    int pos = 0;
    for (int j = sub; j < k; j += kRankLanes) pos += keys[j] > mine;
#pragma unroll
    for (int o = kRankLanes / 2; o > 0; o >>= 1) {
      pos += __shfl_xor_sync(kFull, pos, o);
    }
    if (i < k && sub == 0) {
      row_write<F32>(mine, out + pos, drop, out_vals, out_idx);
    }
    return;
  }
  if (WIDE) {
    bitonic_sort_desc_wide(keys, row_smem, k, tid, kRowThreads);
  } else {
    bitonic_sort_desc(keys, k, tid, kRowThreads);
  }
  for (int j = tid; j < k; j += kRowThreads) {
    row_write<F32>(keys[j], out + j, drop, out_vals, out_idx);
  }
}

template <bool F32, int ITEMS>
cudaError_t launch_row(const void* x, long long rows, int n, int c, int k,
                       int drop, void* out_vals, int* out_idx,
                       unsigned long long* sort_keys, cudaStream_t stream) {
  const int p = pow2_at_least(k);
  const bool wide = sort_keys != nullptr;
  const size_t smem = static_cast<size_t>(wide ? kSortBlock : p) *
                      sizeof(unsigned long long);
  const auto kernel = wide ? row_select_kernel<F32, ITEMS, true>
                           : row_select_kernel<F32, ITEMS, false>;
  // on the current device, every launch (a process may use several cards)
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(rows), kRowThreads, smem, stream>>>(
      x, n, c, k, drop, out_vals, out_idx, sort_keys);
  return cudaGetLastError();
}

// A row of at most kRowThreads * kRowItems / 2 keys takes the kernel of
// kRowItems / 2 keys a thread.
template <bool F32>
cudaError_t run_row(const void* x, long long rows, int n, int c, int k,
                    int drop, void* out_vals, int* out_idx,
                    unsigned long long* sort_keys, cudaStream_t stream) {
  constexpr int V = F32 ? 4 : 8;
  const long long first = n < kRowTile ? n : kRowTile;
  const long long per = ((first + kRowThreads - 1) / kRowThreads + V - 1) /
                        V * V;
  return per <= kRowItems / 2
             ? launch_row<F32, kRowItems / 2>(x, rows, n, c, k, drop,
                                              out_vals, out_idx, sort_keys,
                                              stream)
             : launch_row<F32, kRowItems>(x, rows, n, c, k, drop, out_vals,
                                          out_idx, sort_keys, stream);
}

// The row design with its winners sorted in sort_keys (null: in shared
// memory, k <= kSortOnChipMax).
int rows_launch(const void* x, int batch, int n, int c, int k, int mode,
                int drop, void* out_vals, int* out_idx, void* sort_keys,
                int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (k < 1 || k > n || mode < 0 || mode > 2 ||
      (sort_keys == nullptr) != (k <= kSortOnChipMax)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long rows = static_cast<long long>(batch) * c;
  if (rows >= (1ll << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* keys = static_cast<unsigned long long*>(sort_keys);
  err = mode == 2 ? run_row<true>(x, rows, n, c, k, drop, out_vals, out_idx,
                                  keys, s)
                  : run_row<false>(x, rows, n, c, k, drop, out_vals, out_idx,
                                   keys, s);
  return static_cast<int>(err);
}

int slab_launch(const void* x, int batch, int n, int c, int k, int mode,
                int drop, int hbits, int capr, int levels, void* scratch,
                long long scratch_bytes, void* out_vals, int* out_idx,
                void* sort_keys, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows = static_cast<long long>(batch) * c;
  const SlabLayout l = slab_layout(rows, hbits, capr);
  if (k < 1 || k > n || mode < 0 || mode > 2 || c < 1 ||
      c > kSlabMaxClasses || hbits < 1 || hbits > 16 || capr < k ||
      capr > n || levels < 1 || levels > kSlabMaxLevels ||
      (static_cast<long long>(c) << hbits) * 2 > kSlabHistBytes ||
      static_cast<long long>(n) * c >= (1ll << 31) || rows >= (1ll << 31) ||
      scratch_bytes < static_cast<long long>(l.total) ||
      (reinterpret_cast<uintptr_t>(scratch) & 15u) != 0 ||
      (sort_keys == nullptr) != (k <= kSortOnChipMax)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int ibits = 1;
  while (ibits < 31 && (1ll << ibits) < n) ++ibits;
  char* base = static_cast<char*>(scratch);
  SlabArgs a;
  a.x = x;
  a.total = rows * n;
  a.image = static_cast<uint32_t>(static_cast<long long>(n) * c);
  a.batch = batch;
  a.n = n;
  a.c = c;
  a.k = k;
  a.drop = mode == 0 ? drop : 0;
  a.vbits = mode == 2 ? 32 : 16 - a.drop;
  a.ibits = ibits;
  a.hbits = hbits < a.vbits ? hbits : a.vbits;
  a.capr = capr;
  a.levels = levels;
  a.buf = reinterpret_cast<unsigned long long*>(base + l.buf);
  a.ghist = reinterpret_cast<uint32_t*>(base + l.ghist);
  a.rs = reinterpret_cast<RowState*>(base + l.rs);
  a.active = reinterpret_cast<uint32_t*>(base + l.active);
  a.stamps = reinterpret_cast<unsigned long long*>(base + l.stamps);
  a.sort_keys = static_cast<unsigned long long*>(sort_keys);
  a.sort_cap = pow2_at_least(k);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = mode == 2 ? run_slab<true>(a, device, out_vals, out_idx, s)
                  : run_slab<false>(a, device, out_vals, out_idx, s);
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// The row design: one launch on `stream` (a cudaStream_t); returns
// cudaGetLastError(), or the error of the set-up calls; the caller raises
// when it is not 0.
// mode: 0 packed, 1 bf16, 2 f32. x is (batch, n, c), contiguous; out_vals
// and out_idx are (batch, c, k). k <= kSortOnChipMax.
int topk_rows_launch(const void* x, int batch, int n, int c, int k, int mode,
                     int drop, void* out_vals, int* out_idx, int device,
                     void* stream) {
  return rows_launch(x, batch, n, c, k, mode, drop, out_vals, out_idx,
                     nullptr, device, stream);
}

// The same for k > kSortOnChipMax: sort_keys holds batch * c times the next
// power of two >= k 64-bit keys.
int topk_rows_wide_launch(const void* x, int batch, int n, int c, int k,
                          int mode, int drop, void* out_vals, int* out_idx,
                          void* sort_keys, int device, void* stream) {
  return rows_launch(x, batch, n, c, k, mode, drop, out_vals, out_idx,
                     sort_keys, device, stream);
}

// The row design's constants, for the wrapper's copy of them: kRowThreads,
// kRowItems, kRowDigitBits, kRankSortMax, kRankLanes.
void topk_row_constants(int* out) {
  out[0] = kRowThreads;
  out[1] = kRowItems;
  out[2] = kRowDigitBits;
  out[3] = kRankSortMax;
  out[4] = kRankLanes;
}

// The final sort's constants: kSortOnChipMax, kSortBlock.
void topk_sort_constants(int* out) {
  out[0] = kSortOnChipMax;
  out[1] = kSortBlock;
}

// Bytes of the slab design's scratch for these rows (the wrapper allocates
// them with one torch.empty; the kernel zeroes what it needs).
long long topk_slab_scratch_bytes(int batch, int c, int hbits, int capr) {
  return static_cast<long long>(
      slab_layout(static_cast<long long>(batch) * c, hbits, capr).total);
}

// The slab design: two launches on `stream`, as topk_rows_launch.
// hbits: D, the bits of a pass's digit; capr: a row's candidate buffer
// (min(capacity, n), at least k); levels: the most reads of the slab.
// k <= kSortOnChipMax.
int topk_slab_launch(const void* x, int batch, int n, int c, int k, int mode,
                     int drop, int hbits, int capr, int levels,
                     void* scratch, long long scratch_bytes, void* out_vals,
                     int* out_idx, int device, void* stream) {
  return slab_launch(x, batch, n, c, k, mode, drop, hbits, capr, levels,
                     scratch, scratch_bytes, out_vals, out_idx, nullptr,
                     device, stream);
}

// The same for k > kSortOnChipMax, with sort_keys as in
// topk_rows_wide_launch.
int topk_slab_wide_launch(const void* x, int batch, int n, int c, int k,
                          int mode, int drop, int hbits, int capr,
                          int levels, void* scratch, long long scratch_bytes,
                          void* out_vals, int* out_idx, void* sort_keys,
                          int device, void* stream) {
  return slab_launch(x, batch, n, c, k, mode, drop, hbits, capr, levels,
                     scratch, scratch_bytes, out_vals, out_idx, sort_keys,
                     device, stream);
}

const char* topk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
