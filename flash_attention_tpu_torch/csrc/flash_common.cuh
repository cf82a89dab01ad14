// Pieces shared by the port's flash-attention kernels (flash_fwd.cu and the
// three backward kernels flash_bwd_{di,dq,dkv}.cu) and its matmul kernels
// (gmm.cu, gmm_dw.cu, qmm.cu): the fp32-pair packing for bf16 and fp16, the
// accumulator-to-A-fragment packing, the attention band's open side, the
// segment metadata of a segmented launch, and the error-string export.
//
// Fragment layouts of mma.m16n8k16 (g = lane / 4, t = lane % 4), which the
// wgmma accumulator and register-A layouts repeat per 16-row warp slice:
//   A (16 x 16, row-major): a0 = (g, 2t..2t+1), a1 = (g + 8, 2t..),
//                           a2 = (g, 2t + 8..),  a3 = (g + 8, 2t + 8..)
//   B (16 x 8, k x n):      b0 = (k = 2t..2t+1, n = g), b1 = (k = 2t + 8.., n = g)
//   C (16 x 8, fp32):       c0, c1 = (g, 2t..2t+1), c2, c3 = (g + 8, 2t..2t+1)
// Two adjacent C tiles of one row block form one A fragment (pack_a), so a
// product's result feeds the next product without leaving the registers.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <climits>
#include <stdint.h>

namespace fat {

constexpr float LOG2E = 1.4426950408889634f;

// An open side of an attention band (left or right): far past any offset,
// and small enough that a row index plus it stays inside an int. The C
// interfaces take < 0 for an open side; band_side maps it here.
constexpr int UNBOUNDED = 1 << 30;
inline int band_side(int x) { return x < 0 ? UNBOUNDED : x; }

// A segmented launch (packed batches, varlen): each token's segment id and
// position, q_seg and q_pos (b, sq), kv_seg and kv_pos (b, sk), and the
// range [lo, hi] of streamed blocks that each owned block may see, lo and hi
// (b, owned blocks), all int32 on the device (ops/segments.py computes the
// ranges at the kernel's tiles). A query sees a key of its own id whose
// kv_pos - q_pos lies in the band; the pad ids below match nothing. The
// dense instances take a zeroed Seg and never read it.
struct Seg {
  const int* q_seg;
  const int* kv_seg;
  const int* q_pos;
  const int* kv_pos;
  const int* lo;
  const int* hi;
};
constexpr int Q_PAD_SEG = -2;
constexpr int KV_PAD_SEG = -1;

// A group of tokens of a segmented launch (a warp's 16 query rows or keys,
// or a streamed tile), summarised: whether all carry one id, that id, and
// their least and greatest positions. Four ints, as the producers store it
// beside a tile in shared memory.
struct SegSpan {
  int uniform, seg, pos_min, pos_max;
};

// The SegSpan of the tokens a warp holds, each lane's folded into its least
// and greatest id and position first. Every lane of the warp takes part.
__device__ __forceinline__ SegSpan seg_span(int seg_min, int seg_max,
                                            int pos_min, int pos_max) {
  const int lo = __reduce_min_sync(0xffffffff, seg_min);
  const int hi = __reduce_max_sync(0xffffffff, seg_max);
  return {lo == hi, lo, __reduce_min_sync(0xffffffff, pos_min),
          __reduce_max_sync(0xffffffff, pos_max)};
}

// A producer warp's share of a streamed tile's ids and positions: columns
// k * 32 + lane of the tile of n tokens at token t0 (the pad id past n),
// read from global memory ahead of the stage they go to.
template <int PER>
__device__ __forceinline__ void seg_fetch(const int* seg, const int* pos,
                                          int t0, int n, int pad, int lane,
                                          int (&ids)[PER], int (&pss)[PER]) {
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int t = t0 + k * 32 + lane;
    ids[k] = t < n ? seg[t] : pad;
    pss[k] = t < n ? pos[t] : 0;
  }
}

// The tile's span from the warp's shares (every lane takes part).
template <int PER>
__device__ __forceinline__ SegSpan seg_span_of(const int (&ids)[PER],
                                               const int (&pss)[PER]) {
  int s_lo = INT_MAX, s_hi = INT_MIN, p_lo = INT_MAX, p_hi = INT_MIN;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    s_lo = min(s_lo, ids[k]), s_hi = max(s_hi, ids[k]);
    p_lo = min(p_lo, pss[k]), p_hi = max(p_hi, pss[k]);
  }
  return seg_span(s_lo, s_hi, p_lo, p_hi);
}

// The warp's shares and the span into a stage's slot: ids[n], positions[n],
// then the span.
template <int PER>
__device__ __forceinline__ void seg_store(int* meta, const int (&ids)[PER],
                                          const int (&pss)[PER],
                                          const SegSpan& span, int lane) {
  constexpr int N = PER * 32;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    meta[k * 32 + lane] = ids[k];
    meta[N + k * 32 + lane] = pss[k];
  }
  if (lane == 0) *reinterpret_cast<SegSpan*>(meta + 2 * N) = span;
}

// Whether every (query, key) pair of two groups is live: one id on both
// sides and every kv_pos - q_pos inside [-left, right]. Then a tile needs no
// mask: the segmented kernels' interior tiles.
__device__ __forceinline__ bool seg_all_live(const SegSpan& q,
                                             const SegSpan& k, int left,
                                             int right) {
  return q.uniform && k.uniform && q.seg == k.seg &&
         k.pos_max - q.pos_min <= right && k.pos_min - q.pos_max >= -left;
}

// The Seg of a C interface's argument: null (a dense launch) or a host array
// of the six device pointers in the order of Seg's fields.
inline Seg seg_arg(const void* p) {
  Seg s{};
  if (p) {
    const unsigned long long* a = static_cast<const unsigned long long*>(p);
    s = {reinterpret_cast<const int*>(a[0]), reinterpret_cast<const int*>(a[1]),
         reinterpret_cast<const int*>(a[2]), reinterpret_cast<const int*>(a[3]),
         reinterpret_cast<const int*>(a[4]), reinterpret_cast<const int*>(a[5])};
  }
  return s;
}

template <typename T>
struct Mma;

template <>
struct Mma<__nv_bfloat16> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

template <>
struct Mma<__half> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

// An accumulator of N fp32 columns in the C layout (N / 2 a thread), rounded
// to T, as the A fragments of N / 16 k16 steps: 8-column blocks 2 kk and
// 2 kk + 1 form step kk.
template <typename T, int N>
__device__ __forceinline__ void pack_a(uint32_t (&a)[N / 16][4],
                                       const float (&x)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      a[kk][e] = Mma<T>::pack(x[8 * kk + 2 * e], x[8 * kk + 2 * e + 1]);
}

}  // namespace fat

extern "C" const char* fat_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
