// The forward kernels' online softmax, shared by flash_fwd.cu (d 64, 128
// and 256) and flash_fwd_wide.cu (d 384 and 512): what a consumer thread
// knows of its two rows (the band, the scale, the softcap; with SEG its
// rows' segment ids and positions), a raw score into the log2 domain, and
// one kv tile's masked online softmax on the wgmma accumulator.

#pragma once

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

// What the softmax needs to know of this thread's rows.
struct Rows {
  int row[2];  // the thread's two rows, g and g + 8 of its warp's 16
  int w0;      // the warp's first row
  int t;       // thread in its row group of 4
  int sk, off, left, right;  // the band (fat::UNBOUNDED for an open side)
  float scale_log2;
  float cap_scale, cap_log2;  // scale / cap and cap log2(e), with CAP
};

// SEG: the segment ids and positions of the thread's two rows, and the
// span of its warp's 16.
struct SegRows {
  int seg[2], pos[2];
  fat::SegSpan warp;
};

// A raw score in the log2 domain: scaled, or with CAP softcapped first.
template <bool CAP>
__device__ __forceinline__ float to_log2(float s, const Rows& rw) {
  if constexpr (CAP) return rw.cap_log2 * hop::tanh_exp2(s * rw.cap_scale);
  return s * rw.scale_log2;
}

// The online softmax of the tile at kv column n0 on the thread's two rows (4
// threads share a row): S is scaled into the log2 domain and rounded, masked
// only where the tile crosses an edge of the band (or sk) for this warp, and
// turned into P in place. m and l move on; alpha is the factor that rescales
// O. O itself is not touched (P(j - 1) V(j - 1) may still be running on it).
// SEG masks by the tile's ids and positions in ``meta``, every element of a
// tile unless all its pairs with the warp's rows are live (its span in
// ``meta``, fat::seg_all_live).
template <bool CAP, bool SEG, int BN>
__device__ __forceinline__ void softmax_tile(float (&sc)[BN / 2],
                                             float (&m_r)[2], float (&l_r)[2],
                                             float (&alpha)[2], int n0,
                                             const Rows& rw, const SegRows& sr,
                                             const int* meta) {
  const bool edge = (n0 + BN > rw.sk) ||
                    (n0 + BN - 1 > rw.w0 + rw.off + rw.right) ||
                    (n0 < rw.w0 + 15 + rw.off - rw.left);
  if constexpr (SEG) {
    if (fat::seg_all_live(sr.warp,
                          *reinterpret_cast<const fat::SegSpan*>(meta + 2 * BN),
                          rw.left, rw.right)) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) sc[i] = to_log2<CAP>(sc[i], rw);
    } else {
#pragma unroll
      for (int nn = 0; nn < BN / 8; ++nn) {
        // this thread's two columns of 8-column block nn
        const int c = nn * 8 + rw.t * 2;
        const int2 ks = *reinterpret_cast<const int2*>(meta + c);
        const int2 kp = *reinterpret_cast<const int2*>(meta + BN + c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * nn + e, r = e >> 1;
          const int rel = (e & 1 ? kp.y : kp.x) - sr.pos[r];
          const bool live = (e & 1 ? ks.y : ks.x) == sr.seg[r] &&
                            rel >= -rw.left && rel <= rw.right;
          sc[i] = live ? to_log2<CAP>(sc[i], rw) : -CUDART_INF_F;
        }
      }
    }
  } else if (edge) {
    // live columns [lo, hi) of each row, counted from this thread's first
    // column
    int lo[2], hi[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      hi[r] = min(rw.sk, rw.row[r] + rw.off + rw.right + 1) - n0 - rw.t * 2;
      lo[r] = rw.row[r] + rw.off - rw.left - n0 - rw.t * 2;
    }
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const float x = to_log2<CAP>(sc[i], rw);
      const int c = (i / 4) * 8 + (i & 1), r = (i >> 1) & 1;
      sc[i] = c < hi[r] && c >= lo[r] ? x : -CUDART_INF_F;
    }
  } else {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) sc[i] = to_log2<CAP>(sc[i], rw);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int nn = 0; nn < BN / 8; ++nn)
      mx = fmaxf(mx, fmaxf(sc[4 * nn + 2 * r], sc[4 * nn + 2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, 2));
    const float m_new = fmaxf(m_r[r], mx);
    // a row with nothing live yet keeps p = 0 instead of exp2(-inf + inf)
    const float m_use = m_new == -CUDART_INF_F ? 0.f : m_new;
    alpha[r] = hop::exp2_approx(m_r[r] - m_use);
    float sum = 0.f;
#pragma unroll
    for (int nn = 0; nn < BN / 8; ++nn) {
      const int i = 4 * nn + 2 * r;
      sc[i] = hop::exp2_approx(sc[i] - m_use);
      sc[i + 1] = hop::exp2_approx(sc[i + 1] - m_use);
      sum += sc[i] + sc[i + 1];
    }
    l_r[r] = l_r[r] * alpha[r] + sum;
    m_r[r] = m_new;
  }
}

}  // namespace
