// The dQ kernels' arithmetic on a kv tile, shared by flash_bwd_dq.cu (d 64,
// 128 and 256: 64-column tiles) and flash_bwd_dq_wide.cu (d 384 and 512:
// 32-column tiles), each helper templated on the tile's width BN: what a
// consumer thread knows of its two query rows (the band, the scale, the
// softcap, LSE and D; with SEG their segment ids and positions), whether a
// tile crosses an edge of the band and which of its elements are live, and
// P and dS from S and dP on the wgmma accumulator.

#pragma once

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

// What P needs to know of this thread's rows.
struct Rows {
  int row[2];  // the thread's two rows, g and g + 8 of its warp's 16
  int w0;      // the warp's first row
  int t;       // thread in its row group of 4
  int sk, off, left, right;  // the band (fat::UNBOUNDED for an open side)
  float scale_log2;
  float cap_scale, cap_log2;  // scale / cap and cap log2(e), with CAP
  float lse2[2];  // LSE in the log2 domain
  float d[2];     // D
};

// Whether the tile of BN kv columns at column n0 crosses an edge of the band
// or sk for this warp; if so, the live columns [lo, hi) of each row,
// counted from this thread's first column.
template <int BN>
__device__ __forceinline__ bool tile_edge(int n0, const Rows& rw, int (&lo)[2],
                                          int (&hi)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    hi[r] = min(rw.sk, rw.row[r] + rw.off + rw.right + 1) - n0 - rw.t * 2;
    lo[r] = rw.row[r] + rw.off - rw.left - n0 - rw.t * 2;
  }
  return (n0 + BN > rw.sk) ||
         (n0 + BN - 1 > rw.w0 + rw.off + rw.right) ||
         (n0 < rw.w0 + 15 + rw.off - rw.left);
}

__device__ __forceinline__ bool live(int i, const int (&lo)[2],
                                     const int (&hi)[2]) {
  const int c = (i / 4) * 8 + (i & 1), r = (i >> 1) & 1;
  return c < hi[r] && c >= lo[r];
}

// SEG: the segment ids and positions of the thread's two rows and the span
// of its warp's 16; whether element i of a tile whose kv ids, positions and
// span are ``meta`` is live, and whether every element is (an interior
// tile, fat::seg_all_live).
struct SegRows {
  int seg[2], pos[2];
  fat::SegSpan warp;
};

template <int BN>
__device__ __forceinline__ bool seg_interior(const int* meta,
                                             const SegRows& sr,
                                             const Rows& rw) {
  return fat::seg_all_live(
      sr.warp, *reinterpret_cast<const fat::SegSpan*>(meta + 2 * BN),
      rw.left, rw.right);
}

template <int BN>
__device__ __forceinline__ bool seg_live(int i, const int* meta,
                                         const SegRows& sr, const Rows& rw) {
  const int c = (i / 4) * 8 + (i & 1) + rw.t * 2, r = (i >> 1) & 1;
  const int rel = meta[BN + c] - sr.pos[r];
  return meta[c] == sr.seg[r] && rel >= -rw.left && rel <= rw.right;
}

// P = exp2(S scale log2e - LSE log2e) in place, for the tile at kv column
// n0; masked only where the tile crosses an edge for this warp, or with SEG
// everywhere by the tile's ids and positions in ``meta``.
template <bool SEG, int BN>
__device__ __forceinline__ void probs(float (&sc)[BN / 2], int n0,
                                      const Rows& rw, const SegRows& sr,
                                      const int* meta) {
  int lo[2], hi[2];
  if constexpr (SEG) {
    if (seg_interior<BN>(meta, sr, rw)) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i)
        sc[i] =
            hop::exp2_approx(sc[i] * rw.scale_log2 - rw.lse2[(i >> 1) & 1]);
      return;
    }
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int r = (i >> 1) & 1;
      const float p = hop::exp2_approx(sc[i] * rw.scale_log2 - rw.lse2[r]);
      sc[i] = seg_live<BN>(i, meta, sr, rw) ? p : 0.f;
    }
  } else if (tile_edge<BN>(n0, rw, lo, hi)) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int r = (i >> 1) & 1;
      const float p = hop::exp2_approx(sc[i] * rw.scale_log2 - rw.lse2[r]);
      sc[i] = live(i, lo, hi) ? p : 0.f;
    }
  } else {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i)
      sc[i] = hop::exp2_approx(sc[i] * rw.scale_log2 - rw.lse2[(i >> 1) & 1]);
  }
}

// dS = P * (dP - D), into sc.
template <int BN>
__device__ __forceinline__ void dscores(float (&sc)[BN / 2],
                                        const float (&dp)[BN / 2],
                                        const Rows& rw) {
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) sc[i] *= dp[i] - rw.d[(i >> 1) & 1];
}

// The softcap instance's P and dS in one pass, into sc: t = tanh(S scale /
// cap), P = exp2(cap log2e t - LSE log2e), dS = P (dP - D) (1 - t^2).
template <bool SEG, int BN>
__device__ __forceinline__ void dscores_cap(float (&sc)[BN / 2],
                                            const float (&dp)[BN / 2],
                                            int n0, const Rows& rw,
                                            const SegRows& sr,
                                            const int* meta) {
  int lo[2], hi[2];
  const bool edge = SEG ? !seg_interior<BN>(meta, sr, rw)
                        : tile_edge<BN>(n0, rw, lo, hi);
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    const int r = (i >> 1) & 1;
    const float t = hop::tanh_exp2(sc[i] * rw.cap_scale);
    const float p = hop::exp2_approx(rw.cap_log2 * t - rw.lse2[r]);
    const float ds = p * (dp[i] - rw.d[r]) * (1.f - t * t);
    if constexpr (SEG)
      sc[i] = !edge || seg_live<BN>(i, meta, sr, rw) ? ds : 0.f;
    else
      sc[i] = !edge || live(i, lo, hi) ? ds : 0.f;
  }
}

}  // namespace
