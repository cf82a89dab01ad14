// The dK/dV kernels' key-major helpers, shared by flash_bwd_dkv.cu (d 64,
// 128 and 256: 64-row query tiles) and flash_bwd_dkv_wide.cu (d 384 and
// 512: 32-row query tiles), templated on the streamed tile's rows BM where
// they depend on it: a key block's query tiles, the band as the consumers
// see it, whether a tile crosses an edge of the band and which of its
// elements are live (with SEG by segment ids and positions), and the
// epilogue's write of an accumulator into the swizzled tile TMA stores.

#pragma once

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

constexpr int BOX = 64;        // head-dim elements per TMA box (128 bytes)
constexpr int ROW = BOX * 2;   // bytes per box row

// The query tiles of one key block: every head of the group, and in each
// the BM-row tiles from the first that sees the block.
template <int BM>
struct Tiles {
  int m_first, n_m;
  __device__ __forceinline__ int count(int group) const { return group * n_m; }
  __device__ __forceinline__ int head(int i, int kvh, int group) const {
    return kvh * group + i / n_m;
  }
  __device__ __forceinline__ int m0(int i) const {
    return m_first + (i % n_m) * BM;
  }
};

// The band as the consumers see it, key-major.
struct Band {
  int off, left, right;   // fat::UNBOUNDED for an open side
  float scale_log2;
  float cap_scale, cap_log2;  // scale / cap and cap log2(e), with CAP
};

// Whether the tile of BM query rows at row m0 crosses an edge of the band
// for this warp's keys j0 .. j0 + 15; if so, the live columns [lo, hi] of
// each of the thread's keys (g and g + 8), counted from this thread's first
// column: key j is live for rows j - off - right .. j - off + left.
template <int BM>
__device__ __forceinline__ bool tile_edge(int m0, int j0, int g, int t,
                                          const Band& bd, int (&lo)[2],
                                          int (&hi)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = j0 + g + 8 * r;
    lo[r] = j - bd.off - bd.right - m0 - 2 * t;
    hi[r] = j - bd.off + bd.left - m0 - 2 * t;
  }
  return (j0 + 15 > m0 + bd.off + bd.right) ||
         (m0 + BM - 1 + bd.off - bd.left > j0);
}

__device__ __forceinline__ bool live(int i, const int (&lo)[2],
                                     const int (&hi)[2]) {
  const int c = (i / 4) * 8 + (i & 1), r = (i >> 1) & 1;
  return c >= lo[r] && c <= hi[r];
}

// SEG: the segment ids and positions of the thread's two keys (g and g + 8
// of its warp's 16).
struct SegKeys {
  int seg[2], pos[2];
  fat::SegSpan warp;  // the span of the warp's 16 keys
};

// SEG: the ids and positions of keys j and j + 8 (KV_PAD_SEG past sk).
// (kv_seg, kv_pos: the batch row's.)
template <bool SEG>
__device__ __forceinline__ SegKeys seg_keys(const int* kv_seg,
                                            const int* kv_pos, int sk, int j) {
  SegKeys out{};
  if constexpr (SEG) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = j + 8 * r;
      out.seg[r] = key < sk ? kv_seg[key] : fat::KV_PAD_SEG;
      out.pos[r] = key < sk ? kv_pos[key] : 0;
    }
    out.warp = fat::seg_span(min(out.seg[0], out.seg[1]),
                             max(out.seg[0], out.seg[1]),
                             min(out.pos[0], out.pos[1]),
                             max(out.pos[0], out.pos[1]));
  }
  return out;
}

// SEG: whether every pair of the warp's keys and the query tile whose span
// is ``span`` is live (an interior tile: no mask).
__device__ __forceinline__ bool seg_interior(const int* span,
                                             const SegKeys& sk,
                                             const Band& bd) {
  return fat::seg_all_live(*reinterpret_cast<const fat::SegSpan*>(span),
                           sk.warp, bd.left, bd.right);
}

// SEG: whether element i of a query tile of BM rows whose ids and
// positions are ``qseg`` and ``qseg + BM`` (in the stage) is live.
template <int BM>
__device__ __forceinline__ bool seg_live(int i, const int* qseg,
                                         const SegKeys& sk, int t,
                                         const Band& bd) {
  const int c = (i / 4) * 8 + 2 * t + (i & 1), r = (i >> 1) & 1;
  const int rel = sk.pos[r] - qseg[BM + c];
  return qseg[c] == sk.seg[r] && rel >= -bd.left && rel <= bd.right;
}

// Write scale * acc (N columns), rounded to T, into a consumer's 64 rows of
// a tile whose boxes hold ROWS rows, in the swizzled layout TMA stores from.
template <typename T, int N, int ROWS>
__device__ __forceinline__ void to_smem(uint8_t* rows, const float (&acc)[N / 2],
                                        float scale, int warp, int g, int t) {
#pragma unroll
  for (int nt = 0; nt < N / 8; ++nt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = warp * 16 + g + 8 * r;
      const int chunk = (nt % 8) ^ (row & 7);
      *reinterpret_cast<uint32_t*>(rows + (nt / 8) * ROWS * ROW +
                                   row * ROW + chunk * 16 + t * 4) =
          fat::Mma<T>::pack(acc[4 * nt + 2 * r] * scale,
                            acc[4 * nt + 2 * r + 1] * scale);
    }
  }
}

}  // namespace
