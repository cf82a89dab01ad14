// Pieces shared by the port's matmul kernels: the tile raster (gmm.cu,
// gmm_dw.cu and qmm.cu) and the grouped matmuls' epilogue, which rounds a
// consumer warpgroup's accumulator into shared memory and stores it by TMA.

#pragma once

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace fat {

// A consumer warpgroup's epilogue buffer: 64 rows by 128 columns.
constexpr int EPI_BYTES = 2 * 64 * 128;

// The (m, n) tile number `pid` of a grid of m_tiles x n_tiles, rastered in
// groups of `group_m` m tiles (m fastest inside a group): the tiles in flight
// at one time share a few m tiles and a few n tiles, so their operands are
// read from device memory about once and then from the L2 cache.
__device__ __forceinline__ void raster(int pid, int m_tiles, int n_tiles, int group_m,
                                       int& mt, int& nt) {
  const int per_group = group_m * n_tiles;
  const int first_m = (pid / per_group) * group_m;
  const int gm = min(m_tiles - first_m, group_m);
  const int in = pid % per_group;
  mt = first_m + in % gm;
  nt = in / gm;
}

// Columns 128 H .. 128 H + 127 of a consumer warpgroup's 64-row wgmma
// accumulator (N fp32 columns, N / 2 a thread, in the layout set out in
// hopper_common.cuh), rounded once to T, into `buf` as two 64 x 64 boxes
// laid out as a 128-byte-swizzled TMA store reads them: row r of a box at
// r * 128 bytes, its 16-byte chunks permuted by r % 8. The 8 rows of one
// store instruction land in 8 distinct chunks: no bank conflict.
template <typename T, int N, int H>
__device__ __forceinline__ void acc_to_boxes(uint8_t* buf, const float (&acc)[N / 2],
                                             int warp, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 16; ++j) {  // 8-column blocks of the half
    const int jn = 16 * H + j;
    uint8_t* box = buf + (j / 8) * 64 * 128;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = 16 * warp + g + 8 * e;
      *reinterpret_cast<uint32_t*>(box + r * 128 + (((j % 8) ^ (r & 7)) << 4) + 4 * t) =
          Mma<T>::pack(acc[4 * jn + 2 * e], acc[4 * jn + 2 * e + 1]);
    }
  }
}

// Columns 128 H .. 128 H + 127 of consumer warpgroup c's 64 x N
// accumulator (tid its thread, 0..127): into its buffer `epi` (once the
// buffer's last store has read it), then by TMA to the boxes at columns
// col0 + 128 H .., rows row0 .. row0 + 63 and plane z of the 3-D `map`,
// issued by one thread and left to run while the consumers go on. Columns
// at or past n_cols are not stored; the map clips rows past its extent.
template <typename T, int N, int H>
__device__ __forceinline__ void store_half(uint8_t* epi, const float (&acc)[N / 2],
                                           const CUtensorMap* map, int col0, int row0,
                                           int z, int n_cols, int tid, int c) {
  if (tid == 0) hop::tma_store_wait_read<0>();
  hop::named_sync(1 + c, 128);
  acc_to_boxes<T, N, H>(epi, acc, tid / 32, tid % 32);
  hop::fence_async_smem();
  hop::named_sync(1 + c, 128);
  if (tid == 0) {
    for (int q = 0; q < 2; ++q) {
      const int col = col0 + 128 * H + 64 * q;
      if (col < n_cols) hop::tma_store_3d(map, epi + q * 64 * 128, col, row0, z);
    }
    hop::tma_store_commit();
  }
}

}  // namespace fat
