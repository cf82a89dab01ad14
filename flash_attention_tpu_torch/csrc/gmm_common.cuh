// Pieces shared by the port's grouped-matmul kernels (gmm.cu and
// gmm_dw.cu): 16-byte cp.async copies into shared memory (zero-filled past a
// ragged edge), ldmatrix fragment loads for the mma.sync m16n8k16 tiles of
// flash_common.cuh, the tile raster and the fragment store.
//
// ldmatrix.x4 loads four 8 x 8 b16 matrices; lane l gives the address of
// row l % 8 of matrix l / 8. Without .trans, lane (g, t) receives row g,
// columns 2t..2t+1 of each matrix; with .trans, column g, rows 2t..2t+1.

#pragma once

#include "flash_common.cuh"

namespace fat {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from `src` to shared `dst`; zeros when !ok (src is not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// The (m, n) tile of CTA `pid` in a grid of m_tiles x n_tiles, rastered in
// groups of `group_m` m tiles (m fastest inside a group): the CTAs resident
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

// Store a warp's 32 x 64 fp32 accumulator, rounded once to T, at rows
// [r0, r0 + 32) and columns [c0, c0 + 64) of a row-major (rows, cols)
// matrix; rows or columns out of range are skipped (cols is a multiple of 8).
template <typename T>
__device__ __forceinline__ void store_acc(T* out, long long ld, const float (&acc)[2][8][4],
                                          int r0, int c0, int rows, int cols, int g,
                                          int t) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + mi * 16 + g + h * 8;
      if (r >= rows) continue;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int c = c0 + ni * 8 + t * 2;
        if (c < cols)
          *reinterpret_cast<uint32_t*>(out + r * ld + c) =
              Mma<T>::pack(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
      }
    }
  }
}

}  // namespace fat
