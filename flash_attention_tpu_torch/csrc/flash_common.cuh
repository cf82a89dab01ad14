// Pieces shared by the port's flash-attention kernels (flash_fwd.cu and the
// three backward kernels flash_bwd_{di,dq,dkv}.cu): the mma.sync m16n8k16
// wrapper for bf16 and fp16, the fragment loads, and the tile loader into
// padded shared memory.
//
// Fragment layouts of mma.m16n8k16 (g = lane / 4, t = lane % 4):
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
#include <stdint.h>

namespace fat {

constexpr float LOG2E = 1.4426950408889634f;

template <typename T>
struct Mma;

template <>
struct Mma<__nv_bfloat16> {
  static __device__ __forceinline__ void run(float (&c)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

template <>
struct Mma<__half> {
  static __device__ __forceinline__ void run(float (&c)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

// Copy rows [row0, row0 + ROWS) of a row-major (n_rows, D) matrix with row
// stride `ld` (elements) into shared memory with row stride D + 8 (the pad
// keeps fragment reads free of bank conflicts), 16 bytes a thread. Rows at or
// past n_rows are filled with zeros, so stale shared memory never enters a
// product.
template <typename T, int ROWS, int D, int NTHREADS>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long ld,
                                          int row0, int n_rows, int tid) {
  constexpr int CHUNKS = D / 8;  // 16-byte chunks per row
  for (int i = tid; i < ROWS * CHUNKS; i += NTHREADS) {
    const int r = i / CHUNKS;
    const int c = (i % CHUNKS) * 8;
    uint4 x = make_uint4(0, 0, 0, 0);
    if (row0 + r < n_rows)
      x = *reinterpret_cast<const uint4*>(src + (row0 + r) * ld + c);
    *reinterpret_cast<uint4*>(dst + r * (D + 8) + c) = x;
  }
}

// A fragment of rows (g, g + 8) and columns [k0, k0 + 16) of a row-major
// matrix at `m` with row stride `ld`; ok0 / ok1 false gives zeros for row
// g / g + 8 (a row past the matrix's end is never read).
template <typename T>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const T* m, long long ld,
                                       int g, int t, int k0,
                                       bool ok0 = true, bool ok1 = true) {
  const T* r0 = m + g * ld + k0 + t * 2;
  const T* r1 = m + (g + 8) * ld + k0 + t * 2;
  a[0] = ok0 ? *reinterpret_cast<const uint32_t*>(r0) : 0u;
  a[1] = ok1 ? *reinterpret_cast<const uint32_t*>(r1) : 0u;
  a[2] = ok0 ? *reinterpret_cast<const uint32_t*>(r0 + 8) : 0u;
  a[3] = ok1 ? *reinterpret_cast<const uint32_t*>(r1 + 8) : 0u;
}

// B fragment with B[k][n] = M[n][k] (the K^T of Q K^T): row g of the
// row-major M at `m`, columns [k0, k0 + 16).
template <typename T>
__device__ __forceinline__ void load_b_rows(uint32_t& b0, uint32_t& b1,
                                            const T* m, long long ld, int g,
                                            int t, int k0) {
  const T* r = m + g * ld + k0 + t * 2;
  b0 = *reinterpret_cast<const uint32_t*>(r);
  b1 = *reinterpret_cast<const uint32_t*>(r + 8);
}

// B fragment with B[k][n] = M[k][n] (the V of P V): rows [0, 16) of the
// row-major M at `m` (already offset to the k-step and n-tile), column g.
template <typename T>
__device__ __forceinline__ void load_b_cols(uint32_t& b0, uint32_t& b1,
                                            const T* m, int ld, int g, int t) {
  const uint16_t* p = reinterpret_cast<const uint16_t*>(m) + t * 2 * ld + g;
  b0 = uint32_t(p[0]) | (uint32_t(p[ld]) << 16);
  b1 = uint32_t(p[8 * ld]) | (uint32_t(p[9 * ld]) << 16);
}

// A fragment of k-step kk from C tiles 2 kk and 2 kk + 1 of one row block.
template <typename T>
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = Mma<T>::pack(c0[0], c0[1]);
  a[1] = Mma<T>::pack(c0[2], c0[3]);
  a[2] = Mma<T>::pack(c1[0], c1[1]);
  a[3] = Mma<T>::pack(c1[2], c1[3]);
}

}  // namespace fat

extern "C" const char* fat_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
