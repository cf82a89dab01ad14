// Pieces shared by the port's flash-attention kernels (flash_fwd.cu and the
// three backward kernels flash_bwd_{di,dq,dkv}.cu) and, through
// gmm_common.cuh, its matmul kernels: the mma.sync m16n8k16 wrapper and the
// fp32-pair packing for bf16 and fp16, and the error-string export.
//
// Fragment layouts of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16 x 16, row-major): a0 = (g, 2t..2t+1), a1 = (g + 8, 2t..),
//                           a2 = (g, 2t + 8..),  a3 = (g + 8, 2t + 8..)
//   B (16 x 8, k x n):      b0 = (k = 2t..2t+1, n = g), b1 = (k = 2t + 8.., n = g)
//   C (16 x 8, fp32):       c0, c1 = (g, 2t..2t+1), c2, c3 = (g + 8, 2t..2t+1)
// Two adjacent C tiles of one row block form one A fragment (pack_a), so a
// product's result feeds the next product without leaving the registers (the wgmma
// accumulator and register-A layouts of hopper_common.cuh are the same per
// 16-row warp slice).

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
