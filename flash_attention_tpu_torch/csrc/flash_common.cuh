// Pieces shared by the port's flash-attention kernels (flash_fwd.cu and the
// three backward kernels flash_bwd_{di,dq,dkv}.cu) and its matmul kernels
// (gmm.cu, gmm_dw.cu, qmm.cu): the fp32-pair packing for bf16 and fp16, the
// accumulator-to-A-fragment packing, the attention band's open side, and the
// error-string export.
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
#include <stdint.h>

namespace fat {

constexpr float LOG2E = 1.4426950408889634f;

// An open side of an attention band (left or right): far past any offset,
// and small enough that a row index plus it stays inside an int. The C
// interfaces take < 0 for an open side; band_side maps it here.
constexpr int UNBOUNDED = 1 << 30;
inline int band_side(int x) { return x < 0 ? UNBOUNDED : x; }

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
