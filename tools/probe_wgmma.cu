// Cycles a wgmma chain takes on one SM: the cost of the wide attention
// kernels' score chains (m64n32k16 and m64n64k16, both operands in shared
// memory or A in registers) and their P V and dS K products (m64n256k16),
// alone, as two chains interleaved in one warpgroup, and as one chain in
// each of two warpgroups. Built and run by tools/probe_wgmma.py; the
// operands are whatever shared memory and registers hold (the time of a
// product does not depend on its values).

#include <cuda_bf16.h>

#include "hopper_common.cuh"

namespace {

constexpr int STEPS = 32;  // k16 steps a chain: d 512

// One chain of STEPS m64nNk16 into `d`, both operands in shared memory
// (K-major, as Q and K for Q K^T).
template <int N>
__device__ __forceinline__ void chain_ss(float (&d)[N / 2], uint32_t a,
                                         uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < STEPS; ++kk)
    hop::Wgmma<__nv_bfloat16, N>::ss(
        d, hop::desc_sw128(a + (kk / 4) * 64 * 128 + (kk % 4) * 32, 16, 1024),
        hop::desc_sw128(b + (kk / 4) * N * 128 + (kk % 4) * 32, 16, 1024),
        kk > 0);
}

// V: 0 one m64n32 chain, 1 two m64n32 chains interleaved, 2 one m64n64
// chain, 3 one m64n32 chain with A in registers, 4 four m64n256k16 (P V's
// half at d 512, MN-major B) a rep; every warpgroup of the CTA runs it.
// out[blockIdx.x * 2 + warpgroup] = cycles of `reps` reps.
template <int V>
__global__ void __launch_bounds__(256, 1) probe_kernel(int reps,
                                                       long long* out) {
  extern __shared__ __align__(1024) uint8_t smem[];
  const uint32_t base = hop::smem_u32(smem);
  const int wg = threadIdx.x / 128;
  const uint32_t a = base + wg * 64 * 1024, b = base + 128 * 1024;
  constexpr int N0 = V == 2 ? 64 : V == 4 ? 256 : 32;
  float d0[N0 / 2], d1[16];
#pragma unroll
  for (int i = 0; i < N0 / 2; ++i) d0[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) d1[i] = 0.f;
  uint32_t ra[STEPS][4];
#pragma unroll
  for (int kk = 0; kk < STEPS; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) ra[kk][e] = threadIdx.x * 4 + e;
  __syncthreads();
  const long long t0 = clock64();
  for (int r = 0; r < reps; ++r) {
    hop::fence_regs(d0);
    hop::fence_regs(d1);
    hop::wgmma_fence();
    if constexpr (V == 0 || V == 2) {
      chain_ss<N0>(d0, a, b);
    } else if constexpr (V == 1) {
#pragma unroll
      for (int kk = 0; kk < STEPS; ++kk) {
        const uint32_t ko = (kk / 4) * 64 * 128 + (kk % 4) * 32;
        const uint32_t kb = (kk / 4) * 32 * 128 + (kk % 4) * 32;
        hop::Wgmma<__nv_bfloat16, 32>::ss(
            d0, hop::desc_sw128(a + ko, 16, 1024),
            hop::desc_sw128(b + kb, 16, 1024), kk > 0);
        hop::Wgmma<__nv_bfloat16, 32>::ss(
            d1, hop::desc_sw128(a + ko, 16, 1024),
            hop::desc_sw128(b + 32 * 1024 + kb, 16, 1024), kk > 0);
      }
    } else if constexpr (V == 3) {
#pragma unroll
      for (int kk = 0; kk < STEPS; ++kk)
        hop::WgmmaRs<__nv_bfloat16, 32>::rs(
            d0, ra[kk],
            hop::desc_sw128(b + (kk / 4) * 32 * 128 + (kk % 4) * 32, 16,
                            1024));
    } else {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hop::WgmmaSs<__nv_bfloat16, 256, 0, 1>::ss(
            d0, hop::desc_sw128(a + kk * 32, 16, 1024),
            hop::desc_sw128(b + kk * 16 * 128, 64 * 128, 1024), 1);
    }
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
  }
  hop::fence_regs(d0);
  hop::fence_regs(d1);
  const long long t1 = clock64();
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < N0 / 2; ++i) s += d0[i];
#pragma unroll
  for (int i = 0; i < 16; ++i) s += d1[i];
  if (threadIdx.x % 128 == 0)
    out[blockIdx.x * 2 + wg] = (t1 - t0) + (s == 12345.f);
}

}  // namespace

extern "C" int fat_probe_wgmma(int variant, int warpgroups, int ctas,
                               int reps, void* out, void* stream) {
  const int bytes = 227 * 1024;
  auto kernel = variant == 0   ? probe_kernel<0>
                : variant == 1 ? probe_kernel<1>
                : variant == 2 ? probe_kernel<2>
                : variant == 3 ? probe_kernel<3>
                               : probe_kernel<4>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<ctas, 128 * warpgroups, bytes, static_cast<cudaStream_t>(stream)>>>(
      reps, static_cast<long long*>(out));
  return static_cast<int>(cudaGetLastError());
}
