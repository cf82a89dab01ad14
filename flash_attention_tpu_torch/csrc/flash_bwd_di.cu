// Flash-attention backward, step 1 of 3: D = rowsum(dO * O), for Hopper
// (sm_90a), hand-written CUDA C++.
//
// Replaces: flash_attention_tpu/ops/flash_bwd.py::_di_kernel (the Pallas TPU
// kernel launched by flash_bwd).
//
// Computes D[b, h, i] = sum_d dO[b, i, h, d] * O[b, i, h, d] in fp32 for O and
// dO (b, sq, h, d), bf16 or fp16, d 64, 128 or 256, read by TMA through their strides (the head
// dim must be contiguous), into a contiguous (b, h, sq) fp32 tensor.
//
// Why a matrix product: the backward forms dS = P * (dP - D) with
// dP = dO V^T. When a row's attention sits on one key, its O row equals that
// V row and dS must be exactly 0, which holds only if D is summed exactly as
// dP is. So, like the TPU kernel, D is taken as the diagonal of dO O^T, and
// from the very instruction chain that gives dP in flash_bwd_dq.cu and dP^T
// in flash_bwd_dkv.cu: hop::ss_chain, wgmma m64n64k16 with both operands
// K-major in 128-byte-swizzled shared memory, k16 steps over the head dim in
// order, the first one ignoring the accumulator. Reading the diagonal out of
// the accumulator is exact.
//
// What bounds it on the H100: bytes. It reads O and dO once (4 bytes per
// element pair) and writes 4 bytes per row; the 64 x 64 block each CTA
// multiplies is 64x the useful products and still far below the tensor
// cores' rate.
//
// What the design does about it: one warpgroup per (64 query rows, head,
// batch), with about 33 KB of shared memory at d 128 (65 KB at d 256), so
// several CTAs per SM keep TMA loads in flight; one thread loads both tiles
// on one mbarrier.

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

constexpr int BLOCK_M = 64;  // query rows per CTA
constexpr int NTHREADS = 128;
constexpr int BOX = 64;       // head-dim elements per TMA box (128 bytes)
constexpr int ROW = BOX * 2;  // bytes per box row

template <int D>
struct Smem {
  static constexpr int TILE = BLOCK_M * D * 2;
  static constexpr int O_OFF = TILE;  // dO at 0
  static constexpr int BAR_OFF = 2 * TILE;
  static constexpr int BYTES = BAR_OFF + 8 + 1024;  // + 1024-byte alignment
};

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_di_kernel(const __grid_constant__ CUtensorMap o_map,
                    const __grid_constant__ CUtensorMap do_map,
                    float* __restrict__ di, int sq, int h) {
  using L = Smem<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (hop::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  const int m0 = blockIdx.x * BLOCK_M;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  if (threadIdx.x == 0) {
    hop::mbar_init(bar, 1);
    hop::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    hop::mbar_expect_tx(bar, 2 * L::TILE);
#pragma unroll
    for (int c = 0; c < D / BOX; ++c) {
      hop::tma_load_4d(smem + c * BLOCK_M * ROW, &do_map, bar, c * BOX, head,
                       m0, batch);
      hop::tma_load_4d(smem + L::O_OFF + c * BLOCK_M * ROW, &o_map, bar,
                       c * BOX, head, m0, batch);
    }
  }
  hop::mbar_wait(bar, 0);

  float acc[32];  // dO O^T, 64 x 64
  hop::ss_chain<T, 64, D>(acc, hop::smem_u32(smem), BLOCK_M,
                          hop::smem_u32(smem + L::O_OFF), BLOCK_M);
  hop::wgmma_commit();
  hop::wgmma_wait<0>();
  hop::fence_regs(acc);

  // acc[4 j + e] is row 16 w + g + 8 (e / 2), column 8 j + 2 t + e % 2;
  // each diagonal element has one owner, found with constant indices only
  // (a select between two elements would index the array at run time)
  const int tid = threadIdx.x;
  const int w = tid / 32, g = (tid % 32) >> 2, t = tid & 3;
  float* out = di + ((long long)batch * h + head) * sq + m0;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * j + 2 * t + (e & 1);
      if (16 * w + g + 8 * (e >> 1) == col && m0 + col < sq)
        out[col] = acc[4 * j + e];
    }
}

template <typename T, int D>
int launch(const void* o, const void* dout, float* di, int b, int sq, int h,
           const long long* st, cudaStream_t stream) {
  constexpr bool fp16 = std::is_same_v<T, __half>;
  CUtensorMap om, dm;
  int rc;
  if ((rc = hop::make_map_bshd(&om, o, fp16, b, sq, h, D, st, BLOCK_M)) ||
      (rc = hop::make_map_bshd(&dm, dout, fp16, b, sq, h, D, st + 3, BLOCK_M)))
    return rc;
  auto kernel = flash_bwd_di_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<D>::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((sq + BLOCK_M - 1) / BLOCK_M, h, b);
  kernel<<<grid, NTHREADS, Smem<D>::BYTES, stream>>>(om, dm, di, sq, h);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// strides: 6 int64 in elements, (batch, seq, head) for o, then dout.
// di is a contiguous (b, h, sq) fp32 tensor.
int fat_flash_bwd_di(const void* o, const void* dout, void* di, int b, int sq,
                     int h, int d, const long long* strides, int is_fp16,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(di);
  if (d == 256 && !is_fp16)
    return launch<__nv_bfloat16, 256>(o, dout, out, b, sq, h, strides, s);
  if (d == 256) return launch<__half, 256>(o, dout, out, b, sq, h, strides, s);
  if (d == 128 && !is_fp16)
    return launch<__nv_bfloat16, 128>(o, dout, out, b, sq, h, strides, s);
  if (d == 128) return launch<__half, 128>(o, dout, out, b, sq, h, strides, s);
  if (d == 64 && !is_fp16)
    return launch<__nv_bfloat16, 64>(o, dout, out, b, sq, h, strides, s);
  if (d == 64) return launch<__half, 64>(o, dout, out, b, sq, h, strides, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
