// Grouped matmul weight gradient for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces: flash_attention_tpu/ops/moe.py::_gmm_dw_kernel (the Pallas TPU
// kernel launched by _gmm_dw_impl).
//
// Computes dW[e] = x[rows of e]^T . dy[rows of e] for x (n_rows, K) and
// dy (n_rows, N), bf16 or fp16, read through their row strides, into a
// contiguous (E, K, N) tensor of the same dtype. The rows of expert e are
// those of every block b with block_expert[b] == e, wherever the blocks sit;
// dead blocks (-1) belong to no expert. Each dW element is one fp32 sum over
// all of its expert's rows, rounded once and written once: no atomics, no
// trash slot, no split over rows, so repeats are bit-identical. An expert
// with no rows gets exact zeros (the TPU kernel never visits that output
// block and leaves it unwritten).
//
// What bounds it on the H100: at Mixtral's training shapes (K and N 4096 or
// 14336, about 1024 rows an expert) the operations: 2 K N FLOP a row, 0.97
// ms at 989 TFLOP/s; the 0.94 GB of dW written are 0.28 ms at 3.35 TB/s
// beside them, and each 128 x 256 tile sums only 16-18 stages of 64 rows,
// so a tile's epilogue is a large share of it unless it is overlapped.
//
// What the design does about it: every product on wgmma, every operand by
// TMA, warp-specialised and persistent, on hopper_common.cuh:
// * A tile is dW[e] rows k0 .. k0 + 127 by columns n0 .. n0 + 255.
// * Warpgroup 0, the producer: one thread walks the expert's blocks in index
//   order (the order the mma.sync kernel this replaces summed in), 64 rows a
//   stage, into a ring of 4 stages of 48 KB: the x tile (64 rows by 128
//   columns, two boxes) and the dy tile (64 rows by 256 columns, four
//   boxes), both from 2-D maps over their row strides with the 128-byte
//   swizzle, and a full and an empty mbarrier per stage. Boxes wholly past
//   K or N are not loaded.
// * Warpgroups 1 and 2, the consumers, own 64 dW rows each: wgmma
//   m64n256k16 with A = the consumer's x box read MN-major (x's columns are
//   dW's rows: wgmma's transposed A) and B = dy MN-major, 128 fp32
//   accumulators a thread (setmaxnreg: 40 producer, 232 consumer
//   registers). One stage's product is in flight while the next is issued.
// * Each CTA counts every expert's blocks into shared memory once, so the
//   consumers know each tile's stage count; the producer reads block_expert
//   (a few hundred ints, cached) as it walks. An expert with no rows gets
//   zeros from its consumers, without touching the ring.
// * The epilogue: each consumer rounds its 64 x 256 accumulator in two
//   halves into a 16 KB shared-memory buffer (128-byte swizzled boxes, no
//   bank conflicts) and one thread stores each half by TMA (a 3-D map over
//   dW, so rows past K never reach the next expert), which then runs while
//   the consumers go on to the next tile. The 0.94 GB of dW leave at the
//   rate of the memory, not of the consumers' stores.
// * Persistent and expert-major: one CTA per SM walks the tiles expert by
//   expert, each expert's tiles in grouped raster order (16 K tiles a
//   group), so the x and dy columns of the tiles in flight stay in the L2.
//   The producer fills the next tile's stages while the consumers round and
//   store the last one.
// Left for later work: a ping-pong of the two consumers over two tiles, so
// the tensor cores also run through the epilogue.

#include "flash_common.cuh"
#include "gmm_common.cuh"
#include "hopper_common.cuh"

namespace {

constexpr int BM = 128;        // dW rows (K) a tile: 64 per consumer
constexpr int BN = 256;        // dW columns (N) a tile
constexpr int BR = 64;         // rows of x and dy a stage
constexpr int STAGES = 4;
constexpr int NTHREADS = 384;  // producer + 2 consumer warpgroups
constexpr int GROUP_M = 16;
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int BOX_BYTES = 64 * 128;  // a box of 64 rows by 64 columns
constexpr int X_BYTES = BM / 64 * BOX_BYTES;
constexpr int STAGE_BYTES = X_BYTES + BN / 64 * BOX_BYTES;
constexpr int EPI_OFF = STAGES * STAGE_BYTES;
constexpr int BAR_OFF = EPI_OFF + 2 * fat::EPI_BYTES;
constexpr int CNT_OFF = BAR_OFF + 2 * STAGES * 8;
constexpr int MAX_SMEM = 232448;  // a CTA's shared memory on the H100
// CNT_OFF + 4 E bytes + 1024 slack to align to the swizzle period
constexpr int MAX_EXPERTS = (MAX_SMEM - CNT_OFF - 1024) / 4;

template <typename T>
__global__ void __launch_bounds__(NTHREADS, 1)
gmm_dw_kernel(const __grid_constant__ CUtensorMap x_map,
              const __grid_constant__ CUtensorMap dy_map,
              const __grid_constant__ CUtensorMap dw_map,
              const int* __restrict__ block_expert, T* __restrict__ dw, int K, int N,
              int br, int nb, int n_experts, int m_tiles, int n_tiles) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (hop::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + BAR_OFF);
  uint64_t* empty = full + STAGES;
  int* cnt = reinterpret_cast<int*>(smem + CNT_OFF);  // blocks of each expert

  const int role = __shfl_sync(0xffffffff, threadIdx.x / 128, 0);
  for (int i = threadIdx.x; i < n_experts; i += NTHREADS) cnt[i] = 0;
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      hop::mbar_init(&full[i], 1);
      hop::mbar_init(&empty[i], 8);  // one arrival per consumer warp
    }
    hop::mbar_fence_init();
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nb; i += NTHREADS) {
    const int e = block_expert[i];
    if (e >= 0 && e < n_experts) atomicAdd(&cnt[e], 1);
  }
  __syncthreads();

  const int per_expert = m_tiles * n_tiles;
  const int tiles = n_experts * per_expert;
  const int sub_steps = br / BR;

  if (role == 0) {
    // ---- producer ----
    hop::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      hop::prefetch_map(&x_map);
      hop::prefetch_map(&dy_map);
      int it = 0;  // stages filled so far, over all of this CTA's tiles
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int e = tile / per_expert;
        if (cnt[e] == 0) continue;  // no rows: no loads
        int mt, nt;
        fat::raster(tile - e * per_expert, m_tiles, n_tiles, GROUP_M, mt, nt);
        const int k0 = mt * BM, n0 = nt * BN;
        const int x_boxes = min(BM / 64, (K - k0 + 63) / 64);
        const int d_boxes = min(BN / 64, (N - n0 + 63) / 64);
        const uint32_t bytes = (x_boxes + d_boxes) * BOX_BYTES;
        for (int b = 0; b < nb; ++b) {
          if (__ldg(block_expert + b) != e) continue;
          for (int sub = 0; sub < sub_steps; ++sub, ++it) {
            const int st = it % STAGES;
            if (it >= STAGES) hop::mbar_wait(&empty[st], (it / STAGES - 1) & 1);
            uint8_t* xs = smem + st * STAGE_BYTES;
            uint8_t* ds = xs + X_BYTES;
            const int row = b * br + sub * BR;
            hop::mbar_expect_tx(&full[st], bytes);
            for (int q = 0; q < x_boxes; ++q)
              hop::tma_load_2d(xs + q * BOX_BYTES, &x_map, &full[st], k0 + 64 * q, row);
            for (int q = 0; q < d_boxes; ++q)
              hop::tma_load_2d(ds + q * BOX_BYTES, &dy_map, &full[st], n0 + 64 * q, row);
          }
        }
      }
    }
    return;
  }

  // ---- consumers ----
  hop::setmaxnreg_inc<CONSUMER_REGS>();
  const int c = role - 1;  // dW rows 64 c .. 64 c + 63 of each tile
  const int tid = threadIdx.x % 128, lane = tid % 32;
  const uint32_t base = hop::smem_u32(smem);
  uint8_t* epi = smem + EPI_OFF + c * fat::EPI_BYTES;
  float acc[BN / 2];
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int e = tile / per_expert;
    int mt, nt;
    fat::raster(tile - e * per_expert, m_tiles, n_tiles, GROUP_M, mt, nt);
    const int n0 = nt * BN;
    const int k_row0 = mt * BM + 64 * c;
    T* out = dw + (long long)e * K * N;
    const int n_steps = cnt[e] * sub_steps;
    if (n_steps == 0) {  // an expert with no rows: zeros
      const uint4 z = make_uint4(0, 0, 0, 0);
      for (int i = tid; i < 64 * BN / 8; i += 128) {
        const int r = k_row0 + i / (BN / 8), col = n0 + (i % (BN / 8)) * 8;
        if (r < K && col < N)
          *reinterpret_cast<uint4*>(out + (long long)r * N + col) = z;
      }
      continue;
    }
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    for (int j = 0; j < n_steps; ++j, ++it) {
      const int st = it % STAGES;
      hop::mbar_wait(&full[st], (it / STAGES) & 1);
      const uint32_t xs = base + st * STAGE_BYTES + c * BOX_BYTES;
      const uint32_t ds = base + st * STAGE_BYTES + X_BYTES;
      hop::fence_regs(acc);
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BR / 16; ++kk)
        hop::WgmmaSs<T, BN, 1, 1>::ss(
            acc, hop::desc_sw128(xs + kk * 16 * 128, BOX_BYTES, 1024),
            hop::desc_sw128(ds + kk * 16 * 128, BOX_BYTES, 1024), 1);
      hop::wgmma_commit();
      hop::wgmma_wait<1>();  // the product of the stage before is done
      if (j > 0 && lane == 0) hop::mbar_arrive(&empty[(it - 1) % STAGES]);
    }
    hop::wgmma_wait<0>();
    hop::fence_regs(acc);
    if (lane == 0) hop::mbar_arrive(&empty[(it - 1) % STAGES]);

    if (k_row0 < K) {  // (the same for every thread of the consumer)
      fat::store_half<T, BN, 0>(epi, acc, &dw_map, n0, k_row0, e, N, tid, c);
      fat::store_half<T, BN, 1>(epi, acc, &dw_map, n0, k_row0, e, N, tid, c);
    }
  }
  if (tid == 0) hop::tma_store_wait_read<0>();  // shared memory outlives the stores
}

template <typename T>
int launch(const void* x, const void* dy, const int* be, void* dw, int n_rows, int K,
           int N, int br, int nb, int n_experts, const long long* strides, int ctas,
           cudaStream_t stream) {
  constexpr bool fp16 = std::is_same_v<T, __half>;
  const CUtensorMapDataType type =
      fp16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap xm, dm, wm;
  int rc;
  if ((rc = hop::make_map_2d(&xm, x, type, K, n_rows, strides[0] * 2, BR)) ||
      (rc = hop::make_map_2d(&dm, dy, type, N, n_rows, strides[1] * 2, BR)) ||
      (rc = hop::make_map_3d(&wm, dw, fp16, N, K, n_experts, (long long)N * 2,
                             (long long)K * N * 2, 64)))
    return rc;
  auto kernel = gmm_dw_kernel<T>;
  // once per process: the most any launch asks for
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int m_tiles = (K + BM - 1) / BM, n_tiles = (N + BN - 1) / BN;
  const int bytes = CNT_OFF + 4 * n_experts + 1024;
  kernel<<<min(ctas, n_experts * m_tiles * n_tiles), NTHREADS, bytes, stream>>>(
      xm, dm, wm, be, static_cast<T*>(dw), K, N, br, nb, n_experts, m_tiles, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The most experts one launch takes (their block counts live in shared
// memory beside the ring).
int fat_gmm_dw_max_experts() { return MAX_EXPERTS; }

// strides: 2 int64 in elements, the row strides of x and dy (multiples of
// 8; x and dy 16-byte aligned). n_rows = nb * br with br a multiple of 64;
// K and N multiples of 8; n_experts at most fat_gmm_dw_max_experts(). dw
// is a contiguous (n_experts, K, N) tensor. At most `ctas` CTAs (one an SM)
// walk the tiles.
int fat_gmm_dw(const void* x, const void* dy, const void* block_expert, void* dw,
               int n_rows, int K, int N, int br, int nb, int n_experts,
               const long long* strides, int is_fp16, int ctas, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (br % BR || n_rows != nb * br || K % 8 || N % 8 || n_experts < 1 || ctas < 1 ||
      n_experts > MAX_EXPERTS)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows == 0)
    return static_cast<int>(
        cudaMemsetAsync(dw, 0, (size_t)n_experts * K * N * 2, s));
  const int* be = static_cast<const int*>(block_expert);
  return is_fp16 ? launch<__half>(x, dy, be, dw, n_rows, K, N, br, nb, n_experts, strides,
                                  ctas, s)
                 : launch<__nv_bfloat16>(x, dy, be, dw, n_rows, K, N, br, nb, n_experts,
                                         strides, ctas, s);
}

}  // extern "C"
