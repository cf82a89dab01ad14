// Grouped matmul for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces: flash_attention_tpu/ops/moe.py::_gmm_kernel (the Pallas TPU
// kernel launched by _gmm_impl).
//
// Computes y[r] = x[r] . w[e(r)] for x (n_rows, K) and w (E, K, N), where
// e(r) = block_expert[r / br] is the expert of row r's block, and rows of a
// dead block (e = -1) are exactly 0. bf16 or fp16 in and out, fp32
// accumulator rounded once. w is read through its strides with either its N
// dim contiguous (the weights as stored) or its K dim contiguous (the view
// w.transpose(1, 2) the backward uses for dx = dy . w^T), so the transpose
// is never copied. x is read through its row stride; y is contiguous.
//
// What bounds it on the H100: at Mixtral's prefill and training shapes (K
// and N 4096 or 14336, a few hundred 128-row blocks) the operations: 2 K N
// FLOP a row against 2 (K + N) bytes, 3.89 ms at 989 TFLOP/s for the
// prefill gate/up product (16384 x 2 rows). At decode (16 live rows in up to
// 8 live blocks) the bytes of the live experts' weights: 0.25 ms at 3.35
// TB/s for gate/up.
//
// What the design does about it: every product on wgmma, every operand by
// TMA, warp-specialised and persistent, on hopper_common.cuh:
// * A tile is 128 rows (exactly one 128-row block, so one expert: the
//   wrapper requires rows per block to be a multiple of 128) by 256 columns.
// * Warpgroup 0, the producer: one thread streams 64-deep k steps by TMA
//   into a ring of 4 stages of 48 KB, each a box of x (128 rows, K-major, a
//   2-D map over the row stride) and 64 k rows of w[e] from a 3-D map over
//   (E, K, N) built from w's own strides: MN-major boxes of 64 columns when
//   N is contiguous, one K-major box of 256 rows when K is (the view w^T).
//   TMA zero-fills past K and N, so a box never reads the next expert's
//   rows; weight boxes wholly past N are not loaded. A full and an empty
//   mbarrier per stage.
// * Warpgroups 1 and 2, the consumers, own 64 rows each and issue wgmma
//   m64n256k16 from shared memory (x K-major; w MN-major or K-major by the
//   transpose flag), 128 fp32 accumulators a thread, setmaxnreg moving
//   registers from the producer (40) to them (232). One stage's product is
//   in flight while the next is issued; a stage is released as soon as its
//   product is done.
// * Persistent: one CTA per SM walks the tiles in grouped raster order
//   (fat::raster, 16 row tiles a group), so the tiles in flight share x rows
//   and weight columns through the L2. The producer runs ahead into the next
//   tile's stages while the consumers round and store the last one.
// * The epilogue: each consumer rounds its accumulator, 128 columns at a
//   time, into a 16 KB shared-memory buffer (128-byte swizzled boxes, no
//   bank conflicts), and one thread stores it by TMA, which runs on while
//   the consumers start the next tile.
// * A dead block's tile loads nothing: its consumers write zeros (the TPU
//   kernel fetched expert 0's tile for it). Pad rows inside a live block are
//   computed: the signature carries no per-block live count.
// * k16 steps are summed in k order, as the mma.sync kernel this replaces
//   did, so its outputs are reproduced bit for bit. No atomics: repeats are
//   bit-identical.
// * Tensor maps are encoded on the host per call (driver calls, no device
//   work) and passed as __grid_constant__ parameters: the launch can be
//   captured in a CUDA graph.

#include "flash_common.cuh"
#include "gmm_common.cuh"
#include "hopper_common.cuh"

namespace {

constexpr int BM = 128;        // rows a tile: one block of one expert
constexpr int BN = 256;        // columns a tile
constexpr int BK = 64;         // k a stage: one 128-byte box of x
constexpr int S = 4;           // ring stages
constexpr int NTHREADS = 384;  // producer + 2 consumer warpgroups
constexpr int GROUP_M = 16;
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;  // 128 * 40 + 256 * 232 <= 65536
constexpr int X_BYTES = BM * BK * 2;
constexpr int W_BYTES = BK * BN * 2;
constexpr int BOX_BYTES = 64 * 128;  // a box of 64 rows by 64 columns
constexpr int STAGE_BYTES = X_BYTES + W_BYTES;
constexpr int EPI_OFF = S * STAGE_BYTES;
constexpr int BAR_OFF = EPI_OFF + 2 * fat::EPI_BYTES;
// slack to align the tiles to 1024 bytes, the swizzle's period
constexpr int SMEM_BYTES = BAR_OFF + 2 * S * 8 + 1024;

// KN: w's N dim is contiguous (MN-major B); else its K dim (K-major B).
template <typename T, bool KN>
__global__ void __launch_bounds__(NTHREADS, 1)
gmm_kernel(const __grid_constant__ CUtensorMap x_map,
           const __grid_constant__ CUtensorMap w_map,
           const __grid_constant__ CUtensorMap y_map,
           const int* __restrict__ block_expert, T* __restrict__ y, int N,
           int k_steps, int br, int m_tiles, int n_tiles) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (hop::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + BAR_OFF);
  uint64_t* empty = full + S;
  const int tiles = m_tiles * n_tiles;

  const int role = __shfl_sync(0xffffffff, threadIdx.x / 128, 0);
  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      hop::mbar_init(&full[i], 1);
      hop::mbar_init(&empty[i], 8);  // one arrival per consumer warp
    }
    hop::mbar_fence_init();
  }
  __syncthreads();

  if (role == 0) {
    // ---- producer ----
    hop::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      hop::prefetch_map(&x_map);
      hop::prefetch_map(&w_map);
      int it = 0;  // stages filled so far, over all of this CTA's tiles
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        int mt, nt;
        fat::raster(tile, m_tiles, n_tiles, GROUP_M, mt, nt);
        const int e = block_expert[mt * BM / br];
        if (e < 0) continue;  // dead block: no loads
        const int n0 = nt * BN;
        const int w_boxes = KN ? min(BN / 64, (N - n0 + 63) / 64) : 1;
        const uint32_t bytes = X_BYTES + (KN ? w_boxes * BOX_BYTES : W_BYTES);
        for (int j = 0; j < k_steps; ++j, ++it) {
          const int st = it % S;
          if (it >= S) hop::mbar_wait(&empty[st], (it / S - 1) & 1);
          uint8_t* xs = smem + st * STAGE_BYTES;
          uint8_t* ws = xs + X_BYTES;
          hop::mbar_expect_tx(&full[st], bytes);
          hop::tma_load_2d(xs, &x_map, &full[st], j * BK, mt * BM);
          if constexpr (KN) {
            for (int q = 0; q < w_boxes; ++q)
              hop::tma_load_3d(ws + q * BOX_BYTES, &w_map, &full[st], n0 + 64 * q,
                               j * BK, e);
          } else {
            hop::tma_load_3d(ws, &w_map, &full[st], j * BK, n0, e);
          }
        }
      }
    }
    return;
  }

  // ---- consumers ----
  hop::setmaxnreg_inc<CONSUMER_REGS>();
  const int c = role - 1;  // rows 64 c .. 64 c + 63 of each tile
  const int tid = threadIdx.x % 128, lane = tid % 32;
  const uint32_t base = hop::smem_u32(smem);
  uint8_t* epi = smem + EPI_OFF + c * fat::EPI_BYTES;
  float acc[BN / 2];
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    int mt, nt;
    fat::raster(tile, m_tiles, n_tiles, GROUP_M, mt, nt);
    const int e = block_expert[mt * BM / br];
    const int n0 = nt * BN;
    const long long r0 = (long long)mt * BM + 64 * c;
    if (e < 0) {  // dead block: zeros
      const uint4 z = make_uint4(0, 0, 0, 0);
      for (int i = tid; i < 64 * BN / 8; i += 128) {
        const int r = i / (BN / 8), col = n0 + (i % (BN / 8)) * 8;
        if (col < N) *reinterpret_cast<uint4*>(y + (r0 + r) * N + col) = z;
      }
      continue;
    }
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    for (int j = 0; j < k_steps; ++j, ++it) {
      const int st = it % S;
      hop::mbar_wait(&full[st], (it / S) & 1);
      const uint32_t xs = base + st * STAGE_BYTES + c * 64 * 128;
      const uint32_t ws = base + st * STAGE_BYTES + X_BYTES;
      hop::fence_regs(acc);
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t a = hop::desc_sw128(xs + kk * 32, 16, 1024);
        const uint64_t b = KN ? hop::desc_sw128(ws + kk * 16 * 128, BOX_BYTES, 1024)
                              : hop::desc_sw128(ws + kk * 32, 16, 1024);
        hop::WgmmaSs<T, BN, 0, KN ? 1 : 0>::ss(acc, a, b, 1);
      }
      hop::wgmma_commit();
      hop::wgmma_wait<1>();  // the product of the stage before is done
      if (j > 0 && lane == 0) hop::mbar_arrive(&empty[(it - 1) % S]);
    }
    hop::wgmma_wait<0>();
    hop::fence_regs(acc);
    if (lane == 0) hop::mbar_arrive(&empty[(it - 1) % S]);

    fat::store_half<T, BN, 0>(epi, acc, &y_map, n0, static_cast<int>(r0), 0, N, tid, c);
    fat::store_half<T, BN, 1>(epi, acc, &y_map, n0, static_cast<int>(r0), 0, N, tid, c);
  }
  if (tid == 0) hop::tma_store_wait_read<0>();  // shared memory outlives the stores
}

template <typename T, bool KN>
int launch(const CUtensorMap (&m)[3], const int* be, void* y, int n_rows, int K, int N,
           int br, int ctas, cudaStream_t stream) {
  auto kernel = gmm_kernel<T, KN>;
  // once per process (the attribute holds for the function from then on)
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int m_tiles = n_rows / BM, n_tiles = (N + BN - 1) / BN;
  kernel<<<min(ctas, m_tiles * n_tiles), NTHREADS, SMEM_BYTES, stream>>>(
      m[0], m[1], m[2], be, static_cast<T*>(y), N, (K + BK - 1) / BK, br, m_tiles,
      n_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// strides: 3 int64 in elements: x's row stride, w's expert stride, and w's
// stride along K (kn = 1, N contiguous) or along N (kn = 0, K contiguous),
// each a multiple of 8; x and w 16-byte aligned. n_rows is a positive
// multiple of 128 and of br; br a multiple of 128; K and N multiples of 8,
// N positive. y is a contiguous (n_rows, N) tensor. At most `ctas` CTAs (one
// an SM) walk the tiles. K = 0 writes zeros.
int fat_gmm(const void* x, const void* w, const void* block_expert, void* y,
            int n_rows, int K, int N, int br, int n_experts, int kn,
            const long long* strides, int is_fp16, int ctas, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_rows < 1 || n_rows % BM || br % BM || K % 8 || N < 1 || N % 8 || n_experts < 1 ||
      ctas < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (K == 0)
    return static_cast<int>(cudaMemsetAsync(y, 0, (size_t)n_rows * N * 2, s));
  CUtensorMap m[3];  // x, w, y
  int rc;
  const CUtensorMapDataType type =
      is_fp16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if ((rc = hop::make_map_2d(&m[0], x, type, K, n_rows, strides[0] * 2, BM)) ||
      (rc = hop::make_map_3d(&m[2], y, is_fp16, N, n_rows, 1, (long long)N * 2,
                             (long long)N * 2 * n_rows, 64)))
    return rc;
  // (E, K, N) with N contiguous: boxes of 64 columns by 64 k rows; with K
  // contiguous: boxes of 64 k by 256 columns
  rc = kn ? hop::make_map_3d(&m[1], w, is_fp16, N, K, n_experts, strides[2] * 2,
                             strides[1] * 2, BK)
          : hop::make_map_3d(&m[1], w, is_fp16, K, N, n_experts, strides[2] * 2,
                             strides[1] * 2, BN);
  if (rc) return rc;
  const int* be = static_cast<const int*>(block_expert);
  if (is_fp16)
    return kn ? launch<__half, true>(m, be, y, n_rows, K, N, br, ctas, s)
              : launch<__half, false>(m, be, y, n_rows, K, N, br, ctas, s);
  return kn ? launch<__nv_bfloat16, true>(m, be, y, n_rows, K, N, br, ctas, s)
            : launch<__nv_bfloat16, false>(m, be, y, n_rows, K, N, br, ctas, s);
}

}  // extern "C"
