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
// trash slot, so repeats are bit-identical. An expert with no rows gets
// exact zeros (the TPU kernel never visits that output block and leaves it
// unwritten).
//
// What bounds it on the H100: at the training shapes (K and N 4096 or 14336,
// about 1170 rows per expert) it is compute-bound: 2 K N FLOP per row against
// 2 (K + N) bytes read.
//
// What the design does about it: one CTA of 8 warps per (expert, 128 x 128
// tile of dW); the sum over rows is the CTA's own loop, so nothing crosses
// CTAs. Each step brings 32 rows of the x and dy column tiles through a
// two-stage cp.async ring in padded shared memory; the x tile is the A
// operand transposed (ldmatrix .trans), dy the B operand (ldmatrix .trans),
// into mma.sync m16n8k16 with fp32 accumulators (each warp 32 x 64). CTAs run
// expert by expert, the tiles of one expert rastered in groups of 16 K tiles
// so resident CTAs share x and dy columns through the L2 cache. Left for
// later work: wgmma, TMA and warp specialisation.

#include "gmm_common.cuh"

namespace {

using fat::Mma;

constexpr int BM = 128, BN = 128, BK = 32;  // dW tile BM (K) x BN (N); BK rows
constexpr int NTHREADS = 256;
constexpr int GROUP_M = 16;
constexpr int LD = 128 + 8;  // both tiles stored (row, column): BK rows

// The first block after `after` whose expert is e, or nb.
__device__ __forceinline__ int next_block(const int* be, int nb, int e, int after) {
  for (int i = after + 1; i < nb; ++i)
    if (be[i] == e) return i;
  return nb;
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS, 2)
gmm_dw_kernel(const T* __restrict__ x, const T* __restrict__ dy,
              const int* __restrict__ block_expert, T* __restrict__ dw, int K, int N,
              int br, int nb, long long x_ld, long long dy_ld, int m_tiles,
              int n_tiles) {
  __shared__ __align__(16) T x_s[2][BK * LD];
  __shared__ __align__(16) T d_s[2][BK * LD];

  const int per_expert = m_tiles * n_tiles;
  const int e = blockIdx.x / per_expert;
  int mt, nt;
  fat::raster(blockIdx.x % per_expert, m_tiles, n_tiles, GROUP_M, mt, nt);
  const int k0 = mt * BM, n0 = nt * BN;
  const int tid = threadIdx.x;

  // how many of the blocks belong to e (the same count in every thread)
  int n_match = 0;
  for (int i0 = 0; i0 < nb; i0 += NTHREADS) {
    const int i = i0 + tid;
    n_match += __syncthreads_count(i < nb && block_expert[i] == e);
  }
  const int sub_steps = br / BK;
  const int n_steps = n_match * sub_steps;

  // producer position: (block, sub-step) of the next rows to load
  int p_blk = next_block(block_expert, nb, e, -1), p_sub = 0;
  auto load = [&](int stage) {
    const long long r0 = (long long)p_blk * br + p_sub * BK;
    T* xs = x_s[stage];
    T* ds = d_s[stage];
    for (int i = tid; i < BK * BM / 8; i += NTHREADS) {
      const int r = i / (BM / 8), c = (i % (BM / 8)) * 8;
      const bool ok = k0 + c < K;
      fat::cp_async16(xs + r * LD + c, ok ? x + (r0 + r) * x_ld + k0 + c : x, ok);
    }
    for (int i = tid; i < BK * BN / 8; i += NTHREADS) {
      const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
      const bool ok = n0 + c < N;
      fat::cp_async16(ds + r * LD + c, ok ? dy + (r0 + r) * dy_ld + n0 + c : dy, ok);
    }
    if (++p_sub == sub_steps) {
      p_sub = 0;
      p_blk = next_block(block_expert, nb, e, p_blk);
    }
  };

  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp % 4) * 32, wn = (warp / 4) * 64;
  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.f;

  if (n_steps > 0) load(0);
  fat::cp_async_commit();
  for (int s = 0; s < n_steps; ++s) {
    if (s + 1 < n_steps) load((s + 1) & 1);
    fat::cp_async_commit();
    fat::cp_async_wait<1>();
    __syncthreads();
    const T* xs = x_s[s & 1];
    const T* ds = d_s[s & 1];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      // A = x^T: A[m][r] = xs[r][m]; four 8 x 8 matrices (m, r) = (0, 0),
      // (8, 0), (0, 8), (8, 8), each read transposed
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        fat::ldmatrix_x4_trans(a[mi], xs + (kk + lane % 8 + (lane / 16) * 8) * LD + wm +
                                          mi * 16 + ((lane / 8) % 2) * 8);
      uint32_t b[8][2];
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        uint32_t r[4];
        fat::ldmatrix_x4_trans(r, ds + (kk + lane % 8 + ((lane / 8) % 2) * 8) * LD + wn +
                                      nj * 16 + (lane / 16) * 8);
        b[2 * nj][0] = r[0];
        b[2 * nj][1] = r[1];
        b[2 * nj + 1][0] = r[2];
        b[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 8; ++ni) Mma<T>::run(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
    }
    __syncthreads();
  }

  fat::store_acc<T>(dw + (long long)e * K * N, N, acc, k0 + wm, n0 + wn, K, N, g, t);
}

}  // namespace

extern "C" {

// strides: 2 int64 in elements, the row strides of x and dy. n_rows = nb * br
// with br a multiple of 32; K and N multiples of 8. dw is a contiguous
// (n_experts, K, N) tensor.
int fat_gmm_dw(const void* x, const void* dy, const void* block_expert, void* dw,
               int n_rows, int K, int N, int br, int nb, int n_experts,
               const long long* strides, int is_fp16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* be = static_cast<const int*>(block_expert);
  if (br % BK || n_rows != nb * br || K % 8 || N % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const int m_tiles = (K + BM - 1) / BM, n_tiles = (N + BN - 1) / BN;
  const dim3 grid(n_experts * m_tiles * n_tiles);
  if (is_fp16)
    gmm_dw_kernel<__half><<<grid, NTHREADS, 0, s>>>(
        static_cast<const __half*>(x), static_cast<const __half*>(dy), be,
        static_cast<__half*>(dw), K, N, br, nb, strides[0], strides[1], m_tiles,
        n_tiles);
  else
    gmm_dw_kernel<__nv_bfloat16><<<grid, NTHREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(dy), be,
        static_cast<__nv_bfloat16*>(dw), K, N, br, nb, strides[0], strides[1], m_tiles,
        n_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
