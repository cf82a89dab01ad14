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
// What bounds it on the H100: at the MoE shapes (K and N 4096 or 14336, a
// few hundred 128-row blocks) the products are compute-bound (about 2 K N
// FLOP per row against 2 (K + N) bytes). At decode (a handful of live rows)
// it is bound by the bytes of the live experts' weights.
//
// What the design does about it: the tensor cores through mma.sync
// m16n8k16 with ldmatrix fragment loads. One CTA of 8 warps owns a
// 128 x 128 output tile (each warp 32 x 64), and 32-deep K slices of x and w
// stream through a two-stage cp.async ring in padded shared memory (row
// strides 40 and 136 elements: conflict-free ldmatrix). The tile raster
// groups 16 row tiles, so resident CTAs share their x rows and weight
// columns through the L2 cache. A dead block's CTA reads its expert id,
// writes zeros and returns: it loads no weights (the TPU kernel fetched
// expert 0's tile for it). Left for later work: wgmma, TMA and warp
// specialisation.

#include "gmm_common.cuh"

namespace {

using fat::Mma;

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int NTHREADS = 256;  // 8 warps: 4 along M x 2 along N
constexpr int GROUP_M = 16;
constexpr int A_LD = BK + 8;   // x tile (BM rows of BK)
constexpr int BKN_LD = BN + 8;  // w tile stored (k, n): BK rows of BN
constexpr int BNK_LD = BK + 8;  // w tile stored (n, k): BN rows of BK
constexpr int A_ELEMS = BM * A_LD;
constexpr int B_ELEMS = BN * BNK_LD > BK * BKN_LD ? BN * BNK_LD : BK * BKN_LD;

// KN: w's N dim is contiguous (w_so = stride of K); else its K dim is
// contiguous (w_so = stride of N).
template <typename T, bool KN>
__global__ void __launch_bounds__(NTHREADS, 2)
gmm_kernel(const T* __restrict__ x, const T* __restrict__ w,
           const int* __restrict__ block_expert, T* __restrict__ y, int K, int N,
           int br, long long x_ld, long long w_se, long long w_so, int m_tiles,
           int n_tiles) {
  __shared__ __align__(16) T a_s[2][A_ELEMS];
  __shared__ __align__(16) T b_s[2][B_ELEMS];

  int mt, nt;
  fat::raster(blockIdx.x, m_tiles, n_tiles, GROUP_M, mt, nt);
  const int m0 = mt * BM, n0 = nt * BN;
  const int tid = threadIdx.x;
  const int e = block_expert[m0 / br];

  if (e < 0) {  // dead block: zeros, no loads
    const uint4 z = make_uint4(0, 0, 0, 0);
    for (int i = tid; i < BM * BN / 8; i += NTHREADS) {
      const int r = i / (BN / 8), c = n0 + (i % (BN / 8)) * 8;
      if (c < N) *reinterpret_cast<uint4*>(y + (long long)(m0 + r) * N + c) = z;
    }
    return;
  }

  const T* xb = x + m0 * x_ld;
  const T* wb = w + e * w_se;
  auto load = [&](int stage, int k0) {
    T* as = a_s[stage];
    T* bs = b_s[stage];
    for (int i = tid; i < BM * BK / 8; i += NTHREADS) {
      const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
      const bool ok = k0 + c < K;
      fat::cp_async16(as + r * A_LD + c, ok ? xb + r * x_ld + k0 + c : xb, ok);
    }
    if (KN) {
      for (int i = tid; i < BK * BN / 8; i += NTHREADS) {
        const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
        const bool ok = k0 + r < K && n0 + c < N;
        fat::cp_async16(bs + r * BKN_LD + c, ok ? wb + (k0 + r) * w_so + n0 + c : wb,
                        ok);
      }
    } else {
      for (int i = tid; i < BN * BK / 8; i += NTHREADS) {
        const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
        const bool ok = n0 + r < N && k0 + c < K;
        fat::cp_async16(bs + r * BNK_LD + c, ok ? wb + (n0 + r) * w_so + k0 + c : wb,
                        ok);
      }
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

  const int k_steps = (K + BK - 1) / BK;
  load(0, 0);
  fat::cp_async_commit();
  for (int ks = 0; ks < k_steps; ++ks) {
    if (ks + 1 < k_steps) load((ks + 1) & 1, (ks + 1) * BK);
    fat::cp_async_commit();
    fat::cp_async_wait<1>();
    __syncthreads();
    const T* as = a_s[ks & 1];
    const T* bs = b_s[ks & 1];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        fat::ldmatrix_x4(a[mi], as + (wm + mi * 16 + lane % 16) * A_LD + kk +
                                    (lane / 16) * 8);
      uint32_t b[8][2];
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        uint32_t r[4];
        if (KN)
          fat::ldmatrix_x4_trans(
              r, bs + (kk + lane % 8 + ((lane / 8) % 2) * 8) * BKN_LD + wn + nj * 16 +
                     (lane / 16) * 8);
        else
          fat::ldmatrix_x4(r, bs + (wn + nj * 16 + lane % 8 + (lane / 16) * 8) * BNK_LD +
                                  kk + ((lane / 8) % 2) * 8);
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
    __syncthreads();  // every warp is done with this stage before it refills
  }

  fat::store_acc<T>(y + (long long)m0 * N, N, acc, wm, n0 + wn, BM, N, g, t);
}

template <typename T>
void launch(const void* x, const void* w, const int* be, void* y, int n_rows, int K,
            int N, int br, int kn, const long long* st, cudaStream_t stream) {
  const int m_tiles = n_rows / BM;
  const int n_tiles = (N + BN - 1) / BN;
  const dim3 grid(m_tiles * n_tiles);
  if (kn)
    gmm_kernel<T, true><<<grid, NTHREADS, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w), be, static_cast<T*>(y), K,
        N, br, st[0], st[1], st[2], m_tiles, n_tiles);
  else
    gmm_kernel<T, false><<<grid, NTHREADS, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w), be, static_cast<T*>(y), K,
        N, br, st[0], st[1], st[2], m_tiles, n_tiles);
}

}  // namespace

extern "C" {

// strides: 3 int64 in elements: x's row stride, w's expert stride, and w's
// stride along K (kn = 1, N contiguous) or along N (kn = 0, K contiguous).
// n_rows is a multiple of 128 and of br; br a multiple of 128; K and N
// multiples of 8. y is a contiguous (n_rows, N) tensor.
int fat_gmm(const void* x, const void* w, const void* block_expert, void* y,
            int n_rows, int K, int N, int br, int kn, const long long* strides,
            int is_fp16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* be = static_cast<const int*>(block_expert);
  if (n_rows % BM || br % BM || K % 8 || N % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  if (is_fp16)
    launch<__half>(x, w, be, y, n_rows, K, N, br, kn, strides, s);
  else
    launch<__nv_bfloat16>(x, w, be, y, n_rows, K, N, br, kn, strides, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
