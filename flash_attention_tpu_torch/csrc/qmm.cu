// Weight-only quantized matmul for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces: flash_attention_tpu/ops/quant.py::_qmm_kernel (the Pallas TPU
// kernel launched by quantized_matmul).
//
// Computes y[m, n] = (sum_k x[m, k] q[k, n]) s[n] for bf16 or fp16
// activations x (M, K) (row stride ldx), int8 weights q (K, N), or int4
// weights packed two to a byte along K ((K / 2, N) bytes, row i holding
// logical rows 2i in its low nibble and 2i + 1 in its high nibble), and fp32
// per-channel scales s (N,). The sum is fp32; the scale is applied once to
// it and the result rounded once to the output type. The activations are
// never quantised: every |q| <= 127 is exact in bf16 and fp16, so q is
// converted to x's type and multiplied on the tensor cores as it is.
//
// What bounds it on the H100: at decode (m = 8 rows) the weight's bytes, at
// 1 byte (int8) or half a byte (int4) per weight: a 4096 x 14336 int8
// gate/up weight is 58.7 MB, 17.5 us at 3.35 TB/s, against 0.9 GFLOP. At
// prefill (m = 16384) the operations: 2 m k n, 1.9 TFLOP for the same
// weight, 1.95 ms at 989 TFLOP/s, against 58.7 MB of weights.
//
// What the design does about it:
// - The tensor cores through mma.sync m16n8k16. A CTA of 8 warps owns a
//   BM x 128 output tile: BM = 128 for prefill (each warp 32 x 64, as in
//   gmm.cu), BM = 16 for decode (each warp 16 x 16), so a decode CTA does
//   no work on rows that do not exist beyond the 16-row mma tile.
// - 32-deep K slices of x and of the raw weight bytes stream through a
//   cp.async ring in shared memory (2 stages at BM = 128; 4 at BM = 16, to
//   keep more weight bytes in flight when the CTA has little math to hide
//   them behind). The weight crosses device memory once, in its quantised
//   width: dequantisation happens in shared memory, never in device memory.
// - Each k step converts the landed int8 or int4 slice to a 32 x 128 tile
//   of x's type in shared memory (16 bytes a thread, sign-extended by
//   shifts), then the warps read B fragments from it with ldmatrix.trans,
//   as gmm.cu does for its weights. Chosen over gathering two bytes per B
//   register from the raw tile: every weight byte is converted once per CTA
//   rather than once per warp that reads it (4 at BM = 128), and the
//   fragment loads stay 4 ldmatrix per k16 step instead of 32 byte loads.
//   For int4 the packed layout helps the conversion: one packed byte row
//   gives two adjacent rows of the tile.
// - Decode grids are short: 8 CTAs for n = 1024 against 132 SMs. The
//   wrapper (ops/quant.py::plan) then splits K over blockIdx.y: each split
//   writes an unscaled fp32 partial tile to a workspace, and a second
//   kernel sums the splits in a fixed order, scales and rounds. No atomics,
//   so repeats are bit-identical.
// - Ragged edges: rows past M and columns past N are zero-filled on load
//   and skipped on store; the last K slice is zero-filled past K (a partial
//   16-byte copy of x, whole weight rows masked), and 0 * q adds nothing.
//   N must be a multiple of 16 (16-byte weight rows; the wrapper pads).
// Left for later work: wgmma, TMA, warp specialisation, a persistent
// stream-K schedule in place of the split and its second pass.

#include "gmm_common.cuh"

namespace {

using fat::Mma;

constexpr int BN = 128, BK = 32;
constexpr int NTHREADS = 256;
constexpr int GROUP_M = 16;
constexpr int A_LD = BK + 8;  // x tile: BM rows of BK (padded: ldmatrix conflict-free)
constexpr int W_LD = BN + 8;  // dequantised weight tile: BK rows of BN

template <int BM>
struct Tile {
  static constexpr int STAGES = BM == 16 ? 4 : 2;
  static constexpr int WARPS_M = BM == 16 ? 1 : 4;
  static constexpr int WARPS_N = 8 / WARPS_M;
  static constexpr int WM = BM / WARPS_M;  // rows per warp: 16 or 32
  static constexpr int WN = BN / WARPS_N;  // columns per warp: 16 or 64
  static constexpr int MI = WM / 16, NI = WN / 8;
  static constexpr int MIN_BLOCKS = BM == 16 ? 4 : 2;
};

// 16 bytes from `src` to shared `dst`, of which the first `bytes` are read
// and the rest zero-filled (src is not read when bytes == 0).
__device__ __forceinline__ void cp_async_bytes(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(fat::smem_addr(dst)),
               "l"(src), "r"(bytes));
}

// Signed byte j (0..3) and signed nibble j (0..7) of a word.
__device__ __forceinline__ int sbyte(uint32_t w, int j) {
  return static_cast<int>(w << (24 - 8 * j)) >> 24;
}
__device__ __forceinline__ int snib(uint32_t w, int j) {
  return static_cast<int>(w << (28 - 4 * j)) >> 28;
}

template <typename T>
__device__ __forceinline__ void store16(T* dst, const uint32_t (&o)[8]) {
  reinterpret_cast<uint4*>(dst)[0] = make_uint4(o[0], o[1], o[2], o[3]);
  reinterpret_cast<uint4*>(dst)[1] = make_uint4(o[4], o[5], o[6], o[7]);
}

// ws == nullptr: y = acc * s rounded to T. Otherwise the unscaled fp32
// partial of split blockIdx.y goes to ws[split][M][N].
template <typename T, int BITS, int BM>
__global__ void __launch_bounds__(NTHREADS, Tile<BM>::MIN_BLOCKS)
qmm_kernel(const T* __restrict__ x, const uint8_t* __restrict__ q,
           const float* __restrict__ s, T* __restrict__ y, float* __restrict__ ws, int M,
           int K, int N, long long ldx, int split_steps, int m_tiles, int n_tiles) {
  using C = Tile<BM>;
  constexpr int S = C::STAGES;
  constexpr int QROWS = BITS == 8 ? BK : BK / 2;  // byte rows per k step
  __shared__ __align__(16) T a_s[S][BM * A_LD];
  __shared__ __align__(16) uint8_t q_s[S][QROWS * BN];
  __shared__ __align__(16) T w_s[BK * W_LD];

  int mt, nt;
  fat::raster(blockIdx.x, m_tiles, n_tiles, GROUP_M, mt, nt);
  const int m0 = mt * BM, n0 = nt * BN;
  const int tid = threadIdx.x;
  const int k_steps = (K + BK - 1) / BK;
  const int ks0 = blockIdx.y * split_steps;
  const int n_steps = max(0, min(ks0 + split_steps, k_steps) - ks0);
  const int q_rows = BITS == 8 ? K : K / 2;

  auto load = [&](int stage, int k0) {
    T* as = a_s[stage];
    for (int i = tid; i < BM * BK / 8; i += NTHREADS) {
      const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
      const int bytes = m0 + r < M ? max(0, min(16, (K - k0 - c) * 2)) : 0;
      cp_async_bytes(as + r * A_LD + c, bytes ? x + (m0 + r) * ldx + k0 + c : x, bytes);
    }
    uint8_t* qs = q_s[stage];
    const int qr0 = BITS == 8 ? k0 : k0 / 2;
    for (int i = tid; i < QROWS * BN / 16; i += NTHREADS) {
      const int r = i / (BN / 16), c = (i % (BN / 16)) * 16;
      const bool ok = qr0 + r < q_rows && n0 + c < N;
      fat::cp_async16(qs + r * BN + c, ok ? q + (long long)(qr0 + r) * N + n0 + c : q, ok);
    }
  };

  // the landed weight bytes of `stage` -> w_s in T, 16 columns a thread
  auto convert = [&](int stage) {
    const uint8_t* qs = q_s[stage];
    for (int i = tid; i < QROWS * BN / 16; i += NTHREADS) {
      const int r = i / (BN / 16), c = (i % (BN / 16)) * 16;
      const uint4 raw = *reinterpret_cast<const uint4*>(qs + r * BN + c);
      const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
      if (BITS == 8) {
        uint32_t o[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)  // columns 2j, 2j + 1: bytes 2(j%2), +1 of word j/2
          o[j] = Mma<T>::pack(float(sbyte(w[j / 2], 2 * (j % 2))),
                              float(sbyte(w[j / 2], 2 * (j % 2) + 1)));
        store16(w_s + r * W_LD + c, o);
      } else {
        uint32_t lo[8], hi[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {  // byte b holds nibbles 2b (row 2r), 2b + 1 (row 2r + 1)
          const int b0 = 2 * (j % 2), b1 = b0 + 1;
          lo[j] = Mma<T>::pack(float(snib(w[j / 2], 2 * b0)),
                               float(snib(w[j / 2], 2 * b1)));
          hi[j] = Mma<T>::pack(float(snib(w[j / 2], 2 * b0 + 1)),
                               float(snib(w[j / 2], 2 * b1 + 1)));
        }
        store16(w_s + (2 * r) * W_LD + c, lo);
        store16(w_s + (2 * r + 1) * W_LD + c, hi);
      }
    }
  };

  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp % C::WARPS_M) * C::WM, wn = (warp / C::WARPS_M) * C::WN;
  float acc[C::MI][C::NI][4];
#pragma unroll
  for (int mi = 0; mi < C::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < C::NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

#pragma unroll
  for (int st = 0; st < S - 1; ++st) {
    if (st < n_steps) load(st, (ks0 + st) * BK);
    fat::cp_async_commit();
  }
  for (int it = 0; it < n_steps; ++it) {
    fat::cp_async_wait<S - 2>();
    __syncthreads();  // step `it` landed; every warp is done with step it - 1
    const int nxt = it + S - 1;
    if (nxt < n_steps) load(nxt % S, (ks0 + nxt) * BK);
    fat::cp_async_commit();
    convert(it % S);
    __syncthreads();
    const T* as = a_s[it % S];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[C::MI][4];
#pragma unroll
      for (int mi = 0; mi < C::MI; ++mi)
        fat::ldmatrix_x4(a[mi], as + (wm + mi * 16 + lane % 16) * A_LD + kk + (lane / 16) * 8);
      uint32_t b[C::NI][2];
#pragma unroll
      for (int nj = 0; nj < C::NI / 2; ++nj) {
        uint32_t r[4];
        fat::ldmatrix_x4_trans(r, w_s + (kk + lane % 8 + ((lane / 8) % 2) * 8) * W_LD + wn +
                                      nj * 16 + (lane / 16) * 8);
        b[2 * nj][0] = r[0];
        b[2 * nj][1] = r[1];
        b[2 * nj + 1][0] = r[2];
        b[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < C::MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < C::NI; ++ni) Mma<T>::run(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
    }
  }

#pragma unroll
  for (int ni = 0; ni < C::NI; ++ni) {
    const int c = n0 + wn + ni * 8 + 2 * t;
    if (c >= N) continue;
    const float2 sc = ws ? make_float2(1.f, 1.f) : *reinterpret_cast<const float2*>(s + c);
#pragma unroll
    for (int mi = 0; mi < C::MI; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + wm + mi * 16 + g + h * 8;
        if (r >= M) continue;
        const float v0 = acc[mi][ni][2 * h], v1 = acc[mi][ni][2 * h + 1];
        if (ws)
          *reinterpret_cast<float2*>(ws + ((long long)blockIdx.y * M + r) * N + c) =
              make_float2(v0, v1);
        else
          *reinterpret_cast<uint32_t*>(y + (long long)r * N + c) =
              Mma<T>::pack(v0 * sc.x, v1 * sc.y);
      }
  }
}

template <typename O>
__device__ __forceinline__ void store4(O* p, float4 v);
template <>
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
template <>
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  *reinterpret_cast<uint2*>(p) = make_uint2(Mma<__nv_bfloat16>::pack(v.x, v.y),
                                            Mma<__nv_bfloat16>::pack(v.z, v.w));
}
template <>
__device__ __forceinline__ void store4(__half* p, float4 v) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(Mma<__half>::pack(v.x, v.y), Mma<__half>::pack(v.z, v.w));
}

// y = (sum over splits of ws) * s, 4 columns a thread, splits summed in order.
template <typename O>
__global__ void qmm_reduce_kernel(const float* __restrict__ ws, const float* __restrict__ s,
                                  O* __restrict__ y, long long mn, int N, int splits) {
  const long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i >= mn) return;
  float4 a = *reinterpret_cast<const float4*>(ws + i);
  for (int sp = 1; sp < splits; ++sp) {
    const float4 b = *reinterpret_cast<const float4*>(ws + sp * mn + i);
    a.x += b.x;
    a.y += b.y;
    a.z += b.z;
    a.w += b.w;
  }
  const float4 sc = *reinterpret_cast<const float4*>(s + i % N);
  store4(y + i, make_float4(a.x * sc.x, a.y * sc.y, a.z * sc.z, a.w * sc.w));
}

template <typename T, int BITS, int BM>
cudaError_t launch_main(const void* x, const void* q, const float* s, void* y, float* ws, int M,
                        int K, int N, long long ldx, int splits, int per, cudaStream_t stream) {
  const int m_tiles = (M + BM - 1) / BM, n_tiles = (N + BN - 1) / BN;
  qmm_kernel<T, BITS, BM><<<dim3(m_tiles * n_tiles, splits), NTHREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(q), s, static_cast<T*>(y), ws, M,
      K, N, ldx, per, m_tiles, n_tiles);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_t(const void* x, const void* q, const float* s, void* y, float* ws, int M,
                     int K, int N, long long ldx, int bits, int bm, int splits, int per,
                     int out_fp32, cudaStream_t stream) {
  void* out = ws ? nullptr : y;
  cudaError_t e;
  if (bits == 8)
    e = bm == 16 ? launch_main<T, 8, 16>(x, q, s, out, ws, M, K, N, ldx, splits, per, stream)
                 : launch_main<T, 8, 128>(x, q, s, out, ws, M, K, N, ldx, splits, per, stream);
  else
    e = bm == 16 ? launch_main<T, 4, 16>(x, q, s, out, ws, M, K, N, ldx, splits, per, stream)
                 : launch_main<T, 4, 128>(x, q, s, out, ws, M, K, N, ldx, splits, per, stream);
  if (e != cudaSuccess || !ws) return e;
  const long long mn = (long long)M * N;
  const unsigned blocks = static_cast<unsigned>((mn / 4 + 255) / 256);
  if (out_fp32)
    qmm_reduce_kernel<<<blocks, 256, 0, stream>>>(ws, s, static_cast<float*>(y), mn, N, splits);
  else
    qmm_reduce_kernel<<<blocks, 256, 0, stream>>>(ws, s, static_cast<T*>(y), mn, N, splits);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (M, K) bf16/fp16 with row stride ldx (a multiple of 8, 16-byte aligned
// data); q the int8 (K, N) or packed int4 (K / 2, N) weight bytes,
// contiguous; s (N,) fp32; y (M, N) contiguous, in x's type or fp32
// (out_fp32). N a multiple of 16. bm 16 or 128; K is cut into splits of
// `per` 32-deep steps each. ws, (splits, M, N) fp32, is required when
// splits > 1 or out_fp32 (null otherwise): the main kernel writes partials
// there and a second kernel sums, scales and rounds them into y.
int fat_qmm(const void* x, const void* q, const void* scales, void* y, void* ws, int M, int K,
            int N, long long ldx, int bits, int bm, int splits, int per, int is_fp16,
            int out_fp32, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool need_ws = splits > 1 || out_fp32;
  if (N % 16 || ldx % 8 || (bits != 8 && bits != 4) || (bits == 4 && K % 2) ||
      (bm != 16 && bm != 128) || splits < 1 || per < 1 || need_ws != (ws != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* s = static_cast<const float*>(scales);
  float* w = static_cast<float*>(ws);
  cudaError_t e =
      is_fp16 ? launch_t<__half>(x, q, s, y, w, M, K, N, ldx, bits, bm, splits, per, out_fp32, st)
              : launch_t<__nv_bfloat16>(x, q, s, y, w, M, K, N, ldx, bits, bm, splits, per,
                                        out_fp32, st);
  return static_cast<int>(e);
}

}  // extern "C"
