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
// never quantised: every int8 and int4 value is exact in bf16 and fp16, so
// q is converted to x's type and multiplied on the tensor cores as it is.
//
// What bounds it on the H100: at decode (m = 8 rows) the weight's bytes, at
// 1 byte (int8) or half a byte (int4) per weight: a 4096 x 14336 int8
// gate/up weight is 58.7 MB, 17.5 us at 3.35 TB/s, against 0.9 GFLOP. At
// prefill (m = 16384) the operations: 2 m k n, 1.9 TFLOP for the same
// weight, 1.95 ms at 989 TFLOP/s, against 58.7 MB of weights.
//
// What the design does about it: the weight is the M side of every product,
// y^T = (q s)^T x^T, dequantised straight into wgmma's A registers; x is B,
// read by wgmma from shared memory. A CTA owns 128 weight columns and XR
// rows of x: 256 at prefill, 8 or 16 at decode, so no row of a decode
// product is empty. It is warp-specialised, on hopper_common.cuh:
// * Warpgroup 0, the producer: one thread streams 64-deep k steps by TMA
//   into a ring of STAGES stages, each a box of x (XR rows, K-major) and a
//   box of the raw weight bytes (a 2-D UINT8 map over (Kq, N)), both with the
//   128-byte swizzle, and a full and an empty mbarrier per stage. TMA
//   zero-fills rows past M, columns past K and weight rows past Kq or
//   columns past N. The weight crosses device memory once, in its quantised
//   width, and shared memory once more.
// * Warpgroups 1 and 2, the consumers, own 64 weight columns each, 16 a
//   warp. Each k16 step of A comes from the raw bytes by ldmatrix.trans (8 x
//   8 tiles of byte pairs: a thread receives 2 columns of 2 k rows, or of 2
//   packed rows for int4, chosen so that they are its A fragment) and is
//   converted in registers; the warp's 16 columns are ordered 0, 2, 4, ..,
//   14, 1, 3, .., 15 on the M side, so each thread ends with two adjacent
//   output columns. The two consumers share only the ring: no named
//   barrier, no converted tile in shared memory, no proxy fence.
// * The conversion is exact and uses no int-to-float or float-to-16-bit
//   conversion instruction (those run at an eighth of the fp32 rate):
//   int4 -> (0x4300 | u) bf16 or (0x6400 | u) fp16 by prmt and lop3, u =
//   nibble ^ 8, then one bf16x2/half2 subtraction of 136 or 1032; int8 ->
//   fp16 by prmt of u = byte ^ 0x80 into 0x64uu (1024 + u), then a half2
//   subtraction of 1152; int8 -> bf16, whose 7 mantissa bits cannot hold
//   128 + u, by lop3 of the low 7 bits into 0x4300 | v (128 + v) and of the
//   sign bit into 0x4300 | (q & 0x80) (128 or 256), then one bf16x2
//   subtraction.
// * Each k16 step's product is issued as soon as its A is converted, and
//   the next step's A is converted while it runs (two register sets; one
//   product in flight), so the tensor cores are not drained at each step.
// * Prefill: 1 CTA per SM, tiles in grouped raster order so resident CTAs
//   share their x and weight tiles in the L2; setmaxnreg moves registers
//   from the producer to the consumers (128 accumulators a thread). Decode:
//   small CTAs, DECODE_CTAS_PER_SM of them per SM, to keep weight bytes in
//   flight.
// * Short grids: the wrapper (ops/quant.py::plan) splits k over blockIdx.y.
//   Each split writes an unscaled fp32 partial tile to a workspace, and a
//   second kernel sums the splits in a fixed order, scales and rounds. No
//   atomics, so repeats are bit-identical.
// * Tensor maps are encoded on the host per call (two driver calls, no
//   device work) and passed as __grid_constant__ parameters.
// Left for later work: a persistent schedule (each CTA's epilogue is
// exposed), a stream-K split in place of the second pass, TMA multicast of
// the weight tile across a cluster.

#include "flash_common.cuh"
#include "gmm_common.cuh"
#include "hopper_common.cuh"

namespace {

constexpr int BK = 64;         // k per stage: one 128-byte box of x
constexpr int WN = 128;        // weight columns a tile: 64 per consumer
constexpr int NTHREADS = 384;  // producer + 2 consumer warpgroups
constexpr int GROUP_M = 16;
constexpr int DECODE_CTAS_PER_SM = 3;  // ops/quant.py plans with the same
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;  // 128 * 40 + 256 * 232 <= 65536

// XR rows of x a tile: 256 (prefill) or 8, 16 (decode).
template <int BITS, int XR>
struct Cfg {
  static constexpr bool DECODE = XR < 256;
  static constexpr int STAGES = DECODE ? 6 : (BITS == 8 ? 5 : 6);
  static constexpr int QR = BITS == 8 ? BK : BK / 2;  // weight byte rows a stage
  static constexpr int X_BYTES = XR * 128;
  static constexpr int RAW_BYTES = QR * WN;
  static constexpr int RAW_OFF = STAGES * X_BYTES;
  static constexpr int BAR_OFF = RAW_OFF + STAGES * RAW_BYTES;
  // slack to align the tiles to 1024 bytes, the swizzle's period
  static constexpr int BYTES = BAR_OFF + 2 * STAGES * 8 + 1024;
};

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

// (a & mask) | bits
__device__ __forceinline__ uint32_t and_or(uint32_t a, uint32_t mask, uint32_t bits) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;\n" : "=r"(d) : "r"(a), "r"(mask), "r"(bits));
  return d;
}

// a - c on a pair of T, as c * -1 + a: exact for the integers used here.
template <typename T>
__device__ __forceinline__ uint32_t sub2(uint32_t a, uint32_t c) {
  uint32_t d;
  if constexpr (std::is_same_v<T, __half>)
    asm("fma.rn.f16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(c), "r"(0xBC00BC00u), "r"(a));
  else
    asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(c), "r"(0xBF80BF80u), "r"(a));
  return d;
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// int8: r holds q(k, c), q(k, c + 1), q(k + 1, c), q(k + 1, c + 1) in bytes
// 0..3. Returns the pairs (q(k, c), q(k + 1, c)) and (.., c + 1) in T.
template <typename T>
__device__ __forceinline__ void cvt_int8(uint32_t r, uint32_t& c0, uint32_t& c1) {
  if constexpr (std::is_same_v<T, __half>) {
    // u = q + 128 (0..255) under 0x64: 1024 + u, minus 1152
    const uint32_t u = r ^ 0x80808080u;
    c0 = sub2<T>(prmt(u, 0x64646464u, 0x4240), 0x64806480u);
    c1 = sub2<T>(prmt(u, 0x64646464u, 0x4341), 0x64806480u);
  } else {
    // q = v - 128 s for v = q & 0x7F and s its sign bit: (0x4300 | v) =
    // 128 + v minus (0x4300 | (q & 0x80)) = 128 + 128 s
    const uint32_t x0 = prmt(r, 0, 0x4240), x1 = prmt(r, 0, 0x4341);
    c0 = sub2<T>(and_or(x0, 0x007F007Fu, 0x43004300u), and_or(x0, 0x00800080u, 0x43004300u));
    c1 = sub2<T>(and_or(x1, 0x007F007Fu, 0x43004300u), and_or(x1, 0x00800080u, 0x43004300u));
  }
}

// int4: each byte of r holds two k rows (low nibble first) of one column.
// Returns the 4 pairs in T, byte j to a[j].
template <typename T>
__device__ __forceinline__ void cvt_int4(uint32_t r, uint32_t (&a)[4]) {
  constexpr bool H = std::is_same_v<T, __half>;
  constexpr uint32_t MAGIC = H ? 0x64006400u : 0x43004300u;  // 1024 or 128
  constexpr uint32_t OFF = H ? 0x64086408u : 0x43084308u;    // the magic + 8
  const uint32_t u = r ^ 0x88888888u;  // each nibble + 8, 0..15
  const uint32_t h = u >> 4;           // the high nibbles at the low ones
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    // byte j of u at bit 0, byte j of h at bit 16
    const uint32_t x = prmt(u, h, j | j << 4 | (4 + j) << 8 | (4 + j) << 12);
    a[j] = sub2<T>(and_or(x, 0x000F000Fu, MAGIC), OFF);
  }
}

// ws == nullptr: y = acc * s rounded to T. Otherwise the unscaled fp32
// partial of split blockIdx.y goes to ws[split][M][N].
template <typename T, int BITS, int XR>
__global__ void __launch_bounds__(NTHREADS, XR < 256 ? DECODE_CTAS_PER_SM : 1)
qmm_kernel(const __grid_constant__ CUtensorMap x_map,
           const __grid_constant__ CUtensorMap q_map, const float* __restrict__ s,
           T* __restrict__ y, float* __restrict__ ws, int M, int N, int k_steps,
           int per, int m_tiles, int n_tiles) {
  using C = Cfg<BITS, XR>;
  constexpr int S = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (hop::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::BAR_OFF);
  uint64_t* empty = full + S;

  int mt = 0, nt = blockIdx.x;
  if constexpr (!C::DECODE) fat::raster(blockIdx.x, m_tiles, n_tiles, GROUP_M, mt, nt);
  const int m0 = mt * XR, n0 = nt * WN;
  const int ks0 = blockIdx.y * per;
  const int n_steps = max(0, min(ks0 + per, k_steps) - ks0);

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
    if constexpr (!C::DECODE) hop::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      hop::prefetch_map(&x_map);
      hop::prefetch_map(&q_map);
      for (int j = 0; j < n_steps; ++j) {
        const int st = j % S;
        if (j >= S) hop::mbar_wait(&empty[st], (j / S - 1) & 1);
        hop::mbar_expect_tx(&full[st], C::X_BYTES + C::RAW_BYTES);
        const int k0 = (ks0 + j) * BK;
        hop::tma_load_2d(smem + st * C::X_BYTES, &x_map, &full[st], k0, m0);
        hop::tma_load_2d(smem + C::RAW_OFF + st * C::RAW_BYTES, &q_map, &full[st], n0,
                         BITS == 8 ? k0 : k0 / 2);
      }
    }
    return;
  }

  // ---- consumers ----
  if constexpr (!C::DECODE) hop::setmaxnreg_inc<CONSUMER_REGS>();
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int chunk = 4 * (role - 1) + warp;  // the warp's 16 columns: 16-byte chunk of a row
  const uint32_t x_s = hop::smem_u32(smem);
  const uint32_t raw_s = hop::smem_u32(smem + C::RAW_OFF);
  // ldmatrix row address of this lane in a stage (row `row`, swizzled):
  // int8, 4 tiles of 8 k rows: lane l gives row 8 (l / 8) + l % 8 (tiles 0, 1
  // for k16 step 2h, tiles 2, 3 for step 2h + 1 of x4 number h). int4, tile
  // kk of packed rows 8 kk..8 kk + 7 for step kk, row l % 8 of a tile read
  // from packed row (l % 8) / 2 + 4 ((l % 8) % 2), so that thread t gets
  // packed rows t (k 2t, 2t + 1) and t + 4 (k 2t + 8, 2t + 9).
  const int lr = lane % 8;
  const int row = BITS == 8 ? 8 * (lane / 8) + lr : 8 * (lane / 8) + lr / 2 + 4 * (lr % 2);
  const uint32_t ld_off = row * 128 + ((chunk ^ (row & 7)) << 4);

  float acc[XR / 2];
#pragma unroll
  for (int i = 0; i < XR / 2; ++i) acc[i] = 0.f;
  uint32_t a[2][4];  // A of two k16 steps: one in flight, one being converted

  for (int j = 0; j < n_steps; ++j) {
    const int st = j % S;
    hop::mbar_wait(&full[st], (j / S) & 1);
    const uint32_t raw = raw_s + st * C::RAW_BYTES;
    uint32_t r[BITS == 8 ? 2 : 1][4];  // the stage's weight bytes of this thread
    ldmatrix_x4_trans(r[0], raw + ld_off);
    if constexpr (BITS == 8) ldmatrix_x4_trans(r[1], raw + ld_off + 32 * 128);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t(&ak)[4] = a[kk % 2];
      // A rows g, g + 8 of the warp's 16 are its columns 2g, 2g + 1
      if constexpr (BITS == 8) {
        cvt_int8<T>(r[kk / 2][2 * (kk % 2)], ak[0], ak[1]);      // k 2t, 2t + 1
        cvt_int8<T>(r[kk / 2][2 * (kk % 2) + 1], ak[2], ak[3]);  // k 2t + 8, 2t + 9
      } else {
        cvt_int4<T>(r[0][kk], ak);
      }
      hop::fence_regs(ak);
      hop::wgmma_fence();
      hop::WgmmaRs<T, XR>::rs(acc, ak,
                              hop::desc_sw128(x_s + st * C::X_BYTES + kk * 32, 16, 1024));
      hop::wgmma_commit();
      hop::wgmma_wait<1>();  // the product of the step before is done
      // ... so, at kk 0, the x of stage j - 1 is read
      if (kk == 0 && j > 0 && lane == 0) hop::mbar_arrive(&empty[(j - 1) % S]);
    }
  }
  hop::wgmma_wait<0>();
  hop::fence_regs(acc);

  // d[4 i + e]: M row 16 warp + g + 8 (e / 2), x row 8 i + 2 t + e % 2; M
  // rows g and g + 8 are weight columns 2g and 2g + 1 of the warp's 16
  const int c = n0 + 16 * chunk + 2 * g;
  if (c >= N) return;
  const float2 sc = ws ? make_float2(1.f, 1.f) : *reinterpret_cast<const float2*>(s + c);
#pragma unroll
  for (int i = 0; i < XR / 8; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = m0 + 8 * i + 2 * t + e;
      if (r >= M) continue;
      const float v0 = acc[4 * i + e], v1 = acc[4 * i + 2 + e];
      if (ws)
        *reinterpret_cast<float2*>(ws + ((long long)blockIdx.y * M + r) * N + c) =
            make_float2(v0, v1);
      else
        *reinterpret_cast<uint32_t*>(y + (long long)r * N + c) =
            fat::Mma<T>::pack(v0 * sc.x, v1 * sc.y);
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
  *reinterpret_cast<uint2*>(p) = make_uint2(fat::Mma<__nv_bfloat16>::pack(v.x, v.y),
                                            fat::Mma<__nv_bfloat16>::pack(v.z, v.w));
}
template <>
__device__ __forceinline__ void store4(__half* p, float4 v) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(fat::Mma<__half>::pack(v.x, v.y), fat::Mma<__half>::pack(v.z, v.w));
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

template <typename T, int BITS, int XR>
int launch_main(const void* x, const void* q, const float* s, void* y, float* ws, int M, int K,
                int N, long long ldx, int splits, int per, cudaStream_t stream) {
  using C = Cfg<BITS, XR>;
  constexpr bool fp16 = std::is_same_v<T, __half>;
  CUtensorMap xm, qm;
  int rc;
  if ((rc = hop::make_map_2d(&xm, x,
                             fp16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                  : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                             K, M, ldx * 2, XR)) ||
      (rc = hop::make_map_2d(&qm, q, CU_TENSOR_MAP_DATA_TYPE_UINT8, N,
                             BITS == 8 ? K : K / 2, N, C::QR)))
    return rc;
  auto kernel = qmm_kernel<T, BITS, XR>;
  // once per process (the attribute holds for the function from then on)
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::BYTES);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int m_tiles = (M + XR - 1) / XR, n_tiles = (N + WN - 1) / WN;
  kernel<<<dim3(m_tiles * n_tiles, splits), NTHREADS, C::BYTES, stream>>>(
      xm, qm, s, static_cast<T*>(y), ws, M, N, (K + BK - 1) / BK, per, m_tiles, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int BITS>
int launch_bits(const void* x, const void* q, const float* s, void* y, float* ws, int M, int K,
                int N, long long ldx, int rows, int splits, int per, cudaStream_t st) {
  if (rows == 8) return launch_main<T, BITS, 8>(x, q, s, y, ws, M, K, N, ldx, splits, per, st);
  if (rows == 16) return launch_main<T, BITS, 16>(x, q, s, y, ws, M, K, N, ldx, splits, per, st);
  return launch_main<T, BITS, 256>(x, q, s, y, ws, M, K, N, ldx, splits, per, st);
}

template <typename T>
int launch_t(const void* x, const void* q, const float* s, void* y, float* ws, int M, int K,
             int N, long long ldx, int bits, int rows, int splits, int per, int out_fp32,
             cudaStream_t stream) {
  void* out = ws ? nullptr : y;
  const int rc =
      bits == 8 ? launch_bits<T, 8>(x, q, s, out, ws, M, K, N, ldx, rows, splits, per, stream)
                : launch_bits<T, 4>(x, q, s, out, ws, M, K, N, ldx, rows, splits, per, stream);
  if (rc != 0 || !ws) return rc;
  const long long mn = (long long)M * N;
  const unsigned blocks = static_cast<unsigned>((mn / 4 + 255) / 256);
  if (out_fp32)
    qmm_reduce_kernel<<<blocks, 256, 0, stream>>>(ws, s, static_cast<float*>(y), mn, N, splits);
  else
    qmm_reduce_kernel<<<blocks, 256, 0, stream>>>(ws, s, static_cast<T*>(y), mn, N, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x (M, K) bf16/fp16 with row stride ldx (a multiple of 8, 16-byte aligned
// data); q the int8 (K, N) or packed int4 (K / 2, N) weight bytes,
// contiguous and 16-byte aligned; s (N,) fp32, 16-byte aligned; y (M, N)
// contiguous, in x's type or fp32 (out_fp32). N a multiple of 16. rows of
// x a tile: 8 or 16 (decode, M at most rows) or 256 (prefill); K
// is cut into splits of `per` 64-deep steps each. ws, (splits, M, N) fp32,
// is required when splits > 1 or out_fp32 (null otherwise): the main kernel
// writes partials there and a second kernel sums, scales and rounds them
// into y. K = 0 writes zeros.
int fat_qmm(const void* x, const void* q, const void* scales, void* y, void* ws, int M, int K,
            int N, long long ldx, int bits, int rows, int splits, int per, int is_fp16,
            int out_fp32, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool need_ws = splits > 1 || out_fp32;
  if (N % 16 || ldx % 8 || (bits != 8 && bits != 4) || (bits == 4 && K % 2) ||
      (rows != 8 && rows != 16 && rows != 256) || (rows < 256 && M > rows) || splits < 1 ||
      per < 1 || need_ws != (ws != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (K == 0) {
    const size_t bytes = (size_t)M * N * (out_fp32 ? 4 : 2);
    return static_cast<int>(cudaMemsetAsync(y, 0, bytes, st));
  }
  const float* s = static_cast<const float*>(scales);
  float* w = static_cast<float*>(ws);
  return is_fp16 ? launch_t<__half>(x, q, s, y, w, M, K, N, ldx, bits, rows, splits, per,
                                    out_fp32, st)
                 : launch_t<__nv_bfloat16>(x, q, s, y, w, M, K, N, ldx, bits, rows, splits,
                                           per, out_fp32, st);
}

}  // extern "C"
