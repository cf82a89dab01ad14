// Flash-attention backward, step 1 of 3: D = rowsum(dO * O), for Hopper
// (sm_90a), hand-written CUDA C++.
//
// Replaces: flash_attention_tpu/ops/flash_bwd.py::_di_kernel (the Pallas TPU
// kernel launched by flash_bwd).
//
// Computes D[b, h, i] = sum_d dO[b, i, h, d] * O[b, i, h, d] in fp32 for O and
// dO (b, sq, h, d), bf16 or fp16, read through their strides (the head dim
// must be contiguous), into a contiguous (b, h, sq) fp32 tensor.
//
// Why a matrix product: the backward forms dS = P * (dP - D) with
// dP = dO V^T. When a row's attention sits on one key, its O row equals that
// V row and dS must be exactly 0, which holds only if D is summed exactly as
// dP is. So, like the TPU kernel, D is taken as the diagonal of dO O^T from
// the same mma.sync m16n8k16 fragments, in the same k-step order (head dim
// 0..d in steps of 16, fp32 accumulator starting at 0) that
// flash_bwd_dq.cu and flash_bwd_dkv.cu use for dP. Reading the diagonal out
// of the accumulator is exact.
//
// What bounds it on the H100: bytes. It reads O and dO once (4 bytes per
// element pair) and writes 4 bytes per row; the 16 x 16 diagonal block each
// warp computes is 16x the useful products and still far below the tensor
// cores' rate.
//
// What the design does about it: one CTA of 4 warps per (64 query rows, head,
// batch); each warp loads its 16 rows of dO (A) and O (B) straight from device
// memory into fragments (each row read once, 4 bytes a thread), with no
// shared memory and no synchronisation. Left for later work: 16-byte loads.

#include "flash_common.cuh"

namespace {

using fat::Mma;

constexpr int BLOCK_M = 64;  // query rows per CTA
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_di_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                    float* __restrict__ di, int sq, int h,
                    long long o_sb, long long o_ss, long long o_sh,
                    long long d_sb, long long d_ss, long long d_sh) {
  constexpr int KSTEPS = D / 16;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int m0 = blockIdx.x * BLOCK_M + warp * 16;
  if (m0 >= sq) return;
  const bool ok0 = m0 + g < sq, ok1 = m0 + g + 8 < sq;

  const T* ob = o + batch * o_sb + head * o_sh + m0 * o_ss;
  const T* db = dout + batch * d_sb + head * d_sh + m0 * d_ss;

  // c[nn] = dO[m0 .. m0 + 16) . O[m0 + 8 nn .. m0 + 8 nn + 8)^T
  float c[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    uint32_t a[4];
    fat::load_a(a, db, d_ss, g, t, kk * 16, ok0, ok1);
#pragma unroll
    for (int nn = 0; nn < 2; ++nn) {
      uint32_t b0 = 0u, b1 = 0u;
      if (nn == 0 ? ok0 : ok1)
        fat::load_b_rows(b0, b1, ob + nn * 8 * o_ss, o_ss, g, t, kk * 16);
      Mma<T>::run(c[nn], a, b0, b1);
    }
  }

  // the diagonal: row g is column g of tile 0 and row g + 8 column g of
  // tile 1, both held by the thread with t == g / 2, at element g & 1
  if (t == (g >> 1)) {
    float* out = di + ((long long)batch * h + head) * sq + m0 + g;
    if (ok0) out[0] = c[0][g & 1];
    if (ok1) out[8] = c[1][2 + (g & 1)];
  }
}

template <typename T, int D>
void launch(const void* o, const void* dout, float* di, int b, int sq, int h,
            const long long* st, cudaStream_t stream) {
  dim3 grid((sq + BLOCK_M - 1) / BLOCK_M, h, b);
  flash_bwd_di_kernel<T, D><<<grid, NTHREADS, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), di, sq, h, st[0],
      st[1], st[2], st[3], st[4], st[5]);
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
  if (d == 128 && !is_fp16)
    launch<__nv_bfloat16, 128>(o, dout, out, b, sq, h, strides, s);
  else if (d == 128)
    launch<__half, 128>(o, dout, out, b, sq, h, strides, s);
  else if (d == 64 && !is_fp16)
    launch<__nv_bfloat16, 64>(o, dout, out, b, sq, h, strides, s);
  else if (d == 64)
    launch<__half, 64>(o, dout, out, b, sq, h, strides, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
