// Flash-attention backward, step 2 of 3: dQ, for Hopper (sm_90a),
// hand-written CUDA C++.
//
// Replaces: flash_attention_tpu/ops/flash_bwd.py::_dq_kernel, its dense
// pallas_call (the segmented one, for varlen and segment ids, is not ported).
//
// Computes, per (batch, head) and query row i, with the kv head head / group:
// S = scale Q K^T recomputed, P = exp(S - LSE) from the forward's natural-log
// LSE, dP = dO V^T, dS = P * (dP - D) with D from flash_bwd_di.cu, and
// dQ = scale dS K. Lower-right-aligned causal masking; masked entries, columns
// at or past sk and rows with no live key (causal with sq > sk, LSE =
// empty_lse) get P = 0 explicitly, so those rows get dQ = 0. Q, dO (b, sq, h,
// d) and K, V (b, sk, hk, d), bf16 or fp16, are read through their strides;
// dQ is written contiguous (b, sq, h, d) in the input dtype.
//
// What bounds it on the H100: at training shapes (sq = sk = 2048, d = 128)
// its three products (Q K^T, dO V^T, dS K; 6 d FLOP per live score) make it
// compute-bound, so the tensor cores set the floor.
//
// What the design does about it: all three products run on the tensor cores
// with mma.sync m16n8k16 (fp32 accumulate). A CTA of 4 warps owns 64 query
// rows (16 per warp); Q and dO stay in registers as A fragments for the whole
// kernel and the dQ accumulator in registers, so nothing but K and V moves
// through shared memory. 64-row K/V tiles stream through padded shared memory
// (row stride d + 8) and are consumed in two 32-column halves, which keeps the
// S and dP accumulators at 16 registers each (about 200 a thread in all, no
// spills). dP is summed exactly as D is (same fragments, same k-step order),
// so P * (dP - D) cancels to exactly 0 where a row attends to one key. P
// becomes dS in place and is repacked in registers as the A operand of dS K.
// Causal tiles past the diagonal are never loaded, and a warp skips the
// half-tiles wholly past its own rows' diagonal. CTAs with the longest causal
// rows start first. Left for later work: wgmma, TMA and a double buffer.

#include "flash_common.cuh"

namespace {

using fat::Mma;

constexpr int BLOCK_M = 64;  // query rows per CTA
constexpr int BLOCK_N = 64;  // kv rows per shared-memory tile
constexpr int SUB_N = 32;    // kv columns per pass over the tile
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ di,
                    T* __restrict__ dq, int sq, int sk, int h, int group,
                    long long q_sb, long long q_ss, long long q_sh,
                    long long k_sb, long long k_ss, long long k_sh,
                    long long v_sb, long long v_ss, long long v_sh,
                    long long d_sb, long long d_ss, long long d_sh,
                    float scale, float scale_log2, int causal) {
  constexpr int KSTEPS = D / 16;      // k-steps over the head dim
  constexpr int DTILES = D / 8;       // n-tiles of dQ
  constexpr int NTILES = SUB_N / 8;   // n-tiles of S and dP per pass
  constexpr int STRIDE = D + 8;

  __shared__ __align__(16) T k_s[BLOCK_N * STRIDE];
  __shared__ __align__(16) T v_s[BLOCK_N * STRIDE];

  const int m_block = gridDim.x - 1 - blockIdx.x;  // longest rows first
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int kvh = head / group;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int off = sk - sq;
  const int m0 = m_block * BLOCK_M + warp * 16;
  const int rows[2] = {m0 + g, m0 + g + 8};

  const T* qb = q + batch * q_sb + head * q_sh;
  const T* kb = k + batch * k_sb + kvh * k_sh;
  const T* vb = v + batch * v_sb + kvh * v_sh;
  const T* db = dout + batch * d_sb + head * d_sh;

  uint32_t qf[KSTEPS][4], df[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    fat::load_a(qf[kk], qb + m0 * q_ss, q_ss, g, t, kk * 16, rows[0] < sq,
                rows[1] < sq);
    fat::load_a(df[kk], db + m0 * d_ss, d_ss, g, t, kk * 16, rows[0] < sq,
                rows[1] < sq);
  }
  // LSE in the log2 domain, and D, for the thread's two rows
  float lse2[2], dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long idx = ((long long)batch * h + head) * sq + rows[r];
    lse2[r] = rows[r] < sq ? lse[idx] * fat::LOG2E : 0.f;
    dr[r] = rows[r] < sq ? di[idx] : 0.f;
  }

  float acc[DTILES][4];
#pragma unroll
  for (int dt = 0; dt < DTILES; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;

  int n_end = sk;
  if (causal) {
    const int last_row = min((m_block + 1) * BLOCK_M, sq) - 1;
    n_end = min(sk, last_row + off + 1);
  }
  const int n_tiles = n_end > 0 ? (n_end + BLOCK_N - 1) / BLOCK_N : 0;

  for (int nt = 0; nt < n_tiles; ++nt) {
    const int n0 = nt * BLOCK_N;
    __syncthreads();
    fat::load_tile<T, BLOCK_N, D, NTHREADS>(k_s, kb, k_ss, n0, sk, tid);
    fat::load_tile<T, BLOCK_N, D, NTHREADS>(v_s, vb, v_ss, n0, sk, tid);
    __syncthreads();

#pragma unroll 1
    for (int c0 = 0; c0 < BLOCK_N; c0 += SUB_N) {
      const int col0 = n0 + c0;
      // nothing live for this warp: past sk, or past its last row's diagonal
      if (col0 >= sk || (causal && col0 > m0 + 15 + off)) break;
      const T* ks = k_s + c0 * STRIDE;
      const T* vs = v_s + c0 * STRIDE;

      float s[NTILES][4], dp[NTILES][4];
#pragma unroll
      for (int nn = 0; nn < NTILES; ++nn) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nn][e] = dp[nn][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk) {
          uint32_t b0, b1;
          fat::load_b_rows(b0, b1, ks + nn * 8 * STRIDE, STRIDE, g, t, kk * 16);
          Mma<T>::run(s[nn], qf[kk], b0, b1);
          fat::load_b_rows(b0, b1, vs + nn * 8 * STRIDE, STRIDE, g, t, kk * 16);
          Mma<T>::run(dp[nn], df[kk], b0, b1);
        }
      }

      // P = exp2(S scale log2e - LSE log2e); dS = P (dP - D), into s
      const bool masked = (col0 + SUB_N > sk) ||
                          (causal && col0 + SUB_N - 1 > m0 + off);
#pragma unroll
      for (int nn = 0; nn < NTILES; ++nn) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2f(s[nn][e] * scale_log2 - lse2[e >> 1]);
          if (masked) {
            const int col = col0 + nn * 8 + t * 2 + (e & 1);
            if (col >= sk || (causal && col > rows[e >> 1] + off)) p = 0.f;
          }
          s[nn][e] = p * (dp[nn][e] - dr[e >> 1]);
        }
      }

      // dQ += dS K: B[k = kv row][n = head-dim column] = K
#pragma unroll
      for (int kk = 0; kk < SUB_N / 16; ++kk) {
        uint32_t a[4];
        fat::pack_a<T>(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int dt = 0; dt < DTILES; ++dt) {
          uint32_t b0, b1;
          fat::load_b_cols(b0, b1, ks + kk * 16 * STRIDE + dt * 8, STRIDE, g, t);
          Mma<T>::run(acc[dt], a, b0, b1);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = rows[r];
    if (row >= sq) continue;
    T* out = dq + (((long long)batch * sq + row) * h + head) * D;
#pragma unroll
    for (int dt = 0; dt < DTILES; ++dt)
      *reinterpret_cast<uint32_t*>(out + dt * 8 + t * 2) =
          Mma<T>::pack(acc[dt][2 * r] * scale, acc[dt][2 * r + 1] * scale);
  }
}

template <typename T, int D>
void launch(const void* q, const void* k, const void* v, const void* dout,
            const float* lse, const float* di, void* dq, int b, int sq, int sk,
            int h, int hk, const long long* st, float scale, int causal,
            cudaStream_t stream) {
  dim3 grid((sq + BLOCK_M - 1) / BLOCK_M, h, b);
  flash_bwd_dq_kernel<T, D><<<grid, NTHREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, di,
      static_cast<T*>(dq), sq, sk, h, h / hk, st[0], st[1], st[2], st[3],
      st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], scale,
      scale * fat::LOG2E, causal);
}

}  // namespace

extern "C" {

// strides: 12 int64 in elements, (batch, seq, head) for q, k, v, dout.
// lse and di are contiguous (b, h, sq) fp32; dq a contiguous (b, sq, h, d).
int fat_flash_bwd_dq(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* di,
                     void* dq, int b, int sq, int sk, int h, int hk, int d,
                     const long long* strides, float scale, int causal,
                     int is_fp16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dd = static_cast<const float*>(di);
  if (d == 128 && !is_fp16)
    launch<__nv_bfloat16, 128>(q, k, v, dout, l, dd, dq, b, sq, sk, h, hk,
                               strides, scale, causal, s);
  else if (d == 128)
    launch<__half, 128>(q, k, v, dout, l, dd, dq, b, sq, sk, h, hk, strides,
                        scale, causal, s);
  else if (d == 64 && !is_fp16)
    launch<__nv_bfloat16, 64>(q, k, v, dout, l, dd, dq, b, sq, sk, h, hk,
                              strides, scale, causal, s);
  else if (d == 64)
    launch<__half, 64>(q, k, v, dout, l, dd, dq, b, sq, sk, h, hk, strides,
                       scale, causal, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
