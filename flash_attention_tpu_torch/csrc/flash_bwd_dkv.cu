// Flash-attention backward, step 3 of 3: dK and dV, for Hopper (sm_90a),
// hand-written CUDA C++.
//
// Replaces: flash_attention_tpu/ops/flash_bwd.py::_dkv_kernel, its dense
// pallas_call (the segmented one, for varlen and segment ids, is not ported).
//
// Computes, per (batch, kv head) and key row j: dV = sum_g P^T dO and
// dK = scale sum_g dS^T Q, the sum running over the GQA group of query heads
// that share the kv head, with P = exp(S - LSE) and dS = P * (dP - D)
// recomputed as in flash_bwd_dq.cu. Lower-right-aligned causal masking;
// masked entries, query rows at or past sq and rows with no live key get
// P = 0 explicitly. Q, dO (b, sq, h, d) and K, V (b, sk, hk, d), bf16 or fp16,
// are read through their strides; dK and dV are written contiguous
// (b, sk, hk, d) in the input dtype.
//
// What bounds it on the H100: at training shapes (sq = sk = 2048, d = 128)
// its four products (K Q^T, V dO^T, P^T dO, dS^T Q; 8 d FLOP per live score)
// make it compute-bound, so the tensor cores set the floor.
//
// What the design does about it: every product runs on the tensor cores with
// mma.sync m16n8k16 (fp32 accumulate), in the transposed orientation: a warp
// owns 16 key rows and computes S^T and dP^T (keys x queries) directly, so P^T
// and dS^T are repacked in registers as the A operands of P^T dO and dS^T Q.
// A CTA of 4 warps owns 64 key rows; their K and V tiles sit in shared memory
// for the whole kernel, and 32-row Q / dO tiles of each query head of the
// group stream through it (padded rows, stride d + 8; dynamic shared memory,
// 52 KB at d = 128). The two 16 x d fp32 accumulators per warp (128 registers
// at d = 128) stay in registers across the whole group and every query tile,
// so the group is summed in the CTA with no atomics and no second pass, and
// two runs give bit-identical results. dP^T takes the same products, summed
// over the head dim in the same k-step order, as D in flash_bwd_di.cu, so
// P * (dP - D) cancels to exactly 0 where a row attends to one key. Causal
// query tiles wholly before the block's diagonal are never loaded, and a
// warp skips the tiles wholly before its own rows. CTAs with the most query
// tiles (the first key blocks) start first. Left for later work: wgmma, TMA
// and a double buffer.

#include "flash_common.cuh"

namespace {

using fat::Mma;

constexpr int BLOCK_N = 64;  // key rows per CTA (16 per warp)
constexpr int BLOCK_M = 32;  // query rows per streamed tile
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;

template <typename T, int D>
constexpr int smem_bytes() {
  return (2 * BLOCK_N + 2 * BLOCK_M) * (D + 8) * int(sizeof(T)) +
         2 * BLOCK_M * int(sizeof(float));
}

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ di, T* __restrict__ dk,
                     T* __restrict__ dv, int sq, int sk, int h, int hk,
                     int group, long long q_sb, long long q_ss, long long q_sh,
                     long long k_sb, long long k_ss, long long k_sh,
                     long long v_sb, long long v_ss, long long v_sh,
                     long long d_sb, long long d_ss, long long d_sh,
                     float scale, float scale_log2, int causal) {
  constexpr int KSTEPS = D / 16;        // k-steps over the head dim
  constexpr int DTILES = D / 8;         // n-tiles of dK and dV
  constexpr int NTILES = BLOCK_M / 8;   // n-tiles of S^T and dP^T
  constexpr int STRIDE = D + 8;

  extern __shared__ __align__(16) unsigned char smem[];
  T* k_s = reinterpret_cast<T*>(smem);
  T* v_s = k_s + BLOCK_N * STRIDE;
  T* q_s = v_s + BLOCK_N * STRIDE;
  T* do_s = q_s + BLOCK_M * STRIDE;
  float* lse_s = reinterpret_cast<float*>(do_s + BLOCK_M * STRIDE);
  float* di_s = lse_s + BLOCK_M;

  const int n_block = blockIdx.x;  // the first key blocks see the most rows
  const int kvh = blockIdx.y;
  const int batch = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int off = sk - sq;
  const int n0 = n_block * BLOCK_N;
  const int j0 = n0 + warp * 16;        // this warp's first key row
  const int keys[2] = {j0 + g, j0 + g + 8};

  fat::load_tile<T, BLOCK_N, D, NTHREADS>(
      k_s, k + batch * k_sb + kvh * k_sh, k_ss, n0, sk, tid);
  fat::load_tile<T, BLOCK_N, D, NTHREADS>(
      v_s, v + batch * v_sb + kvh * v_sh, v_ss, n0, sk, tid);
  const T* kw = k_s + warp * 16 * STRIDE;
  const T* vw = v_s + warp * 16 * STRIDE;

  float dk_acc[DTILES][4], dv_acc[DTILES][4];
#pragma unroll
  for (int dt = 0; dt < DTILES; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[dt][e] = dv_acc[dt][e] = 0.f;

  // query rows that see a key of this block: causal needs row >= col - off
  const int m_first = causal ? max(0, n0 - off) / BLOCK_M * BLOCK_M : 0;

  for (int gi = 0; gi < group; ++gi) {
    const int head = kvh * group + gi;
    const T* qb = q + batch * q_sb + head * q_sh;
    const T* db = dout + batch * d_sb + head * d_sh;
    const float* lb = lse + ((long long)batch * h + head) * sq;
    const float* dib = di + ((long long)batch * h + head) * sq;

    for (int m0 = m_first; m0 < sq; m0 += BLOCK_M) {
      __syncthreads();  // every warp is done with the previous tile
      fat::load_tile<T, BLOCK_M, D, NTHREADS>(q_s, qb, q_ss, m0, sq, tid);
      fat::load_tile<T, BLOCK_M, D, NTHREADS>(do_s, db, d_ss, m0, sq, tid);
      if (tid < BLOCK_M) {
        const int row = m0 + tid;
        lse_s[tid] = row < sq ? lb[row] * fat::LOG2E : 0.f;
        di_s[tid] = row < sq ? dib[row] : 0.f;
      }
      __syncthreads();
      // nothing live for this warp: keys past sk, or all after the tile's
      // last row's diagonal
      if (j0 >= sk || (causal && j0 > m0 + BLOCK_M - 1 + off)) continue;

      // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys
      float s[NTILES][4], dp[NTILES][4];
#pragma unroll
      for (int nn = 0; nn < NTILES; ++nn)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nn][e] = dp[nn][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        uint32_t ka[4], va[4];
        fat::load_a(ka, kw, STRIDE, g, t, kk * 16);
        fat::load_a(va, vw, STRIDE, g, t, kk * 16);
#pragma unroll
        for (int nn = 0; nn < NTILES; ++nn) {
          uint32_t b0, b1;
          fat::load_b_rows(b0, b1, q_s + nn * 8 * STRIDE, STRIDE, g, t, kk * 16);
          Mma<T>::run(s[nn], ka, b0, b1);
          fat::load_b_rows(b0, b1, do_s + nn * 8 * STRIDE, STRIDE, g, t,
                           kk * 16);
          Mma<T>::run(dp[nn], va, b0, b1);
        }
      }

      // P^T into s, dS^T = P^T (dP^T - D) into dp
      const bool masked = (m0 + BLOCK_M > sq) || (j0 + 16 > sk) ||
                          (causal && j0 + 15 > m0 + off);
#pragma unroll
      for (int nn = 0; nn < NTILES; ++nn) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ci = nn * 8 + t * 2 + (e & 1);  // query row in the tile
          float p = exp2f(s[nn][e] * scale_log2 - lse_s[ci]);
          if (masked) {
            const int row = m0 + ci;
            const int key = keys[e >> 1];
            if (row >= sq || key >= sk || (causal && key > row + off)) p = 0.f;
          }
          s[nn][e] = p;
          dp[nn][e] = p * (dp[nn][e] - di_s[ci]);
        }
      }

      // dV += P^T dO and dK += dS^T Q: B[k = query row][n = head-dim column]
#pragma unroll
      for (int kk = 0; kk < BLOCK_M / 16; ++kk) {
        uint32_t pa[4], sa[4];
        fat::pack_a<T>(pa, s[2 * kk], s[2 * kk + 1]);
        fat::pack_a<T>(sa, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
        for (int dt = 0; dt < DTILES; ++dt) {
          uint32_t b0, b1;
          fat::load_b_cols(b0, b1, do_s + kk * 16 * STRIDE + dt * 8, STRIDE, g,
                           t);
          Mma<T>::run(dv_acc[dt], pa, b0, b1);
          fat::load_b_cols(b0, b1, q_s + kk * 16 * STRIDE + dt * 8, STRIDE, g,
                           t);
          Mma<T>::run(dk_acc[dt], sa, b0, b1);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = keys[r];
    if (key >= sk) continue;
    const long long base = (((long long)batch * sk + key) * hk + kvh) * D;
#pragma unroll
    for (int dt = 0; dt < DTILES; ++dt) {
      const int c = dt * 8 + t * 2;
      *reinterpret_cast<uint32_t*>(dk + base + c) = Mma<T>::pack(
          dk_acc[dt][2 * r] * scale, dk_acc[dt][2 * r + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + base + c) =
          Mma<T>::pack(dv_acc[dt][2 * r], dv_acc[dt][2 * r + 1]);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* di, void* dk, void* dv, int b,
           int sq, int sk, int h, int hk, const long long* st, float scale,
           int causal, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<T, D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((sk + BLOCK_N - 1) / BLOCK_N, hk, b);
  flash_bwd_dkv_kernel<T, D><<<grid, NTHREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, di,
      static_cast<T*>(dk), static_cast<T*>(dv), sq, sk, h, hk, h / hk, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10],
      st[11], scale, scale * fat::LOG2E, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// strides: 12 int64 in elements, (batch, seq, head) for q, k, v, dout.
// lse and di are contiguous (b, h, sq) fp32; dk and dv contiguous
// (b, sk, hk, d).
int fat_flash_bwd_dkv(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* di,
                      void* dk, void* dv, int b, int sq, int sk, int h, int hk,
                      int d, const long long* strides, float scale, int causal,
                      int is_fp16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dd = static_cast<const float*>(di);
  if (d == 128 && !is_fp16)
    return launch<__nv_bfloat16, 128>(q, k, v, dout, l, dd, dk, dv, b, sq, sk,
                                      h, hk, strides, scale, causal, s);
  if (d == 128)
    return launch<__half, 128>(q, k, v, dout, l, dd, dk, dv, b, sq, sk, h, hk,
                               strides, scale, causal, s);
  if (d == 64 && !is_fp16)
    return launch<__nv_bfloat16, 64>(q, k, v, dout, l, dd, dk, dv, b, sq, sk,
                                     h, hk, strides, scale, causal, s);
  if (d == 64)
    return launch<__half, 64>(q, k, v, dout, l, dd, dk, dv, b, sq, sk, h, hk,
                              strides, scale, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
