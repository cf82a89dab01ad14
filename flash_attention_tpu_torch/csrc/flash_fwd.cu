// Flash-attention forward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces: flash_attention_tpu/ops/flash_fwd.py::_fwd_kernel (the Pallas
// TPU kernel launched by flash_fwd).
//
// Computes, per (batch, head): S = scale * Q K^T, an online softmax in fp32,
// O = P V, and LSE = m + log(l) (natural log), with lower-right-aligned causal
// masking and GQA (kv head = head / group). Q is (b, sq, h, d) and K/V are
// (b, sk, hk, d), bf16 or fp16, read through their strides (the head dim must
// be contiguous), so no transpose copy is made. Fully-masked rows (causal with
// sq > sk) write O = 0 and LSE = empty_lse.
//
// What bounds it on the H100: at prefill shapes (sq = sk = 2048, d = 128) the
// two products make it compute-bound (about 4 * d FLOP per score against a
// few bytes per score), so the tensor cores set the floor.
//
// What the design does about it: both products run on the tensor cores with
// mma.sync m16n8k16 (fp32 accumulate). A CTA of 4 warps owns 64 query rows
// (16 per warp, Q held in registers as A fragments for the whole kernel);
// 64-row K and V tiles stream through padded shared memory (row stride d + 8,
// conflict-free fragment reads). The score accumulator is reused in registers
// as the A operand of P V, so P never leaves the register file. KV tiles wholly
// above the causal diagonal are never loaded, and only tiles that straddle the
// diagonal or the ragged kv edge pay for masking. CTAs with the longest causal
// rows start first. Left for later work: wgmma, TMA and warp specialisation,
// and a cp.async double buffer to overlap the tile loads with the products.
//
// Rows past a sequence's own length in a padded prefill bucket are ordinary
// rows here: causal masking keeps them from influencing earlier rows, and no
// key-length mask beyond sk is applied.

#include "flash_common.cuh"

namespace {

using fat::Mma;

constexpr int BLOCK_M = 64;  // query rows per CTA
constexpr int BLOCK_N = 64;  // kv rows per tile
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int sq, int sk, int h, int group,
                 long long q_sb, long long q_ss, long long q_sh,
                 long long k_sb, long long k_ss, long long k_sh,
                 long long v_sb, long long v_ss, long long v_sh,
                 float scale_log2, int causal, float empty_lse) {
  constexpr int KSTEPS = D / 16;       // k-steps of Q K^T
  constexpr int DTILES = D / 8;        // n-tiles of O
  constexpr int NTILES = BLOCK_N / 8;  // n-tiles of S
  constexpr int STRIDE = D + 8;        // padded smem row (elements)

  __shared__ __align__(16) T k_s[BLOCK_N * STRIDE];
  __shared__ __align__(16) T v_s[BLOCK_N * STRIDE];

  // longest causal rows first: the last query block has the most kv tiles
  const int m_block = gridDim.x - 1 - blockIdx.x;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int kvh = head / group;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group
  const int off = sk - sq;  // lower-right causal offset
  const int m0 = m_block * BLOCK_M + warp * 16;
  const int rows[2] = {m0 + g, m0 + g + 8};

  const T* qb = q + batch * q_sb + head * q_sh;
  const T* kb = k + batch * k_sb + kvh * k_sh;
  const T* vb = v + batch * v_sb + kvh * v_sh;

  // Q as A fragments, zero past sq
  uint32_t qf[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk)
    fat::load_a(qf[kk], qb + m0 * q_ss, q_ss, g, t, kk * 16, rows[0] < sq,
                rows[1] < sq);

  float acc[DTILES][4];
#pragma unroll
  for (int dt = 0; dt < DTILES; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;
  float m_r[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l_r[2] = {0.f, 0.f};

  // kv columns this CTA can see: causal stops at its last row's diagonal
  int n_end = sk;
  if (causal) {
    const int last_row = min((m_block + 1) * BLOCK_M, sq) - 1;
    n_end = min(sk, last_row + off + 1);
  }
  const int n_tiles = n_end > 0 ? (n_end + BLOCK_N - 1) / BLOCK_N : 0;

  for (int nt = 0; nt < n_tiles; ++nt) {
    const int n0 = nt * BLOCK_N;
    __syncthreads();  // every warp is done with the previous tile
    fat::load_tile<T, BLOCK_N, D, NTHREADS>(k_s, kb, k_ss, n0, sk, tid);
    fat::load_tile<T, BLOCK_N, D, NTHREADS>(v_s, vb, v_ss, n0, sk, tid);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows
    float s[NTILES][4];
#pragma unroll
    for (int nn = 0; nn < NTILES; ++nn) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nn][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        uint32_t b0, b1;
        fat::load_b_rows(b0, b1, k_s + nn * 8 * STRIDE, STRIDE, g, t, kk * 16);
        Mma<T>::run(s[nn], qf[kk], b0, b1);
      }
    }

    // scale into the log2 domain; mask only tiles on an edge
    const bool masked = (n0 + BLOCK_N > sk) ||
                        (causal && n0 + BLOCK_N - 1 > m0 + off);
#pragma unroll
    for (int nn = 0; nn < NTILES; ++nn) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nn][e] * scale_log2;
        if (masked) {
          const int col = n0 + nn * 8 + t * 2 + (e & 1);
          const int row = rows[e >> 1];
          if (col >= sk || (causal && col > row + off)) x = -CUDART_INF_F;
        }
        s[nn][e] = x;
      }
    }

    // online softmax on the thread's two rows (4 threads share a row)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int nn = 0; nn < NTILES; ++nn)
        mx = fmaxf(mx, fmaxf(s[nn][2 * r], s[nn][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, 2));
      const float m_new = fmaxf(m_r[r], mx);
      // a row with nothing live yet keeps p = 0 instead of exp2(-inf + inf)
      const float m_use = m_new == -CUDART_INF_F ? 0.f : m_new;
      const float alpha = exp2f(m_r[r] - m_use);
      float sum = 0.f;
#pragma unroll
      for (int nn = 0; nn < NTILES; ++nn) {
        s[nn][2 * r] = exp2f(s[nn][2 * r] - m_use);
        s[nn][2 * r + 1] = exp2f(s[nn][2 * r + 1] - m_use);
        sum += s[nn][2 * r] + s[nn][2 * r + 1];
      }
      sum += __shfl_xor_sync(0xffffffff, sum, 1);
      sum += __shfl_xor_sync(0xffffffff, sum, 2);
      l_r[r] = l_r[r] * alpha + sum;
      m_r[r] = m_new;
#pragma unroll
      for (int dt = 0; dt < DTILES; ++dt) {
        acc[dt][2 * r] *= alpha;
        acc[dt][2 * r + 1] *= alpha;
      }
    }

    // O += P V: two S n-tiles form one A fragment (the C and A layouts agree)
#pragma unroll
    for (int kk = 0; kk < BLOCK_N / 16; ++kk) {
      uint32_t pa[4];
      fat::pack_a<T>(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dt = 0; dt < DTILES; ++dt) {
        uint32_t b0, b1;
        fat::load_b_cols(b0, b1, v_s + kk * 16 * STRIDE + dt * 8, STRIDE, g, t);
        Mma<T>::run(acc[dt], pa, b0, b1);
      }
    }
  }

  // epilogue: O = acc / l (0 for dead rows), LSE = (m + log2 l) * ln 2
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = rows[r];
    if (row >= sq) continue;
    const bool alive = l_r[r] > 0.f;
    const float inv = alive ? 1.f / l_r[r] : 0.f;
    T* orow = o + (((long long)batch * sq + row) * h + head) * D;
#pragma unroll
    for (int dt = 0; dt < DTILES; ++dt) {
      *reinterpret_cast<uint32_t*>(orow + dt * 8 + t * 2) =
          Mma<T>::pack(acc[dt][2 * r] * inv, acc[dt][2 * r + 1] * inv);
    }
    if (t == 0) {
      lse[((long long)batch * h + head) * sq + row] =
          alive ? (m_r[r] + log2f(l_r[r])) * 0.69314718055994531f : empty_lse;
    }
  }
}

template <typename T, int D>
void launch(const void* q, const void* k, const void* v, void* o, float* lse,
            int b, int sq, int sk, int h, int hk, const long long* st,
            float scale_log2, int causal, float empty_lse, cudaStream_t stream) {
  dim3 grid((sq + BLOCK_M - 1) / BLOCK_M, h, b);
  flash_fwd_kernel<T, D><<<grid, NTHREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, sq, sk, h, h / hk,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      scale_log2, causal, empty_lse);
}

}  // namespace

extern "C" {

// strides: 9 int64 in elements, (batch, seq, head) for q, k, v.
// o is a contiguous (b, sq, h, d) tensor; lse a contiguous (b, h, sq) fp32.
int fat_flash_fwd(const void* q, const void* k, const void* v, void* o,
                  void* lse, int b, int sq, int sk, int h, int hk, int d,
                  const long long* strides, float scale_log2, int causal,
                  float empty_lse, int is_fp16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (d == 128 && !is_fp16)
    launch<__nv_bfloat16, 128>(q, k, v, o, l, b, sq, sk, h, hk, strides,
                               scale_log2, causal, empty_lse, s);
  else if (d == 128)
    launch<__half, 128>(q, k, v, o, l, b, sq, sk, h, hk, strides, scale_log2,
                        causal, empty_lse, s);
  else if (d == 64 && !is_fp16)
    launch<__nv_bfloat16, 64>(q, k, v, o, l, b, sq, sk, h, hk, strides,
                              scale_log2, causal, empty_lse, s);
  else if (d == 64)
    launch<__half, 64>(q, k, v, o, l, b, sq, sk, h, hk, strides, scale_log2,
                       causal, empty_lse, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
