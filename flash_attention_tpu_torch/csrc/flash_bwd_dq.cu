// Flash-attention backward, step 2 of 3: dQ, for Hopper (sm_90a),
// hand-written CUDA C++.
//
// Replaces: flash_attention_tpu/ops/flash_bwd.py::_dq_kernel, its dense and
// its segmented pallas_call.
//
// Computes, per (batch, head) and query row i, with the kv head head / group:
// S = scale Q K^T recomputed, P = exp(S - LSE) from the forward's natural-log
// LSE, dP = dO V^T, dS = P * (dP - D) with D from flash_bwd_di.cu, and
// dQ = scale dS K. The band of flash_fwd.cu (lower-right-aligned, causal is
// right = 0); masked entries, columns at or past sk and rows with no live
// key get P = 0 explicitly, so those rows get dQ = 0. With the softcap
// instance (CAP), S is cap tanh(S / cap) with t = tanh(...) recomputed, and
// dS takes the chain rule's 1 - t^2. Q, dO (b, sq, h, d) and K, V
// (b, sk, hk, d), bf16 or fp16, d 64, 128 or 256 (d 384 and 512:
// flash_bwd_dq_wide.cu), are read by TMA through their strides; dQ is
// written contiguous (b, sq, h, d) in the input dtype.
//
// What bounds it on the H100: at training shapes (sq = sk = 2048, d = 128)
// its three products (Q K^T, dO V^T, dS K; 6 d FLOP per live score) make it
// compute-bound, so the tensor cores set the floor; the exp2 and the dS
// arithmetic (about eight instructions per score) must hide behind them.
//
// What the design does about it: a warp-specialised CTA of three warpgroups
// owns 128 query rows, as the forward (flash_fwd.cu) does.
// * Warpgroup 0, the producer, gives most of its registers away
//   (setmaxnreg); one of its threads loads the Q and dO tiles once and
//   streams 64-row K and V tiles by TMA into a ring of STAGES stages, each
//   with a full mbarrier and an empty one that the 8 consumer warps release.
// * Warpgroups 1 and 2, the consumers, own 64 query rows each. S = Q K^T and
//   dP = dO V^T are wgmma chains with both operands in shared memory
//   (K-major, in the 128-byte swizzle TMA wrote); dP is hop::ss_chain, the
//   chain flash_bwd_di.cu sums D with, so P * (dP - D) cancels to exactly 0
//   where a row attends to one key. P and dS stay in fp32 registers; dS,
//   rounded to the input type, is the register A operand of dQ += dS K, whose
//   B operand is K read MN-major (wgmma's transpose mode), so no transposed
//   copy is made. The dQ accumulator (64 fp32 a thread at d 128) stays in
//   registers.
// * Overlap: each consumer issues S(j + 1) and dP(j + 1) behind dS(j) K(j),
//   and computes P(j + 1) while dP(j + 1) finishes; the two consumers
//   interleave on the tensor cores.
// * KV tiles wholly outside the band are never loaded: the CTA's tiles
//   start at the one holding its first row's left edge, and each consumer
//   stops at its own rows' right edge; only tiles that cross an edge of the
//   band or the ragged kv edge pay for masking, one warp's 16 rows at a
//   time. Under CAP a consumer waits for dP before it forms P, so that t
//   needs no registers of its own past the tile's arithmetic. TMA
//   zero-fills rows past sk and sq. The grid puts the query block in its
//   slowest dimension, reversed, so the CTAs with the longest causal rows
//   start first.
// * At d 256 (Cfg) the CTA is one consumer warpgroup and the producer over
//   64 query rows, with a 2-stage ring: the consumer overlaps its own
//   products as above, but no second consumer fills the tensor cores while
//   it computes dS.
// * The epilogue writes scale * dQ into the consumer's own rows of the Q tile
//   in shared memory, in the swizzled layout, and stores it with one TMA
//   store per 64-column box, which clips rows past sq.
// * The segmented instance (SEG, fat::Seg), as flash_fwd.cu's: the CTA's kv
//   tiles are the range ops/segments.py computed for its BLOCK_M rows at
//   this kernel's tiles (fat_flash_bwd_dq_seg_tiles), shared by both
//   consumers; a second producer warp copies each tile's kv ids and
//   positions into the stage beside K and V and arrives on its full
//   barrier; every element is masked by id and by the band over positions
//   (P = 0), so rows with no live key get dQ = 0.

#include "flash_bwd_dq_common.cuh"
#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

constexpr int BLOCK_N = 64;    // kv rows per tile
constexpr int BOX = 64;        // head-dim elements per TMA box (128 bytes)
constexpr int ROW = BOX * 2;   // bytes per box row
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;  // 128 * 40 + 256 * 232 <= 65536

// The CTA by head dim: at d 64 and 128 two consumer warpgroups (64 query
// rows each) and a 3-stage K/V ring. At d 256 one consumer and 2 stages:
// Q and dO for 64 rows (64 KB) and two stages of K and V (128 KB) fill the
// shared memory, and the consumer's dQ (128 fp32), S, dP (32 each) and dS
// (16) take up to 255 registers, which 256 threads a CTA leave every thread
// with no setmaxnreg.
template <int D>
struct Cfg {
  static constexpr int CONSUMERS = D == 256 ? 1 : 2;
  static constexpr int BLOCK_M = 64 * CONSUMERS;  // query rows per CTA
  static constexpr int STAGES = D == 256 ? 2 : 3;  // depth of the K/V ring
  static constexpr int NTHREADS = 128 * (1 + CONSUMERS);  // and a producer
};

template <int D, bool SEG = false>
struct Smem {
  static constexpr int BLOCK_M = Cfg<D>::BLOCK_M;
  static constexpr int STAGES = Cfg<D>::STAGES;
  static constexpr int Q_BYTES = BLOCK_M * D * 2;  // Q, and dO
  static constexpr int KV_BYTES = BLOCK_N * D * 2;
  static constexpr int DO_OFF = Q_BYTES;
  static constexpr int K_OFF = 2 * Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  static constexpr int N_BARS = 1 + 2 * STAGES;  // q + do; kv full; kv empty
  // SEG: each stage's kv ids, positions and their fat::SegSpan (int32)
  static constexpr int META_OFF = BAR_OFF + N_BARS * 8;
  static constexpr int META_INTS = SEG ? 2 * BLOCK_N + 4 : 0;
  // slack to align the tiles to 1024 bytes, the swizzle's period
  static constexpr int BYTES = META_OFF + STAGES * META_INTS * 4 + 1024;
};

// S(j) and dP(j) for one consumer's 64 rows: two commit groups, S first.
template <typename T, int D>
__device__ __forceinline__ void issue_s_dp(float (&sc)[BLOCK_N / 2],
                                           float (&dp)[BLOCK_N / 2],
                                           uint32_t q_s, uint32_t do_s,
                                           uint32_t ks, uint32_t vs) {
  constexpr int BLOCK_M = Cfg<D>::BLOCK_M;
  hop::ss_chain<T, BLOCK_N, D>(sc, q_s, BLOCK_M, ks, BLOCK_N);
  hop::wgmma_commit();
  hop::ss_chain<T, BLOCK_N, D>(dp, do_s, BLOCK_M, vs, BLOCK_N);
  hop::wgmma_commit();
}

template <typename T, int D, bool CAP, bool SEG>
__global__ void __launch_bounds__(Cfg<D>::NTHREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map,
                    const __grid_constant__ CUtensorMap do_map,
                    const __grid_constant__ CUtensorMap dq_map,
                    const float* __restrict__ lse, const float* __restrict__ di,
                    int sq, int sk, int h, int group, float scale,
                    float scale_log2, int left, int right, float cap_scale,
                    float cap_log2, const fat::Seg seg) {
  using L = Smem<D, SEG>;
  constexpr int BLOCK_M = Cfg<D>::BLOCK_M, STAGES = Cfg<D>::STAGES;
  constexpr int CONSUMERS = Cfg<D>::CONSUMERS;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (hop::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;

  const int head = blockIdx.x;
  const int batch = blockIdx.y;
  // longest causal rows first: the last query block has the most kv tiles
  const int m_lo = (gridDim.z - 1 - blockIdx.z) * BLOCK_M;
  const int off = sk - sq;  // lower-right offset of the band
  // The CTA's kv tiles start at the one holding its first row's left edge;
  // rows [m_lo, hi) see kv columns up to the last row's right edge (rows
  // past sq are clamped: they are never stored). Producer and consumers read
  // tiles t_begin + j, j < n_tiles_of(their last row + 1).
  const int t_begin =
      left < fat::UNBOUNDED ? max(0, m_lo + off - left) / BLOCK_N : 0;
  auto n_tiles_of = [&](int hi) {
    const int n_end =
        right < fat::UNBOUNDED ? min(sk, min(hi, sq) + off + right) : sk;
    return n_end > t_begin * BLOCK_N
               ? (n_end + BLOCK_N - 1) / BLOCK_N - t_begin
               : 0;
  };
  // SEG: the range of this query block, from ops/segments.py, for both
  // consumers
  int seg_begin = 0, seg_tiles = 0;
  if constexpr (SEG) {
    const int blk = batch * gridDim.z + (gridDim.z - 1 - blockIdx.z);
    seg_begin = seg.lo[blk];
    seg_tiles = max(0, seg.hi[blk] - seg_begin + 1);
  }

  const int role = __shfl_sync(0xffffffff, threadIdx.x / 128, 0);
  if (threadIdx.x == 0) {
    hop::mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      hop::mbar_init(&full[s], SEG ? 1 + 32 : 1);  // SEG: the meta warp
      hop::mbar_init(&empty[s], 4 * CONSUMERS);  // one per consumer warp
    }
    hop::mbar_fence_init();
  }
  __syncthreads();

  if (role == 0) {
    // ---- producer ----
    if constexpr (CONSUMERS == 2) hop::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      hop::prefetch_map(&q_map);
      hop::prefetch_map(&do_map);
      hop::prefetch_map(&k_map);
      hop::prefetch_map(&v_map);
      const int kvh = head / group;
      const int n_tiles = SEG ? seg_tiles : n_tiles_of(m_lo + BLOCK_M);
      const int t0 = SEG ? seg_begin : t_begin;
      hop::mbar_expect_tx(q_full, 2 * L::Q_BYTES);
#pragma unroll
      for (int c = 0; c < D / BOX; ++c) {
        hop::tma_load_4d(smem + c * BLOCK_M * ROW, &q_map, q_full, c * BOX,
                         head, m_lo, batch);
        hop::tma_load_4d(smem + L::DO_OFF + c * BLOCK_M * ROW, &do_map, q_full,
                         c * BOX, head, m_lo, batch);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        uint8_t* ks = smem + L::K_OFF + s * L::KV_BYTES;
        uint8_t* vs = smem + L::V_OFF + s * L::KV_BYTES;
        if (j >= STAGES) hop::mbar_wait(&empty[s], (j / STAGES - 1) & 1);
        hop::mbar_expect_tx(&full[s], 2 * L::KV_BYTES);
#pragma unroll
        for (int c = 0; c < D / BOX; ++c) {
          hop::tma_load_4d(ks + c * BLOCK_N * ROW, &k_map, &full[s], c * BOX,
                           kvh, (t0 + j) * BLOCK_N, batch);
          hop::tma_load_4d(vs + c * BLOCK_N * ROW, &v_map, &full[s], c * BOX,
                           kvh, (t0 + j) * BLOCK_N, batch);
        }
      }
    } else if constexpr (SEG) {
      if (threadIdx.x / 32 == 1) {
        // each kv tile's ids, positions and span into its stage, read from
        // global memory a tile ahead of the stage's release
        constexpr int PER = BLOCK_N / 32;  // columns a lane
        const int lane = threadIdx.x % 32;
        const int* kv_seg = seg.kv_seg + (long long)batch * sk;
        const int* kv_pos = seg.kv_pos + (long long)batch * sk;
        int ids[PER], pss[PER];
        if (seg_tiles > 0)
          fat::seg_fetch(kv_seg, kv_pos, seg_begin * BLOCK_N, sk,
                         fat::KV_PAD_SEG, lane, ids, pss);
        for (int j = 0; j < seg_tiles; ++j) {
          const int s = j % STAGES;
          const fat::SegSpan span = fat::seg_span_of(ids, pss);
          if (j >= STAGES) hop::mbar_wait(&empty[s], (j / STAGES - 1) & 1);
          fat::seg_store(reinterpret_cast<int*>(smem + L::META_OFF) +
                             s * L::META_INTS,
                         ids, pss, span, lane);
          hop::mbar_arrive(&full[s]);
          if (j + 1 < seg_tiles)
            fat::seg_fetch(kv_seg, kv_pos, (seg_begin + j + 1) * BLOCK_N, sk,
                           fat::KV_PAD_SEG, lane, ids, pss);
        }
      }
    }
  } else {
    // ---- consumers ----
    if constexpr (CONSUMERS == 2) hop::setmaxnreg_inc<CONSUMER_REGS>();
    const int wg = role - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane >> 2;  // fragment row group
    const int t = lane & 3;   // thread in group
    const int wg_lo = m_lo + wg * 64;
    const int w0 = wg_lo + warp * 16;  // this warp's first row
    // this consumer's tiles: at most one fewer than the CTA's (consumer 0's
    // rows end 64 earlier), and a stage is reused only STAGES >= 2 tiles
    // later, so the release of a tile it never reads is never awaited
    const int n_tiles = SEG ? seg_tiles : n_tiles_of(wg_lo + 64);
    const int t0 = SEG ? seg_begin : t_begin;
    Rows rw{{w0 + g, w0 + g + 8}, w0, t, sk, off, left, right, scale_log2,
            cap_scale, cap_log2};
    SegRows sr{};
    if constexpr (SEG) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const long long idx = (long long)batch * sq + rw.row[r];
        sr.seg[r] = rw.row[r] < sq ? seg.q_seg[idx] : fat::Q_PAD_SEG;
        sr.pos[r] = rw.row[r] < sq ? seg.q_pos[idx] : 0;
      }
      sr.warp = fat::seg_span(min(sr.seg[0], sr.seg[1]),
                              max(sr.seg[0], sr.seg[1]),
                              min(sr.pos[0], sr.pos[1]),
                              max(sr.pos[0], sr.pos[1]));
    }
    // SEG: the stages' kv ids, positions and spans
    const int* meta = reinterpret_cast<const int*>(smem + L::META_OFF);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const long long idx = ((long long)batch * h + head) * sq + rw.row[r];
      // a row past sq is never stored: P = 0 keeps it finite
      rw.lse2[r] = rw.row[r] < sq ? lse[idx] * fat::LOG2E : CUDART_INF_F;
      rw.d[r] = rw.row[r] < sq ? di[idx] : 0.f;
    }
    // this consumer's 64 rows of the Q and dO tiles (in each 64-column box)
    uint8_t* q_rows = smem + wg * 64 * ROW;
    const uint32_t q_s = hop::smem_u32(q_rows);
    const uint32_t do_s = hop::smem_u32(smem + L::DO_OFF + wg * 64 * ROW);
    const uint32_t k_s = hop::smem_u32(smem + L::K_OFF);
    const uint32_t v_s = hop::smem_u32(smem + L::V_OFF);

    float acc[D / 2];            // dQ, unscaled
    float sc[BLOCK_N / 2];       // S, then dS in fp32
    float dp[BLOCK_N / 2];       // dP
    uint32_t da[BLOCK_N / 16][4];  // dS as the A operand of dS K
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BLOCK_N / 2; ++i) sc[i] = dp[i] = 0.f;

    // S(j + 1) and dP(j + 1) are issued behind dS(j) K(j); the first and
    // last tiles are peeled off, so no wgmma is issued under a condition
    // inside the loop.
    hop::mbar_wait(q_full, 0);
    if (n_tiles > 0) {
      hop::mbar_wait(&full[0], 0);
      issue_s_dp<T, D>(sc, dp, q_s, do_s, k_s, v_s);
      hop::wgmma_wait<1>();
      hop::fence_regs(sc);
      if constexpr (!CAP) probs<SEG, BLOCK_N>(sc, t0 * BLOCK_N, rw, sr, meta);
      hop::wgmma_wait<0>();
      hop::fence_regs(dp);
      if constexpr (CAP)
        dscores_cap<SEG, BLOCK_N>(sc, dp, t0 * BLOCK_N, rw, sr, meta);
      else
        dscores<BLOCK_N>(sc, dp, rw);
      fat::pack_a<T, BLOCK_N>(da, sc);
    }
    for (int j = 0; j + 1 < n_tiles; ++j) {
      const int s = j % STAGES, s1 = (j + 1) % STAGES;
      hop::rs_chain<T, D, BLOCK_N / 16>(acc, da, k_s + s * L::KV_BYTES,
                                        BLOCK_N);
      hop::wgmma_commit();
      hop::mbar_wait(&full[s1], ((j + 1) / STAGES) & 1);
      issue_s_dp<T, D>(sc, dp, q_s, do_s, k_s + s1 * L::KV_BYTES,
                       v_s + s1 * L::KV_BYTES);
      hop::wgmma_wait<2>();  // dS(j) K(j) is done: stage s is free
      hop::fence_regs(acc);
      hop::fence_regs(da);
      if (lane == 0) hop::mbar_arrive(&empty[s]);
      hop::wgmma_wait<1>();  // S(j + 1) is done; dP(j + 1) may still run
      hop::fence_regs(sc);
      const int n1 = (t0 + j + 1) * BLOCK_N;
      if constexpr (!CAP)
        probs<SEG, BLOCK_N>(sc, n1, rw, sr, meta + s1 * L::META_INTS);
      hop::wgmma_wait<0>();
      hop::fence_regs(dp);
      if constexpr (CAP)
        dscores_cap<SEG, BLOCK_N>(sc, dp, n1, rw, sr,
                                  meta + s1 * L::META_INTS);
      else
        dscores<BLOCK_N>(sc, dp, rw);
      fat::pack_a<T, BLOCK_N>(da, sc);
    }
    if (n_tiles > 0) {
      const int s = (n_tiles - 1) % STAGES;
      hop::rs_chain<T, D, BLOCK_N / 16>(acc, da, k_s + s * L::KV_BYTES,
                                        BLOCK_N);
      hop::wgmma_commit();
      hop::wgmma_wait<0>();
      hop::fence_regs(acc);
      hop::fence_regs(da);
      // (the last stage is never reused: no release)
    }

    // epilogue: scale * dQ into this consumer's rows of the Q tile (its last
    // read of them is done), in the swizzled layout the dQ map stores from
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = warp * 16 + g + 8 * r;
        const int chunk = (nt % 8) ^ (row & 7);
        *reinterpret_cast<uint32_t*>(q_rows + (nt / 8) * BLOCK_M * ROW +
                                     row * ROW + chunk * 16 + t * 4) =
            fat::Mma<T>::pack(acc[4 * nt + 2 * r] * scale,
                              acc[4 * nt + 2 * r + 1] * scale);
      }
    }
    hop::fence_async_smem();
    hop::named_sync(1 + wg, 128);
    if (tid == 0) {
#pragma unroll
      for (int c = 0; c < D / BOX; ++c)
        hop::tma_store_4d(&dq_map, q_rows + c * BLOCK_M * ROW, c * BOX, head,
                          wg_lo, batch);
      hop::tma_store_wait();
    }
  }
}

template <typename T, int D, bool SEG>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* di, void* dq, int b, int sq, int sk,
           int h, int hk, const long long* st, float scale, int left,
           int right, float cap_scale, float cap_log2, const fat::Seg& seg,
           cudaStream_t stream) {
  constexpr bool fp16 = std::is_same_v<T, __half>;
  const long long dq_st[3] = {(long long)sq * h * D, (long long)h * D, D};
  CUtensorMap qm, km, vm, dm, dqm;
  int rc;
  constexpr int BLOCK_M = Cfg<D>::BLOCK_M;
  if ((rc = hop::make_map_bshd(&qm, q, fp16, b, sq, h, D, st, BLOCK_M)) ||
      (rc = hop::make_map_bshd(&km, k, fp16, b, sk, hk, D, st + 3, BLOCK_N)) ||
      (rc = hop::make_map_bshd(&vm, v, fp16, b, sk, hk, D, st + 6, BLOCK_N)) ||
      (rc = hop::make_map_bshd(&dm, dout, fp16, b, sq, h, D, st + 9, BLOCK_M)) ||
      (rc = hop::make_map_bshd(&dqm, dq, fp16, b, sq, h, D, dq_st, 64)))
    return rc;
  auto kernel = cap_scale != 0.f ? flash_bwd_dq_kernel<T, D, true, SEG>
                                 : flash_bwd_dq_kernel<T, D, false, SEG>;
  constexpr int bytes = Smem<D, SEG>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(h, b, (sq + Cfg<D>::BLOCK_M - 1) / Cfg<D>::BLOCK_M);
  kernel<<<grid, Cfg<D>::NTHREADS, bytes, stream>>>(
      qm, km, vm, dm, dqm, lse, di, sq, sk, h, h / hk, scale,
      scale * fat::LOG2E, fat::band_side(left),
      fat::band_side(right), cap_scale, cap_log2, seg);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// strides: 12 int64 in elements, (batch, seq, head) for q, k, v, dout.
// lse and di are contiguous (b, h, sq) fp32; dq a contiguous (b, sq, h, d).
// left, right, cap_scale, cap_log2, seg: as fat_flash_fwd's (the ranges
// over fat_flash_bwd_dq_seg_tiles' blocks).
int fat_flash_bwd_dq(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* di,
                     void* dq, int b, int sq, int sk, int h, int hk, int d,
                     const long long* strides, float scale, int left,
                     int right, float cap_scale, float cap_log2, int is_fp16,
                     const void* seg, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dd = static_cast<const float*>(di);
  const fat::Seg sg = fat::seg_arg(seg);
#define FAT_DQ_LAUNCH(T, D)                                                  \
  return seg ? launch<T, D, true>(q, k, v, dout, l, dd, dq, b, sq, sk, h, hk, \
                                  strides, scale, left, right, cap_scale,     \
                                  cap_log2, sg, s)                            \
             : launch<T, D, false>(q, k, v, dout, l, dd, dq, b, sq, sk, h,    \
                                   hk, strides, scale, left, right,           \
                                   cap_scale, cap_log2, sg, s)
  if (d == 256 && !is_fp16) FAT_DQ_LAUNCH(__nv_bfloat16, 256);
  if (d == 256) FAT_DQ_LAUNCH(__half, 256);
  if (d == 128 && !is_fp16) FAT_DQ_LAUNCH(__nv_bfloat16, 128);
  if (d == 128) FAT_DQ_LAUNCH(__half, 128);
  if (d == 64 && !is_fp16) FAT_DQ_LAUNCH(__nv_bfloat16, 64);
  if (d == 64) FAT_DQ_LAUNCH(__half, 64);
#undef FAT_DQ_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

// The segmented instance's tiles at head dim d: out[0] query rows a CTA
// owns (Cfg::BLOCK_M), out[1] kv rows a streamed tile holds.
int fat_flash_bwd_dq_seg_tiles(int d, int* out) {
  if (d != 64 && d != 128 && d != 256)
    return static_cast<int>(cudaErrorInvalidValue);
  out[0] = d == 256 ? Cfg<256>::BLOCK_M : Cfg<128>::BLOCK_M;
  out[1] = BLOCK_N;
  return 0;
}

}  // extern "C"
