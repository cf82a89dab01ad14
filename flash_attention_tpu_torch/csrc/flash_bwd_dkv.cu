// Flash-attention backward, step 3 of 3: dK and dV, for Hopper (sm_90a),
// hand-written CUDA C++.
//
// Replaces: flash_attention_tpu/ops/flash_bwd.py::_dkv_kernel, its dense and
// its segmented pallas_call.
//
// Computes, per (batch, kv head) and key row j: dV = sum_g P^T dO and
// dK = scale sum_g dS^T Q, the sum running over the GQA group of query heads
// that share the kv head, with P = exp(S - LSE) and dS = P * (dP - D)
// recomputed as in flash_bwd_dq.cu, under the band of flash_fwd.cu (causal
// is right = 0) and, in the softcap instance (CAP), with t = tanh(S / cap)
// recomputed and dS times 1 - t^2. Masked entries, query rows at or past sq
// and rows with no live key get P = 0. Q, dO (b, sq, h, d) and K, V
// (b, sk, hk, d), bf16 or fp16, d 64, 128 or 256 (d 384 and 512:
// flash_bwd_dkv_wide.cu), are read by TMA through their strides; dK and dV
// are written contiguous (b, sk, hk, d) in the input dtype.
//
// What bounds it on the H100: at training shapes (sq = sk = 2048, d = 128)
// its four products (K Q^T, V dO^T, P^T dO, dS^T Q; 8 d FLOP per live score)
// make it compute-bound, so the tensor cores set the floor.
//
// What the design does about it: a warp-specialised CTA of three warpgroups
// owns 128 key rows, in the key-major orientation.
// * Warpgroup 0, the producer, gives most of its registers away
//   (setmaxnreg). One thread loads the CTA's K and V once and streams 64-row
//   Q and dO tiles of every query head of the group by TMA into a ring of
//   STAGES stages; a second warp copies the tiles' LSE (in the log2 domain,
//   +inf past sq, so those rows get P = 0 with no test) and D into the same
//   stage. Each stage has a full mbarrier (the TMA bytes and the warp's 32
//   arrivals) and an empty one that the 8 consumer warps release.
// * Warpgroups 1 and 2, the consumers, own 64 key rows each and compute
//   S^T = K Q^T and dP^T = V dO^T as wgmma chains with both operands in
//   shared memory (K-major, in the 128-byte swizzle TMA wrote). dP^T is
//   hop::ss_chain, the chain flash_bwd_di.cu sums D with, so P * (dP - D)
//   cancels to exactly 0 where a row attends to one key. P^T and dS^T,
//   rounded to the input type, are then already the register A operands of
//   dV += P^T dO and dK += dS^T Q, whose B operands are dO and Q read
//   MN-major (wgmma's transpose mode), so no transposed copy is made.
// * dK and dV stay in fp32 registers (128 a thread at d 128; the consumers
//   raise themselves to 240 registers) across the whole group and every
//   query tile, so the group is summed in the CTA with no atomics and no
//   second pass, and two runs give bit-identical results.
// * Query tiles wholly outside the band are never loaded: a key block's
//   rows run from its first key's right edge to its last key's left edge
//   (the band mirrored); only tiles that cross an edge pay for masking, one
//   warp's 16 keys at a time. Under CAP the consumers wait for dP^T before
//   they form P^T, then form P^T and dS^T in one pass, so that t needs no
//   registers of its own past the tile's arithmetic (dK and dV hold 128 a
//   thread). TMA zero-fills rows past sq and sk. The grid puts the key block in
//   its slowest dimension, so the CTAs with the most query tiles (the first
//   key blocks) start first.
// * At d 256 (Cfg::SPLIT) a CTA owns 64 key rows and its two consumers
//   split the accumulators: consumer 0 computes S^T and P^T and holds dV,
//   consumer 1 computes dP^T and holds dK, and P^T (times 1 - t^2 under
//   CAP) reaches consumer 1 through an fp32 buffer in each ring stage. The
//   two run their products side by side, so the tensor cores see two
//   chains at a time, as at d 128.
// * The epilogue writes scale * dK and dV into the consumer's own rows of
//   the K and V tiles in shared memory, in the swizzled layout, and stores
//   them with TMA, which clips rows past sk.
// * The segmented instance (SEG, fat::Seg): the CTA's query tiles are the
//   range ops/segments.py computed for its BLOCK_N keys over 64-row query
//   tiles (fat_flash_bwd_dkv_seg_tiles), in every head of the group; the
//   LSE/D warp also copies each tile's query ids and positions into the
//   stage (Q_PAD_SEG past sq; at d 256, where the stage has no room for
//   them, consumer 0 reads them from global memory, 512 bytes a tile that
//   the L1 holds), and the consumer that forms P^T holds its keys' ids and
//   positions in registers and masks every element by id and by the band
//   over positions. An empty range writes dK = dV = 0.

#include "flash_bwd_dkv_common.cuh"
#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

constexpr int CONSUMERS = 2;   // consumer warpgroups
constexpr int CTAS_PER_SM = 1;
constexpr int BLOCK_M = 64;    // query rows per streamed tile
constexpr int NTHREADS = 128 * (1 + CONSUMERS);
constexpr int PRODUCER_REGS = 24;
// what the SM's 65536 registers leave each consumer thread, up to 240
constexpr int consumer_regs() {
  const int r =
      (65536 / CTAS_PER_SM - 128 * PRODUCER_REGS) / (128 * CONSUMERS) / 8 * 8;
  return r > 240 ? 240 : r;
}
constexpr int CONSUMER_REGS = consumer_regs();  // 240 at 2 consumers

// The CTA by head dim. At d 64 and 128 each consumer owns 64 key rows and
// both their dK and dV (128 fp32 a thread at d 128), over a 3-stage ring. At
// d 256 the two would be 256 fp32 a thread, above the 255-register limit, so
// both consumers own the same 64 key rows (SPLIT): consumer 0 forms P^T and
// holds dV, consumer 1 forms dP^T and dS^T and holds dK, and P^T crosses
// from the first to the second through shared memory. K and V (64 KB) and
// two stages of Q and dO (128 KB) fill the shared memory.
template <int D>
struct Cfg {
  static constexpr bool SPLIT = D == 256;
  static constexpr int BLOCK_N = SPLIT ? 64 : 64 * CONSUMERS;  // key rows
  static constexpr int STAGES = SPLIT ? 2 : 3;  // depth of the Q/dO ring
};

template <int D, bool SEG = false>
struct Smem {
  static constexpr int BLOCK_N = Cfg<D>::BLOCK_N, STAGES = Cfg<D>::STAGES;
  static constexpr int KV_BYTES = BLOCK_N * D * 2;  // K, and V
  static constexpr int T_BYTES = BLOCK_M * D * 2;   // a Q or dO tile
  static constexpr int V_OFF = KV_BYTES;            // K at 0
  static constexpr int Q_OFF = 2 * KV_BYTES;
  static constexpr int DO_OFF = Q_OFF + STAGES * T_BYTES;
  static constexpr int VEC_OFF = DO_OFF + STAGES * T_BYTES;
  // LSE, D and, SEG, below d 256 the query ids and positions (int32; at
  // d 256 they would take the shared memory past the CTA's limit), then the
  // tile's fat::SegSpan
  static constexpr int SPAN_INT = (SEG && !Cfg<D>::SPLIT ? 4 : 2) * BLOCK_M;
  static constexpr int VEC_BYTES = (SPAN_INT + (SEG ? 4 : 0)) * 4;
  // SPLIT: each stage's P^T (or, with CAP, P^T (1 - t^2)) in fp32, from
  // consumer 0 to consumer 1
  static constexpr int X_OFF = VEC_OFF + STAGES * VEC_BYTES;
  static constexpr int X_BYTES = Cfg<D>::SPLIT ? BLOCK_M * 64 * 4 : 0;
  static constexpr int BAR_OFF = X_OFF + STAGES * X_BYTES;
  static constexpr int N_BARS = 1 + 2 * STAGES;  // k + v; tile full; empty
  // slack to align the tiles to 1024 bytes, the swizzle's period
  static constexpr int BYTES = BAR_OFF + N_BARS * 8 + 1024;
};

// SEG at d 256: seg_live with the tile's query ids and positions read from
// global memory (q_seg, q_pos: the batch row's), rows from m0 on (Q_PAD_SEG
// past sq).
__device__ __forceinline__ bool seg_live_global(int i, const int* q_seg,
                                                const int* q_pos, int sq,
                                                int m0, const SegKeys& sk,
                                                int t, const Band& bd) {
  const int c = (i / 4) * 8 + 2 * t + (i & 1), r = (i >> 1) & 1;
  const int row = m0 + c;
  const int qs = row < sq ? q_seg[row] : fat::Q_PAD_SEG;
  const int rel = sk.pos[r] - (row < sq ? q_pos[row] : 0);
  return qs == sk.seg[r] && rel >= -bd.left && rel <= bd.right;
}

// P^T in place, for the tile at query row m0: S^T scaled into the log2
// domain less the column's LSE, masked only where the tile crosses an edge
// of the band for this warp, or with SEG everywhere by ids and positions.
// lse2 holds the tile's 64 values in shared memory (then D and, SEG, the
// query ids and positions).
template <bool SEG>
__device__ __forceinline__ void probs_t(float (&sc)[BLOCK_M / 2],
                                        const float* lse2, int m0, int j0,
                                        int g, int t, const Band& bd,
                                        const SegKeys& sk) {
  const float scale_log2 = bd.scale_log2;
  int lo[2], hi[2];
  if constexpr (SEG) {
    const int* qseg = reinterpret_cast<const int*>(lse2 + 2 * BLOCK_M);
    if (seg_interior(qseg + 2 * BLOCK_M, sk, bd)) {
#pragma unroll
      for (int i = 0; i < BLOCK_M / 2; ++i)
        sc[i] = hop::exp2_approx(sc[i] * scale_log2 -
                                 lse2[(i / 4) * 8 + 2 * t + (i & 1)]);
      return;
    }
#pragma unroll
    for (int i = 0; i < BLOCK_M / 2; ++i) {
      const float p = hop::exp2_approx(sc[i] * scale_log2 -
                                       lse2[(i / 4) * 8 + 2 * t + (i & 1)]);
      sc[i] = seg_live<BLOCK_M>(i, qseg, sk, t, bd) ? p : 0.f;
    }
  } else if (tile_edge<BLOCK_M>(m0, j0, g, t, bd, lo, hi)) {
#pragma unroll
    for (int i = 0; i < BLOCK_M / 2; ++i) {
      const float p = hop::exp2_approx(sc[i] * scale_log2 -
                                       lse2[(i / 4) * 8 + 2 * t + (i & 1)]);
      sc[i] = live(i, lo, hi) ? p : 0.f;
    }
  } else {
#pragma unroll
    for (int i = 0; i < BLOCK_M / 2; ++i)
      sc[i] = hop::exp2_approx(sc[i] * scale_log2 -
                               lse2[(i / 4) * 8 + 2 * t + (i & 1)]);
  }
}

// The softcap instance's P^T (into sc) and dS^T (into dp) in one pass, for
// the tile at query row m0: t = tanh(S^T scale / cap), P^T = exp2(cap log2e
// t - LSE log2e), dS^T = P^T (dP^T - D) (1 - t^2). vec holds the tile's LSE
// (log2) and D in shared memory (and, SEG, the query ids and positions).
template <bool SEG>
__device__ __forceinline__ void probs_ds_cap(float (&sc)[BLOCK_M / 2],
                                             float (&dp)[BLOCK_M / 2],
                                             const float* vec, int m0, int j0,
                                             int g, int t, const Band& bd,
                                             const SegKeys& sk) {
  int lo[2], hi[2];
  const int* qseg = reinterpret_cast<const int*>(vec + 2 * BLOCK_M);
  const bool edge = SEG ? !seg_interior(qseg + 2 * BLOCK_M, sk, bd)
                        : tile_edge<BLOCK_M>(m0, j0, g, t, bd, lo, hi);
#pragma unroll
  for (int i = 0; i < BLOCK_M / 2; ++i) {
    const int c = (i / 4) * 8 + 2 * t + (i & 1);
    const float th = hop::tanh_exp2(sc[i] * bd.cap_scale);
    float p = hop::exp2_approx(bd.cap_log2 * th - vec[c]);
    if constexpr (SEG)
      p = !edge || seg_live<BLOCK_M>(i, qseg, sk, t, bd) ? p : 0.f;
    else
      p = !edge || live(i, lo, hi) ? p : 0.f;
    sc[i] = p;
    dp[i] = p * (dp[i] - vec[BLOCK_M + c]) * (1.f - th * th);
  }
}

template <typename T, int D, bool CAP, bool SEG>
__global__ void __launch_bounds__(NTHREADS, CTAS_PER_SM)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map,
                     const __grid_constant__ CUtensorMap do_map,
                     const __grid_constant__ CUtensorMap dk_map,
                     const __grid_constant__ CUtensorMap dv_map,
                     const float* __restrict__ lse,
                     const float* __restrict__ di, int sq, int sk, int h,
                     int group, float scale, float scale_log2, int left,
                     int right, float cap_scale, float cap_log2,
                     const fat::Seg seg) {
  using L = Smem<D, SEG>;
  constexpr int BLOCK_N = Cfg<D>::BLOCK_N, STAGES = Cfg<D>::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (hop::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + STAGES;

  const int kvh = blockIdx.x;
  const int batch = blockIdx.y;
  const int n0 = blockIdx.z * BLOCK_N;  // the first key blocks see the most rows
  const int off = sk - sq;              // lower-right offset of the band
  // query rows that see a key of this block, the band mirrored: from the
  // first key's right edge (row >= key - off - right) to the last key's
  // left edge (row <= key - off + left). Producer and consumers count the
  // same tiles.
  Tiles<BLOCK_M> tl;
  tl.m_first = right < fat::UNBOUNDED
                   ? max(0, n0 - off - right) / BLOCK_M * BLOCK_M
                   : 0;
  const int m_end = left < fat::UNBOUNDED
                        ? min(sq, min(n0 + BLOCK_N, sk) - off + left)
                        : sq;
  tl.n_m = m_end > tl.m_first ? (m_end - tl.m_first + BLOCK_M - 1) / BLOCK_M
                              : 0;
  if constexpr (SEG) {
    // the query tiles of this key block, from ops/segments.py
    const int blk = batch * gridDim.z + blockIdx.z;
    tl.m_first = seg.lo[blk] * BLOCK_M;
    tl.n_m = max(0, seg.hi[blk] - seg.lo[blk] + 1);
  }
  const int n_tiles = tl.count(group);

  const int role = __shfl_sync(0xffffffff, threadIdx.x / 128, 0);
  if (threadIdx.x == 0) {
    hop::mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      hop::mbar_init(&full[s], 1 + 32);  // the TMA thread and the LSE/D warp
      hop::mbar_init(&empty[s], 4 * CONSUMERS);  // one per consumer warp
    }
    hop::mbar_fence_init();
  }
  __syncthreads();

  if (role == 0) {
    // ---- producer ----
    hop::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      hop::prefetch_map(&k_map);
      hop::prefetch_map(&v_map);
      hop::prefetch_map(&q_map);
      hop::prefetch_map(&do_map);
      hop::mbar_expect_tx(kv_full, 2 * L::KV_BYTES);
#pragma unroll
      for (int c = 0; c < D / BOX; ++c) {
        hop::tma_load_4d(smem + c * BLOCK_N * ROW, &k_map, kv_full, c * BOX,
                         kvh, n0, batch);
        hop::tma_load_4d(smem + L::V_OFF + c * BLOCK_N * ROW, &v_map, kv_full,
                         c * BOX, kvh, n0, batch);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES;
        const int head = tl.head(i, kvh, group), m0 = tl.m0(i);
        uint8_t* qs = smem + L::Q_OFF + s * L::T_BYTES;
        uint8_t* ds = smem + L::DO_OFF + s * L::T_BYTES;
        if (i >= STAGES) hop::mbar_wait(&empty[s], (i / STAGES - 1) & 1);
        hop::mbar_expect_tx(&full[s], 2 * L::T_BYTES);
#pragma unroll
        for (int c = 0; c < D / BOX; ++c) {
          hop::tma_load_4d(qs + c * BLOCK_M * ROW, &q_map, &full[s], c * BOX,
                           head, m0, batch);
          hop::tma_load_4d(ds + c * BLOCK_M * ROW, &do_map, &full[s], c * BOX,
                           head, m0, batch);
        }
      }
    } else if (threadIdx.x / 32 == 1) {
      const int lane = threadIdx.x % 32;
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES;
        const int head = tl.head(i, kvh, group), m0 = tl.m0(i);
        float* vec = reinterpret_cast<float*>(smem + L::VEC_OFF +
                                              s * L::VEC_BYTES);
        const long long base = ((long long)batch * h + head) * sq;
        if (i >= STAGES) hop::mbar_wait(&empty[s], (i / STAGES - 1) & 1);
#pragma unroll
        int q_id[2], q_ps[2];  // SEG: the lane's two rows' ids and positions
        for (int e = 0; e < 2; ++e) {
          const int c = lane * 2 + e, row = m0 + c;
          vec[c] = row < sq ? lse[base + row] * fat::LOG2E : CUDART_INF_F;
          vec[BLOCK_M + c] = row < sq ? di[base + row] : 0.f;
          if constexpr (SEG) {
            const long long idx = (long long)batch * sq + row;
            q_id[e] = row < sq ? seg.q_seg[idx] : fat::Q_PAD_SEG;
            q_ps[e] = row < sq ? seg.q_pos[idx] : 0;
            if constexpr (!Cfg<D>::SPLIT) {
              int* qv = reinterpret_cast<int*>(vec + 2 * BLOCK_M);
              qv[c] = q_id[e];
              qv[BLOCK_M + c] = q_ps[e];
            }
          }
        }
        if constexpr (SEG) {
          const fat::SegSpan span = fat::seg_span(
              min(q_id[0], q_id[1]), max(q_id[0], q_id[1]),
              min(q_ps[0], q_ps[1]), max(q_ps[0], q_ps[1]));
          if (lane == 0)
            *reinterpret_cast<fat::SegSpan*>(vec + L::SPAN_INT) = span;
        }
        hop::mbar_arrive(&full[s]);
      }
    }
  } else if constexpr (Cfg<D>::SPLIT) {
    // ---- consumers, d 256: 0 holds dV, 1 holds dK, of the same 64 keys ----
    hop::setmaxnreg_inc<CONSUMER_REGS>();
    const int wg = role - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane >> 2;  // fragment row group
    const int t = lane & 3;   // thread in group
    const int j0 = n0 + warp * 16;  // this warp's first key
    const Band bd{off, left, right, scale_log2, cap_scale, cap_log2};
    const SegKeys sk_ = seg_keys<SEG>(seg.kv_seg + (long long)batch * sk,
                                      seg.kv_pos + (long long)batch * sk, sk,
                                      j0 + g);
    uint8_t* kv_rows = smem + (1 - wg) * L::V_OFF;  // V for 0, K for 1
    const uint32_t k_s = hop::smem_u32(smem);
    const uint32_t v_s = hop::smem_u32(smem + L::V_OFF);
    const uint32_t q_s = hop::smem_u32(smem + L::Q_OFF);
    const uint32_t do_s = hop::smem_u32(smem + L::DO_OFF);

    float acc[D / 2];         // unscaled dV (consumer 0) or dK (consumer 1)
    float sc[BLOCK_M / 2];    // S^T then P^T, or dP^T then dS^T, in fp32
    uint32_t fa[BLOCK_M / 16][4];  // P^T or dS^T as the A operand
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BLOCK_M / 2; ++i) sc[i] = 0.f;

    // Each stage carries its P^T factor in X; consumer 0 writes it and
    // arrives on named barrier 3 + (i & 1), which consumer 1 waits on. The
    // two barriers alternate, so consumer 0 (which cannot run more than a
    // stage ahead: the ring's empty barrier waits for both) never arrives
    // twice on one before consumer 1 has waited there. Each consumer's loop
    // is its own branch, so every wgmma chain is issued and waited for
    // inside it.
    hop::mbar_wait(kv_full, 0);
    if (wg == 0) {
      for (int i = 0; i < n_tiles; ++i) {
        // S^T = K Q^T, then P^T; dV += P^T dO
        const int s = i % STAGES;
        const uint32_t qt = q_s + s * L::T_BYTES, dot = do_s + s * L::T_BYTES;
        const float* vec = reinterpret_cast<const float*>(
            smem + L::VEC_OFF + s * L::VEC_BYTES);
        float* xs = reinterpret_cast<float*>(smem + L::X_OFF + s * L::X_BYTES);
        hop::mbar_wait(&full[s], (i / STAGES) & 1);
        hop::ss_chain<T, BLOCK_M, D>(sc, k_s, BLOCK_N, qt, BLOCK_M);
        hop::wgmma_commit();
        hop::wgmma_wait<0>();
        hop::fence_regs(sc);
        int lo[2], hi[2];
        const bool edge =
            SEG ? !seg_interior(reinterpret_cast<const int*>(vec) +
                                    L::SPAN_INT, sk_, bd)
                : tile_edge<BLOCK_M>(tl.m0(i), j0, g, t, bd, lo, hi);
#pragma unroll
        for (int e = 0; e < BLOCK_M / 2; ++e) {
          const int c = (e / 4) * 8 + 2 * t + (e & 1);
          float p, th = 0.f;
          if constexpr (CAP) {
            th = hop::tanh_exp2(sc[e] * bd.cap_scale);
            p = hop::exp2_approx(bd.cap_log2 * th - vec[c]);
          } else {
            p = hop::exp2_approx(sc[e] * bd.scale_log2 - vec[c]);
          }
          if constexpr (SEG)
            p = !edge || seg_live_global(e, seg.q_seg + (long long)batch * sq,
                                         seg.q_pos + (long long)batch * sq,
                                         sq, tl.m0(i), sk_, t, bd)
                    ? p : 0.f;
          else
            p = !edge || live(e, lo, hi) ? p : 0.f;
          sc[e] = p;
          xs[e * 128 + tid] = CAP ? p * (1.f - th * th) : p;
        }
        hop::named_arrive(3 + (i & 1), 256);
        fat::pack_a<T, BLOCK_M>(fa, sc);
        hop::rs_chain<T, D, BLOCK_M / 16>(acc, fa, dot, BLOCK_M);
        hop::wgmma_commit();
        hop::wgmma_wait<0>();
        hop::fence_regs(acc);
        hop::fence_regs(fa);
        __syncwarp();  // every lane has read the stage
        if (lane == 0) hop::mbar_arrive(&empty[s]);
      }
    } else {
      for (int i = 0; i < n_tiles; ++i) {
        // dP^T = V dO^T, then dS^T = X (dP^T - D); dK += dS^T Q
        const int s = i % STAGES;
        const uint32_t qt = q_s + s * L::T_BYTES, dot = do_s + s * L::T_BYTES;
        const float* vec = reinterpret_cast<const float*>(
            smem + L::VEC_OFF + s * L::VEC_BYTES);
        const float* xs =
            reinterpret_cast<const float*>(smem + L::X_OFF + s * L::X_BYTES);
        hop::mbar_wait(&full[s], (i / STAGES) & 1);
        hop::ss_chain<T, BLOCK_M, D>(sc, v_s, BLOCK_N, dot, BLOCK_M);
        hop::wgmma_commit();
        hop::wgmma_wait<0>();
        hop::fence_regs(sc);
        hop::named_sync(3 + (i & 1), 256);
#pragma unroll
        for (int e = 0; e < BLOCK_M / 2; ++e)
          sc[e] = xs[e * 128 + tid] *
                  (sc[e] - vec[BLOCK_M + (e / 4) * 8 + 2 * t + (e & 1)]);
        fat::pack_a<T, BLOCK_M>(fa, sc);
        hop::rs_chain<T, D, BLOCK_M / 16>(acc, fa, qt, BLOCK_M);
        hop::wgmma_commit();
        hop::wgmma_wait<0>();
        hop::fence_regs(acc);
        hop::fence_regs(fa);
        __syncwarp();  // every lane has read the stage
        if (lane == 0) hop::mbar_arrive(&empty[s]);
      }
    }

    // epilogue: dV into the V tile, scale * dK into the K tile, once both
    // consumers' last products (consumer 1's last reads V) are done
    hop::named_sync(5, 256);
    to_smem<T, D, BLOCK_N>(kv_rows, acc, wg == 0 ? 1.f : scale, warp, g, t);
    hop::fence_async_smem();
    hop::named_sync(1 + wg, 128);
    if (tid == 0) {
#pragma unroll
      for (int c = 0; c < D / BOX; ++c)
        hop::tma_store_4d(wg == 0 ? &dv_map : &dk_map,
                          kv_rows + c * BLOCK_N * ROW, c * BOX, kvh, n0,
                          batch);
      hop::tma_store_wait();
    }
  } else {
    // ---- consumers ----
    hop::setmaxnreg_inc<CONSUMER_REGS>();
    const int wg = role - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane >> 2;  // fragment row group
    const int t = lane & 3;   // thread in group
    const int j0 = n0 + wg * 64 + warp * 16;  // this warp's first key
    const Band bd{off, left, right, scale_log2, cap_scale, cap_log2};
    const SegKeys sk_ = seg_keys<SEG>(seg.kv_seg + (long long)batch * sk,
                                      seg.kv_pos + (long long)batch * sk, sk,
                                      j0 + g);
    // this consumer's 64 rows of the K and V tiles (in each 64-column box)
    uint8_t* k_rows = smem + wg * 64 * ROW;
    uint8_t* v_rows = smem + L::V_OFF + wg * 64 * ROW;
    const uint32_t k_s = hop::smem_u32(k_rows);
    const uint32_t v_s = hop::smem_u32(v_rows);
    const uint32_t q_s = hop::smem_u32(smem + L::Q_OFF);
    const uint32_t do_s = hop::smem_u32(smem + L::DO_OFF);

    float dk[D / 2], dv[D / 2];  // unscaled dK, and dV
    float sc[BLOCK_M / 2];       // S^T, then P^T in fp32
    float dp[BLOCK_M / 2];       // dP^T, then dS^T in fp32
    uint32_t pa[BLOCK_M / 16][4], sa[BLOCK_M / 16][4];  // P^T and dS^T as A
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BLOCK_M / 2; ++i) sc[i] = dp[i] = 0.f;

    hop::mbar_wait(kv_full, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % STAGES;
      const uint32_t qt = q_s + s * L::T_BYTES, dot = do_s + s * L::T_BYTES;
      const float* vec = reinterpret_cast<const float*>(
          smem + L::VEC_OFF + s * L::VEC_BYTES);
      hop::mbar_wait(&full[s], (i / STAGES) & 1);
      hop::ss_chain<T, BLOCK_M, D>(sc, k_s, BLOCK_N, qt, BLOCK_M);
      hop::wgmma_commit();
      hop::ss_chain<T, BLOCK_M, D>(dp, v_s, BLOCK_N, dot, BLOCK_M);
      hop::wgmma_commit();
      hop::wgmma_wait<1>();  // S^T is done; dP^T may still run
      hop::fence_regs(sc);
      if constexpr (CAP) {
        hop::wgmma_wait<0>();
        hop::fence_regs(dp);
        probs_ds_cap<SEG>(sc, dp, vec, tl.m0(i), j0, g, t, bd, sk_);
        fat::pack_a<T, BLOCK_M>(pa, sc);
      } else {
        probs_t<SEG>(sc, vec, tl.m0(i), j0, g, t, bd, sk_);
        fat::pack_a<T, BLOCK_M>(pa, sc);
        hop::wgmma_wait<0>();
        hop::fence_regs(dp);
#pragma unroll
        for (int e = 0; e < BLOCK_M / 2; ++e)
          dp[e] =
              sc[e] * (dp[e] - vec[BLOCK_M + (e / 4) * 8 + 2 * t + (e & 1)]);
      }
      fat::pack_a<T, BLOCK_M>(sa, dp);
      hop::rs_chain<T, D, BLOCK_M / 16>(dv, pa, dot, BLOCK_M);
      hop::rs_chain<T, D, BLOCK_M / 16>(dk, sa, qt, BLOCK_M);
      hop::wgmma_commit();
      hop::wgmma_wait<0>();
      hop::fence_regs(dv);
      hop::fence_regs(dk);
      hop::fence_regs(pa);
      hop::fence_regs(sa);
      __syncwarp();  // every lane has read the stage's LSE and D
      if (lane == 0) hop::mbar_arrive(&empty[s]);
    }

    // epilogue: scale * dK and dV into this consumer's rows of the K and V
    // tiles (their last reads are done), stored by TMA
    to_smem<T, D, BLOCK_N>(k_rows, dk, scale, warp, g, t);
    to_smem<T, D, BLOCK_N>(v_rows, dv, 1.f, warp, g, t);
    hop::fence_async_smem();
    hop::named_sync(1 + wg, 128);
    if (tid == 0) {
#pragma unroll
      for (int c = 0; c < D / BOX; ++c) {
        hop::tma_store_4d(&dk_map, k_rows + c * BLOCK_N * ROW, c * BOX, kvh,
                          n0 + wg * 64, batch);
        hop::tma_store_4d(&dv_map, v_rows + c * BLOCK_N * ROW, c * BOX, kvh,
                          n0 + wg * 64, batch);
      }
      hop::tma_store_wait();
    }
  }
}

template <typename T, int D, bool SEG>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* di, void* dk, void* dv, int b,
           int sq, int sk, int h, int hk, const long long* st, float scale,
           int left, int right, float cap_scale, float cap_log2,
           const fat::Seg& seg, cudaStream_t stream) {
  constexpr bool fp16 = std::is_same_v<T, __half>;
  constexpr int BLOCK_N = Cfg<D>::BLOCK_N;
  const long long o_st[3] = {(long long)sk * hk * D, (long long)hk * D, D};
  CUtensorMap qm, km, vm, dm, dkm, dvm;
  int rc;
  if ((rc = hop::make_map_bshd(&qm, q, fp16, b, sq, h, D, st, BLOCK_M)) ||
      (rc = hop::make_map_bshd(&km, k, fp16, b, sk, hk, D, st + 3, BLOCK_N)) ||
      (rc = hop::make_map_bshd(&vm, v, fp16, b, sk, hk, D, st + 6, BLOCK_N)) ||
      (rc = hop::make_map_bshd(&dm, dout, fp16, b, sq, h, D, st + 9, BLOCK_M)) ||
      (rc = hop::make_map_bshd(&dkm, dk, fp16, b, sk, hk, D, o_st, 64)) ||
      (rc = hop::make_map_bshd(&dvm, dv, fp16, b, sk, hk, D, o_st, 64)))
    return rc;
  auto kernel = cap_scale != 0.f ? flash_bwd_dkv_kernel<T, D, true, SEG>
                                 : flash_bwd_dkv_kernel<T, D, false, SEG>;
  constexpr int bytes = Smem<D, SEG>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(hk, b, (sk + BLOCK_N - 1) / BLOCK_N);
  kernel<<<grid, NTHREADS, bytes, stream>>>(
      qm, km, vm, dm, dkm, dvm, lse, di, sq, sk, h, h / hk, scale,
      scale * fat::LOG2E, fat::band_side(left),
      fat::band_side(right), cap_scale, cap_log2, seg);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// strides: 12 int64 in elements, (batch, seq, head) for q, k, v, dout.
// lse and di are contiguous (b, h, sq) fp32; dk and dv contiguous
// (b, sk, hk, d). left, right, cap_scale, cap_log2, seg: as fat_flash_fwd's
// (the ranges of key blocks over query tiles, fat_flash_bwd_dkv_seg_tiles).
int fat_flash_bwd_dkv(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* di,
                      void* dk, void* dv, int b, int sq, int sk, int h, int hk,
                      int d, const long long* strides, float scale, int left,
                      int right, float cap_scale, float cap_log2, int is_fp16,
                      const void* seg, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dd = static_cast<const float*>(di);
  const fat::Seg sg = fat::seg_arg(seg);
#define FAT_DKV_LAUNCH(T, D)                                                 \
  return seg ? launch<T, D, true>(q, k, v, dout, l, dd, dk, dv, b, sq, sk,   \
                                  h, hk, strides, scale, left, right,        \
                                  cap_scale, cap_log2, sg, s)                \
             : launch<T, D, false>(q, k, v, dout, l, dd, dk, dv, b, sq, sk,  \
                                   h, hk, strides, scale, left, right,       \
                                   cap_scale, cap_log2, sg, s)
  if (d == 256 && !is_fp16) FAT_DKV_LAUNCH(__nv_bfloat16, 256);
  if (d == 256) FAT_DKV_LAUNCH(__half, 256);
  if (d == 128 && !is_fp16) FAT_DKV_LAUNCH(__nv_bfloat16, 128);
  if (d == 128) FAT_DKV_LAUNCH(__half, 128);
  if (d == 64 && !is_fp16) FAT_DKV_LAUNCH(__nv_bfloat16, 64);
  if (d == 64) FAT_DKV_LAUNCH(__half, 64);
#undef FAT_DKV_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

// The segmented instance's tiles at head dim d: out[0] key rows a CTA owns
// (Cfg::BLOCK_N), out[1] query rows a streamed tile holds.
int fat_flash_bwd_dkv_seg_tiles(int d, int* out) {
  if (d != 64 && d != 128 && d != 256)
    return static_cast<int>(cudaErrorInvalidValue);
  out[0] = d == 256 ? Cfg<256>::BLOCK_N : Cfg<128>::BLOCK_N;
  out[1] = BLOCK_M;
  return 0;
}

}  // extern "C"
