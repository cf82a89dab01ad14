// Flash-attention backward, step 3 of 3: dK and dV, for Hopper (sm_90a) at
// head dims 384 and 512, hand-written CUDA C++.
//
// Replaces: flash_attention_tpu/ops/flash_bwd.py::_dkv_kernel, its dense and
// its segmented pallas_call, at the head dims the JAX package pads d
// 257-512 to.
//
// Computes what flash_bwd_dkv.cu computes (see there: dV = sum_g P^T dO and
// dK = scale sum_g dS^T Q over the GQA group, P and dS recomputed, the
// band, the softcap, the segmented instance, rows past sq and rows with no
// live key), at d 384 and 512, where that kernel's designs do not fit: dK
// and dV for 64 keys are 2 x 64 x 512 fp32 = 256 KB at d 512, the whole
// register file, so no CTA of 64 keys holds both.
//
// What bounds it on the H100: the tensor cores. The minimum is 8 d FLOP a
// live score (K Q^T, V dO^T, P^T dO, dS^T Q), and this design does 8 d.
//
// What the design does about it:
// * A cluster of two CTAs per unit of work (a block of 64 keys and a range
//   of its kv head's query heads). CTA 0, the K-CTA, holds K, streams the
//   32-row Q tiles, computes S^T = K Q^T and P^T, and accumulates dK over
//   all d columns; CTA 1, the V-CTA, holds V, streams the dO tiles,
//   computes dP^T = V dO^T and dS^T, and accumulates dV. Each of the four
//   products is computed once, and each Q and dO byte is loaded once a
//   unit. Holding one of K and V leaves room for a ring of 4 stages at d
//   512 (6 at d 384).
// * The exchange, through distributed shared memory: the K-CTA stores each
//   tile's P^T (fp32; under CAP P^T (1 - t^2)) and P^T rounded to the input
//   type (the A operand of dV += P^T dO) into the V-CTA with st.async, which
//   completes the bytes on a barrier there; the V-CTA stores dS^T, rounded
//   to the input type, back the same way. Each side frees a buffer by
//   arriving on the writer's barrier remotely, with mbarrier.arrive's
//   default semantics and CTA-scope waits, as CUTLASS's cluster pipelines
//   do (a release at the cluster scope took a third of the kernel's time),
//   and, as they do, only once the product that takes the buffer's operand
//   has completed: the default arrive does not order this CTA's loads from
//   the buffer before the peer's next store into it, so a free sent after
//   the loads were issued but before their registers were read let the
//   peer overwrite a buffer still being read (wrong dV, now and then).
//   Tile i's P^T goes through buffer i & 1 of two, its dS^T through buffer
//   i & 3 of four.
// * In each CTA the two consumer warpgroups own half of the accumulator's
//   columns each (DH = d / 2: 128 fp32 registers a thread at d 512) and
//   share the score products: warpgroup i & 1 computes tile i's S^T (or
//   dP^T), its elementwise pass and the exchange; both then take tile i's
//   product. The K-CTA takes a pair's dK products after it has formed the
//   next pair's scores, so the round trip of P^T and dS^T through the peer
//   is hidden behind them; the V-CTA waits only for P^T, which its own
//   dP^T chain takes as long to form.
// * dP^T is hop::ss_chain at N 32 over the full d, the chain
//   flash_bwd_di.cu sums D with at these head dims, so P * (dP - D) cancels
//   to exactly 0 where a row attends to one key. (A split of the contraction
//   over d between the pair would round differently.)
// * The GQA group over a balanced grid (ops/flash_bwd.py::dkv_wide_plan
//   is its model): each key block's group is cut into equal head ranges,
//   one cluster each, where the band's left side is open (causal's first
//   blocks see every query row, its last ones a few). The clusters decode
//   their unit from blockIdx and the shapes, key block first, then batch,
//   kv head and head range: there the blocks' rows never grow with the
//   block index, so the units run longest first and the clusters the card
//   holds at once walk about the same number of tiles. A unit of a cut
//   block writes fp32 partial dK and dV into a workspace; a second kernel
//   behind the same C entry (dkv_wide_reduce_kernel) sums each block's
//   partials in head-range order and rounds once. No float atomics: two
//   runs are bit-identical.
// * Query tiles wholly outside the band are never loaded and only tiles
//   that cross an edge are masked, as in flash_bwd_dkv.cu; the segmented
//   instance reads its tile range from ops/segments.py at this kernel's
//   tiles (fat_flash_bwd_dkv_wide_seg_tiles), and an empty range writes
//   dK = dV = 0.
// * Epilogue: a unit of an unsplit block writes (scale *) its accumulator
//   into the K or V tile in shared memory and stores it by TMA, which clips
//   rows past sk.
//
// Left for later work: the m64n32 score products' lower rate (shared memory
// reads per FLOP), and a persistent grid (each unit reloads its K or V).

#include "flash_bwd_dkv_common.cuh"
#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

constexpr int BLOCK_N = 64;    // key rows per unit
constexpr int BLOCK_M = 32;    // query rows per streamed tile
constexpr int NTHREADS = 384;  // producer + 2 consumer warpgroups
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;  // 128 * 24 + 256 * 240 <= 65536
// exchange buffers: the V-CTA's P^T (tile i in buffer i & 1) and the
// K-CTA's dS^T (tile i in buffer i & 3: its consumers take a pair's dS^T
// after forming the next pair's scores, so four are in flight)
constexpr int NB_P = 2;
constexpr int NB_DS = 4;
// a thread's share of an exchange buffer, in 16-byte words: P^T (or P^T
// (1 - t^2)) in fp32 (4), then P^T rounded as A fragments (2); dS^T as A
// fragments (2). Word c of thread tid lies at (c * 128 + tid) * 16.
constexpr int P_WORDS = 6;
constexpr int DS_WORDS = 2;

template <int D, bool SEG>
struct Smem {
  static constexpr int STAGES = D == 384 ? 6 : 4;  // depth of the Q/dO ring
  static constexpr int KV_BYTES = BLOCK_N * D * 2;  // K or V at 0
  static constexpr int T_BYTES = BLOCK_M * D * 2;   // a Q or dO tile
  static constexpr int RING_OFF = KV_BYTES;
  static constexpr int VEC_OFF = RING_OFF + STAGES * T_BYTES;
  // the K-CTA's LSE and, SEG, the query ids and positions (int32), then the
  // tile's fat::SegSpan; the V-CTA's D
  static constexpr int SPAN_INT = (SEG ? 3 : 1) * BLOCK_M;
  static constexpr int VEC_BYTES = (SPAN_INT + (SEG ? 4 : 0)) * 4;
  // the exchange buffers this CTA receives into (the V-CTA's P^T, the
  // K-CTA's dS^T), at the same offset in both CTAs
  static constexpr int X_OFF = VEC_OFF + STAGES * VEC_BYTES;
  static constexpr int P_BYTES = P_WORDS * 128 * 16;
  static constexpr int DS_BYTES = DS_WORDS * 128 * 16;
  static constexpr int X_BYTES = NB_P * P_BYTES > NB_DS * DS_BYTES
                                     ? NB_P * P_BYTES
                                     : NB_DS * DS_BYTES;
  static constexpr int BAR_OFF = X_OFF + X_BYTES;
  // kv; tile full, empty; exchange full, free
  static constexpr int N_BARS = 1 + 2 * STAGES + 2 * NB_DS;
  // slack to align the tiles to 1024 bytes, the swizzle's period
  static constexpr int BYTES = BAR_OFF + N_BARS * 8 + 1024;
  static_assert(X_OFF % 16 == 0, "exchange words are 16 bytes");
  // the K-CTA's products run a pair of tiles behind its scores: four Q
  // tiles in the ring at once (fewer deadlock)
  static_assert(STAGES >= 4, "the ring holds two pairs of tiles");
  static_assert(BYTES <= 232448, "over the CTA's shared memory");
};

// The query tiles of one unit: the heads of its range, and in each the
// BM-row tiles from the first that sees the block.
struct UnitTiles {
  int m_first, n_m, head0;
  __device__ __forceinline__ int head(int i) const { return head0 + i / n_m; }
  __device__ __forceinline__ int m0(int i) const {
    return m_first + (i % n_m) * BLOCK_M;
  }
};

template <int N>
__device__ __forceinline__ void load_words(uint32_t (&a)[N][4],
                                           const uint8_t* buf, int tid) {
#pragma unroll
  for (int c = 0; c < N; ++c) {
    const uint4 w = *reinterpret_cast<const uint4*>(buf + (c * 128 + tid) * 16);
    a[c][0] = w.x, a[c][1] = w.y, a[c][2] = w.z, a[c][3] = w.w;
  }
}

template <int N>
__device__ __forceinline__ void send_words(uint32_t dst,
                                           const uint32_t (&a)[N][4], int tid,
                                           uint32_t bar) {
#pragma unroll
  for (int c = 0; c < N; ++c)
    hop::st_async_v4(dst + (c * 128 + tid) * 16, a[c][0], a[c][1], a[c][2],
                     a[c][3], bar);
}

template <typename T, int D, bool CAP, bool SEG>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(NTHREADS, 1)
flash_bwd_dkv_wide_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const __grid_constant__ CUtensorMap do_map,
                          const __grid_constant__ CUtensorMap dk_map,
                          const __grid_constant__ CUtensorMap dv_map,
                          const float* __restrict__ lse,
                          const float* __restrict__ di,
                          float* __restrict__ ws, int b, int sq, int sk,
                          int h, int group, int ranges, float scale,
                          float scale_log2, int left,
                          int right, float cap_scale, float cap_log2,
                          const fat::Seg seg) {
  using L = Smem<D, SEG>;
  constexpr int STAGES = L::STAGES;
  constexpr int DH = D / 2;  // accumulator columns a consumer owns
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (hop::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + STAGES;
  uint64_t* xfull = empty + STAGES;  // this CTA's exchange buffer arrived
  uint64_t* xfree = xfull + NB_DS;   // the peer's buffer is free again

  const int rank = static_cast<int>(hop::cluster_ctarank());  // 0 K, 1 V
  // this cluster's unit of ops/flash_bwd.py::dkv_wide_plan: key block,
  // batch, kv head, head range j (heads j * group / ranges on, within the
  // group); its workspace slot is its index where the blocks are split
  const int unit = blockIdx.x >> 1;
  const int hk = h / group;
  const int n_block = unit / (b * hk * ranges);
  const int batch = unit / (hk * ranges) % b;
  const int kvh = unit / ranges % hk;
  const int j = unit % ranges;
  const int slot = ranges > 1 ? unit : -1;
  const int n0 = n_block * BLOCK_N;
  const int off = sk - sq;  // lower-right offset of the band
  // query rows that see a key of this block, the band mirrored, as in
  // flash_bwd_dkv.cu; producers and consumers of both CTAs count the same
  // tiles
  UnitTiles tl;
  tl.head0 = kvh * group + j * group / ranges;
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
    const int blk = batch * ((sk + BLOCK_N - 1) / BLOCK_N) + n_block;
    tl.m_first = seg.lo[blk] * BLOCK_M;
    tl.n_m = max(0, seg.hi[blk] - seg.lo[blk] + 1);
  }
  const int head_end = kvh * group + (j + 1) * group / ranges;
  const int n_tiles = (head_end - tl.head0) * tl.n_m;

  const int role = __shfl_sync(0xffffffff, threadIdx.x / 128, 0);
  if (threadIdx.x == 0) {
    hop::mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      hop::mbar_init(&full[s], 1 + 32);  // the TMA thread and the vector warp
      hop::mbar_init(&empty[s], 8);      // one per consumer warp
    }
    for (int x = 0; x < NB_DS; ++x) {
      hop::mbar_init(&xfull[x], 1);  // armed here, filled by the peer
      hop::mbar_init(&xfree[x], 8);  // the peer's consumer warps
    }
    hop::mbar_fence_init();
    for (int x = 0; x < (rank == 0 ? NB_DS : NB_P); ++x)
      hop::mbar_expect_tx(&xfull[x], rank == 0 ? L::DS_BYTES : L::P_BYTES);
  }
  // both CTAs' barriers are ready before either stores into the other
  hop::cluster_sync();

  if (role == 0) {
    // ---- producer ----
    hop::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      const CUtensorMap* kv = rank == 0 ? &k_map : &v_map;
      const CUtensorMap* st = rank == 0 ? &q_map : &do_map;
      hop::prefetch_map(kv);
      hop::prefetch_map(st);
      hop::mbar_expect_tx(kv_full, L::KV_BYTES);
      for (int c = 0; c < D / BOX; ++c)
        hop::tma_load_4d(smem + c * BLOCK_N * ROW, kv, kv_full, c * BOX, kvh,
                         n0, batch);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES;
        uint8_t* ts = smem + L::RING_OFF + s * L::T_BYTES;
        if (i >= STAGES) hop::mbar_wait(&empty[s], (i / STAGES - 1) & 1);
        hop::mbar_expect_tx(&full[s], L::T_BYTES);
        for (int c = 0; c < D / BOX; ++c)
          hop::tma_load_4d(ts + c * BLOCK_M * ROW, st, &full[s], c * BOX,
                           tl.head(i), tl.m0(i), batch);
      }
    } else if (threadIdx.x / 32 == 1) {
      // each tile's LSE (log2, +inf past sq) and, SEG, query ids and
      // positions (the K-CTA), or D (the V-CTA): one row a lane
      const int lane = threadIdx.x % 32;
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES;
        const int row = tl.m0(i) + lane;
        float* vec = reinterpret_cast<float*>(smem + L::VEC_OFF +
                                              s * L::VEC_BYTES);
        const long long idx = ((long long)batch * h + tl.head(i)) * sq + row;
        float x;
        if (rank == 0)
          x = row < sq ? lse[idx] * fat::LOG2E : CUDART_INF_F;
        else
          x = row < sq ? di[idx] : 0.f;
        int q_id = 0, q_ps = 0;
        if constexpr (SEG) {
          const long long r = (long long)batch * sq + row;
          q_id = row < sq ? seg.q_seg[r] : fat::Q_PAD_SEG;
          q_ps = row < sq ? seg.q_pos[r] : 0;
        }
        if (i >= STAGES) hop::mbar_wait(&empty[s], (i / STAGES - 1) & 1);
        vec[lane] = x;
        if constexpr (SEG) {
          if (rank == 0) {
            int* qv = reinterpret_cast<int*>(vec + BLOCK_M);
            qv[lane] = q_id;
            qv[BLOCK_M + lane] = q_ps;
            const fat::SegSpan span = fat::seg_span(q_id, q_id, q_ps, q_ps);
            if (lane == 0)
              *reinterpret_cast<fat::SegSpan*>(vec + L::SPAN_INT) = span;
          }
        }
        hop::mbar_arrive(&full[s]);
      }
    }
  } else {
    // ---- consumers: each owns DH columns of the CTA's dK or dV ----
    hop::setmaxnreg_inc<CONSUMER_REGS>();
    const int wg = role - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane >> 2;  // fragment row group
    const int t = lane & 3;   // thread in group
    const uint32_t kv_s = hop::smem_u32(smem);
    const uint32_t ring_s = hop::smem_u32(smem + L::RING_OFF);
    const uint8_t* xbuf = smem + L::X_OFF;
    // the peer's exchange buffers and barriers
    const uint32_t x_peer = hop::mapa(hop::smem_u32(smem + L::X_OFF), rank ^ 1);
    const uint32_t xfull_peer = hop::mapa(hop::smem_u32(xfull), rank ^ 1);
    const uint32_t xfree_peer = hop::mapa(hop::smem_u32(xfree), rank ^ 1);
    // the consumer's DH columns of a Q or dO tile: boxes wg * DH / 64 on
    const uint32_t col = wg * (DH / BOX) * BLOCK_M * ROW;

    float acc[DH / 2];  // unscaled dK (K-CTA) or dV (V-CTA)
    float sc[BLOCK_M / 2];  // S^T then P^T, or dP^T then dS^T, in fp32
    uint32_t fa[BLOCK_M / 16][4];  // dS^T or P^T as the A operand
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;

    // this CTA's exchange buffers: the K-CTA's NB_DS of dS^T (A fragments
    // at word 0), the V-CTA's NB_P of P^T (A fragments at word 4)
    const int lg_nb = rank == 0 ? 2 : 1;  // log2 of their count
    const int x_stride = rank == 0 ? L::DS_BYTES : L::P_BYTES;
    const uint8_t* x_frag = xbuf + (rank == 0 ? 0 : 4 * 128 * 16);

    // dK += dS^T Q or dV += P^T dO over the consumer's columns of tile u,
    // once the peer's operand has arrived in its buffer; frees the stage
    // and, once the product has taken the operand, the buffer
    auto accumulate = [&](int u) {
      const int s = u % STAGES, xb = u & ((1 << lg_nb) - 1);
      hop::mbar_wait(&full[s], (u / STAGES) & 1);
      hop::mbar_wait(&xfull[xb], (u >> lg_nb) & 1);
      load_words(fa, x_frag + xb * x_stride, tid);
      // arm the buffer's next phase before the peer may fill it
      if (wg == 0 && tid == 0) hop::mbar_expect_tx(&xfull[xb], x_stride);
      hop::rs_chain<T, DH, BLOCK_M / 16>(
          acc, fa, ring_s + s * L::T_BYTES + col, BLOCK_M);
      hop::wgmma_commit();
      hop::wgmma_wait<0>();
      hop::fence_regs(acc);
      hop::fence_regs(fa);
      __syncwarp();  // every lane's product has read the stage and buffer
      if (lane == 0) {
        hop::mbar_arrive(&empty[s]);
        hop::mbar_arrive_remote(xfree_peer + xb * 8);
      }
    };

    hop::mbar_wait(kv_full, 0);
    if (rank == 0) {
      const int j0 = n0 + warp * 16;  // this warp's first key
      const Band bd{off, left, right, scale_log2, cap_scale, cap_log2};
      const SegKeys sk_ = seg_keys<SEG>(seg.kv_seg + (long long)batch * sk,
                                        seg.kv_pos + (long long)batch * sk,
                                        sk, j0 + g);
      // S^T = K Q^T of tile i, P^T, and both into the V-CTA's buffer i & 1
      auto scores = [&](int i) {
        const int s = i % STAGES, xb = i & 1;
        const float* vec = reinterpret_cast<const float*>(
            smem + L::VEC_OFF + s * L::VEC_BYTES);
        const int* qseg = reinterpret_cast<const int*>(vec + BLOCK_M);
        hop::mbar_wait(&full[s], (i / STAGES) & 1);
        hop::ss_chain<T, BLOCK_M, D>(sc, kv_s, BLOCK_N,
                                     ring_s + s * L::T_BYTES, BLOCK_M);
        hop::wgmma_commit();
        hop::wgmma_wait<0>();
        hop::fence_regs(sc);
        int lo[2], hi[2];
        const bool edge =
            SEG ? !seg_interior(reinterpret_cast<const int*>(vec) +
                                    L::SPAN_INT, sk_, bd)
                : tile_edge<BLOCK_M>(tl.m0(i), j0, g, t, bd, lo, hi);
        uint32_t xw[BLOCK_M / 8][4];  // P^T (1 - t^2) or P^T, fp32 bits
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
            p = !edge || seg_live<BLOCK_M>(e, qseg, sk_, t, bd) ? p : 0.f;
          else
            p = !edge || live(e, lo, hi) ? p : 0.f;
          sc[e] = p;
          xw[e / 4][e % 4] = __float_as_uint(CAP ? p * (1.f - th * th) : p);
        }
        fat::pack_a<T, BLOCK_M>(fa, sc);
        if (i >= NB_P) hop::mbar_wait(&xfree[xb], ((i >> 1) - 1) & 1);
        const uint32_t dst = x_peer + xb * L::P_BYTES;
        send_words(dst, xw, tid, xfull_peer + xb * 8);
        send_words(dst + 4 * 128 * 16, fa, tid, xfull_peer + xb * 8);
      };
      // consumer wg computes the scores of tiles 2 k + wg; both take every
      // tile's dK product, a pair behind, so that the dS^T of a pair has
      // come back while the next pair's scores were formed (the ring holds
      // the four Q tiles this needs). A wgmma issued under a condition
      // inside the loop serialises: the first scores, the last pair and the
      // last tile of an odd count are peeled.
      const int pairs = n_tiles / 2;
      if (pairs > 0) scores(wg);
      for (int k = 1; k < pairs; ++k) {
        scores(2 * k + wg);
        accumulate(2 * k - 2);
        accumulate(2 * k - 1);
      }
      if (pairs > 0) {
        accumulate(2 * pairs - 2);
        accumulate(2 * pairs - 1);
      }
      if (n_tiles & 1) {
        if (wg == 0) scores(n_tiles - 1);
        accumulate(n_tiles - 1);
      }
    } else {
      // dP^T = V dO^T of tile i, dS^T = X (dP^T - D) with the K-CTA's X of
      // buffer i & 1, rounded, into the K-CTA's buffer i & 3
      auto dscores = [&](int i) {
        const int s = i % STAGES, xb = i & 1;
        const float* vec = reinterpret_cast<const float*>(
            smem + L::VEC_OFF + s * L::VEC_BYTES);
        hop::mbar_wait(&full[s], (i / STAGES) & 1);
        hop::ss_chain<T, BLOCK_M, D>(sc, kv_s, BLOCK_N,
                                     ring_s + s * L::T_BYTES, BLOCK_M);
        hop::wgmma_commit();
        hop::wgmma_wait<0>();
        hop::fence_regs(sc);
        hop::mbar_wait(&xfull[xb], (i >> 1) & 1);
        uint32_t xw[BLOCK_M / 8][4];
        load_words(xw, xbuf + xb * L::P_BYTES, tid);
#pragma unroll
        for (int e = 0; e < BLOCK_M / 2; ++e)
          sc[e] = __uint_as_float(xw[e / 4][e % 4]) *
                  (sc[e] - vec[(e / 4) * 8 + 2 * t + (e & 1)]);
        fat::pack_a<T, BLOCK_M>(fa, sc);
        const int d4 = i & (NB_DS - 1);
        if (i >= NB_DS)
          hop::mbar_wait(&xfree[d4], ((i >> 2) - 1) & 1);
        send_words(x_peer + d4 * L::DS_BYTES, fa, tid, xfull_peer + d4 * 8);
      };
      const int pairs = n_tiles / 2;
      for (int k = 0; k < pairs; ++k) {
        dscores(2 * k + wg);
        accumulate(2 * k);
        accumulate(2 * k + 1);
      }
      if (n_tiles & 1) {
        if (wg == 0) dscores(n_tiles - 1);
        accumulate(n_tiles - 1);
      }
    }

    if (slot < 0) {
      // (scale *) the accumulator into the consumer's columns of the K or V
      // tile, once both consumers' last score products (which read it) are
      // done, and by TMA to dK or dV
      hop::named_sync(5, 256);
      uint8_t* rows = smem + wg * (DH / BOX) * BLOCK_N * ROW;
      to_smem<T, DH, BLOCK_N>(rows, acc, rank == 0 ? scale : 1.f, warp, g,
                              t);
      hop::fence_async_smem();
      hop::named_sync(1 + wg, 128);
      if (tid == 0) {
#pragma unroll
        for (int c = 0; c < DH / BOX; ++c)
          hop::tma_store_4d(rank == 0 ? &dk_map : &dv_map,
                            rows + c * BLOCK_N * ROW, wg * DH + c * BOX, kvh,
                            n0, batch);
        hop::tma_store_wait();
      }
    } else {
      // the unit's fp32 partial (unscaled), 64 rows of d, into its slot
      float* out = ws + ((long long)(slot * 2 + rank) * BLOCK_N) * D + wg * DH;
#pragma unroll
      for (int nt = 0; nt < DH / 8; ++nt)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          *reinterpret_cast<float2*>(
              out + (warp * 16 + g + 8 * r) * D + nt * 8 + 2 * t) =
              make_float2(acc[4 * nt + 2 * r], acc[4 * nt + 2 * r + 1]);
    }
  }
  // neither CTA exits while the other may still store or arrive into it
  hop::cluster_sync();
}

// Each split key block's partials summed in slot (head-range) order, scaled
// (dK) and rounded once: block (x, y, z) is split block x (key block, then
// batch and kv head, as the units run; its slots x * ranges on), dK (y 0)
// or dV (y 1), key row z; 4 columns a thread.
template <typename T, int D>
__global__ void __launch_bounds__(D / 4)
dkv_wide_reduce_kernel(const float* __restrict__ ws, T* __restrict__ dk,
                       T* __restrict__ dv, int b, int sk, int hk, int ranges,
                       float scale) {
  const int x_blk = blockIdx.x;
  const int which = blockIdx.y, row = blockIdx.z;
  const int key = x_blk / (b * hk) * BLOCK_N + row;
  const int batch = x_blk / hk % b, kvh = x_blk % hk;
  if (key >= sk) return;
  const int c = threadIdx.x * 4;
  const float* src =
      ws + ((long long)(x_blk * ranges * 2 + which) * BLOCK_N + row) * D + c;
  float4 x = *reinterpret_cast<const float4*>(src);
  for (int j = 1; j < ranges; ++j) {
    const float4 y = *reinterpret_cast<const float4*>(
        src + (long long)j * 2 * BLOCK_N * D);
    x.x += y.x, x.y += y.y, x.z += y.z, x.w += y.w;
  }
  const float f = which == 0 ? scale : 1.f;
  T* dst = (which == 0 ? dk : dv) +
           (((long long)batch * sk + key) * hk + kvh) * D + c;
  *reinterpret_cast<uint2*>(dst) = make_uint2(
      fat::Mma<T>::pack(x.x * f, x.y * f), fat::Mma<T>::pack(x.z * f, x.w * f));
}

template <typename T, int D, bool CAP, bool SEG>
cudaError_t set_smem() {
  return cudaFuncSetAttribute(flash_bwd_dkv_wide_kernel<T, D, CAP, SEG>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              Smem<D, SEG>::BYTES);
}

template <typename T, int D, bool SEG>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* di, void* dk, void* dv, int b,
           int sq, int sk, int h, int hk, const long long* st, float scale,
           int left, int right, float cap_scale, float cap_log2,
           const fat::Seg& seg, int ranges, float* ws, cudaStream_t stream) {
  constexpr bool fp16 = std::is_same_v<T, __half>;
  const long long o_st[3] = {(long long)sk * hk * D, (long long)hk * D, D};
  CUtensorMap qm, km, vm, dm, dkm, dvm;
  int rc;
  if ((rc = hop::make_map_bshd(&qm, q, fp16, b, sq, h, D, st, BLOCK_M)) ||
      (rc = hop::make_map_bshd(&km, k, fp16, b, sk, hk, D, st + 3, BLOCK_N)) ||
      (rc = hop::make_map_bshd(&vm, v, fp16, b, sk, hk, D, st + 6, BLOCK_N)) ||
      (rc = hop::make_map_bshd(&dm, dout, fp16, b, sq, h, D, st + 9, BLOCK_M)) ||
      (rc = hop::make_map_bshd(&dkm, dk, fp16, b, sk, hk, D, o_st, BLOCK_N)) ||
      (rc = hop::make_map_bshd(&dvm, dv, fp16, b, sk, hk, D, o_st, BLOCK_N)))
    return rc;
  const bool cap = cap_scale != 0.f;
  auto kernel = cap ? flash_bwd_dkv_wide_kernel<T, D, true, SEG>
                    : flash_bwd_dkv_wide_kernel<T, D, false, SEG>;
  cudaError_t err = cap ? set_smem<T, D, true, SEG>()
                        : set_smem<T, D, false, SEG>();
  if (err != cudaSuccess) return static_cast<int>(err);
  // one cluster of two CTAs a unit: every key block of every (batch, kv
  // head), in `ranges` head ranges
  const int blocks = b * hk * ((sk + BLOCK_N - 1) / BLOCK_N);
  kernel<<<2 * blocks * ranges, NTHREADS, Smem<D, SEG>::BYTES, stream>>>(
      qm, km, vm, dm, dkm, dvm, lse, di, ws, b, sq, sk, h, h / hk, ranges,
      scale, scale * fat::LOG2E, fat::band_side(left), fat::band_side(right),
      cap_scale, cap_log2, seg);
  if ((err = cudaGetLastError()) != cudaSuccess || ranges == 1)
    return static_cast<int>(err);
  dkv_wide_reduce_kernel<T, D><<<dim3(blocks, 2, BLOCK_N), D / 4, 0, stream>>>(
      ws, static_cast<T*>(dk), static_cast<T*>(dv), b, sk, hk, ranges, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// fat_flash_bwd_dkv's interface (flash_bwd_dkv.cu) at d 384 and 512, with
// the head ranges each key block's group is cut into (ops/flash_bwd.py::
// dkv_wide_plan) and, where they are more than 1, the workspace of the
// units' partials (fp32, units x 2 x 64 x d; else null).
int fat_flash_bwd_dkv_wide(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse, const void* di,
                           void* dk, void* dv, int b, int sq, int sk, int h,
                           int hk, int d, const long long* strides,
                           float scale, int left, int right, float cap_scale,
                           float cap_log2, int is_fp16, const void* seg,
                           int ranges, void* ws, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dd = static_cast<const float*>(di);
  const fat::Seg sg = fat::seg_arg(seg);
  float* w = static_cast<float*>(ws);
#define FAT_DKV_LAUNCH(T, D)                                                 \
  return seg ? launch<T, D, true>(q, k, v, dout, l, dd, dk, dv, b, sq, sk,   \
                                  h, hk, strides, scale, left, right,        \
                                  cap_scale, cap_log2, sg, ranges, w, s)     \
             : launch<T, D, false>(q, k, v, dout, l, dd, dk, dv, b, sq, sk,  \
                                   h, hk, strides, scale, left, right,       \
                                   cap_scale, cap_log2, sg, ranges, w, s)
  if (d == 512 && !is_fp16) FAT_DKV_LAUNCH(__nv_bfloat16, 512);
  if (d == 512) FAT_DKV_LAUNCH(__half, 512);
  if (d == 384 && !is_fp16) FAT_DKV_LAUNCH(__nv_bfloat16, 384);
  if (d == 384) FAT_DKV_LAUNCH(__half, 384);
#undef FAT_DKV_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

// The segmented instance's tiles at head dim d: out[0] key rows a unit
// owns, out[1] query rows a streamed tile holds.
int fat_flash_bwd_dkv_wide_seg_tiles(int d, int* out) {
  if (d != 384 && d != 512) return static_cast<int>(cudaErrorInvalidValue);
  out[0] = BLOCK_N;
  out[1] = BLOCK_M;
  return 0;
}

// How many of the kernel's two-CTA clusters the current device holds at
// once at head dim d (out[0]), for the plan's balance report.
int fat_flash_bwd_dkv_wide_clusters(int d, int* out) {
  if (d != 384 && d != 512) return static_cast<int>(cudaErrorInvalidValue);
  const void* fn;
  int bytes;
  cudaError_t err;
  if (d == 512) {
    fn = reinterpret_cast<const void*>(
        flash_bwd_dkv_wide_kernel<__nv_bfloat16, 512, false, true>);
    bytes = Smem<512, true>::BYTES;
    err = set_smem<__nv_bfloat16, 512, false, true>();
  } else {
    fn = reinterpret_cast<const void*>(
        flash_bwd_dkv_wide_kernel<__nv_bfloat16, 384, false, true>);
    bytes = Smem<384, true>::BYTES;
    err = set_smem<__nv_bfloat16, 384, false, true>();
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 2;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(2, 1, 1);
  cfg.blockDim = dim3(NTHREADS, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaOccupancyMaxActiveClusters(out, fn, &cfg));
}

}  // extern "C"
