// Flash-attention backward, step 2 of 3: dQ, for Hopper (sm_90a) at head
// dims 384 and 512 where the band's left side is open (causal, or no band)
// and there is no softcap, hand-written CUDA C++: a pair of CTAs a query
// block. flash_bwd_dq_wide.cu takes the windows and the softcap, whose
// rows walk few tiles or whose P costs more than the pair saves (PERF.md,
// row 3).
//
// Replaces: flash_attention_tpu/ops/flash_bwd.py::_dq_kernel, its dense and
// its segmented pallas_call, at the head dims the JAX package pads d
// 257-512 to.
//
// Computes what flash_bwd_dq.cu computes (see there: S and P recomputed
// from the forward's LSE, dP = dO V^T, dS = P * (dP - D), dQ = scale dS K,
// the band, GQA, the segmented instance, dead rows).
//
// What bounds it on the H100: the tensor cores need 6 d FLOP a live score
// (Q K^T, dO V^T and dS K), but shared memory's bandwidth (128 bytes a
// clock an SM, shared by the TMA writes and every wgmma operand read) binds
// first: with Q and dO in shared memory as the chains' A operands, each
// 32-row kv tile re-reads both whole (64 KB each at d 512), 300 KB of
// traffic a tile in all, and a design of one CTA a query block ran at the
// time that traffic takes at about 70% of that bandwidth.
//
// What the design does about it:
// * A cluster of two CTAs a (batch, head, 64-row query block). CTA 0, the
//   S-CTA, keeps Q in registers (the A fragments of its 64 rows: 128 a
//   thread at d 512) and forms S = Q K^T and P; CTA 1, the dP-CTA, keeps dO
//   in registers and forms dP = dO V^T, which it sends to the S-CTA (fp32,
//   through distributed shared memory: st.async, completing its bytes on a
//   barrier of the receiver). The chains read only K or V from shared
//   memory, and the two run on two SMs at once.
// * Each CTA runs three warpgroups: a producer, the score warpgroup (S and P,
//   or dP) and the dQ warpgroup, which accumulates half of dQ's columns (n192
//   at d 384, n256 at d 512: 96 or 128 fp32 registers a thread) from dS and
//   its half of K's columns (MN-major: wgmma's transpose mode, no copy). The
//   S-CTA's score warpgroup hands P to its dQ warpgroup through shared memory
//   under named barriers; that warpgroup forms dS = P (dP - D), one k16 step
//   of A fragments at a time, rounded to the input type, and sends it to the
//   dP-CTA's. So each score warpgroup only issues its chain and hands its
//   result on (tools/probe_dq_pair.py: forming dS in the score warpgroup put
//   500-600 cycles a tile beside its chain of about 1,000). dQ is written
//   once, with no atomics: two runs are bit-identical.
// * The producers stream 32-row kv tiles through a ring (4 stages: at d 512
//   the last of them in the Q or dO tile, once both CTAs hold their
//   fragments in registers): the S-CTA's the lower half of K's columns, the
//   dP-CTA's V and the upper half of K's columns, that half by a multicast
//   TMA into both CTAs (hop::tma_load_4d_multicast); a stage is refilled
//   once every warpgroup reading it has released it (the dP-CTA's empty
//   barriers count the S-CTA's score warps too: its S chain reads the
//   multicast half). The Q tile also holds the S-CTA's two P hand-off
//   buffers, and the epilogue stages dQ there.
// * Each exchange buffer is freed by a remote arrival once its reader has
//   read it (as in flash_bwd_dkv_wide.cu), two buffers each way. (A chain
//   with its A operand in registers must not be in flight through code
//   that only some lanes run: ptxas then serialises every wgmma, C7518; so
//   each score chain is waited for before its result is handed on.)
// * dP is an m64n32 chain over the full d in k16 steps in order with dO as
//   the A operand, the products flash_bwd_di.cu sums D with at these head
//   dims (an A operand from registers gives the bits of one from shared
//   memory), so P * (dP - D) cancels to exactly 0 where a row attends to
//   one key; dS is formed once.
// * KV tiles wholly outside the band are never loaded and only tiles that
//   cross an edge are masked, as in flash_bwd_dq.cu; the segmented
//   instance (SEG) reads its tile range from ops/segments.py at this
//   kernel's tiles (fat_flash_bwd_dq_pair_seg_tiles: flash_bwd_dq_wide.cu's
//   too, so a launch can take either kernel), and a second producer warp of
//   the S-CTA copies each kv tile's ids and positions beside the stage.
// * Epilogue: each dQ warpgroup writes scale * its half of dQ into its
//   CTA's Q or dO tile in the swizzled layout and stores it with one TMA
//   store a 64-column box, which clips rows past sq.
//
// Left for later work: the m64n32 chains' tile width (64-row kv tiles
// would halve the exchange's share, but need D's and the dK/dV kernel's dP
// at N 64 too).

#include "flash_bwd_dq_common.cuh"
#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

constexpr int BLOCK_M = 64;    // query rows per cluster
constexpr int BLOCK_N = 32;    // kv rows per tile
constexpr int NTHREADS = 384;  // producer, score and dQ warpgroups
constexpr int BOX = 64;        // head-dim elements per TMA box (128 bytes)
constexpr int ROW = BOX * 2;   // bytes per box row
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;  // 128 * 24 + 256 * 240 <= 65536
// named barriers (0 is __syncthreads): READY and FREE of the S-CTA's two
// dS hand-off buffers, and the dQ warpgroup's own
constexpr int BAR_READY = 1, BAR_FREE = 3, BAR_DQ = 5;
// exchange buffers each way; a thread's share of one, in 16-byte words: dP
// in fp32 (4), dS as A fragments (2). Word c of thread tid lies at (c *
// 128 + tid) * 16.
constexpr int NB_X = 2;
constexpr int DP_WORDS = 4;
constexpr int DS_WORDS = 2;

template <int D, bool SEG>
struct Smem {
  static constexpr int T_BYTES = BLOCK_M * D * 2;   // Q or dO at 0
  static constexpr int H_BYTES = BLOCK_N * D;       // half a K tile's columns
  // a stage: K's upper column half (multicast, in both CTAs) at 0, then
  // K's lower half (S-CTA) or V (dP-CTA)
  static constexpr int STAGE_BYTES = 3 * H_BYTES;
  static constexpr int RING_OFF = T_BYTES;
  static constexpr int XP_BYTES = DP_WORDS * 128 * 16;  // fp32 P or dP
  static constexpr int XD_BYTES = DS_WORDS * 128 * 16;  // dS, A fragments
  // the ring: RING_STAGES after the Q or dO tile and, where that tile has
  // room for one beside the S-CTA's two P hand-off buffers (d 512), one
  // more in it once both CTAs' fragments are in registers (stage
  // STAGES - 1)
  static constexpr int RING_STAGES = D == 384 ? 4 : 3;
  static constexpr int T_STAGE =
      T_BYTES >= STAGE_BYTES + NB_X * XP_BYTES ? 1 : 0;
  static constexpr int STAGES = RING_STAGES + T_STAGE;
  static constexpr int HANDOFF_OFF = T_STAGE ? STAGE_BYTES : 0;
  // the exchange buffers this CTA receives into (the S-CTA's dP, the
  // dP-CTA's dS), at the same offset in both CTAs
  static constexpr int X_OFF = RING_OFF + RING_STAGES * STAGE_BYTES;
  static constexpr int META_OFF = X_OFF + NB_X * XP_BYTES;
  // SEG: each stage's kv ids, positions and their fat::SegSpan (int32)
  static constexpr int META_INTS = 2 * BLOCK_N + 4;
  static constexpr int BAR_OFF = META_OFF + (SEG ? STAGES * META_INTS * 4 : 0);
  // q or do full, free; stage full, empty; exchange full, free
  static constexpr int N_BARS = 2 + 2 * STAGES + 2 * NB_X;
  // slack to align the tiles to 1024 bytes, the swizzle's period
  static constexpr int BYTES = BAR_OFF + N_BARS * 8 + 1024;
  static_assert(H_BYTES % 1024 == 0, "stages keep the swizzle's alignment");
  static_assert(HANDOFF_OFF + NB_X * XP_BYTES <= T_BYTES,
                "the hand-off buffers in the Q tile");
  static_assert(BYTES <= 232448, "over the CTA's shared memory");
  // stage s's offset
  static __device__ __forceinline__ int stage(int s) {
    return s < RING_STAGES ? RING_OFF + s * STAGE_BYTES : 0;
  }
};

// S or dP = A B^T over d, k16 steps in order, A (Q or dO) in registers and
// B K-major in shared memory: the tile's boxes below `lo_boxes` at `lo`,
// the rest at `hi` (the S-CTA's K: its lower column half after the
// multicast upper one), all of them at `lo` when lo_boxes is the whole d.
// Issued and committed, not waited for.
template <typename T, int D>
__device__ __forceinline__ void rs_scores(float (&sc)[BLOCK_N / 2],
                                          const uint32_t (&a)[D / 16][4],
                                          uint32_t lo, int lo_boxes,
                                          uint32_t hi) {
#pragma unroll
  for (int i = 0; i < BLOCK_N / 2; ++i) sc[i] = 0.f;  // rs always accumulates
  hop::fence_regs(sc);
  hop::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int box = kk / 4;
    const uint32_t b = box < lo_boxes ? lo + box * BLOCK_N * ROW
                                      : hi + (box - lo_boxes) * BLOCK_N * ROW;
    hop::WgmmaRs<T, BLOCK_N>::rs(
        sc, a[kk], hop::desc_sw128(b + (kk % 4) * 32, 16, 1024));
  }
  hop::wgmma_commit();
}

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
__device__ __forceinline__ void store_words(uint8_t* buf,
                                            const uint32_t (&a)[N][4],
                                            int tid) {
#pragma unroll
  for (int c = 0; c < N; ++c)
    *reinterpret_cast<uint4*>(buf + (c * 128 + tid) * 16) =
        make_uint4(a[c][0], a[c][1], a[c][2], a[c][3]);
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

template <typename T, int D, bool SEG>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(NTHREADS, 1)
flash_bwd_dq_pair_kernel(const __grid_constant__ CUtensorMap q_map,
                         const __grid_constant__ CUtensorMap k_map,
                         const __grid_constant__ CUtensorMap v_map,
                         const __grid_constant__ CUtensorMap do_map,
                         const __grid_constant__ CUtensorMap dq_map,
                         const float* __restrict__ lse,
                         const float* __restrict__ di, int sq, int sk, int h,
                         int group, float scale, float scale_log2, int left,
                         int right, const fat::Seg seg) {
  using L = Smem<D, SEG>;
  constexpr int STAGES = L::STAGES;
  constexpr int DH = D / 2;      // dQ columns a CTA owns
  constexpr int HALF = DH / BOX;  // boxes of a column half
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (hop::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* t_full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* t_free = t_full + 1;  // both score warpgroups hold their tile
  uint64_t* full = t_full + 2;
  uint64_t* empty = full + STAGES;
  uint64_t* xfull = empty + STAGES;  // this CTA's exchange buffer arrived
  uint64_t* xfree = xfull + NB_X;    // the peer's buffer is free again

  const int rank = static_cast<int>(hop::cluster_ctarank());  // 0 S, 1 dP
  // longest causal rows first: the last query block has the most kv tiles
  const int m_block = gridDim.z - 1 - blockIdx.z;
  const int head = blockIdx.x >> 1;
  const int batch = blockIdx.y;
  const int m_lo = m_block * BLOCK_M;
  const int off = sk - sq;  // lower-right offset of the band
  // kv tiles t_begin + j, j < n_tiles: from the tile holding the first
  // row's left edge to the last row's right edge (rows past sq clamped:
  // they are never stored), or with SEG the range of ops/segments.py; both
  // CTAs count the same tiles
  int n_end = sk;
  if (right < fat::UNBOUNDED)
    n_end = min(sk, min(m_lo + BLOCK_M, sq) + off + right);
  int seg_lo = 0, seg_n = 0;
  if constexpr (SEG) {
    const int blk = batch * gridDim.z + m_block;
    seg_lo = seg.lo[blk];
    seg_n = max(0, seg.hi[blk] - seg_lo + 1);
  }
  const int t_begin =
      SEG ? seg_lo
          : (left < fat::UNBOUNDED ? max(0, m_lo + off - left) / BLOCK_N : 0);
  const int n_tiles =
      SEG ? seg_n
          : (n_end > t_begin * BLOCK_N ? (n_end + BLOCK_N - 1) / BLOCK_N - t_begin
                                       : 0);

  const int role = __shfl_sync(0xffffffff, threadIdx.x / 128, 0);
  if (threadIdx.x == 0) {
    hop::mbar_init(t_full, 1);
    hop::mbar_init(t_free, 8);  // both CTAs' score warps
    for (int s = 0; s < STAGES; ++s) {
      // the TMA thread, and with SEG the S-CTA's metadata warp
      hop::mbar_init(&full[s], SEG && rank == 0 ? 1 + 32 : 1);
      // the score and dQ warpgroups' warps; the dP-CTA multicasts K's upper
      // half into both CTAs, so the S-CTA's score warps release its stages
      // too
      hop::mbar_init(&empty[s], rank == 0 ? 8 : 12);
    }
    for (int x = 0; x < NB_X; ++x) {
      hop::mbar_init(&xfull[x], 1);  // armed here, filled by the peer
      hop::mbar_init(&xfree[x], 4);  // the peer's reading warps
    }
    hop::mbar_fence_init();
    for (int x = 0; x < NB_X; ++x)
      hop::mbar_expect_tx(&xfull[x], rank == 0 ? L::XP_BYTES : L::XD_BYTES);
  }
  // both CTAs' barriers are ready before either loads or stores into the
  // other
  hop::cluster_sync();

  const uint32_t x_peer = hop::mapa(hop::smem_u32(smem + L::X_OFF), rank ^ 1);
  const uint32_t xfull_peer = hop::mapa(hop::smem_u32(xfull), rank ^ 1);
  const uint32_t xfree_peer = hop::mapa(hop::smem_u32(xfree), rank ^ 1);
  const uint32_t base = hop::smem_u32(smem);
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group

  if (role == 0) {
    // ---- producer ----
    hop::setmaxnreg_dec<PRODUCER_REGS>();
    const int kvh = head / group;
    if (threadIdx.x == 0) {
      const CUtensorMap* tm = rank == 0 ? &q_map : &do_map;
      hop::prefetch_map(tm);
      hop::prefetch_map(&k_map);
      if (rank == 1) hop::prefetch_map(&v_map);
      hop::mbar_expect_tx(t_full, L::T_BYTES);
#pragma unroll
      for (int c = 0; c < D / BOX; ++c)
        hop::tma_load_4d(smem + c * BLOCK_M * ROW, tm, t_full, c * BOX, head,
                         m_lo, batch);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        const int n0 = (t_begin + j) * BLOCK_N;
        uint8_t* st = smem + L::stage(s);
        // the last stage is the Q or dO tile, in both CTAs (the multicast
        // half of K lands in the peer's)
        if (L::T_STAGE && j == STAGES - 1) hop::mbar_wait(t_free, 0);
        if (j >= STAGES) hop::mbar_wait(&empty[s], (j / STAGES - 1) & 1);
        if (rank == 0) {
          // K's lower half here; its upper half comes from the dP-CTA
          hop::mbar_expect_tx(&full[s], 2 * L::H_BYTES);
          for (int c = 0; c < HALF; ++c)
            hop::tma_load_4d(st + L::H_BYTES + c * BLOCK_N * ROW, &k_map,
                             &full[s], c * BOX, kvh, n0, batch);
        } else {
          hop::mbar_expect_tx(&full[s], 3 * L::H_BYTES);
          for (int c = 0; c < HALF; ++c)
            hop::tma_load_4d_multicast(st + c * BLOCK_N * ROW, &k_map,
                                       &full[s], (HALF + c) * BOX, kvh, n0,
                                       batch, 0x3);
          for (int c = 0; c < D / BOX; ++c)
            hop::tma_load_4d(st + L::H_BYTES + c * BLOCK_N * ROW, &v_map,
                             &full[s], c * BOX, kvh, n0, batch);
        }
      }
    } else if (SEG && rank == 0 && warp == 1) {
      // each kv tile's ids, positions and span beside its stage, read from
      // global memory a tile ahead of the stage's release
      constexpr int PER = BLOCK_N / 32;
      const int* kv_seg = seg.kv_seg + (long long)batch * sk;
      const int* kv_pos = seg.kv_pos + (long long)batch * sk;
      int ids[PER], pss[PER];
      if (n_tiles > 0)
        fat::seg_fetch(kv_seg, kv_pos, t_begin * BLOCK_N, sk,
                       fat::KV_PAD_SEG, lane, ids, pss);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        const fat::SegSpan span = fat::seg_span_of(ids, pss);
        if (j >= STAGES) hop::mbar_wait(&empty[s], (j / STAGES - 1) & 1);
        fat::seg_store(reinterpret_cast<int*>(smem + L::META_OFF) +
                           s * L::META_INTS,
                       ids, pss, span, lane);
        hop::mbar_arrive(&full[s]);
        if (j + 1 < n_tiles)
          fat::seg_fetch(kv_seg, kv_pos, (t_begin + j + 1) * BLOCK_N, sk,
                         fat::KV_PAD_SEG, lane, ids, pss);
      }
    }
  } else if (role == 1) {
    // ---- the score warpgroup: Q (S-CTA) or dO (dP-CTA) in registers ----
    hop::setmaxnreg_inc<CONSUMER_REGS>();
    const int w0 = m_lo + warp * 16;  // this warp's first row
    uint32_t a[D / 16][4];
    hop::mbar_wait(t_full, 0);
    hop::load_a_tile<D>(a, smem, warp, g, t);
    hop::fence_regs(a);  // read before the tile becomes a stage
    __syncwarp();
    if (lane == 0) {
      hop::mbar_arrive(t_free);
      hop::mbar_arrive_remote(hop::mapa(hop::smem_u32(t_free), rank ^ 1));
    }
    float sc[BLOCK_N / 2];  // S then P (S-CTA), or dP (dP-CTA)
    if (rank == 0) {
      Rows rw{{w0 + g, w0 + g + 8}, w0, t, sk, off, left, right, scale_log2,
              0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const long long idx = ((long long)batch * h + head) * sq + rw.row[r];
        // a row past sq is never stored: P = 0 keeps it finite
        rw.lse2[r] = rw.row[r] < sq ? lse[idx] * fat::LOG2E : CUDART_INF_F;
      }
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
      const uint32_t empty_peer = hop::mapa(hop::smem_u32(empty), 1);
      // S(j) into `out`: K's lower half after the multicast upper one
      auto scores = [&](float (&out)[BLOCK_N / 2], int j) {
        const int s = j % STAGES;
        hop::mbar_wait(&full[s], (j / STAGES) & 1);
        const uint32_t st = base + L::stage(s);
        rs_scores<T, D>(out, a, st + L::H_BYTES, HALF, st);
      };
      // tile j, its S in sc: P, masked, in fp32 to this CTA's dQ
      // warpgroup, which forms dS
      auto probs_j = [&](int j) {
        const int s = j % STAGES, xb = j & 1;
        hop::fence_regs(sc);
        // the S chain is done with the stage (with SEG, once its ids are
        // read too)
        if (!SEG && lane == 0) {
          hop::mbar_arrive(&empty[s]);
          hop::mbar_arrive_remote(empty_peer + s * 8);
        }
        const int* meta = reinterpret_cast<const int*>(smem + L::META_OFF) +
                          s * L::META_INTS;
        const int n0 = (t_begin + j) * BLOCK_N;
        probs<SEG, BLOCK_N>(sc, n0, rw, sr, meta);
        if (SEG) {
          __syncwarp();  // every lane has read the stage's ids
          if (lane == 0) {
            hop::mbar_arrive(&empty[s]);
            hop::mbar_arrive_remote(empty_peer + s * 8);
          }
        }
        uint32_t xw[DP_WORDS][4];
#pragma unroll
        for (int e = 0; e < BLOCK_N / 2; ++e)
          xw[e / 4][e % 4] = __float_as_uint(sc[e]);
        // buffer xb was last read by this CTA's dQ warpgroup for P(j - 2)
        if (j >= NB_X) hop::named_sync(BAR_FREE + xb, 256);
        store_words(smem + L::HANDOFF_OFF + xb * L::XP_BYTES, xw, tid);
        hop::named_arrive(BAR_READY + xb, 256);
      };
      for (int j = 0; j < n_tiles; ++j) {
        scores(sc, j);
        hop::wgmma_wait<0>();
        probs_j(j);
      }
      // the dQ warpgroup's releases of the last two buffers
      for (int j = max(0, n_tiles - NB_X); j < n_tiles; ++j)
        hop::named_sync(BAR_FREE + (j & 1), 256);
    } else {
      // dP(j) into `out`: V after the stage's multicast half of K
      auto dpc = [&](float (&out)[BLOCK_N / 2], int j) {
        const int s = j % STAGES;
        hop::mbar_wait(&full[s], (j / STAGES) & 1);
        const uint32_t v = base + L::stage(s) + L::H_BYTES;
        rs_scores<T, D>(out, a, v, D / BOX, v);
      };
      // tile j, its dP in sc: V is free, and dP goes to the S-CTA's buffer
      // j % 2 once it has read dP(j - 2) from there
      auto send_dp = [&](int j) {
        const int xb = j & 1;
        hop::fence_regs(sc);
        __syncwarp();
        if (lane == 0) hop::mbar_arrive(&empty[j % STAGES]);
        uint32_t dpw[DP_WORDS][4];
#pragma unroll
        for (int e = 0; e < BLOCK_N / 2; ++e)
          dpw[e / 4][e % 4] = __float_as_uint(sc[e]);
        if (j >= NB_X) hop::mbar_wait(&xfree[xb], ((j >> 1) - 1) & 1);
        send_words(x_peer + xb * L::XP_BYTES, dpw, tid, xfull_peer + xb * 8);
      };
      for (int j = 0; j < n_tiles; ++j) {
        dpc(sc, j);
        hop::wgmma_wait<0>();
        send_dp(j);
      }
    }
  } else {
    // ---- the dQ warpgroup: half of dQ's columns ----
    hop::setmaxnreg_inc<CONSUMER_REGS>();
    float acc[DH / 2];  // this CTA's half of dQ, unscaled
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
    // the S-CTA's rows' D
    float dr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = m_lo + warp * 16 + g + 8 * r;
      dr[r] = rank == 0 && row < sq
                  ? di[((long long)batch * h + head) * sq + row]
                  : 0.f;
    }
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % STAGES, xb = j & 1;
      uint32_t fa[BLOCK_N / 16][4];
      if (rank == 0) {
        // dS(j) = P(j) (dP(j) - D), one k16 step of A fragments at a time,
        // from this CTA's P and the dP-CTA's dP; rounded, to the dP-CTA too
        const uint8_t* xp = smem + L::HANDOFF_OFF + xb * L::XP_BYTES;
        const uint8_t* dpb = smem + L::X_OFF + xb * L::XP_BYTES;
        hop::named_sync(BAR_READY + xb, 256);
        hop::mbar_wait(&xfull[xb], (j >> 1) & 1);
#pragma unroll
        for (int kk = 0; kk < BLOCK_N / 16; ++kk) {
          uint32_t pw[2][4], dw[2][4];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const uint4 p4 = *reinterpret_cast<const uint4*>(
                xp + ((2 * kk + c) * 128 + tid) * 16);
            const uint4 d4 = *reinterpret_cast<const uint4*>(
                dpb + ((2 * kk + c) * 128 + tid) * 16);
            pw[c][0] = p4.x, pw[c][1] = p4.y, pw[c][2] = p4.z, pw[c][3] = p4.w;
            dw[c][0] = d4.x, dw[c][1] = d4.y, dw[c][2] = d4.z, dw[c][3] = d4.w;
          }
          float ds[8];
#pragma unroll
          for (int e = 0; e < 8; ++e)
            ds[e] = __uint_as_float(pw[e / 4][e % 4]) *
                    (__uint_as_float(dw[e / 4][e % 4]) - dr[(e >> 1) & 1]);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            fa[kk][e] = fat::Mma<T>::pack(ds[2 * e], ds[2 * e + 1]);
        }
        hop::fence_regs(fa);  // both buffers are read before they free
        hop::named_arrive(BAR_FREE + xb, 256);
        // arm the dP buffer's next phase before the peer may fill it
        if (tid == 0) hop::mbar_expect_tx(&xfull[xb], L::XP_BYTES);
        __syncwarp();
        if (lane == 0) hop::mbar_arrive_remote(xfree_peer + xb * 8);
        if (j >= NB_X) hop::mbar_wait(&xfree[xb], ((j >> 1) - 1) & 1);
        send_words(x_peer + xb * L::XD_BYTES, fa, tid, xfull_peer + xb * 8);
      } else {
        hop::mbar_wait(&xfull[xb], (j >> 1) & 1);
        load_words(fa, smem + L::X_OFF + xb * L::XD_BYTES, tid);
        if (tid == 0) hop::mbar_expect_tx(&xfull[xb], L::XD_BYTES);
      }
      hop::mbar_wait(&full[s], (j / STAGES) & 1);
      // this CTA's column half of K: the S-CTA's the lower (after the
      // multicast upper one), the dP-CTA's the upper (at the stage's start)
      const uint32_t st = base + L::stage(s);
      hop::rs_chain<T, DH, BLOCK_N / 16>(
          acc, fa, rank == 0 ? st + L::H_BYTES : st, BLOCK_N);
      hop::wgmma_commit();
      hop::wgmma_wait<0>();
      hop::fence_regs(acc);
      hop::fence_regs(fa);
      __syncwarp();  // every lane's product has read the stage and buffer
      if (lane == 0) {
        hop::mbar_arrive(&empty[s]);
        if (rank == 1) hop::mbar_arrive_remote(xfree_peer + xb * 8);
      }
    }
    // epilogue: scale * this half of dQ into the CTA's Q or dO tile (its
    // load has landed, its fragments were read into registers before the
    // first chain, and the last dS hand-off has been taken), in the
    // swizzled layout the dQ map stores from
    hop::mbar_wait(t_full, 0);
#pragma unroll
    for (int nt = 0; nt < DH / 8; ++nt) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = warp * 16 + g + 8 * r;
        const int chunk = (nt % 8) ^ (row & 7);
        *reinterpret_cast<uint32_t*>(smem + (nt / 8) * BLOCK_M * ROW +
                                     row * ROW + chunk * 16 + t * 4) =
            fat::Mma<T>::pack(acc[4 * nt + 2 * r] * scale,
                              acc[4 * nt + 2 * r + 1] * scale);
      }
    }
    hop::fence_async_smem();
    hop::named_sync(BAR_DQ, 128);
    if (tid == 0) {
#pragma unroll
      for (int c = 0; c < HALF; ++c)
        hop::tma_store_4d(&dq_map, smem + c * BLOCK_M * ROW,
                          rank * DH + c * BOX, head, m_lo, batch);
      hop::tma_store_wait();
    }
  }
  // neither CTA exits while the other may still store or arrive into it
  hop::cluster_sync();
}

template <typename T, int D, bool SEG>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* di, void* dq, int b, int sq, int sk,
           int h, int hk, const long long* st, float scale, int right,
           const fat::Seg& seg, cudaStream_t stream) {
  constexpr bool fp16 = std::is_same_v<T, __half>;
  const long long dq_st[3] = {(long long)sq * h * D, (long long)h * D, D};
  CUtensorMap qm, km, vm, dm, dqm;
  int rc;
  if ((rc = hop::make_map_bshd(&qm, q, fp16, b, sq, h, D, st, BLOCK_M)) ||
      (rc = hop::make_map_bshd(&km, k, fp16, b, sk, hk, D, st + 3, BLOCK_N)) ||
      (rc = hop::make_map_bshd(&vm, v, fp16, b, sk, hk, D, st + 6, BLOCK_N)) ||
      (rc = hop::make_map_bshd(&dm, dout, fp16, b, sq, h, D, st + 9, BLOCK_M)) ||
      (rc = hop::make_map_bshd(&dqm, dq, fp16, b, sq, h, D, dq_st, BLOCK_M)))
    return rc;
  auto kernel = flash_bwd_dq_pair_kernel<T, D, SEG>;
  constexpr int bytes = Smem<D, SEG>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  // one cluster of two CTAs a (head, batch, query block)
  dim3 grid(2 * h, b, (sq + BLOCK_M - 1) / BLOCK_M);
  kernel<<<grid, NTHREADS, bytes, stream>>>(
      qm, km, vm, dm, dqm, lse, di, sq, sk, h, h / hk, scale,
      scale * fat::LOG2E, fat::UNBOUNDED, fat::band_side(right), seg);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// fat_flash_bwd_dq's interface (flash_bwd_dq.cu) at d 384 and 512, for a
// band whose left side is open (left < 0) and no softcap (cap_scale 0):
// anything else is refused, as ops/flash_bwd.py routes it to
// fat_flash_bwd_dq_wide.
int fat_flash_bwd_dq_pair(const void* q, const void* k, const void* v,
                          const void* dout, const void* lse, const void* di,
                          void* dq, int b, int sq, int sk, int h, int hk,
                          int d, const long long* strides, float scale,
                          int left, int right, float cap_scale, float,
                          int is_fp16, const void* seg, void* stream) {
  if (left >= 0 || cap_scale != 0.f)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dd = static_cast<const float*>(di);
  const fat::Seg sg = fat::seg_arg(seg);
#define FAT_DQ_LAUNCH(T, D)                                                  \
  return seg ? launch<T, D, true>(q, k, v, dout, l, dd, dq, b, sq, sk, h, hk, \
                                  strides, scale, right, sg, s)               \
             : launch<T, D, false>(q, k, v, dout, l, dd, dq, b, sq, sk, h,    \
                                   hk, strides, scale, right, sg, s)
  if (d == 512 && !is_fp16) FAT_DQ_LAUNCH(__nv_bfloat16, 512);
  if (d == 512) FAT_DQ_LAUNCH(__half, 512);
  if (d == 384 && !is_fp16) FAT_DQ_LAUNCH(__nv_bfloat16, 384);
  if (d == 384) FAT_DQ_LAUNCH(__half, 384);
#undef FAT_DQ_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

// The segmented instance's tiles at head dim d: out[0] query rows a
// cluster owns, out[1] kv rows a streamed tile holds (those of
// flash_bwd_dq_wide.cu).
int fat_flash_bwd_dq_pair_seg_tiles(int d, int* out) {
  if (d != 384 && d != 512) return static_cast<int>(cudaErrorInvalidValue);
  out[0] = BLOCK_M;
  out[1] = BLOCK_N;
  return 0;
}

}  // extern "C"
