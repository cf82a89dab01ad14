// Flash-attention forward for Hopper (sm_90a) at head dims 384 and 512,
// hand-written CUDA C++.
//
// Replaces: flash_attention_tpu/ops/flash_fwd.py::_fwd_kernel (the Pallas
// TPU kernel launched by flash_fwd), its dense and its segmented
// pallas_call, at the head dims the JAX package pads d 257-512 to.
//
// Computes what flash_fwd.cu computes (see there: the band, the softcap,
// GQA, the segmented instance, dead rows, LSE), at d 384 and 512, whose
// tiles do not fit that kernel's design: a consumer warpgroup there owns 64
// query rows and the whole of O in registers, which at d 512 alone is 64 x
// 512 fp32 / 128 threads = 256 registers a thread, and its 128-row Q tile
// and one 64-row stage of K and V would take 256 KB of shared memory.
//
// What bounds it on the H100: shared memory's bandwidth, before the tensor
// cores (4 d FLOP a score). A 64 x 64 tile at d 512 writes K and V into
// shared memory (128 KB), and its products read them (128 KB) and Q (64
// KB: S's A operand, read anew for each tile) and P (16 KB): about 344 KB a
// tile against the SM's 128 bytes a clock, about 1.6 us at 1.755 GHz, where
// the products alone take about 1.2 (tools/probe_wgmma.py: an m64n64k16
// chain from shared memory runs at the tensor cores' rate only when it has
// the bandwidth to itself). Q cannot move into registers: 128 a thread at
// d 512 beside the 128 of O's half a consumer holds.
//
// What the design does about it (FlashMLA's split of O by columns):
// * A CTA owns 64 query rows of one head and runs three warpgroups.
//   Warpgroup 0, the producer, gives its registers away (setmaxnreg); one
//   thread loads Q once and streams the 64-row K tiles, two more the two
//   column halves of each V tile (one for each consumer), by TMA, each slot
//   with its own full and empty mbarrier. Shared memory at d 512: Q 64 KB,
//   K 64 KB, V 64 KB, two P buffers 16 KB.
// * Where the band's left side is open, heads run fastest in the grid, so
//   the CTAs on the card at once are the heads of a few query blocks,
//   streaming the same K/V tiles from L2; under a window query blocks run
//   fastest, as in flash_fwd.cu.
// * Consumer 0 computes S = Q K^T (m64n64, k over d; both K-major in shared
//   memory) and the online softmax once, for all 64 rows (the softmax of
//   flash_fwd_common.cuh), then writes P, rounded to the input type, and
//   each row's rescale factor alpha into one of two P buffers in shared
//   memory. Where the band's left side is open (causal, or no band: rows of
//   many tiles) it issues S(j + 1) before its half of P(j) V(j) and runs
//   the softmax of tile j + 1 while that product runs (FA3's overlap within
//   a warpgroup; P(j) is already in shared memory, so no second score
//   register set is needed); under a window (a few tiles a row) it takes
//   each tile in turn, so that P(j) V(j) runs while K(j + 1) loads.
// * The two consumers each own half of O's columns: n192 at d 384, n256 at
//   d 512, 96 or 128 fp32 registers a thread. Each rescales its half by
//   alpha and issues O_half += P V_half with both operands in shared memory
//   (P K-major, V MN-major: wgmma's transpose mode, no copy).
// * Hand-off by named barriers: consumer 0 arrives on READY(buf) when P(j)
//   and alpha(j) are in buffer j % 2; consumer 1 waits on it, and arrives on
//   FREE(buf) once its product has read the buffer, which consumer 0 waits
//   for before it writes P(j + 2) there.
// * KV tiles wholly outside the band are never loaded, and only tiles that
//   cross an edge of the band (or sk) are masked, one warp's 16 rows at a
//   time, as in flash_fwd.cu. The segmented instance (SEG) reads its tile
//   range from ops/segments.py at this kernel's tiles
//   (fat_flash_fwd_wide_seg_tiles) and a second producer warp copies each kv
//   tile's ids and positions into the K slot's metadata.
// * Epilogue: consumer 0 writes each row's LSE and 1 / l into shared memory;
//   each consumer writes its half of O into the Q tile (no longer read) in
//   the swizzled layout and stores it with one TMA store a 64-column box.
//
// Exactness as in flash_fwd.cu: scores are rounded in the log2 domain
// before the max is subtracted, so a row with one live key gets O equal to
// that V row bit for bit. Both orders run the same chains and softmax on
// the same values, so O and LSE do not depend on the instance.
//
// Tried and not kept (PERF.md, row 1): clusters of 2 and 4 CTAs on heads of
// one kv head sharing each K/V tile by multicast loads (the L2's bytes a
// CTA halved or quartered: slower on every row), the K slot released in
// four parts, and S with Q in registers in a warpgroup of its own (512
// threads leave 128 registers a thread, fewer than the m64n256
// accumulator's wgmma needs).

#include "flash_common.cuh"
#include "flash_fwd_common.cuh"
#include "hopper_common.cuh"

namespace {

constexpr int BLOCK_M = 64;    // query rows per CTA
constexpr int BLOCK_N = 64;    // kv rows per tile
constexpr int NTHREADS = 384;  // producer + 2 consumer warpgroups
constexpr int BOX = 64;        // head-dim elements per TMA box (128 bytes)
constexpr int ROW = BOX * 2;   // bytes per box row
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;  // 128 * 40 + 256 * 232 <= 65536
// named barriers (0 is __syncthreads): consumer 0's own, then READY and
// FREE of the two P buffers, the epilogue's, and consumer 1's own
constexpr int BAR_C0 = 1, BAR_READY = 2, BAR_FREE = 4, BAR_EPI = 6,
              BAR_C1 = 7;

template <int D, bool SEG = false>
struct Smem {
  static constexpr int Q_BYTES = BLOCK_M * D * 2;
  static constexpr int KV_BYTES = BLOCK_N * D * 2;
  static constexpr int P_BYTES = BLOCK_M * BLOCK_N * 2;  // one 64-column box
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + KV_BYTES;
  static constexpr int P_OFF = V_OFF + KV_BYTES;       // two P buffers
  static constexpr int ALPHA_OFF = P_OFF + 2 * P_BYTES;  // [2][BLOCK_M] fp32
  static constexpr int INV_OFF = ALPHA_OFF + 2 * BLOCK_M * 4;  // [BLOCK_M]
  static constexpr int BAR_OFF = INV_OFF + BLOCK_M * 4;
  // q; k full; v full (each column half); k empty; v empty (each half)
  static constexpr int N_BARS = 7;
  // SEG: the K slot's kv ids, positions and their fat::SegSpan (int32)
  static constexpr int META_OFF = BAR_OFF + N_BARS * 8;
  static constexpr int META_INTS = SEG ? 2 * BLOCK_N + 4 : 0;
  // slack to align the tiles to 1024 bytes, the swizzle's period
  static constexpr int BYTES = META_OFF + META_INTS * 4 + 1024;
  static_assert(BYTES <= 232448, "over the CTA's shared memory");
};

// S = Q K^T for the CTA's 64 rows, both K-major in shared memory: one wgmma
// chain over d, committed and not waited for.
template <typename T, int D>
__device__ __forceinline__ void issue_qk(float (&sc)[BLOCK_N / 2], uint32_t q_s,
                                         uint32_t k_s) {
  hop::fence_regs(sc);
  hop::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t kb = (kk / 4) * ROW, ko = (kk % 4) * 32;
    hop::Wgmma<T, BLOCK_N>::ss(
        sc, hop::desc_sw128(q_s + kb * BLOCK_M + ko, 16, 1024),
        hop::desc_sw128(k_s + kb * BLOCK_N + ko, 16, 1024), kk > 0);
  }
  hop::wgmma_commit();
}

// O_half = alpha O_half + P V_half: P (64 x 64, K-major) and the consumer's
// DH columns of V (MN-major) in shared memory; one wgmma chain, committed
// and not waited for.
template <typename T, int DH>
__device__ __forceinline__ void issue_pv(float (&acc)[DH / 2],
                                         const float (&alpha)[2], uint32_t p_s,
                                         uint32_t v_half) {
  if (__any_sync(0xffffffff, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
  }
  hop::fence_regs(acc);  // the rescale stays before the fence
  hop::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BLOCK_N / 16; ++kk)
    hop::WgmmaSs<T, DH, 0, 1>::ss(
        acc, hop::desc_sw128(p_s + kk * 32, 16, 1024),
        hop::desc_sw128(v_half + kk * 16 * ROW, BLOCK_N * ROW, 1024), 1);
  hop::wgmma_commit();
}

// P, rounded to T, into a 64 x 64 buffer in the 128-byte swizzle a K-major
// wgmma operand reads (row r's 16-byte chunk k at r * 128 + (k ^ r % 8) *
// 16): thread (warp, g, t) holds rows 16 warp + g and + 8.
template <typename T>
__device__ __forceinline__ void store_p(uint8_t* p, const float (&sc)[BLOCK_N / 2],
                                        int warp, int g, int t) {
#pragma unroll
  for (int nt = 0; nt < BLOCK_N / 8; ++nt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = warp * 16 + g + 8 * r;
      *reinterpret_cast<uint32_t*>(p + row * ROW + ((nt ^ (row & 7)) * 16) +
                                   t * 4) =
          fat::Mma<T>::pack(sc[4 * nt + 2 * r], sc[4 * nt + 2 * r + 1]);
    }
}

template <typename T, int D, bool CAP, bool SEG>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_fwd_wide_kernel(const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map,
                      const __grid_constant__ CUtensorMap o_map,
                      float* __restrict__ lse, int sq, int sk, int h, int group,
                      float scale_log2, int left, int right, float cap_scale,
                      float cap_log2, float empty_lse, const fat::Seg seg) {
  using L = Smem<D, SEG>;
  constexpr int DH = D / 2;   // O columns a consumer owns
  constexpr int NB = D / BOX;  // boxes of a K or V tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (hop::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = q_full + 2;  // [2]
  uint64_t* k_empty = q_full + 4;
  uint64_t* v_empty = q_full + 5;  // [2]

  // where the band's left side is open (rows of many tiles) heads run
  // fastest, so the CTAs on the card at once share K/V tiles; under a
  // window query blocks do. Either way they run longest causal rows first
  // (the last block has the most tiles)
  const bool open = left >= fat::UNBOUNDED;
  const int head = open ? blockIdx.x : blockIdx.y;
  const int n_m = open ? gridDim.y : gridDim.x;  // query blocks
  const int m_block = n_m - 1 - (open ? blockIdx.y : blockIdx.x);
  const int batch = blockIdx.z;
  const int m_lo = m_block * BLOCK_M;
  const int off = sk - sq;  // lower-right offset of the band
  // kv tiles t_begin + j, j < n_tiles, as in flash_fwd.cu
  int n_end = sk;
  if (right < fat::UNBOUNDED)
    n_end = min(sk, min(m_lo + BLOCK_M, sq) + off + right);
  int seg_lo = 0, seg_n = 0;
  if constexpr (SEG) {
    const int blk = batch * n_m + m_block;
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
    hop::mbar_init(q_full, 1);
    hop::mbar_init(k_full, SEG ? 1 + 32 : 1);  // SEG: the meta warp
    hop::mbar_init(k_empty, 4);  // consumer 0's warps
    for (int w = 0; w < 2; ++w) {
      hop::mbar_init(&v_full[w], 1);
      hop::mbar_init(&v_empty[w], 4);  // consumer w's warps
    }
    hop::mbar_fence_init();
  }
  __syncthreads();

  if (role == 0) {
    // ---- producer: Q and K (warp 0), SEG metadata (warp 1), V's column
    // halves (warps 2 and 3) ----
    hop::setmaxnreg_dec<PRODUCER_REGS>();
    const int kvh = head / group;
    const int warp = threadIdx.x / 32;
    if (threadIdx.x == 0) {
      hop::prefetch_map(&q_map);
      hop::prefetch_map(&k_map);
      hop::mbar_expect_tx(q_full, L::Q_BYTES);
#pragma unroll
      for (int c = 0; c < NB; ++c)
        hop::tma_load_4d(smem + c * BLOCK_M * ROW, &q_map, q_full, c * BOX,
                         head, m_lo, batch);
      for (int j = 0; j < n_tiles; ++j) {
        if (j > 0) hop::mbar_wait(k_empty, (j - 1) & 1);
        hop::mbar_expect_tx(k_full, L::KV_BYTES);
        for (int c = 0; c < NB; ++c)
          hop::tma_load_4d(smem + L::K_OFF + c * BLOCK_N * ROW, &k_map,
                           k_full, c * BOX, kvh, (t_begin + j) * BLOCK_N,
                           batch);
      }
    } else if ((warp == 2 || warp == 3) && threadIdx.x % 32 == 0) {
      const int w = warp - 2;  // V's column half, consumer w's
      hop::prefetch_map(&v_map);
      for (int j = 0; j < n_tiles; ++j) {
        if (j > 0) hop::mbar_wait(&v_empty[w], (j - 1) & 1);
        hop::mbar_expect_tx(&v_full[w], L::KV_BYTES / 2);
        for (int c = w * NB / 2; c < (w + 1) * NB / 2; ++c)
          hop::tma_load_4d(smem + L::V_OFF + c * BLOCK_N * ROW, &v_map,
                           &v_full[w], c * BOX, kvh, (t_begin + j) * BLOCK_N,
                           batch);
      }
    } else if (SEG && warp == 1) {
      // each kv tile's ids, positions and span into the K slot's metadata,
      // read from global memory a tile ahead of the slot's release
      constexpr int PER = BLOCK_N / 32;
      const int lane = threadIdx.x % 32;
      const int* kv_seg = seg.kv_seg + (long long)batch * sk;
      const int* kv_pos = seg.kv_pos + (long long)batch * sk;
      int ids[PER], pss[PER];
      if (n_tiles > 0)
        fat::seg_fetch(kv_seg, kv_pos, t_begin * BLOCK_N, sk,
                       fat::KV_PAD_SEG, lane, ids, pss);
      for (int j = 0; j < n_tiles; ++j) {
        const fat::SegSpan span = fat::seg_span_of(ids, pss);
        if (j > 0) hop::mbar_wait(k_empty, (j - 1) & 1);
        fat::seg_store(reinterpret_cast<int*>(smem + L::META_OFF), ids, pss,
                       span, lane);
        hop::mbar_arrive(k_full);
        if (j + 1 < n_tiles)
          fat::seg_fetch(kv_seg, kv_pos, (t_begin + j + 1) * BLOCK_N, sk,
                         fat::KV_PAD_SEG, lane, ids, pss);
      }
    }
    return;
  }

  // ---- consumers ----
  hop::setmaxnreg_inc<CONSUMER_REGS>();
  const int wg = role - 1;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group
  const int w0 = m_lo + warp * 16;  // this warp's first row
  const int rows[2] = {w0 + g, w0 + g + 8};
  const uint32_t q_s = hop::smem_u32(smem);
  const uint32_t k_s = hop::smem_u32(smem + L::K_OFF);
  // this consumer's DH columns of the V slot: boxes wg * DH / 64 on
  const uint32_t v_half = hop::smem_u32(smem + L::V_OFF) + wg * (DH / BOX) *
                                                                BLOCK_N * ROW;
  const uint32_t p_s = hop::smem_u32(smem + L::P_OFF);
  float* alpha_s = reinterpret_cast<float*>(smem + L::ALPHA_OFF);
  float* inv_s = reinterpret_cast<float*>(smem + L::INV_OFF);

  float acc[DH / 2];  // this consumer's half of O, unnormalised
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
  float alpha[2];

  if (wg == 0) {
    float sc[BLOCK_N / 2];  // S, then P in fp32
    float m_r[2] = {-CUDART_INF_F, -CUDART_INF_F};
    float l_r[2] = {0.f, 0.f};  // this thread's share of the row sums
    const Rows rw{{rows[0], rows[1]}, w0, t, sk, off, left, right,
                  scale_log2, cap_scale, cap_log2};
    SegRows sr{};
    if constexpr (SEG) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const long long idx = (long long)batch * sq + rows[r];
        sr.seg[r] = rows[r] < sq ? seg.q_seg[idx] : fat::Q_PAD_SEG;
        sr.pos[r] = rows[r] < sq ? seg.q_pos[idx] : 0;
      }
      sr.warp = fat::seg_span(min(sr.seg[0], sr.seg[1]),
                              max(sr.seg[0], sr.seg[1]),
                              min(sr.pos[0], sr.pos[1]),
                              max(sr.pos[0], sr.pos[1]));
    }
    const int* meta = reinterpret_cast<const int*>(smem + L::META_OFF);
    // S(j), issued once K(j) has arrived
    auto scores = [&](int j) {
      hop::mbar_wait(k_full, j & 1);
      issue_qk<T, D>(sc, q_s, k_s);
    };
    // S(j) once it has been waited for: the softmax (the K slot released
    // before it, or with SEG after it: the slot holds the tile's ids), then
    // P(j) and alpha(j) into buffer j % 2 for consumer 1
    auto softmax_publish = [&](int j) {
      hop::fence_regs(sc);
      if (!SEG && lane == 0) hop::mbar_arrive(k_empty);
      softmax_tile<CAP, SEG, BLOCK_N>(sc, m_r, l_r, alpha,
                                      (t_begin + j) * BLOCK_N, rw, sr, meta);
      if (SEG && lane == 0) hop::mbar_arrive(k_empty);
      const int buf = j & 1;
      // buffer buf was last read by consumer 1's P(j - 2) V(j - 2)
      if (j >= 2) hop::named_sync(BAR_FREE + buf, 256);
      store_p<T>(smem + L::P_OFF + buf * L::P_BYTES, sc, warp, g, t);
      if (t == 0) {
        alpha_s[buf * BLOCK_M + warp * 16 + g] = alpha[0];
        alpha_s[buf * BLOCK_M + warp * 16 + g + 8] = alpha[1];
      }
      hop::fence_async_smem();  // P is read by wgmma (async proxy)
      hop::named_sync(BAR_C0, 128);
      hop::named_arrive(BAR_READY + buf, 256);
    };
    // this consumer's half of P(j) V(j), rescaled by alpha(j) (still in
    // `alpha`), issued and committed; then its wait and V's release
    auto pv = [&](int j) {
      hop::mbar_wait(&v_full[0], j & 1);
      issue_pv<T, DH>(acc, alpha, p_s + (j & 1) * L::P_BYTES, v_half);
    };
    auto pv_done = [&]() {
      hop::wgmma_wait<0>();
      hop::fence_regs(acc);
      if (lane == 0) hop::mbar_arrive(&v_empty[0]);
    };
    hop::mbar_wait(q_full, 0);
    if (open) {
      // rows of many tiles (the band's left side open): S(j + 1) goes in
      // ahead of P(j) V(j), and its softmax runs while that product does
      if (n_tiles > 0) {
        scores(0);
        hop::wgmma_wait<0>();
        softmax_publish(0);
      }
      for (int j = 0; j + 1 < n_tiles; ++j) {
        scores(j + 1);
        pv(j);
        hop::wgmma_wait<1>();
        softmax_publish(j + 1);
        pv_done();
      }
      if (n_tiles > 0) {
        pv(n_tiles - 1);
        pv_done();
      }
    } else {
      // a window's few tiles a row: each tile's S, softmax and product in
      // turn, so P(j) V(j) runs while K(j + 1) loads
      for (int j = 0; j < n_tiles; ++j) {
        scores(j);
        hop::wgmma_wait<0>();
        softmax_publish(j);
        pv(j);
        pv_done();
      }
    }
    // consumer 1's releases of the last two buffers
    for (int j = max(0, n_tiles - 2); j < n_tiles; ++j)
      hop::named_sync(BAR_FREE + (j & 1), 256);
    // LSE = (m + log2 l) ln 2 (empty_lse for dead rows); 1 / l for both
    // consumers (0 for dead rows)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_r[r] += __shfl_xor_sync(0xffffffff, l_r[r], 1);
      l_r[r] += __shfl_xor_sync(0xffffffff, l_r[r], 2);
      const bool alive = l_r[r] > 0.f;
      if (t == 0) {
        // not an IEEE division (its slow path is a call; see
        // hop::mbar_wait); l = 1 still gives exactly 1
        inv_s[warp * 16 + g + 8 * r] = alive ? __fdividef(1.f, l_r[r]) : 0.f;
        if (rows[r] < sq)
          lse[((long long)batch * h + head) * sq + rows[r]] =
              alive ? (m_r[r] + log2f(l_r[r])) * 0.69314718055994531f
                    : empty_lse;
      }
    }
  } else {
    for (int j = 0; j < n_tiles; ++j) {
      const int buf = j & 1;
      hop::named_sync(BAR_READY + buf, 256);
      alpha[0] = alpha_s[buf * BLOCK_M + warp * 16 + g];
      alpha[1] = alpha_s[buf * BLOCK_M + warp * 16 + g + 8];
      hop::mbar_wait(&v_full[1], j & 1);
      issue_pv<T, DH>(acc, alpha, p_s + buf * L::P_BYTES, v_half);
      hop::wgmma_wait<0>();
      hop::fence_regs(acc);
      if (lane == 0) hop::mbar_arrive(&v_empty[1]);
      hop::named_arrive(BAR_FREE + buf, 256);
    }
  }

  // epilogue: Q is no longer read (consumer 0's S chains are done, and its
  // Q load was waited for) and 1 / l is in shared memory
  hop::named_sync(BAR_EPI, 256);
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) inv[r] = inv_s[warp * 16 + g + 8 * r];
  // this consumer's half of O into its boxes of the Q tile, in the swizzled
  // layout the O map stores from
  uint8_t* o_boxes = smem + wg * (DH / BOX) * BLOCK_M * ROW;
#pragma unroll
  for (int nt = 0; nt < DH / 8; ++nt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = warp * 16 + g + 8 * r;
      const int chunk = (nt % 8) ^ (row & 7);
      *reinterpret_cast<uint32_t*>(o_boxes + (nt / 8) * BLOCK_M * ROW +
                                   row * ROW + chunk * 16 + t * 4) =
          fat::Mma<T>::pack(acc[4 * nt + 2 * r] * inv[r],
                            acc[4 * nt + 2 * r + 1] * inv[r]);
    }
  }
  hop::fence_async_smem();
  hop::named_sync(wg == 0 ? BAR_C0 : BAR_C1, 128);
  if (tid == 0) {
#pragma unroll
    for (int c = 0; c < DH / BOX; ++c)
      hop::tma_store_4d(&o_map, o_boxes + c * BLOCK_M * ROW,
                        wg * DH + c * BOX, head, m_lo, batch);
    hop::tma_store_wait();
  }
}

template <typename T, int D, bool SEG>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int b, int sq, int sk, int h, int hk, const long long* st,
           float scale_log2, int left, int right, float cap_scale,
           float cap_log2, float empty_lse, const fat::Seg& seg,
           cudaStream_t stream) {
  constexpr bool fp16 = std::is_same_v<T, __half>;
  const long long o_st[3] = {(long long)sq * h * D, (long long)h * D, D};
  CUtensorMap qm, km, vm, om;
  int rc;
  if ((rc = hop::make_map_bshd(&qm, q, fp16, b, sq, h, D, st, BLOCK_M)) ||
      (rc = hop::make_map_bshd(&km, k, fp16, b, sk, hk, D, st + 3, BLOCK_N)) ||
      (rc = hop::make_map_bshd(&vm, v, fp16, b, sk, hk, D, st + 6, BLOCK_N)) ||
      (rc = hop::make_map_bshd(&om, o, fp16, b, sq, h, D, o_st, BLOCK_M)))
    return rc;
  auto kernel = cap_scale != 0.f ? flash_fwd_wide_kernel<T, D, true, SEG>
                                 : flash_fwd_wide_kernel<T, D, false, SEG>;
  constexpr int bytes = Smem<D, SEG>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_m = (sq + BLOCK_M - 1) / BLOCK_M;
  const dim3 grid = left < 0 ? dim3(h, n_m, b) : dim3(n_m, h, b);
  kernel<<<grid, NTHREADS, bytes, stream>>>(
      qm, km, vm, om, lse, sq, sk, h, h / hk, scale_log2,
      fat::band_side(left), fat::band_side(right), cap_scale, cap_log2,
      empty_lse, seg);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// fat_flash_fwd's interface (flash_fwd.cu) at d 384 and 512.
int fat_flash_fwd_wide(const void* q, const void* k, const void* v, void* o,
                       void* lse, int b, int sq, int sk, int h, int hk, int d,
                       const long long* strides, float scale_log2, int left,
                       int right, float cap_scale, float cap_log2,
                       float empty_lse, int is_fp16, const void* seg,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  const fat::Seg sg = fat::seg_arg(seg);
#define FAT_FWD_LAUNCH(T, D)                                                 \
  return seg ? launch<T, D, true>(q, k, v, o, l, b, sq, sk, h, hk, strides,  \
                                  scale_log2, left, right, cap_scale,        \
                                  cap_log2, empty_lse, sg, s)                \
             : launch<T, D, false>(q, k, v, o, l, b, sq, sk, h, hk, strides, \
                                   scale_log2, left, right, cap_scale,       \
                                   cap_log2, empty_lse, sg, s)
  if (d == 512 && !is_fp16) FAT_FWD_LAUNCH(__nv_bfloat16, 512);
  if (d == 512) FAT_FWD_LAUNCH(__half, 512);
  if (d == 384 && !is_fp16) FAT_FWD_LAUNCH(__nv_bfloat16, 384);
  if (d == 384) FAT_FWD_LAUNCH(__half, 384);
#undef FAT_FWD_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

// The segmented instance's tiles at head dim d: out[0] query rows a CTA
// owns, out[1] kv rows a streamed tile holds.
int fat_flash_fwd_wide_seg_tiles(int d, int* out) {
  if (d != 384 && d != 512) return static_cast<int>(cudaErrorInvalidValue);
  out[0] = BLOCK_M;
  out[1] = BLOCK_N;
  return 0;
}

}  // extern "C"
