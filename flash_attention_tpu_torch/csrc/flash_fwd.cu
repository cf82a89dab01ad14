// Flash-attention forward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces: flash_attention_tpu/ops/flash_fwd.py::_fwd_kernel (the Pallas
// TPU kernel launched by flash_fwd), its dense and its segmented
// pallas_call.
//
// Computes, per (batch, head): S = scale * Q K^T, optionally softcapped to
// cap * tanh(S / cap), an online softmax in fp32, O = P V, and LSE = m +
// log(l) (natural log), with GQA (kv head = head / group) and a band of
// lower-right-aligned relative offsets: key c is live for row r iff
// -left <= c - r - (sk - sq) <= right (causal is right = 0; either side may
// be unbounded). Q is (b, sq, h, d) and K/V are (b, sk, hk, d), bf16 or
// fp16, d 64, 128 or 256 (384 and 512: flash_fwd_wide.cu), read by TMA
// through their strides (the head dim must be contiguous), so no copy is
// made. Rows with no live key (causal with
// sq > sk, or a band that misses every key) write O = 0 and LSE = empty_lse.
//
// What bounds it on the H100: at prefill shapes (sq = sk = 2048, d = 128) the
// two products make it compute-bound (4 d FLOP per score against a few bytes
// per score), so the tensor cores set the floor. Next come the softmax's
// instructions (about six per score: scale, max, subtract, exp2, sum, pack),
// which must hide behind the products; the loads do not limit it.
//
// What the design does about it: a warp-specialised CTA of three warpgroups
// owns 128 query rows.
// * Warpgroup 0, the producer, gives most of its registers away
//   (setmaxnreg); one of its threads loads Q once and streams 128-row K and
//   V tiles (64-row at d 256, KV_ROWS) by TMA into a ring of STAGES stages. K and V each have a full
//   mbarrier per stage (so Q K^T starts before V lands) and an empty one
//   that the 8 consumer warps release (K as soon as Q K^T is done).
// * Warpgroups 1 and 2, the consumers, own 64 query rows each. S = Q K^T is
//   one wgmma chain with both operands in shared memory (K-major, in the
//   128-byte swizzle TMA wrote). The online softmax runs on the fp32
//   accumulator in registers (each thread holds rows g and g + 8 of its
//   warp's 16). P, rounded to the input type, stays in registers as the A
//   operand of O += P V, whose B operand is V read MN-major (wgmma's
//   transpose mode), so no transposed copy is made.
// * Overlap: the two consumers take turns (named barriers) to issue their
//   products, so one's softmax runs while the other's hold the tensor
//   cores; and each issues S(j + 1) together with P(j) V(j), so the softmax
//   of tile j + 1 runs while P(j) V(j) finishes.
// * KV tiles wholly outside the band are never loaded: a CTA's tiles run
//   from the one holding its first row's left edge to the one holding its
//   last row's right edge, and the producer and the consumers count them
//   from the same integers. Only tiles that cross an edge of the band or the
//   ragged kv edge pay for masking, one warp's 16 rows at a time. TMA
//   zero-fills K/V rows past sk and Q rows past sq. CTAs with the longest
//   causal rows start first.
// * The softcap is a compile-time instance (CAP): cap * tanh(s scale / cap)
//   with tanh from exp2 (hop::tanh_exp2) and 1 / cap folded on the host, so
//   the consumers hold no division; without it the instance is the plain
//   one, instruction for instruction.
// * At d 256 the same layout holds with 64-row kv tiles: Q (64 KB) and two
//   stages of K and V (128 KB) fit the CTA's shared memory, and a consumer
//   thread's O (128 fp32), S (32) and P (16) fit its 232 registers. The
//   products are m64n64 for S and m64n256 for P V.
// * The epilogue writes O into the consumer's own 64 rows of the Q tile in
//   shared memory, in the swizzled layout, and stores it with one TMA store
//   per 64-column box, which clips rows past sq.
//
// Exactness the backward relies on: scores are scaled into the log2 domain
// and rounded first, then the row max is subtracted, so the largest score of
// a row gives exp2(0) = 1 exactly; a row with one live key gets O equal to
// that V row bit for bit.
//
// Rows past a sequence's own length in a padded prefill bucket are ordinary
// rows here: causal masking keeps them from influencing earlier rows, and no
// key-length mask beyond sk is applied.
//
// The segmented instance (SEG; packed batches and varlen, fat::Seg): a query
// sees a key of its own segment id whose kv_pos - q_pos lies in the band
// (causal is right = 0 over positions; the row and column indices are never
// compared). The CTA's kv tiles are the range [lo, hi] that
// ops/segments.py computed for its 128 rows at this kernel's tile sizes
// (fat_flash_fwd_seg_tiles); an empty range loads nothing and writes O = 0
// and LSE = empty_lse. A second producer warp reads each kv tile's ids and
// positions (KV_PAD_SEG past sk) a tile ahead, and copies them with their
// span (fat::SegSpan) into the K stage's slot, arriving on its full
// barrier; the consumers release the slot after the tile's softmax, not
// after S, so the ids live until then. The consumers hold their rows' ids
// and positions (Q_PAD_SEG past sq) in registers, and mask every tile of
// the range but those whose every pair with the warp's rows is live, which
// take the dense path's unmasked softmax. Tiles that cross a sequence
// boundary read the neighbour's rows, which the ids mask off.

#include "flash_common.cuh"
#include "flash_fwd_common.cuh"
#include "hopper_common.cuh"

namespace {

constexpr int BLOCK_M = 128;   // query rows per CTA, 64 per consumer
// kv rows per tile: 128 at d 64 and 128; 64 at d 256, where Q (64 KB) and
// two stages of K and V (128 KB) fill the CTA's shared memory
template <int D>
constexpr int KV_ROWS = D == 256 ? 64 : 128;
constexpr int STAGES = 2;      // depth of the K/V ring
constexpr int NTHREADS = 384;  // producer + 2 consumer warpgroups
constexpr int BOX = 64;        // head-dim elements per TMA box (128 bytes)
constexpr int ROW = BOX * 2;   // bytes per box row
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;  // 128 * 40 + 256 * 232 <= 65536

template <int D, bool SEG = false>
struct Smem {
  static constexpr int Q_BYTES = BLOCK_M * D * 2;
  static constexpr int KV_BYTES = KV_ROWS<D> * D * 2;
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  static constexpr int N_BARS = 1 + 4 * STAGES;  // q; k, v full; k, v empty
  // SEG: each K stage's kv ids, positions and their fat::SegSpan (int32)
  static constexpr int META_OFF = BAR_OFF + N_BARS * 8;
  static constexpr int META_INTS = SEG ? 2 * KV_ROWS<D> + 4 : 0;
  // slack to align the tiles to 1024 bytes, the swizzle's period
  static constexpr int BYTES = META_OFF + STAGES * META_INTS * 4 + 1024;
};

// S(j) = Q K(j)^T for one consumer's 64 rows, both K-major in shared memory:
// one wgmma chain, committed and not waited for.
template <typename T, int D, int BN = KV_ROWS<D>>
__device__ __forceinline__ void issue_qk(float (&sc)[BN / 2], uint32_t q_s,
                                         uint32_t ks) {
  hop::fence_regs(sc);
  hop::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t kb = (kk / 4) * ROW, ko = (kk % 4) * 32;
    hop::Wgmma<T, BN>::ss(
        sc, hop::desc_sw128(q_s + kb * BLOCK_M + ko, 16, 1024),
        hop::desc_sw128(ks + kb * BN + ko, 16, 1024), kk > 0);
  }
  hop::wgmma_commit();
}

// O = alpha O + P V, P in registers, V MN-major in shared memory: one wgmma
// chain, committed and not waited for.
template <typename T, int D, int BN = KV_ROWS<D>>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2],
                                         uint32_t (&pa)[BN / 16][4],
                                         const float (&alpha)[2], uint32_t vs) {
  // O moves only where a row's max moved (alpha < 1): after the first
  // tiles, mostly nowhere in the warp
  if (__any_sync(0xffffffff, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
  }
  hop::fence_regs(acc);  // the rescale and P stay before the fence
  hop::fence_regs(pa);
  hop::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
    hop::Wgmma<T, D>::rs_tb(
        acc, pa[kk], hop::desc_sw128(vs + kk * 16 * ROW, BN * ROW, 1024));
  hop::wgmma_commit();
}

// P, rounded to the input type, as A fragments: 8-column blocks 2 kk and
// 2 kk + 1 form k-step kk.
template <typename T, int BN>
__device__ __forceinline__ void to_p(uint32_t (&pa)[BN / 16][4],
                                     const float (&sc)[BN / 2]) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      pa[kk][e] = fat::Mma<T>::pack(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1]);
}

template <typename T, int D, bool CAP, bool SEG>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap q_map,
                 const __grid_constant__ CUtensorMap k_map,
                 const __grid_constant__ CUtensorMap v_map,
                 const __grid_constant__ CUtensorMap o_map,
                 float* __restrict__ lse, int sq, int sk, int h, int group,
                 float scale_log2, int left, int right, float cap_scale,
                 float cap_log2, float empty_lse, const fat::Seg seg) {
  using L = Smem<D, SEG>;
  constexpr int BLOCK_N = KV_ROWS<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (hop::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* k_empty = v_full + STAGES;
  uint64_t* v_empty = k_empty + STAGES;

  // longest causal rows first: the last query block has the most kv tiles
  const int m_block = gridDim.x - 1 - blockIdx.x;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int m_lo = m_block * BLOCK_M;
  const int off = sk - sq;  // lower-right offset of the band
  // kv columns this CTA can see, [n_begin, n_end): the band's right edge
  // stops at its last row's, the left edge starts at its first row's
  // (floored to a tile). Producer and consumers load and read tiles
  // n_begin / BLOCK_N + j, j < n_tiles.
  int n_end = sk;
  if (right < fat::UNBOUNDED)
    n_end = min(sk, min(m_lo + BLOCK_M, sq) + off + right);
  // SEG: the range of this query block, from ops/segments.py
  int seg_lo = 0, seg_n = 0;
  if constexpr (SEG) {
    const int blk = batch * gridDim.x + m_block;
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

  // warpgroup index, warp-uniform to the compiler (the shuffle): each role
  // is one branch that runs to the end, with its own setmaxnreg limit
  const int role = __shfl_sync(0xffffffff, threadIdx.x / 128, 0);
  if (threadIdx.x == 0) {
    hop::mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      hop::mbar_init(&k_full[s], SEG ? 1 + 32 : 1);  // SEG: the meta warp
      hop::mbar_init(&v_full[s], 1);
      hop::mbar_init(&k_empty[s], 8);  // one arrival per consumer warp
      hop::mbar_init(&v_empty[s], 8);
    }
    hop::mbar_fence_init();
  }
  __syncthreads();

  if (role == 0) {
    // ---- producer ----
    hop::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      hop::prefetch_map(&q_map);
      hop::prefetch_map(&k_map);
      hop::prefetch_map(&v_map);
      const int kvh = head / group;
      hop::mbar_expect_tx(q_full, L::Q_BYTES);
#pragma unroll
      for (int c = 0; c < D / BOX; ++c)
        hop::tma_load_4d(smem + c * BLOCK_M * ROW, &q_map, q_full, c * BOX,
                         head, m_lo, batch);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        const uint32_t prev = (j / STAGES - 1) & 1;  // tile j - STAGES
        uint8_t* ks = smem + L::K_OFF + s * L::KV_BYTES;
        uint8_t* vs = smem + L::V_OFF + s * L::KV_BYTES;
        // K and V slots are released apart: K(j - STAGES) as soon as its
        // S is done, a product earlier than its V
        if (j >= STAGES) hop::mbar_wait(&k_empty[s], prev);
        hop::mbar_expect_tx(&k_full[s], L::KV_BYTES);
#pragma unroll
        for (int c = 0; c < D / BOX; ++c)
          hop::tma_load_4d(ks + c * BLOCK_N * ROW, &k_map, &k_full[s], c * BOX,
                           kvh, (t_begin + j) * BLOCK_N, batch);
        if (j >= STAGES) hop::mbar_wait(&v_empty[s], prev);
        hop::mbar_expect_tx(&v_full[s], L::KV_BYTES);
#pragma unroll
        for (int c = 0; c < D / BOX; ++c)
          hop::tma_load_4d(vs + c * BLOCK_N * ROW, &v_map, &v_full[s], c * BOX,
                           kvh, (t_begin + j) * BLOCK_N, batch);
      }
    } else if constexpr (SEG) {
      if (threadIdx.x / 32 == 1) {
        // each kv tile's ids, positions and span into its K stage's slot,
        // read from global memory a tile ahead of the slot's release
        constexpr int PER = BLOCK_N / 32;  // columns a lane
        const int lane = threadIdx.x % 32;
        const int* kv_seg = seg.kv_seg + (long long)batch * sk;
        const int* kv_pos = seg.kv_pos + (long long)batch * sk;
        int ids[PER], pss[PER];
        if (n_tiles > 0)
          fat::seg_fetch(kv_seg, kv_pos, t_begin * BLOCK_N, sk,
                         fat::KV_PAD_SEG, lane, ids, pss);
        for (int j = 0; j < n_tiles; ++j) {
          const int s = j % STAGES;
          const fat::SegSpan span = fat::seg_span_of(ids, pss);
          if (j >= STAGES) hop::mbar_wait(&k_empty[s], (j / STAGES - 1) & 1);
          fat::seg_store(reinterpret_cast<int*>(smem + L::META_OFF) +
                             s * L::META_INTS,
                         ids, pss, span, lane);
          hop::mbar_arrive(&k_full[s]);
          if (j + 1 < n_tiles)
            fat::seg_fetch(kv_seg, kv_pos, (t_begin + j + 1) * BLOCK_N, sk,
                           fat::KV_PAD_SEG, lane, ids, pss);
        }
      }
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
    const int w0 = m_lo + wg * 64 + warp * 16;  // this warp's first row
    const int rows[2] = {w0 + g, w0 + g + 8};
    // this consumer's 64 rows of the Q tile (in each 64-column box)
    uint8_t* q_rows = smem + wg * 64 * ROW;
    const uint32_t q_s = hop::smem_u32(q_rows);
    const uint32_t k_s = hop::smem_u32(smem + L::K_OFF);
    const uint32_t v_s = hop::smem_u32(smem + L::V_OFF);

    float acc[D / 2];  // O, unnormalised
    float sc[BLOCK_N / 2];  // S, then P in fp32
    uint32_t pa[BLOCK_N / 16][4];  // P as the A operand of P V
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BLOCK_N / 2; ++i) sc[i] = 0.f;
    float m_r[2] = {-CUDART_INF_F, -CUDART_INF_F};
    float l_r[2] = {0.f, 0.f};  // this thread's share of the row sums
    float alpha[2];
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
    // SEG: the stages' kv ids, positions and spans
    const int* meta = reinterpret_cast<const int*>(smem + L::META_OFF);

    // The consumers take turns to issue their products (named barriers 3
    // and 4, consumer 0 first), so one's softmax runs while the other's
    // products hold the tensor cores. Within a consumer, S(j + 1) is issued
    // with P(j) V(j), and its softmax runs while P(j) V(j) finishes. The
    // last tile has no S(j + 1) and is peeled off, so no wgmma is issued
    // under a condition inside the loop.
    const int my_turn = 3 + wg, next_turn = 4 - wg;
    hop::mbar_wait(q_full, 0);
    if (n_tiles > 0) {
      if (wg == 1) hop::named_arrive(3, 256);
      hop::named_sync(my_turn, 256);
      hop::mbar_wait(&k_full[0], 0);
      issue_qk<T, D>(sc, q_s, k_s);
      hop::named_arrive(next_turn, 256);
      hop::wgmma_wait<0>();
      hop::fence_regs(sc);
      // SEG: K's slot holds the tile's ids until its softmax is done
      if (!SEG && lane == 0) hop::mbar_arrive(&k_empty[0]);
      softmax_tile<CAP, SEG, BLOCK_N>(sc, m_r, l_r, alpha, t_begin * BLOCK_N,
                                      rw, sr, meta);
      if (SEG && lane == 0) hop::mbar_arrive(&k_empty[0]);
      to_p<T, BLOCK_N>(pa, sc);
    }
    for (int j = 0; j + 1 < n_tiles; ++j) {
      const int s = j % STAGES, s1 = (j + 1) % STAGES;
      hop::named_sync(my_turn, 256);
      hop::mbar_wait(&k_full[s1], ((j + 1) / STAGES) & 1);
      issue_qk<T, D>(sc, q_s, k_s + s1 * L::KV_BYTES);
      hop::mbar_wait(&v_full[s], (j / STAGES) & 1);
      issue_pv<T, D>(acc, pa, alpha, v_s + s * L::KV_BYTES);
      hop::named_arrive(next_turn, 256);
      hop::wgmma_wait<1>();  // S(j + 1) is done; P(j) V(j) may still run
      hop::fence_regs(sc);
      if (!SEG && lane == 0) hop::mbar_arrive(&k_empty[s1]);
      softmax_tile<CAP, SEG, BLOCK_N>(sc, m_r, l_r, alpha,
                                      (t_begin + j + 1) * BLOCK_N, rw, sr,
                                      meta + s1 * L::META_INTS);
      if (SEG && lane == 0) hop::mbar_arrive(&k_empty[s1]);
      hop::wgmma_wait<0>();
      hop::fence_regs(acc);
      hop::fence_regs(pa);
      if (lane == 0) hop::mbar_arrive(&v_empty[s]);
      to_p<T, BLOCK_N>(pa, sc);
    }
    if (n_tiles > 0) {
      const int j = n_tiles - 1, s = j % STAGES;
      hop::named_sync(my_turn, 256);
      hop::mbar_wait(&v_full[s], (j / STAGES) & 1);
      issue_pv<T, D>(acc, pa, alpha, v_s + s * L::KV_BYTES);
      hop::named_arrive(next_turn, 256);
      hop::wgmma_wait<0>();
      hop::fence_regs(acc);
      hop::fence_regs(pa);
      // (the last V slot is never reused: no release)
      // consumer 1's last turn signal has no turn after it: take it
      if (wg == 0) hop::named_sync(my_turn, 256);
    }

    // epilogue: O = acc / l (0 for dead rows), LSE = (m + log2 l) * ln 2
    float inv[2];
    bool alive[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_r[r] += __shfl_xor_sync(0xffffffff, l_r[r], 1);
      l_r[r] += __shfl_xor_sync(0xffffffff, l_r[r], 2);
      alive[r] = l_r[r] > 0.f;
      // not an IEEE division: its slow path is a subroutine call, and the
      // consumers' code holds no calls or traps (see hop::mbar_wait);
      // l = 1 still gives exactly 1
      inv[r] = alive[r] ? __fdividef(1.f, l_r[r]) : 0.f;
    }
    // O into this consumer's rows of the Q tile (its last read of them is
    // done), in the swizzled layout the O map stores from
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = warp * 16 + g + 8 * r;
        const int chunk = (nt % 8) ^ (row & 7);
        *reinterpret_cast<uint32_t*>(q_rows + (nt / 8) * BLOCK_M * ROW +
                                     row * ROW + chunk * 16 + t * 4) =
            fat::Mma<T>::pack(acc[4 * nt + 2 * r] * inv[r],
                              acc[4 * nt + 2 * r + 1] * inv[r]);
      }
    }
    hop::fence_async_smem();
    hop::named_sync(1 + wg, 128);
    if (tid == 0) {
#pragma unroll
      for (int c = 0; c < D / BOX; ++c)
        hop::tma_store_4d(&o_map, q_rows + c * BLOCK_M * ROW, c * BOX, head,
                          m_lo + wg * 64, batch);
      hop::tma_store_wait();
    }
    if (t == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (rows[r] < sq)
          lse[((long long)batch * h + head) * sq + rows[r]] =
              alive[r] ? (m_r[r] + log2f(l_r[r])) * 0.69314718055994531f
                       : empty_lse;
      }
    }
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
      (rc = hop::make_map_bshd(&km, k, fp16, b, sk, hk, D, st + 3,
                               KV_ROWS<D>)) ||
      (rc = hop::make_map_bshd(&vm, v, fp16, b, sk, hk, D, st + 6,
                               KV_ROWS<D>)) ||
      (rc = hop::make_map_bshd(&om, o, fp16, b, sq, h, D, o_st, 64)))
    return rc;
  auto kernel = cap_scale != 0.f ? flash_fwd_kernel<T, D, true, SEG>
                                 : flash_fwd_kernel<T, D, false, SEG>;
  constexpr int bytes = Smem<D, SEG>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((sq + BLOCK_M - 1) / BLOCK_M, h, b);
  kernel<<<grid, NTHREADS, bytes, stream>>>(
      qm, km, vm, om, lse, sq, sk, h, h / hk, scale_log2,
      fat::band_side(left), fat::band_side(right), cap_scale,
      cap_log2, empty_lse, seg);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// strides: 9 int64 in elements, (batch, seq, head) for q, k, v.
// o is a contiguous (b, sq, h, d) tensor; lse a contiguous (b, h, sq) fp32.
// left, right: the band (< 0 = unbounded; causal is right = 0). cap_scale =
// scale / cap and cap_log2 = cap log2(e) run the softcap instance; 0 and 0
// the plain one. seg: null for a dense launch, or a host array of the six
// device pointers of fat::Seg (the ranges over fat_flash_fwd_seg_tiles'
// blocks), which runs the segmented instance with the band over positions.
int fat_flash_fwd(const void* q, const void* k, const void* v, void* o,
                  void* lse, int b, int sq, int sk, int h, int hk, int d,
                  const long long* strides, float scale_log2, int left,
                  int right, float cap_scale, float cap_log2, float empty_lse,
                  int is_fp16, const void* seg, void* stream) {
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
  if (d == 256 && !is_fp16) FAT_FWD_LAUNCH(__nv_bfloat16, 256);
  if (d == 256) FAT_FWD_LAUNCH(__half, 256);
  if (d == 128 && !is_fp16) FAT_FWD_LAUNCH(__nv_bfloat16, 128);
  if (d == 128) FAT_FWD_LAUNCH(__half, 128);
  if (d == 64 && !is_fp16) FAT_FWD_LAUNCH(__nv_bfloat16, 64);
  if (d == 64) FAT_FWD_LAUNCH(__half, 64);
#undef FAT_FWD_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

// The segmented instance's tiles at head dim d: out[0] query rows a CTA
// owns, out[1] kv rows a streamed tile holds; the blocks of its ranges.
int fat_flash_fwd_seg_tiles(int d, int* out) {
  if (d != 64 && d != 128 && d != 256)
    return static_cast<int>(cudaErrorInvalidValue);
  out[0] = BLOCK_M;
  out[1] = d == 256 ? KV_ROWS<256> : KV_ROWS<128>;
  return 0;
}

}  // extern "C"
