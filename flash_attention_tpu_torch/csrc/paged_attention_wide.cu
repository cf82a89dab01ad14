// Paged-attention decode for Hopper (sm_90a) at head dims 384 and 512,
// hand-written CUDA C++.
//
// Replaces: flash_attention_tpu/ops/paged_attention.py::_paged_attn_kernel
// (the Pallas TPU kernel launched by paged_attention), at the head dims the
// JAX package pads d 257-512 to.
//
// Computes what paged_attention.cu computes (see there: pages, lengths, the
// window and its holes, the softcap, the int8 and fp8 caches with their
// scale tiles, the split over chunks and the ordered merge), at d 384 and
// 512, where that kernel's design does not fit: its one consumer warpgroup
// holds O of the group in registers, 256 fp32 a thread at d 512.
//
// What bounds it on the H100: bytes, as at d 128: each cached token costs
// 2 * d * 2 bytes of K and V (2 d + 8 in an 8-bit cache) and 4 * d * group
// FLOP. At DeepSeek-V4-Flash's geometry (64 query heads on one kv head) that
// is 64 FLOP a byte, still below the ~295 where the tensor cores would bind.
//
// What the design does about it:
// * All of a kv head's query heads, up to MAX_GROUP = 64, are the M side of
//   one wgmma m64 (FlashMLA's layout), so the kv head's pages are read once
//   for the whole group; a larger group runs as sub-groups of 64 over the
//   grid's y axis, each reading the pages again. Rows past the group are
//   zeros.
// * The split over the sequence, the chunk plan, the producer (one warp of a
//   producer warpgroup that gives its registers away: page ids read
//   lane-parallel, TMA boxes of the largest power of two dividing the page
//   size, out-of-range pages for dead boxes), the per-pair counters and the
//   ordered merge of fp32 partials are paged_attention.cu's.
// * Three warpgroups a CTA, one CTA a SM. Shared memory at d 512: Q (64 rows,
//   64 KB, written by the consumers in the 128-byte swizzle), one stage of K
//   and V (128 KB), and P (8 KB); the stages are as many as fit (1 at d 384
//   and 512, 2 for the 8-bit cache at d 384).
// * Consumer 0 computes S = Q K^T (m64n64, both operands in shared memory)
//   and the online softmax for every head, and writes P, rounded to bf16 or
//   fp16, and each head's rescale factor into shared memory. The two
//   consumers each own half of O's columns (n192 at d 384, n256 at d 512:
//   96 or 128 fp32 registers a thread) and issue O_half += P V_half with both
//   operands in shared memory (V MN-major). Named barrier 1 over the two
//   consumers orders each tile's steps.
// * The 8-bit cache: the consumers convert the tile's K into one bf16 buffer
//   in the bf16 stage's layout (paged_common.cuh), consumer 0 runs S on it,
//   then the same buffer takes the converted V for P V. kscale multiplies
//   the score before the softcap and the mask, vscale P before its rounding,
//   as in paged_attention.cu.
//
// Exactness as in paged_attention.cu: a row of length 1 gets O equal to
// that token's V bit for bit.
//
// Left for later work: a deeper ring (32-token tiles), overlap of consumer
// 0's S(j + 1) with the products of tile j, and for the 8-bit cache a
// conversion that overlaps the loads.

#include "flash_common.cuh"
#include "hopper_common.cuh"
#include "paged_common.cuh"

namespace {

constexpr int NTHREADS = 384;  // producer + 2 consumer warpgroups
constexpr int NC = 256;        // consumer threads
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;  // 128 * 40 + 256 * 232 <= 65536
constexpr int MAX_GROUP = 64;  // query heads of a CTA: the wgmma M side
constexpr int BAR_ALL = 1;     // named barrier of the two consumers

// Q: 0 pages in T; 1 int8 pages; 2 fp8 e4m3 pages (with scale tiles)
template <int D, int Q = 0>
struct Smem {
  static constexpr bool QUANT = Q != 0;
  static constexpr int TILE_BYTES = TILE * D * (QUANT ? 1 : 2);
  // K, then V, then (QUANT) the tile's 64 K scales and 64 V scales, the
  // stage padded to the swizzle's 1024-byte period
  static constexpr int SCALE_OFF = 2 * TILE_BYTES;
  static constexpr int STAGE_BYTES = 2 * TILE_BYTES + (QUANT ? 1024 : 0);
  static constexpr int TX_BYTES = 2 * TILE_BYTES + (QUANT ? 2 * TILE * 4 : 0);
  // QUANT: one tile converted to bf16 (K, then V)
  static constexpr int CVT_BYTES = QUANT ? TILE * D * 2 : 0;
  static constexpr int Q_BYTES = MAX_GROUP * D * 2;
  static constexpr int P_BYTES = MAX_GROUP * TILE * 2;
  // after the stages: the bf16 buffer, Q, P, the heads' rescale factors and
  // 1 / l, the barriers and the merge flag, and slack to align the ring to
  // 1024 bytes
  static constexpr int FIXED = CVT_BYTES + Q_BYTES + P_BYTES +
                               2 * MAX_GROUP * 4 + 2 * 4 * 8 + 16 + 1024;
  static constexpr int STAGES = (232448 - FIXED) / STAGE_BYTES > 4
                                    ? 4
                                    : (232448 - FIXED) / STAGE_BYTES;
  static_assert(STAGES >= 1, "no stage fits the CTA's shared memory");
  static constexpr int CVT_OFF = STAGES * STAGE_BYTES;
  static constexpr int Q_OFF = CVT_OFF + CVT_BYTES;
  static constexpr int P_OFF = Q_OFF + Q_BYTES;
  static constexpr int ALPHA_OFF = P_OFF + P_BYTES;
  static constexpr int INV_OFF = ALPHA_OFF + MAX_GROUP * 4;
  static constexpr int BAR_OFF = INV_OFF + MAX_GROUP * 4;
  static constexpr int FLAG_OFF = BAR_OFF + 2 * STAGES * 8;
  static constexpr int BYTES = FLAG_OFF + 16 + 1024;
  // the merge's weights [chunk][head] reuse the ring, whose every load has
  // been consumed by then
  static constexpr int W_OFF = 0;
  static_assert(MAX_CHUNKS * MAX_GROUP * 4 <= STAGES * STAGE_BYTES, "");
};

// Floats of one chunk's partial: O (MAX_GROUP x D), then m and l.
template <int D>
constexpr int PARTIAL = MAX_GROUP * D + 2 * MAX_GROUP;

// O_half += P V_half: P (64 heads x 64 tokens, K-major) and this consumer's
// DH columns of V (MN-major) in shared memory; one wgmma chain, committed
// and waited for.
template <typename T, int DH>
__device__ __forceinline__ void pv_half(float (&acc)[DH / 2], uint32_t p_s,
                                        uint32_t v_half) {
  hop::fence_regs(acc);
  hop::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < TILE / 16; ++kk)
    hop::WgmmaSs<T, DH, 0, 1>::ss(
        acc, hop::desc_sw128(p_s + kk * 32, 16, 1024),
        hop::desc_sw128(v_half + kk * 16 * ROW, TILE * ROW, 1024), 1);
  hop::wgmma_commit();
  hop::wgmma_wait<0>();
  hop::fence_regs(acc);
}

template <int N>
__device__ __forceinline__ void rescale(float (&acc)[N], const float (&alpha)[2]) {
  if (__any_sync(0xffffffff, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
    for (int i = 0; i < N; ++i) acc[i] *= alpha[(i >> 1) & 1];
  }
}

template <typename T, int D, bool CAP, int Q>
__global__ void __launch_bounds__(NTHREADS, 1)
paged_attn_wide_kernel(const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map,
                       const T* __restrict__ q, const int* __restrict__ lengths,
                       const int* __restrict__ tables, T* __restrict__ out,
                       float* __restrict__ ws, int* __restrict__ counters,
                       int h, int hk, int page_size, int box_rows,
                       int pages_per_seq, int total_pages, int pages_all,
                       int layer, int chunk_tiles, int window, float scale_log2,
                       float cap_scale, float cap_log2,
                       const __grid_constant__ CUtensorMap ks_map,
                       const __grid_constant__ CUtensorMap vs_map) {
  using S = Smem<D, Q>;
  constexpr bool QUANT = S::QUANT;
  constexpr int STAGES = S::STAGES;
  constexpr int DH = D / 2;  // O columns a consumer owns
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (hop::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::BAR_OFF);
  uint64_t* empty = full + STAGES;

  const int chunk = blockIdx.x, b = blockIdx.z;
  // grid.y runs over (kv head, sub-group of at most MAX_GROUP query heads)
  const int full_group = h / hk;
  const int n_sub = (full_group + MAX_GROUP - 1) / MAX_GROUP;
  const int kvh = blockIdx.y / n_sub, sub = blockIdx.y % n_sub;
  const int group = min(MAX_GROUP, full_group - sub * MAX_GROUP);
  const int len = min(lengths[b], pages_per_seq * page_size);
  // the first live token, and the tile the pair's first chunk starts at
  const int start = window > 0 ? max(len - window, 0) : 0;
  const int tile0 = start / TILE;
  const int tok0 = (tile0 + chunk * chunk_tiles) * TILE;
  const long long row0 =
      (long long)b * h + (long long)kvh * full_group + sub * MAX_GROUP;
  if (len <= 0) {
    if (chunk == 0) {
      uint16_t* o = reinterpret_cast<uint16_t*>(out) + row0 * D;
      for (int i = threadIdx.x; i < group * D; i += NTHREADS) o[i] = 0;
    }
    return;
  }
  if (tok0 >= len) return;
  // producer and consumers agree on the tile count; every tile holds at
  // least one live token
  const int n_tiles = min(chunk_tiles, (len - tok0 + TILE - 1) / TILE);
  const int n_live =
      ((len + TILE - 1) / TILE - tile0 + chunk_tiles - 1) / chunk_tiles;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    hop::mbar_fence_init();
  }
  __syncthreads();

  const int role = __shfl_sync(0xffffffff, threadIdx.x / 128, 0);
  if (role == 0) {
    // ---- producer: the warpgroup's first warp ----
    hop::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    if (lane == 0) {
      hop::prefetch_map(&k_map);
      hop::prefetch_map(&v_map);
    }
    const int* tab = tables + (long long)b * pages_per_seq;
    const int boxes = TILE / box_rows;
    const int base = (layer * hk + kvh) * total_pages;
    if constexpr (QUANT) {
      // page_size 128: one box of TILE rows a tile, and its scales, from
      // lane 0; a tile always holds a live token
      if (lane == 0) {
        hop::prefetch_map(&ks_map);
        hop::prefetch_map(&vs_map);
        constexpr int IN_ROW = qbox_row(D);
        for (int j = 0; j < n_tiles; ++j) {
          const int s = j % STAGES;
          const int t0 = tok0 + j * TILE;
          const int page = base + tab[t0 / page_size];
          const int row = t0 % page_size;
          if (j >= STAGES) hop::mbar_wait(&empty[s], (j / STAGES - 1) & 1);
          hop::mbar_expect_tx(&full[s], S::TX_BYTES);
          uint8_t* ks = smem + s * S::STAGE_BYTES;
          uint8_t* vs = ks + S::TILE_BYTES;
#pragma unroll
          for (int c = 0; c < D / IN_ROW; ++c) {
            hop::tma_load_3d(ks + c * TILE * IN_ROW, &k_map, &full[s],
                             c * IN_ROW, row, page);
            hop::tma_load_3d(vs + c * TILE * IN_ROW, &v_map, &full[s],
                             c * IN_ROW, row, page);
          }
          hop::tma_load_2d(ks + S::SCALE_OFF, &ks_map, &full[s], row, page);
          hop::tma_load_2d(ks + S::SCALE_OFF + TILE * 4, &vs_map, &full[s],
                           row, page);
        }
      }
      return;
    }
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % STAGES;
      const int t0 = tok0 + j * TILE;
      // this lane's boxes (i = lane, lane + 32) and their pages, read before
      // the wait for a free stage
      int page[2], row[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int i = lane + 32 * u;
        const int t = t0 + i * box_rows;
        const bool live = i < boxes && t < len && t + box_rows > start;
        // a dead box reads past the map's last page: TMA fills zeros
        page[u] = live ? base + tab[t / page_size] : pages_all;
        row[u] = live ? t % page_size : 0;
      }
      if (j >= STAGES) hop::mbar_wait(&empty[s], (j / STAGES - 1) & 1);
      if (lane == 0) hop::mbar_expect_tx(&full[s], S::TX_BYTES);
      __syncwarp();
      uint8_t* ks = smem + s * S::STAGE_BYTES;
      uint8_t* vs = ks + S::TILE_BYTES;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int i = lane + 32 * u;
        if (i < boxes) {
          // not unrolled: 2 x 8 loads of their own offsets would not fit
          // the producer's 40 registers at d 512
#pragma unroll 1
          for (int c = 0; c < D / BOX; ++c) {
            const int off = c * TILE * ROW + i * box_rows * ROW;
            hop::tma_load_3d(ks + off, &k_map, &full[s], c * BOX, row[u],
                             page[u]);
            hop::tma_load_3d(vs + off, &v_map, &full[s], c * BOX, row[u],
                             page[u]);
          }
        }
      }
    }
    return;
  }

  // ---- consumers ----
  hop::setmaxnreg_inc<CONSUMER_REGS>();
  const int wg = role - 1;
  const int ctid = threadIdx.x - 128;  // thread of the two consumers
  const int tid = ctid % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in its row group
  // this thread's two heads (the M rows 16 warp + g and + 8)
  const int heads[2] = {warp * 16 + g, warp * 16 + g + 8};

  // Q as a K-major tile of 64 rows (rows past the group zeros) in the
  // 128-byte swizzle: row r's 16-byte chunk k of a box at r * 128 + (k ^ r %
  // 8) * 16
  for (int i = ctid; i < MAX_GROUP * D / 8; i += NC) {
    const int c = i % 8, r = (i / 8) % MAX_GROUP, box = i / (8 * MAX_GROUP);
    const uint4 x = r < group ? *reinterpret_cast<const uint4*>(
                                    q + (row0 + r) * D + box * BOX + c * 8)
                              : make_uint4(0u, 0u, 0u, 0u);
    *reinterpret_cast<uint4*>(smem + S::Q_OFF + box * MAX_GROUP * ROW +
                              r * ROW + ((c ^ (r & 7)) * 16)) = x;
  }
  hop::fence_async_smem();  // the tile is read by wgmma (async proxy)
  hop::named_sync(BAR_ALL, NC);

  const uint32_t ring = hop::smem_u32(smem);
  const uint32_t q_s = hop::smem_u32(smem + S::Q_OFF);
  const uint32_t p_s = hop::smem_u32(smem + S::P_OFF);
  float* alpha_s = reinterpret_cast<float*>(smem + S::ALPHA_OFF);
  float* inv_s = reinterpret_cast<float*>(smem + S::INV_OFF);
  // this consumer's DH columns of a V tile: boxes wg * DH / 64 on
  const uint32_t half = wg * (DH / BOX) * TILE * ROW;
  float acc[DH / 2];  // this consumer's half of O, unnormalised
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
  float m_r[2] = {-CUDART_INF_F, -CUDART_INF_F};  // consumer 0: heads' max
  float l_r[2] = {0.f, 0.f};  // consumer 0: this thread's share of the sums
  float alpha[2];

  // Each tile, in the same barrier order on both consumers: (tile > 0) both
  // products of the last tile are done, so P and the bf16 buffer are free;
  // (QUANT) K converted; (QUANT) S done, the buffer free for V; P, alpha
  // (and QUANT V) in shared memory. Then each consumer's product.
  if (wg == 0) {
    float sc[TILE / 2];  // S, then P in fp32
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % STAGES;
      if (j > 0) hop::named_sync(BAR_ALL, NC);
      hop::mbar_wait(&full[s], (j / STAGES) & 1);
      uint8_t* stage = smem + s * S::STAGE_BYTES;
      uint32_t ks = ring + s * S::STAGE_BYTES, vs = ks + S::TILE_BYTES;
      const float* tile_scales = reinterpret_cast<const float*>(stage + S::SCALE_OFF);
      if constexpr (QUANT) {
        dequant_tile<D, Q, NC>(stage, smem + S::CVT_OFF, ctid);
        hop::fence_async_smem();
        hop::named_sync(BAR_ALL, NC);
        ks = vs = ring + S::CVT_OFF;
      }
      // S = Q K^T for every head
      hop::ss_chain<T, TILE, D>(sc, q_s, MAX_GROUP, ks, TILE);
      hop::wgmma_commit();
      hop::wgmma_wait<0>();
      hop::fence_regs(sc);
      if constexpr (QUANT) hop::named_sync(BAR_ALL, NC);  // S read the buffer
      // the online softmax of the thread's two heads over the tile's 64
      // tokens; thread t holds columns 8 nn + 2 t and + 1 of each
      const int t0 = tok0 + j * TILE;
      // live columns [lo, hi) counted from the thread's first
      const int hi = len - t0 - 2 * t, lo = start - t0 - 2 * t;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -CUDART_INF_F;
#pragma unroll
        for (int nn = 0; nn < TILE / 8; ++nn) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * nn + 2 * r + e;
            float x = sc[i];
            if constexpr (QUANT) x *= tile_scales[8 * nn + 2 * t + e];
            if constexpr (CAP)
              x = cap_log2 * hop::tanh_exp2(x * cap_scale);
            else
              x = x * scale_log2;
            const int c = 8 * nn + e;
            sc[i] = c < hi && c >= lo ? x : -CUDART_INF_F;
            mx = fmaxf(mx, sc[i]);
          }
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, 2));
        // every tile has a live token, so the max is finite
        const float m_new = fmaxf(m_r[r], mx);
        alpha[r] = hop::exp2_approx(m_r[r] - m_new);
        float sum = 0.f;
#pragma unroll
        for (int nn = 0; nn < TILE / 8; ++nn) {
          const int i = 4 * nn + 2 * r;
          sc[i] = hop::exp2_approx(sc[i] - m_new);
          sc[i + 1] = hop::exp2_approx(sc[i + 1] - m_new);
          sum += sc[i] + sc[i + 1];
          if constexpr (QUANT) {  // P times vscale before its rounding
            sc[i] *= tile_scales[TILE + 8 * nn + 2 * t];
            sc[i + 1] *= tile_scales[TILE + 8 * nn + 2 * t + 1];
          }
        }
        l_r[r] = l_r[r] * alpha[r] + sum;
        m_r[r] = m_new;
      }
      // P, rounded to T, in the 128-byte swizzle of a K-major operand
      uint8_t* p = smem + S::P_OFF;
#pragma unroll
      for (int nt = 0; nt < TILE / 8; ++nt)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          *reinterpret_cast<uint32_t*>(p + heads[r] * ROW +
                                       ((nt ^ (heads[r] & 7)) * 16) + t * 4) =
              fat::Mma<T>::pack(sc[4 * nt + 2 * r], sc[4 * nt + 2 * r + 1]);
      if (t == 0) {
        alpha_s[heads[0]] = alpha[0];
        alpha_s[heads[1]] = alpha[1];
      }
      // QUANT: this consumer's share of V's conversion, once S is no longer
      // held in registers
      if constexpr (QUANT)
        dequant_tile<D, Q, NC>(stage + S::TILE_BYTES, smem + S::CVT_OFF, ctid);
      hop::fence_async_smem();
      hop::named_sync(BAR_ALL, NC);
      rescale(acc, alpha);
      pv_half<T, DH>(acc, p_s, vs + half);
      if (lane == 0) hop::mbar_arrive(&empty[s]);
    }
    // the heads' 1 / l, m and l
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_r[r] += __shfl_xor_sync(0xffffffff, l_r[r], 1);
      l_r[r] += __shfl_xor_sync(0xffffffff, l_r[r], 2);
      if (t == 0) inv_s[heads[r]] = __fdividef(1.f, l_r[r]);
    }
  } else {
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % STAGES;
      if (j > 0) hop::named_sync(BAR_ALL, NC);
      hop::mbar_wait(&full[s], (j / STAGES) & 1);
      uint8_t* stage = smem + s * S::STAGE_BYTES;
      uint32_t vs = ring + s * S::STAGE_BYTES + S::TILE_BYTES;
      if constexpr (QUANT) {
        dequant_tile<D, Q, NC>(stage, smem + S::CVT_OFF, ctid);
        hop::fence_async_smem();
        hop::named_sync(BAR_ALL, NC);
        hop::named_sync(BAR_ALL, NC);  // consumer 0's S has read the buffer
        dequant_tile<D, Q, NC>(stage + S::TILE_BYTES, smem + S::CVT_OFF, ctid);
        vs = ring + S::CVT_OFF;
      }
      hop::fence_async_smem();
      hop::named_sync(BAR_ALL, NC);
      alpha[0] = alpha_s[heads[0]];
      alpha[1] = alpha_s[heads[1]];
      rescale(acc, alpha);
      pv_half<T, DH>(acc, p_s, vs + half);
      if (lane == 0) hop::mbar_arrive(&empty[s]);
    }
  }

  // ---- epilogue ----
  hop::named_sync(BAR_ALL, NC);  // 1 / l in shared memory; products done
  const int col0 = wg * DH + 2 * t;  // the thread's first column of O
  if (n_live == 1) {
    // the whole row is in this chunk: O = acc / l (l = 1 gives exactly 1)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (heads[r] < group) {
        const float inv = inv_s[heads[r]];
        uint32_t* o = reinterpret_cast<uint32_t*>(out + (row0 + heads[r]) * D +
                                                  col0);
#pragma unroll
        for (int nt = 0; nt < DH / 8; ++nt)
          o[nt * 4] = fat::Mma<T>::pack(acc[4 * nt + 2 * r] * inv,
                                        acc[4 * nt + 2 * r + 1] * inv);
      }
    }
    return;
  }
  const int pair = b * gridDim.y + blockIdx.y;
  float* part = ws + ((long long)pair * gridDim.x + chunk) * PARTIAL<D>;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (heads[r] < group) {
#pragma unroll
      for (int nt = 0; nt < DH / 8; ++nt)
        *reinterpret_cast<float2*>(part + heads[r] * D + col0 + nt * 8) =
            make_float2(acc[4 * nt + 2 * r], acc[4 * nt + 2 * r + 1]);
      if (wg == 0 && t == 0) {
        part[MAX_GROUP * D + heads[r]] = m_r[r];
        part[MAX_GROUP * D + MAX_GROUP + heads[r]] = l_r[r];
      }
    }
  }
  __threadfence();
  hop::named_sync(BAR_ALL, NC);
  if (ctid == 0) {
    const int done = atomicAdd(&counters[pair], 1);
    const int last = done == n_live - 1;
    if (last) {
      counters[pair] = 0;  // ready for the next call
      __threadfence();
    }
    *reinterpret_cast<int*>(smem + S::FLAG_OFF) = last;
  }
  hop::named_sync(BAR_ALL, NC);
  if (!*reinterpret_cast<volatile int*>(smem + S::FLAG_OFF)) return;

  // The last chunk of the pair merges every chunk's partial, in chunk order
  merge_partials<MAX_GROUP, NC, NC / MAX_GROUP, D>(
      ws + (long long)pair * gridDim.x * PARTIAL<D>,
      reinterpret_cast<float*>(smem + S::W_OFF), inv_s, n_live, group, ctid,
      out + row0 * D);
}

// Q: 0 pages in T; 1 int8 and 2 fp8 e4m3 pages with scale tiles ks, vs
template <typename T, int D, int Q>
int launch(const void* q, const void* kp, const void* vp, const void* ksp,
           const void* vsp, const int* lengths, const int* tables, void* out,
           float* ws, int* counters, int b, int h, int hk, int L, int layer,
           int total_pages, int page_size, int pages_per_seq, int chunk_tiles,
           int n_chunks, int window, float scale_log2, float cap_scale,
           float cap_log2, cudaStream_t stream) {
  Pool pool;
  int rc = pool_of<D, Q>(&pool, std::is_same_v<T, __half>, kp, vp, ksp, vsp,
                         L, hk, total_pages, page_size, pages_per_seq,
                         chunk_tiles, n_chunks, window);
  if (rc) return rc;
  auto kernel = cap_scale != 0.f ? paged_attn_wide_kernel<T, D, true, Q>
                                 : paged_attn_wide_kernel<T, D, false, Q>;
  static std::atomic<uint64_t> raised[2]{};
  if ((rc = raise_smem_once(kernel, Smem<D, Q>::BYTES,
                            raised[cap_scale != 0.f])))
    return rc;
  dim3 grid(n_chunks, hk * ((h / hk + MAX_GROUP - 1) / MAX_GROUP), b);
  kernel<<<grid, NTHREADS, Smem<D, Q>::BYTES, stream>>>(
      pool.km, pool.vm, static_cast<const T*>(q), lengths, tables,
      static_cast<T*>(out), ws, counters, h, hk, page_size, pool.box_rows,
      pages_per_seq, total_pages, pool.pages_all, layer, chunk_tiles, window,
      scale_log2, cap_scale, cap_log2, pool.ksm, pool.vsm);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// fat_paged_attention's interface (paged_attention.cu) at d 384 and 512,
// with sub-groups of up to 64 query heads: workspace (b hk n_sub n_chunks)
// partials of (64 d + 128) floats (unused when n_chunks is 1), n_sub =
// ceil(h / hk / 64); counters b hk n_sub int32 zeros.
int fat_paged_attention_wide(const void* q, const void* k_pages,
                             const void* v_pages, const void* k_scales,
                             const void* v_scales, const void* lengths,
                             const void* tables, void* out, void* workspace,
                             void* counters, int b, int h, int hk, int d, int L,
                             int layer, int total_pages, int page_size,
                             int pages_per_seq, int chunk_tiles, int n_chunks,
                             int window, float scale_log2, float cap_scale,
                             float cap_log2, int is_fp16, int kv_type,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  const int* tab = static_cast<const int*>(tables);
  float* ws = static_cast<float*>(workspace);
  int* cnt = static_cast<int*>(counters);
  if (hk < 1 || h % hk || kv_type < 0 || kv_type > 2 ||
      (kv_type != 0 && is_fp16))
    return static_cast<int>(cudaErrorInvalidValue);
#define FAT_PAGED_LAUNCH(T, D, Q)                                              \
  return launch<T, D, Q>(q, k_pages, v_pages, k_scales, v_scales, len, tab,    \
                         out, ws, cnt, b, h, hk, L, layer, total_pages,        \
                         page_size, pages_per_seq, chunk_tiles, n_chunks,      \
                         window, scale_log2, cap_scale, cap_log2, s)
#define FAT_PAGED_D(D)                                                         \
  if (d == D && kv_type == 1) FAT_PAGED_LAUNCH(__nv_bfloat16, D, 1);           \
  if (d == D && kv_type == 2) FAT_PAGED_LAUNCH(__nv_bfloat16, D, 2);           \
  if (d == D && !is_fp16) FAT_PAGED_LAUNCH(__nv_bfloat16, D, 0);               \
  if (d == D) FAT_PAGED_LAUNCH(__half, D, 0)
  FAT_PAGED_D(512);
  FAT_PAGED_D(384);
#undef FAT_PAGED_D
#undef FAT_PAGED_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
