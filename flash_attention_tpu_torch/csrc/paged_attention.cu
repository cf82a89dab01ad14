// Paged-attention decode for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces: flash_attention_tpu/ops/paged_attention.py::_paged_attn_kernel
// (the Pallas TPU kernel launched by paged_attention).
//
// One new query token per sequence attends to its cached K/V, which lie in
// fixed-size pages anywhere in a layer-stacked pool (L, hk, P, page_size, d).
// A row's page table maps its i-th page of tokens to a physical page. Rows
// with length <= 0 write zeros. Lengths past the table's width are clamped to
// it; page ids must lie in [0, P) (the engine pads tables with its trash
// page, which several rows may share). bf16 or fp16, d 64, 128 or 256, GQA
// groups of up to 8 query heads per kv head. With a sliding window W the
// query sees the tokens [max(len - W, 0), len) only; a table entry whose page holds no
// such token may be a hole (-1 or any other id) and is never read. The
// softcap instance (CAP) squashes scaled scores to cap tanh(s / cap) as
// flash_fwd.cu does.
//
// What bounds it on the H100: bytes. Each cached token costs 2 * d * 2 bytes
// of K and V and only 4 * d * group FLOP, about group FLOP per byte, far below
// the ~295 FLOP/byte where bf16 tensor cores would become the limit: 67 MB
// at 8 rows of 1..4096 tokens (Llama-3-8B's 8 kv heads) is 20 us at 3.35
// TB/s. What stands between a kernel and that bound is latency: a (row, kv
// head) pair streamed by one CTA lasts as long as its longest row, and loads
// issued only after a dependent page-table read leave the memory idle.
//
// What the design does about it:
// * A split over the sequence (flash-decoding). A pair's tokens are cut into
//   chunks of chunk_tiles 64-token tiles; each (chunk, kv head, row) is one
//   CTA, two resident a SM. The chunking comes from the table's width, b, hk
//   and the SM count on the host (ops/paged_attention.py::plan), never from
//   lengths, so the call reads nothing back and can be captured in a CUDA
//   graph. A CTA whose chunk starts past its row's length exits at once.
//   With a window, a pair's chunks start at the 64-token tile that holds the
//   window's first token, so the plan covers ceil(W / 64) + 1 tiles a pair
//   instead of the table's width, and no tile wholly behind the window is
//   loaded.
// * Pages by TMA through an mbarrier ring. Warp 4, the first of a producer
//   warpgroup that gives its registers to the consumers (setmaxnreg),
//   issues the loads: its lanes read the tile's page ids in parallel, ahead
//   of waiting for a free stage, and issue one TMA load per box of box_rows
//   tokens (a power of two that divides the page size, at most 64) and 64
//   columns, from a 3-D map over the pool viewed as (L hk P, page_size, d),
//   with the 128-byte swizzle. The maps are encoded once per pool and cached.
//   Boxes past the row's length, or wholly before the window, load an
//   out-of-range page, which TMA fills with zeros without reading memory, so
//   every stage completes the same byte count; the page id of such a box is
//   never used, so a hole in the table is never turned into a coordinate.
//   A ring of STAGES stages (96 KB a CTA, 192 KB a SM; at d 256 2 stages,
//   128 KB, 1 CTA a SM) keeps the SM's loads in flight while earlier tiles
//   are consumed.
// * The group's products on tensor cores. Warps 0-3 are one consumer
//   warpgroup: the group's query heads are the M side of wgmma m64 (rows
//   past the group are zeros), held in registers as the A operand of S =
//   Q K^T against the K tile (K-major; at d 256 a 64-row tile in shared
//   memory, see Cfg), and P stays in registers as the A
//   operand of O += P V, V read MN-major. The tensor work this wastes on the
//   zero rows is hidden behind the loads. Only warp 0 holds live rows, so
//   only it runs the online softmax (fp32, log2 domain).
// * A combine in a fixed order. A row that fits in one chunk writes its
//   output directly. Otherwise each chunk writes an fp32 partial (m, l and
//   the unnormalised O of the group) to a workspace and counts itself on
//   the pair's counter; the CTA that completes the count resets it to 0 and
//   merges the partials in chunk order. No floating-point atomics: repeats
//   are bit-identical whichever CTA merges.
//
// Exactness: scores are scaled into the log2 domain and rounded before the
// max is subtracted, so a row of length 1 gets exp2(0) = 1 and O equal to
// that token's V bit for bit.
//
// The quantized cache (instances Q = 1, int8, and Q = 2, fp8 e4m3; bf16 q,
// page_size 128): pages hold one byte an element, and each page has an fp32
// (8, 128) scale tile whose lane t holds token t's scale. The math is the TPU
// kernel's: the scores are scaled by kscale[t] (before the softcap and the
// mask) and P by vscale[t] before it is rounded to bf16 for P V; the scales
// are never applied to K or V. Per 64-token tile the producer TMA-loads the
// 8-bit K and V tiles (unswizzled rows, boxes of up to 128 bytes a row) and
// the tile's 64 scales from row 0 of the page's K and V scale tiles (256
// contiguous bytes each; the other 7 rows are never read) into the stage. The
// consumer warpgroup converts the 8-bit tiles to bf16 (exact for int8 and
// e4m3) in one shared buffer in the 128-byte swizzle the bf16 instances' TMA
// writes, fences the async proxy, and runs the same wgmma chains on it. The
// bytes a cached token costs fall from 4 d to 2 d + 8, but on the H100 these
// instances are bound by the conversion pass, which no load overlaps inside
// a CTA, not by the bytes (PERF.md).
//
// Left for later work: the zero rows of the M side (a token-major layout
// would waste no tensor work but needs a reduction over tokens across the
// warpgroup; for the quantized cache it would also put the dequantised K on
// the M side, as qmm.cu does for weights, with no conversion pass through
// shared memory), and a persistent schedule in place of CTAs that exit at
// once.

#include <atomic>
#include <climits>
#include <mutex>

#include <cuda_fp8.h>

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

constexpr int TILE = 64;         // tokens per ring stage
constexpr int BOX = 64;          // head-dim elements per TMA box (128 bytes)
constexpr int ROW = BOX * 2;     // bytes per box row
constexpr int NCONSUMERS = 128;  // one consumer warpgroup
constexpr int NTHREADS = 2 * NCONSUMERS;  // and a producer warpgroup
// At d 64 and 128, 2 CTAs of 256 threads launch with 128 registers a thread;
// setmaxnreg moves them from the producer to the consumers: 128 * 40 + 128 *
// 216 = 256 * 128
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 216;
constexpr int MAX_GROUP = 8;
constexpr int MAX_CHUNKS = 64;   // ops/paged_attention.py::plan stays within

// The CTA by head dim. At d 64 and 128: 2 CTAs a SM, 96 KB of ring each,
// and Q in registers as wgmma's A operand (D / 4 registers a thread). At
// d 256 those registers, O (128) and S (32) would not fit 216, and two
// stages of K and V take 128 KB: 1 CTA a SM, whose 256 threads launch with
// every register they can use (no setmaxnreg), 2 stages, and Q as a 64-row
// K-major tile in shared memory (Q_SMEM; rows past the group zeros).
// The quantized instances' stages are half the bytes plus the scales, and
// the bf16 buffer they convert into takes one bf16 stage: 4 stages at d 64
// and 128 (53 and 103 KB), 3 at d 256 (195 KB with Q).
template <int D>
struct Cfg {
  static constexpr bool Q_SMEM = D == 256;
  static constexpr int CTAS_PER_SM = Q_SMEM ? 1 : 2;
  static constexpr int STAGES = Q_SMEM ? 2 : 3 * 128 / D;  // 96 or 128 KB
  static constexpr int QUANT_STAGES = Q_SMEM ? 3 : 4;
};

// Q: 0 pages in T; 1 int8 pages; 2 fp8 e4m3 pages (with scale tiles)
template <int D, int Q = 0>
struct Smem {
  static constexpr bool QUANT = Q != 0;
  static constexpr int STAGES = QUANT ? Cfg<D>::QUANT_STAGES : Cfg<D>::STAGES;
  static constexpr int TILE_BYTES = TILE * D * (QUANT ? 1 : 2);
  // K, then V, then (QUANT) the tile's 64 K scales and 64 V scales, the
  // stage padded to the swizzle's 1024-byte period
  static constexpr int SCALE_OFF = 2 * TILE_BYTES;
  static constexpr int STAGE_BYTES = 2 * TILE_BYTES + (QUANT ? 1024 : 0);
  static constexpr int TX_BYTES = 2 * TILE_BYTES + (QUANT ? 2 * TILE * 4 : 0);
  // QUANT: the K and V tiles converted to bf16, as the bf16 instances' stage
  static constexpr int CVT_OFF = STAGES * STAGE_BYTES;
  static constexpr int CVT_BYTES = QUANT ? 2 * TILE * D * 2 : 0;
  static constexpr int Q_OFF = CVT_OFF + CVT_BYTES;  // Q_SMEM: 64 rows of Q
  static constexpr int Q_BYTES = Cfg<D>::Q_SMEM ? 64 * D * 2 : 0;
  static constexpr int BAR_OFF = Q_OFF + Q_BYTES;
  static constexpr int W_OFF = BAR_OFF + 2 * STAGES * 8;  // merge weights
  static constexpr int INV_OFF = W_OFF + MAX_CHUNKS * MAX_GROUP * 4;
  static constexpr int FLAG_OFF = INV_OFF + MAX_GROUP * 4;
  // slack to align the ring to 1024 bytes, the swizzle's period
  static constexpr int BYTES = FLAG_OFF + 16 + 1024;
};

// Floats of one chunk's partial: O (MAX_GROUP x D), then m and l.
template <int D>
constexpr int PARTIAL = MAX_GROUP * D + 2 * MAX_GROUP;

// Bytes a row of an 8-bit tile's TMA box: the whole row up to 128
__host__ __device__ constexpr int qbox_row(int d) { return d < 128 ? d : 128; }

// Two 8-bit elements (bytes 2 half and 2 half + 1 of w) as a bf16 pair,
// exactly. int8: the byte with its sign bit flipped is the mantissa of 2^23 +
// (x + 128), from which 2^23 + 128 is subtracted (a byte permute and an add a
// value, where a conversion instruction runs at a quarter of the add's rate).
template <int Q>
__device__ __forceinline__ uint32_t dequant_pair(uint32_t w, int half) {
  if constexpr (Q == 1) {
    const uint32_t u = w ^ 0x80808080u;
    return fat::Mma<__nv_bfloat16>::pack(
        __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + 2 * half)) -
            8388736.f,
        __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541 + 2 * half)) -
            8388736.f);
  } else {
    const __half2 h2 = __nv_cvt_fp8x2_to_halfraw2(
        static_cast<__nv_fp8x2_storage_t>(w >> (16 * half)), __NV_E4M3);
    const float2 f = __half22float2(h2);
    return fat::Mma<__nv_bfloat16>::pack(f.x, f.y);
  }
}

// An 8-bit K or V tile of the ring (TILE rows of D bytes, in boxes of
// qbox_row(D) bytes a row) to bf16 at dst, in the 128-byte swizzle a bf16
// TMA load writes: 64-element boxes of TILE rows, row r's 16-byte chunk k at
// r * 128 + (k ^ r % 8) * 16. The consumer warpgroup's 128 threads each take
// 16 bytes a step.
template <int D, int Q>
__device__ __forceinline__ void dequant_tile(const uint8_t* src, uint8_t* dst,
                                             int tid) {
  constexpr int IN_ROW = qbox_row(D);
  constexpr int ROW_CHUNKS = D / 16;
#pragma unroll
  for (int it = 0; it < TILE * ROW_CHUNKS / NCONSUMERS; ++it) {
    const int i = tid + it * NCONSUMERS;
    const int r = i / ROW_CHUNKS, c = (i % ROW_CHUNKS) * 16;  // row, byte
    const uint4 x = *reinterpret_cast<const uint4*>(
        src + (c / IN_ROW) * TILE * IN_ROW + r * IN_ROW + c % IN_ROW);
    const uint4 lo = make_uint4(dequant_pair<Q>(x.x, 0), dequant_pair<Q>(x.x, 1),
                                dequant_pair<Q>(x.y, 0), dequant_pair<Q>(x.y, 1));
    const uint4 hi = make_uint4(dequant_pair<Q>(x.z, 0), dequant_pair<Q>(x.z, 1),
                                dequant_pair<Q>(x.w, 0), dequant_pair<Q>(x.w, 1));
    // elements c .. c + 15: box c / 64, chunks (c % 64) / 8 and the next
    uint8_t* row = dst + (c / BOX) * TILE * ROW + r * ROW;
    const int k = (c % BOX) / 8;
    *reinterpret_cast<uint4*>(row + ((k ^ (r & 7)) * 16)) = lo;
    *reinterpret_cast<uint4*>(row + (((k + 1) ^ (r & 7)) * 16)) = hi;
  }
}

template <typename T, int D, bool CAP, int Q>
__global__ void __launch_bounds__(NTHREADS, Cfg<D>::CTAS_PER_SM)
paged_attn_kernel(const __grid_constant__ CUtensorMap k_map,
                  const __grid_constant__ CUtensorMap v_map,
                  const T* __restrict__ q, const int* __restrict__ lengths,
                  const int* __restrict__ tables, T* __restrict__ out,
                  float* __restrict__ ws, int* __restrict__ counters, int h,
                  int hk, int page_size, int box_rows, int pages_per_seq,
                  int total_pages, int pages_all, int layer, int chunk_tiles,
                  int window, float scale_log2, float cap_scale,
                  float cap_log2,
                  const __grid_constant__ CUtensorMap ks_map,
                  const __grid_constant__ CUtensorMap vs_map) {
  using S = Smem<D, Q>;
  constexpr bool QUANT = S::QUANT;
  constexpr int STAGES = S::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (hop::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::BAR_OFF);
  uint64_t* empty = full + STAGES;

  const int chunk = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int group = h / hk;
  const int len = min(lengths[b], pages_per_seq * page_size);
  // the first live token, and the tile the pair's first chunk starts at
  const int start = window > 0 ? max(len - window, 0) : 0;
  const int tile0 = start / TILE;
  const int tok0 = (tile0 + chunk * chunk_tiles) * TILE;
  const long long row0 = (long long)b * h + (long long)kvh * group;
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
      hop::mbar_init(&empty[s], 4);  // one arrival per consumer warp
    }
    hop::mbar_fence_init();
  }
  __syncthreads();

  // warpgroup index, warp-uniform to the compiler (the shuffle): each role
  // is one branch that runs to the end, with its own setmaxnreg limit
  const int role = __shfl_sync(0xffffffff, threadIdx.x / NCONSUMERS, 0);
  if (role == 1) {
    // ---- producer: the warpgroup's first warp ----
    if constexpr (!Cfg<D>::Q_SMEM) hop::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x >= NCONSUMERS + 32) return;
    const int lane = threadIdx.x % 32;
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
      }
      constexpr int IN_ROW = qbox_row(D);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        const int t0 = tok0 + j * TILE;
        if (lane == 0) {
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
#pragma unroll
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

  // ---- consumer warpgroup ----
  if constexpr (!Cfg<D>::Q_SMEM) hop::setmaxnreg_inc<CONSUMER_REGS>();
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;  // fragment row group: head g of the group
  const int t = lane & 3;   // thread in its row group
  const bool live_row = warp == 0 && g < group;

  // Q as wgmma's A operand: row g of warp 0 is the group's head g; rows
  // g + 8 and the other warps' rows are zeros. In registers, as m16n8k16 A
  // fragments (Q_SMEM: none), or as a K-major tile of 64 rows in the 128-byte
  // swizzle (row r's 16-byte chunk k of a box at r * 128 + (k ^ r % 8) * 16)
  uint32_t qa[Cfg<D>::Q_SMEM ? 1 : D / 16][4];
  const uint32_t q_s = hop::smem_u32(smem + S::Q_OFF);
  if constexpr (Cfg<D>::Q_SMEM) {
    for (int i = tid; i < 64 * D / 8; i += NCONSUMERS) {
      const int c = i % 8, r = (i / 8) % 64, box = i / 512;
      const uint4 x = r < group ? *reinterpret_cast<const uint4*>(
                                      q + (row0 + r) * D + box * BOX + c * 8)
                                : make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(smem + S::Q_OFF + box * 64 * ROW + r * ROW +
                                ((c ^ (r & 7)) * 16)) = x;
    }
    hop::fence_async_smem();  // the tile is read by wgmma (async proxy)
    hop::named_sync(1, NCONSUMERS);
  } else {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t* qr = reinterpret_cast<const uint32_t*>(
          q + (row0 + g) * D + kk * 16 + 2 * t);
      qa[kk][0] = live_row ? qr[0] : 0u;
      qa[kk][1] = 0u;
      qa[kk][2] = live_row ? qr[4] : 0u;
      qa[kk][3] = 0u;
    }
  }

  float acc[D / 2];        // O, unnormalised
  float sc[TILE / 2];      // S, then P in fp32
  uint32_t pa[TILE / 16][4];  // P as the A operand of P V
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < TILE / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) pa[kk][e] = 0u;
  float m_r = -CUDART_INF_F;  // row g's running max (log2 domain)
  float l_r = 0.f;            // this thread's share of row g's sum

  const uint32_t ring = hop::smem_u32(smem);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % STAGES;
    uint32_t ks = ring + s * S::STAGE_BYTES;
    uint32_t vs = ks + S::TILE_BYTES;
    hop::mbar_wait(&full[s], (j / STAGES) & 1);
    // QUANT: the stage's tile scales (K, then V), and its K and V in bf16
    const float* tile_scales =
        reinterpret_cast<const float*>(smem + s * S::STAGE_BYTES + S::SCALE_OFF);
    if constexpr (QUANT) {
      // the previous tile's products are complete (each warp waited for
      // them), so the bf16 buffer is free
      uint8_t* k8 = smem + s * S::STAGE_BYTES;
      dequant_tile<D, Q>(k8, smem + S::CVT_OFF, tid);
      dequant_tile<D, Q>(k8 + S::TILE_BYTES, smem + S::CVT_OFF + TILE * D * 2,
                         tid);
      hop::fence_async_smem();  // read by wgmma (async proxy)
      hop::named_sync(1, NCONSUMERS);
      ks = ring + S::CVT_OFF;
      vs = ks + TILE * D * 2;
    }
    // S = Q K^T (the tile K-major), started from zero
    if constexpr (Cfg<D>::Q_SMEM) {
      hop::ss_chain<T, TILE, D>(sc, q_s, 64, ks, TILE);
    } else {
#pragma unroll
      for (int i = 0; i < TILE / 2; ++i) sc[i] = 0.f;
      hop::fence_regs(sc);
      hop::fence_regs(qa);
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hop::WgmmaRs<T, TILE>::rs(
            sc, qa[kk],
            hop::desc_sw128(ks + (kk / 4) * TILE * ROW + (kk % 4) * 32, 16,
                            1024));
    }
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(sc);
    if (warp == 0) {
      // the online softmax of row g over the tile's 64 tokens; thread t
      // holds columns 8 nn + 2 t and + 1 in sc[4 nn] and sc[4 nn + 1]
      const int t0 = tok0 + j * TILE;
      // live columns [lo, hi) counted from the thread's first
      const int hi = len - t0 - 2 * t, lo = start - t0 - 2 * t;
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int nn = 0; nn < TILE / 8; ++nn) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = sc[4 * nn + e];
          if constexpr (QUANT) x *= tile_scales[8 * nn + 2 * t + e];
          if constexpr (CAP)
            x = cap_log2 * hop::tanh_exp2(x * cap_scale);
          else
            x = x * scale_log2;
          const int c = 8 * nn + e;
          sc[4 * nn + e] = c < hi && c >= lo ? x : -CUDART_INF_F;
          mx = fmaxf(mx, sc[4 * nn + e]);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, 2));
      // every tile has a live token, so the max is finite
      const float m_new = fmaxf(m_r, mx);
      const float alpha = hop::exp2_approx(m_r - m_new);
      float sum = 0.f;
#pragma unroll
      for (int nn = 0; nn < TILE / 8; ++nn) {
        sc[4 * nn] = hop::exp2_approx(sc[4 * nn] - m_new);
        sc[4 * nn + 1] = hop::exp2_approx(sc[4 * nn + 1] - m_new);
        sum += sc[4 * nn] + sc[4 * nn + 1];
      }
      l_r = l_r * alpha + sum;
      m_r = m_new;
      if (alpha != 1.f) {
#pragma unroll
        for (int i = 0; i < D / 2; ++i) acc[i] *= alpha;
      }
      // P of row g (QUANT: times vscale), rounded to T; row g + 8 stays zero
      if constexpr (QUANT) {
        const float* vsc = tile_scales + TILE;
#pragma unroll
        for (int nn = 0; nn < TILE / 8; ++nn) {
          sc[4 * nn] *= vsc[8 * nn + 2 * t];
          sc[4 * nn + 1] *= vsc[8 * nn + 2 * t + 1];
        }
      }
#pragma unroll
      for (int kk = 0; kk < TILE / 16; ++kk) {
        pa[kk][0] = fat::Mma<T>::pack(sc[8 * kk], sc[8 * kk + 1]);
        pa[kk][2] = fat::Mma<T>::pack(sc[8 * kk + 4], sc[8 * kk + 5]);
      }
    }
    // O += P V (V MN-major)
    hop::rs_chain<T, D, TILE / 16>(acc, pa, vs, TILE);
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(acc);
    hop::fence_regs(pa);
    if (lane == 0) hop::mbar_arrive(&empty[s]);
  }

  // ---- epilogue ----
  const int pair = b * hk + kvh;
  float* part = ws + ((long long)pair * gridDim.x + chunk) * PARTIAL<D>;
  if (warp == 0) {
    l_r += __shfl_xor_sync(0xffffffff, l_r, 1);
    l_r += __shfl_xor_sync(0xffffffff, l_r, 2);
    if (n_live == 1) {
      // the whole row is in this chunk: O = acc / l (l = 1 gives exactly 1)
      const float inv = __fdividef(1.f, l_r);
      if (g < group) {
        uint32_t* o = reinterpret_cast<uint32_t*>(out + (row0 + g) * D);
#pragma unroll
        for (int nt = 0; nt < D / 8; ++nt)
          o[nt * 4 + t] =
              fat::Mma<T>::pack(acc[4 * nt] * inv, acc[4 * nt + 1] * inv);
      }
      return;
    }
    if (g < group) {
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt)
        *reinterpret_cast<float2*>(part + g * D + nt * 8 + 2 * t) =
            make_float2(acc[4 * nt], acc[4 * nt + 1]);
      if (t == 0) {
        part[MAX_GROUP * D + g] = m_r;
        part[MAX_GROUP * D + MAX_GROUP + g] = l_r;
      }
    }
    __threadfence();
    __syncwarp();
    if (lane == 0) {
      const int done = atomicAdd(&counters[pair], 1);
      const int last = done == n_live - 1;
      if (last) {
        counters[pair] = 0;  // ready for the next call
        __threadfence();
      }
      *reinterpret_cast<int*>(smem + S::FLAG_OFF) = last;
    }
  }
  if (n_live == 1) return;
  hop::named_sync(1, NCONSUMERS);
  if (!*reinterpret_cast<volatile int*>(smem + S::FLAG_OFF)) return;

  // The last chunk of the pair merges every chunk's partial, in chunk
  // order. Weights first: 16 threads a head, each over every 16th chunk.
  const float* parts = ws + (long long)pair * gridDim.x * PARTIAL<D>;
  float* wts = reinterpret_cast<float*>(smem + S::W_OFF);  // [chunk][head]
  float* inv_l = reinterpret_cast<float*>(smem + S::INV_OFF);
  {
    const int gi = tid / 16, c0 = tid % 16;
    float mx = -CUDART_INF_F;
    for (int c = c0; c < n_live; c += 16)
      mx = fmaxf(mx, __ldcg(parts + c * PARTIAL<D> + MAX_GROUP * D + gi));
#pragma unroll
    for (int w = 8; w > 0; w >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, w));
    float lsum = 0.f;
    for (int c = c0; c < n_live; c += 16) {
      const float* pc = parts + c * PARTIAL<D> + MAX_GROUP * D;
      const float wt = hop::exp2_approx(__ldcg(pc + gi) - mx);
      lsum += __ldcg(pc + MAX_GROUP + gi) * wt;
      wts[c * MAX_GROUP + gi] = wt;
    }
#pragma unroll
    for (int w = 8; w > 0; w >>= 1)
      lsum += __shfl_xor_sync(0xffffffff, lsum, w);
    if (c0 == 0) inv_l[gi] = __fdividef(1.f, lsum);
  }
  hop::named_sync(1, NCONSUMERS);
  for (int i = tid; i < group * D; i += NCONSUMERS) {
    const int gi = i / D;
    float o = 0.f;
    for (int c = 0; c < n_live; ++c)
      o += __ldcg(parts + c * PARTIAL<D> + i) * wts[c * MAX_GROUP + gi];
    reinterpret_cast<uint16_t*>(out)[row0 * D + i] =
        fat::Mma<T>::pack(o * inv_l[gi], 0.f) & 0xffffu;
  }
}

// Tensor maps over one pool, by (pointer, shape, kind, box height): the
// engine allocates its pool once, so after the first call a launch encodes
// nothing. A map depends only on these, so a pool freed and another
// allocated at the same address with the same shape reuses a right map.
// kind: 0 bf16 pages, 1 fp16 pages, 2 8-bit pages, 3 fp32 scale tiles.
enum MapKind : int { BF16 = 0, FP16 = 1, BYTES8 = 2, SCALES = 3 };

struct MapKey {
  const void* ptr;
  int d, page_size, pages_all, kind, box_rows;
  bool operator==(const MapKey& o) const {
    return ptr == o.ptr && d == o.d && page_size == o.page_size &&
           pages_all == o.pages_all && kind == o.kind && box_rows == o.box_rows;
  }
};

constexpr int MAP_CACHE = 16;

// The quantized cache's maps, unswizzled: 8-bit pages as (L hk P, page_size,
// d) bytes in boxes of qbox_row(d) x box_rows x 1, and scale tiles as (L hk
// P) rows of 8 x 128 floats in boxes of 64 floats (a tile's scales, from row
// 0). Reads past the pool (a dead box's page) fill zeros.
int quant_map(CUtensorMap* map, const MapKey& key) {
  auto encode = hop::tensor_map_encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorSharedObjectSymbolNotFound);
  const bool pages = key.kind == BYTES8;
  cuuint64_t dims[3] = {cuuint64_t(pages ? key.d : 8 * 128),
                        cuuint64_t(pages ? key.page_size : key.pages_all),
                        cuuint64_t(key.pages_all)};
  cuuint64_t strides[2] = {cuuint64_t(pages ? key.d : 8 * 128 * 4),
                           cuuint64_t(key.page_size) * key.d};
  cuuint32_t box[3] = {cuuint32_t(pages ? qbox_row(key.d) : TILE),
                       cuuint32_t(pages ? key.box_rows : 1), 1};
  cuuint32_t elem[3] = {1, 1, 1};
  CUresult r = encode(
      map, pages ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      pages ? 3 : 2, const_cast<void*>(key.ptr), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

int pool_map(CUtensorMap* map, const MapKey& key) {
  static std::mutex mu;
  static MapKey keys[MAP_CACHE];
  static CUtensorMap maps[MAP_CACHE];
  static int used = 0, next = 0;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i)
    if (keys[i] == key) {
      *map = maps[i];
      return 0;
    }
  // (L hk P, page_size, d): one page of one head is page_size x d elements
  const int rc =
      key.kind >= BYTES8
          ? quant_map(map, key)
          : hop::make_map_3d(map, key.ptr, key.kind == FP16, key.d, key.page_size,
                             key.pages_all, (long long)key.d * 2,
                             (long long)key.page_size * key.d * 2, key.box_rows);
  if (rc) return rc;
  keys[next] = key;
  maps[next] = *map;
  next = (next + 1) % MAP_CACHE;
  used = used < MAP_CACHE ? used + 1 : used;
  return 0;
}

// Q: 0 pages in T; 1 int8 and 2 fp8 e4m3 pages with scale tiles ks, vs
template <typename T, int D, int Q>
int launch(const void* q, const void* kp, const void* vp, const void* ksp,
           const void* vsp, const int* lengths, const int* tables, void* out,
           float* ws, int* counters, int b, int h, int hk, int L, int layer,
           int total_pages, int page_size, int pages_per_seq, int chunk_tiles,
           int n_chunks, int window, float scale_log2, float cap_scale,
           float cap_log2, cudaStream_t stream) {
  constexpr bool fp16 = std::is_same_v<T, __half>;
  const long long pages_all = (long long)L * hk * total_pages;
  // the tiles a pair's chunks must cover: the table's, or with a window the
  // most tiles W tokens can touch
  long long need = ((long long)pages_per_seq * page_size + TILE - 1) / TILE;
  const long long span = (long long)(window + TILE - 1) / TILE + 1;
  if (window > 0 && span < need) need = span;
  if (pages_all >= INT_MAX || n_chunks > MAX_CHUNKS || chunk_tiles < 1 ||
      window < 0 || (long long)n_chunks * chunk_tiles < need ||
      (Q != 0 && page_size != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  // the largest power of two that divides the page size, at most a tile: a
  // box never crosses a page
  const int box_rows = min(TILE, page_size & -page_size);
  const int kind = Q != 0 ? BYTES8 : fp16 ? FP16 : BF16;
  CUtensorMap km, vm, ksm{}, vsm{};
  int rc;
  if ((rc = pool_map(&km, {kp, D, page_size, (int)pages_all, kind, box_rows})) ||
      (rc = pool_map(&vm, {vp, D, page_size, (int)pages_all, kind, box_rows})))
    return rc;
  if (Q != 0 &&
      ((rc = pool_map(&ksm, {ksp, D, page_size, (int)pages_all, SCALES, 1})) ||
       (rc = pool_map(&vsm, {vsp, D, page_size, (int)pages_all, SCALES, 1}))))
    return rc;
  auto kernel = cap_scale != 0.f ? paged_attn_kernel<T, D, true, Q>
                                 : paged_attn_kernel<T, D, false, Q>;
  // the shared-memory limit is raised once per device and instance
  static std::atomic<uint64_t> raised[2]{};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const uint64_t bit = uint64_t(1) << (dev & 63);
  std::atomic<uint64_t>& done = raised[cap_scale != 0.f];
  if (!(done.load() & bit)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<D, Q>::BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    done.fetch_or(bit);
  }
  dim3 grid(n_chunks, hk, b);
  kernel<<<grid, NTHREADS, Smem<D, Q>::BYTES, stream>>>(
      km, vm, static_cast<const T*>(q), lengths, tables, static_cast<T*>(out),
      ws, counters, h, hk, page_size, box_rows, pages_per_seq, total_pages,
      (int)pages_all, layer, chunk_tiles, window, scale_log2, cap_scale,
      cap_log2, ksm, vsm);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q, out: contiguous (b, h, d); k/v pages: contiguous (L, hk, P, ps, d);
// lengths (b,) and tables (b, pages_per_seq): contiguous int32. workspace:
// fp32, (b hk n_chunks) partials of (8 d + 16) floats (unused when n_chunks
// is 1); counters: b hk int32 zeros, left zero by every call. The chunks
// (n_chunks of chunk_tiles 64-token tiles) must cover pages_per_seq pages,
// or with a window (W > 0 tokens; 0 = none) ceil(W / 64) + 1 tiles, and
// h / hk must be at most 8. cap_scale = scale / cap and cap_log2 = cap
// log2(e) run the softcap instance; 0 and 0 the plain one. kv_type 0: the
// pages in q's type; 1 (int8) or 2 (fp8 e4m3): bf16 q, page size 128, and
// k/v scales contiguous (L, hk, P, 8, 128) fp32 (null otherwise).
int fat_paged_attention(const void* q, const void* k_pages, const void* v_pages,
                        const void* k_scales, const void* v_scales,
                        const void* lengths, const void* tables, void* out,
                        void* workspace, void* counters, int b, int h, int hk,
                        int d, int L, int layer, int total_pages, int page_size,
                        int pages_per_seq, int chunk_tiles, int n_chunks,
                        int window, float scale_log2, float cap_scale,
                        float cap_log2, int is_fp16, int kv_type, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  const int* tab = static_cast<const int*>(tables);
  float* ws = static_cast<float*>(workspace);
  int* cnt = static_cast<int*>(counters);
  if (h % hk || h / hk > MAX_GROUP || kv_type < 0 || kv_type > 2 ||
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
  FAT_PAGED_D(256);
  FAT_PAGED_D(128);
  FAT_PAGED_D(64);
#undef FAT_PAGED_D
#undef FAT_PAGED_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
