// Flash-attention backward, step 2 of 3: dQ, for Hopper (sm_90a) at head
// dims 384 and 512, hand-written CUDA C++.
//
// Replaces: flash_attention_tpu/ops/flash_bwd.py::_dq_kernel, its dense and
// its segmented pallas_call, at the head dims the JAX package pads d
// 257-512 to.
//
// Computes what flash_bwd_dq.cu computes (see there: S and P recomputed
// from the forward's LSE, dP = dO V^T, dS = P * (dP - D), dQ = scale dS K,
// the band, the softcap, GQA, the segmented instance, dead rows), at d 384
// and 512, where that kernel's design does not fit: Q and dO for 64 rows
// take 128 KB of shared memory at d 512 and one 64-row stage of K and V
// another 128 KB, over the CTA's 227 KB; and dQ for 64 rows in one
// warpgroup would be 64 x 512 fp32 / 128 threads = 256 registers a thread.
//
// What bounds it on the H100: the tensor cores (6 d FLOP a live score: Q
// K^T, dO V^T and dS K), as at d 128; with 32-row kv tiles each K/V byte
// brought in (mostly from L2: every CTA of a kv head reads the same K and
// V) feeds 64 rows' products.
//
// What the design does about it (FlashMLA's split of the output by
// columns, as flash_fwd_wide.cu splits O):
// * A CTA owns 64 query rows and runs three warpgroups. Warpgroup 0, the
//   producer, gives its registers away (setmaxnreg); one thread loads Q and
//   dO once and streams 32-row K and V tiles by TMA, K and V each in one
//   slot with its own full and empty mbarrier. Shared memory at d 512: Q
//   64 KB, dO 64 KB, K 32 KB, V 32 KB, two dS buffers 16 KB.
// * Consumer 0 computes dP = dO V^T and S = Q K^T (m64n32, k over d, both
//   operands K-major in shared memory; dP is hop::ss_chain at N 32, the
//   chain flash_bwd_di.cu sums D with at these head dims, so P * (dP - D)
//   cancels to exactly 0 where a row attends to one key), then P and dS
//   once for all 64 rows, releases V (so V(j + 1) loads while the dQ
//   products of tile j run), and writes dS, rounded to the input type,
//   into one of two dS buffers (K-major, swizzled).
// * The two consumers each own half of dQ's columns: n192 at d 384, n256 at
//   d 512, 96 or 128 fp32 registers a thread. Each issues dQ_half += dS
//   K_half with both operands in shared memory (dS K-major, K MN-major:
//   wgmma's transpose mode, no copy); K is released once both have.
// * Hand-off by named barriers, as in flash_fwd_wide.cu: consumer 0 arrives
//   on READY(buf) when dS(j) is in buffer j % 2; consumer 1 waits on it and
//   arrives on FREE(buf) once its product has read the buffer, which
//   consumer 0 waits for before it writes dS(j + 2) there.
// * Each CTA owns its rows over all of their kv tiles: dQ is written once,
//   with no atomics, so two runs are bit-identical. KV tiles wholly outside
//   the band are never loaded and only tiles that cross an edge are masked,
//   as in flash_bwd_dq.cu; the segmented instance (SEG) reads its tile
//   range from ops/segments.py at this kernel's tiles
//   (fat_flash_bwd_dq_wide_seg_tiles), and a second producer warp copies
//   each kv tile's ids and positions beside V (consumer 0 reads them until
//   it releases V).
// * Epilogue: each consumer writes scale * its half of dQ into the Q tile
//   (no longer read) in the swizzled layout and stores it with one TMA
//   store a 64-column box, which clips rows past sq.
//
// Left for later work: consumer 0 runs dP, S and the dS arithmetic in turn
// while consumer 1 waits, and K(j + 1) loads only once both dQ products of
// tile j are done, so the tensor cores idle during the arithmetic and the
// load; a second K slot, overlap of S(j + 1) with dS(j) K(j), a deeper ring
// at d 384 (where the shared memory has room for two stages), and 64-column
// kv tiles through two-CTA clusters sharing Q and dO.

#include "flash_bwd_dq_common.cuh"
#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

constexpr int BLOCK_M = 64;    // query rows per CTA
constexpr int BLOCK_N = 32;    // kv rows per tile
constexpr int NTHREADS = 384;  // producer + 2 consumer warpgroups
constexpr int BOX = 64;        // head-dim elements per TMA box (128 bytes)
constexpr int ROW = BOX * 2;   // bytes per box row
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;  // 128 * 40 + 256 * 232 <= 65536
// named barriers (0 is __syncthreads): consumer 0's own, then READY and
// FREE of the two dS buffers, the epilogue's, and consumer 1's own
constexpr int BAR_C0 = 1, BAR_READY = 2, BAR_FREE = 4, BAR_EPI = 6,
              BAR_C1 = 7;

template <int D, bool SEG = false>
struct Smem {
  static constexpr int Q_BYTES = BLOCK_M * D * 2;   // Q, and dO
  static constexpr int KV_BYTES = BLOCK_N * D * 2;  // a K or V tile
  // a dS buffer: one 64-column swizzled box of 64 rows, the first 32
  // columns used (a K-major wgmma operand of two k16 steps)
  static constexpr int DS_BYTES = BLOCK_M * ROW;
  static constexpr int DO_OFF = Q_BYTES;
  static constexpr int K_OFF = 2 * Q_BYTES;
  static constexpr int V_OFF = K_OFF + KV_BYTES;
  static constexpr int DS_OFF = V_OFF + KV_BYTES;  // two dS buffers
  static constexpr int BAR_OFF = DS_OFF + 2 * DS_BYTES;
  static constexpr int N_BARS = 5;  // q + do; k, v full; k, v empty
  // SEG: the V slot's kv ids, positions and their fat::SegSpan (int32)
  static constexpr int META_OFF = BAR_OFF + N_BARS * 8;
  static constexpr int META_INTS = SEG ? 2 * BLOCK_N + 4 : 0;
  // slack to align the tiles to 1024 bytes, the swizzle's period
  static constexpr int BYTES = META_OFF + META_INTS * 4 + 1024;
  static_assert(BYTES <= 232448, "over the CTA's shared memory");
};

// dS, rounded to T, into a dS buffer in the 128-byte swizzle a K-major
// wgmma operand reads (row r's 16-byte chunk k at r * 128 + (k ^ r % 8) *
// 16; chunks 0-3, the tile's 32 columns): thread (warp, g, t) holds rows
// 16 warp + g and + 8.
template <typename T>
__device__ __forceinline__ void store_ds(uint8_t* p,
                                         const float (&sc)[BLOCK_N / 2],
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

// dQ_half += dS K_half: dS (64 x 32, K-major) and the consumer's DH columns
// of K (MN-major) in shared memory; one wgmma chain, committed and not
// waited for.
template <typename T, int DH>
__device__ __forceinline__ void issue_dsk(float (&acc)[DH / 2], uint32_t ds_s,
                                          uint32_t k_half) {
  hop::fence_regs(acc);
  hop::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BLOCK_N / 16; ++kk)
    hop::WgmmaSs<T, DH, 0, 1>::ss(
        acc, hop::desc_sw128(ds_s + kk * 32, 16, 1024),
        hop::desc_sw128(k_half + kk * 16 * ROW, BLOCK_N * ROW, 1024), 1);
  hop::wgmma_commit();
}

template <typename T, int D, bool CAP, bool SEG>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_bwd_dq_wide_kernel(const __grid_constant__ CUtensorMap q_map,
                         const __grid_constant__ CUtensorMap k_map,
                         const __grid_constant__ CUtensorMap v_map,
                         const __grid_constant__ CUtensorMap do_map,
                         const __grid_constant__ CUtensorMap dq_map,
                         const float* __restrict__ lse,
                         const float* __restrict__ di, int sq, int sk, int h,
                         int group, float scale, float scale_log2, int left,
                         int right, float cap_scale, float cap_log2,
                         const fat::Seg seg) {
  using L = Smem<D, SEG>;
  constexpr int DH = D / 2;  // dQ columns a consumer owns
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (hop::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = q_full + 2;
  uint64_t* k_empty = q_full + 3;
  uint64_t* v_empty = q_full + 4;

  // longest causal rows first: the last query block has the most kv tiles
  const int m_block = gridDim.z - 1 - blockIdx.z;
  const int head = blockIdx.x;
  const int batch = blockIdx.y;
  const int m_lo = m_block * BLOCK_M;
  const int off = sk - sq;  // lower-right offset of the band
  // kv tiles t_begin + j, j < n_tiles: from the tile holding the first
  // row's left edge to the last row's right edge (rows past sq clamped:
  // they are never stored), or with SEG the range of ops/segments.py
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
    hop::mbar_init(q_full, 1);
    hop::mbar_init(k_full, 1);
    hop::mbar_init(v_full, SEG ? 1 + 32 : 1);  // SEG: the meta warp
    hop::mbar_init(k_empty, 8);  // every consumer warp
    hop::mbar_init(v_empty, 4);  // consumer 0's warps
    hop::mbar_fence_init();
  }
  __syncthreads();

  if (role == 0) {
    // ---- producer ----
    hop::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      hop::prefetch_map(&q_map);
      hop::prefetch_map(&do_map);
      hop::prefetch_map(&k_map);
      hop::prefetch_map(&v_map);
      const int kvh = head / group;
      hop::mbar_expect_tx(q_full, 2 * L::Q_BYTES);
#pragma unroll
      for (int c = 0; c < D / BOX; ++c) {
        hop::tma_load_4d(smem + c * BLOCK_M * ROW, &q_map, q_full, c * BOX,
                         head, m_lo, batch);
        hop::tma_load_4d(smem + L::DO_OFF + c * BLOCK_M * ROW, &do_map, q_full,
                         c * BOX, head, m_lo, batch);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const uint32_t prev = (j - 1) & 1;  // tile j - 1's phase
        const int n0 = (t_begin + j) * BLOCK_N;
        // V first: consumer 0 releases it before the dQ products of the
        // tile before, which hold K
        if (j > 0) hop::mbar_wait(v_empty, prev);
        hop::mbar_expect_tx(v_full, L::KV_BYTES);
#pragma unroll
        for (int c = 0; c < D / BOX; ++c)
          hop::tma_load_4d(smem + L::V_OFF + c * BLOCK_N * ROW, &v_map, v_full,
                           c * BOX, kvh, n0, batch);
        if (j > 0) hop::mbar_wait(k_empty, prev);
        hop::mbar_expect_tx(k_full, L::KV_BYTES);
#pragma unroll
        for (int c = 0; c < D / BOX; ++c)
          hop::tma_load_4d(smem + L::K_OFF + c * BLOCK_N * ROW, &k_map, k_full,
                           c * BOX, kvh, n0, batch);
      }
    } else if constexpr (SEG) {
      if (threadIdx.x / 32 == 1) {
        // each kv tile's ids, positions and span into the V slot's
        // metadata, read from global memory a tile ahead of the slot's
        // release
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
          if (j > 0) hop::mbar_wait(v_empty, (j - 1) & 1);
          fat::seg_store(reinterpret_cast<int*>(smem + L::META_OFF), ids, pss,
                         span, lane);
          hop::mbar_arrive(v_full);
          if (j + 1 < n_tiles)
            fat::seg_fetch(kv_seg, kv_pos, (t_begin + j + 1) * BLOCK_N, sk,
                           fat::KV_PAD_SEG, lane, ids, pss);
        }
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
  const uint32_t k_s = hop::smem_u32(smem + L::K_OFF);
  // this consumer's DH columns of the K slot: boxes wg * DH / 64 on
  const uint32_t k_half = k_s + wg * (DH / BOX) * BLOCK_N * ROW;
  const uint32_t ds_s = hop::smem_u32(smem + L::DS_OFF);

  float acc[DH / 2];  // this consumer's half of dQ, unscaled
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;

  if (wg == 0) {
    const int w0 = m_lo + warp * 16;  // this warp's first row
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
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const long long idx = ((long long)batch * h + head) * sq + rw.row[r];
      // a row past sq is never stored: P = 0 keeps it finite
      rw.lse2[r] = rw.row[r] < sq ? lse[idx] * fat::LOG2E : CUDART_INF_F;
      rw.d[r] = rw.row[r] < sq ? di[idx] : 0.f;
    }
    const int* meta = reinterpret_cast<const int*>(smem + L::META_OFF);
    const uint32_t q_s = hop::smem_u32(smem);
    const uint32_t do_s = hop::smem_u32(smem + L::DO_OFF);
    const uint32_t v_s = hop::smem_u32(smem + L::V_OFF);
    float sc[BLOCK_N / 2];  // S, then P, then dS in fp32
    float dp[BLOCK_N / 2];  // dP
    hop::mbar_wait(q_full, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int buf = j & 1;
      const int n0 = (t_begin + j) * BLOCK_N;
      // dP first: V(j) was loaded while the dQ products of tile j - 1 ran,
      // K(j) only once they were done
      hop::mbar_wait(v_full, j & 1);
      hop::ss_chain<T, BLOCK_N, D>(dp, do_s, BLOCK_M, v_s, BLOCK_N);
      hop::wgmma_commit();
      hop::mbar_wait(k_full, j & 1);
      hop::ss_chain<T, BLOCK_N, D>(sc, q_s, BLOCK_M, k_s, BLOCK_N);
      hop::wgmma_commit();
      hop::wgmma_wait<0>();
      hop::fence_regs(dp);
      hop::fence_regs(sc);
      if constexpr (!CAP) probs<SEG, BLOCK_N>(sc, n0, rw, sr, meta);
      if constexpr (CAP)
        dscores_cap<SEG, BLOCK_N>(sc, dp, n0, rw, sr, meta);
      else
        dscores<BLOCK_N>(sc, dp, rw);
      __syncwarp();  // every lane has read the V slot's metadata
      if (lane == 0) hop::mbar_arrive(v_empty);
      // buffer buf was last read by consumer 1's dS(j - 2) K(j - 2)
      if (j >= 2) hop::named_sync(BAR_FREE + buf, 256);
      store_ds<T>(smem + L::DS_OFF + buf * L::DS_BYTES, sc, warp, g, t);
      hop::fence_async_smem();  // dS is read by wgmma (async proxy)
      hop::named_sync(BAR_C0, 128);
      hop::named_arrive(BAR_READY + buf, 256);
      issue_dsk<T, DH>(acc, ds_s + buf * L::DS_BYTES, k_half);
      hop::wgmma_wait<0>();
      hop::fence_regs(acc);
      if (lane == 0) hop::mbar_arrive(k_empty);
    }
    // consumer 1's releases of the last two buffers
    for (int j = max(0, n_tiles - 2); j < n_tiles; ++j)
      hop::named_sync(BAR_FREE + (j & 1), 256);
  } else {
    for (int j = 0; j < n_tiles; ++j) {
      const int buf = j & 1;
      hop::named_sync(BAR_READY + buf, 256);
      hop::mbar_wait(k_full, j & 1);
      issue_dsk<T, DH>(acc, ds_s + buf * L::DS_BYTES, k_half);
      hop::wgmma_wait<0>();
      hop::fence_regs(acc);
      if (lane == 0) hop::mbar_arrive(k_empty);
      hop::named_arrive(BAR_FREE + buf, 256);
    }
  }

  // epilogue: Q is no longer read (consumer 0's S chains are done, and its
  // Q load was waited for): this consumer's half of scale * dQ into its
  // boxes of the Q tile, in the swizzled layout the dQ map stores from
  hop::named_sync(BAR_EPI, 256);
  uint8_t* boxes = smem + wg * (DH / BOX) * BLOCK_M * ROW;
#pragma unroll
  for (int nt = 0; nt < DH / 8; ++nt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = warp * 16 + g + 8 * r;
      const int chunk = (nt % 8) ^ (row & 7);
      *reinterpret_cast<uint32_t*>(boxes + (nt / 8) * BLOCK_M * ROW +
                                   row * ROW + chunk * 16 + t * 4) =
          fat::Mma<T>::pack(acc[4 * nt + 2 * r] * scale,
                            acc[4 * nt + 2 * r + 1] * scale);
    }
  }
  hop::fence_async_smem();
  hop::named_sync(wg == 0 ? BAR_C0 : BAR_C1, 128);
  if (tid == 0) {
#pragma unroll
    for (int c = 0; c < DH / BOX; ++c)
      hop::tma_store_4d(&dq_map, boxes + c * BLOCK_M * ROW, wg * DH + c * BOX,
                        head, m_lo, batch);
    hop::tma_store_wait();
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
  if ((rc = hop::make_map_bshd(&qm, q, fp16, b, sq, h, D, st, BLOCK_M)) ||
      (rc = hop::make_map_bshd(&km, k, fp16, b, sk, hk, D, st + 3, BLOCK_N)) ||
      (rc = hop::make_map_bshd(&vm, v, fp16, b, sk, hk, D, st + 6, BLOCK_N)) ||
      (rc = hop::make_map_bshd(&dm, dout, fp16, b, sq, h, D, st + 9, BLOCK_M)) ||
      (rc = hop::make_map_bshd(&dqm, dq, fp16, b, sq, h, D, dq_st, BLOCK_M)))
    return rc;
  auto kernel = cap_scale != 0.f ? flash_bwd_dq_wide_kernel<T, D, true, SEG>
                                 : flash_bwd_dq_wide_kernel<T, D, false, SEG>;
  constexpr int bytes = Smem<D, SEG>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(h, b, (sq + BLOCK_M - 1) / BLOCK_M);
  kernel<<<grid, NTHREADS, bytes, stream>>>(
      qm, km, vm, dm, dqm, lse, di, sq, sk, h, h / hk, scale,
      scale * fat::LOG2E, fat::band_side(left), fat::band_side(right),
      cap_scale, cap_log2, seg);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// fat_flash_bwd_dq's interface (flash_bwd_dq.cu) at d 384 and 512.
int fat_flash_bwd_dq_wide(const void* q, const void* k, const void* v,
                          const void* dout, const void* lse, const void* di,
                          void* dq, int b, int sq, int sk, int h, int hk,
                          int d, const long long* strides, float scale,
                          int left, int right, float cap_scale,
                          float cap_log2, int is_fp16, const void* seg,
                          void* stream) {
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
  if (d == 512 && !is_fp16) FAT_DQ_LAUNCH(__nv_bfloat16, 512);
  if (d == 512) FAT_DQ_LAUNCH(__half, 512);
  if (d == 384 && !is_fp16) FAT_DQ_LAUNCH(__nv_bfloat16, 384);
  if (d == 384) FAT_DQ_LAUNCH(__half, 384);
#undef FAT_DQ_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

// The segmented instance's tiles at head dim d: out[0] query rows a CTA
// owns, out[1] kv rows a streamed tile holds.
int fat_flash_bwd_dq_wide_seg_tiles(int d, int* out) {
  if (d != 384 && d != 512) return static_cast<int>(cudaErrorInvalidValue);
  out[0] = BLOCK_M;
  out[1] = BLOCK_N;
  return 0;
}

}  // extern "C"
