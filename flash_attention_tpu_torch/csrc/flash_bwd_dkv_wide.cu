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
// register file, so no CTA of 64 keys holds both; and K and V for 64 keys
// (128 KB) leave room for one stage of 32-row Q and dO tiles only.
//
// What bounds it on the H100: the tensor cores. The minimum is 8 d FLOP a
// live score (K Q^T, V dO^T, P^T dO, dS^T Q); this design does 12 d (below).
//
// What the design does about it: a grid split of the output columns.
// * Two CTAs share each block of 64 keys, one for each half of dK's and
//   dV's columns (DH = d / 2: 192 or 256). Each recomputes S^T and dP^T
//   over the full d (hence 12 d FLOP a score, not 8 d), and holds dV and dK
//   for its 64 keys and DH columns, split over its two consumers as the d-256
//   design of flash_bwd_dkv.cu (Cfg::SPLIT) splits them: consumer 0
//   computes S^T = K Q^T and P^T and holds dV, consumer 1 computes dP^T =
//   V dO^T and dS^T and holds dK, DH / 2 fp32 registers a thread, and P^T
//   (times 1 - t^2 under CAP) crosses from the first to the second through
//   an fp32 buffer in each ring stage under named barriers 3 and 4,
//   alternating by tile.
// * S^T and dP^T are m64n32 wgmma chains over d with both operands in
//   shared memory (K-major; dP^T is hop::ss_chain at N 32, the chain
//   flash_bwd_di.cu sums D with at these head dims, so P * (dP - D) cancels
//   to exactly 0 where a row attends to one key); P^T and dS^T, rounded to
//   the input type, are the register A operands of dV_half += P^T dO_half
//   and dK_half += dS^T Q_half, whose B operands are the dO and Q tiles'
//   DH columns read MN-major (wgmma's transpose mode, no copy).
// * Warpgroup 0, the producer, gives its registers away (setmaxnreg). One
//   thread loads the CTA's K and V once (128 KB at d 512) and streams 32-row
//   Q and dO tiles of every query head of the group through a ring of
//   STAGES stages (1 at d 512: 64 KB a stage; 2 at d 384); a second warp
//   copies each tile's LSE (in the log2 domain, +inf past sq), D and, SEG,
//   query ids and positions into the stage.
// * The group is summed inside the CTA, with no float atomics, so two runs
//   are bit-identical. Query tiles wholly outside the band are never loaded
//   and only tiles that cross an edge are masked, as in flash_bwd_dkv.cu;
//   the segmented instance reads its tile range from ops/segments.py at this
//   kernel's tiles (fat_flash_bwd_dkv_wide_seg_tiles), and an empty range
//   writes dK = dV = 0.
// * Epilogue: each consumer writes its half (dV, scale * dK) into the V or
//   K tile in shared memory, once both consumers' last products are done,
//   and stores it by TMA at the CTA's column offset, which clips rows past
//   sk.
//
// Left for later work: the recomputation (a split into dV and dK CTAs
// would do 10 d a score; 64-row query tiles through two-CTA clusters sharing
// K and V, 8 d), the one-stage ring at d 512 (each tile's loads are exposed),
// and the m64n32 products' lower rate.

#include "flash_bwd_dkv_common.cuh"
#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

constexpr int BLOCK_N = 64;    // key rows per CTA
constexpr int BLOCK_M = 32;    // query rows per streamed tile
constexpr int NTHREADS = 384;  // producer + 2 consumer warpgroups
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;  // 128 * 24 + 256 * 240 <= 65536

template <int D, bool SEG = false>
struct Smem {
  static constexpr int STAGES = D == 384 ? 2 : 1;  // depth of the Q/dO ring
  static constexpr int KV_BYTES = BLOCK_N * D * 2;  // K, and V
  static constexpr int T_BYTES = BLOCK_M * D * 2;   // a Q or dO tile
  static constexpr int V_OFF = KV_BYTES;            // K at 0
  static constexpr int Q_OFF = 2 * KV_BYTES;
  static constexpr int DO_OFF = Q_OFF + STAGES * T_BYTES;
  static constexpr int VEC_OFF = DO_OFF + STAGES * T_BYTES;
  // LSE, D and, SEG, the query ids and positions (int32), then the tile's
  // fat::SegSpan
  static constexpr int SPAN_INT = (SEG ? 4 : 2) * BLOCK_M;
  static constexpr int VEC_BYTES = (SPAN_INT + (SEG ? 4 : 0)) * 4;
  // each stage's P^T (or, with CAP, P^T (1 - t^2)) in fp32, from consumer 0
  // to consumer 1
  static constexpr int X_OFF = VEC_OFF + STAGES * VEC_BYTES;
  static constexpr int X_BYTES = BLOCK_N * BLOCK_M * 4;
  static constexpr int BAR_OFF = X_OFF + STAGES * X_BYTES;
  static constexpr int N_BARS = 1 + 2 * STAGES;  // k + v; tile full; empty
  // slack to align the tiles to 1024 bytes, the swizzle's period
  static constexpr int BYTES = BAR_OFF + N_BARS * 8 + 1024;
  static_assert(BYTES <= 232448, "over the CTA's shared memory");
};

template <typename T, int D, bool CAP, bool SEG>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_bwd_dkv_wide_kernel(const __grid_constant__ CUtensorMap q_map,
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
  constexpr int STAGES = L::STAGES;
  constexpr int DH = D / 2;  // dK and dV columns a CTA owns
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (hop::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + STAGES;

  const int kvh = blockIdx.x;
  const int batch = blockIdx.y;
  // the first key blocks see the most rows; the two halves of a block's
  // columns are neighbours in the grid
  const int n_block = blockIdx.z >> 1;
  const int half = blockIdx.z & 1;
  const int n0 = n_block * BLOCK_N;
  const int off = sk - sq;  // lower-right offset of the band
  // query rows that see a key of this block, the band mirrored, as in
  // flash_bwd_dkv.cu; producer and consumers count the same tiles
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
    const int blk = batch * (gridDim.z >> 1) + n_block;
    tl.m_first = seg.lo[blk] * BLOCK_M;
    tl.n_m = max(0, seg.hi[blk] - seg.lo[blk] + 1);
  }
  const int n_tiles = tl.count(group);

  const int role = __shfl_sync(0xffffffff, threadIdx.x / 128, 0);
  if (threadIdx.x == 0) {
    hop::mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      hop::mbar_init(&full[s], 1 + 32);  // the TMA thread and the LSE/D warp
      hop::mbar_init(&empty[s], 8);      // one per consumer warp
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
        for (int c = 0; c < D / BOX; ++c) {
          hop::tma_load_4d(qs + c * BLOCK_M * ROW, &q_map, &full[s], c * BOX,
                           head, m0, batch);
          hop::tma_load_4d(ds + c * BLOCK_M * ROW, &do_map, &full[s], c * BOX,
                           head, m0, batch);
        }
      }
    } else if (threadIdx.x / 32 == 1) {
      // each tile's LSE (log2), D and, SEG, query ids and positions: one
      // row a lane
      const int lane = threadIdx.x % 32;
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES;
        const int head = tl.head(i, kvh, group), row = tl.m0(i) + lane;
        float* vec = reinterpret_cast<float*>(smem + L::VEC_OFF +
                                              s * L::VEC_BYTES);
        const long long idx = ((long long)batch * h + head) * sq + row;
        const float l2 = row < sq ? lse[idx] * fat::LOG2E : CUDART_INF_F;
        const float dd = row < sq ? di[idx] : 0.f;
        int q_id = 0, q_ps = 0;
        if constexpr (SEG) {
          const long long r = (long long)batch * sq + row;
          q_id = row < sq ? seg.q_seg[r] : fat::Q_PAD_SEG;
          q_ps = row < sq ? seg.q_pos[r] : 0;
        }
        if (i >= STAGES) hop::mbar_wait(&empty[s], (i / STAGES - 1) & 1);
        vec[lane] = l2;
        vec[BLOCK_M + lane] = dd;
        if constexpr (SEG) {
          int* qv = reinterpret_cast<int*>(vec + 2 * BLOCK_M);
          qv[lane] = q_id;
          qv[BLOCK_M + lane] = q_ps;
          const fat::SegSpan span = fat::seg_span(q_id, q_id, q_ps, q_ps);
          if (lane == 0)
            *reinterpret_cast<fat::SegSpan*>(vec + L::SPAN_INT) = span;
        }
        hop::mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // ---- consumers: 0 holds dV, 1 holds dK, of the same 64 keys ----
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
  const uint32_t k_s = hop::smem_u32(smem);
  const uint32_t v_s = hop::smem_u32(smem + L::V_OFF);
  const uint32_t q_s = hop::smem_u32(smem + L::Q_OFF);
  const uint32_t do_s = hop::smem_u32(smem + L::DO_OFF);
  // the CTA's DH columns of a Q or dO tile: boxes half * DH / 64 on
  const uint32_t col = half * (DH / BOX) * BLOCK_M * ROW;

  float acc[DH / 2];       // unscaled dV (consumer 0) or dK (consumer 1)
  float sc[BLOCK_M / 2];   // S^T then P^T, or dP^T then dS^T, in fp32
  uint32_t fa[BLOCK_M / 16][4];  // P^T or dS^T as the A operand
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BLOCK_M / 2; ++i) sc[i] = 0.f;

  // Each stage carries its P^T factor in X; consumer 0 writes it and
  // arrives on named barrier 3 + (i & 1), which consumer 1 waits on. The
  // two barriers alternate, so consumer 0 (which cannot run more than a
  // stage ahead: the ring's empty barrier waits for both) never arrives
  // twice on one before consumer 1 has waited there. Each consumer's loop
  // is its own branch, so every wgmma chain is issued and waited for inside
  // it.
  hop::mbar_wait(kv_full, 0);
  if (wg == 0) {
    for (int i = 0; i < n_tiles; ++i) {
      // S^T = K Q^T, then P^T; dV += P^T dO
      const int s = i % STAGES;
      const uint32_t qt = q_s + s * L::T_BYTES, dot = do_s + s * L::T_BYTES;
      const float* vec = reinterpret_cast<const float*>(
          smem + L::VEC_OFF + s * L::VEC_BYTES);
      const int* qseg = reinterpret_cast<const int*>(vec + 2 * BLOCK_M);
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
          p = !edge || seg_live<BLOCK_M>(e, qseg, sk_, t, bd) ? p : 0.f;
        else
          p = !edge || live(e, lo, hi) ? p : 0.f;
        sc[e] = p;
        xs[e * 128 + tid] = CAP ? p * (1.f - th * th) : p;
      }
      hop::named_arrive(3 + (i & 1), 256);
      fat::pack_a<T, BLOCK_M>(fa, sc);
      hop::rs_chain<T, DH, BLOCK_M / 16>(acc, fa, dot + col, BLOCK_M);
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
      hop::rs_chain<T, DH, BLOCK_M / 16>(acc, fa, qt + col, BLOCK_M);
      hop::wgmma_commit();
      hop::wgmma_wait<0>();
      hop::fence_regs(acc);
      hop::fence_regs(fa);
      __syncwarp();  // every lane has read the stage
      if (lane == 0) hop::mbar_arrive(&empty[s]);
    }
  }

  // epilogue: dV into the V tile, scale * dK into the K tile, once both
  // consumers' last products (consumer 1's last reads V, consumer 0's K)
  // are done
  hop::named_sync(5, 256);
  uint8_t* rows = smem + (1 - wg) * L::V_OFF;  // V for 0, K for 1
  to_smem<T, DH, BLOCK_N>(rows, acc, wg == 0 ? 1.f : scale, warp, g, t);
  hop::fence_async_smem();
  hop::named_sync(1 + wg, 128);
  if (tid == 0) {
#pragma unroll
    for (int c = 0; c < DH / BOX; ++c)
      hop::tma_store_4d(wg == 0 ? &dv_map : &dk_map,
                        rows + c * BLOCK_N * ROW, half * DH + c * BOX, kvh,
                        n0, batch);
    hop::tma_store_wait();
  }
}

template <typename T, int D, bool SEG>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* di, void* dk, void* dv, int b,
           int sq, int sk, int h, int hk, const long long* st, float scale,
           int left, int right, float cap_scale, float cap_log2,
           const fat::Seg& seg, cudaStream_t stream) {
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
  auto kernel = cap_scale != 0.f ? flash_bwd_dkv_wide_kernel<T, D, true, SEG>
                                 : flash_bwd_dkv_wide_kernel<T, D, false, SEG>;
  constexpr int bytes = Smem<D, SEG>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  // two CTAs a key block, one a half of the columns
  dim3 grid(hk, b, 2 * ((sk + BLOCK_N - 1) / BLOCK_N));
  kernel<<<grid, NTHREADS, bytes, stream>>>(
      qm, km, vm, dm, dkm, dvm, lse, di, sq, sk, h, h / hk, scale,
      scale * fat::LOG2E, fat::band_side(left), fat::band_side(right),
      cap_scale, cap_log2, seg);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// fat_flash_bwd_dkv's interface (flash_bwd_dkv.cu) at d 384 and 512.
int fat_flash_bwd_dkv_wide(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse, const void* di,
                           void* dk, void* dv, int b, int sq, int sk, int h,
                           int hk, int d, const long long* strides,
                           float scale, int left, int right, float cap_scale,
                           float cap_log2, int is_fp16, const void* seg,
                           void* stream) {
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
  if (d == 512 && !is_fp16) FAT_DKV_LAUNCH(__nv_bfloat16, 512);
  if (d == 512) FAT_DKV_LAUNCH(__half, 512);
  if (d == 384 && !is_fp16) FAT_DKV_LAUNCH(__nv_bfloat16, 384);
  if (d == 384) FAT_DKV_LAUNCH(__half, 384);
#undef FAT_DKV_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

// The segmented instance's tiles at head dim d: out[0] key rows a CTA owns,
// out[1] query rows a streamed tile holds.
int fat_flash_bwd_dkv_wide_seg_tiles(int d, int* out) {
  if (d != 384 && d != 512) return static_cast<int>(cudaErrorInvalidValue);
  out[0] = BLOCK_N;
  out[1] = BLOCK_M;
  return 0;
}

}  // extern "C"
