// Pieces shared by the paged-attention decode kernels, paged_attention.cu
// (d 64, 128 and 256) and paged_attention_wide.cu (d 384 and 512): the
// ring's tile, the conversion of an 8-bit K or V tile to bf16 in the
// 128-byte swizzle, and the host's TMA maps over a page pool, encoded once
// per pool and cached.

#pragma once

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
constexpr int MAX_CHUNKS = 64;   // ops/paged_attention.py::plan stays within

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
// r * 128 + (k ^ r % 8) * 16. NT consumer threads each take 16 bytes a
// step.
template <int D, int Q, int NT>
__device__ __forceinline__ void dequant_tile(const uint8_t* src, uint8_t* dst,
                                             int tid) {
  constexpr int IN_ROW = qbox_row(D);
  constexpr int ROW_CHUNKS = D / 16;
#pragma unroll
  for (int it = 0; it < TILE * ROW_CHUNKS / NT; ++it) {
    const int i = tid + it * NT;
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


// A launch's pool: the maps of its K and V pages (and, for an 8-bit cache,
// of its scale tiles), the TMA box height (the largest power of two that
// divides the page size, at most a tile, so a box never crosses a page) and
// the pages of the whole pool.
struct Pool {
  CUtensorMap km, vm, ksm, vsm;
  int box_rows, pages_all;
};

// The pool of a launch at head dim D with page type Q (0 pages in q's type;
// 1 int8 and 2 fp8 e4m3, with scale tiles ksp, vsp), after checking the
// plan: the chunks (n_chunks of chunk_tiles tiles, at most MAX_CHUNKS) must
// cover the table's tiles, or with a window W the most tiles W tokens can
// touch. Returns a cudaError_t value.
template <int D, int Q>
int pool_of(Pool* p, bool fp16, const void* kp, const void* vp,
            const void* ksp, const void* vsp, int L, int hk, int total_pages,
            int page_size, int pages_per_seq, int chunk_tiles, int n_chunks,
            int window) {
  const long long pages_all = (long long)L * hk * total_pages;
  long long need = ((long long)pages_per_seq * page_size + TILE - 1) / TILE;
  const long long span = (long long)(window + TILE - 1) / TILE + 1;
  if (window > 0 && span < need) need = span;
  if (pages_all >= INT_MAX || n_chunks > MAX_CHUNKS || chunk_tiles < 1 ||
      window < 0 || (long long)n_chunks * chunk_tiles < need ||
      (Q != 0 && page_size != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  p->box_rows = min(TILE, page_size & -page_size);
  p->pages_all = static_cast<int>(pages_all);
  const int kind = Q != 0 ? BYTES8 : fp16 ? FP16 : BF16;
  p->ksm = p->vsm = CUtensorMap{};
  int rc;
  if ((rc = pool_map(&p->km, {kp, D, page_size, p->pages_all, kind, p->box_rows})) ||
      (rc = pool_map(&p->vm, {vp, D, page_size, p->pages_all, kind, p->box_rows})))
    return rc;
  if (Q != 0 &&
      ((rc = pool_map(&p->ksm, {ksp, D, page_size, p->pages_all, SCALES, 1})) ||
       (rc = pool_map(&p->vsm, {vsp, D, page_size, p->pages_all, SCALES, 1}))))
    return rc;
  return 0;
}

// Raise a kernel's dynamic shared-memory limit to `bytes`, once per device
// (`done` holds a bit a device). Returns a cudaError_t value.
template <typename K>
int raise_smem_once(K kernel, int bytes, std::atomic<uint64_t>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const uint64_t bit = uint64_t(1) << (dev & 63);
  if (!(done.load() & bit)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    done.fetch_or(bit);
  }
  return 0;
}

// The last chunk of a (batch, head group) pair merges every chunk's partial
// (O of MAX_GROUP heads, then their m and their l: MAX_GROUP * D + 2 *
// MAX_GROUP floats a chunk, from `parts`) into out's `group` rows of D, in
// chunk order. Weights first, THREADS_PER_HEAD threads a head, each over
// every THREADS_PER_HEAD-th chunk (`wts` [chunk][head] and `inv_l` [head] in
// shared memory); then the weighted sums, NTHREADS threads over group * D.
// `tid` is the thread's index among the NTHREADS, which meet at named
// barrier 1.
template <int MAX_GROUP, int NTHREADS, int THREADS_PER_HEAD, int D, typename T>
__device__ __forceinline__ void merge_partials(const float* parts, float* wts,
                                               float* inv_l, int n_live,
                                               int group, int tid, T* out) {
  static_assert(MAX_GROUP * THREADS_PER_HEAD == NTHREADS);
  static_assert(THREADS_PER_HEAD <= 32 && 32 % THREADS_PER_HEAD == 0);
  constexpr int PARTIAL = MAX_GROUP * D + 2 * MAX_GROUP;
  {
    const int gi = tid / THREADS_PER_HEAD, c0 = tid % THREADS_PER_HEAD;
    const bool live = gi < group;
    float mx = -CUDART_INF_F;
    for (int c = c0; live && c < n_live; c += THREADS_PER_HEAD)
      mx = fmaxf(mx, __ldcg(parts + c * PARTIAL + MAX_GROUP * D + gi));
#pragma unroll
    for (int w = THREADS_PER_HEAD / 2; w > 0; w >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, w));
    float lsum = 0.f;
    for (int c = c0; live && c < n_live; c += THREADS_PER_HEAD) {
      const float* pc = parts + c * PARTIAL + MAX_GROUP * D;
      const float wt = hop::exp2_approx(__ldcg(pc + gi) - mx);
      lsum += __ldcg(pc + MAX_GROUP + gi) * wt;
      wts[c * MAX_GROUP + gi] = wt;
    }
#pragma unroll
    for (int w = THREADS_PER_HEAD / 2; w > 0; w >>= 1)
      lsum += __shfl_xor_sync(0xffffffff, lsum, w);
    if (c0 == 0 && live) inv_l[gi] = __fdividef(1.f, lsum);
  }
  hop::named_sync(1, NTHREADS);
  for (int i = tid; i < group * D; i += NTHREADS) {
    const int gi = i / D;
    float o = 0.f;
    for (int c = 0; c < n_live; ++c)
      o += __ldcg(parts + c * PARTIAL + i) * wts[c * MAX_GROUP + gi];
    reinterpret_cast<uint16_t*>(out)[i] =
        fat::Mma<T>::pack(o * inv_l[gi], 0.f) & 0xffffu;
  }
}

}  // namespace
