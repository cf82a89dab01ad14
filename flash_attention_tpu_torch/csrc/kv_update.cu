// In-place paged KV write for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces: flash_attention_tpu/ops/kv_update.py::_kv_write_kernel (the
// Pallas TPU kernel launched by write_token_kv).
//
// Each decode step writes one token's K and V row per sequence into its page
// slot: pages[layer, h, wpage[b], woff[b], :] = val[b, h, :], for K and V, in
// place on the caller's layer-stacked (L, hk, P, page_size, d) pools. The copy
// is dtype-agnostic: a row is row_bytes bytes, moved 16 bytes per thread. A
// source row may be narrower than the cache's (a head dim the attention
// kernels run zero-padded, as d 96 in a cache 128 wide or d 320 in one 384
// wide): it is read at its own row stride and the columns past it are
// written as zeros, so the wrapper pads nothing.
//
// What bounds it on the H100: bytes, and at decode batch sizes (a few dozen
// rows of 256 bytes) really the launch itself; the kernel moves 4 * b * hk * d
// bytes of a pool that may hold gigabytes.
//
// What the design does about it: it touches only the target rows. The TPU
// kernel had to read-modify-write whole (page_size, d) tiles because its DMA
// moved tiles; here each thread stores one 16-byte chunk straight into the
// slot, one CTA per (row, kv head), so nothing else of the pool is read or
// written and no copy of the cache is ever made.
//
// Duplicate targets: the TPU grid ran rows in order, so rows that share a
// target slot wrote one after another. Here they race. The engine aims every
// padding row of a decode batch at the same trash page, whose contents are
// never read for a live row, so the race is harmless; callers must not give
// two live rows the same slot. A row whose (wpage, woff) lies outside the pool
// writes nothing.
//
// The quantized cache (int8 or fp8 e4m3 pages, with fp32 scale tiles of
// (L, hk, P, 8, 128): lane t of a page's tile holds token t's scale, the same
// in all 8 rows, the TPU's smallest DMA slice) has one more kernel,
// kv_write_quant_kernel, in two instances: STORE writes a row already in the
// cache's type and its scale (the TPU kernel's quantized write, JAX's
// write_token_kv contract); INT8 and FP8 take the bf16 row, quantize it per
// token (models/llama.py::_quantize_token in the JAX package: amax over d,
// scale = max(amax / 127 or 448, 1e-8), x / scale in IEEE fp32, int8 rounded
// half to even and clipped to +-127, e4m3 rounded to nearest even) and store
// the same way, so a decode layer's quantization and write stay one launch.
// One warp per (row, kv head) and K or V: the amax is a warp reduction, each
// lane holds d / 32 elements, and lanes 0-7 write the scale into the 8 rows
// of the tile at lane woff. Both instances write the plain version's bits.
// Rows narrower than the cache (d_in < D) are read at their own stride, and
// their missing columns quantize as zeros, which leave the amax, and so the
// scale, unchanged.

#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

__global__ void kv_write_kernel(char* __restrict__ k_pages,
                                char* __restrict__ v_pages,
                                const char* __restrict__ kval,
                                const char* __restrict__ vval,
                                const int* __restrict__ wpage,
                                const int* __restrict__ woff, int hk,
                                int total_pages, int page_size, int row_bytes,
                                int src_bytes, long long layer_off) {
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int page = wpage[b];
  const int off = woff[b];
  if (page < 0 || page >= total_pages || off < 0 || off >= page_size) return;
  const long long dst =
      layer_off + (((long long)h * total_pages + page) * page_size + off) * row_bytes;
  const long long src = ((long long)b * hk + h) * src_bytes;
  const int chunks = row_bytes / 16;
  for (int i = threadIdx.x; i < 2 * chunks; i += blockDim.x) {
    const bool is_v = i >= chunks;
    const int c = (is_v ? i - chunks : i) * 16;
    const uint4 x =
        c < src_bytes ? *reinterpret_cast<const uint4*>((is_v ? vval : kval) + src + c)
                      : make_uint4(0u, 0u, 0u, 0u);
    *reinterpret_cast<uint4*>((is_v ? v_pages : k_pages) + dst + c) = x;
  }
}

enum QuantMode : int { STORE = 0, QUANT_INT8 = 1, QUANT_FP8 = 2 };

// E bytes (2, 4, 8 or 16) as one aligned access
template <int E>
struct Bytes;
template <>
struct Bytes<2> { using T = uint16_t; };
template <>
struct Bytes<4> { using T = uint32_t; };
template <>
struct Bytes<8> { using T = uint2; };
template <>
struct Bytes<16> { using T = uint4; };

// The widest of 16, 8, 4 and 2 bytes that divides n: the access in which a
// lane moves its n bytes (a lane's offset is a multiple of n).
__host__ __device__ constexpr int access_bytes(int n) {
  return n % 16 == 0 ? 16 : n % 8 == 0 ? 8 : n % 4 == 0 ? 4 : 2;
}

template <int MODE, int D>
__global__ void __launch_bounds__(64)
kv_write_quant_kernel(uint8_t* __restrict__ k_pages,
                      uint8_t* __restrict__ v_pages,
                      float* __restrict__ k_scales,
                      float* __restrict__ v_scales,
                      const void* __restrict__ kval,
                      const void* __restrict__ vval,
                      const float* __restrict__ kscale,
                      const float* __restrict__ vscale,
                      const int* __restrict__ wpage,
                      const int* __restrict__ woff, int hk, int total_pages,
                      int page_size, int layer, int d_in) {
  const int b = blockIdx.x, h = blockIdx.y;
  const bool is_v = threadIdx.x >= 32;
  const int lane = threadIdx.x % 32;
  const int page = wpage[b];
  const int off = woff[b];
  if (page < 0 || page >= total_pages || off < 0 || off >= page_size) return;
  // the page's index in the pool viewed as (L hk P) pages
  const long long tile = ((long long)layer * hk + h) * total_pages + page;
  uint8_t* dst = (is_v ? v_pages : k_pages) + (tile * page_size + off) * D;
  const long long row = (long long)b * hk + h;
  float scale;
  if constexpr (MODE == STORE) {
    const uint8_t* src = static_cast<const uint8_t*>(is_v ? vval : kval) + row * d_in;
    if (lane < D / 16) {
      uint4 x;
      if (d_in == D) {
        x = reinterpret_cast<const uint4*>(src)[lane];
      } else {
        uint8_t* xb = reinterpret_cast<uint8_t*>(&x);
#pragma unroll
        for (int k = 0; k < 16; ++k)
          xb[k] = lane * 16 + k < d_in ? src[lane * 16 + k] : 0;
      }
      reinterpret_cast<uint4*>(dst)[lane] = x;
    }
    scale = (is_v ? vscale : kscale)[row];
  } else {
    constexpr int E = D / 32;  // elements a lane
    constexpr int IB = access_bytes(2 * E), OB = access_bytes(E);
    using In = typename Bytes<IB>::T;
    using Out = typename Bytes<OB>::T;
    const uint16_t* src =
        static_cast<const uint16_t*>(is_v ? vval : kval) + row * d_in + lane * E;
    alignas(16) uint16_t w[E];  // the lane's bf16 elements
    if (d_in == D) {
#pragma unroll
      for (int k = 0; k < 2 * E / IB; ++k)
        reinterpret_cast<In*>(w)[k] = reinterpret_cast<const In*>(src)[k];
    } else {
#pragma unroll
      for (int i = 0; i < E; ++i) w[i] = lane * E + i < d_in ? src[i] : 0;
    }
    float x[E];
    float amax = 0.f;
#pragma unroll
    for (int i = 0; i < E; ++i) {
      x[i] = __uint_as_float(uint32_t(w[i]) << 16);
      amax = fmaxf(amax, fabsf(x[i]));
    }
#pragma unroll
    for (int m = 16; m > 0; m >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffff, amax, m));
    scale = fmaxf(__fdiv_rn(amax, MODE == QUANT_INT8 ? 127.f : 448.f), 1e-8f);
    alignas(16) uint8_t q[E];
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const float y = __fdiv_rn(x[i], scale);
      if constexpr (MODE == QUANT_INT8)
        q[i] = static_cast<uint8_t>(
            __float2int_rn(fminf(fmaxf(rintf(y), -127.f), 127.f)));
      else
        q[i] = __nv_cvt_float_to_fp8(y, __NV_SATFINITE, __NV_E4M3);
    }
#pragma unroll
    for (int k = 0; k < E / OB; ++k)
      reinterpret_cast<Out*>(dst + lane * E)[k] = reinterpret_cast<const Out*>(q)[k];
  }
  if (lane < 8) (is_v ? v_scales : k_scales)[tile * 1024 + lane * 128 + off] = scale;
}

template <int MODE>
int launch_quant(uint8_t* kp, uint8_t* vp, float* ks, float* vs, const void* kval,
                 const void* vval, const float* kscale, const float* vscale,
                 const int* wpage, const int* woff, int b, int hk, int layer,
                 int total_pages, int page_size, int d, int d_in,
                 cudaStream_t stream) {
  dim3 grid(b, hk);
#define FAT_KV_QUANT(D)                                                        \
  kv_write_quant_kernel<MODE, D><<<grid, 64, 0, stream>>>(                      \
      kp, vp, ks, vs, kval, vval, kscale, vscale, wpage, woff, hk, total_pages, \
      page_size, layer, d_in)
  if (d_in > d || d_in < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (d == 64)
    FAT_KV_QUANT(64);
  else if (d == 128)
    FAT_KV_QUANT(128);
  else if (d == 256)
    FAT_KV_QUANT(256);
  else if (d == 384)
    FAT_KV_QUANT(384);
  else if (d == 512)
    FAT_KV_QUANT(512);
  else
    return static_cast<int>(cudaErrorInvalidValue);
#undef FAT_KV_QUANT
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// k/v pages: contiguous (L, hk, P, ps, d); kval/vval: contiguous (b, hk,
// d_in) of the same dtype, d_in <= d; wpage/woff: contiguous (b,) int32.
// row_bytes = d * size, src_bytes = d_in * size, both multiples of 16; the
// cache's columns past d_in are written as zeros.
int fat_kv_write(void* k_pages, void* v_pages, const void* kval,
                 const void* vval, const void* wpage, const void* woff, int b,
                 int hk, int layer, int total_pages, int page_size,
                 int row_bytes, int src_bytes, void* stream) {
  if (row_bytes % 16 != 0 || src_bytes % 16 != 0 || src_bytes > row_bytes ||
      src_bytes < 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long layer_off =
      (long long)layer * hk * total_pages * page_size * row_bytes;
  const int threads = std::min(256, std::max(32, 2 * row_bytes / 16));
  dim3 grid(b, hk);
  kv_write_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<char*>(k_pages), static_cast<char*>(v_pages),
      static_cast<const char*>(kval), static_cast<const char*>(vval),
      static_cast<const int*>(wpage), static_cast<const int*>(woff), hk,
      total_pages, page_size, row_bytes, src_bytes, layer_off);
  return static_cast<int>(cudaGetLastError());
}

// The quantized cache: k/v pages contiguous (L, hk, P, ps, d) int8 or fp8
// (bytes), ps <= 128; k/v scales contiguous (L, hk, P, 8, 128) fp32. mode 0
// (STORE): kval/vval (b, hk, d_in) in the cache's type and kscale/vscale
// (b, hk) fp32; modes 1 (int8) and 2 (fp8 e4m3): kval/vval (b, hk, d_in)
// bf16, quantized here (kscale/vscale unused). d is 64, 128, 256, 384 or 512,
// d_in <= d; the columns past d_in are written as zeros.
int fat_kv_write_quant(void* k_pages, void* v_pages, void* k_scales,
                       void* v_scales, const void* kval, const void* vval,
                       const void* kscale, const void* vscale,
                       const void* wpage, const void* woff, int b, int hk,
                       int layer, int total_pages, int page_size, int d,
                       int d_in, int mode, void* stream) {
  if (page_size > 128 || page_size < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  auto* kp = static_cast<uint8_t*>(k_pages);
  auto* vp = static_cast<uint8_t*>(v_pages);
  auto* ks = static_cast<float*>(k_scales);
  auto* vs = static_cast<float*>(v_scales);
  auto* ksc = static_cast<const float*>(kscale);
  auto* vsc = static_cast<const float*>(vscale);
  auto* wp = static_cast<const int*>(wpage);
  auto* wo = static_cast<const int*>(woff);
  auto s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case STORE:
      return launch_quant<STORE>(kp, vp, ks, vs, kval, vval, ksc, vsc, wp, wo,
                                 b, hk, layer, total_pages, page_size, d, d_in, s);
    case QUANT_INT8:
      return launch_quant<QUANT_INT8>(kp, vp, ks, vs, kval, vval, ksc, vsc, wp,
                                      wo, b, hk, layer, total_pages, page_size,
                                      d, d_in, s);
    case QUANT_FP8:
      return launch_quant<QUANT_FP8>(kp, vp, ks, vs, kval, vval, ksc, vsc, wp,
                                     wo, b, hk, layer, total_pages, page_size,
                                     d, d_in, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* fat_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
