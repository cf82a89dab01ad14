// In-place paged KV write for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces: flash_attention_tpu/ops/kv_update.py::_kv_write_kernel (the
// Pallas TPU kernel launched by write_token_kv).
//
// Each decode step writes one token's K and V row per sequence into its page
// slot: pages[layer, h, wpage[b], woff[b], :] = val[b, h, :], for K and V, in
// place on the caller's layer-stacked (L, hk, P, page_size, d) pools. The copy
// is dtype-agnostic: a row is row_bytes bytes, moved 16 bytes per thread.
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
                                long long layer_off) {
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int page = wpage[b];
  const int off = woff[b];
  if (page < 0 || page >= total_pages || off < 0 || off >= page_size) return;
  const long long dst =
      layer_off + (((long long)h * total_pages + page) * page_size + off) * row_bytes;
  const long long src = ((long long)b * hk + h) * row_bytes;
  const int chunks = row_bytes / 16;
  for (int i = threadIdx.x; i < 2 * chunks; i += blockDim.x) {
    const bool is_v = i >= chunks;
    const int c = (is_v ? i - chunks : i) * 16;
    const uint4 x = *reinterpret_cast<const uint4*>((is_v ? vval : kval) + src + c);
    *reinterpret_cast<uint4*>((is_v ? v_pages : k_pages) + dst + c) = x;
  }
}

}  // namespace

extern "C" {

// k/v pages: contiguous (L, hk, P, ps, d); kval/vval: contiguous (b, hk, d)
// of the same dtype; wpage/woff: contiguous (b,) int32. row_bytes = d * size.
int fat_kv_write(void* k_pages, void* v_pages, const void* kval,
                 const void* vval, const void* wpage, const void* woff, int b,
                 int hk, int layer, int total_pages, int page_size,
                 int row_bytes, void* stream) {
  if (row_bytes % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long layer_off =
      (long long)layer * hk * total_pages * page_size * row_bytes;
  const int threads = std::min(256, std::max(32, 2 * row_bytes / 16));
  dim3 grid(b, hk);
  kv_write_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<char*>(k_pages), static_cast<char*>(v_pages),
      static_cast<const char*>(kval), static_cast<const char*>(vval),
      static_cast<const int*>(wpage), static_cast<const int*>(woff), hk,
      total_pages, page_size, row_bytes, layer_off);
  return static_cast<int>(cudaGetLastError());
}

const char* fat_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
