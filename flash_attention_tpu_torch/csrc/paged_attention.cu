// Paged-attention decode for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces: flash_attention_tpu/ops/paged_attention.py::_paged_attn_kernel
// (the Pallas TPU kernel launched by paged_attention).
//
// One new query token per sequence attends to its cached K/V, which lie in
// fixed-size pages anywhere in a layer-stacked pool (L, hk, P, page_size, d).
// A row's page table maps its i-th page of tokens to a physical page. Rows
// with length <= 0 write zeros. Lengths past the table's width are clamped to
// it; page ids must lie in [0, P) (the engine pads tables with its trash page).
//
// What bounds it on the H100: bytes. Each cached token costs 2 * d * 2 bytes
// of K and V and only 4 * d * group FLOP, about group FLOP per byte, far below
// the ~295 FLOP/byte where bf16 tensor cores would become the limit.
//
// What the design does about it: one CTA per (batch row, kv head) reads every
// K/V row of that head exactly once and applies it to all `group` query heads
// that share it (GQA), so K/V are never read twice. Each warp takes 8 tokens
// at a time and issues all 16 of their K/V row loads (256 contiguous bytes
// per row, 8 bytes per lane) before using any, which keeps enough bytes in
// flight to approach the memory rate; dot products reduce across the warp with
// shuffles, and the online softmax runs in fp32 per warp. Warps merge their
// partial (m, l, acc) through shared memory at the end. No page-table padding
// or pages-per-block grouping is needed. Left for later work: split-K over the
// sequence ("flash-decoding"), since b * hk CTAs do not fill 132 SMs at small
// batch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int U = 8;  // tokens per warp per iteration

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <>
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ __nv_bfloat16 from_f(float x) { return __float2bfloat16(x); }
template <>
__device__ __forceinline__ __half from_f(float x) { return __float2half(x); }

// E consecutive elements of one lane, loaded as one vector
template <typename T, int E>
struct alignas(E * sizeof(T)) Vec {
  T x[E];
};

template <typename T, int D, int G>
__global__ void __launch_bounds__(NTHREADS)
paged_attn_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                  const T* __restrict__ v_pages, const int* __restrict__ lengths,
                  const int* __restrict__ tables, T* __restrict__ out, int h,
                  int hk, int page_size, int pages_per_seq, long long layer_off,
                  long long head_stride, float scale_log2) {
  constexpr int E = D / 32;  // elements per lane
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int group = h / hk;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  __shared__ float sm_m[NWARPS][G];
  __shared__ float sm_l[NWARPS][G];
  __shared__ float sm_acc[NWARPS][G][D];

  const long long q0 = ((long long)b * h + (long long)kvh * group) * D;
  const int len = min(lengths[b], pages_per_seq * page_size);
  if (len <= 0) {
    for (int i = tid; i < group * D; i += NTHREADS) out[q0 + i] = from_f<T>(0.f);
    return;
  }

  float qf[G][E];
#pragma unroll
  for (int gi = 0; gi < G; ++gi)
#pragma unroll
    for (int e = 0; e < E; ++e)
      qf[gi][e] = gi < group
          ? to_f(q[q0 + gi * D + lane * E + e]) * scale_log2 : 0.f;

  float m[G], l[G], acc[G][E];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    m[gi] = -CUDART_INF_F;
    l[gi] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[gi][e] = 0.f;
  }

  const T* kb = k_pages + layer_off + kvh * head_stride;
  const T* vb = v_pages + layer_off + kvh * head_stride;
  const int* tab = tables + (long long)b * pages_per_seq;

  for (int t0 = warp * U; t0 < len; t0 += NWARPS * U) {
    Vec<T, E> kv[U], vv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + u;
      if (t < len) {
        const long long row =
            (long long)tab[t / page_size] * page_size + t % page_size;
        kv[u] = *reinterpret_cast<const Vec<T, E>*>(kb + row * D + lane * E);
        vv[u] = *reinterpret_cast<const Vec<T, E>*>(vb + row * D + lane * E);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          kv[u].x[e] = from_f<T>(0.f);
          vv[u].x[e] = from_f<T>(0.f);
        }
      }
    }
    // scores of the U tokens for every query head of the group (log2 domain)
    float s[U][G];
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) dot += qf[gi][e] * to_f(kv[u].x[e]);
#pragma unroll
        for (int w = 16; w > 0; w >>= 1)
          dot += __shfl_xor_sync(0xffffffff, dot, w);
        s[u][gi] = t0 + u < len ? dot : -CUDART_INF_F;
      }
    }
    // online softmax; token t0 is live, so the running max is finite
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      float mx = m[gi];
#pragma unroll
      for (int u = 0; u < U; ++u) mx = fmaxf(mx, s[u][gi]);
      const float alpha = exp2f(m[gi] - mx);
      l[gi] *= alpha;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[gi][e] *= alpha;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p = exp2f(s[u][gi] - mx);
        l[gi] += p;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[gi][e] += p * to_f(vv[u].x[e]);
      }
      m[gi] = mx;
    }
  }

  // merge the warps' partial softmax states
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    if (lane == 0) {
      sm_m[warp][gi] = m[gi];
      sm_l[warp][gi] = l[gi];
    }
#pragma unroll
    for (int e = 0; e < E; ++e) sm_acc[warp][gi][lane * E + e] = acc[gi][e];
  }
  __syncthreads();
  for (int i = tid; i < group * D; i += NTHREADS) {
    const int gi = i / D;
    const int dd = i % D;
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) mx = fmaxf(mx, sm_m[w][gi]);
    float lsum = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      const float wt = exp2f(sm_m[w][gi] - mx);  // 0 for a warp with no token
      lsum += sm_l[w][gi] * wt;
      o += sm_acc[w][gi][dd] * wt;
    }
    out[q0 + i] = from_f<T>(o / lsum);
  }
}

template <typename T, int D, int G>
void launch(const void* q, const void* kp, const void* vp, const int* lengths,
            const int* tables, void* out, int b, int h, int hk, int page_size,
            int pages_per_seq, long long layer_off, long long head_stride,
            float scale_log2, cudaStream_t stream) {
  dim3 grid(b, hk);
  paged_attn_kernel<T, D, G><<<grid, NTHREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), lengths, tables, static_cast<T*>(out), h, hk,
      page_size, pages_per_seq, layer_off, head_stride, scale_log2);
}

template <typename T, int D>
int dispatch_group(int group, const void* q, const void* kp, const void* vp,
                   const int* lengths, const int* tables, void* out, int b,
                   int h, int hk, int page_size, int pages_per_seq,
                   long long layer_off, long long head_stride, float scale_log2,
                   cudaStream_t s) {
  if (group == 1)
    launch<T, D, 1>(q, kp, vp, lengths, tables, out, b, h, hk, page_size,
                    pages_per_seq, layer_off, head_stride, scale_log2, s);
  else if (group == 2)
    launch<T, D, 2>(q, kp, vp, lengths, tables, out, b, h, hk, page_size,
                    pages_per_seq, layer_off, head_stride, scale_log2, s);
  else if (group <= 4)
    launch<T, D, 4>(q, kp, vp, lengths, tables, out, b, h, hk, page_size,
                    pages_per_seq, layer_off, head_stride, scale_log2, s);
  else if (group <= 8)
    launch<T, D, 8>(q, kp, vp, lengths, tables, out, b, h, hk, page_size,
                    pages_per_seq, layer_off, head_stride, scale_log2, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q, out: contiguous (b, h, d); k/v pages: contiguous (L, hk, P, ps, d);
// lengths (b,) and tables (b, pages_per_seq): contiguous int32.
int fat_paged_attention(const void* q, const void* k_pages, const void* v_pages,
                        const void* lengths, const void* tables, void* out,
                        int b, int h, int hk, int d, int layer, int total_pages,
                        int page_size, int pages_per_seq, float scale_log2,
                        int is_fp16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long head_stride = (long long)total_pages * page_size * d;
  const long long layer_off = (long long)layer * hk * head_stride;
  const int* len = static_cast<const int*>(lengths);
  const int* tab = static_cast<const int*>(tables);
  const int group = h / hk;
  if (d == 128 && !is_fp16)
    return dispatch_group<__nv_bfloat16, 128>(group, q, k_pages, v_pages, len,
        tab, out, b, h, hk, page_size, pages_per_seq, layer_off, head_stride,
        scale_log2, s);
  if (d == 128)
    return dispatch_group<__half, 128>(group, q, k_pages, v_pages, len, tab,
        out, b, h, hk, page_size, pages_per_seq, layer_off, head_stride,
        scale_log2, s);
  if (d == 64 && !is_fp16)
    return dispatch_group<__nv_bfloat16, 64>(group, q, k_pages, v_pages, len,
        tab, out, b, h, hk, page_size, pages_per_seq, layer_off, head_stride,
        scale_log2, s);
  if (d == 64)
    return dispatch_group<__half, 64>(group, q, k_pages, v_pages, len, tab,
        out, b, h, hk, page_size, pages_per_seq, layer_off, head_stride,
        scale_log2, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* fat_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
