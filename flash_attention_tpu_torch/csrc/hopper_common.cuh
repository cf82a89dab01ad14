// Hopper (sm_90a) building blocks for the port's warp-specialised kernels
// (the flash forward, the backward's three kernels, the quantized matmul,
// the grouped matmuls gmm and gmm_dw, and paged-attention decode):
// mbarriers, TMA tensor loads and stores, thread-block clusters (a peer
// CTA's shared memory: its addresses, stores and barrier arrivals),
// warpgroup matrix multiplies (wgmma) with their shared-memory descriptors
// and chains, fences, commit and wait, register reallocation (setmaxnreg),
// named barriers, and the
// host-side encoding of TMA tensor maps over a (b, s, heads, d) tensor, a
// 2-D matrix and a 3-D stack of matrices.
//
// Shared-memory tiles are what a TMA load with a 128-byte swizzle writes: a
// box of 64 16-bit elements (128 bytes, the swizzle span) by `rows` rows,
// row r at r * 128 bytes with its 16-byte chunks permuted by r % 8, and the
// box 1024-byte aligned. A tile wider than 64 elements is several such
// boxes one after another. wgmma reads the same tile through a descriptor:
//   K-major (the reduction dim contiguous, as Q and K for Q K^T):
//     8-row groups 1024 bytes apart (SBO); a k16 step inside a box adds 32
//     bytes to the start address, the next box adds rows * 128.
//   MN-major (the output dim contiguous, as V for P V, "transposed" B, or
//   the rows of x as gmm_dw's A):
//     8-row (k) groups 1024 bytes apart (SBO), 64-element column boxes
//     rows * 128 bytes apart (LBO); a k16 step adds 16 * 128 bytes.
//
// Accumulator layout of wgmma m64nNk16 (fp32), thread T of the warpgroup,
// warp w = T / 32, g = (T % 32) / 4, t = T % 4: d[4 j + e] holds row
// 16 w + g + 8 (e / 2), column 8 j + 2 t + e % 2 -- the mma.sync m16n8k16 C
// layout of flash_common.cuh per 16-row warp slice. An A operand from
// registers takes that warp slice's m16n8k16 A fragment, so two adjacent
// 8-column accumulator blocks form one k16 step of A (fat::pack_a).

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: no libcuda link)
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include <type_traits>

namespace hop {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers --------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Make the initialised barriers visible to the async proxy (TMA) and to the
// other threads (follow with __syncthreads()).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive once and expect `bytes` more from TMA copies in this phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Wait until the phase of parity `parity` has completed. A phase that never
// completes (a parity or count error) hangs the kernel: run new pipeline code
// under a time limit. (A watchdog that traps would be no cure: a trap in a
// warp-specialised kernel holds every role to the launch's register limit,
// so setmaxnreg's larger budget is lost.)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// ---- thread-block clusters -------------------------------------------------
// (flash_bwd_dkv_wide.cu and flash_bwd_dq_pair.cu: two CTAs a cluster, each
// writing into the other's shared memory)

__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// The shared::cluster address of `addr` (a shared::cta address of this CTA)
// in the shared memory of the cluster's CTA `rank`.
__device__ __forceinline__ uint32_t mapa(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}

// Every thread of every CTA of the cluster: arrive, then wait for the
// others. Orders the shared-memory work before it (barrier initialisation,
// writes into a peer) before all of theirs after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// Arrive once on a barrier of another CTA of the cluster (`bar`, a
// shared::cluster address from mapa), with mbarrier.arrive's default
// semantics, as CUTLASS's cluster pipelines release a peer's buffer
// (release and acquire at the cluster scope, here and in the waits, cost
// the wide dkv kernel 30-40% of its time on the H100: PERF.md, row 4).
__device__ __forceinline__ void mbar_arrive_remote(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Store 16 bytes into another CTA's shared memory (`addr`, shared::cluster)
// and complete 16 bytes of the transaction count of its barrier `bar`
// (shared::cluster), which that CTA armed with mbar_expect_tx; the bytes
// are visible to a thread of that CTA once mbar_wait sees the phase end.
__device__ __forceinline__ void st_async_v4(uint32_t addr, uint32_t a,
                                            uint32_t b, uint32_t c, uint32_t d,
                                            uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(addr),
      "r"(a), "r"(b), "r"(c), "r"(d), "r"(bar)
      : "memory");
}

// ---- TMA --------------------------------------------------------------------

// Load the box at coordinates (c0 innermost .. c3) of `map` into `dst`,
// completing `bytes` of the barrier's expected transaction count.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_u32(bar))
      : "memory");
}

// tma_load_4d into every CTA of the cluster whose bit is set in `mask`: the
// box lands at `dst`'s offset in each of them and completes its bytes on
// the barrier at `bar`'s offset there (flash_bwd_dq_pair.cu: the half of
// each K tile both CTAs of a pair read). Each CTA arms its own barrier
// with every byte it expects, the peer's included.
__device__ __forceinline__ void tma_load_4d_multicast(void* dst,
                                                      const CUtensorMap* map,
                                                      uint64_t* bar, int c0,
                                                      int c1, int c2, int c3,
                                                      uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes.multicast::cluster [%0], [%1, {%2, %3, %4, %5}], [%6], %7;\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_u32(bar)), "h"(mask)
      : "memory");
}

// Load the box at coordinates (c0 innermost, c1, c2) of a 3-D `map` into
// `dst`.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_u32(bar))
      : "memory");
}

// Load the box at coordinates (c0 innermost, c1) of a 2-D `map` into `dst`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_u32(bar))
      : "memory");
}

// Store `src` to the box at (c0 .. c3); elements past the tensor's extents
// are not written. Generic-proxy writes to `src` need fence_async_smem()
// and a barrier first.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, "
      "%5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Store `src` to the box at (c0 innermost, c1, c2) of a 3-D map; elements
// past the extents are not written. As above, fence and synchronise
// generic-proxy writes to `src` first.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src,
                                             int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], "
      "[%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Close the stores issued so far into one bulk group.
__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups still read shared memory.
template <int N>
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// Commit the issued stores and wait until they have read shared memory.
__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map))
               : "memory");
}

// ---- registers and barriers -------------------------------------------------

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Barrier `id` (1..15; 0 is __syncthreads) over `n` threads: wait, or only
// arrive (the waiters and the arrivers together make up the n).
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// Keep the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across its wait (or its issue).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// ---- wgmma ------------------------------------------------------------------

// Descriptor of a 128-byte-swizzled shared-memory operand at `addr`, with
// leading and stride byte offsets as set out at the top of this file.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFF) << 32) | (uint64_t(1) << 62);
}

// Order earlier register and shared-memory writes before the next wgmma.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed groups are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

#define HOP_D8(d, i)                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define HOP_D16(d) HOP_D8(d, 0), HOP_D8(d, 8)
#define HOP_D32(d) HOP_D8(d, 0), HOP_D8(d, 8), HOP_D8(d, 16), HOP_D8(d, 24)
#define HOP_D64(d) HOP_D32(d), HOP_D8(d, 32), HOP_D8(d, 40), HOP_D8(d, 48), HOP_D8(d, 56)
#define HOP_D4(d) "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
#define HOP_D128(d) HOP_D64(d), HOP_D8(d, 64), HOP_D8(d, 72), HOP_D8(d, 80), \
      HOP_D8(d, 88), HOP_D8(d, 96), HOP_D8(d, 104), HOP_D8(d, 112), HOP_D8(d, 120)
#define HOP_D96(d) HOP_D64(d), HOP_D8(d, 64), HOP_D8(d, 72), HOP_D8(d, 80), \
      HOP_D8(d, 88)
#define HOP_L4 "{%0, %1, %2, %3}"
#define HOP_L8 "{%0, %1, %2, %3, %4, %5, %6, %7}"
#define HOP_L128 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "                       \
  "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "              \
  "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "              \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "              \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "              \
  "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "              \
  "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "              \
  "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "              \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "      \
  "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "  \
  "%120, %121, %122, %123, %124, %125, %126, %127}"
#define HOP_L96 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "                       \
  "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "              \
  "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "              \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "              \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "              \
  "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "              \
  "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "              \
  "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}"
#define HOP_L16                                                                \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define HOP_L32                                                                \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "   \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "    \
  "%30, %31}"
#define HOP_L64                                                                \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "   \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "    \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "     \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "     \
  "%58, %59, %60, %61, %62, %63}"

// D (+)= A B, A and B K-major in shared memory; scale_d 0 ignores D's input.
// a, b, scale_d are operands NA, NA + 1, NA + 2.
#define HOP_SS(TY, N, LIST, OUTS, NA, NB, NS)                                  \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" NS ", 0;\n"              \
               "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY   \
               " " LIST ", %" NA ", %" NB ", p, 1, 1, 0, 0;\n}\n"             \
               : OUTS                                                          \
               : "l"(a), "l"(b), "r"(scale_d))

// D += A B, A from registers (4 x 32 bits), B in shared memory: MN-major
// (TB "1", rs_tb) or K-major (TB "0", rs).
#define HOP_RS(TY, N, LIST, OUTS, A0, A1, A2, A3, NB, NS, TB)                  \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" NS ", 0;\n"              \
               "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY   \
               " " LIST ", {%" A0 ", %" A1 ", %" A2 ", %" A3 "}, %" NB        \
               ", p, 1, 1, " TB ";\n}\n"                                      \
               : OUTS                                                          \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1))

// wgmma m64nNk16 with fp32 accumulators in bf16 or fp16: ss at N 32, 64 and
// 128 (Q K^T; the backward's 64-column S and dP, 32-column at d 384 and 512),
// rs_tb at N 64, 128, 192 and 256 (P V at d 64, 128 and 256; the backward's
// dS K, P^T dO and dS^T Q, and their d-384/512 column halves).
template <typename T, int N>
struct Wgmma;

template <typename T>
struct Wgmma<T, 32> {
  static __device__ __forceinline__ void ss(float (&d)[16], uint64_t a,
                                            uint64_t b, int scale_d) {
    if constexpr (std::is_same_v<T, __half>)
      HOP_SS("f16", 32, HOP_L16, HOP_D16(d), "16", "17", "18");
    else
      HOP_SS("bf16", 32, HOP_L16, HOP_D16(d), "16", "17", "18");
  }
};

template <typename T>
struct Wgmma<T, 64> {
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a,
                                            uint64_t b, int scale_d) {
    if constexpr (std::is_same_v<T, __half>)
      HOP_SS("f16", 64, HOP_L32, HOP_D32(d), "32", "33", "34");
    else
      HOP_SS("bf16", 64, HOP_L32, HOP_D32(d), "32", "33", "34");
  }
  static __device__ __forceinline__ void rs_tb(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t b) {
    if constexpr (std::is_same_v<T, __half>)
      HOP_RS("f16", 64, HOP_L32, HOP_D32(d), "32", "33", "34", "35", "36", "37", "1");
    else
      HOP_RS("bf16", 64, HOP_L32, HOP_D32(d), "32", "33", "34", "35", "36", "37", "1");
  }
};

template <typename T>
struct Wgmma<T, 128> {
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t a,
                                            uint64_t b, int scale_d) {
    if constexpr (std::is_same_v<T, __half>)
      HOP_SS("f16", 128, HOP_L64, HOP_D64(d), "64", "65", "66");
    else
      HOP_SS("bf16", 128, HOP_L64, HOP_D64(d), "64", "65", "66");
  }
  static __device__ __forceinline__ void rs_tb(float (&d)[64],
                                               const uint32_t (&a)[4],
                                               uint64_t b) {
    if constexpr (std::is_same_v<T, __half>)
      HOP_RS("f16", 128, HOP_L64, HOP_D64(d), "64", "65", "66", "67", "68", "69", "1");
    else
      HOP_RS("bf16", 128, HOP_L64, HOP_D64(d), "64", "65", "66", "67", "68", "69", "1");
  }
};

template <typename T>
struct Wgmma<T, 192> {
  static __device__ __forceinline__ void rs_tb(float (&d)[96],
                                               const uint32_t (&a)[4],
                                               uint64_t b) {
    if constexpr (std::is_same_v<T, __half>)
      HOP_RS("f16", 192, HOP_L96, HOP_D96(d), "96", "97", "98", "99", "100", "101", "1");
    else
      HOP_RS("bf16", 192, HOP_L96, HOP_D96(d), "96", "97", "98", "99", "100", "101", "1");
  }
};

template <typename T>
struct Wgmma<T, 256> {
  static __device__ __forceinline__ void rs_tb(float (&d)[128],
                                               const uint32_t (&a)[4],
                                               uint64_t b) {
    if constexpr (std::is_same_v<T, __half>)
      HOP_RS("f16", 256, HOP_L128, HOP_D128(d), "128", "129", "130", "131", "132", "133", "1");
    else
      HOP_RS("bf16", 256, HOP_L128, HOP_D128(d), "128", "129", "130", "131", "132", "133", "1");
  }
};

// rs: A from registers, B K-major in shared memory: the quantized matmul's
// dequantised weight (A, the M side) times rows of x (B) at N 8 and 16
// (decode) and 256 (prefill); paged attention's Q (A, the GQA group's query
// heads) times a 64-token K tile (B) at N 64; the wide dQ kernel's Q or dO
// (A) times a 32-row K or V tile (B) at N 32.
template <typename T, int N>
struct WgmmaRs;

template <typename T>
struct WgmmaRs<T, 32> {
  static __device__ __forceinline__ void rs(float (&d)[16], const uint32_t (&a)[4],
                                            uint64_t b) {
    if constexpr (std::is_same_v<T, __half>)
      HOP_RS("f16", 32, HOP_L16, HOP_D16(d), "16", "17", "18", "19", "20", "21", "0");
    else
      HOP_RS("bf16", 32, HOP_L16, HOP_D16(d), "16", "17", "18", "19", "20", "21", "0");
  }
};

template <typename T>
struct WgmmaRs<T, 64> {
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t b) {
    if constexpr (std::is_same_v<T, __half>)
      HOP_RS("f16", 64, HOP_L32, HOP_D32(d), "32", "33", "34", "35", "36", "37", "0");
    else
      HOP_RS("bf16", 64, HOP_L32, HOP_D32(d), "32", "33", "34", "35", "36", "37", "0");
  }
};

template <typename T>
struct WgmmaRs<T, 8> {
  static __device__ __forceinline__ void rs(float (&d)[4], const uint32_t (&a)[4],
                                            uint64_t b) {
    if constexpr (std::is_same_v<T, __half>)
      HOP_RS("f16", 8, HOP_L4, HOP_D4(d), "4", "5", "6", "7", "8", "9", "0");
    else
      HOP_RS("bf16", 8, HOP_L4, HOP_D4(d), "4", "5", "6", "7", "8", "9", "0");
  }
};

template <typename T>
struct WgmmaRs<T, 16> {
  static __device__ __forceinline__ void rs(float (&d)[8], const uint32_t (&a)[4],
                                            uint64_t b) {
    if constexpr (std::is_same_v<T, __half>)
      HOP_RS("f16", 16, HOP_L8, HOP_D8(d, 0), "8", "9", "10", "11", "12", "13", "0");
    else
      HOP_RS("bf16", 16, HOP_L8, HOP_D8(d, 0), "8", "9", "10", "11", "12", "13", "0");
  }
};

template <typename T>
struct WgmmaRs<T, 256> {
  static __device__ __forceinline__ void rs(float (&d)[128], const uint32_t (&a)[4],
                                            uint64_t b) {
    if constexpr (std::is_same_v<T, __half>)
      HOP_RS("f16", 256, HOP_L128, HOP_D128(d), "128", "129", "130", "131", "132", "133", "0");
    else
      HOP_RS("bf16", 256, HOP_L128, HOP_D128(d), "128", "129", "130", "131", "132", "133", "0");
  }
};

// D (+)= A B, both from shared memory, each K-major (0) or MN-major (1,
// "transposed"; bf16 and fp16 only): a, b, scale_d, TA, TB are operands
// NA .. NA + 4.
#define HOP_SST(TY, N, LIST, OUTS, NA, NB, NS, NTA, NTB)                      \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" NS ", 0;\n"              \
               "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY   \
               " " LIST ", %" NA ", %" NB ", p, 1, 1, %" NTA ", %" NTB       \
               ";\n}\n"                                                      \
               : OUTS                                                          \
               : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB))

// ss with A (TA) and B (TB) K-major (0) or MN-major (1), at N 256:
// gmm (x K-major; the weight MN-major as stored, K-major as the view w^T)
// and gmm_dw (x and dy both MN-major); at N 192 and 256 the head-dim halves
// of P V at d 384 and 512 (P K-major, V MN-major; flash_fwd_wide.cu and
// paged_attention_wide.cu).
template <typename T, int N, int TA, int TB>
struct WgmmaSs;

template <typename T, int TA, int TB>
struct WgmmaSs<T, 192, TA, TB> {
  static __device__ __forceinline__ void ss(float (&d)[96], uint64_t a,
                                            uint64_t b, int scale_d) {
    if constexpr (std::is_same_v<T, __half>)
      HOP_SST("f16", 192, HOP_L96, HOP_D96(d), "96", "97", "98", "99", "100");
    else
      HOP_SST("bf16", 192, HOP_L96, HOP_D96(d), "96", "97", "98", "99", "100");
  }
};

template <typename T, int TA, int TB>
struct WgmmaSs<T, 256, TA, TB> {
  static __device__ __forceinline__ void ss(float (&d)[128], uint64_t a,
                                            uint64_t b, int scale_d) {
    if constexpr (std::is_same_v<T, __half>)
      HOP_SST("f16", 256, HOP_L128, HOP_D128(d), "128", "129", "130", "131", "132");
    else
      HOP_SST("bf16", 256, HOP_L128, HOP_D128(d), "128", "129", "130", "131", "132");
  }
};

#undef HOP_SST
#undef HOP_SS
#undef HOP_RS
#undef HOP_L128
#undef HOP_L96
#undef HOP_L64
#undef HOP_L32
#undef HOP_L16
#undef HOP_L8
#undef HOP_L4
#undef HOP_D128
#undef HOP_D96
#undef HOP_D64
#undef HOP_D32
#undef HOP_D16
#undef HOP_D4
#undef HOP_D8

// D = A B^T over KD elements of K, k16 steps in order (the first ignores D's
// input), for a K-major A (64 rows at `a`) and B (N rows at `b`) in tiles
// whose 64-column boxes hold a_rows and b_rows rows. Issued, not committed.
// Every kernel that must sum a dot product bit for bit as another does (the
// backward's dP and D) takes it from this one chain.
template <typename T, int N, int KD>
__device__ __forceinline__ void ss_chain(float (&d)[N / 2], uint32_t a,
                                         int a_rows, uint32_t b, int b_rows) {
  fence_regs(d);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KD / 16; ++kk) {
    const uint32_t box = kk / 4, ko = (kk % 4) * 32;
    Wgmma<T, N>::ss(d, desc_sw128(a + box * a_rows * 128 + ko, 16, 1024),
                    desc_sw128(b + box * b_rows * 128 + ko, 16, 1024), kk > 0);
  }
}

// The A fragments (k16 step kk's four registers, as fat::pack_a lays them
// out) of this thread's rows of a 64-row, KD-column tile in shared memory,
// the 128-byte-swizzled boxes a TMA load writes (box c at c * 64 * 128
// bytes): the operand of rs wgmma chains that keep the tile in registers.
template <int KD>
__device__ __forceinline__ void load_a_tile(uint32_t (&a)[KD / 16][4],
                                            const uint8_t* tile, int warp,
                                            int g, int t) {
#pragma unroll
  for (int kk = 0; kk < KD / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = warp * 16 + g + 8 * (e & 1);
      const int chunk = (kk % 4) * 2 + (e >> 1);
      a[kk][e] = *reinterpret_cast<const uint32_t*>(
          tile + (kk / 4) * 64 * 128 + row * 128 + ((chunk ^ (row & 7)) * 16) +
          t * 4);
    }
}

// D += A B for A in registers (KS k16 steps of m16n8k16 A fragments) and an
// MN-major B (16 KS rows of N columns at `b`) in a tile whose 64-column boxes
// hold b_rows rows. Issued, not committed.
template <typename T, int N, int KS>
__device__ __forceinline__ void rs_chain(float (&d)[N / 2],
                                         uint32_t (&a)[KS][4], uint32_t b,
                                         int b_rows) {
  fence_regs(d);
  fence_regs(a);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    Wgmma<T, N>::rs_tb(d, a[kk],
                       desc_sw128(b + kk * 16 * 128, b_rows * 128, 1024));
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// tanh(x) = 1 - 2 / (2^(2 x log2 e) + 1), from ex2.approx and a fast
// reciprocal: an absolute error of a few 1e-7 over the whole line (where
// tanh.approx.f32 has a relative error near 2^-11, which a softcap of 50
// turns into logit errors near 5e-3), exactly +-1 at the ends, and no IEEE
// division (whose slow path is a call; see mbar_wait).
__device__ __forceinline__ float tanh_exp2(float x) {
  return 1.f - __fdividef(2.f, exp2_approx(x * 2.8853900817779268f) + 1.f);
}

// ---- host: TMA tensor maps --------------------------------------------------

// cuTensorMapEncodeTiled is a driver call. The libraries link only the CUDA
// runtime, so it is looked up in the driver library the runtime has loaded.
// It fails in a thread with no current context: one that has made no
// runtime call yet, as an autograd worker thread may not have. So the
// runtime's current device is set again first, which makes its primary
// context current (no device work: it may run during a CUDA graph capture).
// Returns nullptr if either step fails.
inline decltype(&cuTensorMapEncodeTiled) tensor_map_encoder() {
  static auto fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return reinterpret_cast<decltype(&cuTensorMapEncodeTiled)>(
        lib ? dlsym(lib, "cuTensorMapEncodeTiled") : nullptr);
  }();
  int dev;
  if (cudaGetDevice(&dev) != cudaSuccess || cudaSetDevice(dev) != cudaSuccess)
    return nullptr;
  return fn;
}

// A 4-D map (d, heads, s, b) over a (b, s, heads, d) tensor of 16-bit
// elements with element strides st = (batch, seq, head) and a contiguous d,
// loading boxes of 64 x 1 x rows x 1 with the 128-byte swizzle. Rows past s
// read as zeros and are not written. Returns a cudaError_t value.
inline int make_map_bshd(CUtensorMap* map, const void* ptr, bool fp16, int b,
                         int s, int heads, int d, const long long* st,
                         int rows) {
  auto encode = tensor_map_encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorSharedObjectSymbolNotFound);
  const int s1 = s > 0 ? s : 1;  // an empty sequence is never read
  cuuint64_t dims[4] = {cuuint64_t(d), cuuint64_t(heads), cuuint64_t(s1),
                        cuuint64_t(b)};
  cuuint64_t strides[3] = {cuuint64_t(st[2]) * 2, cuuint64_t(st[1]) * 2,
                           cuuint64_t(st[0]) * 2};
  // a dim of extent 1 is never stepped: give it a packed stride, whatever
  // stride the caller's view has there
  if (heads == 1) strides[0] = cuuint64_t(d) * 2;
  if (s1 == 1) strides[1] = strides[0] * heads;
  if (b == 1) strides[2] = strides[1] * s1;
  cuuint32_t box[4] = {64, 1, cuuint32_t(rows), 1};
  cuuint32_t elem[4] = {1, 1, 1, 1};
  CUresult r = encode(
      map, fp16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      4, const_cast<void*>(ptr), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// A 2-D map over a row-major (outer, inner) matrix whose rows lie
// `row_bytes` apart (a multiple of 16), loading boxes of 128 bytes (64
// 16-bit elements or 128 raw bytes) by box_outer rows with the 128-byte
// swizzle. Elements past either extent read as zeros. Returns a cudaError_t
// value.
inline int make_map_2d(CUtensorMap* map, const void* ptr,
                       CUtensorMapDataType type, int inner, int outer,
                       long long row_bytes, int box_outer) {
  auto encode = tensor_map_encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorSharedObjectSymbolNotFound);
  const bool bytes = type == CU_TENSOR_MAP_DATA_TYPE_UINT8;
  cuuint64_t dims[2] = {cuuint64_t(inner), cuuint64_t(outer)};
  cuuint64_t strides[1] = {cuuint64_t(row_bytes)};
  cuuint32_t box[2] = {bytes ? 128u : 64u, cuuint32_t(box_outer)};
  cuuint32_t elem[2] = {1, 1};
  CUresult r = encode(
      map, type, 2, const_cast<void*>(ptr), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// A 3-D map over a stack of matrices of 16-bit elements: extents (d0
// innermost, contiguous; d1; d2), the strides of d1 and d2 in bytes
// (multiples of 16), loading boxes of 64 x box1 x 1 with the 128-byte
// swizzle. Elements past any extent read as zeros, so a box never reads
// into the next matrix. Returns a cudaError_t value.
inline int make_map_3d(CUtensorMap* map, const void* ptr, bool fp16, int d0,
                       int d1, int d2, long long s1_bytes, long long s2_bytes,
                       int box1) {
  auto encode = tensor_map_encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorSharedObjectSymbolNotFound);
  cuuint64_t dims[3] = {cuuint64_t(d0), cuuint64_t(d1), cuuint64_t(d2)};
  cuuint64_t strides[2] = {cuuint64_t(s1_bytes), cuuint64_t(s2_bytes)};
  // a dim of extent 1 is never stepped: give it a packed stride, whatever
  // stride the caller's view has there
  if (d1 == 1) strides[0] = cuuint64_t(d0) * 2;
  if (d2 == 1) strides[1] = strides[0] * d1;
  cuuint32_t box[3] = {64, cuuint32_t(box1), 1};
  cuuint32_t elem[3] = {1, 1, 1};
  CUresult r = encode(
      map, fp16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      3, const_cast<void*>(ptr), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace hop
