// Hopper building blocks for the port's kernels (sm_90a): mbarriers, TMA
// tensor loads and stores, warpgroup matrix multiplies (wgmma) on
// 128-byte-swizzled shared-memory tiles, and the host-side tensor-map
// encoder.
//
// The tile layout every helper here assumes: a K-major tile of R rows by
// 128 bytes (64 bf16 or 32 float32 columns), 1024-byte aligned, as a TMA
// load with CU_TENSOR_MAP_SWIZZLE_128B and a 128-byte inner box writes it.
// Its wgmma descriptor (smem_desc) is the same for both types: 8-row
// groups 1024 bytes apart, and the 32-byte k slice kk (a bf16 k16 or a
// tf32 k8) starts 32 * kk bytes in.  Element (row m, byte b) of the tile
// lies at m * 128 + ((b / 16) ^ (m % 8)) * 16 + b % 16.
//
// The tensor-map encoders come from libcuda through the runtime's entry
// point query, so a library that includes this header links no -lcuda.
// Users: conv_wgmma.cuh, fused_attention.cu.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers -----------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Makes initialised barriers visible to the other threads and to TMA (one
// thread, before the block's __syncthreads).
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive once and expect `bytes` more of TMA transactions in this phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Spin until the phase of parity `parity` has completed.  A phase that
// has not completed after about 2^34 cycles (10 s) is a fault (a load that
// never lands, a count that does not match): trap rather than hang.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  long long start = -1;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (!done) {
      const long long now = clock64();
      if (start < 0)
        start = now;
      else if (now - start > (1LL << 34))
        __trap();
    }
  } while (!done);
}

// ---- TMA tensor loads (global -> shared, completion on an mbarrier) -------
// Coordinates are in elements, innermost first, and may lie outside the
// tensor (negative too): TMA fills those elements with zeros and still
// counts the whole box towards the barrier's transactions.

// Brings a tensor map into the TMA unit's cache ahead of its first load.
__device__ __forceinline__ void prefetch_tensormap(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// An im2col load: the map's box of pixels (its pixelsPerColumn rows, one
// 128-byte line of channels from c each), taken in the map's traversal
// order from pixel (w, h, n) on: w fastest, then h, then n, each within the
// range the map's corners bound.  Each pixel is read at (w + ow, h + oh),
// ow and oh in 0..2 for a 3x3 conv's tap.
__device__ __forceinline__ void tma_load_im2col_4d(void* dst,
                                                   const CUtensorMap* map,
                                                   uint64_t* bar, int c,
                                                   int w, int h, int n,
                                                   int ow, int oh) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.im2col.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2], {%7, %8};\n" ::
          "r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c),
      "r"(w), "r"(h), "r"(n), "h"(static_cast<uint16_t>(ow)),
      "h"(static_cast<uint16_t>(oh))
      : "memory");
}

// ---- TMA tensor stores (shared -> global) ---------------------------------
// Elements of the box outside the tensor are not written.  The writing
// threads fence their shared-memory stores to the async proxy and meet at a
// barrier first; one thread stores, commits, and waits until the box has
// been read before the shared memory is reused or the block exits.

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Barrier `id` (1..15) over `threads` threads (a multiple of 32).
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             const void* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], "
      "[%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Commit the stores issued so far; wait until every committed store has
// read its box (a thread that stores several boxes waits once, before its
// shared memory goes away).
__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void tma_store_commit_and_wait() {
  tma_store_commit();
  tma_store_wait_read();
}

// ---- warpgroups ------------------------------------------------------------

// wgmma descriptor of a K-major, 128-byte-swizzled bf16 tile at shared
// address `addr` (see the top of this file): start address >> 4, leading
// offset 1 (unused when swizzled), stride 1024 bytes between 8-row groups,
// layout 1 = 128-byte swizzle.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of the accumulators
// across the asynchronous wgmma that owns them.
template <int R>
__device__ __forceinline__ void fence_accumulators(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A . B for a 64 x N x 16 slice: A and B are K-major bf16 tiles
// given by descriptors, d the warpgroup's float32 accumulator fragment
// (N / 2 values a thread: d[4j + 2h + e] is row 16 * warp + lane / 4 + 8h,
// column 8j + 2 * (lane % 4) + e).  scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t a,
                                                 uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t a,
                                                 uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t a,
                                                 uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (+)= A . B for a 64 x 64 x 16 slice in bf16 with A from registers and
// B MN-major: a[0..3] hold rows 16 * warp + lane / 4 (+8 for a[1], a[3])
// by columns 2 * (lane % 4) + {0, 1} (+8 for a[2], a[3]) of the slice, two
// bf16 a register, the lower column in the low half (mma.m16n8k16's A
// fragment: the accumulator fragment of a 64 x 16 slice of d, rounded and
// packed); B is 16 rows of k by 64 columns of n, one 128-byte swizzled line
// a k (a tile as a TMA load of (k, n) rows writes it; the descriptor is
// smem_desc's, read transposed).
__device__ __forceinline__ void wgmma_m64n64k16_rs_mn(float (&d)[32],
                                                      const uint32_t (&a)[4],
                                                      uint64_t b,
                                                      int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma_m64k16(float (&d)[N / 2], uint64_t a,
                                             uint64_t b, int scale_d) {
  if constexpr (N == 64)
    wgmma_m64n64k16(d, a, b, scale_d);
  else if constexpr (N == 128)
    wgmma_m64n128k16(d, a, b, scale_d);
  else
    wgmma_m64n256k16(d, a, b, scale_d);
}

// ---- tf32 (float32 operands on the tensor cores) -----------------------------

// x rounded to tf32 (10 mantissa bits), to nearest with ties away from
// zero: its 13 low bits are zero, so x - hi is exact in float32.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo + e with hi = tf32(x), lo = tf32(x - hi) and |e| <= 2^-22 |x|
// (the 3xTF32 split).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// d (+)= A . B for a 64 x N x 8 slice in tf32: A from registers (a[0..3]
// is row 16 * warp + lane / 4 (+8 for a[1], a[3]), column lane % 4 (+4 for
// a[2], a[3]) of the slice, as mma.m16n8k8's tf32 fragment), B a K-major
// float32 tile given by its descriptor; d as in the bf16 products.
__device__ __forceinline__ void wgmma_m64n32k8_tf32(float (&d)[16],
                                                    const uint32_t (&a)[4],
                                                    uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n64k8_tf32(float (&d)[32],
                                                    const uint32_t (&a)[4],
                                                    uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n128k8_tf32(float (&d)[64],
                                                    const uint32_t (&a)[4],
                                                    uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma_m64k8_tf32(float (&d)[N / 2],
                                                 const uint32_t (&a)[4],
                                                 uint64_t b, int scale_d) {
  if constexpr (N == 32)
    wgmma_m64n32k8_tf32(d, a, b, scale_d);
  else if constexpr (N == 64)
    wgmma_m64n64k8_tf32(d, a, b, scale_d);
  else
    wgmma_m64n128k8_tf32(d, a, b, scale_d);
}

// ---- host: tensor maps -----------------------------------------------------

// libcuda's function `name` (CUDA 12.0's signature), or null.
inline void* libcuda_fn(const char* name) {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  cudaGetDriverEntryPointByVersion(name, &fn, 12000, cudaEnableDefault,
                                   &found);
#else
  cudaGetDriverEntryPoint(name, &fn, cudaEnableDefault, &found);
#endif
  return found == cudaDriverEntryPointSuccess ? fn : nullptr;
}

// A bf16 or float32 tensor map with 128-byte swizzle over `base`: dims
// innermost first, byte strides of dims 1.. (multiples of 16), box in
// elements (the innermost box 128 bytes: 64 bf16 or 32 float32).  Returns
// 0 or a cudaError_t.
inline int encode_map(CUtensorMap* map, CUtensorMapDataType type,
                      const void* base, int rank, const cuuint64_t* dims,
                      const cuuint64_t* strides, const cuuint32_t* box) {
  using Encode = decltype(&cuTensorMapEncodeTiled);
  static const Encode encode =
      reinterpret_cast<Encode>(libcuda_fn("cuTensorMapEncodeTiled"));
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  const CUresult r = encode(
      map, type, static_cast<cuuint32_t>(rank),
      const_cast<void*>(base), dims, strides, box, ones,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// An im2col map of an NHWC tensor for a 3x3 conv with SAME padding (dims
// {c, w, h, n}, byte strides of w, h, n): the traversal runs over the top-
// left taps of the output pixels, (-1 .. w - 2, -1 .. h - 2) in each image,
// and a box is `pixels` rows of `channels` (one 128-byte line), with
// 128-byte swizzle.  Returns 0 or a cudaError_t.
inline int encode_im2col_map(CUtensorMap* map, CUtensorMapDataType type,
                             const void* base, const cuuint64_t* dims,
                             const cuuint64_t* strides, cuuint32_t channels,
                             cuuint32_t pixels) {
  using Encode = decltype(&cuTensorMapEncodeIm2col);
  static const Encode encode =
      reinterpret_cast<Encode>(libcuda_fn("cuTensorMapEncodeIm2col"));
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const int lower[2] = {-1, -1}, upper[2] = {-1, -1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, type, 4, const_cast<void*>(base), dims, strides, lower, upper,
      channels, pixels, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace hopper
