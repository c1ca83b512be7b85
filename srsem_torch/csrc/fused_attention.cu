// The attention core of a ViT block for Hopper (sm_90a): from the qkv
// Linear's output to the heads merged, in one launch, bf16 with head width
// 64 and at most 256 tokens.
//
// Replaces no TPU kernel: the JAX package leaves attention to XLA
// (srsem/backbones/vit.py), and the port's plain PyTorch version of it
// (srsem_torch/ops/fused_attention.py::plain_attention) costs ten launches
// a block: two batched products on a generic GEMM, copies of q, k, v and of
// the merged heads, the division, the float32 softmax and its cast (about
// 15.6 device ms a batch of 64 pairs at 224 px, 46% of the ViT regressor's
// device time, against a bound of 0.555 ms).  The kernel computes the same
// function with the same rounding points:
//     s = bf16(bf16(q . k^T) * (1 / scale))            (float32 products)
//     p = bf16(exp(s - max_j s) / sum_j exp(s - max_j s))   (float32)
//     o = bf16(p . v)                                  (float32 products)
// with the float32 reciprocal of scale, as PyTorch divides a bf16 tensor by
// a scalar on the card, and expf in full float32 (no fast math), as its
// softmax takes it.  The reciprocal must be a bf16 value (heads of 64 give
// 1/8): the product of two bf16 values is exact in float32, so one bf16
// multiply gives the plain path's bits wherever the scaled score is 2^-134
// or more in magnitude.  The division is Markstein's (div_rn), and the
// float32 sums run in another order.  Keys past T are masked to -inf.
//
// What bounds it: bytes.  A ViT-B/16 pass at batch 64 (T = 197, 12 heads)
// reads the (64, 197, 2304) qkv output once (58.1 MB) and writes the
// (64, 197, 768) merged heads (19.4 MB): 23.1 us at 3.35 TB/s, against
// 7.6 GFLOP (7.7 us at 989 TFLOP/s).  The design moves those bytes and no
// others:
//   * A block takes one (image, head): one TMA load a 64-row box brings
//     its K, V and query tiles (head h's 64 columns of q, k and v, read in
//     place from the qkv rows through one 4-d tensor map of (64 columns,
//     3 heads blocks, T, N); boxes past T are zero-filled) into shared
//     memory once, K and the queries on one mbarrier, V on another, so
//     the first scores start before V lands.  No copy of q, k or v, and
//     no score or probability, is written to device memory.
//   * One warpgroup takes the query tiles in turn.  A tile's scores are
//     wgmma m64n64k16 products over NP = ceil(T / 64) key boxes, the
//     whole row of up to 256 keys in registers (128 float32 a thread), so
//     the softmax needs no online rescaling and keeps the plain path's
//     rounding points.  Each row lies in the four lanes of a quad: two
//     shuffles give its max and its sum.  Key groups of 8 wholly past T,
//     and warps whose 16 rows lie wholly past T, take no softmax work,
//     and P . V skips key slices of 16 wholly past T.
//   * The softmax, not the bytes, sets the pace (about 20 instructions a
//     score; a launch without it takes 0.036 ms at ViT-B/16's shape).  A division
//     costs about ten of them: dividing a row by one sum takes its
//     correctly rounded reciprocal once and two fmas a score (div_rn).
//     The bf16 scale is one bf16x2 multiply a column pair.
//   * P goes to P . V from registers: the accumulator fragment of a 64 x
//     16 slice of S is the A fragment of a register-A wgmma, so P is
//     rounded and packed in place; V stays MN-major in shared memory
//     (wgmma_m64n64k16_rs_mn).
//   * The output tile goes out through shared memory (the query tile's
//     own, whose last reader was the tile's score product) by one TMA
//     store into the head-merged (N, T, W) layout; rows past T are not
//     written.
//   * 128 threads a block at up to 255 registers and 3 x NP x 8 KB of
//     shared memory: two blocks an SM, whose loads and products overlap.
//     T = 197 gives 768 blocks at batch 64, under three waves.  On an H100
//     at that shape, against 0.077 ms a launch, these measured no faster:
//     a block a query tile (K and V loaded by each, 0.078; at three blocks
//     an SM the scores spill, 0.090), two warpgroups a block taking two
//     tiles each (0.082), and P . V over every key slice, without the
//     branch that makes ptxas wait on each register-A wgmma (0.077).
//
// Layouts (what srsem_torch/ops/fused_attention.py passes):
//   qkv : (N, T, 3 W) bf16, contiguous, W = 64 heads; q of head h is
//         columns 64 h.., k 64 (heads + h).., v 64 (2 heads + h)..
//   out : (N, T, W) bf16, contiguous, head h in columns 64 h..

#include <cuda_bf16.h>
#include <math.h>

#include <atomic>

#include "wgmma.cuh"

namespace {

using namespace hopper;

constexpr int kHeadDim = 64;   // one 128-byte line of bf16
constexpr int kRows = 64;      // query rows a tile, key rows a box
constexpr int kMaxTokens = 256;
constexpr int kBox = kRows * kHeadDim * 2;  // bytes of a 64-row box
constexpr int kThreads = 128;  // one warpgroup

// Dynamic shared memory of an instance: NP boxes of K, of V and of the
// query tiles, two mbarriers, and the slack to align the base to 1024.
constexpr int smem_bytes(int np) { return 3 * np * kBox + 16 + 1024; }

// a / b from r = RN(1 / b) by one correction (Markstein): q = RN(a r), then
// RN(q + (a - q b) r) with the remainder exact by fma.  For the softmax's
// a = exp(s - max) in [2^-100, 1] and sums b in [1, 257) it is IEEE
// division's RN(a / b): no pair of 8.6e9 checked on the card parted.  Below
// 2^-100 the remainder underflows and about one quotient in 200 parts by a
// float32 ulp, 2^-16 of P's bf16 ulp, which P's rounding hides but at a
// near-tie.  Three instructions a score where a division takes about ten;
// the softmax divides a row by one sum.
__device__ __forceinline__ float div_rn(float a, float b, float r) {
  const float q = a * r;
  return fmaf(fmaf(-q, b, a), r, q);
}

// Two values rounded to bf16, the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int NP>
__global__ void __launch_bounds__(kThreads, 2)
    fused_attention_kernel(const __grid_constant__ CUtensorMap qkv,
                           const __grid_constant__ CUtensorMap out, int t,
                           int heads, float inv_scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
      ~static_cast<uintptr_t>(1023));
  unsigned char* ks = smem;
  unsigned char* vs = smem + NP * kBox;
  unsigned char* qs = smem + 2 * NP * kBox;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + 3 * NP * kBox);
  const int n = blockIdx.x / heads, h = blockIdx.x - n * heads;

  if (threadIdx.x == 0) {
    mbar_init(&bars[0], 1);
    mbar_init(&bars[1], 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    prefetch_tensormap(&qkv);
    prefetch_tensormap(&out);
    mbar_expect_tx(&bars[0], 2 * NP * kBox);
#pragma unroll
    for (int b = 0; b < NP; ++b)
      tma_load_4d(ks + b * kBox, &qkv, &bars[0], 0, heads + h, b * kRows, n);
#pragma unroll
    for (int b = 0; b < NP; ++b)
      tma_load_4d(qs + b * kBox, &qkv, &bars[0], 0, h, b * kRows, n);
    mbar_expect_tx(&bars[1], NP * kBox);
#pragma unroll
    for (int b = 0; b < NP; ++b)
      tma_load_4d(vs + b * kBox, &qkv, &bars[1], 0, 2 * heads + h, b * kRows,
                  n);
  }
  __syncwarp();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // This thread's rows of a tile, r0 and r0 + 8, and its columns of each
  // group of 8, c0 and c0 + 1 (the accumulator fragment's).
  const int r0 = warp * 16 + lane / 4;
  const int c0 = 2 * (lane % 4);
  const uint32_t k_addr = smem_u32(ks), v_addr = smem_u32(vs);
  const __nv_bfloat162 scale2 = __float2bfloat162_rn(inv_scale);
  mbar_wait(&bars[0], 0);

#pragma unroll 1
  for (int i = 0; i < NP; ++i) {
    unsigned char* q = qs + i * kBox;
    const uint32_t q_addr = smem_u32(q);
    // S = Q_i . K^T: s[b] holds key box b's 64 columns.
    float s[NP][32];
#pragma unroll
    for (int b = 0; b < NP; ++b)
#pragma unroll
      for (int e = 0; e < 32; ++e) s[b][e] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int b = 0; b < NP; ++b)
#pragma unroll
      for (int kk = 0; kk < kHeadDim / 16; ++kk)
        wgmma_m64n64k16(s[b], smem_desc(q_addr + 32 * kk),
                        smem_desc(k_addr + b * kBox + 32 * kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int b = 0; b < NP; ++b) fence_accumulators(s[b]);

    // The row softmax; then P rounded and packed as the A fragments of the
    // k16 slices of P . V (slice kk: key box kk / 4, column groups
    // 2 (kk % 4) and 2 (kk % 4) + 1).
    uint32_t pa[4 * NP][4];
    if (i * kRows + warp * 16 < t) {
      // Both rows side by side, for two independent chains.  A group of 8
      // keys wholly past T (the warp agrees) takes no work and is 0.
      float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
#pragma unroll
      for (int b = 0; b < NP; ++b)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (b == NP - 1 && b * kRows + 8 * j >= t) continue;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            // A column pair's scores rounded to bf16 and scaled there.
            float* x = &s[b][4 * j + 2 * hh];
            const __nv_bfloat162 y =
                __hmul2(__floats2bfloat162_rn(x[0], x[1]), scale2);
            x[0] = __low2float(y);
            x[1] = __high2float(y);
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              if (b == NP - 1 && b * kRows + 8 * j + c0 + e >= t)
                x[e] = -INFINITY;
              mx[hh] = fmaxf(mx[hh], x[e]);
            }
          }
        }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      }
#pragma unroll
      for (int b = 0; b < NP; ++b)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const bool past = b == NP - 1 && b * kRows + 8 * j >= t;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float& x = s[b][4 * j + 2 * hh + e];
              x = past ? 0.f : expf(x - mx[hh]);
              sum[hh] += x;
            }
        }
      float rcp[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 1);
        sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 2);
        rcp[hh] = __frcp_rn(sum[hh]);
      }
#pragma unroll
      for (int b = 0; b < NP; ++b)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (b == NP - 1 && b * kRows + 8 * j >= t) continue;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float& x = s[b][4 * j + 2 * hh + e];
              x = div_rn(x, sum[hh], rcp[hh]);
            }
        }
#pragma unroll
      for (int kk = 0; kk < 4 * NP; ++kk) {
        const float* d = &s[kk / 4][8 * (kk % 4)];
        pa[kk][0] = pack_bf16(d[0], d[1]);
        pa[kk][1] = pack_bf16(d[2], d[3]);
        pa[kk][2] = pack_bf16(d[4], d[5]);
        pa[kk][3] = pack_bf16(d[6], d[7]);
      }
    } else {
      // 16 rows wholly past T: computed by the products, never stored.
#pragma unroll
      for (int kk = 0; kk < 4 * NP; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) pa[kk][r] = 0u;
    }

    // O_i = P . V over the key slices of 16 that hold a key before T (V's
    // rows past T are zeros, and so is P there).
    mbar_wait(&bars[1], 0);
    float o[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) o[e] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * NP; ++kk)
      if (16 * kk < t)
        wgmma_m64n64k16_rs_mn(o, pa[kk], smem_desc(v_addr + kk * 16 * 128),
                              kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_accumulators(o);

    // The tile out through the query tile's shared memory, laid out as the
    // TMA box is (16-byte chunks swizzled by row % 8), once every warp is
    // past the tile's score product, the tile's last reader.
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int m = r0 + 8 * hh;
        *reinterpret_cast<uint32_t*>(q + m * 128 + ((j ^ (m & 7)) << 4) +
                                     2 * c0) =
            pack_bf16(o[4 * j + 2 * hh], o[4 * j + 2 * hh + 1]);
      }
    fence_proxy_async();
    __syncthreads();
    if (threadIdx.x == 0) {
      tma_store_4d(&out, q, 0, h, i * kRows, n);
      tma_store_commit();
    }
    __syncwarp();
  }
  if (threadIdx.x == 0) tma_store_wait_read();
}

// A 4-d bf16 map of 64-column head blocks over rows of `blocks` such
// blocks: (64, blocks, t, n), 64-row boxes of one block.
int head_map(CUtensorMap* map, const void* base, int n, int t, int blocks) {
  const cuuint64_t line = kHeadDim * 2;
  const cuuint64_t dims[4] = {kHeadDim, static_cast<cuuint64_t>(blocks),
                              static_cast<cuuint64_t>(t),
                              static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[3] = {line, line * blocks,
                                 line * blocks * static_cast<cuuint64_t>(t)};
  const cuuint32_t box[4] = {kHeadDim, 1, kRows, 1};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, 4, dims,
                    strides, box);
}

template <int NP>
int launch(const CUtensorMap& mi, const CUtensorMap& mo, int n, int t,
           int heads, float inv_scale, cudaStream_t stream) {
  auto* kernel = fused_attention_kernel<NP>;
  constexpr int smem = smem_bytes(NP);
  // The attributes stay with the instance on a device: set them on its
  // first launch there (bit d of `ready` for device d), not at every one.
  static std::atomic<unsigned long long> ready{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (!(ready.load(std::memory_order_relaxed) & bit)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    // All of the SM's unified memory to shared memory: two blocks an SM.
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready.fetch_or(bit);
  }
  kernel<<<n * heads, kThreads, smem, stream>>>(mi, mo, t, heads, inv_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The attention core of `heads` heads of width 64 over n images of t <= 256
// tokens: qkv (n, t, 3 * 64 * heads) bf16 in, out (n, t, 64 * heads) bf16,
// both contiguous and 16-byte aligned; inv_scale is the float32 reciprocal
// of the scores' divisor, a bf16 value.  Launches on `stream`; returns the cudaError_t
// of the launch (0 = queued) or cudaErrorInvalidValue for shapes it does
// not take.
int srsem_fused_attention(const void* qkv, void* out, int n, int t, int heads,
                          float inv_scale, void* stream) {
  const auto invalid = static_cast<int>(cudaErrorInvalidValue);
  if (!qkv || !out || n < 1 || t < 1 || t > kMaxTokens || heads < 1 ||
      static_cast<long long>(n) * heads > 0x7fffffffLL ||
      reinterpret_cast<uintptr_t>(qkv) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return invalid;
  CUtensorMap mi, mo;
  int err = head_map(&mi, qkv, n, t, 3 * heads);
  if (err == 0) err = head_map(&mo, out, n, t, heads);
  if (err != 0) return err;
  const auto s = static_cast<cudaStream_t>(stream);
  switch ((t + kRows - 1) / kRows) {
    case 1: return launch<1>(mi, mo, n, t, heads, inv_scale, s);
    case 2: return launch<2>(mi, mo, n, t, heads, inv_scale, s);
    case 3: return launch<3>(mi, mo, n, t, heads, inv_scale, s);
    default: return launch<4>(mi, mo, n, t, heads, inv_scale, s);
  }
}

}  // extern "C"
