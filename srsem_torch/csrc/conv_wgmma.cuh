// One implicit-GEMM convolution for Hopper (sm_90a), shared by the port's
// fused kernels: fused_decoder.cu (a CLU decoder level, two launches) and
// fused_bottleneck.cu (a ResNet bottleneck, three launches).  A launch
// computes, with float32 sums,
//     out = relu(conv(x0, W0) + conv(x1, W1) + bias [+ res])      in T
// or, with a 1x1 head after it (the decoder's level 0),
//     out = relu(round_T(relu(conv + bias)) . head_w + head_b).
// The (x0, x1) channel concat is never built: K runs over (tap, channel of
// x0) and then (tap, channel of x1) into one accumulator.  A 3x3 conv has
// SAME padding; `res` (N, H, W, cout) is read at the output pixel.
//
// C[M, N] = A[M, K] . B[K, N] with M = output pixels, N = output channels,
// K = (input, tap, channel).
//
// Tensor cores: conv_wgmma<T, NT, HEAD>, for bf16 (every width a multiple
// of 64) and float32 (every width a multiple of 32).
//   * M: one warpgroup's 64-row wgmma tile is either an output patch of
//     bh x bw <= 64 pixels of one image (pick_patch), or 64 flat rows of
//     the (N*H*W, C) pixel matrix, across rows and images (no rows wasted
//     where 64-pixel patches do not tile the image: a 14x14 image takes
//     four 4x14 patches, 1.31x its rows).  A block computes two M tiles
//     (128 rows) by NT output channels; the caller picks NT (64, 128 or
//     256 in bf16; 32, 64 or 128 in float32).
//   * A k-step is one 128-byte swizzled line a row: 64 bf16 or 32 float32
//     channels (kChunk<T>).  A: per k-step one TMA box of (kChunk
//     channels, bw, bh, 1 image) at (c, c0 + dx - 1, r0 + dy - 1, n) for
//     tap (dy, dx); for flat rows of a 1x1 conv, (kChunk channels, 64
//     rows) at (c, 64 q); for flat rows of a 3x3 conv, TMA's im2col box:
//     64 pixels in order from the tile's first pixel (x0, y0, n0), each
//     read at its tap, (c, x0 - 1, y0 - 1, n0) with offsets (dx, dy), the
//     traversal stepping to the next row and image by itself.  The
//     hardware computes the addresses, zero-fills outside the tensor
//     (negative coordinates included; that is the SAME padding) and
//     swizzles for wgmma.  No im2col tensor in memory.
//   * B: the weights as a K-major (Cout, K) matrix, one TMA box of
//     (kChunk, NT) a k-step.
//   * A ring of min(stages, k-steps) stages guarded by mbarriers: one
//     producer warp issues the loads, two consumer warpgroups run wgmma
//     with one k-step in flight (288 threads a block).
//   * The epilogue adds the bias (and the residual), applies ReLU, rounds
//     to T into shared memory and stores the tile with TMA (or forms the
//     1x1 head).  A residual (flat tiles only) comes in by TMA, boxes of
//     (kChunk channels, 64 rows) issued before the first k-step, so its
//     bytes arrive during the products.  (With each thread's own 4-byte
//     stores, conv3 of ResNet-50's stage 0 moved its bytes at 1.7 TB/s on
//     an H100; through TMA, at 2.6 TB/s.)
//
// float32 (3xTF32).  The card's float32 FMA pipe (67 TFLOP/s) is 1/7 of
// its dense TF32 tensor-core rate (495 TFLOP/s), and TF32 alone keeps 10
// mantissa bits (about 1e-3 relative: too coarse for the float32 gates).
// So a float32 conv splits each operand x into hi = tf32(x) and lo =
// tf32(x - hi), both rounded to nearest (cvt.rna: x - hi is exact), and
// sums lo.hi + hi.lo + hi.hi on the tensor cores into one float32
// accumulator; the dropped lo.lo and lo's rounding are about 2^-22 of each
// product.  Three products bound it: 3 x operations / 495 TFLOP/s, a
// float32-accurate 165 TFLOP/s, 2.5x the FMA pipe.
//   * B: the weights come split once, when they are packed: a (2 Cout, K)
//     matrix, hi over lo, and a k-step loads both boxes.
//   * A: each consumer reads its thread's fragment of the arrived A tile
//     from shared memory (4 values a k8 slice), splits it in registers and
//     issues wgmma m64nNTk8 with A from registers: a k-step's eight small
//     products (lo.Bhi, hi.Blo) first, then its four hi.Bhi.
//   * The tensor core drops the bits of each sum below its accumulator's
//     last place, toward zero.  Summed straight into one accumulator,
//     those drops grow with K and bias the sum toward zero, past float32's
//     own error and past the 1e-4 gate at the decoder's K = 13,824.  So
//     each k-step's products go into a fresh accumulator, added to the
//     running float32 sum on the FMA pipe (rounded to nearest) once the
//     k-step is done, and the small products go first, while it is small.
//     Against a float64 reference the error is then 0.28-1.03x the plain
//     float32 version's (cuBLAS / cuDNN, TF32 off) at the main-path
//     shapes on an H100 (compare_f32_conv.py).  A warpgroup's k-steps then
//     do not overlap; its other warpgroup's (and, at NT <= 64 in the
//     bottleneck, a second block's) products fill the gap.
//   * Small M: nr_train's 7x7 and 14x14 convs have 7-25 M tiles at batch
//     8.  The plan (pick_tf32) takes N tiles as narrow as 32, so such a
//     conv still spreads over 64-128 blocks; its wave model counts three
//     products a k-step.  No split of K: every sum stays in one block, in
//     one order, and two launches give the same bits.
//   * The output tile (NT / 32 boxes of 8 KB a consumer) is staged in the
//     whole ring once both consumers are done with it.
// FMAs (bf16 at widths that are not a multiple of 64, float32 at widths
// that are not a multiple of 32, such as the v2 decoder's skip of 257):
// conv_fma, 64-pixel patches by 64 channels a block (block_gemm.cuh's
// gemm_fma).
//
// Each .cu instantiates the kernels under its own names (thin __global__
// wrappers, handed to the launchers by a Kernels struct), so a profile
// tells a bottleneck launch from a decoder launch, and sets its own launch
// bounds.

#pragma once

#include <initializer_list>

#include "block_gemm.cuh"
#include "wgmma.cuh"

namespace conv {

using namespace block_gemm;
using namespace hopper;

constexpr int kPatch = 64;        // rows of one M tile (wgmma M)
constexpr int kStepBytes = 128;   // one k-step of a row: one swizzled line
template <typename T>
constexpr int kChunk = kStepBytes / sizeof(T);  // channels of one k-step
constexpr int kConsumers = 2;  // consumer warpgroups a block
constexpr int kTcThreads = 128 * kConsumers + 32;  // + one producer warp
constexpr int kABytes = kPatch * kStepBytes;  // one M tile's A box at most
// Shared memory of an SM (228 KB); a block also takes 1 KB of it.
constexpr size_t kSmemPerSm = 233472;

// ---- what a launch computes, and how it is tiled ---------------------------

struct Conv {
  const void* x0;
  int c0;              // input 0: (N, H, W, c0)
  const void* x1;
  int c1;              // input 1: (N, H, W, c1), or null and 0
  int ks;              // taps a side: 3 (SAME padding) or 1
  const void* wt;      // (cout, ks*ks*(c0 + c1)) K-major, k = tap*C + c
  const float* bias;   // (cout)
  int cout;
  const void* res;     // (N, H, W, cout) added before the ReLU, or null
  void* out;           // (N, H, W, cout), or (N, H, W, head_co)
  const void* head_w;  // (head_co, cout) 1x1 head, or null
  const float* head_b;
  int head_co;
};

struct Patch {
  int bh, bw;
};

struct Tiling {
  bool flat;    // 64 flat pixel rows an M tile (3x3: im2col), else patches
  Patch patch;  // bh x bw pixels an M tile when not flat
  int nt;       // output channels a tensor-core block computes
  int stages;   // most ring stages (a launch takes min(stages, k-steps))
};

// The route a conv's shapes take (what the predicates and plans report).
enum Route { kFma = 0, kWgmmaBf16 = 1, kWgmmaTf32x3 = 2 };

// The current device's SM count, or 0.
inline int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return sms;
}

// The patch shape (bh x bw <= 64 pixels) that covers an h x w image with
// the fewest patches; ties go to the smaller patch (fewer bytes a TMA box),
// then the squarer one (less halo read again across taps), then the wider
// one (longer contiguous runs).  Rows are balanced: 28 rows in tiles of at
// most 4 are 4 each.
inline Patch pick_patch(int h, int w) {
  Patch best{1, 1};
  long long best_tiles = -1;
  int best_area = 0, best_side = 0;
  for (int bw = 1; bw <= (w < kPatch ? w : kPatch); ++bw) {
    const int cap = kPatch / bw < h ? kPatch / bw : h;
    const int row_tiles = (h + cap - 1) / cap;
    const int bh = (h + row_tiles - 1) / row_tiles;
    const long long tiles =
        static_cast<long long>(row_tiles) * ((w + bw - 1) / bw);
    const int area = bh * bw, side = bh < bw ? bh : bw;
    if (best_tiles < 0 || tiles < best_tiles ||
        (tiles == best_tiles &&
         (area < best_area || (area == best_area && side >= best_side)))) {
      best = {bh, bw};
      best_tiles = tiles;
      best_area = area;
      best_side = side;
    }
  }
  return best;
}

// M tiles of a launch over n images of h x w.
inline long long m_tiles(const Tiling& t, int n, int h, int w) {
  if (t.flat) return (static_cast<long long>(n) * h * w + kPatch - 1) / kPatch;
  return static_cast<long long>(n) * ((h + t.patch.bh - 1) / t.patch.bh) *
         ((w + t.patch.bw - 1) / t.patch.bw);
}

// Blocks of a tensor-core launch: pairs of M tiles by N tiles.  An odd
// last M tile is paired with a repeat of itself (computed, not stored).
inline long long tc_blocks(long long tiles, int cout, int nt) {
  return (tiles + kConsumers - 1) / kConsumers * (cout / nt);
}

// A stage: both consumers' A boxes and the weights' box (float32: the hi
// and the lo box).
__host__ __device__ constexpr int tc_stage_bytes(bool f32, int nt) {
  return kConsumers * kABytes + nt * kStepBytes * (f32 ? 2 : 1);
}
// A block's residual tiles: 64 rows by NT channels for each consumer.
__host__ __device__ constexpr int tc_res_bytes(bool f32, int nt) {
  return kConsumers * kPatch * nt * (f32 ? 4 : 2);
}
__host__ __device__ constexpr size_t tc_smem_bytes(bool f32, int nt,
                                                   int stages, bool res) {
  // Stages, the residual tiles, the stages' full and empty barriers and the
  // residual's, and 1024 bytes to align the base for the 128-byte swizzle.
  return static_cast<size_t>(stages) * tc_stage_bytes(f32, nt) +
         (res ? tc_res_bytes(f32, nt) : 0) +
         (2 * stages + 1) * sizeof(uint64_t) + 1024;
}
static_assert(tc_smem_bytes(false, 64, 8, false) <= kSmemLimit, "NT 64 stages");
static_assert(tc_smem_bytes(false, 128, 6, false) <= kSmemLimit, "NT 128 stages");
static_assert(tc_smem_bytes(false, 256, 4, false) <= kSmemLimit, "NT 256 stages");

// The float32 output tile of both consumers, staged in the ring: NT / 32
// boxes of 8 KB each.
__host__ __device__ constexpr int tf32_out_bytes(int nt) {
  return kConsumers * (nt / kChunk<float>) * kABytes;
}

// ---- the float32 plan -------------------------------------------------------

// The most ring stages (up to 8) a float32 block of N tile nt fits in its
// share of the SM when `per_sm` blocks share it; 0 if none.
inline int tf32_stages(int nt, bool res, int per_sm) {
  const size_t budget =
      per_sm == 1 ? kSmemLimit : kSmemPerSm / per_sm - 1024;
  for (int s = 8; s >= 1; --s)
    if (tc_smem_bytes(true, nt, s, res) <= budget) return s;
  return 0;
}

struct Tf32Tile {
  int nt, stages;
};

// The N tile (128, 64 or 32) and ring of a float32 conv with `tiles` M
// tiles and `steps` k-steps of 32 channels on `sms` SMs, by a wave model:
// the SM with the most blocks sets the time, and a block's k-step costs
// three NT-wide products and a fixed 32 cycles (its consumers read and
// split A, wait on barriers).  `two_per_sm`: blocks of NT <= 64 share an
// SM two at a time (the bottleneck's launch bounds), else one a block.  A
// conv without a residual stages its output tile in the ring, which has
// to hold it.  Ties go to the wider tile.  {0, 0}: no tile fits.
inline Tf32Tile pick_tf32(long long tiles, int cout, int steps, int sms,
                          bool res, bool two_per_sm) {
  Tf32Tile best{0, 0};
  double best_cost = 0.0;
  for (const int nt : {128, 64, 32}) {
    if (cout % nt) continue;
    const int stages = tf32_stages(nt, res, two_per_sm && nt < 128 ? 2 : 1);
    const int ring = stages < steps ? stages : steps;
    if (stages == 0 ||
        (!res && ring * tc_stage_bytes(true, nt) < tf32_out_bytes(nt)))
      continue;
    const long long per_sm = (tc_blocks(tiles, cout, nt) + sms - 1) / sms;
    const double cost =
        static_cast<double>(per_sm) * (3.0 * nt + 32.0) * steps;
    if (best.nt == 0 || cost < best_cost) {
      best = {nt, stages};
      best_cost = cost;
    }
  }
  return best;
}

// ---- tensor-core conv ------------------------------------------------------

struct TcArgs {
  int h, w;          // image size (pixels)
  int pixels;        // n * h * w
  int c0, c1;        // channels of input 0 and of input 1 (0: none)
  int ks;            // taps a side: 3 (SAME padding 1) or 1
  int cout;          // output channels (for the head: Cm, one N tile)
  int flat;          // M tiles are 64 flat pixel rows (ks 3: im2col boxes)
  int bh, bw, tiles_h, tiles_w;
  int tiles;         // M tiles
  int n_tiles;       // cout / NT
  int stages;        // ring stages
  const float* bias;
  int res;           // a residual comes in through the residual map
  void* out;         // the head's output (pixels, head_co), in T
  const void* head_w;  // (head_co, cout) in T, head only
  const float* head_b;
  int head_co;
};

// Patch q's image and top-left pixel.
__device__ __forceinline__ int3 patch_origin(const TcArgs& p, int q) {
  const int per_img = p.tiles_h * p.tiles_w;
  const int img = q / per_img, t = q - img * per_img;
  return make_int3(img, (t / p.tiles_w) * p.bh, (t % p.tiles_w) * p.bw);
}

// Where the loads of M tile q start: a patch's image and top-left pixel;
// a flat tile's first row (in .y) for a 1x1 conv, its first pixel's image,
// row and column for a 3x3 conv's im2col boxes.
__device__ __forceinline__ int3 tile_origin(const TcArgs& p, int q) {
  if (!p.flat) return patch_origin(p, q);
  const int r = q * kPatch;
  if (p.ks == 1) return make_int3(0, r, 0);
  const int per_img = p.h * p.w;
  const int img = r / per_img, t = r - img * per_img;
  return make_int3(img, t / p.w, t % p.w);
}

// Block b computes M tiles 2 * (b / n_tiles) + {0, 1} (warpgroups 0, 1)
// by output channels NT * (b % n_tiles) ..; the channel tiles of one pair
// of M tiles run side by side, so their A loads meet in L2.  A .cu wraps
// this in its own __global__ kernel; the tensor maps (inputs 0 and 1, the
// weights, the residual, the output) are its __grid_constant__
// parameters.  T = float runs 3xTF32 (the top of this file).
template <typename T, int NT, bool HEAD>
__device__ __forceinline__ void conv_wgmma(const CUtensorMap* in0,
                                           const CUtensorMap* in1,
                                           const CUtensorMap* wmap,
                                           const CUtensorMap* rmap,
                                           const CUtensorMap* omap,
                                           const TcArgs& p) {
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int kCh = kChunk<T>;
  constexpr int kStage = tc_stage_bytes(kF32, NT);
  constexpr int kRes = tc_res_bytes(kF32, NT);
  const int S = p.stages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
      ~static_cast<uintptr_t>(1023));
  unsigned char* res_tiles = smem + S * kStage;
  uint64_t* full = reinterpret_cast<uint64_t*>(res_tiles + (p.res ? kRes : 0));
  uint64_t* empty = full + S;
  uint64_t* res_full = empty + S;

  const int tn = blockIdx.x % p.n_tiles;
  const int pair = blockIdx.x / p.n_tiles;
  const int wg = threadIdx.x / 128;
  const int steps0 = p.ks * p.ks * (p.c0 / kCh);
  const int steps = steps0 + p.ks * p.ks * (p.c1 / kCh);

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_init(res_full, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // Producer warp: one thread keeps the ring full.
    if (threadIdx.x == kConsumers * 128) {
      prefetch_tensormap(in0);
      if (p.c1) prefetch_tensormap(in1);
      prefetch_tensormap(wmap);
      if (p.res) prefetch_tensormap(rmap);
      if (!HEAD) prefetch_tensormap(omap);
      int3 org[kConsumers];
#pragma unroll
      for (int i = 0; i < kConsumers; ++i) {
        // A missing last tile repeats the one before (computed, not stored).
        const int q0 = kConsumers * pair + i;
        org[i] = tile_origin(p, q0 < p.tiles ? q0 : p.tiles - 1);
      }
      const uint32_t a_bytes =
          p.flat ? kABytes : static_cast<uint32_t>(p.bh * p.bw * kStepBytes);
      const uint32_t bytes = kConsumers * a_bytes + (kStage - kConsumers * kABytes);
      if (p.res) {
        // The residual first: it lands while the products run.
        mbar_expect_tx(res_full, kRes);
#pragma unroll
        for (int i = 0; i < kConsumers; ++i)
#pragma unroll
          for (int b = 0; b < NT / kCh; ++b)
            tma_load_2d(res_tiles + (i * (NT / kCh) + b) * kABytes, rmap,
                        res_full, tn * NT + b * kCh, org[i].y);
      }
      const int pad = p.ks / 2;
      // The ring's slot and the phase of its barriers, stepped without a
      // division (S is a launch argument).
      int slot = 0, phase = 0;
      for (int s = 0; s < steps; ++s) {
        if (s >= S) mbar_wait(&empty[slot], phase ^ 1);
        mbar_expect_tx(&full[slot], bytes);
        const bool second = s >= steps0;
        const int t = second ? s - steps0 : s;
        const int chunks = (second ? p.c1 : p.c0) / kCh;
        const int tap = t / chunks, ch = t - tap * chunks;
        const int dy = tap / p.ks - pad, dx = tap % p.ks - pad;
        unsigned char* st = smem + slot * kStage;
        const CUtensorMap* in = second ? in1 : in0;
#pragma unroll
        for (int i = 0; i < kConsumers; ++i) {
          if (!p.flat)
            tma_load_4d(st + i * kABytes, in, &full[slot], ch * kCh,
                        org[i].z + dx, org[i].y + dy, org[i].x);
          else if (p.ks == 1)
            tma_load_2d(st + i * kABytes, in0, &full[slot], ch * kCh,
                        org[i].y);
          else
            tma_load_im2col_4d(st + i * kABytes, in, &full[slot], ch * kCh,
                               org[i].z - pad, org[i].y - pad, org[i].x,
                               dx + pad, dy + pad);
        }
        tma_load_2d(st + kConsumers * kABytes, wmap, &full[slot], s * kCh,
                    tn * NT);
        if constexpr (kF32)  // the weights' lo rows follow their hi rows
          tma_load_2d(st + kConsumers * kABytes + NT * kStepBytes, wmap,
                      &full[slot], s * kCh, p.cout + tn * NT);
        if (++slot == S) slot = 0, phase ^= 1;
      }
    }
  } else {
    // Consumer warpgroup wg: rows of M tile 2 * pair + wg.
    float acc[NT / 2];
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) acc[i] = 0.f;
    const uint32_t b0 = smem_u32(smem) + kConsumers * kABytes;
    const int lane = threadIdx.x % 32;
    // This thread's rows of the tile: r0 and r0 + 8.
    const int r0 = (threadIdx.x % 128) / 32 * 16 + lane / 4;
    int slot = 0, phase = 0;
    if constexpr (kF32) {
      // Each k-step's 12 products go into a fresh accumulator `part`,
      // added to acc on the FMA pipe (the top of this file says why).  A
      // is in registers by then, so the slot goes back to the producer as
      // soon as the products are done.
      float part[NT / 2];
      uint32_t hi[4][4], lo[4][4];
      for (int s = 0; s < steps; ++s) {
        mbar_wait(&full[slot], phase);
        const uint32_t off = slot * kStage;
        // The thread's tf32 fragment of each k8 slice kk: rows r0, r0 + 8
        // by columns 8 kk + lane % 4, + 4 (16-byte chunks 2 kk and 2 kk +
        // 1, swizzled by row % 8 = lane / 4), split into hi and lo.
        const unsigned char* at = smem + off + wg * kABytes;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int row = r0 + 8 * (i & 1), chunk = 2 * kk + (i >> 1);
            const float x = *reinterpret_cast<const float*>(
                at + row * kStepBytes + ((chunk ^ (lane / 4)) << 4) +
                (lane % 4) * 4);
            split_tf32(x, hi[kk][i], lo[kk][i]);
          }
        // The k-step's small terms (lo.Bhi, hi.Blo) first, while `part`
        // is small and drops least, then its four hi.Bhi slices.
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_m64k8_tf32<NT>(part, lo[kk], smem_desc(b0 + off + kk * 32),
                               kk > 0);
          wgmma_m64k8_tf32<NT>(
              part, hi[kk],
              smem_desc(b0 + off + NT * kStepBytes + kk * 32), 1);
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_m64k8_tf32<NT>(part, hi[kk], smem_desc(b0 + off + kk * 32), 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_accumulators(part);
#pragma unroll
        for (int i = 0; i < NT / 2; ++i) acc[i] += part[i];
        if (threadIdx.x % 128 == 0) mbar_arrive(&empty[slot]);
        if (++slot == S) slot = 0, phase ^= 1;
      }
    } else {
      const uint32_t a0 = smem_u32(smem) + wg * kABytes;
      int prev = 0;
      for (int s = 0; s < steps; ++s) {
        mbar_wait(&full[slot], phase);
        wgmma_fence();
        const uint32_t off = slot * kStage;
#pragma unroll
        for (int kk = 0; kk < kCh / 16; ++kk)
          wgmma_m64k16<NT>(acc, smem_desc(a0 + off + kk * 32),
                           smem_desc(b0 + off + kk * 32), 1);
        wgmma_commit();
        // k-step s - 1 is done: its slot goes back to the producer.
        wgmma_wait<1>();
        if (s > 0 && threadIdx.x % 128 == 0) mbar_arrive(&empty[prev]);
        prev = slot;
        if (++slot == S) slot = 0, phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_accumulators(acc);

    // Epilogue.  This thread holds rows r0 and r0 + 8 of the M tile,
    // columns 8j + 2 * (lane % 4) + {0, 1}.
    const int q = kConsumers * pair + wg;
    if constexpr (!HEAD) {
      // The output tile goes out through shared memory, laid out as a TMA
      // box is: per kChunk channels, 128-byte rows whose 16-byte chunks the
      // swizzle permutes by row % 8 (a quad's four lanes touch one or two
      // chunks, a warp's eight rows eight of each: no bank conflicts).  It
      // takes the residual's boxes in place (each thread reads its
      // residual elements and writes its outputs there); else, in bf16,
      // this consumer's A boxes of the first NT / 64 ring slots, which no
      // load touches any more, and in float32 (twice the boxes) the ring
      // from its start, once both consumers are done with it.  TMA then
      // writes whole lines and leaves out what lies outside the tensor (a
      // ragged tile's rows or pixels).
      if (kF32 && !p.res) named_barrier(3, kConsumers * 128);
      auto box = [&](int b) {
        if (p.res) return res_tiles + (wg * (NT / kCh) + b) * kABytes;
        return kF32 ? smem + (wg * (NT / kCh) + b) * kABytes
                    : smem + b * kStage + wg * kABytes;
      };
      if (p.res) mbar_wait(res_full, 0);
#pragma unroll
      for (int j = 0; j < NT / 8; ++j) {
        const int c = 8 * j + 2 * (lane % 4);
        const int cb = (c % kCh) * static_cast<int>(sizeof(T));  // byte in line
        const float2 b = *reinterpret_cast<const float2*>(p.bias + tn * NT + c);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int m = r0 + 8 * hh;
          T* e = reinterpret_cast<T*>(box(c / kCh) + m * kStepBytes +
                                      (((cb >> 4) ^ (m & 7)) << 4) + (cb & 15));
          const float2 r = p.res ? get(e, true) : make_float2(0.f, 0.f);
          put(e, fmaxf(acc[4 * j + 2 * hh] + b.x + r.x, 0.f),
              fmaxf(acc[4 * j + 2 * hh + 1] + b.y + r.y, 0.f), true);
        }
      }
      fence_proxy_async();
      named_barrier(1 + wg, 128);
      if (threadIdx.x % 128 == 0 && q < p.tiles) {
        const int3 org = p.flat ? make_int3(0, q * kPatch, 0)
                                : patch_origin(p, q);
#pragma unroll
        for (int b = 0; b < NT / kCh; ++b) {
          if (p.flat)
            tma_store_2d(omap, box(b), tn * NT + b * kCh, org.y);
          else
            tma_store_4d(omap, box(b), tn * NT + b * kCh, org.z, org.y,
                         org.x);
        }
        tma_store_commit_and_wait();
      }
    } else {
      // 1x1 head (patches): y[o] = relu(sum_c round(relu(h1_c + b1_c)) *
      // W2[o, c] + b2[o]); a row's channels lie in the four lanes of a quad.
      const T* head_w = static_cast<const T*>(p.head_w);
      T* out = static_cast<T*>(p.out);
      const int3 org = patch_origin(p, q < p.tiles ? q : 0);
      size_t pix[2];
      bool ok[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int m = r0 + 8 * hh;
        const int y = org.y + m / p.bw, x = org.z + m % p.bw;
        ok[hh] = q < p.tiles && m < p.bh * p.bw && y < p.h && x < p.w;
        pix[hh] = (static_cast<size_t>(org.x) * p.h + y) * p.w + x;
      }
      const int col0 = tn * NT + 2 * (lane % 4);
      for (int o = 0; o < p.head_co; ++o) {
        float part[2] = {0.f, 0.f};
#pragma unroll
        for (int j = 0; j < NT / 8; ++j) {
          const int col = col0 + 8 * j;
          const float2 b = *reinterpret_cast<const float2*>(p.bias + col);
          const float2 wv = get(head_w + static_cast<size_t>(o) * NT + col,
                                true);
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const float v0 = to_f(from_f<T>(
                fmaxf(acc[4 * j + 2 * hh] + b.x, 0.f)));
            const float v1 = to_f(from_f<T>(
                fmaxf(acc[4 * j + 2 * hh + 1] + b.y, 0.f)));
            part[hh] = fmaf(v0, wv.x, fmaf(v1, wv.y, part[hh]));
          }
        }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          part[hh] += __shfl_xor_sync(0xffffffffu, part[hh], 1);
          part[hh] += __shfl_xor_sync(0xffffffffu, part[hh], 2);
          if (lane % 4 == 0 && ok[hh])
            out[pix[hh] * p.head_co + o] =
                from_f<T>(fmaxf(part[hh] + p.head_b[o], 0.f));
        }
      }
    }
  }
}

template <typename T>
constexpr CUtensorMapDataType map_type() {
  return sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

// TMA map of an NHWC activation in T, box (kChunk channels, bw, bh, 1).
template <typename T>
int activation_map(CUtensorMap* map, const void* x, int n, int h, int w,
                   int c, Patch patch) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(c),
                              static_cast<cuuint64_t>(w),
                              static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(n)};
  const cuuint64_t row = static_cast<cuuint64_t>(c) * sizeof(T);
  const cuuint64_t strides[3] = {row, row * w, row * w * h};
  const cuuint32_t box[4] = {kChunk<T>, static_cast<cuuint32_t>(patch.bw),
                             static_cast<cuuint32_t>(patch.bh), 1};
  return encode_map(map, map_type<T>(), x, 4, dims, strides, box);
}

// TMA im2col map of an NHWC activation in T for a 3x3 conv over flat M
// tiles: boxes of 64 pixels by kChunk channels.
template <typename T>
int im2col_map(CUtensorMap* map, const void* x, int n, int h, int w, int c) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(c),
                              static_cast<cuuint64_t>(w),
                              static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(n)};
  const cuuint64_t row = static_cast<cuuint64_t>(c) * sizeof(T);
  const cuuint64_t strides[3] = {row, row * w, row * w * h};
  return encode_im2col_map(map, map_type<T>(), x, dims, strides, kChunk<T>,
                           kPatch);
}

// TMA map of a row-major (rows, k) matrix in T, box (kChunk, box_rows):
// the pixel matrix of a flat M tile, or K-major weights.
template <typename T>
int matrix_map(CUtensorMap* map, const void* a, long long rows, int k,
               int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(k),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(k) * sizeof(T)};
  const cuuint32_t box[2] = {kChunk<T>, static_cast<cuuint32_t>(box_rows)};
  return encode_map(map, map_type<T>(), a, 2, dims, strides, box);
}

template <class Kernels, typename T, int NT, bool HEAD>
int launch_tc_nt(const CUtensorMap& m0, const CUtensorMap& m1,
                 const CUtensorMap& mw, const CUtensorMap& mr,
                 const CUtensorMap& mo, const TcArgs& a, cudaStream_t stream) {
  auto* kernel = Kernels::template tc<T, NT, HEAD>();
  const size_t smem = tc_smem_bytes(sizeof(T) == 4, NT, a.stages, a.res != 0);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  // All of the SM's unified memory to shared memory, so that two blocks
  // fit where their stages and registers allow.
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = tc_blocks(a.tiles, a.cout, NT);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), kTcThreads, smem, stream>>>(
      m0, m1, mw, mr, mo, a);
  return static_cast<int>(cudaGetLastError());
}

// One conv on the tensor cores.  Needs c0, c1 and cout multiples of
// kChunk<T>, t.nt dividing cout (64, 128 or 256 in bf16; 32, 64 or 128 in
// float32); a flat tiling of a 1x1 conv needs one input; a residual needs
// a flat 1x1 conv; without one, a ring that holds the output tile (bf16: at
// least NT / 64 stages, so K >= NT); a head needs cout == t.nt and
// Kernels::kHead.  In float32, c.wt is the (2 cout, K) split weights (hi
// rows, then lo rows) and c.head_w is not split.
template <class Kernels, typename T>
int launch_tc(const Conv& c, int n, int h, int w, const Tiling& t,
              cudaStream_t stream) {
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int kCh = kChunk<T>;
  const long long pixels = static_cast<long long>(n) * h * w;
  const bool head = c.head_w != nullptr;
  const bool nt_ok = kF32 ? (t.nt == 32 || t.nt == 64 || t.nt == 128)
                          : (t.nt == 64 || t.nt == 128 || t.nt == 256);
  if (pixels > 0x7fffffffLL - kPatch || c.c0 % kCh || c.c1 % kCh || !nt_ok ||
      c.cout % t.nt || (t.flat && c.ks == 1 && c.c1 != 0) ||
      (c.res && !(t.flat && c.ks == 1)) ||
      (head && (c.cout != t.nt || t.flat)))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = m_tiles(t, n, h, w);
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap m0, m1, mw, mr, mo;
  // An input's map: patches' boxes, a flat 1x1 conv's rows, or a flat 3x3
  // conv's im2col boxes.
  auto input_map = [&](CUtensorMap* m, const void* x, int cin) {
    if (!t.flat) return activation_map<T>(m, x, n, h, w, cin, t.patch);
    if (c.ks == 1) return matrix_map<T>(m, x, pixels, cin, kPatch);
    return im2col_map<T>(m, x, n, h, w, cin);
  };
  int err = input_map(&m0, c.x0, c.c0);
  if (err == 0) {
    if (c.c1 > 0)
      err = input_map(&m1, c.x1, c.c1);
    else
      m1 = m0;
  }
  const int k = c.ks * c.ks * (c.c0 + c.c1);
  if (err == 0)
    err = matrix_map<T>(&mw, c.wt, (kF32 ? 2LL : 1LL) * c.cout, k, t.nt);
  if (err == 0) {
    if (c.res)
      err = matrix_map<T>(&mr, c.res, pixels, c.cout, kPatch);
    else
      mr = mw;
  }
  if (err == 0) {
    if (head)
      mo = mw;
    else if (t.flat)
      err = matrix_map<T>(&mo, c.out, pixels, c.cout, kPatch);
    else
      err = activation_map<T>(&mo, c.out, n, h, w, c.cout, t.patch);
  }
  if (err != 0) return err;
  TcArgs a{};
  a.h = h;
  a.w = w;
  a.pixels = static_cast<int>(pixels);
  a.c0 = c.c0;
  a.c1 = c.c1;
  a.ks = c.ks;
  a.cout = c.cout;
  a.flat = t.flat;
  a.bh = t.patch.bh;
  a.bw = t.patch.bw;
  a.tiles_h = t.flat ? 1 : (h + t.patch.bh - 1) / t.patch.bh;
  a.tiles_w = t.flat ? 1 : (w + t.patch.bw - 1) / t.patch.bw;
  a.tiles = static_cast<int>(tiles);
  a.n_tiles = c.cout / t.nt;
  const int steps = k / kCh;
  a.stages = t.stages < steps ? t.stages : steps;
  // Without a residual the output tile is staged in the ring: in bf16 its
  // first NT / 64 slots, in float32 its first tf32_out_bytes.
  if (!head && !c.res &&
      (kF32 ? a.stages * tc_stage_bytes(true, t.nt) < tf32_out_bytes(t.nt)
            : a.stages < t.nt / kCh))
    return static_cast<int>(cudaErrorInvalidValue);
  a.bias = c.bias;
  a.res = c.res != nullptr;
  a.out = c.out;
  a.head_w = c.head_w;
  a.head_b = c.head_b;
  a.head_co = c.head_co;
  if (head) {
    if constexpr (Kernels::kHead) {
      if constexpr (kF32) {
        switch (t.nt) {
          case 128: return launch_tc_nt<Kernels, T, 128, true>(m0, m1, mw, mr, mo, a, stream);
          case 64: return launch_tc_nt<Kernels, T, 64, true>(m0, m1, mw, mr, mo, a, stream);
          default: return launch_tc_nt<Kernels, T, 32, true>(m0, m1, mw, mr, mo, a, stream);
        }
      } else {
        switch (t.nt) {
          case 256: return launch_tc_nt<Kernels, T, 256, true>(m0, m1, mw, mr, mo, a, stream);
          case 128: return launch_tc_nt<Kernels, T, 128, true>(m0, m1, mw, mr, mo, a, stream);
          default: return launch_tc_nt<Kernels, T, 64, true>(m0, m1, mw, mr, mo, a, stream);
        }
      }
    }
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if constexpr (kF32) {
    switch (t.nt) {
      case 128: return launch_tc_nt<Kernels, T, 128, false>(m0, m1, mw, mr, mo, a, stream);
      case 64: return launch_tc_nt<Kernels, T, 64, false>(m0, m1, mw, mr, mo, a, stream);
      default: return launch_tc_nt<Kernels, T, 32, false>(m0, m1, mw, mr, mo, a, stream);
    }
  } else {
    switch (t.nt) {
      case 256: return launch_tc_nt<Kernels, T, 256, false>(m0, m1, mw, mr, mo, a, stream);
      case 128: return launch_tc_nt<Kernels, T, 128, false>(m0, m1, mw, mr, mo, a, stream);
      default: return launch_tc_nt<Kernels, T, 64, false>(m0, m1, mw, mr, mo, a, stream);
    }
  }
}

// ---- FMA conv (widths the tensor-core conv does not take) -----------------

template <typename T>
struct FmaArgs {
  const T* x0;
  const T* x1;
  int c0, c1, ks, h, w, cout, bh, bw, tiles_h, tiles_w;
  const T* wt;  // (cout, ks*ks*(c0 + c1)), K-major
  const float* bias;
  const T* res;  // (N, H, W, cout), or null
  T* out;
};

// Block (q, j): patch q by output channels 64 j .. 64 j + 63.
template <typename T>
__device__ __forceinline__ void conv_fma(const FmaArgs<T>& p) {
  __shared__ __align__(16) float stage[BK * (BM + BN)];
  const int per_img = p.tiles_h * p.tiles_w;
  const int img = blockIdx.x / per_img, t = blockIdx.x - img * per_img;
  const int r0 = (t / p.tiles_w) * p.bh, q0 = (t % p.tiles_w) * p.bw;
  const int n0 = blockIdx.y * BN;
  const size_t base = static_cast<size_t>(img) * p.h * p.w;
  const T* x0 = p.x0 + base * p.c0;
  const T* x1 = p.x1 ? p.x1 + base * p.c1 : nullptr;
  const T* res = p.res ? p.res + base * p.cout : nullptr;
  T* yo = p.out + base * p.cout;
  const int k0 = p.ks * p.ks * p.c0, k = k0 + p.ks * p.ks * p.c1;
  const int pad = p.ks / 2;

  // Output pixel of patch row m (offset within the image), or -1.
  auto pixel = [&](int m) {
    const int y = r0 + m / p.bw, x = q0 + m % p.bw;
    return m < p.bh * p.bw && y < p.h && x < p.w ? y * p.w + x : -1;
  };
  auto a_ptr = [&](int m, int kk) -> const T* {
    const int px = pixel(m);
    if (px < 0) return nullptr;
    const bool second = kk >= k0;
    const int cin = second ? p.c1 : p.c0;
    const int kr = second ? kk - k0 : kk;
    const int tap = kr / cin, c = kr - tap * cin;
    const int y = px / p.w + tap / p.ks - pad, x = px % p.w + tap % p.ks - pad;
    if (y < 0 || y >= p.h || x < 0 || x >= p.w) return nullptr;
    return (second ? x1 : x0) + static_cast<size_t>(y * p.w + x) * cin + c;
  };
  auto b_ptr = [&](int kk, int n) {
    return p.wt + static_cast<size_t>(n0 + n) * k + kk;
  };
  auto row = [&](int m) {
    const int px = pixel(m);
    return make_int2(px, px >= 0);
  };
  auto add_res = [&](int2 r, int n, bool) {
    return make_float2(
        res && r.y ? to_f(res[static_cast<size_t>(r.x) * p.cout + n0 + n])
                   : 0.f,
        0.f);
  };
  auto store = [&](int2 r, int n, float v0, float, bool, float2 rv) {
    if (r.y)
      yo[static_cast<size_t>(r.x) * p.cout + n0 + n] =
          from_f<T>(fmaxf(v0 + rv.x, 0.f));
  };
  const int nn = p.cout - n0 < BN ? p.cout - n0 : BN;
  gemm_fma<T>(kPatch, nn, k, a_ptr, b_ptr, p.bias + n0, row, add_res, store,
              reinterpret_cast<unsigned char*>(stage));
}

template <class Kernels, typename T>
int launch_fma(const Conv& c, int n, int h, int w, Patch patch,
               cudaStream_t stream) {
  FmaArgs<T> a{static_cast<const T*>(c.x0), static_cast<const T*>(c.x1),
               c.c0, c.c1, c.ks, h, w, c.cout, patch.bh, patch.bw,
               (h + patch.bh - 1) / patch.bh, (w + patch.bw - 1) / patch.bw,
               static_cast<const T*>(c.wt), c.bias,
               static_cast<const T*>(c.res), static_cast<T*>(c.out)};
  const long long patches = static_cast<long long>(n) * a.tiles_h * a.tiles_w;
  if (patches > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(patches), (c.cout + BN - 1) / BN);
  auto* kernel = Kernels::template fma<T>();
  kernel<<<grid, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace conv
