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
// Tensor cores (bf16, every width a multiple of 64): conv_wgmma.
//   * M: one warpgroup's 64-row wgmma tile is either an output patch of
//     bh x bw <= 64 pixels of one image (pick_patch), or, for a 1x1 conv,
//     64 flat rows of the (N*H*W, C) pixel matrix (no rows wasted on a
//     patch that does not fill 64, and one 2-D TMA box a k-step).  A block
//     computes two M tiles (128 rows) by NT = 64, 128 or 256 output
//     channels; the caller picks NT.
//   * A: per k-step one TMA box of (64 channels, bw, bh, 1 image) at
//     (c, c0 + dx - 1, r0 + dy - 1, n) for tap (dy, dx), or (64 channels,
//     64 rows) at (c, 64 q): the hardware computes the addresses,
//     zero-fills outside the tensor (negative coordinates included; that
//     is the SAME padding) and swizzles for wgmma.  No im2col.
//   * B: the weights as a K-major (Cout, K) matrix, one TMA box of
//     (64, NT) a k-step.
//   * A ring of min(stages, k-steps) stages guarded by mbarriers: one
//     producer warp issues the loads, two consumer warpgroups run wgmma
//     m64nNTk16 with one k-step in flight (288 threads a block).
//   * The epilogue adds the bias (and the residual), applies ReLU, rounds
//     to bf16 into shared memory and stores the tile with TMA (or forms
//     the 1x1 head).  A residual (flat tiles only) comes in by TMA, boxes
//     of (64 channels, 64 rows) issued before the first k-step, so its
//     bytes arrive during the products.  (With each thread's own 4-byte
//     stores, conv3 of ResNet-50's stage 0 moved its bytes at 1.7 TB/s on
//     an H100; through TMA, at 2.6 TB/s.)
// FMAs (float32, and bf16 at other widths): conv_fma, 64-pixel patches by
// 64 channels a block (block_gemm.cuh's gemm_fma), bound by the 67 TFLOP/s
// FMA pipe.
//
// Each .cu instantiates the kernels under its own names (thin __global__
// wrappers, handed to the launchers by a Kernels struct), so a profile
// tells a bottleneck launch from a decoder launch, and sets its own launch
// bounds.

#pragma once

#include "block_gemm.cuh"
#include "wgmma.cuh"

namespace conv {

using namespace block_gemm;
using namespace hopper;

constexpr int kPatch = 64;     // rows of one M tile (wgmma M)
constexpr int kChunk = 64;     // channels of one k-step (128 bytes of bf16)
constexpr int kConsumers = 2;  // consumer warpgroups a block
constexpr int kTcThreads = 128 * kConsumers + 32;  // + one producer warp
constexpr int kABytes = kPatch * kChunk * 2;  // one M tile's A box at most

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
  bool flat;    // 64 flat pixel rows an M tile (1x1 convs), else patches
  Patch patch;  // bh x bw pixels an M tile when not flat
  int nt;       // output channels a tensor-core block computes
  int stages;   // most ring stages (a launch takes min(stages, k-steps))
};

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

template <int NT>
__host__ __device__ constexpr int tc_stage_bytes() {
  return kConsumers * kABytes + NT * kChunk * 2;
}
// A block's residual tiles: 64 rows by NT channels for each consumer.
template <int NT>
__host__ __device__ constexpr int tc_res_bytes() {
  return kConsumers * kPatch * NT * 2;
}
template <int NT>
__host__ __device__ constexpr size_t tc_smem_bytes(int stages, bool res) {
  // Stages, the residual tiles, the stages' full and empty barriers and the
  // residual's, and 1024 bytes to align the base for the 128-byte swizzle.
  return static_cast<size_t>(stages) * tc_stage_bytes<NT>() +
         (res ? tc_res_bytes<NT>() : 0) +
         (2 * stages + 1) * sizeof(uint64_t) + 1024;
}
static_assert(tc_smem_bytes<64>(8, false) <= kSmemLimit, "NT 64 stages");
static_assert(tc_smem_bytes<128>(6, false) <= kSmemLimit, "NT 128 stages");
static_assert(tc_smem_bytes<256>(4, false) <= kSmemLimit, "NT 256 stages");

// ---- tensor-core conv (bf16) ---------------------------------------------

struct TcArgs {
  int h, w;          // image size (pixels)
  int pixels;        // n * h * w
  int c0, c1;        // channels of input 0 and of input 1 (0: none)
  int ks;            // taps a side: 3 (SAME padding 1) or 1
  int cout;          // output channels (for the head: Cm, one N tile)
  int flat;          // M tiles are 64 flat pixel rows (ks 1, one input)
  int bh, bw, tiles_h, tiles_w;
  int tiles;         // M tiles
  int n_tiles;       // cout / NT
  int stages;        // ring stages
  const float* bias;
  int res;           // a residual comes in through the residual map
  bf16* out;         // the head's output (pixels, head_co)
  const bf16* head_w;  // (head_co, cout), head only
  const float* head_b;
  int head_co;
};

// Patch q's image and top-left pixel.
__device__ __forceinline__ int3 patch_origin(const TcArgs& p, int q) {
  const int per_img = p.tiles_h * p.tiles_w;
  const int img = q / per_img, t = q - img * per_img;
  return make_int3(img, (t / p.tiles_w) * p.bh, (t % p.tiles_w) * p.bw);
}

// Block b computes M tiles 2 * (b / n_tiles) + {0, 1} (warpgroups 0, 1)
// by output channels NT * (b % n_tiles) ..; the channel tiles of one pair
// of M tiles run side by side, so their A loads meet in L2.  A .cu wraps
// this in its own __global__ kernel; the tensor maps (inputs 0 and 1, the
// weights, the residual, the output) are its __grid_constant__
// parameters.
template <int NT, bool HEAD>
__device__ __forceinline__ void conv_wgmma(const CUtensorMap* in0,
                                           const CUtensorMap* in1,
                                           const CUtensorMap* wmap,
                                           const CUtensorMap* rmap,
                                           const CUtensorMap* omap,
                                           const TcArgs& p) {
  constexpr int kStage = tc_stage_bytes<NT>();
  const int S = p.stages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
      ~static_cast<uintptr_t>(1023));
  unsigned char* res_tiles = smem + S * kStage;
  uint64_t* full = reinterpret_cast<uint64_t*>(
      res_tiles + (p.res ? tc_res_bytes<NT>() : 0));
  uint64_t* empty = full + S;
  uint64_t* res_full = empty + S;

  const int tn = blockIdx.x % p.n_tiles;
  const int pair = blockIdx.x / p.n_tiles;
  const int wg = threadIdx.x / 128;
  const int steps0 = p.ks * p.ks * (p.c0 / kChunk);
  const int steps = steps0 + p.ks * p.ks * (p.c1 / kChunk);

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
        const int q = q0 < p.tiles ? q0 : p.tiles - 1;
        org[i] = p.flat ? make_int3(0, q * kPatch, 0) : patch_origin(p, q);
      }
      const uint32_t a_bytes =
          p.flat ? kABytes : static_cast<uint32_t>(p.bh * p.bw * kChunk * 2);
      const uint32_t bytes = kConsumers * a_bytes + NT * kChunk * 2;
      if (p.res) {
        // The residual first: it lands while the products run.
        mbar_expect_tx(res_full, tc_res_bytes<NT>());
#pragma unroll
        for (int i = 0; i < kConsumers; ++i)
#pragma unroll
          for (int b = 0; b < NT / kChunk; ++b)
            tma_load_2d(res_tiles + (i * (NT / kChunk) + b) * kABytes, rmap,
                        res_full, tn * NT + b * kChunk, org[i].y);
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
        const int chunks = (second ? p.c1 : p.c0) / kChunk;
        const int tap = t / chunks, ch = t - tap * chunks;
        const int dy = tap / p.ks - pad, dx = tap % p.ks - pad;
        unsigned char* st = smem + slot * kStage;
#pragma unroll
        for (int i = 0; i < kConsumers; ++i) {
          if (p.flat)
            tma_load_2d(st + i * kABytes, in0, &full[slot], ch * kChunk,
                        org[i].y);
          else
            tma_load_4d(st + i * kABytes, second ? in1 : in0, &full[slot],
                        ch * kChunk, org[i].z + dx, org[i].y + dy, org[i].x);
        }
        tma_load_2d(st + kConsumers * kABytes, wmap, &full[slot], s * kChunk,
                    tn * NT);
        if (++slot == S) slot = 0, phase ^= 1;
      }
    }
  } else {
    // Consumer warpgroup wg: rows of M tile 2 * pair + wg.
    float acc[NT / 2];
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) acc[i] = 0.f;
    const uint32_t a0 = smem_u32(smem) + wg * kABytes;
    const uint32_t b0 = smem_u32(smem) + kConsumers * kABytes;
    int slot = 0, phase = 0, prev = 0;
    for (int s = 0; s < steps; ++s) {
      mbar_wait(&full[slot], phase);
      wgmma_fence();
      const uint32_t off = slot * kStage;
#pragma unroll
      for (int kk = 0; kk < kChunk / 16; ++kk)
        wgmma_m64k16<NT>(acc, smem_desc(a0 + off + kk * 32),
                         smem_desc(b0 + off + kk * 32), 1);
      wgmma_commit();
      // k-step s - 1 is done: its slot goes back to the producer.
      wgmma_wait<1>();
      if (s > 0 && threadIdx.x % 128 == 0) mbar_arrive(&empty[prev]);
      prev = slot;
      if (++slot == S) slot = 0, phase ^= 1;
    }
    wgmma_wait<0>();
    fence_accumulators(acc);

    // Epilogue.  This thread holds rows r and r + 8 of the M tile, columns
    // 8j + 2 * (lane % 4) + {0, 1}.
    const int lane = threadIdx.x % 32;
    const int q = kConsumers * pair + wg;
    const int r0 = (threadIdx.x % 128) / 32 * 16 + lane / 4;
    if constexpr (!HEAD) {
      // The output tile goes out through shared memory, laid out as a TMA
      // box is: per 64 channels, 128-byte rows whose 16-byte chunks the
      // swizzle permutes by row % 8 (a quad's four lanes touch one chunk, a
      // warp's eight rows eight chunks: no bank conflicts).  It takes the
      // residual's boxes in place (each thread reads its residual elements
      // and writes its outputs there), else this consumer's A boxes of the
      // first NT / 64 ring slots, which no load touches any more.  TMA
      // then writes whole lines and leaves out what lies outside the
      // tensor (a ragged tile's rows or pixels).
      auto box = [&](int b) {
        return p.res ? res_tiles + (wg * (NT / kChunk) + b) * kABytes
                     : smem + b * kStage + wg * kABytes;
      };
      if (p.res) mbar_wait(res_full, 0);
#pragma unroll
      for (int j = 0; j < NT / 8; ++j) {
        const int c = 8 * j + 2 * (lane % 4);
        const float2 b = *reinterpret_cast<const float2*>(p.bias + tn * NT + c);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int m = r0 + 8 * hh;
          bf16* e = reinterpret_cast<bf16*>(
              box(c / kChunk) + m * 128 +
              ((((c % kChunk) >> 3) ^ (m & 7)) << 4) + (c % 8) * 2);
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
        for (int b = 0; b < NT / kChunk; ++b) {
          if (p.flat)
            tma_store_2d(omap, box(b), tn * NT + b * kChunk, org.y);
          else
            tma_store_4d(omap, box(b), tn * NT + b * kChunk, org.z, org.y,
                         org.x);
        }
        tma_store_commit_and_wait();
      }
    } else {
      // 1x1 head (patches): y[o] = relu(sum_c round(relu(h1_c + b1_c)) *
      // W2[o, c] + b2[o]); a row's channels lie in the four lanes of a quad.
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
          const float2 wv = get(p.head_w + static_cast<size_t>(o) * NT + col,
                                true);
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const float v0 = to_f(from_f<bf16>(
                fmaxf(acc[4 * j + 2 * hh] + b.x, 0.f)));
            const float v1 = to_f(from_f<bf16>(
                fmaxf(acc[4 * j + 2 * hh + 1] + b.y, 0.f)));
            part[hh] = fmaf(v0, wv.x, fmaf(v1, wv.y, part[hh]));
          }
        }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          part[hh] += __shfl_xor_sync(0xffffffffu, part[hh], 1);
          part[hh] += __shfl_xor_sync(0xffffffffu, part[hh], 2);
          if (lane % 4 == 0 && ok[hh])
            p.out[pix[hh] * p.head_co + o] =
                from_f<bf16>(fmaxf(part[hh] + p.head_b[o], 0.f));
        }
      }
    }
  }
}

// TMA map of an NHWC bf16 activation, box (64 channels, bw, bh, 1).
inline int activation_map(CUtensorMap* map, const void* x, int n, int h,
                          int w, int c, Patch patch) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(c),
                              static_cast<cuuint64_t>(w),
                              static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(n)};
  const cuuint64_t row = static_cast<cuuint64_t>(c) * 2;
  const cuuint64_t strides[3] = {row, row * w, row * w * h};
  const cuuint32_t box[4] = {kChunk, static_cast<cuuint32_t>(patch.bw),
                             static_cast<cuuint32_t>(patch.bh), 1};
  return encode_bf16_map(map, x, 4, dims, strides, box);
}

// TMA map of a row-major (rows, k) bf16 matrix, box (64, box_rows): the
// pixel matrix of a flat M tile, or K-major weights.
inline int matrix_map(CUtensorMap* map, const void* a, long long rows, int k,
                      int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(k),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(k) * 2};
  const cuuint32_t box[2] = {kChunk, static_cast<cuuint32_t>(box_rows)};
  return encode_bf16_map(map, a, 2, dims, strides, box);
}

template <class Kernels, int NT, bool HEAD>
int launch_tc_nt(const CUtensorMap& m0, const CUtensorMap& m1,
                 const CUtensorMap& mw, const CUtensorMap& mr,
                 const CUtensorMap& mo, const TcArgs& a, cudaStream_t stream) {
  auto* kernel = Kernels::template tc<NT, HEAD>();
  const size_t smem = tc_smem_bytes<NT>(a.stages, a.res != 0);
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

// One conv on the tensor cores.  Needs bf16, c0, c1 and cout multiples of
// 64, t.nt dividing cout; a flat tiling needs ks 1 and one input; a
// residual needs a flat tiling; without one, a ring of at least NT / 64
// stages (so K >= NT); a head needs cout == t.nt and Kernels::kHead.
template <class Kernels>
int launch_tc(const Conv& c, int n, int h, int w, const Tiling& t,
              cudaStream_t stream) {
  const long long pixels = static_cast<long long>(n) * h * w;
  const bool head = c.head_w != nullptr;
  if (pixels > 0x7fffffffLL - kPatch || c.c0 % kChunk || c.c1 % kChunk ||
      (t.nt != 64 && t.nt != 128 && t.nt != 256) || c.cout % t.nt ||
      (t.flat && (c.ks != 1 || c.c1 != 0)) || (c.res && !t.flat) ||
      (head && c.cout != t.nt))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = m_tiles(t, n, h, w);
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap m0, m1, mw, mr, mo;
  int err = t.flat ? matrix_map(&m0, c.x0, pixels, c.c0, kPatch)
                   : activation_map(&m0, c.x0, n, h, w, c.c0, t.patch);
  if (err == 0) {
    if (c.c1 > 0)
      err = activation_map(&m1, c.x1, n, h, w, c.c1, t.patch);
    else
      m1 = m0;
  }
  const int k = c.ks * c.ks * (c.c0 + c.c1);
  if (err == 0) err = matrix_map(&mw, c.wt, c.cout, k, t.nt);
  if (err == 0) {
    if (c.res)
      err = matrix_map(&mr, c.res, pixels, c.cout, kPatch);
    else
      mr = mw;
  }
  if (err == 0) {
    if (head)
      mo = mw;
    else if (t.flat)
      err = matrix_map(&mo, c.out, pixels, c.cout, kPatch);
    else
      err = activation_map(&mo, c.out, n, h, w, c.cout, t.patch);
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
  const int steps = k / kChunk;
  a.stages = t.stages < steps ? t.stages : steps;
  // Without a residual the output tile is staged in the ring's first
  // NT / 64 slots.
  if (!head && !c.res && a.stages < t.nt / kChunk)
    return static_cast<int>(cudaErrorInvalidValue);
  a.bias = c.bias;
  a.res = c.res != nullptr;
  a.out = static_cast<bf16*>(c.out);
  a.head_w = static_cast<const bf16*>(c.head_w);
  a.head_b = c.head_b;
  a.head_co = c.head_co;
  if (head) {
    if constexpr (Kernels::kHead) {
      switch (t.nt) {
        case 256: return launch_tc_nt<Kernels, 256, true>(m0, m1, mw, mr, mo, a, stream);
        case 128: return launch_tc_nt<Kernels, 128, true>(m0, m1, mw, mr, mo, a, stream);
        default: return launch_tc_nt<Kernels, 64, true>(m0, m1, mw, mr, mo, a, stream);
      }
    }
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (t.nt) {
    case 256: return launch_tc_nt<Kernels, 256, false>(m0, m1, mw, mr, mo, a, stream);
    case 128: return launch_tc_nt<Kernels, 128, false>(m0, m1, mw, mr, mo, a, stream);
    default: return launch_tc_nt<Kernels, 64, false>(m0, m1, mw, mr, mo, a, stream);
  }
}

// ---- FMA conv (float32, and bf16 at other widths) ------------------------

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
