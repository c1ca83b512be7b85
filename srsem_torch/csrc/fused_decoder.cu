// Fused CLU UNet decoder level for Hopper (sm_90a), float32 and bf16.
//
// Replaces the two Pallas TPU kernels of srsem/ops/fused_decoder.py:
//   * fused_decoder_level       (_decoder_kernel, whole images per program)
//   * fused_decoder_level_tiled (_tiled_decoder_kernel + _copy_with_halo,
//     row tiles with a 1- or 2-row halo)
// Both compute, with BN folded into the weights (folded_decoder_weights):
//     h1 = relu(conv3x3(d, W1d) + conv3x3(u, W1u) + b1)    u optional
//     y  = relu(conv3x3(h1, W2) + b2)      final_kernel 3
//     y  = relu(h1 . W2 + b2)              final_kernel 1 (level 0's head)
// with float32 sums, h1 rounded to the compute type T between the convs and
// y written in T.  The (d, u) channel concat is never built: conv1's K runs
// over (tap, channel of d) and then (tap, channel of u) into one float32
// accumulator.  On Hopper both wrappers are one design, and the row tile of
// the tiled TPU kernel does not exist here.
//
// What bounds it.  At batch 32 and 224 px level 2 (28x28, d 512 + u 1024
// -> 512 -> 512) and level 1 (56x56, 256 + 512 -> 256 -> 256) are 4.7e11
// FLOP each and level 0 (112x112, 64 + 256 -> 64 -> 1) 1.5e11, against
// 0.1-0.3 GB of inputs: every level is bound by the tensor cores'
// operations (0.48 / 0.48 / 0.15 ms at 989 TFLOP/s), not by bytes.
//
// Why h1 goes through L2.  The TPU kernels keep h1 in VMEM with conv2's
// halo.  In shared memory that halo costs products: a 7x10 tile of level 2
// computes h1 on 9x12 pixels, and both convs ran about 2x the useful
// products (9.3e11 executed for 4.7e11 useful at level 2).  h1 itself is
// 25.7 MB at level 2 and 51.4 MB at level 1 (batch 32): writing it and
// reading it back once costs 15-31 us at 3.35 TB/s, 3-6% of the bound, and
// level 2's fits the 50 MB L2.  So a 3x3 level is two launches of one
// implicit-GEMM conv kernel, conv1 (d, u -> h1, a scratch tensor) and
// conv2 (h1 -> y), with no halo recomputed.  conv2's SAME padding pads h1
// with zeros at the image border: the TMA loads' zero fill outside the
// tensor is exactly the TPU kernel's h1 masking (:222-228).  Level 0's 1x1
// head to one channel stays one launch: Cm = 64 is one N tile, so conv1's
// epilogue rounds relu(h1 + b1) to T and forms the dot product with W2 in
// registers.
//
// The conv kernel (bf16 with every width a multiple of 64: every main-path
// level).  C[M, N] = A[M, K] . B[K, N] with M = output pixels, N = output
// channels, K = (tap, input channel).
//   * M: an output patch of bh x bw <= 64 pixels of one image is one
//     warpgroup's 64-row wgmma tile; a block computes two patches (128
//     rows) by NT = 64, 128 or 256 output channels.  The patch shape is
//     chosen here (pick_patch) for the fewest patches an image: 4x14 at
//     28x28 (12.5% of the rows computed and not stored), 8x8 at 56x56 and
//     112x112 (none).
//   * A: per k-step one TMA box of (64 channels, bw, bh, 1 image) at
//     (c, c0 + dx - 1, r0 + dy - 1, n) for tap (dy, dx): the hardware
//     computes the addresses, zero-fills the padding (negative coordinates
//     included) and swizzles for wgmma.  No im2col, no concat.
//   * B: the weights as a K-major (Cout, K) matrix (the wrapper transposes
//     them), one TMA box of (64, NT) a k-step.
//   * A ring of 4-8 stages of 48 KB or less guarded by mbarriers; one
//     producer warp issues the loads, two consumer warpgroups run wgmma
//     m64nNTk16 with one k-step in flight (288 threads a block, so a
//     consumer may hold its 128 accumulators in up to 224 registers).
//     A k-step stages two A
//     boxes (14 KB at 4x14) and NT * 128 bytes of B for 2 * 128 * NT * 64
//     FLOP: about 6.1 GB of L2 traffic for level 2's two launches at
//     NT = 256, against 17.7 GB for the halo-grid kernel before.
//   * The epilogue adds the bias, applies ReLU and stores in bf16 from the
//     accumulators (or forms the 1x1 head).
// float32, and bf16 at other widths (v2's unpadded widths, small test
// shapes), take the same two-launch structure on FMAs (block_gemm.cuh's
// gemm_fma, 64-pixel patches by 64 channels a block), bound by the 67
// TFLOP/s FMA pipe; the 1x1 head is then a second, 1-tap launch.
//
// The plan (patch, launches, rows executed over useful) lives here only;
// the Python wrapper asks for it (srsem_decoder_plan).
//
// Layouts (what srsem_torch/ops/fused_decoder.py passes, in T; biases
// float32):
//   d : (N, H, W, Cd)   u : (N, H, W, Cu) or null (Cu = 0)
//   w1t : (Cm, 9*Cd + 9*Cu)   K-major, k = (dy*3 + dx)*C + c over d, then u
//   w2t : (Co, 9*Cm) for final_kernel 3, (Co, Cm) for final_kernel 1
//   h1 : (N, H, W, Cm) scratch (null when the level is one launch)
//   y : (N, H, W, Co)

#include "block_gemm.cuh"
#include "wgmma.cuh"

namespace {

using namespace block_gemm;
using namespace hopper;

constexpr int kPatch = 64;     // output pixels of one patch (wgmma M)
constexpr int kChunk = 64;     // channels of one k-step (128 bytes of bf16)
constexpr int kConsumers = 2;  // consumer warpgroups a block
constexpr int kTcThreads = 128 * kConsumers + 32;  // + one producer warp
constexpr int kABytes = kPatch * kChunk * 2;  // one patch's A tile

// ---- the plan ----------------------------------------------------------

struct Patch {
  int bh, bw;
};

// The patch shape (bh x bw <= 64 pixels) that covers an h x w image with
// the fewest patches; ties go to the smaller patch (fewer bytes a TMA box),
// then the squarer one (less halo read again across taps), then the wider
// one (longer contiguous runs).  Rows are balanced: 28 rows in tiles of at
// most 4 are 4 each.
Patch pick_patch(int h, int w) {
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

__host__ inline bool uses_tensor_cores(bool is_bf16, int cd, int cu, int cm,
                                       int co, int k2) {
  return is_bf16 && cd % 64 == 0 && cu % 64 == 0 && cm % 64 == 0 &&
         (k2 == 3 ? co % 64 == 0 : (cm == 64 || cm == 128 || cm == 256));
}

// Output channels a tensor-core block computes.
inline int n_tile(int cout) {
  return cout % 256 == 0 ? 256 : (cout % 128 == 0 ? 128 : 64);
}

// ---- tensor-core conv (bf16) ---------------------------------------------

struct TcArgs {
  int h, w;          // image size (pixels)
  int c0, c1;        // channels of input 0 and of input 1 (0: none)
  int ks;            // taps a side: 3 (SAME padding 1) or 1
  int cout;          // output channels (for the head: Cm, one N tile)
  int bh, bw, tiles_h, tiles_w, patches;
  int n_tiles;       // cout / NT
  const float* bias;
  bf16* out;         // (N, H, W, cout), or (N, H, W, head_co) for the head
  const bf16* head_w;  // (head_co, cout), head only
  const float* head_b;
  int head_co;
};

template <int NT>
__host__ __device__ constexpr int tc_stages() {
  return NT == 256 ? 4 : (NT == 128 ? 6 : 8);
}
template <int NT>
__host__ __device__ constexpr int tc_stage_bytes() {
  return kConsumers * kABytes + NT * kChunk * 2;
}
template <int NT>
__host__ __device__ constexpr size_t tc_smem_bytes() {
  // Stages, their full and empty barriers, and 1024 bytes to align the
  // base for the 128-byte swizzle.
  return static_cast<size_t>(tc_stages<NT>()) * tc_stage_bytes<NT>() +
         2 * tc_stages<NT>() * sizeof(uint64_t) + 1024;
}
static_assert(tc_smem_bytes<64>() <= kSmemLimit, "NT 64 stages");
static_assert(tc_smem_bytes<128>() <= kSmemLimit, "NT 128 stages");
static_assert(tc_smem_bytes<256>() <= kSmemLimit, "NT 256 stages");

// Patch q's image and top-left pixel.
__device__ __forceinline__ int3 patch_origin(const TcArgs& p, int q) {
  const int per_img = p.tiles_h * p.tiles_w;
  const int img = q / per_img, t = q - img * per_img;
  return make_int3(img, (t / p.tiles_w) * p.bh, (t % p.tiles_w) * p.bw);
}

// Block b computes patches 2 * (b / n_tiles) + {0, 1} (warpgroups 0, 1)
// by output channels NT * (b % n_tiles) ..; the channel tiles of one pair
// of patches run side by side, so their A loads meet in L2.
template <int NT, bool HEAD>
__global__ void __launch_bounds__(kTcThreads, 1)
    fused_decoder_conv_wgmma(const __grid_constant__ CUtensorMap in0,
                             const __grid_constant__ CUtensorMap in1,
                             const __grid_constant__ CUtensorMap wmap,
                             const TcArgs p) {
  constexpr int S = tc_stages<NT>();
  constexpr int kStage = tc_stage_bytes<NT>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
      ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S * kStage);
  uint64_t* empty = full + S;

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
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // Producer warp: one thread keeps the ring full.
    if (threadIdx.x == kConsumers * 128) {
      int3 org[kConsumers];
#pragma unroll
      for (int i = 0; i < kConsumers; ++i) {
        // A missing last patch repeats the one before (computed, not stored).
        const int q = kConsumers * pair + i;
        org[i] = patch_origin(p, q < p.patches ? q : p.patches - 1);
      }
      const uint32_t bytes = kConsumers * p.bh * p.bw * kChunk * 2 +
                             NT * kChunk * 2;
      const int pad = p.ks / 2;
      for (int s = 0; s < steps; ++s) {
        const int slot = s % S;
        if (s >= S) mbar_wait(&empty[slot], ((s / S) - 1) & 1);
        mbar_expect_tx(&full[slot], bytes);
        const bool second = s >= steps0;
        const int t = second ? s - steps0 : s;
        const int chunks = (second ? p.c1 : p.c0) / kChunk;
        const int tap = t / chunks, ch = t - tap * chunks;
        const int dy = tap / p.ks - pad, dx = tap % p.ks - pad;
        unsigned char* st = smem + slot * kStage;
#pragma unroll
        for (int i = 0; i < kConsumers; ++i)
          tma_load_4d(st + i * kABytes, second ? &in1 : &in0, &full[slot],
                      ch * kChunk, org[i].z + dx, org[i].y + dy, org[i].x);
        tma_load_2d(st + kConsumers * kABytes, &wmap, &full[slot], s * kChunk,
                    tn * NT);
      }
    }
  } else {
    // Consumer warpgroup wg: rows of patch 2 * pair + wg.
    float acc[NT / 2];
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) acc[i] = 0.f;
    const uint32_t a0 = smem_u32(smem) + wg * kABytes;
    const uint32_t b0 = smem_u32(smem) + kConsumers * kABytes;
    for (int s = 0; s < steps; ++s) {
      const int slot = s % S;
      mbar_wait(&full[slot], (s / S) & 1);
      wgmma_fence();
      const uint32_t off = slot * kStage;
#pragma unroll
      for (int kk = 0; kk < kChunk / 16; ++kk)
        wgmma_m64k16<NT>(acc, smem_desc(a0 + off + kk * 32),
                         smem_desc(b0 + off + kk * 32), 1);
      wgmma_commit();
      // k-step s - 1 is done: its slot goes back to the producer.
      wgmma_wait<1>();
      if (s > 0 && threadIdx.x % 128 == 0) mbar_arrive(&empty[(s - 1) % S]);
    }
    wgmma_wait<0>();
    fence_accumulators(acc);

    // Epilogue.  This thread holds rows r and r + 8 of the patch, columns
    // 8j + 2 * (lane % 4) + {0, 1}.
    const int lane = threadIdx.x % 32;
    const int q = kConsumers * pair + wg;
    const int3 org = patch_origin(p, q < p.patches ? q : 0);
    size_t pix[2];
    bool ok[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int m = (threadIdx.x % 128) / 32 * 16 + lane / 4 + 8 * hh;
      const int y = org.y + m / p.bw, x = org.z + m % p.bw;
      ok[hh] = q < p.patches && m < p.bh * p.bw && y < p.h && x < p.w;
      pix[hh] = (static_cast<size_t>(org.x) * p.h + y) * p.w + x;
    }
    const int col0 = tn * NT + 2 * (lane % 4);
    if constexpr (!HEAD) {
#pragma unroll
      for (int j = 0; j < NT / 8; ++j) {
        const int col = col0 + 8 * j;
        const float2 b = *reinterpret_cast<const float2*>(p.bias + col);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          if (ok[hh])
            put(p.out + pix[hh] * p.cout + col,
                fmaxf(acc[4 * j + 2 * hh] + b.x, 0.f),
                fmaxf(acc[4 * j + 2 * hh + 1] + b.y, 0.f), true);
      }
    } else {
      // 1x1 head: y[o] = relu(sum_c round(relu(h1_c + b1_c)) * W2[o, c]
      // + b2[o]); a row's channels lie in the four lanes of a quad.
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
int activation_map(CUtensorMap* map, const void* x, int n, int h, int w,
                   int c, Patch patch) {
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

// TMA map of K-major (cout, k) weights, box (64, bn).
int weight_map(CUtensorMap* map, const void* wt, int cout, int k, int bn) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(k),
                              static_cast<cuuint64_t>(cout)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(k) * 2};
  const cuuint32_t box[2] = {kChunk, static_cast<cuuint32_t>(bn)};
  return encode_bf16_map(map, wt, 2, dims, strides, box);
}

template <int NT, bool HEAD>
int launch_tc_bn(const CUtensorMap& m0, const CUtensorMap& m1,
                 const CUtensorMap& mw, const TcArgs& a, cudaStream_t stream) {
  auto* kernel = fused_decoder_conv_wgmma<NT, HEAD>;
  const size_t smem = tc_smem_bytes<NT>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks =
      static_cast<long long>((a.patches + kConsumers - 1) / kConsumers) *
      a.n_tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), kTcThreads, smem, stream>>>(m0, m1,
                                                                      mw, a);
  return static_cast<int>(cudaGetLastError());
}

// One conv on the tensor cores: inputs x0 (c0 channels) and x1 (c1, may be
// 0), K-major weights wt (cout, ks*ks*(c0 + c1)), into out; with a head,
// out is the head's output and cout must be one N tile.
int launch_tc(const void* x0, const void* x1, int c0, int c1, int ks,
              const void* wt, const float* bias, int cout, void* out,
              const void* head_w, const float* head_b, int head_co, int n,
              int h, int w, Patch patch, cudaStream_t stream) {
  const int bn = n_tile(cout);
  CUtensorMap m0, m1, mw;
  int err = activation_map(&m0, x0, n, h, w, c0, patch);
  if (err == 0)
    err = c1 > 0 ? activation_map(&m1, x1, n, h, w, c1, patch)
                 : activation_map(&m1, x0, n, h, w, c0, patch);
  if (err == 0) err = weight_map(&mw, wt, cout, ks * ks * (c0 + c1), bn);
  if (err != 0) return err;
  TcArgs a{};
  a.h = h;
  a.w = w;
  a.c0 = c0;
  a.c1 = c1;
  a.ks = ks;
  a.cout = cout;
  a.bh = patch.bh;
  a.bw = patch.bw;
  a.tiles_h = (h + patch.bh - 1) / patch.bh;
  a.tiles_w = (w + patch.bw - 1) / patch.bw;
  const long long patches = static_cast<long long>(n) * a.tiles_h * a.tiles_w;
  if (patches > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  a.patches = static_cast<int>(patches);
  a.n_tiles = cout / bn;
  a.bias = bias;
  a.out = static_cast<bf16*>(out);
  a.head_w = static_cast<const bf16*>(head_w);
  a.head_b = head_b;
  a.head_co = head_co;
  const bool head = head_w != nullptr;
  if (head && a.n_tiles != 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (bn * 2 + (head ? 1 : 0)) {
    case 512: return launch_tc_bn<256, false>(m0, m1, mw, a, stream);
    case 513: return launch_tc_bn<256, true>(m0, m1, mw, a, stream);
    case 256: return launch_tc_bn<128, false>(m0, m1, mw, a, stream);
    case 257: return launch_tc_bn<128, true>(m0, m1, mw, a, stream);
    case 128: return launch_tc_bn<64, false>(m0, m1, mw, a, stream);
    default: return launch_tc_bn<64, true>(m0, m1, mw, a, stream);
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
  T* out;
};

// Block (q, j): patch q by output channels 64 j .. 64 j + 63.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    fused_decoder_conv_fma(const FmaArgs<T> p) {
  __shared__ __align__(16) float stage[BK * (BM + BN)];
  const int per_img = p.tiles_h * p.tiles_w;
  const int img = blockIdx.x / per_img, t = blockIdx.x - img * per_img;
  const int r0 = (t / p.tiles_w) * p.bh, q0 = (t % p.tiles_w) * p.bw;
  const int n0 = blockIdx.y * BN;
  const size_t base = static_cast<size_t>(img) * p.h * p.w;
  const T* x0 = p.x0 + base * p.c0;
  const T* x1 = p.x1 ? p.x1 + base * p.c1 : nullptr;
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
  auto no_res = [](int2, int, bool) { return make_float2(0.f, 0.f); };
  auto store = [&](int2 r, int n, float v0, float, bool, float2) {
    if (r.y)
      yo[static_cast<size_t>(r.x) * p.cout + n0 + n] = from_f<T>(fmaxf(v0, 0.f));
  };
  const int nn = p.cout - n0 < BN ? p.cout - n0 : BN;
  gemm_fma<T>(kPatch, nn, k, a_ptr, b_ptr, p.bias + n0, row, no_res, store,
              reinterpret_cast<unsigned char*>(stage));
}

template <typename T>
int launch_fma(const void* x0, const void* x1, int c0, int c1, int ks,
               const void* wt, const float* bias, int cout, void* out, int n,
               int h, int w, Patch patch, cudaStream_t stream) {
  FmaArgs<T> a{static_cast<const T*>(x0), static_cast<const T*>(x1), c0, c1,
               ks, h, w, cout, patch.bh, patch.bw,
               (h + patch.bh - 1) / patch.bh, (w + patch.bw - 1) / patch.bw,
               static_cast<const T*>(wt), bias, static_cast<T*>(out)};
  const long long patches = static_cast<long long>(n) * a.tiles_h * a.tiles_w;
  if (patches > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(patches), (cout + BN - 1) / BN);
  fused_decoder_conv_fma<T><<<grid, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int level_fma(const void* d, const void* u, const void* w1t, const float* b1,
              const void* w2t, const float* b2, void* h1, void* y, int n,
              int h, int w, int cd, int cu, int cm, int co, int k2,
              Patch patch, cudaStream_t s) {
  const int err =
      launch_fma<T>(d, u, cd, cu, 3, w1t, b1, cm, h1, n, h, w, patch, s);
  if (err != 0) return err;
  return launch_fma<T>(h1, nullptr, cm, 0, k2, w2t, b2, co, y, n, h, w, patch,
                       s);
}

}  // namespace

extern "C" {

// 1 when the shapes take the tensor-core path, else 0 (FMA path).
int srsem_decoder_uses_tensor_cores(int is_bf16, int cd, int cu, int cm,
                                    int co, int k2) {
  return uses_tensor_cores(is_bf16 != 0, cd, cu, cm, co, k2);
}

// How a level runs: the patch (*bh x *bw output pixels a 64-row tile), the
// CUDA launches it makes (*launches: 1 for the tensor cores' fused 1x1
// head, else 2, and then the caller passes an h1 scratch), and the rows
// the products compute over the output pixels (*rows_ratio >= 1; a
// tensor-core block computes two patches).  Returns 0 or
// cudaErrorInvalidValue.
int srsem_decoder_plan(int n, int h, int w, int cd, int cu, int cm, int co,
                       int k2, int is_bf16, int* bh, int* bw, int* launches,
                       double* rows_ratio) {
  if (n < 1 || h < 1 || w < 1 || cd < 1 || cu < 0 || cm < 1 || co < 1 ||
      (k2 != 1 && k2 != 3))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool tc = uses_tensor_cores(is_bf16 != 0, cd, cu, cm, co, k2);
  const Patch patch = pick_patch(h, w);
  const double patches = static_cast<double>(n) *
                         ((h + patch.bh - 1) / patch.bh) *
                         ((w + patch.bw - 1) / patch.bw);
  const double rows =
      tc ? static_cast<double>(static_cast<long long>(patches + 1) / 2) *
               (kConsumers * kPatch)
         : patches * kPatch;
  *bh = patch.bh;
  *bw = patch.bw;
  *launches = tc && k2 == 1 ? 1 : 2;
  *rows_ratio = rows / (static_cast<double>(n) * h * w);
  return 0;
}

// Launch on `stream`; returns the cudaError_t of the launches (0 = queued).
// u is null when cu == 0; h1 is null when the plan makes one launch.
// Pointers must be 16-byte aligned (the wrapper checks).
int srsem_fused_decoder(const void* d, const void* u, const void* w1t,
                        const void* b1, const void* w2t, const void* b2,
                        void* h1, void* y, int n, int h, int w, int cd, int cu,
                        int cm, int co, int k2, int is_bf16, void* stream) {
  if (n < 1 || h < 1 || w < 1 || cd < 1 || cu < 0 || cm < 1 || co < 1 ||
      (k2 != 1 && k2 != 3) || (cu > 0) != (u != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long cmax = cd > cu ? (cd > cm ? cd : cm) : (cu > cm ? cu : cm);
  if (static_cast<long long>(h) * w * (cmax > co ? cmax : co) > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto f1 = static_cast<const float*>(b1);
  const auto f2 = static_cast<const float*>(b2);
  const Patch patch = pick_patch(h, w);
  if (uses_tensor_cores(is_bf16 != 0, cd, cu, cm, co, k2)) {
    if (k2 == 1)
      return launch_tc(d, u, cd, cu, 3, w1t, f1, cm, y, w2t, f2, co, n, h, w,
                       patch, s);
    if (h1 == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const int err = launch_tc(d, u, cd, cu, 3, w1t, f1, cm, h1, nullptr,
                              nullptr, 0, n, h, w, patch, s);
    if (err != 0) return err;
    return launch_tc(h1, nullptr, cm, 0, 3, w2t, f2, co, y, nullptr, nullptr,
                     0, n, h, w, patch, s);
  }
  if (h1 == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (is_bf16)
    return level_fma<bf16>(d, u, w1t, f1, w2t, f2, h1, y, n, h, w, cd, cu, cm,
                           co, k2, patch, s);
  return level_fma<float>(d, u, w1t, f1, w2t, f2, h1, y, n, h, w, cd, cu, cm,
                          co, k2, patch, s);
}

}  // extern "C"
