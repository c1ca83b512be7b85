// Fused stride-1 ResNet bottleneck for Hopper (sm_90a), float32 and bf16.
//
// Replaces the two Pallas TPU kernels of srsem/ops/fused_bottleneck.py:
//   * fused_bottleneck       (_bottleneck_kernel, whole images per program)
//   * fused_bottleneck_tiled (_tiled_bottleneck_kernel + _halo_copy, row
//     tiles with a 1-row halo)
// Both compute, with BN folded into the weights (fold_bn_into_conv):
//     h1 = relu(x . W1 + b1)                  conv1, 1x1
//     h2 = relu(conv3x3(h1, W2) + b2)         conv2, SAME: h1 zero outside
//     y  = relu(h2 . W3 + b3 + x)             conv3, 1x1 + residual
// with float32 sums, h1 and h2 rounded to the compute type T between the
// convs and y written in T.  On Hopper both wrappers are one design, and
// the row tile of the tiled TPU kernel does not exist here.
//
// What bounds it.  At 224 px every stage is 436 MFLOP an image (27.9 GFLOP
// at batch 64, 28 us at 989 TFLOP/s).  Stages 0-1 are bound by bytes
// (stage 0 reads x for conv1 and again for the residual and writes y:
// 308 MB at batch 64, 92 us at 3.35 TB/s), stages 2-3 by the products.
//
// Why three launches.  The TPU kernels keep h1 and h2 in VMEM, with conv2's
// halo.  In shared memory a halo costs products (a 4x7 output tile needs
// conv1 on 6x9 pixels), and a block of a small tile streams all of the
// weights (8.9 MB at stage 3).  h1 and h2 are 25.7 / 12.8 / 6.4 / 3.2 MB
// each at stages 0-3 (batch 64): from stage 1 on they fit the 50 MB L2,
// and writing and reading them back costs less.  So a bottleneck is three
// launches of the implicit-GEMM conv it shares with the decoder
// (conv_wgmma.cuh), with h1 and h2 in scratch tensors the caller allocates:
//   1. conv1, x -> h1: flat 64-row tiles of the (N*H*W, C) pixel matrix;
//   2. conv2, h1 -> h2: bh x bw patches (pick_patch); the TMA zero fill
//      outside the tensor is the TPU kernel's h1 masking (:250-257);
//   3. conv3, h2 -> y: flat tiles, x brought in by TMA for the epilogue.
// The rows computed over the useful ones are then 1.0 for the 1x1 convs
// (up to the last tile's ragged rows), and 1.0-1.31 for conv2.
//
// The plan (make_plan) picks each conv's N tile by a wave model on the
// card's SM count (pick_nt) and lives here only; the Python wrapper asks
// for it (srsem_bottleneck_plan).  A tensor-core block of NT <= 128 takes
// at most 112 registers a thread and at most 97 KB of shared memory, so
// two blocks share an SM and one's loads overlap the other's epilogue;
// NT = 256 holds 128 accumulators a thread and runs alone.
//
// float32 (every width a multiple of 32) takes the same three launches on
// the tensor cores by 3xTF32 (conv_wgmma.cuh): three tf32 products a
// k-step bound it at 3 x operations / 495 TFLOP/s (0.0212 ms for each of
// train-nr-iqa's float32 shapes at batch 8, against 0.0521 ms on the 67
// TFLOP/s FMA pipe).  Those shapes have few M tiles (7-25 at 14x14 and
// 7x7), so the plan (pick_tf32) takes N tiles down to 32 wide to spread a
// conv over more blocks; blocks of NT <= 64 run two to an SM, NT 128
// alone.  Weights come split (hi rows over lo rows) from the wrapper's
// packing.  bf16 at other widths, and float32 at widths that are not a
// multiple of 32, take the same three launches through the shared FMA
// conv (patches for all three convs).
//
// Layouts (what srsem_torch/ops/fused_bottleneck.py passes, in T; biases
// float32):
//   x, y : (N, H, W, C)        h1, h2 : (N, H, W, wd) scratch
//   w1t : (wd, C)    w2t : (wd, 9*wd), k = (dy*3 + dx)*wd + c    w3t : (C, wd)
// and on the 3xTF32 route each w?t is its (2, rows, K) split: tf32 hi
// over tf32 lo (srsem_torch/ops/tf32x3.py::split_tf32).

#include "conv_wgmma.cuh"

namespace {

using namespace conv;

// Two blocks an SM up to NT 128 in bf16 and NT 64 in float32.
template <typename T, int NT>
__global__ void __launch_bounds__(kTcThreads,
                                  NT < (sizeof(T) == 4 ? 128 : 256) ? 2 : 1)
    fused_bottleneck_conv_wgmma(const __grid_constant__ CUtensorMap in0,
                                const __grid_constant__ CUtensorMap in1,
                                const __grid_constant__ CUtensorMap wmap,
                                const __grid_constant__ CUtensorMap rmap,
                                const __grid_constant__ CUtensorMap omap,
                                const TcArgs p) {
  conv_wgmma<T, NT, false>(&in0, &in1, &wmap, &rmap, &omap, p);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fused_bottleneck_conv_fma(const FmaArgs<T> p) {
  conv_fma<T>(p);
}

struct BottleneckKernels {
  static constexpr bool kHead = false;
  template <typename T, int NT, bool HEAD>
  static auto tc() {
    return fused_bottleneck_conv_wgmma<T, NT>;
  }
  template <typename T>
  static auto fma() {
    return fused_bottleneck_conv_fma<T>;
  }
};

Route route(bool is_bf16, int c, int wd) {
  if (is_bf16) return c % 64 == 0 && wd % 64 == 0 ? kWgmmaBf16 : kFma;
  return c % 32 == 0 && wd % 32 == 0 ? kWgmmaTf32x3 : kFma;
}

// bf16 ring stages: two blocks of NT <= 128 fit an SM (3 x 24 KB at NT 64,
// 3 x 32 KB at NT 128, 2 beside conv3's 32 KB of residual tiles); NT 256
// runs alone with 4 x 48 KB (3 beside its 64 KB of residual tiles).
int stages(int nt, bool res) {
  if (nt == 256) return res ? 3 : 4;
  return nt == 128 && res ? 2 : 3;
}

// The N tile of a bf16 tensor-core conv with `tiles` M tiles and `steps`
// k-steps on `sms` SMs, by a wave model: the SM with the most blocks sets
// the time, and a block's k-step costs NT tensor-core cycles (x 1.5 at NT
// 64, whose products read more shared memory each); a block alone on its
// SM (NT 256) also exposes about two k-steps of ring fill and epilogue,
// which a second block's work hides.  Ties go to the wider tile, which
// reads A fewer times.  A conv without a residual stages its output tile in
// NT / 64 ring slots, so NT <= 64 * steps.
int pick_nt(long long tiles, int cout, int steps, int sms, bool res) {
  int best = 0;
  double best_cost = 0.0;
  for (const int nt : {256, 128, 64}) {
    if (cout % nt || (!res && nt > kChunk<bf16> * steps)) continue;
    const long long per_sm = (tc_blocks(tiles, cout, nt) + sms - 1) / sms;
    const double cost = static_cast<double>(per_sm) *
                        (nt == 64 ? 1.5 * nt : nt) *
                        (steps + (nt == 256 ? 2 : 0));
    if (best == 0 || cost < best_cost) {
      best = nt;
      best_cost = cost;
    }
  }
  return best;
}

struct Plan {
  Route route;
  Tiling tile[3];
};

Plan make_plan(int n, int h, int w, int c, int wd, Route r, int sms) {
  const Patch patch = pick_patch(h, w);
  Plan plan{r, {}};
  if (r == kFma) {
    for (Tiling& t : plan.tile) t = {false, patch, BN, 0};
    return plan;
  }
  const int cout[3] = {wd, wd, c}, k[3] = {c, 9 * wd, wd};
  for (int i = 0; i < 3; ++i) {
    Tiling& t = plan.tile[i];
    t = {i != 1, patch, 0, 0};
    const long long tiles = m_tiles(t, n, h, w);
    if (r == kWgmmaBf16) {
      t.nt = pick_nt(tiles, cout[i], k[i] / kChunk<bf16>, sms, i == 2);
      t.stages = stages(t.nt, i == 2);
    } else {
      const Tf32Tile f = pick_tf32(tiles, cout[i], k[i] / kChunk<float>, sms,
                                   i == 2, true);
      t.nt = f.nt;
      t.stages = f.stages;
    }
  }
  return plan;
}

// Pixel counts fit an int (a flat tile's row), and so do offsets within
// an image (the FMA conv's).
bool valid(int n, int h, int w, int c, int wd) {
  return n >= 1 && h >= 1 && w >= 1 && c >= 1 && wd >= 1 &&
         static_cast<long long>(n) * h * w <= 0x7fffffffLL - kPatch &&
         static_cast<long long>(h) * w * (c > wd ? c : wd) <= 0x7fffffffLL;
}

}  // namespace

extern "C" {

// The route (is_bf16, c, wd) take: 1 bf16 wgmma, 2 float32 wgmma by
// 3xTF32 (w?t passed split), 0 the FMA conv.
int srsem_bottleneck_uses_tensor_cores(int is_bf16, int c, int wd) {
  return route(is_bf16 != 0, c, wd);
}

// How a block runs on `sms` SMs (<= 0: the current device's): *launches
// (3) CUDA launches, and for conv i = 0, 1, 2: flat[i] (1: 64-row tiles of
// the pixel matrix, 0: bh[i] x bw[i] patches), nt[i] output channels a
// block (tensor cores; the FMA block's 64 otherwise), blocks[i], and
// rows_ratio[i], the rows its products compute over the output pixels
// (a tensor-core block computes two M tiles, an FMA block one patch).
// Returns 0 or cudaErrorInvalidValue.
int srsem_bottleneck_plan(int n, int h, int w, int c, int wd, int is_bf16,
                          int sms, int* launches, int* flat, int* bh, int* bw,
                          int* nt, long long* blocks, double* rows_ratio) {
  if (!valid(n, h, w, c, wd)) return static_cast<int>(cudaErrorInvalidValue);
  if (sms <= 0) sms = sm_count();
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Plan plan = make_plan(n, h, w, c, wd, route(is_bf16 != 0, c, wd), sms);
  const int cout[3] = {wd, wd, c};
  *launches = 3;
  for (int i = 0; i < 3; ++i) {
    const Tiling& t = plan.tile[i];
    const long long tiles = m_tiles(t, n, h, w);
    flat[i] = t.flat;
    bh[i] = t.flat ? 0 : t.patch.bh;
    bw[i] = t.flat ? 0 : t.patch.bw;
    nt[i] = t.nt;
    const bool tc = plan.route != kFma;
    blocks[i] = tc ? tc_blocks(tiles, cout[i], t.nt)
                   : tiles * ((cout[i] + BN - 1) / BN);
    const long long rows =
        tc ? (tiles + kConsumers - 1) / kConsumers * kConsumers : tiles;
    rows_ratio[i] = static_cast<double>(rows) * kPatch /
                    (static_cast<double>(n) * h * w);
  }
  return 0;
}

// Launch the three convs on `stream`; returns the cudaError_t of the
// launches (0 = queued).  h1 and h2 are (N, H, W, wd) scratch.  Pointers
// must be 16-byte aligned (the wrapper checks).
int srsem_fused_bottleneck(const void* x, const void* w1t, const void* b1,
                           const void* w2t, const void* b2, const void* w3t,
                           const void* b3, void* h1, void* h2, void* y, int n,
                           int h, int w, int c, int wd, int is_bf16,
                           void* stream) {
  if (!valid(n, h, w, c, wd)) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const Route r = route(is_bf16 != 0, c, wd);
  const int sms = r != kFma ? sm_count() : 1;
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Plan plan = make_plan(n, h, w, c, wd, r, sms);
  const Conv convs[3] = {
      {x, c, nullptr, 0, 1, w1t, static_cast<const float*>(b1), wd, nullptr,
       h1, nullptr, nullptr, 0},
      {h1, wd, nullptr, 0, 3, w2t, static_cast<const float*>(b2), wd, nullptr,
       h2, nullptr, nullptr, 0},
      {h2, wd, nullptr, 0, 1, w3t, static_cast<const float*>(b3), c, x, y,
       nullptr, nullptr, 0}};
  for (int i = 0; i < 3; ++i) {
    const Tiling& t = plan.tile[i];
    const int err =
        r == kWgmmaBf16 ? launch_tc<BottleneckKernels, bf16>(convs[i], n, h, w, t, s)
        : r == kWgmmaTf32x3
            ? launch_tc<BottleneckKernels, float>(convs[i], n, h, w, t, s)
        : is_bf16
            ? launch_fma<BottleneckKernels, bf16>(convs[i], n, h, w, t.patch, s)
            : launch_fma<BottleneckKernels, float>(convs[i], n, h, w, t.patch,
                                                   s);
    if (err != 0) return err;
  }
  return 0;
}

}  // extern "C"
