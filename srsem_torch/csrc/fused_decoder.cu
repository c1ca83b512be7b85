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
// -> 512 -> 512), level 1 (56x56, 256 + 512 -> 256 -> 256) and level 3
// (14x14, 1024 + 2048 -> 1024 -> 1024) are 4.7e11 FLOP each, level 4
// (7x7, d 2048 -> 2048 -> 2048, no u) 2.4e11 and level 0 (112x112, 64 +
// 256 -> 64 -> 1) 1.5e11, against 0.1-0.3 GB of inputs: every level is
// bound by the tensor cores' operations (0.48 / 0.48 / 0.48 / 0.24 /
// 0.15 ms at 989 TFLOP/s), not by bytes.  Levels 3 and 4 also read the
// most weights: 0.45 GB in float32 (0.91 GB split for 3xTF32), against
// the activations' 0.1 GB.
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
// The conv is the implicit-GEMM kernel of conv_wgmma.cuh, instantiated
// here as fused_decoder_conv_wgmma<NT, HEAD>, by NT = n_tile(Cout)
// channels in bf16 (256 at levels 1-4), through a ring of 4 stages (8 at
// NT 64).  Its M tiles are patches of at most 64 pixels (pick_patch: 8x8
// at 56x56 and 112x112) or, where those compute more rows than the
// pixels' own, 64 flat pixel rows through TMA's im2col boxes (use_flat):
// patches would take 4x14 at 28x28 (1.14x the rows), 4x14 at 14x14 and
// 7x7 at 7x7 (1.31x each); flat tiles take 1.00 / 1.00 / 1.02x.  A block
// pairs two M tiles, and the N tiles of one pair run side by side: all of
// a conv's N tiles are in flight together, each read by the blocks of
// every pair in the wave within a few k-steps of one another, so level
// 4's 302 MB of split weights a conv stream from memory about once a wave
// (two waves) and the 50 MB L2 holds only the k-steps in flight.
//
// float32 (the CLU model's default decoder dtype), with every width a
// multiple of 32, runs the same launches on the tensor cores by 3xTF32
// (conv_wgmma.cuh): it is bound by 3 x operations / 495 TFLOP/s (2.87 /
// 2.87 / 2.87 / 1.44 / 0.897 ms at levels 3 / 2 / 1 / 4 / 0, batch 32;
// 26.9 ms in all on the 67 TFLOP/s FMA pipe).  The plan's wave model
// (pick_tf32) picks each conv's N tile (128, 64 or 32; one block an SM, a
// ring of up to 8 stages): level 3 takes 49 pairs of flat tiles by 8 N
// tiles of 128 (392 blocks, three waves on 132 SMs), level 4 13 pairs by
// 16 (208 blocks: two waves, the second 58% full; no narrower tile fills
// them better).  Level 0 keeps its head in conv1's epilogue (one launch),
// in float32.  conv1's and conv2's weights come split, hi rows over lo
// rows, packed once by the caller (ops/fused_decoder.py::pack_level); the
// head's do not.  v2's skip diffs (Cd = 65, 257, 513: the pixel
// channel after the tap's) reach the kernel zero-padded to the next
// multiple of 64 (bf16) or 32 (float32), with zero rows in w1t
// (ops/fused_decoder.py::skip_width), so every model level takes the
// tensor cores.  Other widths (small test shapes; a float32 row of 1028
// bytes, which TMA cannot address) take the same two-launch structure on
// FMAs (fused_decoder_conv_fma); the 1x1 head is then a second, 1-tap
// launch.
//
// The plan (route, patch or flat tiles, launches, N tiles, rows executed
// over useful) lives here only; the Python wrapper asks for it (srsem_decoder_plan).
//
// Layouts (what srsem_torch/ops/fused_decoder.py passes, in T; biases
// float32; the weights packed once, ops/fused_decoder.py::pack_level):
//   d : (N, H, W, Cd)   u : (N, H, W, Cu) or null (Cu = 0)
//   w1t : (Cm, 9*Cd + 9*Cu)   K-major, k = (dy*3 + dx)*C + c over d, then u
//   w2t : (Co, 9*Cm) for final_kernel 3, (Co, Cm) for final_kernel 1
//   (on the 3xTF32 route w1t and a 3x3 w2t are their (2, rows, K) split:
//   tf32 hi over tf32 lo)
//   h1 : (N, H, W, Cm) scratch (null when the level is one launch)
//   y : (N, H, W, Co)

#include "conv_wgmma.cuh"

namespace {

using namespace conv;

// ops/fused_decoder.py::tensor_core_widths holds the same rule (the
// wrapper pads v2's skip by it without the library): change both together.
Route route(bool is_bf16, int cd, int cu, int cm, int co, int k2) {
  const int q = is_bf16 ? 64 : 32;
  const bool head_ok = is_bf16 ? (cm == 64 || cm == 128 || cm == 256)
                               : (cm == 32 || cm == 64 || cm == 128);
  if (cd % q || cu % q || cm % q || (k2 == 3 ? co % q != 0 : !head_ok))
    return kFma;
  return is_bf16 ? kWgmmaBf16 : kWgmmaTf32x3;
}

// Output channels a bf16 tensor-core block computes: the widest tile.
inline int n_tile(int cout) {
  return cout % 256 == 0 ? 256 : (cout % 128 == 0 ? 128 : 64);
}

inline int tc_stages(int nt) { return nt == 256 ? 4 : (nt == 128 ? 6 : 8); }

template <typename T, int NT, bool HEAD>
__global__ void __launch_bounds__(kTcThreads, 1)
    fused_decoder_conv_wgmma(const __grid_constant__ CUtensorMap in0,
                             const __grid_constant__ CUtensorMap in1,
                             const __grid_constant__ CUtensorMap wmap,
                             const __grid_constant__ CUtensorMap rmap,
                             const __grid_constant__ CUtensorMap omap,
                             const TcArgs p) {
  conv_wgmma<T, NT, HEAD>(&in0, &in1, &wmap, &rmap, &omap, p);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fused_decoder_conv_fma(const FmaArgs<T> p) {
  conv_fma<T>(p);
}

struct DecoderKernels {
  static constexpr bool kHead = true;
  template <typename T, int NT, bool HEAD>
  static auto tc() {
    return fused_decoder_conv_wgmma<T, NT, HEAD>;
  }
  template <typename T>
  static auto fma() {
    return fused_decoder_conv_fma<T>;
  }
};

// How a level runs: its route, patch, CUDA launches (1 for the tensor
// cores' fused 1x1 head, else 2) and each launch's tiling.
struct Plan {
  Route route;
  Patch patch;
  int launches;
  Tiling conv[2];
};

bool valid(int n, int h, int w, int cd, int cu, int cm, int co, int k2) {
  return n >= 1 && h >= 1 && w >= 1 && cd >= 1 && cu >= 0 && cm >= 1 &&
         co >= 1 && (k2 == 1 || k2 == 3);
}

// Rows a tensor-core launch computes over n images of h x w: pairs of M
// tiles of 64 rows.
long long tc_rows(const Tiling& t, int n, int h, int w) {
  return (m_tiles(t, n, h, w) + kConsumers - 1) / kConsumers * kConsumers *
         kPatch;
}

// A two-launch tensor-core level (two 3x3 convs) takes flat M tiles where
// they compute fewer rows than patches; the 1x1 head's epilogue and the
// FMA conv take patches.
bool use_flat(Route r, int launches, int n, int h, int w, Patch patch) {
  return r != kFma && launches == 2 &&
         tc_rows({true, patch, 0, 0}, n, h, w) <
             tc_rows({false, patch, 0, 0}, n, h, w);
}

Plan make_plan(int n, int h, int w, int cd, int cu, int cm, int co, int k2,
               bool is_bf16, int sms) {
  const Route r = route(is_bf16, cd, cu, cm, co, k2);
  const Patch patch = pick_patch(h, w);
  Plan plan{r, patch, r != kFma && k2 == 1 ? 1 : 2, {}};
  const bool flat = use_flat(r, plan.launches, n, h, w, patch);
  const int cout[2] = {cm, co}, k[2] = {9 * (cd + cu), k2 * k2 * cm};
  for (int i = 0; i < plan.launches; ++i) {
    Tiling& t = plan.conv[i];
    t = {flat, patch, 0, 0};
    if (r == kWgmmaBf16) {
      t.nt = n_tile(cout[i]);
      t.stages = tc_stages(t.nt);
    } else if (r == kWgmmaTf32x3) {
      const Tf32Tile f =
          plan.launches == 1
              ? Tf32Tile{cm, tf32_stages(cm, false, 1)}
              : pick_tf32(m_tiles(t, n, h, w), cout[i],
                          k[i] / kChunk<float>, sms, false, false);
      t.nt = f.nt;
      t.stages = f.stages;
    }
  }
  return plan;
}

// One launch of the level: conv1 (d, u -> out), or conv2 (h1 -> out).
int launch(const Conv& c, int n, int h, int w, const Plan& plan, int i,
           bool is_bf16, cudaStream_t s) {
  const Tiling& t = plan.conv[i];
  switch (plan.route) {
    case kWgmmaBf16: return launch_tc<DecoderKernels, bf16>(c, n, h, w, t, s);
    case kWgmmaTf32x3: return launch_tc<DecoderKernels, float>(c, n, h, w, t, s);
    default:
      return is_bf16
                 ? launch_fma<DecoderKernels, bf16>(c, n, h, w, plan.patch, s)
                 : launch_fma<DecoderKernels, float>(c, n, h, w, plan.patch, s);
  }
}

}  // namespace

extern "C" {

// The route the shapes take: 1 bf16 wgmma, 2 float32 wgmma by 3xTF32
// (w1t and a 3x3 w2t passed split), 0 the FMA conv.
int srsem_decoder_uses_tensor_cores(int is_bf16, int cd, int cu, int cm,
                                    int co, int k2) {
  return route(is_bf16 != 0, cd, cu, cm, co, k2);
}

// How a level runs on the current device: the patch (*bh x *bw output
// pixels a 64-row tile where a launch takes patches), the CUDA launches it
// makes (*launches: 1 for the tensor cores' fused 1x1 head, else 2, and
// then the caller passes an h1 scratch), flat[i] whether launch i takes 64
// flat pixel rows an M tile in place of patches, nt[0], nt[1] the output
// channels a tensor-core block of each launch computes (0: the FMA conv,
// or no second launch), and the rows the products compute over the output
// pixels (*rows_ratio >= 1; a tensor-core block computes two M tiles).
// Returns 0 or cudaErrorInvalidValue.
int srsem_decoder_plan(int n, int h, int w, int cd, int cu, int cm, int co,
                       int k2, int is_bf16, int* bh, int* bw, int* launches,
                       int* flat, int* nt, double* rows_ratio) {
  if (!valid(n, h, w, cd, cu, cm, co, k2))
    return static_cast<int>(cudaErrorInvalidValue);
  const int sms = sm_count();
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Plan plan = make_plan(n, h, w, cd, cu, cm, co, k2, is_bf16 != 0, sms);
  const Tiling& t = plan.conv[0];
  const double rows =
      static_cast<double>(plan.route != kFma ? tc_rows(t, n, h, w)
                                             : m_tiles(t, n, h, w) * kPatch);
  *bh = plan.patch.bh;
  *bw = plan.patch.bw;
  *launches = plan.launches;
  for (int i = 0; i < 2; ++i) {
    flat[i] = plan.conv[i].flat;
    nt[i] = plan.conv[i].nt;
  }
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
  if (!valid(n, h, w, cd, cu, cm, co, k2) || (cu > 0) != (u != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long cmax = cd > cu ? (cd > cm ? cd : cm) : (cu > cm ? cu : cm);
  if (static_cast<long long>(h) * w * (cmax > co ? cmax : co) > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto f1 = static_cast<const float*>(b1);
  const auto f2 = static_cast<const float*>(b2);
  const bool bf = is_bf16 != 0;
  const int sms = route(bf, cd, cu, cm, co, k2) == kWgmmaTf32x3 ? sm_count() : 1;
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Plan plan = make_plan(n, h, w, cd, cu, cm, co, k2, bf, sms);
  if (plan.launches == 1)
    return launch({d, cd, u, cu, 3, w1t, f1, cm, nullptr, y, w2t, f2, co}, n,
                  h, w, plan, 0, bf, s);
  if (h1 == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int err =
      launch({d, cd, u, cu, 3, w1t, f1, cm, nullptr, h1, nullptr, nullptr, 0},
             n, h, w, plan, 0, bf, s);
  if (err != 0) return err;
  return launch({h1, cm, nullptr, 0, k2, w2t, f2, co, nullptr, y, nullptr,
                 nullptr, 0},
                n, h, w, plan, 1, bf, s);
}

}  // extern "C"
