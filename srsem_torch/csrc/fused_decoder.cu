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
// The conv is the implicit-GEMM kernel of conv_wgmma.cuh, instantiated
// here as fused_decoder_conv_wgmma<NT, HEAD>: patches of at most 64
// pixels (pick_patch: 4x14 at 28x28, 12.5% of the rows computed and not
// stored; 8x8 at 56x56 and 112x112, none) by NT = n_tile(Cout) channels,
// 256 at levels 1-2, through a ring of 4 stages (8 at NT 64).  Level 2's
// two launches read about 6.1 GB from L2, against 17.7 GB for the
// halo-grid kernel before.  float32, and bf16 at other widths (v2's
// unpadded widths, small test shapes), take the same two-launch structure
// on FMAs (fused_decoder_conv_fma); the 1x1 head is then a second, 1-tap
// launch.
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

#include "conv_wgmma.cuh"

namespace {

using namespace conv;

__host__ inline bool uses_tensor_cores(bool is_bf16, int cd, int cu, int cm,
                                       int co, int k2) {
  return is_bf16 && cd % 64 == 0 && cu % 64 == 0 && cm % 64 == 0 &&
         (k2 == 3 ? co % 64 == 0 : (cm == 64 || cm == 128 || cm == 256));
}

// Output channels a tensor-core block computes: the widest tile.
inline int n_tile(int cout) {
  return cout % 256 == 0 ? 256 : (cout % 128 == 0 ? 128 : 64);
}

inline int tc_stages(int nt) { return nt == 256 ? 4 : (nt == 128 ? 6 : 8); }

template <int NT, bool HEAD>
__global__ void __launch_bounds__(kTcThreads, 1)
    fused_decoder_conv_wgmma(const __grid_constant__ CUtensorMap in0,
                             const __grid_constant__ CUtensorMap in1,
                             const __grid_constant__ CUtensorMap wmap,
                             const __grid_constant__ CUtensorMap rmap,
                             const __grid_constant__ CUtensorMap omap,
                             const TcArgs p) {
  conv_wgmma<NT, HEAD>(&in0, &in1, &wmap, &rmap, &omap, p);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fused_decoder_conv_fma(const FmaArgs<T> p) {
  conv_fma<T>(p);
}

struct DecoderKernels {
  static constexpr bool kHead = true;
  template <int NT, bool HEAD>
  static auto tc() {
    return fused_decoder_conv_wgmma<NT, HEAD>;
  }
  template <typename T>
  static auto fma() {
    return fused_decoder_conv_fma<T>;
  }
};

// One launch of the level: conv1 (d, u -> out), or conv2 (h1 -> out).
int launch(const Conv& c, int n, int h, int w, Patch patch, bool tc,
           bool is_bf16, cudaStream_t s) {
  if (tc) {
    const int nt = n_tile(c.cout);
    return launch_tc<DecoderKernels>(c, n, h, w,
                                     {false, patch, nt, tc_stages(nt)}, s);
  }
  return is_bf16 ? launch_fma<DecoderKernels, bf16>(c, n, h, w, patch, s)
                 : launch_fma<DecoderKernels, float>(c, n, h, w, patch, s);
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
  const bool tc = uses_tensor_cores(is_bf16 != 0, cd, cu, cm, co, k2);
  if (tc && k2 == 1)
    return launch({d, cd, u, cu, 3, w1t, f1, cm, nullptr, y, w2t, f2, co}, n,
                  h, w, patch, tc, true, s);
  if (h1 == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int err =
      launch({d, cd, u, cu, 3, w1t, f1, cm, nullptr, h1, nullptr, nullptr, 0},
             n, h, w, patch, tc, is_bf16 != 0, s);
  if (err != 0) return err;
  return launch({h1, cm, nullptr, 0, k2, w2t, f2, co, nullptr, y, nullptr,
                 nullptr, 0},
                n, h, w, patch, tc, is_bf16 != 0, s);
}

}  // extern "C"
