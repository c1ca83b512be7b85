// Fused stride-1 ResNet bottleneck for Hopper (sm_90a), float32 and bf16.
//
// Replaces the two Pallas TPU kernels of srsem/ops/fused_bottleneck.py:
//   * fused_bottleneck       (_bottleneck_kernel, whole image per program)
//   * fused_bottleneck_tiled (_tiled_bottleneck_kernel + _halo_copy, row
//     tiles with a 1-row halo)
// On the TPU these are two kernels because of VMEM size and Mosaic compile
// limits (fused_bottleneck.py:97-111, fused_resnet.py:131-144).  On Hopper
// they are one design: a thread block computes one output tile of
// (image, rows, columns) with a 1-pixel halo, and the two Python wrappers
// differ only in how they choose the tile (largest that fits vs the
// caller's row tile).
//
// Computes, with BN folded into the weights (fold_bn_into_conv):
//     h1 = relu(x . W1 + b1)                       1x1 conv, halo tile
//     h2 = relu(sum_t shift_t(h1) . W2[t] + b2)    3x3 conv, 9 taps
//     y  = relu(h2 . W3 + b3 + x)                  1x1 conv + residual
// h1 and h2 live in shared memory only; x is read once (plus halo) and y
// written once.  h1 outside the image is ZERO (conv2's SAME padding pads
// h1, not x — the same masking as _tiled_bottleneck_kernel :250-257).
// Every product accumulates in float32; h1 and h2 are rounded to the
// compute type T between the convs, as the JAX kernels do.
//
// Layouts (what bottleneck_weights emits, in T; biases float32):
//   x, y : (N, H, W, C) contiguous NHWC
//   w1   : (C, wd)            [in, out]
//   w2   : (9, wd, wd)        [tap dy*3+dx, in, out]
//   w3   : (wd, C)            [in, out]
//
// Shared-memory layout ("halo grid"): h1 row q holds halo pixel
// (q / HW, q % HW) of the (th+2) x (tw+2) halo tile, HW = tw + 2; h2 row q
// holds output pixel (q / HW, q % HW) — columns tw, tw+1 of each h2 row are
// computed and never stored.  A 3x3 tap (dy, dx) is then the constant row
// offset dy*HW + dx: conv2 reads h1 rows q + dy*HW + dx, conv3 reads h2 row
// q, both straight from shared memory, with no gather.  Rows are padded by
// 8 channels (16 B in bf16) so ldmatrix's eight row addresses hit distinct
// banks.
//
// What bounds it: at the main path's shapes every block is 436.7 MFLOP an
// image; stages 0-1 move enough bytes to be memory-bound on the card's
// tensor-core roofline, stages 2-3 are compute-bound.  Each conv is a
// block-level GEMM (block_gemm.cuh):
//   * bf16 with C and wd multiples of 64 (every main-path shape): mma.sync
//     m16n8k16 on the tensor cores, ldmatrix operands, 32x32 accumulators
//     per warp in registers; the block tile adapts to M (128x64 or
//     64x128); conv1's A (x) and every weight panel stream through a
//     cp.async pipeline with one barrier per 64-deep k-step (two stages
//     for conv1, three for conv2 and conv3, which stage only weights), so
//     later k-steps' loads fly while this one computes; epilogues map each
//     output row to its destination once per row block and issue their
//     global loads ahead of their stores;
//   * otherwise (float32, other widths): scalar staging and float32 FMAs on
//     the CUDA cores, bound by the 67 TFLOP/s FMA pipe.
// Still to do for speed: conv3's residual reads of x are 4-byte and
// scattered (the mma fragment layout), so stage the output tile through
// shared memory for 16-byte reads and writes; at stage 3 every block
// streams all of the weights from L2 for a 4x7 tile, so share them across
// a cluster (TMA multicast); then wgmma.
//
// Shared memory per block — see smem_bytes(), mirrored by
// srsem_torch/ops/fused_bottleneck.py::bottleneck_smem_bytes.

#include "block_gemm.cuh"

namespace {

using namespace block_gemm;

// Rows of h2 (output pixels in the halo grid, padded to 32-row warp slabs)
// and of h1 (h2's rows plus the largest tap offset, 2*HW + 2).
__host__ __device__ inline int h2_rows(int th, int tw) {
  return (th * (tw + 2) + 31) / 32 * 32;
}
__host__ __device__ inline int h1_rows(int th, int tw) {
  return h2_rows(th, tw) + 2 * (tw + 2) + 2;
}

__host__ __device__ inline size_t h1_bytes(int th, int tw, int wd, int item) {
  return align128(static_cast<size_t>(h1_rows(th, tw)) * (wd + kPad) * item);
}

__host__ __device__ inline size_t h2_bytes(int th, int tw, int wd, int item) {
  return align128(static_cast<size_t>(h2_rows(th, tw)) * (wd + kPad) * item);
}

__host__ __device__ inline size_t smem_bytes(int th, int tw, int wd, int item) {
  return h1_bytes(th, tw, wd, item) + h2_bytes(th, tw, wd, item) +
         kStagingBytes;
}

template <typename T, bool TC>
__global__ void __launch_bounds__(kThreads)
    fused_bottleneck_kernel(const T* __restrict__ x, T* __restrict__ y,
                            const T* __restrict__ w1,
                            const float* __restrict__ b1,
                            const T* __restrict__ w2,
                            const float* __restrict__ b2,
                            const T* __restrict__ w3,
                            const float* __restrict__ b3, int H, int W, int C,
                            int wd, int th, int tw, int tiles_h, int tiles_w) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int hw = tw + 2;                  // halo-grid row length
  const int p_halo = (th + 2) * hw;       // conv1 rows
  const int p_out = th * hw;              // conv2 / conv3 rows
  const int ld = wd + kPad;
  const int item = static_cast<int>(sizeof(T));
  T* h1s = reinterpret_cast<T*>(smem);
  T* h2s = reinterpret_cast<T*>(smem + h1_bytes(th, tw, wd, item));
  unsigned char* stage =
      smem + h1_bytes(th, tw, wd, item) + h2_bytes(th, tw, wd, item);

  int tile = blockIdx.x;
  const int tcol = tile % tiles_w;
  tile /= tiles_w;
  const int trow = tile % tiles_h;
  const int img = tile / tiles_h;
  const int r0 = trow * th, c0 = tcol * tw;
  const T* xi = x + static_cast<size_t>(img) * H * W * C;
  T* yi = y + static_cast<size_t>(img) * H * W * C;

  // Epilogues: row(m) gives {offset of the row's element 0 in the
  // destination, flag}, once per row; store(r, n, v0, v1, two, res) gets
  // the biased sums of element n, and of n + 1 when `two` (the tensor-core
  // path, where C and wd are multiples of 64 and n is even, so each pair
  // is aligned).  Offsets within one image fit in an int (the launch
  // checks H * W * C).
  //
  // conv1 over the halo tile; out-of-image pixels are zero in h1.
  auto x_row = [&](int m) -> const T* {
    const int gy = r0 - 1 + m / hw, gx = c0 - 1 + m % hw;
    if (gy < 0 || gy >= H || gx < 0 || gx >= W) return nullptr;
    return xi + (static_cast<size_t>(gy) * W + gx) * C;
  };
  auto a1 = [&](int m, int k) -> const T* {
    const T* p = x_row(m);
    return p ? p + k : nullptr;
  };
  auto no_res = [](int2, int, bool) { return make_float2(0.f, 0.f); };
  auto row1 = [&](int m) {  // flag: the halo pixel lies in the image
    const int gy = r0 - 1 + m / hw, gx = c0 - 1 + m % hw;
    return make_int2(m * ld, gy >= 0 && gy < H && gx >= 0 && gx < W);
  };
  auto s1 = [&](int2 r, int n, float v0, float v1, bool two, float2) {
    put(h1s + r.x + n, r.y ? fmaxf(v0, 0.f) : 0.f, r.y ? fmaxf(v1, 0.f) : 0.f,
        two);
  };
  // conv2 (3x3): K runs over (tap, input channel); tap (dy, dx) reads h1
  // row q + dy*hw + dx.  h1_tap(k) is the address of A(0, k).
  auto h1_tap = [&](int k) -> const T* {
    const int t = k / wd, dy = t / 3, dx = t - dy * 3;
    return h1s + static_cast<size_t>(dy * hw + dx) * ld + (k - t * wd);
  };
  auto a2 = [&](int q, int k) -> const T* {
    return h1_tap(k) + static_cast<size_t>(q) * ld;
  };
  auto row2 = [&](int q) { return make_int2(q * ld, 1); };
  auto s2 = [&](int2 r, int n, float v0, float v1, bool two, float2) {
    put(h2s + r.x + n, fmaxf(v0, 0.f), fmaxf(v1, 0.f), two);
  };
  // conv3 + residual; halo-grid columns >= tw and pixels past a ragged
  // image edge are not written.
  auto h2_col = [&](int k) -> const T* { return h2s + k; };
  auto a3 = [&](int q, int k) -> const T* {
    return h2s + static_cast<size_t>(q) * ld + k;
  };
  auto row3 = [&](int q) {  // flag: an output pixel of this tile
    const int oy = q / hw, ox = q - oy * hw;
    const int gy = r0 + oy, gx = c0 + ox;
    return make_int2((gy * W + gx) * C, ox < tw && gy < H && gx < W);
  };
  auto r3 = [&](int2 r, int n, bool two) {
    return r.y ? get(xi + r.x + n, two) : make_float2(0.f, 0.f);
  };
  auto s3 = [&](int2 r, int n, float v0, float v1, bool two, float2 res) {
    if (r.y)
      put(yi + r.x + n, fmaxf(v0 + res.x, 0.f), fmaxf(v1 + res.y, 0.f), two);
  };

  if constexpr (TC) {
    gemm_tc<true>(
        p_halo, wd, C, x_row,
        [](const T* p, int k0) -> const T* { return p ? p + k0 : nullptr; },
        0, [&](int k) { return w1 + static_cast<size_t>(k) * wd; }, b1, row1,
        no_res, s1, w1, stage);
    __syncthreads();
    gemm_tc<false>(p_out, wd, 9 * wd, h1_tap, 0, ld,
                   [&](int k) { return w2 + static_cast<size_t>(k) * wd; }, b2,
                   row2, no_res, s2, w2, stage);
    __syncthreads();
    gemm_tc<false>(p_out, C, wd, h2_col, 0, ld,
                   [&](int k) { return w3 + static_cast<size_t>(k) * C; }, b3,
                   row3, r3, s3, w3, stage);
  } else {
    gemm_fma<T>(p_halo, wd, C, a1,
                [&](int k, int n) { return w1 + static_cast<size_t>(k) * wd + n; },
                b1, row1, no_res, s1, stage);
    __syncthreads();
    gemm_fma<T>(p_out, wd, 9 * wd, a2,
                [&](int k, int n) { return w2 + static_cast<size_t>(k) * wd + n; },
                b2, row2, no_res, s2, stage);
    __syncthreads();
    gemm_fma<T>(p_out, C, wd, a3,
                [&](int k, int n) { return w3 + static_cast<size_t>(k) * C + n; },
                b3, row3, r3, s3, stage);
  }
}

template <typename T, bool TC>
int launch(const void* x, void* y, const void* w1, const float* b1,
           const void* w2, const float* b2, const void* w3, const float* b3,
           int n, int h, int w, int c, int wd, int th, int tw,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(th, tw, wd, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      fused_bottleneck_kernel<T, TC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_h = (h + th - 1) / th, tiles_w = (w + tw - 1) / tw;
  const long long blocks = static_cast<long long>(n) * tiles_h * tiles_w;
  if (blocks > 0x7fffffffLL ||
      static_cast<long long>(h) * w * c > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  fused_bottleneck_kernel<T, TC><<<static_cast<unsigned>(blocks), kThreads,
                                   smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y),
      static_cast<const T*>(w1), b1, static_cast<const T*>(w2), b2,
      static_cast<const T*>(w3), b3, h, w, c, wd, th, tw, tiles_h, tiles_w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Dynamic shared memory one block of tile (th, tw) needs, in bytes.
size_t srsem_bottleneck_smem_bytes(int th, int tw, int wd, int itemsize) {
  return smem_bytes(th, tw, wd, itemsize);
}

// 1 when (is_bf16, c, wd) take the tensor-core path, else 0 (FMA path).
int srsem_bottleneck_uses_tensor_cores(int is_bf16, int c, int wd) {
  return is_bf16 && c % 64 == 0 && wd % 64 == 0;
}

// Launch on `stream`; returns the cudaError_t of the launch (0 = queued).
// Pointers must be 16-byte aligned (the wrapper checks).
int srsem_fused_bottleneck(const void* x, void* y, const void* w1,
                           const void* b1, const void* w2, const void* b2,
                           const void* w3, const void* b3, int n, int h, int w,
                           int c, int wd, int th, int tw, int is_bf16,
                           void* stream) {
  if (n < 1 || h < 1 || w < 1 || c < 1 || wd < 1 || th < 1 || tw < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto f1 = static_cast<const float*>(b1);
  const auto f2 = static_cast<const float*>(b2);
  const auto f3 = static_cast<const float*>(b3);
  if (srsem_bottleneck_uses_tensor_cores(is_bf16, c, wd))
    return launch<bf16, true>(x, y, w1, f1, w2, f2, w3, f3, n, h, w, c, wd,
                              th, tw, s);
  if (is_bf16)
    return launch<bf16, false>(x, y, w1, f1, w2, f2, w3, f3, n, h, w, c, wd,
                               th, tw, s);
  return launch<float, false>(x, y, w1, f1, w2, f2, w3, f3, n, h, w, c, wd,
                              th, tw, s);
}

}  // extern "C"
