// Fused CLU UNet decoder level for Hopper (sm_90a), float32 and bf16.
//
// Replaces the two Pallas TPU kernels of srsem/ops/fused_decoder.py:
//   * fused_decoder_level       (_decoder_kernel, whole images per program)
//   * fused_decoder_level_tiled (_tiled_decoder_kernel + _copy_with_halo,
//     row tiles with a 1- or 2-row halo)
// On Hopper they are one design, as fused_bottleneck.cu is for the
// bottleneck pair: a thread block computes one output tile of
// (image, rows, columns) with its halo, and the two Python wrappers differ
// only in how they choose the tile.
//
// Computes, with BN folded into the weights (folded_decoder_weights):
//     h1 = relu(conv3x3(d, W1d) + conv3x3(u, W1u) + b1)    u optional
//     y  = relu(conv3x3(h1, W2) + b2)      final_kernel 3
//     y  = relu(h1 . W2 + b2)              final_kernel 1 (level 0's head)
// The (d, u) channel concat is never built: conv1's K runs over
// (tap, channel of d) and then (tap, channel of u) into one float32
// accumulator (the split-concat identity).  h1 lives in shared memory
// only.  With a 3x3 conv2, h1 carries a 1-pixel halo and is ZERO outside
// the image (conv2's SAME padding pads h1, not the inputs — the masking of
// _tiled_decoder_kernel :222-228), so the inputs are read with a 2-pixel
// halo; with a 1x1 conv2 h1 is exactly the tile and the inputs need 1.
// Products accumulate in float32; h1 is rounded to the compute type T
// between the convs, and y is written in T, as the JAX kernels do.
//
// Layouts (what srsem_torch/ops/fused_decoder.py passes, in T; biases
// float32):
//   d : (N, H, W, Cd)   u : (N, H, W, Cu) or null (Cu = 0)
//   w1d : (9, Cd, Cm)   w1u : (9, Cu, Cm)   [tap dy*3+dx, in, out]
//   w2 : (9, Cm, Co) for final_kernel 3, (Cm, Co) for final_kernel 1
//   y : (N, H, W, Co)
//
// Shared-memory layout ("halo grid", as in fused_bottleneck.cu): h1 row q
// holds pixel (q / HW, q % HW) of the (th + 2e) x (tw + 2e) h1 tile,
// HW = tw + 2e, e = 1 for a 3x3 conv2 and 0 for a 1x1.  A tap (dy, dx) of
// conv2 is then the constant row offset dy*HW + dx, read by ldmatrix
// straight from shared memory; conv2's output row q is pixel
// (q / HW, q % HW) of the tile, columns >= tw computed and not stored.
//
// What bounds it: at batch 32 and 224 px the three fused levels are
// 4.7e11 (L1, L2) and 1.5e11 (L0) FLOP against 0.2-0.3 GB of d and u, so
// every level is bound by the tensor cores' operations, not by bytes.  So
// the design keeps every product on the tensor cores and h1 on chip:
//   * conv1 is an implicit GEMM over global memory: each k-step of 64 lies
//     in one tap of one input (Cd, Cu multiples of 64; the wrapper pads a
//     v2 skip diff with zero channels), and the staged A row of h1 pixel p
//     is input pixel p + (dy - 1, dx - 1), or zeros outside the image, so
//     no im2col or concat is written and the halo comes from the same
//     loads; the reads repeat across taps and output-channel tiles, and
//     hit L2;
//   * conv2 (3x3) reads h1 from shared memory as conv2 of the bottleneck
//     does; the 1x1 head to one channel is a dot product per pixel;
//   * bf16 with Cd, Cu, Cm and (3x3) Co multiples of 64 — every main-path
//     level — runs on mma.sync m16n8k16 with a cp.async pipeline
//     (block_gemm.cuh::gemm_tc); float32 and other widths run on FMAs
//     (gemm_fma), bound by the 67 TFLOP/s FMA pipe.
// Still to do for speed: the staged input chunk is re-read for each of the
// nine taps and each 64- or 128-wide tile of Cm; stage it once per chunk
// with its halo and shift it per tap in shared memory; then wgmma.
//
// The tile is chosen here too (srsem_decoder_tile, which the Python
// wrapper asks): shared memory per block is smem_bytes(), and the
// whole-image wrapper's tile comes from a model of waves times work
// (wave_tile), so the shared-memory and cost rules have one copy.

#include "block_gemm.cuh"

namespace {

using namespace block_gemm;

// Rows of h1 in shared memory for tile (th, tw).  3x3 conv2: its th*HW
// output rows (padded to 32-row warp slabs on the tensor cores) plus the
// largest tap offset 2*HW + 2.  1x1 conv2: the tile's pixels.
__host__ __device__ inline int h1_rows(int th, int tw, int k2, bool tc) {
  if (k2 == 1) return th * tw;
  const int hw = tw + 2;
  const int out = tc ? (th * hw + 31) / 32 * 32 : th * hw;
  return out + 2 * hw + 2;
}

__host__ __device__ inline size_t smem_bytes(int th, int tw, int cm, int item,
                                             int k2, bool tc) {
  return align128(static_cast<size_t>(h1_rows(th, tw, k2, tc)) * (cm + kPad) *
                  item) +
         kStagingBytes;
}

__host__ __device__ inline bool uses_tensor_cores(bool is_bf16, int cd, int cu,
                                                  int cm, int co, int k2) {
  return is_bf16 && cd % 64 == 0 && cu % 64 == 0 && cm % 64 == 0 &&
         (k2 == 1 || co % 64 == 0);
}

// Rows per tile when h rows split into tiles of at most th rows as evenly
// as possible (14 rows in two tiles are 7 + 7, not 13 + 1).
inline int balanced(int h, int th) {
  const int tiles = (h + th - 1) / th;
  return (h + tiles - 1) / tiles;
}

inline bool fits(int th, int tw, int cm, int item, int k2, bool tc) {
  return smem_bytes(th, tw, cm, item, k2, tc) <= kSmemLimit;
}

// An output tile that fits in shared memory: row_tile rows when
// row_tile > 0 (min(row_tile, h)), else the tallest that fits, with the
// rows balanced.  The width is split only when full-width rows do not fit.
bool pick_tile(int h, int w, int cm, int item, int k2, bool tc, int row_tile,
               int* th, int* tw) {
  for (int splits = 1; splits <= w; ++splits) {
    const int cw = (w + splits - 1) / splits;
    const int lo = row_tile > 0 ? (row_tile < h ? row_tile : h) : 1;
    const int hi = row_tile > 0 ? lo : h;
    for (int t = hi; t >= lo; --t) {
      if (fits(t, cw, cm, item, k2, tc)) {
        *th = row_tile > 0 ? t : balanced(h, t);
        *tw = cw;
        return true;
      }
    }
  }
  return false;
}

// The whole-image wrapper's tile for n images on sms SMs: of the tiles
// that fit (widths from 1-4 column splits, balanced rows), the one with
// the least modelled time — waves of blocks (one block per SM, since a
// tile takes most of an SM's shared memory) times one block's
// multiply-adds, with h1's halo, the halo-grid columns and each GEMM's
// rows rounded up to its row tile.  Ties go to the larger tile.
bool wave_tile(int n, int h, int w, int cin, int cm, int co, int item, int k2,
               bool tc, int sms, int* th, int* tw) {
  const int e = k2 == 3 ? 1 : 0;
  long long best = -1;
  int best_area = 0;
  for (int splits = 1; splits <= (w < 4 ? w : 4); ++splits) {
    const int cw = (w + splits - 1) / splits;
    int top = h;
    while (top > 0 && !fits(top, cw, cm, item, k2, tc)) --top;
    for (int t = 1, last = 0; t <= top; ++t) {
      const int rows = balanced(h, t);  // nondecreasing in t
      if (rows == last) continue;
      last = rows;
      const long long blocks = static_cast<long long>(n) *
                               ((h + rows - 1) / rows) * ((w + cw - 1) / cw);
      long long macs = static_cast<long long>(
                           gemm_rows(h1_rows(rows, cw, k2, tc), cm, tc)) *
                       9 * cin * cm;
      macs += k2 == 3 ? static_cast<long long>(
                            gemm_rows(rows * (cw + 2 * e), co, tc)) *
                            9 * cm * co
                      : static_cast<long long>(rows) * cw * cm * co;
      const long long cost = (blocks + sms - 1) / sms * macs;
      if (best < 0 || cost < best || (cost == best && rows * cw > best_area)) {
        best = cost;
        best_area = rows * cw;
        *th = rows;
        *tw = cw;
      }
    }
  }
  // Only narrower columns fit (or nothing: false).
  return best >= 0 || pick_tile(h, w, cm, item, k2, tc, 0, th, tw);
}

template <typename T, bool TC>
__global__ void __launch_bounds__(kThreads)
    fused_decoder_kernel(const T* __restrict__ d, const T* __restrict__ u,
                         const T* __restrict__ w1d, const T* __restrict__ w1u,
                         const float* __restrict__ b1,
                         const T* __restrict__ w2,
                         const float* __restrict__ b2, T* __restrict__ y,
                         int H, int W, int Cd, int Cu, int Cm, int Co, int k2,
                         int th, int tw, int tiles_h, int tiles_w) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int e = k2 == 3 ? 1 : 0;           // h1 halo
  const int hw = tw + 2 * e;               // halo-grid row length
  const int m1 = h1_rows(th, tw, k2, TC);  // conv1 rows (all of h1)
  const int ld = Cm + kPad;
  const int item = static_cast<int>(sizeof(T));
  T* h1s = reinterpret_cast<T*>(smem);
  unsigned char* stage =
      smem + align128(static_cast<size_t>(m1) * ld * item);

  int tile = blockIdx.x;
  const int tcol = tile % tiles_w;
  tile /= tiles_w;
  const int trow = tile % tiles_h;
  const int img = tile / tiles_h;
  const int r0 = trow * th, c0 = tcol * tw;
  const size_t pix0 = static_cast<size_t>(img) * H * W;
  const T* di = d + pix0 * Cd;
  const T* ui = u ? u + pix0 * Cu : nullptr;
  T* yi = y + pix0 * Co;
  const int kd = 9 * Cd;            // conv1's K over d; u follows
  const int k1 = kd + 9 * Cu;

  auto inside = [&](int gy, int gx) {
    return gy >= 0 && gy < H && gx >= 0 && gx < W;
  };
  // conv1, A(m, k): h1 row m is pixel (gy, gx) = pix1(m); k = tap * Cin + c
  // over d, then over u.  Offsets within one image fit in an int (the
  // launch checks H * W * C).
  auto pix1 = [&](int m) {
    return make_int2(r0 - e + m / hw, c0 - e + m % hw);
  };
  auto a_at = [&](int2 p, int k0) -> const T* {
    const bool in_d = k0 < kd;
    const int cin = in_d ? Cd : Cu;
    const int kk = in_d ? k0 : k0 - kd;
    const int t = kk / cin, c = kk - t * cin;
    const int dy = t / 3, dx = t - 3 * dy;
    const int gy = p.x + dy - 1, gx = p.y + dx - 1;
    if (!inside(gy, gx)) return nullptr;
    return (in_d ? di : ui) + (gy * W + gx) * cin + c;
  };
  auto no_res = [](int2, int, bool) { return make_float2(0.f, 0.f); };
  auto row1 = [&](int m) {  // flag: the h1 pixel lies in the image
    const int2 p = pix1(m);
    return make_int2(m * ld, inside(p.x, p.y));
  };
  auto s1 = [&](int2 r, int n, float v0, float v1, bool two, float2) {
    put(h1s + r.x + n, r.y ? fmaxf(v0, 0.f) : 0.f, r.y ? fmaxf(v1, 0.f) : 0.f,
        two);
  };
  // conv2 (3x3): K runs over (tap, channel of h1); tap (dy, dx) reads h1
  // row q + dy*hw + dx.  h1_tap(k) is the address of A(0, k).
  auto h1_tap = [&](int k) -> const T* {
    const int t = k / Cm, dy = t / 3, dx = t - dy * 3;
    return h1s + static_cast<size_t>(dy * hw + dx) * ld + (k - t * Cm);
  };
  auto row2 = [&](int q) {  // flag: an output pixel of this tile
    const int oy = q / hw, ox = q - oy * hw;
    const int gy = r0 + oy, gx = c0 + ox;
    return make_int2((gy * W + gx) * Co, ox < tw && gy < H && gx < W);
  };
  auto s2 = [&](int2 r, int n, float v0, float v1, bool two, float2) {
    if (r.y) put(yi + r.x + n, fmaxf(v0, 0.f), fmaxf(v1, 0.f), two);
  };
  auto w1_row = [&](int k) -> const T* {
    return k < kd ? w1d + static_cast<size_t>(k) * Cm
                  : w1u + static_cast<size_t>(k - kd) * Cm;
  };
  auto w2_row = [&](int k) { return w2 + static_cast<size_t>(k) * Co; };

  if constexpr (TC) {
    gemm_tc<true>(m1, Cm, k1, pix1, a_at, 0, w1_row, b1, row1, no_res, s1,
                  w1d, stage);
  } else {
    gemm_fma<T>(
        m1, Cm, k1,
        [&](int m, int k) -> const T* {
          const int k0 = k < kd ? k / Cd * Cd : kd + (k - kd) / Cu * Cu;
          const T* p = a_at(pix1(m), k0);
          return p ? p + (k - k0) : nullptr;
        },
        [&](int k, int n) { return w1_row(k) + n; }, b1, row1, no_res, s1,
        stage);
  }
  __syncthreads();

  if (k2 == 3) {
    if constexpr (TC) {
      gemm_tc<false>(th * hw, Co, 9 * Cm, h1_tap, 0, ld, w2_row, b2, row2,
                     no_res, s2, w2, stage);
    } else {
      gemm_fma<T>(
          th * hw, Co, 9 * Cm,
          [&](int q, int k) { return h1_tap(k) + static_cast<size_t>(q) * ld; },
          [&](int k, int n) { return w2_row(k) + n; }, b2, row2, no_res, s2,
          stage);
    }
  } else {
    // 1x1 head: one dot product of Cm channels per (pixel, output channel).
    for (int i = threadIdx.x; i < th * tw * Co; i += kThreads) {
      const int q = i / Co, n = i - q * Co;
      const int gy = r0 + q / tw, gx = c0 + q % tw;
      if (gy >= H || gx >= W) continue;
      const T* a = h1s + static_cast<size_t>(q) * ld;
      float acc = 0.f;
      for (int c = 0; c < Cm; ++c)
        acc = fmaf(to_f(a[c]), to_f(w2[static_cast<size_t>(c) * Co + n]), acc);
      yi[(gy * W + gx) * Co + n] = from_f<T>(fmaxf(acc + b2[n], 0.f));
    }
  }
}

template <typename T, bool TC>
int launch(const void* d, const void* u, const void* w1d, const void* w1u,
           const float* b1, const void* w2, const float* b2, void* y, int n,
           int h, int w, int cd, int cu, int cm, int co, int k2, int th,
           int tw, cudaStream_t stream) {
  const size_t smem = smem_bytes(th, tw, cm, sizeof(T), k2, TC);
  cudaError_t err = cudaFuncSetAttribute(
      fused_decoder_kernel<T, TC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_h = (h + th - 1) / th, tiles_w = (w + tw - 1) / tw;
  const long long blocks = static_cast<long long>(n) * tiles_h * tiles_w;
  const long long cmax = cd > cu ? (cd > co ? cd : co) : (cu > co ? cu : co);
  if (blocks > 0x7fffffffLL ||
      static_cast<long long>(h) * w * cmax > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  fused_decoder_kernel<T, TC><<<static_cast<unsigned>(blocks), kThreads, smem,
                                stream>>>(
      static_cast<const T*>(d), static_cast<const T*>(u),
      static_cast<const T*>(w1d), static_cast<const T*>(w1u), b1,
      static_cast<const T*>(w2), b2, static_cast<T*>(y), h, w, cd, cu, cm, co,
      k2, th, tw, tiles_h, tiles_w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// 1 when the shapes take the tensor-core path, else 0 (FMA path).
int srsem_decoder_uses_tensor_cores(int is_bf16, int cd, int cu, int cm,
                                    int co, int k2) {
  return uses_tensor_cores(is_bf16 != 0, cd, cu, cm, co, k2);
}

// The tile (*th, *tw) to launch with: row_tile rows when row_tile > 0,
// else wave_tile's choice for `sms` SMs.  Returns 0, or
// cudaErrorInvalidValue when no tile fits in shared memory.
int srsem_decoder_tile(int n, int h, int w, int cd, int cu, int cm, int co,
                       int k2, int is_bf16, int row_tile, int sms, int* th,
                       int* tw) {
  if (n < 1 || h < 1 || w < 1 || cm < 1 || co < 1 || sms < 1 ||
      (k2 != 1 && k2 != 3))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool tc = uses_tensor_cores(is_bf16 != 0, cd, cu, cm, co, k2);
  const int item = is_bf16 ? 2 : 4;
  const bool ok = row_tile > 0
                      ? pick_tile(h, w, cm, item, k2, tc, row_tile, th, tw)
                      : wave_tile(n, h, w, cd + cu, cm, co, item, k2, tc, sms,
                                  th, tw);
  return ok ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// Launch on `stream`; returns the cudaError_t of the launch (0 = queued).
// u and w1u are null when cu == 0.  Pointers must be 16-byte aligned (the
// wrapper checks).
int srsem_fused_decoder(const void* d, const void* u, const void* w1d,
                        const void* w1u, const void* b1, const void* w2,
                        const void* b2, void* y, int n, int h, int w, int cd,
                        int cu, int cm, int co, int k2, int th, int tw,
                        int is_bf16, void* stream) {
  if (n < 1 || h < 1 || w < 1 || cd < 1 || cu < 0 || cm < 1 || co < 1 ||
      th < 1 || tw < 1 || (k2 != 1 && k2 != 3) || (cu > 0) != (u != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto f1 = static_cast<const float*>(b1);
  const auto f2 = static_cast<const float*>(b2);
  if (uses_tensor_cores(is_bf16 != 0, cd, cu, cm, co, k2))
    return launch<bf16, true>(d, u, w1d, w1u, f1, w2, f2, y, n, h, w, cd, cu,
                              cm, co, k2, th, tw, s);
  if (is_bf16)
    return launch<bf16, false>(d, u, w1d, w1u, f1, w2, f2, y, n, h, w, cd, cu,
                               cm, co, k2, th, tw, s);
  return launch<float, false>(d, u, w1d, w1u, f1, w2, f2, y, n, h, w, cd, cu,
                              cm, co, k2, th, tw, s);
}

}  // extern "C"
