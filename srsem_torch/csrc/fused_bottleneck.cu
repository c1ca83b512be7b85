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
// block-level GEMM:
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kPad = 8;  // channels of padding per h1/h2 row
// Scalar (FMA) path: 64x64 output tiles, 4x4 per thread, k-steps of 16.
constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int TM = 4;
constexpr int TN = 4;
static_assert((BM / TM) * (BN / TN) == kThreads, "thread tile mismatch");
// Tensor-core path: 8 warps of 32x32, k-steps of 64.  conv1 stages A (x)
// and B (W1), two stages; conv2 and conv3 read A from shared memory and
// stage only B (weights), three stages.  (Measured on the H100: deeper
// pipelines gained little, fewer barriers per product more.)
constexpr int TBK = 64;
constexpr int kStagesAB = 2;
constexpr int kStagesB = 3;
// Bytes of one stage: A and B of the larger tile (128x64), or B alone.
constexpr int kTcStageBytes = (128 * (TBK + 8) + TBK * (64 + 8)) * 2;
constexpr int kTcStageBytesB = TBK * (128 + 8) * 2;
constexpr int kStagingBytes = kStagesAB * kTcStageBytes > kStagesB * kTcStageBytesB
                                  ? kStagesAB * kTcStageBytes
                                  : kStagesB * kTcStageBytesB;
static_assert(kStagingBytes >= BK * (BM + BN) * 4, "fma staging");
static_assert((64 * (TBK + 8) + TBK * (128 + 8)) * 2 <= kTcStageBytes,
              "64x128 tile staging");

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);
}

// Store v0 at p (and v1 at p + 1 when `two`, as one 4- or 8-byte store:
// p must then be aligned to the pair).
template <typename T>
__device__ __forceinline__ void put(T* p, float v0, float v1, bool two) {
  if (!two) {
    *p = from_f<T>(v0);
  } else if constexpr (sizeof(T) == 2) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
  }
}

// p[0] and, when `two`, p[1] as floats (a pair read as one load).
template <typename T>
__device__ __forceinline__ float2 get(const T* p, bool two) {
  if (!two) return make_float2(to_f(*p), 0.f);
  if constexpr (sizeof(T) == 2)
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  else
    return *reinterpret_cast<const float2*>(p);
}

__host__ __device__ inline size_t align128(size_t b) {
  return (b + 127) & ~static_cast<size_t>(127);
}

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

// ---- scalar FMA path --------------------------------------------------
// C[M, N] = A[M, K] . B[K, N] for the whole block, in 64x64 output tiles.
// a_ptr(m, k) / b_ptr(k, n) return the element's address (a_ptr may return
// nullptr for a zero, e.g. a pixel outside the image).  The epilogue is
// store(r, n, C(m, n) + bias[n], 0, false, res(r, n, false)) with
// r = row(m).  M, N, K are block-uniform, so every thread reaches every
// __syncthreads.
template <typename T, class APtr, class BPtr, class Row, class Res,
          class Store>
__device__ void gemm_fma(int M, int N, int K, APtr a_ptr, BPtr b_ptr,
                         const float* bias, Row row, Res res, Store store,
                         unsigned char* stage) {
  float* As = reinterpret_cast<float*>(stage);
  float* Bs = As + BK * BM;
  const int tid = threadIdx.x;
  const int ty = tid / (BN / TN);
  const int tx = tid % (BN / TN);
  for (int m0 = 0; m0 < M; m0 += BM) {
    for (int n0 = 0; n0 < N; n0 += BN) {
      float acc[TM][TN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
      for (int k0 = 0; k0 < K; k0 += BK) {
        for (int e = tid; e < BM * BK; e += kThreads) {
          const int mm = e / BK, kk = e % BK;
          const int m = m0 + mm, k = k0 + kk;
          const T* p = (m < M && k < K) ? a_ptr(m, k) : nullptr;
          As[kk * BM + mm] = p ? to_f(*p) : 0.f;
        }
        for (int e = tid; e < BK * BN; e += kThreads) {
          const int kk = e / BN, nn = e % BN;
          const int k = k0 + kk, n = n0 + nn;
          Bs[kk * BN + nn] = (k < K && n < N) ? to_f(*b_ptr(k, n)) : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
          float a[TM], b[TN];
#pragma unroll
          for (int i = 0; i < TM; ++i) a[i] = As[kk * BM + ty * TM + i];
#pragma unroll
          for (int j = 0; j < TN; ++j) b[j] = Bs[kk * BN + tx * TN + j];
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int m = m0 + ty * TM + i;
        if (m >= M) continue;
        const int2 r = row(m);
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int n = n0 + tx * TN + j;
          if (n < N)
            store(r, n, acc[i][j] + bias[n], 0.f, false, res(r, n, false));
        }
      }
    }
  }
}

// ---- tensor-core path (bf16) ----------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a . b, m16n8k16, bf16 in, float32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16-byte async copy global -> shared; zero-fills when !valid (src-size 0;
// `src` must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// C[M, N] = A[M, K] . B[K, N] on the tensor cores.  Needs K % 64 == 0,
// N % 64 == 0.  A_GLOBAL (conv1): a_fn(m) is the global address of A's row
// m (nullptr: a zero row, e.g. a pixel outside the image), and A is staged
// with cp.async.  Otherwise (conv2, conv3): a_fn(k0) is the shared-memory
// address of A(0, k0), A(m, k0 + kk) = a_fn(k0) + m * a_ld + kk for
// kk < TBK, read by ldmatrix directly; valid for every m below M rounded up
// to 32 (rows past M are computed and not stored).  b_row(k) is the global
// address of B's row k.  The epilogue is store(r, n, C(m, n) + bias[n],
// C(m, n + 1) + bias[n + 1], true, res(r, n, true)) with r = row(m), which
// maps an output row to where it goes (once per m-tile, outside the n
// loop); res returns the pair a store adds after the bias (the residual
// of conv3).
//
// The pipeline keeps S - 1 k-steps of loads in flight (S = 2 when A is
// staged, 3 when only B is) behind one barrier per k-step: the slot a
// k-step refills was read in the previous k-step, which every warp has
// finished once it is past this k-step's barrier.
template <bool A_GLOBAL, class AFn, class BRow, class Row, class Res,
          class Store>
__device__ void gemm_tc(int M, int N, int K, AFn a_fn, int a_ld, BRow b_row,
                        const float* bias, Row row, Res res, Store store,
                        const bf16* dummy, unsigned char* stage) {
  constexpr int S = A_GLOBAL ? kStagesAB : kStagesB;
  constexpr int sa_ld = TBK + 8;  // staged A row, padded against conflicts
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // Warp grid wr x wc (wr * wc = 8), each warp 32x32: a 128x64 tile for
  // large M, 64x128 for small M (wc <= 4 bounds the staging size).
  const int wr0 = M <= 32 ? 1 : (M <= 64 ? 2 : 4);
  const int wc = min(8 / wr0, min(4, N / 32));
  const int tile_m = 32 * (8 / wc), tile_n = 32 * wc;
  const int b_ld = tile_n + 8;
  const int warp_m = (warp / wc) * 32, warp_n = (warp % wc) * 32;
  const int a_elems = A_GLOBAL ? tile_m * sa_ld : 0;
  const int stage_elems = a_elems + TBK * b_ld;
  bf16* const slots = reinterpret_cast<bf16*>(stage);
  const int nk = K / TBK;

  // What this thread stages each k-step, in 16-byte vectors: B rows b_k0
  // (+ b_rows per pass) at column b_n (tile_n / 8 vectors a row), and A
  // rows a_r0 (+ a_rows per pass) at k-offset a_k (TBK / 8 vectors a row).
  const int vec_shift = tile_n == 128 ? 4 : 3;
  const int b_k0 = tid >> vec_shift, b_n = (tid & ((1 << vec_shift) - 1)) * 8;
  const int b_rows = kThreads >> vec_shift;
  const int b_passes = TBK / b_rows;
  constexpr int a_vecs = TBK / 8, a_rows = kThreads / a_vecs;
  const int a_passes = tile_m / a_rows;  // at most 4: tile_m <= 128
  const int a_r0 = tid / a_vecs, a_k = (tid % a_vecs) * 8;
  // ldmatrix offsets of this lane within a slot (A) and a k-step (B).
  int b_frag[2];
#pragma unroll
  for (int j = 0; j < 2; ++j)
    b_frag[j] = ((lane & 7) + ((lane >> 3) & 1) * 8) * b_ld + warp_n +
                j * 16 + (lane >> 4) * 8;

  for (int m0 = 0; m0 < M; m0 += tile_m) {
    const bool warp_active = m0 + warp_m < M;  // warp-uniform
    int a_frag[2];
    const bf16* a_src[4] = {nullptr, nullptr, nullptr, nullptr};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = warp_m + i * 16 + (lane & 15);
      a_frag[i] = A_GLOBAL ? row * sa_ld + (lane >> 4) * 8
                           : (m0 + row) * a_ld + (lane >> 4) * 8;
    }
    if constexpr (A_GLOBAL) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int m = m0 + a_r0 + a_rows * j;
        if (j < a_passes && m < M) a_src[j] = a_fn(m);
      }
    }
    // The four output rows this lane stores, (i, h) -> row + 16 i + 8 h.
    int2 rows[2][2];
    bool row_ok[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + warp_m + i * 16 + h * 8 + (lane >> 2);
        row_ok[i][h] = warp_active && m < M;
        rows[i][h] = row_ok[i][h] ? row(m) : make_int2(0, 0);
      }

    for (int n0 = 0; n0 < N; n0 += tile_n) {
      float acc[2][4][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

      const bool b_ok = n0 + b_n < N;
      auto load_stage = [&](int ks) {
        bf16* as = slots + (ks % S) * stage_elems;
        bf16* bs = as + a_elems;
        const int k0 = ks * TBK;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (j >= b_passes) break;
          const int kk = b_k0 + j * b_rows;
          cp_async16(bs + kk * b_ld + b_n,
                     b_ok ? b_row(k0 + kk) + n0 + b_n : dummy, b_ok);
        }
        if constexpr (A_GLOBAL) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (j >= a_passes) break;
            const bf16* p = a_src[j];
            cp_async16(as + (a_r0 + a_rows * j) * sa_ld + a_k,
                       p ? p + k0 + a_k : dummy, p != nullptr);
          }
        }
      };

#pragma unroll
      for (int ks = 0; ks < S - 1; ++ks) {
        if (ks < nk) load_stage(ks);
        cp_async_commit();
      }
      for (int ks = 0; ks < nk; ++ks) {
        cp_async_wait<S - 2>();  // this thread's copies of k-step ks landed
        __syncthreads();         // everyone's did; slot (ks - 1) % S is free
        if (ks + S - 1 < nk) load_stage(ks + S - 1);
        cp_async_commit();
        if (warp_active) {
          const bf16* as = slots + (ks % S) * stage_elems;
          const bf16* bs = as + a_elems;
          const bf16* a_base;
          if constexpr (A_GLOBAL)
            a_base = as;
          else
            a_base = a_fn(ks * TBK);
#pragma unroll
          for (int kk = 0; kk < TBK; kk += 16) {
            uint32_t a[2][4], b[2][4];
#pragma unroll
            for (int i = 0; i < 2; ++i)
              ldmatrix_x4(a[i], a_base + a_frag[i] + kk);
#pragma unroll
            for (int j = 0; j < 2; ++j)
              ldmatrix_x4_trans(b[j], bs + b_frag[j] + kk * b_ld);
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j)
                mma_bf16(acc[i][j], a[i], b[j >> 1][(j & 1) * 2],
                         b[j >> 1][(j & 1) * 2 + 1]);
          }
        }
      }
      __syncthreads();  // the next tile's first loads refill these slots

      if (warp_active) {
        // Every bias and residual load first, all in flight together, then
        // the stores: the compiler does not move a load past a store that
        // may alias it, so interleaved they would wait one by one.
        float2 bj[4], r[2][4][2];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = n0 + warp_n + j * 8 + (lane & 3) * 2;
          bj[j] = col < N ? *reinterpret_cast<const float2*>(bias + col)
                          : make_float2(0.f, 0.f);
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              r[i][j][h] = row_ok[i][h] && col < N
                               ? res(rows[i][h], col, true)
                               : make_float2(0.f, 0.f);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int col = n0 + warp_n + j * 8 + (lane & 3) * 2;
              if (row_ok[i][h] && col < N)
                store(rows[i][h], col, acc[i][j][2 * h] + bj[j].x,
                      acc[i][j][2 * h + 1] + bj[j].y, true, r[i][j][h]);
            }
      }
    }
  }
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
    gemm_tc<true>(p_halo, wd, C, x_row, 0,
                  [&](int k) { return w1 + static_cast<size_t>(k) * wd; }, b1,
                  row1, no_res, s1, w1, stage);
    __syncthreads();
    gemm_tc<false>(p_out, wd, 9 * wd, h1_tap, ld,
                   [&](int k) { return w2 + static_cast<size_t>(k) * wd; }, b2,
                   row2, no_res, s2, w2, stage);
    __syncthreads();
    gemm_tc<false>(p_out, C, wd, h2_col, ld,
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
