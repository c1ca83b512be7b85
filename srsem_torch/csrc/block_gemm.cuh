// Block-level GEMMs shared by the port's fused kernels (sm_90a).
//
// A thread block of kThreads threads computes C[M, N] = A[M, K] . B[K, N]
// for the whole block and hands every output element to an epilogue
// functor, so each fused kernel keeps its intermediates in shared memory
// and chains its convolutions as block GEMMs:
//   * gemm_tc  — bf16 on the tensor cores (mma.sync m16n8k16, ldmatrix
//     operands, cp.async pipeline); needs K % 64 == 0 and N % 64 == 0;
//   * gemm_fma — any dtype and width, float32 FMAs on the CUDA cores.
// Users: fused_bottleneck.cu (both), fused_decoder.cu (gemm_fma, the FMA
// path; its tensor-core path is wgmma, wgmma.cuh).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace block_gemm {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kPad = 8;  // channels of padding per shared-memory row
// Scalar (FMA) path: 64x64 output tiles, 4x4 per thread, k-steps of 16.
constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int TM = 4;
constexpr int TN = 4;
static_assert((BM / TM) * (BN / TN) == kThreads, "thread tile mismatch");
// Tensor-core path: 8 warps of 32x32, k-steps of 64.  A staged from global
// memory (A_GLOBAL) goes with B through two stages; A read from shared
// memory leaves only B (weights) to stage, through three.  (Measured on
// the H100: deeper pipelines gained little, fewer barriers per product
// more.)
constexpr int TBK = 64;
constexpr int kStagesAB = 2;
constexpr int kStagesB = 3;
// Bytes of one stage: A and B of the larger tile (128x64), or B alone.
constexpr int kTcStageBytes = (128 * (TBK + 8) + TBK * (64 + 8)) * 2;
constexpr int kTcStageBytesB = TBK * (128 + 8) * 2;
// Staging bytes either GEMM needs (a kernel reserves them once).
constexpr int kStagingBytes = kStagesAB * kTcStageBytes > kStagesB * kTcStageBytesB
                                  ? kStagesAB * kTcStageBytes
                                  : kStagesB * kTcStageBytesB;
static_assert(kStagingBytes >= BK * (BM + BN) * 4, "fma staging");
static_assert((64 * (TBK + 8) + TBK * (128 + 8)) * 2 <= kTcStageBytes,
              "64x128 tile staging");
// Dynamic shared memory one block may use on sm_90 (227 KB).
constexpr size_t kSmemLimit = 232448;

// Warp columns wc of gemm_tc's wr x wc warp grid (wr * wc = 8, each warp
// 32x32) for an M x N product: a 128x64 tile for large M, 64x128 for small
// M (wc <= 4 bounds the staging size).
__host__ __device__ inline int tc_warp_cols(int M, int N) {
  const int wr0 = M <= 32 ? 1 : (M <= 64 ? 2 : 4);
  const int wc = 8 / wr0 < 4 ? 8 / wr0 : 4;
  return wc < N / 32 ? wc : N / 32;
}

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
// N % 64 == 0.
//
// A_GLOBAL: A is staged from global memory with cp.async.  a_fn(m) maps A's
// row m to a handle once per m-tile (rows past M keep a value-initialised
// handle and are computed, not stored), and a_at(handle, k0) gives the
// global address of A(m, k0 .. k0 + 63) for a k-step, or nullptr for a
// zero row (e.g. a pixel outside the image).  With a pointer handle,
// a_at(p, k0) is p + k0; a 3x3 conv over global memory (fused_decoder.cu)
// keeps the pixel as the handle and finds the tap's pixel per k-step.
//
// Otherwise (A in shared memory): a_fn(k0) is the shared-memory address of
// A(0, k0), A(m, k0 + kk) = a_fn(k0) + m * a_ld + kk for kk < TBK, read by
// ldmatrix directly; valid for every m below M rounded up to 32 (rows past
// M are computed and not stored); a_at is unused.
//
// b_row(k) is the global address of B's row k.  The epilogue is
// store(r, n, C(m, n) + bias[n], C(m, n + 1) + bias[n + 1], true,
// res(r, n, true)) with r = row(m), which maps an output row to where it
// goes (once per m-tile, outside the n loop); res returns the pair a store
// adds after the bias (e.g. a residual).
//
// The pipeline keeps S - 1 k-steps of loads in flight (S = 2 when A is
// staged, 3 when only B is) behind one barrier per k-step: the slot a
// k-step refills was read in the previous k-step, which every warp has
// finished once it is past this k-step's barrier.
template <bool A_GLOBAL, class AFn, class AAt, class BRow, class Row,
          class Res, class Store>
__device__ void gemm_tc(int M, int N, int K, AFn a_fn, AAt a_at, int a_ld,
                        BRow b_row, const float* bias, Row row, Res res,
                        Store store, const bf16* dummy, unsigned char* stage) {
  constexpr int S = A_GLOBAL ? kStagesAB : kStagesB;
  constexpr int sa_ld = TBK + 8;  // staged A row, padded against conflicts
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wc = tc_warp_cols(M, N);
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
    using Handle = decltype(a_fn(0));
    Handle a_src[4] = {};
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
            const bf16* p = a_at(a_src[j], k0);
            cp_async16(as + (a_r0 + a_rows * j) * sa_ld + a_k,
                       p ? p + a_k : dummy, p != nullptr);
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

}  // namespace block_gemm
