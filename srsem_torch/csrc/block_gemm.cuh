// The block-level FMA GEMM of the port's FMA convs (conv_wgmma.cuh's
// conv_fma: float32, and bf16 at widths the tensor cores do not take), and
// the scalar helpers the convs' epilogues share.
//
// A thread block of kThreads threads computes C[M, N] = A[M, K] . B[K, N]
// for the whole block in float32 FMAs on the CUDA cores (gemm_fma, any
// dtype and width) and hands every output element to an epilogue functor.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace block_gemm {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
// 64x64 output tiles, 4x4 per thread, k-steps of 16.
constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int TM = 4;
constexpr int TN = 4;
static_assert((BM / TM) * (BN / TN) == kThreads, "thread tile mismatch");
// Dynamic shared memory one block may use on sm_90 (227 KB).
constexpr size_t kSmemLimit = 232448;

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

}  // namespace block_gemm
