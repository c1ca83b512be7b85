// Fused squared-diff -> 1x1-conv head -> spatial sum for Hopper (sm_90a):
// one launch scores a whole batch, float32, bf16 and float16 taps.
//
// Replaces the Pallas TPU kernel srsem/ops/fused_head.py::fused_stage_score
// (_make_kernel), with the composition fused_global_score puts around it
// (bias, mean over stages, ReLU), and covers the grouped (G, K) head
// srsem/models/global_models.py::fused_grouped_head and the ViT token head
// (TokenHeadAggregator, fused_grouped_token_head), which the JAX package
// leaves to XLA.  For S <= 12 tapped stages and P = G*K pairs:
//     score[p] = relu(mean_s(sum_hwc((gt_s[p/K] - sr_s[p])^2 * w_s[c])
//                           / (H_s*W_s) + b_s))
// over (N, H, W, C) maps, or over (N, T, W) token taps with T in place of
// H*W (the token head's shared form, single_lin_vit, packs its one block
// once a stage).  K = 1 is the pairwise head (GT = taps_a, SR = taps_b).
// In the per-stage mode (S = 1, no mean, no ReLU) it is sum / (H*W) + b:
// fused_stage_score.
//
// What bounds it: bytes.  About 3 FLOP an element, under 1 FLOP a byte in
// bf16, where the card needs about 295 before its tensor cores matter; a
// global batch at 224 px reads 385 MB of taps (0.115 ms at 3.35 TB/s), a
// stages_vit batch 310 MB of float32 token taps (0.0925 ms).  So
// no tensor cores and no shared-memory staging (nothing is reused).  What
// it needs is bytes in flight: about 3.35 TB/s x 0.7 us = 2.3 MB, 18 KB an
// SM.  The design:
//   * 16-byte loads, 8 elements a thread (two loads in float32), neighbour
//     threads on neighbour addresses, read-only and not kept in L1 (each
//     byte is read once); each thread keeps 4 loads a side in flight (4
//     steps unrolled, 2 in float32), and four blocks share an SM (of 256
//     threads: at most 64 registers).
//   * A step is 256 threads x 8 elements = 2048 elements; a chunk is whole
//     groups of 4 steps, so the unrolled loop covers all but a ragged last
//     chunk (sweep_head_plan.py times the other plans).  Where C divides
//     2048 (the conv taps' 256, 512, 1024, 2048) and the taps are 16-byte
//     aligned, a thread's 8 channels stay fixed for a whole chunk: its 8
//     weights are loaded once an item and there is no modulo an element.
//     The ViT's W = 768 does not divide 2048 (2048 = 2 x 768 + 512): there
//     a step is 1536 = 2 x 768 elements, streamed by blocks of 192
//     threads, so their channels stay fixed too and the tokens keep the
//     16-byte loads (4 blocks x 192 threads x 4 loads x 16 B = 48 KB in
//     flight an SM, above the 18 KB the card needs).  The step is a
//     launch's, a template parameter with the block's threads: a step read
//     at run time spills in the float16 K = 2 instance (its unrolled loads
//     need an address register each, not an offset), and 192 of 256
//     threads behind a branch spill in the float32 K = 4 one; 192-thread
//     blocks have up to 80 registers.  Any other C, an unaligned tap and
//     the ragged end of a chunk take the general path: one element a
//     thread, its channel by a modulo.
//   * Work items are (stage, group, k-block, chunk of one image's tap).  An
//     item reads its GT chunk once and streams the k-block's SR chunks (at
//     most 8) against it, the GT vector held in registers across them, with
//     one partial sum an SR image: (1+K)/(2K) of the pairwise bytes.
//   * One launch: every stage's descriptor goes to the kernel by value in
//     its parameters (no descriptor table copied to the card): up to 12, so
//     wperlay_cnn's and wperlay_vit's 12 per-block taps are one launch
//     too.  Twelve are under 1 KB of the 4 KB of kernel parameters, and as
//     the parameters are __grid_constant__ the walk's and the finish's
//     reads of st[s] with a computed s read parameter space, with no copy
//     to a stack frame (the descriptors add no byte to any instance's
//     frame in the ptxas -v lines).  The grid is persistent: at most 4
//     blocks an SM, each walking the items by a fixed stride, largest
//     stage first.  The plan (chunk size, items, grid) is
//     made in one place, the Python wrapper
//     (srsem_torch/ops/fused_head.py::kernel_plan), which keeps it per
//     shape; a call passes it with the taps' pointers, and this file
//     checks it.
//   * The finish is in the same launch and deterministic: each item writes
//     its partials to a scratch buffer, then __threadfence() and a ticket;
//     in the last block to finish, one thread a (pair, stage) sums the
//     stage's partials chunk by chunk (16 loads in flight), divides by H*W
//     and adds b; then one thread a pair sums its stages' scores in stage
//     order, takes the mean and the ReLU and writes the score; the block
//     resets the ticket.  No float atomics: the same inputs give the same
//     bits.
//
// Layouts (what srsem_torch/ops/fused_head.py passes):
//   gt_s : (G, H, W, C) or (G, T, W)      sr_s : (G*K, ...), same dtype,
//          contiguous
//   w    : packed float32 weights, stage s at w_off    b : packed biases
//   part : float32 scratch, pair p's chunk i of stage s at part0 + p*chunks + i
//   out  : (P,) float32

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kVec = 8;                  // elements a thread a step
constexpr int kStep = 2048;              // 256 threads a block
constexpr int kNarrowStep = 1536;        // 192 threads: C = 768 divides it
constexpr int kMinBlocks = 4;            // blocks an SM the grid counts on
constexpr int kMaxStages = 12;
constexpr int kMaxKt = 8;                // SR images an item streams
constexpr int kHeadFields = 10;          // srsem_fused_head's plan layout
constexpr int kStageFields = 10;

constexpr int kF32 = 0, kBf16 = 1, kF16 = 2;

struct Stage {
  const void* gt;
  const void* sr;
  long long per_image;  // H*W*C elements of one image's tap
  long long item0;      // first work item of the stage
  long long part0;      // first partial of the stage
  int c;
  int w_off;   // the stage's first weight in the packed weights
  int bias;    // its index in the packed biases
  int chunk;   // elements a chunk, a multiple of its step
  int chunks;  // chunks an image
  int vstep;   // the launch's step: fixed channels a thread, 16-byte
               // loads; 0: the general path, in steps of kStep
  float hw;    // H*W, or T tokens
};

struct Params {
  Stage st[kMaxStages];
  long long items;
  int stages, g, k, kb, kblocks, per_stage;
  const float* w;
  const float* b;  // null: every stage adds b_const
  float b_const;
  float* part;
  unsigned* ticket;
  float* out;
};

static_assert(sizeof(Params) <= 4096, "kernel parameters are 4 KB at most");

template <int D>
using Elem = std::conditional_t<D == kF32, float, uint16_t>;

// 16 bytes, read-only and not allocated in L1: every byte is read once.
__device__ __forceinline__ uint4 ld_stream(const void* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ float half_bits(uint32_t h, int d) {
  return d == kBf16 ? __uint_as_float(h << 16)
                    : __half2float(__ushort_as_half(static_cast<unsigned short>(h)));
}

// 8 consecutive elements as they came from memory: two 16-byte words of
// float32, one of bf16 or float16.
template <int D>
struct Vec8 {
  static constexpr int kWords = D == kF32 ? 2 : 1;
  uint4 r[kWords];

  __device__ __forceinline__ void load(const Elem<D>* p) {
#pragma unroll
    for (int i = 0; i < kWords; ++i) r[i] = ld_stream(p + 4 * i);
  }
  __device__ __forceinline__ float operator[](int e) const {
    if constexpr (D == kF32) {
      return __uint_as_float(word(r[e >> 2], e & 3));
    } else {
      const uint32_t w = word(r[0], e >> 1);
      return half_bits(e & 1 ? w >> 16 : w & 0xffffu, D);
    }
  }
};

template <int D>
__device__ __forceinline__ float load1(const Elem<D>* p) {
  if constexpr (D == kF32) {
    return __ldg(p);
  } else {
    return half_bits(__ldg(p), D);
  }
}

// U steps of STEP elements on the fixed-channel path: `gt` and `sr` point
// at this thread's first element, SR image j at sr + j * stride.  The GT's U vectors stay
// in registers while the SR images' stream past them, one image's U
// vectors at a time (all K at once would spill at 64 registers).
template <int D, int KT, int U, int STEP>
__device__ __forceinline__ void vec_steps(const Elem<D>* gt,
                                          const Elem<D>* sr, long long stride,
                                          int kn, const float (&wv)[kVec],
                                          float (&acc)[KT]) {
  Vec8<D> g[U];
#pragma unroll
  for (int u = 0; u < U; ++u) g[u].load(gt + u * STEP);
#pragma unroll
  for (int j = 0; j < KT; ++j) {
    if (j < kn) {
      Vec8<D> s[U];
#pragma unroll
      for (int u = 0; u < U; ++u) s[u].load(sr + j * stride + u * STEP);
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const float d = g[u][e] - s[u][e];
          acc[j] = fmaf(d * d, wv[e], acc[j]);
        }
      }
    }
  }
}

// STEP / kVec threads a block: every thread streams a step.
template <int D, int KT, int STEP>
__global__ void __launch_bounds__(STEP / kVec, kMinBlocks)
    fused_head_kernel(const __grid_constant__ Params p) {
  constexpr int kThreads = STEP / kVec, kWarps = kThreads / 32;
  using T = Elem<D>;
  constexpr int U = D == kF32 ? 2 : 4;  // 4 16-byte loads a side in flight
  __shared__ float red[kWarps][KT];
  __shared__ bool last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (long long it = blockIdx.x; it < p.items; it += gridDim.x) {
    int s = 0;
    while (s + 1 < p.stages && it >= p.st[s + 1].item0) ++s;
    const Stage& st = p.st[s];
    const long long local = it - st.item0;
    const int chunk = static_cast<int>(local % st.chunks);
    const long long rest = local / st.chunks;
    const int k0 = static_cast<int>(rest % p.kblocks) * p.kb;
    const long long grp = rest / p.kblocks;
    const int kn = min(p.kb, p.k - k0);
    const long long begin = static_cast<long long>(chunk) * st.chunk;
    const int len = static_cast<int>(
        min(static_cast<long long>(st.chunk), st.per_image - begin));
    const T* gt = static_cast<const T*>(st.gt) + grp * st.per_image + begin;
    const T* sr = static_cast<const T*>(st.sr) +
                  (grp * p.k + k0) * st.per_image + begin;
    const float* w = p.w + st.w_off;

    float acc[KT];
#pragma unroll
    for (int j = 0; j < KT; ++j) acc[j] = 0.f;
    int done = 0;
    if (st.vstep) {
      // begin and every step start at a multiple of STEP, so of C.
      const int c0 = tid * kVec % st.c;
      float wv[kVec];
#pragma unroll
      for (int e = 0; e < kVec; ++e) wv[e] = __ldg(w + c0 + e);
      const int steps = len / STEP;
      const T* g = gt + tid * kVec;
      const T* q = sr + tid * kVec;
      int i = 0;
      for (; i + U <= steps; i += U)
        vec_steps<D, KT, U, STEP>(g + i * STEP, q + i * STEP, st.per_image,
                                  kn, wv, acc);
      for (; i < steps; ++i)
        vec_steps<D, KT, 1, STEP>(g + i * STEP, q + i * STEP, st.per_image,
                                  kn, wv, acc);
      done = steps * STEP;
    }
    for (int e = done + tid; e < len; e += kThreads) {
      const float wc = __ldg(w + static_cast<int>((begin + e) % st.c));
      const float a = load1<D>(gt + e);
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        if (j < kn) {
          const float d = a - load1<D>(sr + j * st.per_image + e);
          acc[j] = fmaf(d * d, wc, acc[j]);
        }
      }
    }

    // The item's partials: a butterfly in each warp, then the warps' sums
    // in order.
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      float v = acc[j];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      if (lane == 0) red[warp][j] = v;
    }
    __syncthreads();
    if (tid < kn) {
      float t = 0.f;
#pragma unroll
      for (int i = 0; i < kWarps; ++i) t += red[i][tid];
      p.part[st.part0 + (grp * p.k + k0 + tid) * st.chunks + chunk] = t;
    }
    __syncthreads();
  }

  // The last block to finish reads every block's partials.
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(p.ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int pairs = p.g * p.k;
  // One thread a (pair, stage): the stage's score from its partials, chunk
  // by chunk, kept in the pair's first partial of the stage.
  for (int c = tid; c < pairs * p.stages; c += kThreads) {
    const Stage& st = p.st[c % p.stages];
    float* part = p.part + st.part0 + static_cast<long long>(c / p.stages) * st.chunks;
    float sum = 0.f;
#pragma unroll 16
    for (int i = 0; i < st.chunks; ++i) sum += __ldcg(part + i);
    part[0] = sum / st.hw + (p.b ? p.b[st.bias] : p.b_const);
  }
  __syncthreads();
  // One thread a pair: the stages' scores in stage order, their mean and
  // the ReLU.
  for (int q = tid; q < pairs; q += kThreads) {
    float total = 0.f;
    for (int s = 0; s < p.stages; ++s)
      total += __ldcg(p.part + p.st[s].part0 + static_cast<long long>(q) * p.st[s].chunks);
    const float mean = total / p.stages;
    // ReLU as torch.relu: a NaN stays NaN.
    p.out[q] = p.per_stage ? total : (mean < 0.f ? 0.f : mean);
  }
  if (tid == 0) *p.ticket = 0u;  // ready for the next launch on this stream
}

template <int D, int KT>
int launch(const Params& p, int step, int grid, cudaStream_t stream) {
  if (step == kNarrowStep)
    fused_head_kernel<D, KT, kNarrowStep>
        <<<grid, kNarrowStep / kVec, 0, stream>>>(p);
  else
    fused_head_kernel<D, KT, kStep><<<grid, kStep / kVec, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_kt(const Params& p, int kt, int step, int grid,
              cudaStream_t stream) {
  switch (kt) {
    case 1: return launch<D, 1>(p, step, grid, stream);
    case 2: return launch<D, 2>(p, step, grid, stream);
    case 4: return launch<D, 4>(p, step, grid, stream);
    case 8: return launch<D, kMaxKt>(p, step, grid, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

}  // namespace

extern "C" {

// Score a batch in one launch on `stream`; returns the cudaError_t of the
// launch (0 = queued) or cudaErrorInvalidValue for a plan the kernel does
// not take.  `plan` holds kHeadFields values, then one row of kStageFields
// a stage in the kernel's stage order:
//   stages, dtype (0 float32, 1 bf16, 2 float16), g, k, kb, kblocks, kt,
//   items, grid, per_stage;
//   per_image, item0, part0, c, w_off, bias, chunk, chunks, vstep, hw
// (as Params and Stage above; kt is 1, 2, 4 or 8 and >= kb, the SR images
// an item streams; kblocks = ceil(k / kb); every nonzero vstep is the
// launch's one step, kStep or kNarrowStep).  `taps` holds each stage's GT
// and SR pointers, in the same order.  `ticket` is one zeroed unsigned that
// only this stream's launches use; the kernel leaves it zero.
int srsem_fused_head(const long long* plan, const void* const* taps,
                     const float* w, const float* b, float b_const,
                     float* part, unsigned* ticket, float* out,
                     void* stream) {
  const auto invalid = static_cast<int>(cudaErrorInvalidValue);
  if (!plan) return invalid;
  const int stages = static_cast<int>(plan[0]), dtype = static_cast<int>(plan[1]),
            g = static_cast<int>(plan[2]), k = static_cast<int>(plan[3]),
            kb = static_cast<int>(plan[4]), kblocks = static_cast<int>(plan[5]),
            kt = static_cast<int>(plan[6]), grid = static_cast<int>(plan[8]),
            per_stage = static_cast<int>(plan[9]);
  const long long items = plan[7];
  if (stages < 1 || stages > kMaxStages || g < 1 || k < 1 || kb < 1 ||
      kb > kt || kt > kMaxKt || kblocks != (k + kb - 1) / kb || items < 1 ||
      grid < 1 || (per_stage && stages != 1) || !taps || !w || !part ||
      !ticket || !out)
    return invalid;
  const int esize = dtype == kF32 ? 4 : 2;
  int step = 0;
  Params p{};
  for (int s = 0; s < stages; ++s) {
    const long long* d = plan + kHeadFields + s * kStageFields;
    Stage& st = p.st[s];
    st.gt = taps[2 * s];
    st.sr = taps[2 * s + 1];
    st.per_image = d[0];
    st.item0 = d[1];
    st.part0 = d[2];
    st.c = static_cast<int>(d[3]);
    st.w_off = static_cast<int>(d[4]);
    st.bias = static_cast<int>(d[5]);
    st.chunk = static_cast<int>(d[6]);
    st.chunks = static_cast<int>(d[7]);
    st.vstep = static_cast<int>(d[8]);
    st.hw = static_cast<float>(d[9]);
    const int unit = st.vstep ? st.vstep : kStep;
    if (!st.gt || !st.sr || st.c < 1 || st.per_image < st.c ||
        st.chunk < unit || st.chunk % unit || st.chunks < 1 ||
        static_cast<long long>(st.chunks) * st.chunk < st.per_image ||
        (s == 0 ? st.item0 != 0 : st.item0 <= p.st[s - 1].item0))
      return invalid;
    if (st.vstep && ((st.vstep != kStep && st.vstep != kNarrowStep) ||
                     (step && st.vstep != step) || st.c % kVec ||
                     st.vstep % st.c || !aligned16(st.gt) ||
                     !aligned16(st.sr) || (st.per_image * esize) % 16))
      return invalid;
    if (st.vstep) step = st.vstep;
  }
  p.items = items;
  p.stages = stages;
  p.g = g;
  p.k = k;
  p.kb = kb;
  p.kblocks = kblocks;
  p.per_stage = per_stage;
  p.w = w;
  p.b = b;
  p.b_const = b_const;
  p.part = part;
  p.ticket = ticket;
  p.out = out;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch_kt<kF32>(p, kt, step, grid, s);
    case kBf16: return launch_kt<kBf16>(p, kt, step, grid, s);
    case kF16: return launch_kt<kF16>(p, kt, step, grid, s);
    default: return invalid;
  }
}

}  // extern "C"
