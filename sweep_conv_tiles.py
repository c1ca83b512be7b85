#!/usr/bin/env python3
"""Time each of the fused bottleneck's three convs alone on one CUDA card,
at every N tile and ring depth the shared conv kernel takes.

    python3 sweep_conv_tiles.py          # from the root of a checkout

For each main-path bottleneck shape (224 px, batch 64 and 32, stages 0-3)
and each conv (1: x -> h1, 1x1 over flat tiles; 2: h1 -> h2, 3x3 over
patches; 3: h2 -> y, 1x1 over flat tiles plus the residual x) it prints
one JSON line: the N tile the kernel's plan picks (``plan_nt``) and the
device microseconds of one launch (CUDA events, 30 launches after 3) for
each ``nt<NT>_s<stages>`` the kernel takes.  A tiling it refuses (too
little shared memory; without a residual, fewer stages than NT / 64) is
left out.  The harness is a small library that launches one conv of
srsem_torch/csrc/conv_wgmma.cuh with a given tiling, built into
build/sweep_conv_tiles/ (git-ignored).  It needs nvcc and a card.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent

HARNESS = r"""
#include "conv_wgmma.cuh"
namespace {
using namespace conv;
template <int NT>
__global__ void __launch_bounds__(kTcThreads, NT == 256 ? 1 : 2)
    sweep_conv_wgmma(const __grid_constant__ CUtensorMap in0,
                     const __grid_constant__ CUtensorMap in1,
                     const __grid_constant__ CUtensorMap wmap,
                     const __grid_constant__ CUtensorMap rmap,
                     const __grid_constant__ CUtensorMap omap,
                     const TcArgs p) {
  conv_wgmma<NT, false>(&in0, &in1, &wmap, &rmap, &omap, p);
}
template <typename T>
__global__ void __launch_bounds__(kThreads) sweep_conv_fma(const FmaArgs<T> p) {
  conv_fma<T>(p);
}
struct Kernels {
  static constexpr bool kHead = false;
  template <int NT, bool HEAD> static auto tc() { return sweep_conv_wgmma<NT>; }
  template <typename T> static auto fma() { return sweep_conv_fma<T>; }
};
}  // namespace
extern "C" int sweep_conv(const void* x, int c0, int ks, const void* wt,
                          const float* bias, int cout, const void* res,
                          void* out, int n, int h, int w, int nt, int stages,
                          void* stream) {
  const Conv c{x, c0, nullptr, 0, ks, wt, bias, cout, res, out,
               nullptr, nullptr, 0};
  const Tiling t{ks == 1, pick_patch(h, w), nt, stages};
  return launch_tc<Kernels>(c, n, h, w, t, static_cast<cudaStream_t>(stream));
}
"""


def build():
    from srsem_torch.ops import _build

    out = _build.BUILD_DIR.parent / "sweep_conv_tiles"
    out.mkdir(parents=True, exist_ok=True)
    src, lib = out / "sweep_conv.cu", out / "sweep_conv.so"
    src.write_text(HARNESS)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
                    "-o", str(lib), str(src)], check=True)
    fn = ctypes.CDLL(str(lib)).sweep_conv
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    return fn


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("sweep_conv_tiles: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from srsem_torch.ops import fused_bottleneck as fb

    sweep = build()
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def us(fn, reps=30):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps * 1e3

    print(json.dumps({"card": torch.cuda.get_device_name(0)}), flush=True)
    for n in (64, 32):
        for stage, hw in enumerate((56, 28, 14, 7)):
            c, wd = 256 * 2 ** stage, 64 * 2 ** stage
            x = torch.randn(n, hw, hw, c, device=dev).bfloat16()
            h1 = torch.randn(n, hw, hw, wd, device=dev).bfloat16()
            plan = fb.kernel_plan(x, wd)
            convs = [(x, c, 1, wd, None), (h1, wd, 3, wd, None),
                     (h1, wd, 1, c, x)]
            for i, (inp, cin, ks, cout, res) in enumerate(convs):
                wt = (torch.randn(cout, ks * ks * cin, device=dev)
                      * cin ** -0.5).bfloat16()
                bias = torch.zeros(cout, device=dev)
                out = torch.empty(n, hw, hw, cout, device=dev,
                                  dtype=torch.bfloat16)
                row = {"batch": n, "stage": stage, "conv": i + 1,
                       "plan_nt": plan.nts[i]}
                for nt in (64, 128, 256):
                    for stages in (2, 3, 4):
                        def call(nt=nt, stages=stages):
                            return sweep(
                                inp.data_ptr(), cin, ks, wt.data_ptr(),
                                bias.data_ptr(), cout,
                                None if res is None else res.data_ptr(),
                                out.data_ptr(), n, hw, hw, nt, stages, stream)
                        if cout % nt == 0 and call() == 0:
                            row[f"nt{nt}_s{stages}"] = us(call)
                print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
