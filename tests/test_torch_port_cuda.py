"""The port's kernels against their plain PyTorch versions on a CUDA card.

Every test here is marked ``cuda`` and skips without a card.  The file
imports no JAX, so it runs where JAX is not installed, with the repo's
conftest (which pins JAX) left out:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py -q

float32 comparisons run with TF32 off.
"""

import ctypes

import numpy as np
import pytest
import torch

from srsem_torch.ops import _build
from srsem_torch.ops import fused_bottleneck as tfb
from srsem_torch.ops import fused_head as tfh


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m cuda on the H100)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _weights(rng, c, wd, device):
    mk = lambda *s: torch.tensor(  # noqa: E731
        (rng.normal(size=s) / np.sqrt(s[0] if len(s) < 4 else 9 * s[2]))
        .astype(np.float32), device=device)
    return mk(c, wd), mk(wd) * 0.1, mk(3, 3, wd, wd), mk(wd) * 0.1, \
        mk(wd, c), mk(c) * 0.1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(3, 8, 8, 32), (2, 56, 56, 256),
                                   (5, 7, 7, 2048), (2, 9, 11, 40)])
def test_stage_score_kernel_matches_plain(cuda_device, dtype, shape):
    """Triton kernel == plain version (multi-chunk and ragged chunks
    included); float32 sums in another order: 1e-5."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    fa = torch.randn(shape, device=cuda_device, generator=g).to(dtype)
    fb = torch.randn(shape, device=cuda_device, generator=g).to(dtype)
    w = torch.randn(shape[-1], device=cuda_device, generator=g)
    before = tfh.fused_stage_score.launches
    got = tfh.fused_stage_score(fa, fb, w, 0.5)
    assert tfh.fused_stage_score.launches == before + 1
    want = tfh.plain_stage_sums(fa, fb, w) / (shape[1] * shape[2]) + 0.5
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,wd,row_tile", [
    ((2, 16, 16, 64), 16, None), ((2, 16, 16, 64), 16, 5),
    ((2, 56, 56, 256), 64, 8), ((2, 14, 14, 1024), 256, None),
    ((2, 7, 7, 2048), 512, None), ((1, 13, 9, 256), 64, 4),
    ((3, 10, 11, 128), 64, None), ((1, 13, 9, 96), 24, 4),
    ((1, 5, 6, 36), 12, None)])
def test_bottleneck_kernel_matches_plain(cuda_device, dtype, shape, wd,
                                         row_tile):
    """CUDA kernel == plain version.  f32: FP order only (1e-4); bf16: a
    few bf16 ulps where the f32 sums round h1/h2/y apart (2e-2).  bf16 with
    C and wd multiples of 64 takes the tensor cores; other widths (and
    float32) the FMA path."""
    rng = np.random.default_rng(8)
    x = torch.tensor(rng.normal(size=shape).astype(np.float32),
                     device=cuda_device).to(dtype)
    ws = _weights(rng, shape[-1], wd, cuda_device)
    wrapper = tfb.fused_bottleneck_tiled if row_tile else tfb.fused_bottleneck
    kwargs = {"row_tile": row_tile} if row_tile else {}
    before = wrapper.launches
    got = wrapper(x, *ws, **kwargs)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    want = tfb.plain_bottleneck(x, ws, row_tile)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_bottleneck_rejects_noncontiguous_cuda_input(cuda_device):
    rng = np.random.default_rng(9)
    x = torch.zeros(1, 32, 4, 4, device=cuda_device).permute(0, 2, 3, 1)
    with pytest.raises(ValueError, match="contiguous"):
        tfb.fused_bottleneck(x, *_weights(rng, 32, 8, cuda_device))


@pytest.mark.cuda
def test_smem_formula_matches_kernel(cuda_device):
    fn = _build.load("fused_bottleneck").srsem_bottleneck_smem_bytes
    fn.restype = ctypes.c_size_t
    fn.argtypes = [ctypes.c_int] * 4
    for args in [(8, 56, 64, 2), (8, 28, 64, 4), (5, 7, 512, 4), (3, 3, 8, 2)]:
        assert fn(*args) == tfb.bottleneck_smem_bytes(*args)
