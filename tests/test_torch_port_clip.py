"""Port CLIP ResNet-50 (srsem_torch/backbones/resnet.py, fused_resnet.py)
and image ops (srsem_torch/ops/image.py) vs the JAX package, same weights.

Weights come from a seeded port tower with random frozen-BN statistics and
go to JAX params through srsem/utils/convert.py::convert_clip_resnet50,
which reads the port's OpenAI-CLIP-layout state dict.  f32, 64 px, batch
2; tolerance 1e-4 for the module, 1e-3 for the fused tower (BN folding
changes every conv's summation order; the JAX package's own tolerance,
tests/test_fused_bottleneck.py:350-357) and 1e-5 for the image ops.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsem.backbones.fused_resnet import fused_clip_apply as jax_fused_clip
from srsem.backbones.resnet import ClipResNet50 as JaxClip
from srsem.ops.image import _resize_matrix
from srsem.ops.image import interpolate_pos_embed as jax_pos_embed
from srsem.ops.image import resize_bilinear_mxu
from srsem.utils.convert import convert_clip_resnet50
from srsem_torch.backbones.fused_resnet import fused_apply
from srsem_torch.backbones.resnet import FrozenBatchNorm, make_backbone, reset_tower
from srsem_torch.config import BackboneConfig
from srsem_torch.ops import fused_bottleneck as tfb
from srsem_torch.ops.fused_bottleneck import bottleneck_weights
from srsem_torch.ops.image import (
    interpolate_pos_embed,
    resize_bilinear,
    upsample_x2_align_corners,
)
from srsem_torch.utils.convert import load_clip_resnet50

CFG = BackboneConfig(kind="resnet50_clip", image_size=64, compute_dtype="float32")


def seeded_clip_tower(cfg, seed):
    """A port CLIP tower with seeded weights: small gammas closing each
    residual branch keep activations O(1) through 16 blocks, so the
    tolerances are relative bounds."""
    tower = make_backbone(cfg).requires_grad_(False)
    reset_tower(tower, torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, m in tower.named_modules():
            if isinstance(m, FrozenBatchNorm):
                c = m.weight.shape[0]
                closing = name.endswith(("bn3", "downsample.1")) and "layer" in name
                m.weight.copy_(torch.tensor(rng.uniform(0.1, 0.3, c) if closing
                                            else rng.uniform(0.5, 1.5, c)))
                m.bias.copy_(torch.tensor(rng.uniform(-0.5, 0.5, c)))
                m.running_mean.copy_(torch.tensor(rng.uniform(-0.5, 0.5, c)))
                m.running_var.copy_(torch.tensor(rng.uniform(0.5, 1.5, c)))
    return tower


@pytest.fixture(scope="module")
def towers():
    port = seeded_clip_tower(CFG, 0)
    params = convert_clip_resnet50(port.state_dict())
    x = np.random.default_rng(1).uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    want = JaxClip(dtype=jnp.float32, image_size=64).apply(
        {"params": params}, jnp.asarray(x))
    return port, params, x, want


def test_module_matches_jax(towers):
    port, _, x, (want_emb, want_taps) = towers
    got_emb, got_taps = port(torch.tensor(x))
    assert set(got_taps) == set(want_taps)
    for name, want in want_taps.items():
        assert tuple(got_taps[name].shape) == want.shape
        np.testing.assert_allclose(got_taps[name].numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    assert tuple(got_emb.shape) == (2, 1024)
    np.testing.assert_allclose(got_emb.numpy(), np.asarray(want_emb),
                               rtol=1e-4, atol=1e-4)


def test_fused_tower_matches_jax_fused(towers):
    """fused_apply("resnet50_clip") (kernel wrappers → plain versions on
    the CPU; stage 0 on the tiled wrapper) == JAX fused_clip_apply (Pallas
    in interpret mode, the same stages fused) on every tap."""
    port, params, x, _ = towers
    want_emb, want_taps = jax_fused_clip(params, jnp.asarray(x), jnp.float32,
                                         interpret=True,
                                         fuse_stages=(0, 1, 2, 3))
    before = tfb.fused_bottleneck.launches
    got_emb, got_taps = fused_apply("resnet50_clip", port, torch.tensor(x),
                                    torch.float32)
    assert tfb.fused_bottleneck.launches == before  # CPU: plain versions
    assert set(got_taps) == set(want_taps)
    for name, want in want_taps.items():
        np.testing.assert_allclose(got_taps[name].numpy(), np.asarray(want),
                                   rtol=1e-3, atol=1e-3, err_msg=name)
    np.testing.assert_allclose(got_emb.numpy(), np.asarray(want_emb),
                               rtol=1e-3, atol=1e-3)


def test_bottleneck_weights_take_clip_block(towers):
    """A stride-1 ClipBottleneck goes to the bottleneck kernel as it is."""
    port, _, _, _ = towers
    block = port.layer2[1]
    x = torch.randn(1, 512, 8, 8, generator=torch.Generator().manual_seed(2))
    want = block(x.contiguous(memory_format=torch.channels_last))
    got = tfb.fused_bottleneck(x.permute(0, 2, 3, 1).contiguous(),
                               *bottleneck_weights(block))
    np.testing.assert_allclose(got.permute(0, 3, 1, 2).numpy(), want.numpy(),
                               rtol=1e-4, atol=1e-4)


def test_load_clip_resnet50_takes_a_whole_clip_state_dict(towers):
    port, _, x, _ = towers
    sd = {f"visual.{k}": v for k, v in port.state_dict().items()}
    sd["visual.bn1.num_batches_tracked"] = torch.tensor(0)
    sd["transformer.resblocks.0.attn.in_proj_weight"] = torch.zeros(4, 4)
    fresh = load_clip_resnet50(make_backbone(CFG).requires_grad_(False), sd)
    got, _ = fresh(torch.tensor(x))
    want, _ = port(torch.tensor(x))
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("grid", [(14, 14), (2, 2), (3, 5)])
def test_interpolate_pos_embed_matches_jax(grid):
    """Up-size (7 → 14), down-size (7 → 2, where jax.image.resize
    antialiases) and a non-square grid."""
    pos = np.random.default_rng(3).normal(size=(50, 16)).astype(np.float32)
    want = np.asarray(jax_pos_embed(jnp.asarray(pos), grid))
    got = interpolate_pos_embed(torch.tensor(pos), grid)
    assert tuple(got.shape) == want.shape == (grid[0] * grid[1] + 1, 16)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    got3 = interpolate_pos_embed(torch.tensor(pos)[None], grid)
    np.testing.assert_allclose(got3[0].numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("src,dst,align", [
    ((7, 7), (14, 14), True), ((14, 10), (28, 20), True),
    ((64, 64), (32, 32), False), ((64, 64), (4, 4), False),
    ((9, 6), (13, 17), False)])
def test_resizes_match_jax_matrices(src, dst, align):
    """F.interpolate (no antialias) == JAX's interpolation matrices
    (_resize_matrix) for both corner conventions."""
    x = np.random.default_rng(4).normal(size=(2, *src, 3)).astype(np.float32)
    want = np.asarray(resize_bilinear_mxu(jnp.asarray(x), dst,
                                          align_corners=align))
    got = resize_bilinear(torch.tensor(x), dst, align_corners=align)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    wh = np.asarray(_resize_matrix(dst[0], src[0], align))
    ww = np.asarray(_resize_matrix(dst[1], src[1], align))
    np.testing.assert_allclose(
        got.numpy(), np.einsum("oh,pw,nhwc->nopc", wh, ww, x),
        rtol=1e-5, atol=1e-5)
    if align and dst == (2 * src[0], 2 * src[1]):
        torch.testing.assert_close(upsample_x2_align_corners(torch.tensor(x)),
                                   got)
