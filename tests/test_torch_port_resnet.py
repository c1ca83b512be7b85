"""Port ImageNet ResNet-50 (srsem_torch/backbones/resnet.py, fused_resnet.py)
vs the JAX tower (srsem/backbones/resnet.py), same weights.

Weights come from a seeded port model with random frozen-BN statistics,
go to JAX params through srsem/utils/convert.py (convert_torch_resnet50,
convert_global_head — they read the port's torchvision-layout state dict),
and come back into a fresh port model through ``load_jax_global_params``.
f32, 64 px, batch 2; tolerance 1e-4 for the module (the
tests/test_torch_parity.py bar), 1e-3 for the fused tower (BN folding
changes every conv's summation order; the JAX package's own tolerance,
tests/test_fused_bottleneck.py:350-357).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsem.backbones.resnet import ImageNetResNet50 as JaxResNet50
from srsem.utils.convert import convert_global_head, convert_torch_resnet50
from srsem_torch.backbones.fused_resnet import fused_apply
from srsem_torch.backbones.resnet import FrozenBatchNorm, make_backbone
from srsem_torch.config import BackboneConfig, GlobalModelConfig
from srsem_torch.models.global_models import make_global_model
from srsem_torch.utils.convert import load_jax_global_params, load_torch_resnet50

CFG = GlobalModelConfig(backbone=BackboneConfig(
    kind="resnet50", image_size=64, compute_dtype="float32"), depth=3)


def _jax_variables(seed):
    """JAX GlobalPairScorer variables (numpy) from a seeded port model."""
    model = make_global_model(CFG, torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    for name, m in model.backbone.named_modules():
        if isinstance(m, FrozenBatchNorm):
            c = m.weight.shape[0]
            # Small gammas closing each residual branch keep activations
            # O(1) through 16 blocks, so 1e-4 is a relative bound.
            closing = name.endswith(("bn3", "downsample.1"))
            m.weight.copy_(torch.tensor(rng.uniform(0.1, 0.3, c) if closing
                                        else rng.uniform(0.5, 1.5, c)))
            m.bias.copy_(torch.tensor(rng.uniform(-0.5, 0.5, c)))
            m.running_mean.copy_(torch.tensor(rng.uniform(-0.5, 0.5, c)))
            m.running_var.copy_(torch.tensor(rng.uniform(0.5, 1.5, c)))
    return {"params": {
        "backbone": convert_torch_resnet50(model.backbone.state_dict()),
        **convert_global_head(model.aggregator.state_dict())}}


@pytest.fixture(scope="module")
def towers():
    variables = _jax_variables(0)
    port = load_jax_global_params(make_global_model(CFG), variables)
    x = np.random.default_rng(1).uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    jax_model = JaxResNet50(dtype=jnp.float32)
    want = jax_model.apply({"params": variables["params"]["backbone"]},
                           jnp.asarray(x))
    return variables, port, x, want


def test_module_matches_jax(towers):
    _, port, x, (want_emb, want_taps) = towers
    got_emb, got_taps = port.backbone(torch.tensor(x))
    assert set(got_taps) == set(want_taps)
    for name, want in want_taps.items():
        assert tuple(got_taps[name].shape) == want.shape
        np.testing.assert_allclose(got_taps[name].numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    np.testing.assert_allclose(got_emb.numpy(), np.asarray(want_emb),
                               rtol=1e-4, atol=1e-4)


def test_fused_tower_matches_jax(towers):
    """fused_apply (kernel wrappers → plain versions on CPU; stage 0 on the
    tiled wrapper) == the JAX module on every tap."""
    _, port, x, (want_emb, want_taps) = towers
    got_emb, got_taps = fused_apply("resnet50", port.backbone, torch.tensor(x),
                                    torch.float32)
    assert set(got_taps) == set(want_taps)
    for name, want in want_taps.items():
        np.testing.assert_allclose(got_taps[name].numpy(), np.asarray(want),
                                   rtol=1e-3, atol=1e-3, err_msg=name)
    np.testing.assert_allclose(got_emb.numpy(), np.asarray(want_emb),
                               rtol=1e-3, atol=1e-3)


def test_state_dict_round_trip(towers):
    """JAX params → port → state_dict → convert_torch_resnet50 /
    convert_global_head == the JAX params, exactly."""
    variables, port, _, _ = towers
    back = convert_torch_resnet50(port.backbone.state_dict())
    want = variables["params"]["backbone"]

    def walk(a, b, path=""):
        assert set(a) == set(b), path
        for k in a:
            if isinstance(a[k], dict):
                walk(a[k], b[k], f"{path}/{k}")
            else:
                np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                              err_msg=f"{path}/{k}")

    walk(back, want)
    walk(convert_global_head(port.aggregator.state_dict())["aggregator"],
         variables["params"]["aggregator"])


def test_load_torch_resnet50_drops_classifier(towers):
    """A torchvision state dict (fc head, num_batches_tracked, module.
    prefix) loads into the port's tower."""
    _, port, x, _ = towers
    sd = {f"module.{k}": v for k, v in port.backbone.state_dict().items()}
    sd["module.fc.weight"] = torch.zeros(1000, 2048)
    sd["module.fc.bias"] = torch.zeros(1000)
    sd["module.bn1.num_batches_tracked"] = torch.tensor(0)
    fresh = load_torch_resnet50(make_backbone(CFG.backbone), sd)
    got, _ = fresh(torch.tensor(x))
    want, _ = port.backbone(torch.tensor(x))
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_make_backbone_rejects_unported_kinds():
    """Every kind of the JAX package's is ported (the ViT too); an unknown
    kind raises."""
    with pytest.raises(ValueError, match="unknown backbone kind"):
        make_backbone(BackboneConfig(kind="convnext"))
    vit = make_backbone(BackboneConfig(kind="vit_clip", vit_width=96,
                                       vit_depth=2, vit_heads=4))
    assert type(vit).__name__ == "ClipViT" and len(vit.blocks) == 2
