"""The port's CLIP ViT tower (srsem_torch/backbones/vit.py) against the JAX
package's (srsem/backbones/vit.py) on the same weights, and the ViT weight
converters both ways (srsem_torch/utils/convert.py against
srsem/utils/convert.py).

The tiny tower of tests/test_models_vit.py (width 96, depth 4, 4 heads,
16 px patches, float32) with the global scorer's 14x14 positional table,
so the table is interpolated at 64 px (4x4 patches) and at 96 px (6x6).
The JAX tree is the Flax init with every leaf moved by a seeded normal
draw (so no bias is zero and no LayerNorm the identity), carried into the
port by ``jax_vit_state_dict``.  Tolerance 1e-4 (float32 through four
blocks, sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsem.backbones.vit import ClipViT as JaxClipViT
from srsem.backbones.vit import vit_block_taps as jax_vit_block_taps
from srsem.utils import convert as jcv
from srsem_torch.backbones.vit import ClipViT, vit_block_taps
from srsem_torch.train.partition import flatten_dict
from srsem_torch.utils.convert import (
    jax_tower_params,
    jax_vit_state_dict,
    load_backbone_params,
)
from test_torch_port_train import _two_threads  # noqa: F401 — fixture

TINY = dict(patch=16, width=96, depth=4, heads=4)


def jax_vit_params(seed: int, size: int = 64, **kw):
    """A tiny JAX ClipViT's params, every leaf moved by normal(0, 0.05),
    as float32 numpy."""
    model = JaxClipViT(dtype=jnp.float32, **TINY, **kw)
    params = model.init(jax.random.PRNGKey(seed),
                        jnp.zeros((1, size, size, 3)))["params"]
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda v: (np.asarray(v) + rng.normal(0, 0.05, v.shape))
        .astype(np.float32), jax.device_get(params))


def port_vit(params, **kw) -> ClipViT:
    vit = ClipViT(dtype=torch.float32, **TINY, **kw)
    vit.load_state_dict(jax_vit_state_dict(params), strict=True)
    return vit.eval()


def images(seed: int, n: int, size: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (n, size, size, 3)).astype(np.float32)


def _compare(jax_out, port_out):
    (jemb, jtaps), (pemb, ptaps) = jax_out, port_out
    np.testing.assert_allclose(pemb.detach().numpy(), np.asarray(jemb),
                               rtol=1e-4, atol=1e-4)
    assert set(ptaps) == set(jtaps)
    for name, want in jtaps.items():
        got = ptaps[name]
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("size,kw", [
    (64, {}),                                   # 14x14 table → 4x4 grid
    (96, {}),                                   # → 6x6
    (64, {"use_norm_pre": False, "ln_eps": 1e-6}),  # ALBEF's DeiT tower
], ids=["64px", "96px", "no_norm_pre"])
def test_vit_embedding_and_taps_match_jax(size, kw):
    params = jax_vit_params(0, **kw)
    x = images(1, 2, size)
    want = JaxClipViT(dtype=jnp.float32, **TINY, **kw).apply(
        {"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = port_vit(params, **kw)(torch.tensor(x))
    assert got[1]["blocks.3.ls2"].shape == (2, 1 + (size // 16) ** 2, 96)
    _compare(want, got)


def test_vit_block_taps_match_jax():
    for depth, total, step in ((3, 12, 3), (11, 12, 1), (0, 12, 1),
                               (2, 4, 1), (1, 4, 3), (5, 4, 1)):
        assert vit_block_taps(depth, total, step) == jax_vit_block_taps(
            depth, total, step)


def _timm_state_dict(seed: int):
    """A timm ``vit_base_patch16_clip_224``-layout state dict of the tiny
    tower, with the keys timm has beside the tower (a classifier head,
    LayerScale's identity gammas), which the loaders drop."""
    vit = ClipViT(dtype=torch.float32, **TINY)
    vit.load_state_dict(jax_vit_state_dict(jax_vit_params(seed)))
    sd = {k: v.clone() for k, v in vit.state_dict().items()}
    sd["head.weight"] = torch.zeros(10, 96)
    sd["blocks.0.ls2.gamma"] = torch.ones(96)
    return sd


def _hf_state_dict(seed: int):
    """An HF ``CLIPVisionModel`` state dict of the tiny tower (separate
    q/k/v, no patch bias, ``pre_layrnorm``), seeded numpy weights."""
    rng = np.random.default_rng(seed)
    t = lambda *s: torch.tensor(  # noqa: E731
        rng.normal(0, 0.05, s).astype(np.float32))
    w, p = 96, "vision_model."
    sd = {f"{p}embeddings.patch_embedding.weight": t(w, 3, 16, 16),
          f"{p}embeddings.class_embedding": t(w),
          f"{p}embeddings.position_embedding.weight": t(197, w),
          f"{p}pre_layrnorm.weight": 1 + t(w), f"{p}pre_layrnorm.bias": t(w),
          f"{p}post_layernorm.weight": 1 + t(w),
          f"{p}post_layernorm.bias": t(w)}
    for l in range(4):
        q = f"{p}encoder.layers.{l}."
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd[f"{q}self_attn.{proj}.weight"] = t(w, w)
            sd[f"{q}self_attn.{proj}.bias"] = t(w)
        for ln in ("layer_norm1", "layer_norm2"):
            sd[f"{q}{ln}.weight"] = 1 + t(w)
            sd[f"{q}{ln}.bias"] = t(w)
        sd[f"{q}mlp.fc1.weight"], sd[f"{q}mlp.fc1.bias"] = t(4 * w, w), t(4 * w)
        sd[f"{q}mlp.fc2.weight"], sd[f"{q}mlp.fc2.bias"] = t(w, 4 * w), t(w)
    return sd


@pytest.mark.parametrize("layout", ["timm", "hf"])
def test_state_dicts_load_as_jax_converts_them(layout):
    """A timm or an HF state dict loaded into the port's tower gives JAX's
    outputs from ``convert_clip_vit`` / ``convert_hf_clip_vit``."""
    sd = _timm_state_dict(2) if layout == "timm" else _hf_state_dict(3)
    jparams = (jcv.convert_clip_vit(sd) if layout == "timm"
               else jcv.convert_hf_clip_vit(sd))
    vit = ClipViT(dtype=torch.float32, **TINY)
    load_backbone_params(vit, "vit_clip", sd)
    x = images(4, 2, 64)
    want = JaxClipViT(dtype=jnp.float32, **TINY).apply(
        {"params": jparams}, jnp.asarray(x))
    with torch.no_grad():
        got = vit(torch.tensor(x))
    _compare(want, got)


def test_jax_tree_round_trip_is_bit_equal():
    """JAX tree → port tower → JAX tree (``jax_tower_params``, the
    checkpoint writer's path) bit for bit; JAX's own ``convert_clip_vit``
    reads the port's ``state_dict()`` back to the same tree; a JAX tree
    loads through ``load_backbone_params`` too."""
    params = jax_vit_params(5)
    vit = port_vit(params)
    keys = [k for k, _ in vit.named_parameters()]
    back = jax_tower_params(vit, keys, lambda p: p)
    again = jcv.convert_clip_vit(vit.state_dict())
    want = flatten_dict(params)
    for tree in (back, again):
        flat = flatten_dict(tree)
        assert set(flat) == set(want)
        for key, v in want.items():
            np.testing.assert_array_equal(np.asarray(flat[key]), v,
                                          err_msg=str(key))
    other = ClipViT(dtype=torch.float32, **TINY)
    load_backbone_params(other, "vit_clip", params)
    for k, v in other.state_dict().items():
        assert torch.equal(v, vit.state_dict()[k]), k


def test_vit_bf16_runs_and_keeps_float32_taps():
    """In bf16 the stream after norm_pre and the taps stay float32, as in
    JAX; the scores' neighbourhood of the float32 tower (bf16 matmuls)."""
    params = jax_vit_params(6)
    vit = ClipViT(dtype=torch.bfloat16, **TINY)
    vit.load_state_dict(jax_vit_state_dict(params))
    x = torch.tensor(images(7, 2, 64))
    with torch.no_grad():
        emb, taps = vit(x)
        emb32, taps32 = port_vit(params)(x)
    assert emb.dtype == torch.float32
    assert all(t.dtype == torch.float32 for t in taps.values())
    want = JaxClipViT(dtype=jnp.bfloat16, **TINY).apply(
        {"params": params}, jnp.asarray(x.numpy()))
    for name, t in taps.items():
        assert np.asarray(want[1][name]).dtype == np.float32
        scale = float(taps32[name].abs().max())
        assert float((t - taps32[name]).abs().max()) < 0.1 * scale, name
