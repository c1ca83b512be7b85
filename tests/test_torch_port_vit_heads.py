"""The ViT token heads in the port (srsem_torch/models/global_models.py::
TokenHeadAggregator, the head kernel's token path in
srsem_torch/ops/fused_head.py, the scorers) against the JAX package's
GlobalPairScorer, fused_grouped_token_head and scorers on the same
weights, and a CPU emulation of the head kernel's W = 768 plan.

The tiny ViT of tests/test_models_vit.py (width 96, depth 4, 4 heads,
64 px, float32); the JAX variables are the Flax init with the tower's
leaves moved by a seeded draw and a live head (nonnegative weights, biases
+0.1, so the final ReLU passes every score), carried into the port by
``load_jax_global_params``.  Tolerance 1e-4 (float32, the tower's and the
head's sums in another order); the kernel's emulation against its plain
version 1e-5 (float32 sums of a few thousand terms).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsem.backbones.vit import vit_block_taps as jax_vit_block_taps
from srsem.core.config import BackboneConfig as JaxBackboneConfig
from srsem.core.config import GlobalModelConfig as JaxGlobalConfig
from srsem.core.meshes import create_mesh
from srsem.eval.grouped import GroupedPairScorer as JaxGroupedPairScorer
from srsem.eval.scorer import PairScorer as JaxPairScorer
from srsem.models.global_models import fused_grouped_token_head
from srsem.models.global_models import make_global_model as jax_make_global
from srsem_torch.config import BackboneConfig, GlobalModelConfig
from srsem_torch.eval.grouped import GroupedPairScorer
from srsem_torch.eval.scorer import PairScorer
from srsem_torch.models.global_models import (
    TokenHeadAggregator,
    grouped_token_head,
    make_global_model,
    squared_diffs,
    token_head_from_stats,
)
from srsem_torch.ops import fused_head as tfh
from srsem_torch.utils.convert import jax_head_params, load_jax_global_params
from test_torch_port_head import _emulate
from test_torch_port_train import _two_threads  # noqa: F401 — fixture

SIZE = 64
TINY = dict(vit_width=96, vit_depth=4, vit_heads=4)


def cfgs(head, depth):
    """The port's and JAX's configurations of the tiny ViT scorer."""
    port = GlobalModelConfig(backbone=BackboneConfig(
        kind="vit_clip", image_size=SIZE, compute_dtype="float32", **TINY),
        head=head, depth=depth)
    jax_cfg = JaxGlobalConfig(backbone=JaxBackboneConfig(
        kind="vit_clip", image_size=SIZE, compute_dtype="float32", **TINY),
        head=head, depth=depth)
    return port, jax_cfg


def jax_variables(jax_cfg, seed):
    """JAX GlobalPairScorer variables (numpy): the tower's leaves moved by
    normal(0, 0.05), a live head."""
    model = jax_make_global(jax_cfg)
    z = jnp.zeros((1, SIZE, SIZE, 3))
    params = jax.device_get(
        model.init(jax.random.PRNGKey(seed), z, z)["params"])
    rng = np.random.default_rng(seed)
    backbone = jax.tree.map(
        lambda v: (np.asarray(v) + rng.normal(0, 0.05, v.shape))
        .astype(np.float32), params["backbone"])
    head = {k: {"kernel": np.abs(np.asarray(v["kernel"])) * 0.05,
                "bias": np.asarray(v["bias"]) + 0.1}
            for k, v in params["aggregator"].items()}
    return {"params": {"backbone": backbone, "aggregator": head}}


def images(seed, n):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((2, n, SIZE, SIZE, 3)).astype(np.float32)


HEADS = [("single_lin_vit", 0), ("single_lin_vit", 3), ("stages_vit", 1),
         ("stages_vit", 3), ("wperlay_vit", 1), ("wperlay_vit", 3)]


@pytest.mark.parametrize("head,depth", HEADS,
                         ids=[f"{h}_d{d}" for h, d in HEADS])
def test_vit_heads_match_jax(head, depth):
    """The module's scores, the head kernel's plain path with the packed
    head and the head from token means, against JAX's GlobalPairScorer;
    the JAX head layout both ways."""
    cfg, jcfg = cfgs(head, depth)
    variables = jax_variables(jcfg, 1)
    a, b = images(2, 3)
    want = np.asarray(jax_make_global(jcfg).apply(
        variables, jnp.asarray(a), jnp.asarray(b)))
    assert (want > 0).all()
    model = load_jax_global_params(make_global_model(cfg), variables)
    assert isinstance(model.aggregator, TokenHeadAggregator)
    assert model.tap_names == jax_vit_block_taps(
        depth, total=4, step=3 if head == "stages_vit" else 1)
    ta, tb = torch.tensor(a), torch.tensor(b)
    with torch.no_grad():
        got = model(ta, tb)
        _, taps_a = model.backbone(ta)
        _, taps_b = model.backbone(tb)
        packed = tfh.pack_head(model.aggregator)
        fused = tfh.fused_global_score(taps_a, taps_b, packed, model.tap_names)
        stats = [d.mean(dim=1) for d in squared_diffs(taps_a, taps_b,
                                                      model.tap_names)]
        from_stats = token_head_from_stats(model.aggregator, stats)
    blocks = packed.w.reshape(len(model.tap_names), -1)
    assert torch.equal(blocks[0], blocks[-1]) == (head == "single_lin_vit")
    for out in (got, fused, from_stats):
        np.testing.assert_allclose(out.numpy(), want, rtol=1e-4, atol=1e-4)
    back = jax_head_params(model.aggregator)
    assert set(back) == set(variables["params"]["aggregator"])
    for name, leaves in back.items():
        for leaf, v in leaves.items():
            np.testing.assert_array_equal(
                v, variables["params"]["aggregator"][name][leaf])


@pytest.mark.parametrize("shared", [False, True], ids=["per_layer", "shared"])
@pytest.mark.parametrize("k", [1, 3])
def test_grouped_token_head_matches_jax(shared, k):
    """The plain grouped token head, the kernel's plain grouped path and
    its pack against JAX's fused_grouped_token_head, G = 2, three (G, T, W)
    taps."""
    rng = np.random.default_rng(10 + k)
    g, t, w, names = 2, 17, 96, ["l0", "l1", "l2"]
    taps_g = {n: rng.standard_normal((g, t, w)).astype(np.float32)
              for n in names}
    taps_s = {n: rng.standard_normal((g * k, t, w)).astype(np.float32)
              for n in names}
    head = TokenHeadAggregator(w, len(names), shared=shared)
    head.reset_parameters(torch.Generator().manual_seed(3))
    with torch.no_grad():
        for layer in head.linears():
            layer.weight.abs_()
    params = jax_head_params(head)
    want = np.asarray(fused_grouped_token_head(
        params, {n: jnp.asarray(v) for n, v in taps_g.items()},
        {n: jnp.asarray(v) for n, v in taps_s.items()}, names, shared=shared))
    assert want.shape == (g, k) and (want > 0).all()
    tg = {n: torch.tensor(v) for n, v in taps_g.items()}
    ts = {n: torch.tensor(v) for n, v in taps_s.items()}
    with torch.no_grad():
        outs = [grouped_token_head(head, tg, ts, names),
                tfh.fused_grouped_score(tg, ts, head, names),
                tfh.plain_grouped_score(tg, ts, tfh.pack_head(head), names)]
    for got in outs:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def stages_vit():
    cfg, jcfg = cfgs("stages_vit", 3)
    variables = jax_variables(jcfg, 4)
    return cfg, jcfg, variables, load_jax_global_params(
        make_global_model(cfg), variables)


def _u8(seed, *shape):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def test_pair_scorer_matches_jax(stages_vit):
    """``PairScorer.score_arrays`` (the module tower, the head through
    ``fused_global_score``) against JAX's PairScorer from uint8."""
    cfg, jcfg, variables, model = stages_vit
    a, b = _u8(5, 3, SIZE, SIZE, 3), _u8(6, 3, SIZE, SIZE, 3)
    want = np.asarray(jax.device_get(JaxPairScorer(
        jcfg, variables, mesh=create_mesh(data=1),
        batch_size=3).score_arrays(a, b)))
    scorer = PairScorer(cfg, model, batch_size=3, device="cpu")
    assert scorer.fused_tower is False and scorer.head is not None
    got = scorer.score_arrays(a, b)
    assert got.dtype == torch.float32 and got.shape == (3,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("head,depth", [("stages_vit", 3),
                                        ("single_lin_vit", 2)])
def test_grouped_scorer_matches_jax(head, depth):
    """``GroupedPairScorer.score_arrays`` (two tower passes, one head call)
    against JAX's GroupedPairScorer, G = 2, K = 2."""
    cfg, jcfg = cfgs(head, depth)
    variables = jax_variables(jcfg, 7)
    model = load_jax_global_params(make_global_model(cfg), variables)
    gt = _u8(8, 2, SIZE, SIZE, 3)
    noise = np.random.default_rng(9).integers(-40, 41, (2, 2, SIZE, SIZE, 3))
    sr = np.clip(gt[:, None].astype(int) + noise, 0, 255).astype(np.uint8)
    want = np.asarray(jax.device_get(JaxGroupedPairScorer(
        jcfg, variables, k=2, batch_size=2,
        mesh=create_mesh(data=1)).score_arrays(gt, sr)))
    got = GroupedPairScorer(cfg, model, k=2, batch_size=2,
                            device="cpu").score_arrays(gt, sr)
    assert got.shape == (2, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_fused_tower_refused_for_the_vit(stages_vit):
    """``fused_tower=True`` raises JAX's ValueError (srsem/eval/scorer.py:
    53-57, srsem/eval/grouped.py:160); None resolves to the module."""
    cfg, _, _, model = stages_vit
    msg = "fused_tower needs a ResNet backbone, got 'vit_clip'"
    with pytest.raises(ValueError, match=msg):
        PairScorer(cfg, model, fused_tower=True, device="cpu")
    with pytest.raises(ValueError, match=msg):
        GroupedPairScorer(cfg, model, k=2, fused_tower=True, device="cpu")
    assert PairScorer(cfg, model, device="cpu").fused_tower is False


# ---- the head kernel's token plan ----------------------------------------

# stages_vit's four taps at 224 px, scaled down in batch: (N, 197, 768).
_VIT_TAPS = [(2, 197, 768)] * 4


@pytest.mark.parametrize("shared", [False, True], ids=["per_layer", "shared"])
@pytest.mark.parametrize("k,shapes", [
    (1, _VIT_TAPS),                    # stages_vit pairwise
    (4, _VIT_TAPS),                    # grouped, K = 4
    (1, [(2, 17, 96)] * 3),            # the tiny tower's width
], ids=["w768", "w768_k4", "w96"])
def test_kernel_work_list_on_tokens_matches_plain(shared, k, shapes):
    """The kernel's work list (the test_torch_port_head emulation) over
    (N, T, W) token taps: W = 768 and 96 take the fixed-channel path in
    1536-element steps (192 threads), each thread's channels fixed; the
    shared head is packed once a stage, as a per-stage head."""
    rng = np.random.default_rng(13)
    mk = lambda s: torch.tensor(  # noqa: E731
        np.abs(rng.standard_normal(s)).astype(np.float32))
    stages = [(mk(s), mk((k * s[0], *s[1:]))) for s in shapes]
    names = [f"blocks.{j}.ls2" for j in range(len(shapes))]
    head = TokenHeadAggregator(shapes[0][-1], len(shapes), shared=shared)
    head.reset_parameters(torch.Generator().manual_seed(2))
    packed = tfh.pack_head(head)
    assert packed.offsets == tuple(j * shapes[0][-1]
                                   for j in range(len(shapes)))
    blocks = packed.w.reshape(len(shapes), -1)
    assert torch.equal(blocks[0], blocks[-1]) == shared
    plan = tfh.kernel_plan(stages, sms=132)
    assert all(plan.vec) and set(plan.step) == {1536}
    assert all(c % (4 * 1536) == 0 for c in plan.chunk)
    got = _emulate(stages, k, packed, plan)
    want = tfh.plain_grouped_score(dict(zip(names, (a for a, _ in stages))),
                                   dict(zip(names, (b for _, b in stages))),
                                   packed, names).reshape(-1)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_plan_at_vit_main_path_shapes():
    """At 224 px on 132 SMs: stages_vit's 4 float32 token taps at batch 64
    and wperlay_vit's 12, every stage on the 1536-element fixed-channel
    path; the conv taps' plans are unchanged (2048-element steps), and a
    launch mixing both widths keeps one step, 2048: W = 768 goes to the
    general path there."""
    def sized(shape):
        return torch.zeros(1).as_strided(shape, (0,) * len(shape))

    for n_taps, g, k in ((4, 64, 1), (12, 64, 1), (4, 16, 4)):
        shape = (197, 768)
        stages = [(sized((g, *shape)), sized((g * k, *shape)))] * n_taps
        plan = tfh.kernel_plan(stages, sms=132)
        assert all(plan.vec) and set(plan.step) == {1536}
        assert plan.grid == 528 and plan.items >= plan.grid
        for chunk, chunks in zip(plan.chunk, plan.chunks):
            assert chunk % 6144 == 0
            assert (chunks - 1) * chunk < 197 * 768 <= chunks * chunk
    conv = [(sized((64, 56, 56, 256)), sized((64, 56, 56, 256)))]
    assert tfh.kernel_plan(conv, sms=132).step == (2048,)
    tokens = [(sized((64, 197, 768)), sized((64, 197, 768)))]
    plan = tfh.kernel_plan(conv + tokens, sms=132)
    assert plan.order == (0, 1) and plan.step == (2048, 0)


def test_scorer_packs_the_shared_head_per_stage():
    """single_lin_vit's one Linear packs once a tapped stage, so the kernel
    reads it as any per-stage head."""
    cfg, _ = cfgs("single_lin_vit", 3)
    model = make_global_model(cfg, torch.Generator().manual_seed(0))
    scorer = PairScorer(cfg, model, device="cpu")
    assert scorer.head.channels == (96,) * 4
    assert torch.equal(scorer.head.w, model.aggregator.w_layer[0].weight
                       .reshape(-1).repeat(4))
    assert torch.equal(scorer.head.b, model.aggregator.w_layer[0].bias
                       .reshape(-1).repeat(4))
