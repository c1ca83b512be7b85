"""The plain reference against the port's plain modules, float32, on the
CPU at a tiny size: the same raw weights give the same taps, scores,
maps and training steps.  Only this file imports both."""

import numpy as np
import pytest
import torch

from portbench.common.weights import draw
from portbench.reference import heads, layout, towers
from portbench.reference import train as ref_train

SIZE = 64


@pytest.fixture(autouse=True)
def _plain_cpu():
    torch.set_num_threads(2)
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def images(seed, n=2):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, (n, SIZE, SIZE, 3), dtype=np.uint8)
    b = np.clip(a + rng.integers(-40, 41, a.shape), 0, 255).astype(np.uint8)
    return torch.from_numpy(a), torch.from_numpy(b)


def close(got, want, rtol):
    scale = want.abs().max()
    assert float((got - want).abs().max()) <= rtol * float(scale)


def test_imagenet_tower_and_stages_head():
    from srsem_torch.config import BackboneConfig, GlobalModelConfig
    from srsem_torch.models.global_models import make_global_model

    cfg = GlobalModelConfig(backbone=BackboneConfig(
        kind="resnet50", image_size=SIZE, compute_dtype="float32"),
        head="stages_cnn", depth=3)
    sd = draw(layout.imagenet_resnet50()
              + layout.stages_head(layout.STAGE_CHANNELS), 11, "cpu")
    model = make_global_model(cfg)
    model.load_state_dict(sd, strict=True)
    a, b = images(1)
    xa = towers.normalize(a, heads.IMAGENET_MEAN, heads.IMAGENET_STD)
    xb = towers.normalize(b, heads.IMAGENET_MEAN, heads.IMAGENET_STD)
    taps_a = towers.imagenet_taps(xa, sd)
    taps_b = towers.imagenet_taps(xb, sd)
    with torch.no_grad():
        _, port_taps = model.backbone(xa.permute(0, 2, 3, 1))
        for name, t in taps_a.items():
            close(port_taps[name].permute(0, 3, 1, 2), t, 1e-4)
        got = model(xa.permute(0, 2, 3, 1), xb.permute(0, 2, 3, 1))
    want = heads.stages_scores(taps_a, taps_b, sd, heads.stage_taps(3))
    close(got, want, 1e-4)
    assert (want > 0).all()


def clu(seed=12):
    from srsem_torch.config import BackboneConfig, LocalModelConfig
    from srsem_torch.models.local_models import make_local_model

    cfg = LocalModelConfig(backbone=BackboneConfig(
        kind="resnet50_clip", image_size=SIZE, compute_dtype="float32"))
    sd = draw(layout.clip_resnet50(SIZE) + layout.clu_decoder(), seed, "cpu")
    model = make_local_model(cfg)
    model.load_state_dict(sd, strict=True)
    return cfg, sd, model


def test_clip_tower_and_clu_maps():
    _, sd, model = clu()
    a, b = images(2)
    xa = towers.normalize(a, heads.CLIP_MEAN, heads.CLIP_STD)
    xb = towers.normalize(b, heads.CLIP_MEAN, heads.CLIP_STD)
    taps_a, taps_b = towers.clip_taps(xa, sd), towers.clip_taps(xb, sd)
    with torch.no_grad():
        _, port_taps = model.backbone(xa.permute(0, 2, 3, 1))
        for name in heads.CLU_TAPS:
            close(port_taps[name].permute(0, 3, 1, 2), taps_a[name], 1e-4)
        got = model(xa.permute(0, 2, 3, 1), xb.permute(0, 2, 3, 1))
    want = heads.clu_maps(taps_a, taps_b, sd)
    close(got, want, 1e-4)
    assert 0.05 < float(want.mean()) < 0.95


def test_training_steps():
    from srsem_torch.train.loop import batch_to_device, build_training
    from srsem_torch.train.partition import trainable_predicate

    _, sd, model = clu(13)
    rng = np.random.default_rng(3)
    batches = []
    for _ in range(2):
        a = rng.standard_normal((4, SIZE, SIZE, 3)).astype(np.float32)
        b = (a + 0.5 * rng.standard_normal(a.shape)).astype(np.float32)
        y = rng.uniform(0, 1, (4, SIZE, SIZE)).astype(np.float32)
        batches.append((((a, b), y), np.ones((4,), np.float32)))
    steps, opt = build_training(model, True, trainable_predicate(), 1e-3,
                                torch.device("cpu"))
    losses = [float(steps.train_step(*batch_to_device(bt, torch.device("cpu"))))
              for bt in batches]
    dev = []
    with torch.no_grad():
        for (((a, b), y), m) in batches:
            taps = ref_train.tower_taps(torch.as_tensor(a), torch.as_tensor(b),
                                        sd)
            dev.append((taps, torch.as_tensor(y), torch.as_tensor(m)))
    want = ref_train.train_steps(sd, dev, 1e-3)
    # The first step agrees to rounding; Adam's first update is about
    # lr * sign(g), so elements whose gradient is rounding noise move the
    # second step's loss a little.
    assert losses[0] == pytest.approx(want["losses"][0], rel=1e-5)
    assert losses[1] == pytest.approx(want["losses"][1], rel=5e-3)
    # Leaves whose gradient is nought to rounding (a conv bias before a
    # batch-statistic BN) move under Adam by round-off: left out by the
    # harness's rule.
    from portbench.drivers.train import STILL, median_of

    gn = {k: float(g.norm()) for k, g in want["grads"].items()}
    still = STILL * median_of(list(gn.values()))
    state = model.state_dict()
    for k in ref_train.trainable_keys(sd) + ref_train.stat_keys(sd):
        if gn.get(k, 1.0) < still:
            continue
        got = state[k] - sd[k]
        ref = (want["leaves"].get(k, want["stats"].get(k)) - sd[k])
        assert float((got.norm() - ref.norm()).abs()) <= 2e-2 * float(
            ref.norm()), k


def test_bf16_rounding_points_follow_the_fused_tower():
    """In bfloat16 the reference rounds where the port's fused CLIP tower
    does: block by block, from the same input, the same bits but for
    rare last-place flips of a different float32 summation order."""
    from srsem_torch.backbones import fused_resnet as fr

    cfg, sd, model = clu(14)
    model.backbone.dtype = torch.bfloat16
    a, _ = images(4)
    x = towers.normalize(a, heads.CLIP_MEAN, heads.CLIP_STD)
    rd = towers.Rounding(towers.rounder("bfloat16"))
    folded = fr.fold_tower(model.backbone, torch.bfloat16)
    with torch.no_grad():
        h = model.backbone.stem(x.permute(0, 2, 3, 1))
        want = towers.clip_taps(x, sd, rounding=rd)["stem.conv3"]
        assert float((h.float() == want).float().mean()) >= 0.995
        h = torch.nn.functional.avg_pool2d(h, 2)
        for s, blocks in enumerate(folded):
            for b, (kind, w) in enumerate(blocks):
                k = f"backbone.layer{s + 1}.{b}"
                if kind == "fused":
                    got = fr._fused_block(w, h, fr.TILED_STAGE_ROWS.get(s))
                    want = rd.interior_block(h.float(), sd, k)
                else:
                    got = fr._plain_block(w, h)
                    want = rd.first_block(h.float(), sd, k,
                                          2 if s > 0 else 1, pool=True)
                same = (got.float() == want).float().mean()
                assert float(same) >= 0.995, (k, float(same))
                h = got
