"""The port's ViT regressor against the benchmark's plain reference
(portbench/reference/vit.py, plain torch, nothing of the port): seeded
weights drawn from the benchmark's layout (portbench/models/stages_vit.py)
at a tiny width but all 12 blocks, so that stages_vit taps blocks 2, 5, 8
and 11, through ``PairScorer.score_arrays`` and the scorer's tower, on the
CPU.

In float32 the two compute the same sums in another order.  With a
bfloat16 tower the reference rounds where the port's tower stores
bfloat16; two such towers still part by a last place here and there (the
library rounds a bias add once on the CPU where the card's conv rounds it
twice, and sums run in another order), and each part grows through the
blocks' LayerNorms and softmaxes, so the bfloat16 tolerances come from
readings.  The fp8 control (the reference's ``lower``: each Linear's and
the patch conv's input and weight in e4m3) must fail them.
"""

import numpy as np
import pytest
import torch

from portbench.common.weights import draw
from portbench.models import stages_vit
from srsem_torch.eval.scorer import PairScorer
from torch_port_tmp import remove_tmp_path  # noqa: F401 — autouse fixture

#: Float32 on both sides: max |port - reference| over max |reference|.
#: Readings 1.1e-7 (scores) and 8.8e-7 (taps) at 224 px, 9.3e-8 and 6.7e-7
#: at 64 px; the sums' order alone.
F32_RTOL = 1e-5
#: bfloat16 tower: the worst tap's mean |gap| over its mean |value|, as the
#: benchmark's ``tower_gap``.  Readings over seeds 1-4: 0.63-0.72% at
#: 224 px, 0.68-0.90% at 64 px; the fp8 control reads 9.3-11.5%.
BF16_TAP_GAP = 0.03
#: bfloat16 tower: the widest score gap over the median score, as the
#: benchmark's ``score_gap``.  Readings 3.0e-4-3.2e-3 at 224 px,
#: 5.2e-3-1.04e-2 at 64 px; the fp8 control 0.20-0.43.
BF16_SCORE_GAP = 0.05


@pytest.fixture(autouse=True)
def _plain_cpu():
    """Two threads a worker, and the CPU's plain kernels (not oneDNN's)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    with torch.backends.mkldnn.flags(enabled=False):
        yield
    torch.set_num_threads(n)


def tiny(size: int, dtype: str) -> dict:
    """The cell's configuration at 64 wide with 4 heads, all 12 blocks."""
    return {"port_config": {"backbone": {
        "kind": "vit_clip", "image_size": size, "compute_dtype": dtype,
        "vit_width": 64, "vit_heads": 4}, "head": "stages_vit", "depth": 3}}


def readings(size: int, dtype: str, control=None, seed: int = 1):
    """The port's and the reference's taps of the GT images and scores of
    two (GT, SR) pairs on the same raw weights."""
    cfg = tiny(size, dtype)
    sd = draw(stages_vit.raw_layout(cfg), seed, "cpu")
    pcfg, model = stages_vit.build(cfg, sd, "cpu")
    scorer = PairScorer(pcfg, model, batch_size=2, device="cpu")
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, (2, size, size, 3), dtype=np.uint8)
    b = np.clip(a + rng.integers(-20, 21, a.shape), 0, 255).astype(np.uint8)
    ref = stages_vit.Reference(cfg, sd, control=control)
    with torch.no_grad():
        got = scorer.score_arrays(a, b)
        taps = scorer.tower(scorer.normalize(a))[1]
        want_a = ref.taps(torch.from_numpy(a))
        want = ref.head(want_a, ref.taps(torch.from_numpy(b)))
    assert sorted(want_a) == sorted(stages_vit.tap_names(cfg))
    return got, want, {k: taps[k] for k in want_a}, want_a


def rel_max(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("size", [224, 64], ids=["224px", "64px_resized"])
def test_float32_matches_the_reference(size):
    got, want, taps, want_taps = readings(size, "float32")
    assert rel_max(got, want) <= F32_RTOL
    for k, t in want_taps.items():
        assert taps[k].dtype == torch.float32 and taps[k].shape == t.shape
        assert rel_max(taps[k], t) <= F32_RTOL, k
    assert (want > 1.01).all()  # the squared-diff term carries each score


@pytest.mark.parametrize("size,control", [(224, None), (64, None),
                                          (224, "lower")],
                         ids=["224px", "64px_resized", "fp8_control_fails"])
def test_bfloat16_tower_at_the_reference_rounding_points(size, control):
    got, want, taps, want_taps = readings(size, "bfloat16", control)
    tap_gap = max(float((taps[k] - t).abs().mean() / t.abs().mean())
                  for k, t in want_taps.items())
    score_gap = float((got - want).abs().max() / want.abs().median())
    if control is None:
        assert tap_gap <= BF16_TAP_GAP and score_gap <= BF16_SCORE_GAP
    else:
        assert tap_gap > BF16_TAP_GAP and score_gap > BF16_SCORE_GAP
