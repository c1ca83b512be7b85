"""The yardstick's counts against hand counts: model FLOPs from the
reference's layers, and the kernels' bounds at PERF.md's shapes, as the
model modules give them."""

import pytest

from portbench.common import kernels
from portbench.common.peaks import bound_s
from portbench.common.spec import ROOT, load_json
from portbench.models import clu_unet, stages_regressor

R50 = load_json(ROOT / "portbench/configs/r50_stages3.json")
CLU = load_json(ROOT / "portbench/configs/clu_r50clip.json")


def test_resnet50_image_flops():
    dtype, flops = stages_regressor.flops(R50)["tower"]
    assert dtype == "bfloat16"
    assert flops == pytest.approx(8.17e9, rel=2e-3)  # 8.2 GFLOP an image


def test_clip_rn50_and_decoder_flops():
    counts = clu_unet.flops(CLU)
    # CLIP's stride-2 blocks run their 3x3 conv before the pool: 10.73.
    assert counts["tower"][1] == pytest.approx(10.73e9, rel=2e-3)
    dtype, decode = counts["pair"]
    assert dtype == "float32"
    # Levels 0-4 at batch 32: 148 + 3 x 473 + 237 GFLOP and the map head.
    assert decode * 32 == pytest.approx(1805.3e9, rel=1e-3)


@pytest.mark.parametrize("lvl,gflop", [(2, 473.5), (1, 473.5), (0, 148.0)])
def test_decoder_levels_at_batch_32(lvl, gflop):
    work = clu_unet.kernel_work(CLU, [32, 32], 32, True)["fused_decoder"]
    ops, _, dtype = work[clu_unet.KERNEL_LEVELS.index(lvl)]
    assert ops / 1e9 == pytest.approx(gflop, rel=1e-3)
    assert dtype == "float32"


def test_training_counts_no_decoder_kernel():
    work = clu_unet.kernel_work(CLU, [160], 80, False)
    assert set(work) == {"fused_bottleneck"} and len(work["fused_bottleneck"]) == 12


@pytest.mark.parametrize("block,ms", [((64, 28, 512, 128), 0.0308),
                                      ((64, 14, 1024, 256), 0.0283),
                                      ((64, 7, 2048, 512), 0.0283),
                                      ((64, 56, 256, 64), 0.0614)])
def test_bottleneck_bounds_of_perf_table(block, ms):
    got = bound_s(*kernels.bottleneck(*block, "bfloat16"))
    assert got * 1e3 == pytest.approx(ms, abs=5e-5)


def test_bottleneck_blocks_of_a_pass():
    work = stages_regressor.kernel_work(R50, [64], 64)["fused_bottleneck"]
    assert len(work) == 12  # 2 + 3 + 5 + 2 stride-1 blocks
    assert work[0] == kernels.bottleneck(64, 56, 256, 64, "bfloat16")
    assert work[-1] == kernels.bottleneck(64, 7, 2048, 512, "bfloat16")


# Pairwise at batch 64, and grouped (G = 16, K = 4).
@pytest.mark.parametrize("passes,ms", [([64, 64], 0.1150), ([16, 64], 0.0719)])
def test_head_bounds_of_perf_table(passes, ms):
    (work,) = stages_regressor.kernel_work(R50, passes, 64)["fused_head"]
    assert bound_s(*work) * 1e3 == pytest.approx(ms, abs=1e-4)
