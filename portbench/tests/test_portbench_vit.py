"""The ViT regressor's cell on the CPU: its counts against hand counts, the
reference's imports, and a run at a small size that is correct, and not
correct once the head's answer is altered where the scorer produces it.

The runs keep the published widths (768 wide, 12 blocks of 12 heads)
and shrink the images to 64 px (17 tokens) and the traffic to a few
pairs, as test_portbench_harness.py does for the ResNet cells.
"""

import json
import subprocess
import sys
import types

import pytest
import torch

from portbench.common.peaks import bound_s
from portbench.common.spec import ROOT, load_json
from portbench.common.trace import Profile
from portbench.metrics import token_head_roofline
from portbench.models import stages_vit
from portbench.run import run_cell

CELL = "vitb16_stages3.pairs_b64"
VIT = load_json(ROOT / "portbench/configs/vitb16_stages3.json")
SMALL = {"batch": 4, "pool": 8, "check_calls": 2, "check_chunk": 4,
         "warmup_calls": 1, "profile_calls": 1}


def test_vit_b16_image_flops():
    dtype, flops = stages_vit.flops(VIT)["tower"]
    assert dtype == "bfloat16"
    # 196 patches x 768 x 768 x 2 for the patch conv; a block: qkv, proj,
    # fc1 and fc2 over 197 tokens (768 x (2,304 + 768 + 2 x 3,072) x 2
    # each) and two products of 12 heads of 197 x 197 x 64 x 2.
    block = 197 * 768 * (2304 + 768 + 2 * 3072) * 2 + 2 * 12 * 197 ** 2 * 64 * 2
    assert flops == 196 * 768 * 768 * 2 + 12 * block
    assert flops == pytest.approx(35.13e9, rel=1e-3)  # 17.6 GMAC an image


def test_token_head_bound_of_perf_table():
    (work,) = stages_vit.kernel_work(VIT, [64, 64], 64)["fused_head"]
    # Four float32 (197, 768) taps of 128 images, the four heads' weights
    # and biases, 64 scores: bytes-bound.
    assert work[1] == 4 * (4 * 197 * 768 * 128 + 4 * 769 + 64)
    assert bound_s(*work) * 1e3 == pytest.approx(0.0925, abs=1e-4)


def test_token_head_roofline_reads_its_bound():
    work = stages_vit.kernel_work(VIT, [64, 64], 64)
    ctx = types.SimpleNamespace(profile=None, driver=types.SimpleNamespace(
        kernel_work=lambda: work))
    assert token_head_roofline.read(ctx) is None  # untraced: nothing read
    bound = bound_s(*work["fused_head"][0])
    # Two calls whose head kernel took twice its bound each; the GEMM is
    # not the head's time.
    ctx.profile = Profile(calls=2, wall_s=1.0, busy_s=1.0, ops=[
        ("fused_head_tokens_kernel", 0.0, 4 * bound),
        ("nvjet_tst_128x256_h_bz_coopA", 0.0, 1.0)])
    assert token_head_roofline.read(ctx) == pytest.approx(50.0)


def test_tap_names_are_every_third_block():
    assert stages_vit.tap_names(VIT) == (
        "blocks.2.ls2", "blocks.5.ls2", "blocks.8.ls2", "blocks.11.ls2")


def test_the_reference_loads_nothing_of_the_port():
    code = ("import json, sys; import portbench.reference.vit; "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    names = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not names & {"jax", "jaxlib", "flax", "optax", "srsem",
                        "srsem_torch"}


def adjust(cell):
    cell.config["port_config"]["backbone"]["image_size"] = 64
    cell.traffic.update({k: v for k, v in SMALL.items() if k in cell.traffic})


def run():
    torch.set_num_threads(2)
    with torch.backends.mkldnn.flags(enabled=False):
        return run_cell(CELL, 2 ** 31 + 11, 0.0, False, "cpu", adjust=adjust)


def altered(fn):
    """``fn`` with its first score moved by a tenth."""
    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs).clone()
        out[0] = out[0] * 1.1 + 0.1
        return out
    return wrapper


def test_scoring_answer_altered(monkeypatch):
    sound = run()
    assert sound["correct"], sound["checks"]
    import srsem_torch.eval.scorer as scorer

    monkeypatch.setattr(scorer, "fused_global_score",
                        altered(scorer.fused_global_score))
    broken = run()
    assert not broken["correct"], broken["checks"]
    assert broken["checks"]["head_gap"]["value"] > broken["checks"][
        "head_gap"]["limit"]
