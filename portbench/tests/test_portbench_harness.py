"""The harness on the CPU: it refuses to measure without a card, and a run
whose timed path is broken underneath comes out not correct.

The fault runs skip the harness's look for a chip (``run_cell`` on the
CPU) and drive the rest of a run at a tiny size, in the configurations'
own precisions (the reference follows a bfloat16 tower's rounding, so a
sound run's numbers sit far under the cells' limits): an answer altered
where it is produced (each scoring cell), and for training a step that
returns its state unchanged, half of the batch left out, the mean taken
over the rest, and a step that goes wrong only after the checked first
steps.  One card, so no exchange between chips to leave out.
"""

import json
import shutil
import subprocess
import sys

import pytest
import torch

from portbench.common.spec import ROOT
from portbench.run import run_cell

SMALL = {"batch": 4, "pool": 8, "check_calls": 2, "check_chunk": 4,
         "warmup_calls": 1, "pool_batches": 4, "profile_calls": 1}


def adjust(cell):
    cell.config["port_config"]["backbone"]["image_size"] = 64
    cell.traffic.update({k: v for k, v in SMALL.items() if k in cell.traffic})


def run(name, seed=2 ** 31 + 11):
    torch.set_num_threads(2)
    with torch.backends.mkldnn.flags(enabled=False):
        return run_cell(name, seed, 0.0, False, "cpu", adjust=adjust)


def no_result(out: str) -> bool:
    return not any(line.startswith("{") for line in out.splitlines())


def test_refuses_without_a_card(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "r50_stages3.pairs_b64", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "",
                          "HOME": str(tmp_path)})
    assert proc.returncode != 0 and no_result(proc.stdout)
    assert "CUDA" in proc.stderr


def test_fails_with_only_the_benchmark(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench")
    proc = subprocess.run(
        [sys.executable, "-c", "import sys; from portbench.run import "
         "run_cell; run_cell('r50_stages3.pairs_b64', 1, 0.0, False, 'cpu')"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and no_result(proc.stdout)
    assert "srsem_torch" in proc.stderr


def altered(fn):
    """``fn`` with its first answer (a score, a map) moved by a tenth."""
    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs).clone()
        out[0] = out[0] * 1.1 + 0.1
        return out
    return wrapper


SCORING = {"r50_stages3.pairs_b64": ("srsem_torch.eval.scorer",
                                     "fused_global_score"),
           "clu_r50clip.maps_b32": ("srsem_torch.models.local_models",
                                    "finish_map")}


@pytest.mark.parametrize("name", sorted(SCORING))
def test_scoring_answer_altered(name, monkeypatch):
    sound = run(name)
    assert sound["correct"], sound["checks"]
    mod, fn = SCORING[name]
    module = __import__(mod, fromlist=[fn])
    monkeypatch.setattr(module, fn, altered(getattr(module, fn)))
    broken = run(name)
    assert not broken["correct"], broken["checks"]


def test_training_sound():
    sound = run("clu_r50clip.train_b80")
    assert sound["correct"], sound["checks"]


def test_training_state_unchanged(monkeypatch):
    import srsem_torch.train.steps as steps

    monkeypatch.setattr(steps, "adam_step",
                        lambda optimizer, loss, mesh=None: loss.detach())
    broken = run("clu_r50clip.train_b80")
    assert not broken["correct"], broken["checks"]


def test_training_half_the_batch(monkeypatch):
    import srsem_torch.train.loop as loop

    whole = loop.batch_to_device

    def half(batch, device, mesh=None):
        return [t[: t.shape[0] // 2] for t in whole(batch, device, mesh)]

    monkeypatch.setattr(loop, "batch_to_device", half)
    broken = run("clu_r50clip.train_b80")
    assert not broken["correct"], broken["checks"]
    print(json.dumps(broken["checks"]))


def test_training_goes_wrong_after_the_checked_steps(monkeypatch):
    """Steps after the first three skip Adam's update: only the step the
    reference follows from the saved state after the window sees it."""
    import srsem_torch.train.steps as steps

    whole, calls = steps.adam_step, []

    def late(optimizer, loss, mesh=None):
        calls.append(1)
        if len(calls) <= 3:
            return whole(optimizer, loss, mesh)
        return loss.detach()

    monkeypatch.setattr(steps, "adam_step", late)
    broken = run("clu_r50clip.train_b80")
    assert not broken["correct"], broken["checks"]
    assert broken["checks"]["change_gap"]["value"] > 0.5
