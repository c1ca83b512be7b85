"""On the card, at each cell's own size with a short window: a sound run
of the program is correct, and each control the cell's limits name (the
plain reference with a part one precision below the configuration's, in
the program's place: ``lower`` an fp8 tower and a TF32 head or decoder,
``head`` a TF32 decoder alone, ``head_bf16`` a head in bfloat16) is not.

    python -m pytest --noconftest -m cuda portbench/tests -q
"""

import pytest
import torch

from portbench.common.spec import Cell, benchmark
from portbench.run import run_cell

CELLS = [w["name"] for w in benchmark()["workloads"]]
CONTROLS = [(name, control) for name in CELLS
            for control in Cell(name).limits["controls"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(card, name):
    result = run_cell(name, 2 ** 31 + 101, 2.0, False, "cuda")
    assert result["correct"], result["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("name,control", CONTROLS)
def test_control_is_not_correct(card, name, control):
    result = run_cell(name, 2 ** 31 + 102, 2.0, False, "cuda",
                      control=control)
    assert not result["correct"], result["checks"]
