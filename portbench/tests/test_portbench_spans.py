"""A ``--trace 1`` run on the CPU, resized as test_portbench_harness.py
does, reads the program's own spans and counters: the host's input and
issue milliseconds a call, from as many root spans as calls profiled,
and the seconds spent building the scorer or training step."""

import math

import pytest
import torch

from portbench.run import run_cell

SMALL = {"batch": 4, "pool": 8, "check_calls": 2, "check_chunk": 4,
         "warmup_calls": 1, "pool_batches": 4, "profile_calls": 2}
READ = ("input_host_ms_per_call", "issue_host_ms_per_call", "construct_s")


def adjust(cell):
    cell.config["port_config"]["backbone"]["image_size"] = 64
    cell.traffic.update({k: v for k, v in SMALL.items() if k in cell.traffic})


@pytest.mark.parametrize("name", ["r50_stages3.pairs_b64",
                                  "clu_r50clip.train_b80"])
def test_traced_run_reads_the_program_spans(name):
    from srsem_torch.utils import profiling

    profiling.reset()
    torch.set_num_threads(2)
    with torch.backends.mkldnn.flags(enabled=False):
        result = run_cell(name, 2 ** 31 + 7, 0.0, True, "cpu", adjust=adjust)
    metrics = result["metrics"]
    for key in READ:
        value = metrics[key]["value"]
        assert math.isfinite(value) and value > 0, (key, value)
    assert metrics["issue_host_ms_per_call"]["unit"] == "ms"
    assert "kernel_load_s" not in metrics  # no kernel loads on the CPU
    root = "srsem.train_step" if "train" in name else "srsem.score"
    spans = profiling.snapshot()["spans"]
    assert sum(s["name"] == root for s in spans) == SMALL["profile_calls"]
