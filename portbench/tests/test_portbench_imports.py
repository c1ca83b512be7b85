"""What a run loads: no module whose top-level name (the part before the
first dot, compared whole) is JAX's, Flax's, Optax's or the JAX package's;
and nothing of the port under the reference."""

import json
import subprocess
import sys

from portbench.common.spec import ROOT

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "srsem")

RUN = """
import json, sys, torch
torch.set_num_threads(2)
from portbench.run import run_cell
from portbench.common.spec import benchmark, module
bench = benchmark()
for m in bench["end_to_end"] + bench["per_layer"]:
    module("metrics", m["name"])
def adjust(cell):
    cell.config["port_config"]["backbone"]["image_size"] = 32
    cell.traffic.update(batch=2, pool=4, check_calls=1, check_chunk=2,
                        warmup_calls=1, pool_batches=2, checked_steps=1,
                        profile_calls=1)
for w in bench["workloads"]:
    run_cell(w["name"], 5, 0.0, True, "cpu", adjust=adjust)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

REFERENCE = """
import json, sys
import portbench.reference.heads, portbench.reference.layout
import portbench.reference.lowprec, portbench.reference.towers
import portbench.reference.train
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def top_level_modules(code: str):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_and_no_jax_package():
    names = top_level_modules(RUN)
    assert "srsem_torch" in names and "portbench" in names
    assert not names & set(FORBIDDEN), names & set(FORBIDDEN)


def test_the_reference_loads_nothing_of_the_port():
    names = top_level_modules(REFERENCE)
    assert not names & set(FORBIDDEN + ("srsem_torch",))


def test_the_harness_refuses_what_it_finds():
    from portbench import run

    assert run.FORBIDDEN == FORBIDDEN
    sys.modules["srsem.fake"] = sys.modules[__name__]
    try:
        assert run.forbidden_modules() == ["srsem.fake"]
    finally:
        del sys.modules["srsem.fake"]
