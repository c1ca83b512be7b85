"""The port's model axis (srsem_torch/parallel/sharding.py) on four spawned
gloo ranks: tests/test_tensor_parallel.py's check, a global train step on
a ``(data=2, model=2)`` mesh with the tower's convs of 512 or more output
channels sharded over ``model`` against the same step on ``(data=4,
model=1)``, and each against JAX's step on a mesh of the same shape.

ImageNet ResNet-50 tower and stages_cnn head (depth 3), float32 at 64 px,
a batch of 4 of which the last row is padding (at data = 4 one rank holds
only that row).  The sharded tower runs as its module; the replicated one
through the fused tower's plain version.  Tolerances: the two port meshes
within rtol 1e-5 of each other; each against JAX as
tests/test_torch_port_train.py holds a step (loss rtol 3e-3, the head
within 2·lr).
"""

import jax
import numpy as np
import optax
import pytest
import torch

import torch_mesh_ranks as ranks
from srsem.core.config import BackboneConfig as JaxBackboneConfig
from srsem.core.config import GlobalModelConfig as JaxGlobalConfig
from srsem.core.meshes import batch_sharding, replicated_sharding
from srsem.models.global_models import make_global_model as jax_make_global
from srsem.parallel.sharding import param_shardings as jax_param_shardings
from srsem.train.partition import partition_params
from srsem.train.partition import trainable_predicate as jax_predicate
from srsem.train.steps import build_step_fns as jax_build_step_fns
from srsem.utils.convert import convert_global_head, convert_torch_resnet50
from test_torch_port_mesh import jax_mesh, live_head, randomize_bn
from test_torch_port_train import (  # noqa: F401 — fixtures
    _batches,
    _close,
    _reference_cpu_convs,
    _two_threads,
)

SIZE, LR = ranks.SIZE, ranks.LR
CFG = ranks.GlobalModelConfig(backbone=ranks.IMAGENET, head="stages_cnn",
                              depth=3)
JAX_CFG = JaxGlobalConfig(backbone=JaxBackboneConfig(
    kind="resnet50", image_size=SIZE, compute_dtype="float32"),
    head="stages_cnn", depth=3)
MESHES = [(2, 2), (4, 1)]


@pytest.fixture(scope="module")
def stepped():
    model = ranks.make_global_model(CFG, torch.Generator().manual_seed(2))
    randomize_bn(model.backbone, 2)
    live_head(model.aggregator)
    ((a, b), y), mask = _batches(12, [3], (), 4)[0]
    payload = {"global": model.state_dict(), "cfg": CFG, "meshes": MESHES,
               "batch": (a, b, y, mask)}
    variables = {"params": {
        "backbone": convert_torch_resnet50(model.backbone.state_dict()),
        "aggregator": convert_global_head(
            model.aggregator.state_dict())["aggregator"]}}
    return payload, variables, ranks.spawn(4, "tensor_parallel", payload)


def _jax_step(variables, batch, shape):
    """JAX's train step with the frozen tower's large kernels sharded over
    ``model`` (tests/test_tensor_parallel.py::_run_step)."""
    mesh = jax_mesh(*shape)
    trainable, frozen = partition_params(variables["params"],
                                         jax_predicate())
    tx = optax.adam(LR)
    opt_state = tx.init(trainable)
    steps = jax_build_step_fns(jax_make_global(JAX_CFG), tx, mesh)
    repl, data = replicated_sharding(mesh), batch_sharding(mesh)
    a, b, y, mask = (jax.device_put(x, data) for x in batch)
    new_trainable, _, _, loss = steps.train_step(
        jax.device_put(trainable, repl), jax.device_put(opt_state, repl),
        jax.device_put(frozen, jax_param_shardings(mesh, frozen,
                                                   min_shard_dim=512)),
        {}, (a, b), y, mask)
    return float(loss), jax.device_get(new_trainable)


def test_model_axis_step_equals_data_axis_step(stepped):
    """(data=2, model=2) with a sharded tower == (data=4, model=1): the
    same loss and head on every rank."""
    _, _, on_ranks = stepped
    want = on_ranks[0][(4, 1)]
    assert not want["sharded"]
    for got in on_ranks:
        assert got[(2, 2)]["sharded"]
        for shape in MESHES:
            np.testing.assert_allclose(got[shape]["loss"], want["loss"],
                                       rtol=1e-5)
            _close(got[shape]["trainable"], want["trainable"], 1e-5,
                   2 * LR, f"head {shape}")
    assert np.isfinite(want["loss"]) and want["loss"] > 0


@pytest.mark.parametrize("shape", MESHES, ids=["data2-model2",
                                               "data4-model1"])
def test_model_axis_step_matches_jax(stepped, shape):
    """Each port mesh against JAX's step on a mesh of the same shape."""
    payload, variables, on_ranks = stepped
    loss, trainable = _jax_step(variables, payload["batch"], shape)
    got = on_ranks[0][shape]
    np.testing.assert_allclose(got["loss"], loss, rtol=3e-3, atol=1e-5)
    _close(got["trainable"], trainable, 1e-3, 2 * LR, f"head {shape}")
