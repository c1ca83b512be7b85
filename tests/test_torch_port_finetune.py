"""Tower training in the port (srsem_torch/train/{steps,loop}.py: LoRA and
the full fine-tune of a CluUnet, ``enc_ft`` of a global regressor) against
the JAX package's train step (srsem/train/steps.py) from the same variables
on the same batch.

The JAX model is initialised with a seeded ``PRNGKey``; its tower gets
random BatchNorm statistics (and random ``lora_a`` factors, zero at init),
and the variables go into the port with ``load_jax_*_params``.  One Adam
step each, float32 at 64 px, the CLU decoder at width 1/8: the loss within
rtol 1e-5, every trained leaf (the tower's included) within 2·lr absolute,
as tests/test_torch_port_train_cli.py holds Adam's first step (Adam turns a
near-zero gradient's sign noise into a full ±lr step), and Adam's moments
after the step leaf by leaf relative to each leaf's scale
(tests/test_torch_port_train.py::_moments_close).  A first Adam step moves
each leaf by at most lr whatever its gradient, so the moments (``mu`` is
0.1·g, ``nu`` 0.001·g²) are what hold the gradient through the LoRA
factors, the checkpointed tower and the BN statistics to JAX's.  The port's
oneDNN convolutions are off, as in tests/test_torch_port_train.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from srsem.core.config import BackboneConfig as JaxBackboneConfig
from srsem.core.config import GlobalModelConfig as JaxGlobalConfig
from srsem.models.global_models import make_global_model as jax_make_global
from srsem.models.local_models import CluUnet as JaxCluUnet
from srsem.train.partition import partition_params as jax_partition
from srsem.train.partition import trainable_predicate as jax_predicate
from srsem.train.steps import build_step_fns as jax_build_step_fns
from srsem_torch.config import BackboneConfig, GlobalModelConfig
from srsem_torch.config import LocalModelConfig
from srsem_torch.models.global_models import make_global_model
from srsem_torch.models.local_models import make_local_model
from srsem_torch.train.loop import build_training
from srsem_torch.train.partition import flatten_dict, trainable_predicate
from srsem_torch.utils.convert import (
    jax_adam_state,
    jax_trainable_params,
    load_jax_global_params,
    load_jax_local_params,
)
from test_torch_port_lora import _live_lora
from test_torch_port_train import (  # noqa: F401 — fixture
    _batches,
    _mesh1,
    _moments_close,
    _reference_cpu_convs,
    _two_threads,
    _variables,
)

SIZE, LR, RANK, WM = 64, 1e-4, 4, 0.125


def _jax_step(jmodel, variables, predicate, is_map, batch):
    """One JAX train step: ``(loss, trainable after the step, Adam's
    state)``."""
    trainable, frozen = jax_partition(variables["params"], predicate)
    tx = optax.adam(LR)
    steps = jax_build_step_fns(jmodel, tx, _mesh1(), is_map_model=is_map)
    ((a, b), y), mask = batch
    new, opt_state, _, loss = steps.train_step(
        trainable, tx.init(trainable), frozen,
        variables.get("batch_stats", {}), (a, b), y, mask)
    return float(loss), jax.device_get(new), jax.device_get(opt_state)


def _port_step(pmodel, predicate, is_map, batch):
    steps, opt = build_training(pmodel, is_map, predicate, LR,
                                torch.device("cpu"))
    ((a, b), y), mask = batch
    loss = steps.train_step(*(torch.from_numpy(np.asarray(v))
                              for v in (a, b, y, mask)))
    return (float(loss), jax_trainable_params(pmodel)[0],
            jax_adam_state(pmodel, opt))


def _check(port, jax_out, init, what):
    (lp, tp, sp), (lj, tj, sj) = port, jax_out
    np.testing.assert_allclose(lp, lj, rtol=1e-5, err_msg=f"{what} loss")
    _moments_close(sp, sj)
    fp, fj, f0 = flatten_dict(tp), flatten_dict(tj), flatten_dict(init)
    assert set(fp) == set(fj), what
    for key, want in fj.items():
        np.testing.assert_allclose(fp[key], np.asarray(want), rtol=0,
                                   atol=2 * LR, err_msg=f"{what} {key}")
    return fp, fj, f0


@pytest.mark.parametrize("rank", [RANK, "full"], ids=["lora", "full"])
def test_clu_tower_training_step_matches_jax(rank):
    """One step of a CluUnet with LoRA factors on every tower conv, or with
    the whole tower trained under activation checkpointing (JAX:
    ``nn.remat``): the loss, the decoder and the tower's trained leaves.
    LoRA moves the factors only; the full fine-tune moves the tower's BN
    running means and variances too, as JAX's Adam does."""
    kind = "resnet50_clip" if rank == RANK else "resnet50"
    jmodel = JaxCluUnet(backbone_kind=kind, image_size=SIZE,
                        compute_dtype=jnp.float32, lora_rank=rank,
                        width_mult=WM)
    variables = _variables(jmodel, 5, (False,))
    rng = np.random.default_rng(5)
    if rank == RANK:
        variables["params"]["backbone"] = _live_lora(
            variables["params"]["backbone"], rng)
    pred_kw = dict(lora=rank == RANK, full_finetune=rank == "full")
    batch = _batches(6, [2], (SIZE, SIZE))[0]
    pmodel = make_local_model(LocalModelConfig(
        backbone=BackboneConfig(kind=kind, image_size=SIZE,
                                compute_dtype="float32"), lora_rank=rank),
        width_mult=WM)
    load_jax_local_params(pmodel, variables)
    init, _ = jax_partition(variables["params"], jax_predicate(**pred_kw))
    jax_out = _jax_step(jmodel, variables, jax_predicate(**pred_kw), True,
                        batch)
    port = _port_step(pmodel, trainable_predicate(**pred_kw), True, batch)
    fp, fj, f0 = _check(port, jax_out, init, str(rank))
    tower = [k for k in fj if k[0] == "backbone"]
    moved = [k for k in tower if not np.array_equal(fj[k], f0[k])]
    if rank == "full":
        assert len(tower) == 4 * 53 + 53  # every BN leaf and conv kernel
        stats = [k for k in moved if k[-1] in ("mean", "var")]
        assert len(stats) > 100, "the BN statistics train under 'full'"
        for key in stats[:20]:  # the port moved them as JAX did
            assert not np.array_equal(fp[key], f0[key]), key
    else:
        assert {k[-1] for k in tower} == {"lora_a", "lora_b"}
        assert moved and all(k[-1] in ("lora_a", "lora_b") for k in moved)


def test_enc_ft_training_step_matches_jax():
    """One ``enc_ft`` step of a global regressor (stages_cnn depth 1, CLIP
    tower): gradients reach every tower leaf, the attention pool's and the
    BN statistics included, and the port's step matches JAX's."""
    jcfg = JaxGlobalConfig(backbone=JaxBackboneConfig(
        kind="resnet50_clip", image_size=SIZE, compute_dtype="float32"),
        head="stages_cnn", depth=1, enc_ft=True)
    jmodel = jax_make_global(jcfg)
    variables = _variables(jmodel, 7)
    for head in variables["params"]["aggregator"].values():  # a live head
        head["kernel"] = np.abs(head["kernel"]) * 0.05
        head["bias"] = head["bias"] + 0.1
    batch = _batches(8, [2])[0]
    pmodel = make_global_model(GlobalModelConfig(
        backbone=BackboneConfig(kind="resnet50_clip", image_size=SIZE,
                                compute_dtype="float32"),
        head="stages_cnn", depth=1, enc_ft=True))
    load_jax_global_params(pmodel, variables)
    jax_out = _jax_step(jmodel, variables, jax_predicate(enc_ft=True), False,
                        batch)
    port = _port_step(pmodel, trainable_predicate(enc_ft=True), False, batch)
    fp, fj, f0 = _check(port, jax_out, variables["params"], "enc_ft")
    assert ("backbone", "attnpool", "out_proj", "kernel") in fj
    moved = [k for k in fj if k[0] == "backbone"
             and not np.array_equal(fj[k], f0[k])]
    assert any(k[-1] == "var" for k in moved)
