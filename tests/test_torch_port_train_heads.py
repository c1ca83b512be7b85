"""Port training of the other CNN global heads (``wperlay_cnn``,
``stages_cnn_pooling``, ``emb_lin``) vs JAX's ``run_training``, from the
same variables on the same batches (the last one ragged), float32 at
64 px on the CLIP tower, with the helpers and tolerances of
tests/test_torch_port_train.py: per-step losses and the validation
metrics rtol 3e-3, the trained head rtol 1e-3 / atol 2·n_steps·lr, Adam's
state leaf by leaf.  Each head starts live (its final ReLU passes), so
the steps move it.
"""

import jax
import numpy as np
import pytest

from srsem.core.config import BackboneConfig as JaxBackboneConfig
from srsem.core.config import GlobalModelConfig as JaxGlobalConfig
from srsem.models.global_models import make_global_model as jax_make_global
from srsem_torch.config import BackboneConfig, GlobalModelConfig
from srsem_torch.models.global_models import make_global_model
from test_torch_port_train import (  # noqa: F401 — a fixture
    LR,
    SIZE,
    _batches,
    _close,
    _moments_close,
    _reference_cpu_convs,
    _train_both,
    _variables,
)


@pytest.mark.parametrize("head,depth", [("wperlay_cnn", 2),
                                        ("stages_cnn_pooling", 1),
                                        ("emb_lin", 3)])
def test_head_training_matches_jax(tmp_path, head, depth):
    bb = dict(kind="resnet50_clip", image_size=SIZE, compute_dtype="float32")
    jmodel = jax_make_global(JaxGlobalConfig(
        backbone=JaxBackboneConfig(**bb), head=head, depth=depth))
    variables = _variables(jmodel, 1)
    agg = variables["params"]["aggregator"]
    if head == "wperlay_cnn":
        for layer in agg.values():
            layer["kernel"] = np.abs(layer["kernel"]) * 0.05
            layer["bias"] = layer["bias"] + 0.1
    else:  # the MLP's last Dense: a live output
        last = agg[max(agg, key=lambda k: int(k.split(".")[1]))]
        last["bias"] = last["bias"] + 0.5
    pmodel = make_global_model(GlobalModelConfig(
        backbone=BackboneConfig(**bb), head=head, depth=depth))
    n_steps = 2
    train = _batches(11, [4, 3], batch_size=4)
    val = _batches(12, [4])
    jres, jw, pres, pw = _train_both(jmodel, pmodel, variables, False,
                                     train, val, tmp_path)
    np.testing.assert_allclose(pw.batch_losses(), jw.batch_losses(),
                               rtol=3e-3, atol=1e-5)
    assert len(set(pw.batch_losses())) == n_steps
    for key in ("loss", "mse", "srcc"):
        np.testing.assert_allclose(pres.val_metrics[key],
                                   jres.val_metrics[key], rtol=3e-3,
                                   atol=1e-5, err_msg=key)
    _close(pres.trainable, jax.device_get(jres.trainable), 1e-3,
           2 * n_steps * LR, head)
    _moments_close(pres.opt_state, jres.opt_state)
