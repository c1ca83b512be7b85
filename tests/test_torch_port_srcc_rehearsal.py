"""The SRCC rehearsal on the port: the counterpart of
tests/test_srcc_rehearsal.py, with the JAX package's ``train_global`` and
the port's ``train_global`` (srsem_torch/train/loop.py, its fused tower's
plain version on the CPU) training from the same variables on identical
batches.

The planted-signal dataset is the JAX test's: GT textures, each SR
candidate the GT blended with a pixel-permuted copy at strength alpha
(plus noise), label alpha; 40 train and 16 validation pairs at 64 px,
batch 8, 30 epochs, Adam at 1e-4, stages_cnn (depth 2) on a frozen CLIP
ResNet-50 with random BN statistics.  Each run must learn the signal
(validation SRCC > 0.9) and the two SRCCs agree within the north star's
0.005.  The weights are the JAX test's: its torch mirror's, converted.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from srsem.core.config import BackboneConfig as JaxBackboneConfig
from srsem.core.config import GlobalModelConfig as JaxGlobalConfig
from srsem.core.config import MeshConfig as JaxMeshConfig
from srsem.core.config import TrainConfig as JaxTrainConfig
from srsem.core.meshes import create_mesh
from srsem.train.loop import train_global as jax_train_global
from srsem.utils.convert import convert_clip_resnet50
from srsem_torch.config import BackboneConfig, GlobalModelConfig, TrainConfig
from srsem_torch.train.loop import train_global
from test_srcc_rehearsal import _batches, _make_dataset
from test_torch_parity import (
    TorchClipResNet50,
    TorchStagesCnnHead,
    _randomize_bn,
)
from test_torch_port_train import (  # noqa: F401 — fixtures
    _reference_cpu_convs,
    _two_threads,
)

SIZE, DEPTH, BATCH, EPOCHS, LR = 64, 2, 8, 30, 1e-4
N_TRAIN, N_VAL = 40, 16


def _variables():
    """tests/test_srcc_rehearsal.py's init: a torch CLIP-RN50 mirror with
    random BN statistics (seed 17) converted, and its stages_cnn heads
    with biases in [0.05, 0.15] (a live final ReLU)."""
    torch.manual_seed(17)
    tbb = TorchClipResNet50(image_size=SIZE).eval()
    _randomize_bn(tbb)
    heads = TorchStagesCnnHead(tbb, depth=DEPTH).w_layers
    with torch.no_grad():
        for conv in heads:
            conv.bias.uniform_(0.05, 0.15)
    flat = {}
    for j, conv in enumerate(heads):
        flat[(f"w_layers.{j}", "kernel")] = jnp.asarray(
            conv.weight.detach().numpy().transpose(2, 3, 1, 0).reshape(-1, 1))
        flat[(f"w_layers.{j}", "bias")] = jnp.asarray(conv.bias.detach().numpy())
    return {"params": {
        "backbone": convert_clip_resnet50(tbb.state_dict(), image_size=SIZE),
        "aggregator": traverse_util.unflatten_dict(flat)}}


@pytest.mark.slow
def test_port_srcc_rehearsal_matches_jax():
    rng = np.random.default_rng(0)  # the JAX test's np_rng
    train = _batches(*_make_dataset(rng, N_TRAIN), BATCH)
    val = _batches(*_make_dataset(rng, N_VAL), BATCH)
    # numpy leaves: the JAX loop donates the device arrays it is given.
    variables = jax.tree.map(np.asarray, _variables())
    bb = dict(kind="resnet50_clip", image_size=SIZE, compute_dtype="float32")
    jres = jax_train_global(
        JaxGlobalConfig(backbone=JaxBackboneConfig(**bb), head="stages_cnn",
                        depth=DEPTH),
        JaxTrainConfig(lr=LR, batch_size=BATCH, epochs=EPOCHS,
                       mesh=JaxMeshConfig(data_axis=1, model_axis=1),
                       checkpoint_dir=None, log_every=10 ** 6),
        train, val, variables=variables,
        mesh=create_mesh(1, 1, devices=jax.devices("cpu")[:1]))
    pres = train_global(
        GlobalModelConfig(backbone=BackboneConfig(**bb), head="stages_cnn",
                          depth=DEPTH),
        TrainConfig(lr=LR, batch_size=BATCH, epochs=EPOCHS,
                    checkpoint_dir=None, log_every=10 ** 6),
        train, val, variables=variables, device="cpu")

    srcc_jax = jres.val_metrics["srcc"]
    srcc_port = pres.val_metrics["srcc"]
    delta = abs(srcc_port - srcc_jax)
    print(f"SRCC rehearsal: jax={srcc_jax:.4f} port={srcc_port:.4f} "
          f"delta={delta:.4f}")
    assert srcc_jax > 0.9, f"the JAX run failed to learn: {srcc_jax}"
    assert srcc_port > 0.9, f"the port's run failed to learn: {srcc_port}"
    assert delta <= 0.005, (f"SRCC delta {delta:.4f} exceeds the 0.005 north "
                            f"star (jax {srcc_jax:.4f}, port {srcc_port:.4f})")
