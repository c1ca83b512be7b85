"""Training with the ViT tower in the port (srsem_torch/train/{steps,loop,
statcache}.py, ``train-global`` / ``eval-global``) against the JAX
package's, on the tiny ViT of tests/test_models_vit.py (width 96, depth 4,
4 heads, 64 px, float32) with the weights of
tests/test_torch_port_vit_heads.py::jax_variables.

* One train step, the tower frozen (the module under ``no_grad``) and
  under ``enc_ft`` (the whole tower under autograd): the loss within rtol
  1e-5, every trained leaf within 2·lr, and Adam's moments leaf by leaf
  (tests/test_torch_port_finetune.py's checks).
* Checkpoints both ways: the port's ``train-global --set enc_ft=True``
  writes the JAX layout (the tower's leaves under ``trainable``), which
  the JAX CLI's ``eval-global`` reads as the port's does; a checkpoint the
  JAX package writes is read by the port's ``eval-global`` (SRCC and MSE
  within 1e-4).
* ``build_stat_cache`` over the ViT tower (token means of the squared
  diffs, 1e-4) and the closed-form token heads (shared and per layer)
  against srsem/train/statcache.py: the train MSE and the fitted head's
  predictions on the cache.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from srsem.backbones.resnet import make_backbone as jax_make_backbone
from srsem.cli.main import main as jax_main
from srsem.core.meshes import create_mesh
from srsem.models.global_models import make_global_model as jax_make_global
from srsem.models.global_models import token_head_from_stats as jax_from_stats
from srsem.train import statcache as jax_statcache
from srsem.train.checkpoint import save_checkpoint as jax_save_checkpoint
from srsem.train.partition import partition_params as jax_partition
from srsem.train.partition import trainable_predicate as jax_predicate
from srsem_torch.cli.main import main as port_main
from srsem_torch.models.global_models import make_global_model
from srsem_torch.train import statcache as port_statcache
from srsem_torch.train.checkpoint import restore_checkpoint
from srsem_torch.train.partition import flatten_dict, trainable_predicate
from srsem_torch.utils.convert import load_jax_global_params
from test_torch_port_finetune import LR, _check, _jax_step, _port_step
from test_torch_port_train import _batches, _two_threads  # noqa: F401
from test_torch_port_vit_heads import cfgs, jax_variables

VIT_SETS = ["--set", "backbone.image_size=64",
            "--set", "backbone.compute_dtype=float32",
            "--set", "backbone.vit_width=96", "--set", "backbone.vit_depth=4",
            "--set", "backbone.vit_heads=4",
            "--set", "head=stages_vit", "--set", "depth=3"]


@pytest.mark.parametrize("enc_ft", [False, True], ids=["frozen", "enc_ft"])
def test_vit_train_step_matches_jax(enc_ft):
    """One Adam step of stages_vit (depth 3): the frozen tower runs as the
    module under no_grad (the fused tower serves ResNets only), enc_ft
    trains the tower's leaves (patch conv, class token, positional table,
    LayerNorms, blocks) as JAX's step does."""
    import dataclasses

    cfg, jcfg = cfgs("stages_vit", 3)
    cfg = dataclasses.replace(cfg, enc_ft=enc_ft)
    jcfg = dataclasses.replace(jcfg, enc_ft=enc_ft)
    variables = jax_variables(jcfg, 11)
    pmodel = load_jax_global_params(make_global_model(cfg), variables)
    batch = _batches(12, [2])[0]
    jax_out = _jax_step(jax_make_global(jcfg), variables,
                        jax_predicate(enc_ft=enc_ft), False, batch)
    port = _port_step(pmodel, trainable_predicate(enc_ft=enc_ft), False, batch)
    init, _ = jax_partition(variables["params"], jax_predicate(enc_ft=enc_ft))
    fp, fj, f0 = _check(port, jax_out, init, "enc_ft" if enc_ft else "frozen")
    tower = [k for k in fj if k[0] == "backbone"]
    if enc_ft:
        assert ("backbone", "cls_token") in fj
        assert ("backbone", "blocks.3", "mlp.fc2", "kernel") in fj
        # Every leaf moves but the final LayerNorm's, which feeds only the
        # class-token embedding that the token heads do not read.
        still = {("backbone", "norm", "scale"), ("backbone", "norm", "bias")}
        for out in (fp, fj):
            moved = {k for k in tower if not np.array_equal(out[k], f0[k])}
            assert moved == set(tower) - still
    else:
        assert not tower and set(k[1] for k in fj) == {
            "w_layers.0", "w_layers.1"}


@pytest.fixture(scope="module")
def study(tmp_path_factory):
    """A ten-pair user study (``SR/`` and ``HQ/`` images and a CSV): SR =
    the GT blended with a permuted copy at strength α, label α (as
    tests/test_torch_port_train_cli.py makes its study)."""
    from PIL import Image

    root = tmp_path_factory.mktemp("vit_study")
    rng = np.random.default_rng(0)
    (root / "SR").mkdir()
    (root / "HQ").mkdir()
    rows = []
    for i in range(10):
        gt = rng.integers(0, 256, (72, 80, 3), dtype=np.uint8)
        alpha = (i + 0.5) / 10
        perm = rng.permutation(gt.reshape(-1, 3)).reshape(gt.shape)
        Image.fromarray(gt).save(root / "HQ" / f"{i}.jpg", quality=95)
        Image.fromarray(((1 - alpha) * gt + alpha * perm).astype(np.uint8)
                        ).save(root / "SR" / f"m_{i}.png")
        rows.append(f"m_{i}.png,{alpha!r}")
    (root / "scores.csv").write_text(
        "img_names,userStudyScores\n" + "\n".join(rows) + "\n")
    return root


def test_vit_checkpoints_both_ways_and_eval_global(study, tmp_path, capsys):
    """The port's enc_ft train-global checkpoint (the ViT tower's leaves in
    ``trainable``) read by both CLIs' eval-global; a JAX-written
    checkpoint read by both."""
    _, jcfg = cfgs("stages_vit", 3)
    variables = jax_variables(jcfg, 13)
    tower = tmp_path / "vit.msgpack"
    tower.write_bytes(serialization.to_bytes(variables["params"]["backbone"]))
    common = [str(study / "scores.csv"), str(study), "--backbone", "vit_clip",
              "--backbone-checkpoint", str(tower), *VIT_SETS]
    assert port_main(["train-global", *common, "--set", "enc_ft=True",
                      "--train-set", "batch_size=4", "--train-set", "epochs=1",
                      "--checkpoint-dir", str(tmp_path / "port"),
                      "--device", "cpu"]) == 0
    capsys.readouterr()
    written = restore_checkpoint(str(tmp_path / "port"))
    keys = flatten_dict(written["trainable"])
    assert ("backbone", "pos_embed") in keys
    assert ("aggregator", "w_layers.1", "kernel") in keys
    assert ("backbone", "blocks.0", "attn.qkv", "kernel") in flatten_dict(
        written["opt_state"]["0"]["mu"])
    # A JAX-written checkpoint: a moved head over the same tower.
    head = {k: {"kernel": v["kernel"] * 1.5, "bias": v["bias"] - 0.05}
            for k, v in variables["params"]["aggregator"].items()}
    jax_save_checkpoint(str(tmp_path / "jax"), 3, {"trainable": {
        "aggregator": head}})
    for writer in ("port", "jax"):
        out = {}
        for name, main, extra in (("jax", jax_main, []),
                                  ("port", port_main, ["--device", "cpu"])):
            assert main(["eval-global", *common, "--checkpoint",
                         str(tmp_path / writer), "--batch-size", "4",
                         *extra]) == 0
            out[name] = json.loads(
                capsys.readouterr().out.strip().splitlines()[-1])
        assert out["port"]["n"] == out["jax"]["n"] == 10
        np.testing.assert_allclose(
            [out["port"]["srcc"], out["port"]["mse"]],
            [out["jax"]["srcc"], out["jax"]["mse"]], rtol=1e-4, atol=1e-6,
            err_msg=writer)


@pytest.mark.parametrize("shared", [False, True], ids=["per_layer", "shared"])
def test_stat_cache_and_closed_form_token_head_match_jax(shared):
    """The stat cache over the ViT tower's taps and the closed-form token
    head (ridge 1e-3) against JAX's, on three batches of four pairs."""
    head = "single_lin_vit" if shared else "wperlay_vit"
    cfg, jcfg = cfgs(head, 2)
    variables = jax_variables(jcfg, 15)
    pmodel = load_jax_global_params(make_global_model(cfg), variables)
    names = list(pmodel.tap_names)
    loader = _batches(16, [4, 4, 4])
    jcache = jax_statcache.build_stat_cache(
        jax_make_backbone(jcfg.backbone), variables["params"]["backbone"],
        names, loader,
        create_mesh(data=1))
    pcache = port_statcache.build_stat_cache(pmodel.backbone, names, loader,
                                             torch.device("cpu"))
    for nm in names:
        assert pcache.stats[nm].shape == (3, 4, 96)
        np.testing.assert_allclose(pcache.stats[nm].numpy(),
                                   np.asarray(jcache.stats[nm]),
                                   rtol=1e-4, atol=1e-6, err_msg=nm)
    want = jax_statcache.fit_token_head_closed_form(jcache, names,
                                                    shared=shared, l2=1e-3)
    got = port_statcache.fit_token_head_closed_form(pcache, names,
                                                    shared=shared, l2=1e-3)
    assert set(got["params"]) == set(want["params"]) == (
        {"w_layer"} if shared else {"w_layers.0", "w_layers.1", "w_layers.2"})
    np.testing.assert_allclose(got["train_mse"], want["train_mse"],
                               rtol=1e-2, atol=1e-6)
    stats = [jnp.asarray(pcache.stats[nm].numpy()) for nm in names]
    preds = [np.asarray(jax_from_stats(fit["params"], stats, shared=shared))
             for fit in (got, want)]
    np.testing.assert_allclose(preds[0], preds[1], rtol=1e-3, atol=1e-3)
