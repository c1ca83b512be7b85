"""Port checkpoints (srsem_torch/train/checkpoint.py) and partitioning
(srsem_torch/train/partition.py) vs the JAX package's
srsem/train/checkpoint.py and srsem/train/partition.py.

Files go both ways between the packages: srsem's ``save_checkpoint``
writes and the port reads, leaf for leaf; the port writes and srsem reads.
The port's writer gives the same bytes as flax's ``to_bytes``.  Arrays
over flax's chunk size are written as chunked maps; the size is
monkeypatched small here.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

import srsem.train.checkpoint as jck
from srsem.train.partition import merge_params as jax_merge_params
from srsem.train.partition import partition_params as jax_partition_params
from srsem.train.partition import trainable_predicate as jax_predicate
from srsem_torch.train import checkpoint as tck
from srsem_torch.train import partition as tpart
from torch_port_tmp import remove_tmp_path  # noqa: F401 — autouse fixture


def _tree(seed=0):
    """A checkpoint-shaped tree: float32 head params, an int32 array, a
    bf16 leaf, a numpy scalar, Python scalars, an Adam opt_state (named
    tuples inside a tuple) and empty batch_stats."""
    rng = np.random.default_rng(seed)
    trainable = {"aggregator": {
        "w_layers.0": {"kernel": rng.standard_normal((16, 1)).astype(np.float32),
                       "bias": np.array([0.25], np.float32)},
        "fin_lin.0": {"kernel": rng.standard_normal((12, 600)).astype(np.float32),
                      "bias": np.zeros(600, np.float32)}}}
    return {
        "trainable": trainable,
        "opt_state": optax.adam(1e-3).init(trainable),
        "batch_stats": {},
        "extra": {"ids": np.arange(9, dtype=np.int32),
                  "half": jnp.asarray(rng.standard_normal((3, 5)), jnp.bfloat16),
                  "scale": np.float32(0.5), "count": 7, "lr": 1e-4,
                  "name": "wperlay_cnn", "none": None, "flag": True}}


def _assert_leaf_equal(got, want):
    if isinstance(got, torch.Tensor):
        assert got.dtype == torch.bfloat16
        want = (want.float().numpy() if isinstance(want, torch.Tensor)
                else np.asarray(want).astype(np.float32))
        np.testing.assert_array_equal(got.float().numpy(), want)
    elif isinstance(want, (np.ndarray, np.generic, jax.Array)):
        want = np.asarray(want)
        assert np.asarray(got).dtype == want.dtype
        assert np.asarray(got).shape == want.shape
        np.testing.assert_array_equal(np.asarray(got), want)
    else:
        assert got == want and type(got) is type(want)


def _assert_tree_equal(got, want):
    assert isinstance(got, dict) and isinstance(want, dict)
    assert sorted(got) == sorted(want)
    for k in want:
        if isinstance(want[k], dict):
            _assert_tree_equal(got[k], want[k])
        else:
            _assert_leaf_equal(got[k], want[k])


@pytest.fixture
def small_chunks(monkeypatch):
    """Chunk arrays over 1 KB in both packages (flax splits at 1 GB)."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 1024)
    monkeypatch.setattr(tck, "MAX_CHUNK_SIZE", 1024)


def test_port_reads_jax_checkpoint(tmp_path, small_chunks):
    tree = _tree()
    jck.save_checkpoint(str(tmp_path), 3, tree)
    with open(tmp_path / "step_3.msgpack", "rb") as f:
        assert b"__msgpack_chunked_array__" in f.read()  # fin_lin.0 is chunked
    got = tck.restore_checkpoint(str(tmp_path))
    want = jck.restore_checkpoint(str(tmp_path))
    _assert_tree_equal(got, want)
    assert got["trainable"]["aggregator"]["fin_lin.0"]["kernel"].shape == (12, 600)
    assert isinstance(got["extra"]["half"], torch.Tensor)
    assert sorted(got["opt_state"]) == ["0", "1"]  # (ScaleByAdam, Empty)


def test_port_writes_what_jax_reads(tmp_path, small_chunks):
    tree = jax.device_get(_tree(1))
    tree["extra"]["half"] = torch.tensor(
        np.asarray(tree["extra"]["half"]).astype(np.float32)).to(torch.bfloat16)
    tree["extra"]["scalar"] = np.float32(2.5)  # ext type 3
    path = tck.save_checkpoint(str(tmp_path), 4, tree)
    assert path == os.path.join(str(tmp_path), "step_4.msgpack")
    assert jck.latest_step(str(tmp_path)) == 4
    got = jck.restore_checkpoint(str(tmp_path))
    reference = dict(tree)
    reference["opt_state"] = serialization.to_state_dict(tree["opt_state"])
    reference["extra"] = {**tree["extra"],
                          "half": np.asarray(_tree(1)["extra"]["half"])}
    _assert_tree_equal({k: v for k, v in got.items()},
                       serialization.msgpack_restore(
                           serialization.to_bytes(reference)))
    assert isinstance(got["extra"]["scalar"], np.float32)
    # The same bytes as flax's writer, and the port reads its own file.
    assert tck.msgpack_serialize(tree) == serialization.to_bytes(reference)
    _assert_tree_equal(tck.restore_checkpoint(str(tmp_path), step=4),
                       tck.msgpack_restore(tck.msgpack_serialize(tree)))


def test_corrupt_latest_json_falls_back_alike(tmp_path):
    for step in (2, 10, 7):
        jck.save_checkpoint(str(tmp_path), step, {"v": np.full(3, step)})
    (tmp_path / "latest.json").write_text('{"step": ')
    assert tck.latest_step(str(tmp_path)) == jck.latest_step(str(tmp_path)) == 10
    got = tck.restore_checkpoint(str(tmp_path))
    np.testing.assert_array_equal(got["v"], np.full(3, 10))
    (tmp_path / "latest.json").write_text(json.dumps({"path": "x"}))
    assert tck.latest_step(str(tmp_path)) == jck.latest_step(str(tmp_path)) == 10
    with pytest.raises(FileNotFoundError, match="no checkpoint under"):
        tck.restore_checkpoint(str(tmp_path / "missing"))


@pytest.mark.parametrize("keep_last", [None, 1, 2])
def test_keep_last_leaves_the_same_files(tmp_path, keep_last):
    """The same saves in both packages leave the same listed files: a
    stale higher step is pruned, ``step_0010`` counts as step 10 next to
    ``step_7``, and the pointer names the last save."""
    listing = {}
    for name, mod in (("jax", jck), ("port", tck)):
        d = tmp_path / name
        d.mkdir()
        (d / "step_0010.msgpack").write_bytes(b"old run")
        (d / "step_99.msgpack").write_bytes(b"stale")
        (d / "notes.txt").write_text("kept")
        for step in (3, 7, 12):
            mod.save_checkpoint(str(d), step, {"v": np.float32(step)},
                                keep_last=keep_last)
        listing[name] = sorted(os.listdir(d))
        assert json.loads((d / "latest.json").read_text())["step"] == 12
    assert listing["port"] == listing["jax"]
    if keep_last == 1:
        assert listing["port"] == ["latest.json", "notes.txt", "step_12.msgpack"]


def test_merge_and_partition_match_jax():
    rng = np.random.default_rng(2)
    params = {"backbone": {"conv1": {"kernel": rng.standard_normal(4)},
                           "lora": {"lora_a": rng.standard_normal(2)}},
              "aggregator": {"w_layers.0": {"kernel": rng.standard_normal(3),
                                            "bias": rng.standard_normal(1)}},
              "empty": {}}
    trained = {"aggregator": {"w_layers.0": {"kernel": np.ones(3)}},
               "decoder.0": {"conv1": {"bias": np.zeros(2)}}}
    got = tpart.merge_params(trained, params)
    want = jax_merge_params(trained, params)
    _assert_tree_equal(got, want)
    assert "empty" not in got  # flatten_dict drops empty dicts, as flax's
    for kw in ({}, {"lora": True}, {"enc_ft": True}):
        for g, w in zip(tpart.partition_params(params, tpart.trainable_predicate(**kw)),
                        jax_partition_params(params, jax_predicate(**kw))):
            _assert_tree_equal(g, w)


def test_reader_rejects_malformed_bytes():
    good = tck.msgpack_serialize({"a": np.arange(3)})
    with pytest.raises(ValueError, match="truncated"):
        tck.msgpack_restore(good[:-2])
    with pytest.raises(ValueError, match="after the msgpack object"):
        tck.msgpack_restore(good + b"\x00")
    with pytest.raises(TypeError, match="cannot serialize"):
        tck.msgpack_serialize({"a": object()})


def test_trainable_params_round_trip_through_checkpoint(tmp_path):
    """``jax_trainable_params`` gives what srsem/utils/convert.py's
    convert_global_head / convert_clu_decoder give for the same port
    model; written with the port's save_checkpoint, read back and loaded
    with ``partial=True`` into a differently seeded model, it gives back
    the trained weights and keeps the tower."""
    from srsem.utils.convert import convert_clu_decoder, convert_global_head
    from srsem_torch.config import BackboneConfig, GlobalModelConfig
    from srsem_torch.models.global_models import make_global_model
    from srsem_torch.models.local_models import CluUnet
    from srsem_torch.utils.convert import (
        jax_trainable_params,
        load_jax_global_params,
        load_jax_local_params,
    )

    def leaves_equal(a, b):
        assert sorted(a) == sorted(b)
        for k in a:
            if isinstance(a[k], dict):
                leaves_equal(a[k], b[k])
            else:
                np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))

    bb = BackboneConfig(kind="resnet50_clip", image_size=64,
                        compute_dtype="float32")
    for head in ("wperlay_cnn", "emb_lin"):
        cfg = GlobalModelConfig(backbone=bb, head=head, depth=11)
        model = make_global_model(cfg, torch.Generator().manual_seed(0))
        params, stats = jax_trainable_params(model)
        leaves_equal(params, convert_global_head(model.aggregator.state_dict()))
        assert stats == {}
        tck.save_checkpoint(str(tmp_path / head), 1,
                            {"trainable": params, "batch_stats": stats})
        other = make_global_model(cfg, torch.Generator().manual_seed(1))
        tower = {k: v.clone() for k, v in other.backbone.state_dict().items()}
        restored = tck.restore_checkpoint(str(tmp_path / head))
        load_jax_global_params(other, {"params": restored["trainable"]},
                               partial=True)
        for k, v in model.aggregator.state_dict().items():
            torch.testing.assert_close(other.aggregator.state_dict()[k], v,
                                       rtol=0, atol=0)
        for k, v in other.backbone.state_dict().items():
            assert torch.equal(v, tower[k])
    clu = CluUnet(compute_dtype=torch.float32, image_size=64, width_mult=0.125)
    clu.reset_parameters(torch.Generator().manual_seed(2))
    with torch.no_grad():
        for m in clu.decoder.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-1, 1)
                m.running_var.uniform_(0.5, 1.5)
    params, stats = jax_trainable_params(clu)
    want = convert_clu_decoder({k: v for k, v in clu.state_dict().items()
                                if k.startswith("decoder.")})
    leaves_equal(params, want["params"])
    leaves_equal(stats, want["batch_stats"])
    tck.save_checkpoint(str(tmp_path / "clu"), 1,
                        {"trainable": params, "batch_stats": stats})
    restored = tck.restore_checkpoint(str(tmp_path / "clu"))
    other = CluUnet(compute_dtype=torch.float32, image_size=64, width_mult=0.125)
    load_jax_local_params(other, {"params": restored["trainable"],
                                  "batch_stats": restored["batch_stats"]},
                          partial=True)
    for k, v in clu.decoder.state_dict().items():
        torch.testing.assert_close(other.decoder.state_dict()[k], v,
                                   rtol=0, atol=0)
    with pytest.raises(KeyError, match="not in the model"):
        load_jax_local_params(other, {"params": {"decoder.9": params["decoder.0"]}},
                              partial=True)
