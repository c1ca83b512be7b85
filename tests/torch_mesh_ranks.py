"""Rank processes for the port's mesh tests (tests/test_torch_port_mesh*.py).

``spawn`` starts ``world`` gloo ranks on the CPU (a ``FileStore`` in a
temporary directory), runs one job of ``JOBS`` on every rank and returns
each rank's result.  A spawned rank re-imports the module that defines
its function, so this module imports torch and the port only: the JAX
references are computed in the test process.  Every job also runs in the
test process itself, where no process group exists and ``create_mesh``
gives the rank-local 1x1 mesh: that is the one-rank reference.
"""

from __future__ import annotations

import datetime
import io
import json
import os
import shutil
import tempfile
import time
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from srsem_torch.config import (
    BackboneConfig,
    GlobalModelConfig,
    LocalModelConfig,
    TrainConfig,
)
from srsem_torch.core.meshes import create_mesh, world
from srsem_torch.models.global_models import make_global_model
from srsem_torch.models.local_models import make_local_model

SIZE, LR = 64, 1e-4
CLIP = BackboneConfig(kind="resnet50_clip", image_size=SIZE,
                      compute_dtype="float32")
IMAGENET = BackboneConfig(kind="resnet50", image_size=SIZE,
                          compute_dtype="float32")
GCFG = GlobalModelConfig(backbone=CLIP, head="stages_cnn", depth=2)
LCFG = LocalModelConfig(backbone=CLIP)
#: The CLU decoder's width in these tests (as tests/test_torch_port_train.py).
WIDTH = 0.125


#: A collective that waits longer than this fails its rank (a mismatch
#: between the ranks' calls ends the test instead of hanging it), and so
#: does a spawn that has not ended after ``SPAWN_TIMEOUT``.
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=120)
SPAWN_TIMEOUT = 600.0


def _entry(rank, world_size, store, job, payload_path, out_dir):
    torch.set_num_threads(1)
    torch.backends.mkldnn.enabled = False
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world_size,
                            timeout=COLLECTIVE_TIMEOUT)
    try:
        result = JOBS[job](torch.load(payload_path, weights_only=False))
        torch.save(result, os.path.join(out_dir, f"{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(world_size: int, job: str, payload) -> list:
    """``JOBS[job](payload)`` on ``world_size`` gloo ranks; the ranks'
    results in rank order.  Everything the ranks write lives in a
    temporary directory that is removed."""
    tmp = Path(tempfile.mkdtemp(prefix="srsem_mesh_"))
    ctx = None
    try:
        torch.save(payload, tmp / "payload.pt")
        ctx = mp.start_processes(_entry, nprocs=world_size, join=False,
                                 start_method="spawn",
                                 args=(world_size, str(tmp / "store"), job,
                                       str(tmp / "payload.pt"), str(tmp)))
        deadline = time.monotonic() + SPAWN_TIMEOUT
        while not ctx.join(timeout=5.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{job} ranks still running after "
                                   f"{SPAWN_TIMEOUT} s")
        return [torch.load(tmp / f"{r}.pt", weights_only=False)
                for r in range(world_size)]
    finally:
        for proc in ctx.processes if ctx is not None else ():
            if proc.is_alive():
                proc.kill()
        shutil.rmtree(tmp, ignore_errors=True)


def run_local(job: str, payload):
    """``JOBS[job]`` in this process: the one-rank reference (the payload
    goes through a save and load, as a rank's does; oneDNN off, as on the
    ranks)."""
    buf = io.BytesIO()
    torch.save(payload, buf)
    buf.seek(0)
    enabled = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    try:
        return JOBS[job](torch.load(buf, weights_only=False))
    finally:
        torch.backends.mkldnn.enabled = enabled


def _np(t):
    return t.detach().float().cpu().numpy()


# ---- models ------------------------------------------------------------------


def global_model(state=None, cfg=GCFG):
    model = make_global_model(cfg)
    if state is not None:
        model.load_state_dict(state)
    return model


def local_model(state=None):
    """The CLU model at the tests' width from a port state dict, or from
    JAX-layout variables (a dict with ``"params"``)."""
    model = make_local_model(LCFG, width_mult=WIDTH)
    if state is not None and "params" in state:
        from srsem_torch.utils.convert import load_jax_local_params

        load_jax_local_params(model, state)
    elif state is not None:
        model.load_state_dict(state)
    return model


# ---- jobs --------------------------------------------------------------------


def scoring_job(p):
    """The scorers on the rank's mesh (default: every rank on ``data``)."""
    from srsem_torch.eval.dataset_sweep import DualScorer
    from srsem_torch.eval.grouped import GroupedPairScorer, GroupedMapScorer
    from srsem_torch.eval.scorer import PairScorer

    gm, lm = global_model(p["global"]), local_model(p["local"])
    pair = PairScorer(GCFG, gm, batch_size=3, device="cpu")
    maps = PairScorer(LCFG, lm, batch_size=3, model_kind="local",
                      device="cpu")
    grouped = GroupedPairScorer(GCFG, gm, k=2, pairs=pair)
    grouped_maps = GroupedMapScorer(LCFG, lm, k=2, pairs=maps)
    dual = DualScorer(GCFG, LCFG, gm, lm, batch_size=3, device="cpu")
    a, b, gt, sr = p["a"], p["b"], p["gt"], p["sr"]
    scores, dual_maps = dual.score_both(a, b)
    g_scores, g_maps = dual.score_group_arrays(gt, sr)
    return {"batch_size": pair.batch_size,
            "pair": _np(pair.score_arrays(a, b)),
            "maps": _np(maps.score_arrays(a, b)),
            "grouped": _np(grouped.score_arrays(gt, sr)),
            "grouped_maps": _np(grouped_maps.score_arrays(gt, sr)),
            "dual": (_np(scores), _np(dual_maps)),
            "dual_groups": (_np(g_scores), _np(g_maps))}


class Capture:
    """A metric writer keeping every record."""

    def __init__(self):
        self.records = []

    def write(self, step, metrics):
        self.records.append((step, dict(metrics)))

    def close(self):
        pass


def _trained(result, writer):
    return {"trainable": result.trainable, "opt_state": result.opt_state,
            "batch_stats": result.batch_stats, "step": result.step,
            "val_metrics": result.val_metrics,
            "losses": [m["train_loss_batch"] for _, m in writer.records
                       if "train_loss_batch" in m],
            "epoch_losses": [m["train_loss_epoch"] for _, m in writer.records
                             if "train_loss_epoch" in m]}


def bn64_inputs():
    """Float64 NCHW ``(x, dy, weight, bias)`` for the cross-rank BN check:
    a mean 300 times the spread, so the two statistics passes matter."""
    g = torch.Generator().manual_seed(5)
    f64 = {"generator": g, "dtype": torch.float64}
    return (torch.randn(8, 6, 5, 5, **f64) * 0.01 + 3.0,
            torch.randn(8, 6, 5, 5, **f64), torch.rand(6, **f64) + 0.5,
            torch.randn(6, **f64))


def cross_rank_bn64(mesh):
    """The decoder's cross-rank train-mode BN (``_SyncBatchNorm``) on this
    rank's slice of ``bn64_inputs``, in float64: the output and the input
    gradient gathered over ``data``, the weight and bias gradients summed
    over it (as the train step sums them)."""
    from srsem_torch.core.meshes import all_reduce, data_slice, gather_batch
    from srsem_torch.models.local_models import _SyncBatchNorm

    x, dy, weight, bias = bn64_inputs()
    x = data_slice(mesh, x).clone().requires_grad_(True)
    weight.requires_grad_(True)
    bias.requires_grad_(True)
    y = _SyncBatchNorm.apply(x, weight, bias, mesh, 1e-5)[0]
    (y * data_slice(mesh, dy)).sum().backward()
    return {"y": gather_batch(mesh, y.detach()),
            "dx": gather_batch(mesh, x.grad),
            "dweight": all_reduce(mesh, weight.grad),
            "dbias": all_reduce(mesh, bias.grad)}


def training_job(p):
    """``run_training`` of the global head and of the CLU decoder on the
    payload's batches (``p["batches"][kind]``: train and validation
    lists); each rank checkpoints into its own directory, so the test sees
    which ranks wrote."""
    from srsem_torch.train.loop import run_training
    from srsem_torch.train.partition import trainable_predicate

    rank = world()[0]
    out = {}
    for kind, model, is_map in (("global", global_model(p["global"]), False),
                                ("clu", local_model(p["clu_variables"]),
                                 True)):
        ckpt = os.path.join(p["ckpt_root"], f"{kind}-rank{rank}")
        tcfg = TrainConfig(lr=LR, epochs=p["epochs"][kind],
                           batch_size=p["batch_size"][kind],
                           checkpoint_dir=ckpt)
        writer = Capture()
        train, val = p["batches"][kind]
        res = run_training(model, is_map, train, val, tcfg,
                           trainable_predicate(), writer=writer,
                           device="cpu")
        out[kind] = {**_trained(res, writer), "wrote": os.path.isdir(ckpt)}
    # One train-mode decode of the same diff pyramids (the rank's slice).
    from srsem_torch.core.meshes import data_slice, gather_batch
    from srsem_torch.utils.convert import jax_trainable_params

    model = local_model(p["clu_variables"])
    mesh = create_mesh(device="cpu")
    model.sync_batch_norm(mesh)
    maps = model.decode_from_diffs(
        [torch.from_numpy(data_slice(mesh, d)) for d in p["diffs"]],
        train=True)
    out["bn"] = {"maps": _np(gather_batch(mesh, maps)),
                 "batch_stats": jax_trainable_params(model)[1]}
    out["bn64"] = cross_rank_bn64(mesh)
    try:
        run_training(global_model(p["global"]), False,
                     *p["batches"]["global"],
                     TrainConfig(batch_size=3, epochs=0),
                     trainable_predicate(), device="cpu")
    except ValueError as e:
        out["refusal"] = str(e)
    return out


def tensor_parallel_job(p):
    """One global train step of the ImageNet tower's head at each of
    ``p["meshes"]``, the tower's convs of 512 or more output channels
    sharded over the model axis; the loss and the updated head."""
    from srsem_torch.core.meshes import shard_batch
    from srsem_torch.parallel.sharding import is_sharded, param_shardings
    from srsem_torch.train.loop import build_training
    from srsem_torch.train.partition import trainable_predicate
    from srsem_torch.utils.convert import jax_trainable_params

    out = {}
    for shape in p["meshes"]:
        mesh = create_mesh(*shape, device="cpu")
        model = global_model(p["global"], p["cfg"])
        param_shardings(mesh, model.backbone, min_shard_dim=512)
        steps, _ = build_training(model, False, trainable_predicate(), LR,
                                  mesh.device, mesh=mesh)
        loss = steps.train_step(*shard_batch(mesh, p["batch"]))
        out[shape] = {"loss": float(loss), "sharded": is_sharded(model),
                      "trainable": jax_trainable_params(model)[0]}
    return out


def sweeps_job(p):
    """The shared-tower sweeps, the diff caches and the stat cache (with
    the closed form) on the payload's loaders, the CLU decoders at the
    tests' width."""
    from srsem_torch.train import diffcache, multisweep, statcache

    tcfg = TrainConfig(lr=LR, epochs=p["epochs"], batch_size=p["batch_size"],
                       seed=p["seed"])
    points = multisweep.depth_grid((1, 2))
    g_train, g_val = p["global"]
    l_train, l_val = p["local"]
    kw = {"backbone_params": p["tower"], "device": "cpu"}
    full_width = multisweep.make_local_model
    multisweep.make_local_model = (
        lambda cfg, **k: full_width(cfg, width_mult=WIDTH, **k))
    try:
        return {
            "shared": multisweep.train_global_sweep_shared_tower(
                points, GCFG, tcfg, g_train, g_val, **kw),
            "cached_diffs": diffcache.train_global_sweep_cached_diffs(
                points, GCFG, tcfg, g_train, g_val, **kw),
            "cached_stats": statcache.train_global_sweep_cached_stats(
                points, GCFG, tcfg, g_train, g_val, **kw),
            "closed_form": statcache.solve_global_sweep_closed_form(
                points, GCFG, tcfg, g_train, g_val, l2=1e-2, **kw),
            "thresholds": multisweep.train_local_sweep_shared_tower(
                [None, 0.5], LCFG, tcfg, l_train, l_val, **kw),
            "local_cached": diffcache.train_local_cached_diffs(
                LCFG, tcfg, _first_threshold(l_train),
                _first_threshold(l_val), **kw),
        }
    finally:
        multisweep.make_local_model = full_width


def _first_threshold(loader):
    """A threshold-sweep loader's batches with the first threshold's
    labels only."""
    return [(((a, b), y[:, 0]), mask) for ((a, b), y), mask in loader]


def serve_job(p):
    """A scripted stdio session through ``ScoreService`` on the rank's mesh
    (rank 0 serves, the others follow); rank 0 returns the responses."""
    from srsem_torch.cli.serve import ScoreService, serve_stdio

    mesh = create_mesh(device="cpu")
    out = {}
    if mesh.shape["data"] > 1:
        try:
            ScoreService(GCFG, None, group_batch=3, mesh=mesh)
        except ValueError as e:
            out["refusal"] = str(e)
    service = ScoreService(GCFG, global_model(p["global"]), group_batch=4,
                           device="cpu", mesh=mesh, linger_ms=0.0,
                           map_cfg=LCFG, map_model=local_model(p["local"]))
    out["ladder"] = service._ladder()
    if not mesh.is_main:
        service.follow()
        service.close()
        return out
    lines = io.StringIO("".join(json.dumps(r) + "\n" for r in p["requests"]))
    got = io.StringIO()
    try:
        service.warmup([2])
        serve_stdio(service, lines, got)
    finally:
        service.close()
    out["responses"] = [json.loads(x) for x in got.getvalue().splitlines()]
    return out


JOBS = {"scoring": scoring_job, "training": training_job,
        "tensor_parallel": tensor_parallel_job, "sweeps": sweeps_job,
        "serve": serve_job}
