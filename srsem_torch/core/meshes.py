"""Device mesh and batch placement over ``torch.distributed`` ranks — the
port of srsem/core/meshes.py.

The JAX package runs one SPMD program over a ``jax.sharding.Mesh`` of
shape ``(data, model)``: a batch is sharded over ``data``, state is
replicated, and XLA inserts the psums that make losses and BatchNorm
statistics global.  The port runs one process a card (``torchrun``), and
the same placement rules become explicit collectives:

* ``create_mesh`` builds a ``DeviceMesh`` of shape ``(data, model)``
  named ``("data", "model")`` over the process group (NCCL on ``cuda``,
  gloo on ``cpu``), starting the group from ``torchrun``'s environment
  when none exists.  Without a process group (``WORLD_SIZE`` unset or 1)
  it returns a 1x1 mesh that runs no collective, so every path is
  mesh-driven and a one-card run does exactly what it did before.
* ``shard_batch`` hands each rank its slice of a host batch (the rows of
  its ``data`` index; the ranks of one ``model`` group hold the same
  slice), ``replicate`` broadcasts rank 0's state to every rank, and
  ``gather_batch`` is ``shard_batch``'s inverse.

The mesh's default is the ``torchrun`` world, where JAX's single
controller meshes every visible device; ``create_mesh(1, 1)`` is a
rank-local 1x1 mesh (JAX's one-device mesh) whatever the world.  Gloo
moves CUDA tensors through host memory, so two ranks can share one card.
"""

from __future__ import annotations

import datetime
import os
from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from srsem_torch.device import DeviceLike, resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"

#: How long a rank waits for the others at ``init_process_group``.
INIT_TIMEOUT = datetime.timedelta(seconds=300)


class Mesh:
    """A ``(data, model)`` grid of ranks.  ``shape`` maps the axis names
    to their sizes, as JAX's ``mesh.shape`` does; ``device`` is this
    rank's device.  ``device_mesh`` is None for the rank-local 1x1 mesh,
    whose collectives are the identity."""

    def __init__(self, data: int, model: int, device: torch.device,
                 device_mesh=None):
        self.shape = {DATA_AXIS: data, MODEL_AXIS: model}
        self.device = device
        self.device_mesh = device_mesh
        self.data_index, self.model_index = (
            (0, 0) if device_mesh is None
            else tuple(device_mesh.get_coordinate()))
        self._groups = ({} if device_mesh is None else
                        {a: device_mesh.get_group(a)
                         for a in (DATA_AXIS, MODEL_AXIS)})

    @property
    def distributed(self) -> bool:
        """Whether this mesh runs collectives (a process group's mesh,
        even of one rank)."""
        return self.device_mesh is not None

    @property
    def is_main(self) -> bool:
        """Rank 0 of the world: the rank that writes checkpoints, logs and
        responses."""
        return is_main()

    def group(self, axis: str):
        return self._groups[axis]

    def __repr__(self) -> str:
        return (f"Mesh(data={self.shape[DATA_AXIS]}, "
                f"model={self.shape[MODEL_AXIS]}, device={self.device}, "
                f"coords=({self.data_index}, {self.model_index}))")


def world() -> tuple:
    """``(rank, world size)`` of the process group, ``(0, 1)`` without
    one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_main() -> bool:
    """Whether this process is rank 0: of the process group, or before one
    starts, of ``torchrun``'s ``RANK`` (a lone process is)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank() == 0
    return int(os.environ.get("RANK", "0")) == 0


def _rank_device(device: DeviceLike) -> torch.device:
    """``device`` for this rank: under a process group (or ``torchrun``) a
    bare ``cuda`` becomes the card of the rank's ``LOCAL_RANK`` (several
    ranks may share one card); one process keeps the device it asked
    for."""
    dev = resolve_device(device)
    ranked = dist.is_initialized() or "LOCAL_RANK" in os.environ
    if dev.type == "cuda" and dev.index is None and ranked:
        local = int(os.environ.get("LOCAL_RANK", world()[0]))
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return dev


def init_from_env(device: DeviceLike = None) -> None:
    """Start the process group from ``torchrun``'s environment
    (``WORLD_SIZE`` > 1, ``RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) when
    none exists: NCCL for the card, gloo for the CPU.  An unreachable
    store raises after ``INIT_TIMEOUT``."""
    if dist.is_initialized() or int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return
    dev = _rank_device(device)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            timeout=INIT_TIMEOUT)


def create_mesh(data: int = -1, model: int = 1,
                device: DeviceLike = None) -> Mesh:
    """A ``(data, model)`` mesh over the process group's ranks.

    ``data=-1`` takes every rank the model axis leaves.  With no process
    group the world is one rank, and the mesh is the rank-local 1x1 mesh;
    ``data=1, model=1`` gives that mesh in any world.  A mesh must cover
    the world: a rank outside it would have no work."""
    init_from_env(device)
    dev = _rank_device(device)
    _, n = world()
    if data == -1:
        if n % model != 0:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model > n:
        raise ValueError(
            f"mesh {data}x{model} needs {data * model} devices, have {n}")
    if not dist.is_initialized() or data * model == 1 and n > 1:
        return Mesh(data, model, dev)
    if data * model != n:
        raise ValueError(
            f"mesh {data}x{model} covers {data * model} of the {n} ranks; "
            "run as many ranks as the mesh has places")
    from torch.distributed.device_mesh import init_device_mesh

    dm = init_device_mesh(dev.type, (data, model),
                          mesh_dim_names=(DATA_AXIS, MODEL_AXIS))
    return Mesh(data, model, dev, dm)


# ---- collectives ------------------------------------------------------------


def _staged(mesh: Mesh, axis: Optional[str], t: torch.Tensor):
    """``(group, tensor to communicate)``: gloo takes CUDA tensors through
    host memory, NCCL host tensors through the rank's card."""
    group = mesh.group(axis) if axis else None
    backend = dist.get_backend(group)
    if t.is_cuda and backend == "gloo":
        return group, t.cpu()
    if not t.is_cuda and backend == "nccl":
        return group, t.to(mesh.device)
    return group, t.contiguous()


def all_reduce(mesh: Mesh, t: torch.Tensor, axis: str = DATA_AXIS
               ) -> torch.Tensor:
    """The sum of ``t`` over ``axis`` (a new tensor on ``t``'s device)."""
    if not mesh.distributed:
        return t
    group, buf = _staged(mesh, axis, t.detach().clone())
    dist.all_reduce(buf, group=group)
    return buf.to(t.device)


def all_gather(mesh: Mesh, t: torch.Tensor, axis: str = DATA_AXIS,
               dim: int = 0) -> torch.Tensor:
    """The ranks' ``t`` along ``axis``, concatenated along ``dim`` in the
    axis's order.  Every rank's ``t`` has the same shape."""
    if not mesh.distributed:
        return t
    group, buf = _staged(mesh, axis, t.detach())
    parts = [torch.empty_like(buf) for _ in range(mesh.shape[axis])]
    dist.all_gather(parts, buf, group=group)
    return torch.cat(parts, dim=dim).to(t.device)


def broadcast_(mesh: Mesh, t: torch.Tensor) -> None:
    """Overwrite ``t`` with world rank 0's copy."""
    if not mesh.distributed:
        return
    group, buf = _staged(mesh, None, t.detach())
    dist.broadcast(buf, src=0, group=group)
    if buf.data_ptr() != t.data_ptr() or buf.device != t.device:
        with torch.no_grad():
            t.copy_(buf)


def broadcast_object(mesh: Mesh, obj: Any = None) -> Any:
    """World rank 0's picklable ``obj`` on every rank."""
    if not mesh.distributed:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, device=(
        mesh.device if dist.get_backend() == "nccl" else None))
    return box[0]


# ---- batch placement --------------------------------------------------------


def data_slice(mesh: Mesh, x):
    """This rank's rows of a batch whose leading dimension divides the
    data axis (host arrays stay host arrays)."""
    d = mesh.shape[DATA_AXIS]
    n = x.shape[0]
    if n % d:
        raise ValueError(
            f"batch of {n} rows does not shard evenly over the data={d} "
            f"mesh axis; pad it to a multiple of {d}")
    rows = n // d
    return x[mesh.data_index * rows: (mesh.data_index + 1) * rows]


def to_device(x, device: torch.device) -> torch.Tensor:
    """A host array on ``device``: through pinned memory, without waiting,
    for the card."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    t = torch.from_numpy(np.ascontiguousarray(x))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def shard_batch(mesh: Mesh, tree):
    """A host batch (an array, or a tuple, list or dict of them) as this
    rank's slice on its device.  Leading dimensions must divide the data
    axis; callers pad the final partial batch (data/loader.py)."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(shard_batch(mesh, x) for x in tree)
    if isinstance(tree, dict):
        return {k: shard_batch(mesh, v) for k, v in tree.items()}
    return to_device(data_slice(mesh, tree), mesh.device)


def gather_batch(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The inverse of ``shard_batch``: every rank's slice, in data order,
    on every rank."""
    return all_gather(mesh, t, DATA_AXIS)


def sharded_call(mesh: Mesh, fn, *arrays: np.ndarray):
    """``fn`` of this rank's rows of the host ``arrays`` (their leading
    dimension padded with zero rows to a multiple of the data axis), its
    output (a tensor or a tuple of them) gathered on every rank and the
    padding trimmed."""
    n = arrays[0].shape[0]
    pad = (-n) % mesh.shape[DATA_AXIS]
    if pad:
        arrays = tuple(np.concatenate(
            [a, np.zeros((pad,) + a.shape[1:], a.dtype)]) for a in arrays)
    out = fn(*(data_slice(mesh, a) for a in arrays))
    if isinstance(out, tuple):
        return tuple(gather_batch(mesh, o)[:n] for o in out)
    return gather_batch(mesh, out)[:n]


def scatter_batch(mesh: Mesh, x: Optional[np.ndarray], shape: Sequence[int],
                  dtype=np.uint8) -> np.ndarray:
    """This rank's rows of world rank 0's host batch ``x`` (of ``shape``
    and ``dtype``; None on the other ranks), sent by rank 0 alone: the
    ranks of one data index receive the same rows."""
    if not mesh.distributed:
        return data_slice(mesh, x)
    rank, n = world()
    rows = shape[0] // mesh.shape[DATA_AXIS]
    dev = (mesh.device if dist.get_backend() == "nccl"
           else torch.device("cpu"))
    out = torch.empty((rows, *shape[1:]), dtype=torch.from_numpy(
        np.zeros(0, dtype)).dtype, device=dev)
    chunks = None
    if rank == 0:
        parts = torch.from_numpy(np.ascontiguousarray(x)).to(dev).split(rows)
        per_model = mesh.shape[MODEL_AXIS]
        chunks = [parts[r // per_model].contiguous() for r in range(n)]
    dist.scatter(out, chunks, src=0)
    return out.cpu().numpy()


def replicate(mesh: Mesh, state):
    """Rank 0's parameters and buffers (a module, or a sequence of
    modules or tensors) on every rank; returns ``state``."""
    if not mesh.distributed:
        return state
    items: Sequence = state if isinstance(state, (list, tuple)) else [state]
    for item in items:
        tensors = ([item] if isinstance(item, torch.Tensor) else
                   [*item.parameters(), *item.buffers()])
        for t in tensors:
            broadcast_(mesh, t.data)
    return state


class _GatherShards(torch.autograd.Function):
    """All-gather of the model group's slices along ``dim``.  Everything
    after the gather is replicated over the model group, so the gradient
    of a rank's slice is its own slice of the (equal) output gradients."""

    @staticmethod
    def forward(ctx, x, dim: int, mesh: Mesh):
        ctx.dim, ctx.index, ctx.size = dim, mesh.model_index, x.shape[dim]
        return all_gather(mesh, x, MODEL_AXIS, dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.index * ctx.size, ctx.size), None, None


def gather_shards(x: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    """A column-parallel layer's output: the model group's slices of
    ``dim`` concatenated, differentiably."""
    return _GatherShards.apply(x, dim, mesh)
