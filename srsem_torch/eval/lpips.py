"""LPIPS v0.1 — the port of srsem/eval/lpips.py.

Zhang et al.'s learned metric, pyiqa's default: a frozen AlexNet (or
VGG16) feature tower, per-stage channelwise unit normalization, squared
feature differences, learned non-negative 1x1 convolutions to a scalar per
stage, a spatial mean, and a sum over stages.  Both images run through the
tower as one 2N batch.

The module keeps the official layouts natively: its tower is torchvision's
``features`` Sequential (``features.N.weight`` / ``.bias``) and each
stage's learned weights are lpips' ``lin{k}.model.1.weight`` (OIHW, no
bias), so the torchvision and lpips ``.pth`` files load straight into
:class:`LPIPS` (``load_lpips`` also takes lpips' other key spellings).
``load_jax_lpips`` loads the JAX package's param tree (HWIO → OIHW), and
``convert_lpips`` writes that tree from the ``.pth`` files (``convert
--kind lpips``).

Without weights the metric draws its own from a seeded ``torch.Generator``
(LeCun-normal kernels, zero biases), not the JAX package's
``PRNGKey(0)`` init: the two random metrics differ.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from srsem_torch.device import DeviceLike, resolve_device
from srsem_torch.ops.image import resize_bilinear

Tensor = torch.Tensor

# v0.1 input scaling layer constants (RGB, applied after mapping to [-1,1]).
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

ALEX_CHANNELS = (64, 192, 384, 256, 256)
VGG16_CHANNELS = (64, 128, 256, 512, 512)

# torchvision ``features`` indices of the conv layers, in order, and of the
# ReLUs whose outputs are the five taps.
_ALEX_FEATURE_IDX = (0, 3, 6, 8, 10)
_VGG16_FEATURE_IDX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
_TAP_IDX = {"alex": (1, 4, 7, 9, 11), "vgg": (3, 8, 15, 22, 29)}


def _alexnet_layers() -> list:
    """torchvision ``alexnet().features``."""
    return [nn.Conv2d(3, 64, 11, 4, 2), nn.ReLU(),
            nn.MaxPool2d(3, 2),
            nn.Conv2d(64, 192, 5, padding=2), nn.ReLU(),
            nn.MaxPool2d(3, 2),
            nn.Conv2d(192, 384, 3, padding=1), nn.ReLU(),
            nn.Conv2d(384, 256, 3, padding=1), nn.ReLU(),
            nn.Conv2d(256, 256, 3, padding=1), nn.ReLU(),
            nn.MaxPool2d(3, 2)]


def _vgg16_layers() -> list:
    """torchvision ``vgg16().features``."""
    layers, cin = [], 3
    for ch, n in ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3)):
        if layers:
            layers.append(nn.MaxPool2d(2, 2))
        for _ in range(n):
            layers += [nn.Conv2d(cin, ch, 3, padding=1), nn.ReLU()]
            cin = ch
    layers.append(nn.MaxPool2d(2, 2))
    return layers


class _Features(nn.Sequential):
    """A torchvision ``features`` trunk (its state-dict keys ``N.weight`` /
    ``N.bias``) returning the five post-ReLU taps from NCHW images; max
    pools floor, as ``nn.max_pool``'s VALID windows do."""

    def __init__(self, net: str):
        super().__init__(*(_alexnet_layers() if net == "alex"
                           else _vgg16_layers()))
        self.net = net

    def forward(self, x: Tensor) -> Tuple[Tensor, ...]:
        taps, idx = [], _TAP_IDX[self.net]
        for i, layer in enumerate(self):
            x = layer(x)
            if i in idx:
                taps.append(x)
            if i == idx[-1]:
                break
        return tuple(taps)


class AlexNetFeatures(_Features):
    """torchvision AlexNet ``features``: relu1..relu5 taps."""

    def __init__(self):
        super().__init__("alex")


class VGG16Features(_Features):
    """torchvision VGG16 ``features``: relu{1_2,2_2,3_3,4_3,5_3} taps."""

    def __init__(self):
        super().__init__("vgg")


class NetLinLayer(nn.Module):
    """lpips' learned 1x1 conv to one channel (``model.1.weight``; the
    dropout at ``model.0`` is off in eval)."""

    def __init__(self, channels: int):
        super().__init__()
        self.model = nn.Sequential(nn.Dropout(0.0),
                                   nn.Conv2d(channels, 1, 1, bias=False))

    def forward(self, x: Tensor) -> Tensor:
        return self.model(x)


class LPIPS(nn.Module):
    """LPIPS v0.1 distance of [0,1]-range NHWC image pairs → (N,), or with
    ``spatial`` per-pixel maps bilinearly upsampled to the input size and
    summed over stages → (N, H, W)."""

    def __init__(self, net: str = "alex", spatial: bool = False):
        super().__init__()
        if net not in ("alex", "vgg"):
            raise ValueError(f"unknown LPIPS net {net!r}")
        self.net, self.spatial = net, spatial
        self.chans = ALEX_CHANNELS if net == "alex" else VGG16_CHANNELS
        self.features = AlexNetFeatures() if net == "alex" else VGG16Features()
        for k, ch in enumerate(self.chans):
            self.add_module(f"lin{k}", NetLinLayer(ch))
        self.register_buffer("shift", torch.tensor(_SHIFT).view(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE).view(1, 3, 1, 1),
                             persistent=False)

    def forward(self, x0: Tensor, x1: Tensor) -> Tensor:
        n, h, w = x0.shape[:3]
        x = torch.cat([x0, x1], dim=0).float().permute(0, 3, 1, 2)
        # [0,1] → [-1,1], then the v0.1 scaling layer.
        x = (2.0 * x - 1.0 - self.shift) / self.scale
        total = None
        for k, tap in enumerate(self.features(x)):
            f = tap.float()
            f = f * torch.rsqrt((f * f).sum(dim=1, keepdim=True) + 1e-10)
            d = getattr(self, f"lin{k}")((f[:n] - f[n:]) ** 2)
            if self.spatial:
                d = resize_bilinear(d.permute(0, 2, 3, 1), (h, w))[..., 0]
            else:
                d = d.mean(dim=(1, 2, 3))
            total = d if total is None else total + d
        return total

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """LeCun-normal conv kernels and zero biases from ``generator``."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Conv2d):
                    m.weight.normal_(0.0, m.weight[0].numel() ** -0.5,
                                     generator=generator)
                    if m.bias is not None:
                        m.bias.zero_()
        return self


def _lin_weight(lin_sd: Mapping[str, Any], k: int):
    for key in (f"lin{k}.model.1.weight", f"lins.{k}.model.1.weight",
                f"lin{k}.weight"):
        if key in lin_sd:
            return lin_sd[key]
    raise KeyError(f"lin{k} weight not found in lpips state dict")


def _tower_sd(tower_sd: Mapping[str, Any]) -> Dict[str, Any]:
    """torchvision/lpips tower keys → ``features.N.*`` (a ``net.`` or
    ``module.`` prefix dropped, the classifier left out)."""
    sd = {k.replace("net.", "").replace("module.", ""): v
          for k, v in tower_sd.items()}
    return {k: v for k, v in sd.items() if k.startswith("features.")}


def load_lpips(model: LPIPS, lin_sd: Mapping[str, Any],
               tower_sd: Optional[Mapping[str, Any]] = None) -> LPIPS:
    """The official files into ``model``: lpips' lin weights
    (``lin{k}.model.1.weight``, ``lins.{k}.model.1.weight`` or
    ``lin{k}.weight``) and, when given, a torchvision ``alexnet`` /
    ``vgg16`` state dict for the tower.  Returns ``model``."""
    sd = {f"lin{k}.model.1.weight": torch.as_tensor(_lin_weight(lin_sd, k))
          for k in range(len(model.chans))}
    if tower_sd is not None:
        sd.update({k: torch.as_tensor(v) for k, v in _tower_sd(tower_sd).items()})
    missing, unexpected = model.load_state_dict(sd, strict=False)
    if unexpected or (tower_sd is not None and missing):
        raise KeyError(f"LPIPS weights: missing {missing}, unexpected "
                       f"{unexpected}")
    return model


def _jax_paths(model: LPIPS) -> Dict[str, Tuple[str, ...]]:
    """Each state-dict key of ``model`` → its path in the JAX package's
    LPIPS param tree: ``lin{k}.model.1.weight`` → ``lin{k}/kernel``,
    ``features.N.weight`` / ``.bias`` → ``tower/conv*/kernel`` / ``bias``
    (kernels OIHW here, HWIO there)."""
    paths = {f"lin{k}.model.1.weight": (f"lin{k}", "kernel")
             for k in range(len(model.chans))}
    convs = _ALEX_FEATURE_IDX if model.net == "alex" else _VGG16_FEATURE_IDX
    for j, fi in enumerate(convs):
        name = f"conv{j + 1}" if model.net == "alex" else f"conv{j}"
        paths[f"features.{fi}.weight"] = ("tower", name, "kernel")
        paths[f"features.{fi}.bias"] = ("tower", name, "bias")
    return paths


def load_jax_lpips(model: LPIPS, params: Mapping[str, Any]) -> LPIPS:
    """The JAX package's LPIPS param tree (``tower/conv*`` HWIO kernels and
    biases, ``lin{k}/kernel`` (1, 1, C, 1)) into ``model``, strictly."""
    sd = {}
    for key, path in _jax_paths(model).items():
        value = params
        for name in path:
            value = value[name]
        t = torch.from_numpy(np.array(value, np.float32))
        sd[key] = t.permute(3, 2, 0, 1) if t.ndim == 4 else t
    model.load_state_dict(sd, strict=True)
    return model


def convert_lpips(lin_sd: Mapping[str, Any],
                  tower_sd: Optional[Mapping[str, Any]] = None,
                  net: str = "alex") -> Dict:
    """The official lpips lin file and a torchvision tower state dict →
    the JAX package's LPIPS param tree (float32 numpy, HWIO kernels; the
    lins alone without ``tower_sd``), as srsem/eval/lpips.py::
    convert_lpips builds it: the files loaded into an :class:`LPIPS`
    (``load_lpips``), then its weights along ``_jax_paths``."""
    model = load_lpips(LPIPS(net), lin_sd, tower_sd)
    own = model.state_dict()
    tree: Dict[str, Any] = {}
    for key, path in _jax_paths(model).items():
        if path[0] == "tower" and tower_sd is None:
            continue
        value = own[key].numpy()
        node = tree
        for name in path[:-1]:
            node = node.setdefault(name, {})
        node[path[-1]] = (value.transpose(2, 3, 1, 0) if value.ndim == 4
                          else value)
    return tree


def make_lpips(net: str = "alex", params: Optional[Mapping[str, Any]] = None,
               spatial: bool = False, device: DeviceLike = None,
               lin_sd: Optional[Mapping[str, Any]] = None,
               tower_sd: Optional[Mapping[str, Any]] = None):
    """A ``(gt, ev) -> (N,)`` distance (NHWC [0,1] tensors or arrays; the
    result on the metric's device) over an eval-mode LPIPS: ``params`` a
    JAX tree (``convert_lpips``), or ``lin_sd`` (and ``tower_sd``) the
    official ``.pth`` files; without either, weights seeded with 0."""
    dev = resolve_device(device)
    model = LPIPS(net, spatial).reset_parameters(
        torch.Generator().manual_seed(0))
    if params is not None:
        load_jax_lpips(model, params)
    elif lin_sd is not None:
        load_lpips(model, lin_sd, tower_sd)
    model = model.eval().to(dev)

    @torch.no_grad()
    def lpips(gt, ev) -> Tensor:
        return model(torch.as_tensor(gt, device=dev),
                     torch.as_tensor(ev, device=dev))

    lpips.model = model
    return lpips
