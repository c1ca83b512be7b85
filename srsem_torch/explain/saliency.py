"""TranSalNet-Dense saliency predictor and saliency losses — the port of
srsem/explain/saliency.py.

* ``DenseNet161Features`` — DenseNet-161 (growth 48, blocks of 6/12/36/24
  layers) tapped after denseblocks 2/3/4: 768 / 2112 / 2208 channels at
  strides 8 / 16 / 32;
* ``TransEncoder`` — a 1x1 projection to tokens, a learned ``(1, h*w,
  hidden)`` positional table (so its shape is fixed by the input size),
  two pre-LN blocks (LayerNorm eps 1e-6, the fused ``attn_qkv`` split as
  ``(3, heads, head_dim)`` in q, k, v order, exact GELU) and a final norm;
* ``TranSalNetDense`` — three encoders (768, 12), (768, 12), (512, 8) and
  the multiplicative top-down decoder: d1-d6 conv3x3+BN+ReLU with nearest
  x2 upsampling, then ``d7_conv`` and a sigmoid;
* the losses (CC / KL-div / SIM / NSS), batched over the leading axis;
* ``preprocess_pad`` / ``postprocess_crop`` — the reference's
  aspect-preserving pad and crop-back, in numpy;
* ``generate_saliency_maps`` — the ``SaliencyMaps/`` folder job.

Everything runs in float32, as in JAX.  The module names are the JAX
tree's (``encoder.denseblock1.denselayer1.norm1``, ``TransEncoder1.layer0.
attn_qkv``, ``d1_conv``, ``d1_bn``, ...), so
srsem_torch/utils/convert.py::load_transalnet carries ``convert --kind
transalnet``'s tree straight in.  BatchNorm follows srsem/ops/batchnorm.py
(``TorchBatchNorm``), which is ``nn.BatchNorm2d``: ``forward(x,
train=True)`` normalizes with the batch's biased variance and updates the
running statistics with momentum 0.1 and the unbiased variance.

Public modules keep the JAX layout (NHWC in, NHWC taps and tokens out);
the convolutions run on NCHW tensors, the taps are NHWC views of them.
"""

from __future__ import annotations

import json
import math
import os
import sys
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from srsem_torch.device import DeviceLike, resolve_device
from srsem_torch.models.local_models import _batch_norm
from srsem_torch.ops.npimage import resize_bilinear_np

Tensor = torch.Tensor


def _nchw(x: Tensor) -> Tensor:
    """A contiguous NCHW tensor: cuDNN's float32 convolutions and BNs on a
    channels-last view transpose it first, at every layer."""
    return x.permute(0, 3, 1, 2).contiguous()


def _nhwc(x: Tensor) -> Tensor:
    return x.permute(0, 2, 3, 1)


# ---------------- DenseNet-161 encoder ----------------------------------

class DenseLayer(nn.Module):
    def __init__(self, in_ch: int, growth: int = 48):
        super().__init__()
        self.norm1 = nn.BatchNorm2d(in_ch)
        self.conv1 = nn.Conv2d(in_ch, 4 * growth, 1, bias=False)
        self.norm2 = nn.BatchNorm2d(4 * growth)
        self.conv2 = nn.Conv2d(4 * growth, growth, 3, padding=1, bias=False)

    def forward(self, x: Tensor, train: bool) -> Tensor:
        h = self.conv1(F.relu(_batch_norm(x, self.norm1, train)))
        h = self.conv2(F.relu(_batch_norm(h, self.norm2, train)))
        return torch.cat([x, h], dim=1)


class DenseBlock(nn.Module):
    def __init__(self, layers: int, in_ch: int, growth: int = 48):
        super().__init__()
        for i in range(layers):
            self.add_module(f"denselayer{i + 1}",
                            DenseLayer(in_ch + i * growth, growth))

    def forward(self, x: Tensor, train: bool) -> Tensor:
        for layer in self.children():
            x = layer(x, train)
        return x


class Transition(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.norm = nn.BatchNorm2d(in_ch)
        self.conv = nn.Conv2d(in_ch, out_ch, 1, bias=False)

    def forward(self, x: Tensor, train: bool) -> Tensor:
        return F.avg_pool2d(self.conv(F.relu(_batch_norm(x, self.norm, train))),
                            2, 2)


class DenseNet161Features(nn.Module):
    """NHWC images → the three tapped NHWC maps (768/2112/2208 ch)."""

    def __init__(self):
        super().__init__()
        self.conv0 = nn.Conv2d(3, 96, 7, 2, 3, bias=False)
        self.norm0 = nn.BatchNorm2d(96)
        self.denseblock1 = DenseBlock(6, 96)            # 384
        self.transition1 = Transition(384, 192)
        self.denseblock2 = DenseBlock(12, 192)          # 768
        self.transition2 = Transition(768, 384)
        self.denseblock3 = DenseBlock(36, 384)          # 2112
        self.transition3 = Transition(2112, 1056)
        self.denseblock4 = DenseBlock(24, 1056)         # 2208

    def forward(self, x: Tensor, train: bool = False
                ) -> Tuple[Tensor, Tensor, Tensor]:
        x = F.relu(_batch_norm(self.conv0(_nchw(x.float())), self.norm0, train))
        x = F.max_pool2d(x, 3, 2, 1)
        x = self.transition1(self.denseblock1(x, train), train)
        x3 = self.denseblock2(x, train)
        x4 = self.denseblock3(self.transition2(x3, train), train)
        x5 = self.denseblock4(self.transition3(x4, train), train)
        return _nhwc(x3), _nhwc(x4), _nhwc(x5)


def feature_grids(image_size: Tuple[int, int]):
    """The (h, w) grids of the three taps for an ``image_size`` input:
    conv0 (7x7, stride 2, pad 3), the max pool (3, 2, pad 1), then one
    floor halving a transition."""
    def down(n: int) -> int:
        n = (n - 1) // 2 + 1          # conv0
        n = (n - 1) // 2 + 1          # max pool
        return n // 2                 # transition1
    h3, w3 = (down(n) for n in image_size)
    return (h3, w3), (h3 // 2, w3 // 2), (h3 // 4, w3 // 4)


# ---------------- Transformer encoders ----------------------------------

class SaliencyTransBlock(nn.Module):
    def __init__(self, hidden: int, heads: int):
        super().__init__()
        self.heads = heads
        self.attention_norm = nn.LayerNorm(hidden, eps=1e-6)
        self.attn_qkv = nn.Linear(hidden, 3 * hidden)
        self.attn_out = nn.Linear(hidden, hidden)
        self.ffn_norm = nn.LayerNorm(hidden, eps=1e-6)
        self.ffn_fc1 = nn.Linear(hidden, 4 * hidden)
        self.ffn_fc2 = nn.Linear(4 * hidden, hidden)

    def forward(self, x: Tensor) -> Tensor:
        n, t, c = x.shape
        hd = c // self.heads
        qkv = self.attn_qkv(self.attention_norm(x)).reshape(
            n, t, 3, self.heads, hd)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        attn = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(hd), dim=-1)
        h = (attn @ v).transpose(1, 2).reshape(n, t, c)
        x = x + self.attn_out(h)
        h = F.gelu(self.ffn_fc1(self.ffn_norm(x)))
        return x + self.ffn_fc2(h)


class TransEncoder(nn.Module):
    """NHWC ``(n, h, w, in_ch)`` → NHWC ``(n, h, w, hidden)`` for the
    ``grid`` = (h, w) its positional table was made for."""

    def __init__(self, in_ch: int, hidden: int, heads: int,
                 grid: Tuple[int, int], layers: int = 2):
        super().__init__()
        self.patch_embeddings = nn.Conv2d(in_ch, hidden, 1)
        self.position_embeddings = nn.Parameter(
            torch.zeros(1, grid[0] * grid[1], hidden))
        for i in range(layers):
            self.add_module(f"layer{i}", SaliencyTransBlock(hidden, heads))
        self.encoder_norm = nn.LayerNorm(hidden, eps=1e-6)
        self.layers = layers

    def forward(self, x: Tensor) -> Tensor:
        n, h, w, _ = x.shape
        tokens = _nhwc(self.patch_embeddings(_nchw(x))).reshape(n, h * w, -1)
        tokens = tokens + self.position_embeddings
        for i in range(self.layers):
            tokens = getattr(self, f"layer{i}")(tokens)
        return self.encoder_norm(tokens).reshape(n, h, w, -1)


# ---------------- Full model --------------------------------------------

def _upsample_nearest_x2(x: Tensor) -> Tensor:
    return F.interpolate(x, scale_factor=2, mode="nearest")


class TranSalNetDense(nn.Module):
    """NHWC ``(N, H, W, 3)`` → ``(N, H', W')`` saliency map in [0, 1]
    (H' = H at the reference's 288x384 input, the default
    ``image_size``, which fixes the positional tables' shapes)."""

    DECODER = ((768, 768), (768, 512), (512, 256), (256, 128), (128, 64),
               (64, 32))

    def __init__(self, image_size: Tuple[int, int] = (288, 384)):
        super().__init__()
        self.image_size = tuple(image_size)
        g3, g4, g5 = feature_grids(self.image_size)
        self.encoder = DenseNet161Features()
        self.TransEncoder1 = TransEncoder(2208, 768, 12, g5)
        self.TransEncoder2 = TransEncoder(2112, 768, 12, g4)
        self.TransEncoder3 = TransEncoder(768, 512, 8, g3)
        for k, (cin, cout) in enumerate(self.DECODER, start=1):
            self.add_module(f"d{k}_conv", nn.Conv2d(cin, cout, 3, padding=1))
            self.add_module(f"d{k}_bn", nn.BatchNorm2d(cout))
        self.d7_conv = nn.Conv2d(32, 1, 3, padding=1)

    def _conv_bn_relu(self, h: Tensor, k: int, train: bool) -> Tensor:
        h = getattr(self, f"d{k}_conv")(h)
        return F.relu(_batch_norm(h, getattr(self, f"d{k}_bn"), train))

    def forward(self, x: Tensor, train: bool = False) -> Tensor:
        x3, x4, x5 = self.encoder(x, train)
        h = self._conv_bn_relu(_nchw(self.TransEncoder1(x5)), 1, train)
        h = _upsample_nearest_x2(h)
        h = F.relu(h * _nchw(self.TransEncoder2(x4)))
        h = _upsample_nearest_x2(self._conv_bn_relu(h, 2, train))
        h = F.relu(h * _nchw(self.TransEncoder3(x3)))
        for k in (3, 4, 5):
            h = _upsample_nearest_x2(self._conv_bn_relu(h, k, train))
        h = self.d7_conv(self._conv_bn_relu(h, 6, train))
        return torch.sigmoid(h[:, 0])

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Fresh weights with Flax's initializers' distributions, from
        ``generator``: LeCun-normal (truncated at two deviations) conv and
        Linear kernels, zero biases and positional tables, unit
        LayerNorms, BN scale 1 / bias 0 / mean 0 / var 1."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (nn.Conv2d, nn.Linear)):
                    # Flax's truncated normal keeps the variance: / .8796.
                    std = (1.0 / math.sqrt(m.weight[0].numel())
                           / .87962566103423978)
                    nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std,
                                          2 * std, generator=generator)
                    if m.bias is not None:
                        m.bias.zero_()
                elif isinstance(m, (nn.LayerNorm, nn.BatchNorm2d)):
                    m.reset_parameters()
                elif isinstance(m, TransEncoder):
                    m.position_embeddings.zero_()
        return self


# ---------------- Losses -------------------------------------------------

_EPS = 2.2204e-16
_HW = (-2, -1)


def loss_kldiv(pred: Tensor, gt: Tensor) -> Tensor:
    """Per-map KL divergence after normalizing both to distributions
    (reference loss_function.py:35-40).  Batched: (N, H, W) → (N,)."""
    p = pred / pred.sum(dim=_HW, keepdim=True)
    g = gt / gt.sum(dim=_HW, keepdim=True)
    return torch.sum(g * torch.log(_EPS + g / (p + _EPS)), dim=_HW)


def loss_cc(pred: Tensor, gt: Tensor) -> Tensor:
    """Pearson correlation coefficient (reference :43-47)."""
    p = pred - pred.mean(dim=_HW, keepdim=True)
    g = gt - gt.mean(dim=_HW, keepdim=True)
    num = torch.sum(p * g, dim=_HW)
    den = torch.sqrt(torch.sum(p * p, dim=_HW) * torch.sum(g * g, dim=_HW))
    return num / (den + _EPS)


def loss_similarity(pred: Tensor, gt: Tensor) -> Tensor:
    """Histogram intersection of min-max-normalized distributions
    (reference :50-60)."""
    def norm(m):
        lo = m.amin(dim=_HW, keepdim=True)
        hi = m.amax(dim=_HW, keepdim=True)
        m = (m - lo) / (hi - lo + _EPS)
        return m / (m.sum(dim=_HW, keepdim=True) + _EPS)

    return torch.sum(torch.minimum(norm(pred), norm(gt)), dim=_HW)


def loss_nss(pred: Tensor, fixation: Tensor) -> Tensor:
    """Normalized scanpath saliency vs a binary fixation map
    (reference :63-69)."""
    mu = pred.mean(dim=_HW, keepdim=True)
    sd = pred.std(dim=_HW, keepdim=True, correction=0)
    z = (pred - mu) / (sd + _EPS)
    mask = (fixation > 0).float()
    return torch.sum(z * mask, dim=_HW) / (mask.sum(dim=_HW) + _EPS)


def saliency_loss(pred: Tensor, target: Tensor, loss_type: str = "cc"
                  ) -> Tensor:
    """Batch-mean dispatcher (reference SaliencyLoss, :6-32)."""
    fn = {"cc": loss_cc, "kldiv": loss_kldiv, "sim": loss_similarity,
          "nss": loss_nss}[loss_type]
    return torch.mean(fn(torch.as_tensor(pred), torch.as_tensor(target)))


# ---------------- Geometry (numpy) ---------------------------------------

def preprocess_pad(img: np.ndarray, target_hw: Tuple[int, int] = (288, 384),
                   pad_value: int = 1) -> np.ndarray:
    """Aspect-preserving resize + center pad into ``target_hw``, uint8
    (reference: additional_approaches/src/transalnet/utils/
    data_process.py:9-41), with its quirks: 3-channel pads fill with
    value 1, 1-channel with 0; the resized extent uses floor division; a
    trailing singleton channel ``(H, W, 1)`` is squeezed to the reference's
    2-D grayscale.  The resize is the half-pixel-center bilinear of
    srsem_torch/ops/npimage.py.  Channel order is the caller's."""
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    th, tw = target_hw
    h, w = img.shape[:2]
    if img.ndim == 2:
        padded = np.zeros((th, tw), np.uint8)
    else:
        padded = np.full((th, tw, img.shape[2]), pad_value, np.uint8)

    def _resize_u8(x, out_hw):
        r = resize_bilinear_np(x.astype(np.float32), out_hw)
        return np.clip(np.rint(r), 0, 255).astype(np.uint8)

    # The min() clamps are vestigial (floor division keeps the free
    # dimension inside) but kept, as the reference has them.
    if h / th > w / tw:
        new_cols = min((w * th) // h, tw)
        left = (tw - new_cols) // 2
        padded[:, left:left + new_cols] = _resize_u8(img, (th, new_cols))
    else:
        new_rows = min((h * tw) // w, th)
        top = (th - new_rows) // 2
        padded[top:top + new_rows] = _resize_u8(img, (new_rows, tw))
    return padded


def postprocess_crop(pred: np.ndarray,
                     source_hw: Tuple[int, int]) -> np.ndarray:
    """A model-resolution prediction back onto the source geometry
    (reference data_process.py:43-80): upscale until the source rectangle
    is covered, then center-crop the pad bands away; float32."""
    pred = np.asarray(pred, np.float32)
    if pred.ndim != 2:
        raise ValueError(f"expected a (H, W) map, got shape {pred.shape}")
    sh, sw = source_hw
    ph, pw = pred.shape
    if sh / ph > sw / pw:
        new_cols = (pw * sh) // ph
        r = resize_bilinear_np(pred, (sh, new_cols))
        left = (new_cols - sw) // 2
        return r[:, left:left + sw]
    new_rows = (ph * sw) // pw
    r = resize_bilinear_np(pred, (new_rows, sw))
    top = (new_rows - sh) // 2
    return r[top:top + sh, :]


def generate_saliency_maps(model: Callable[[Tensor], Tensor], image_dir: str,
                           out_dir: str, image_size=(288, 384),
                           exts=(".jpg", ".png"), geometry: str = "pad",
                           channel_order: str = "bgr",
                           device: DeviceLike = None) -> int:
    """Write ``SaliencyMaps`` .npy files for the images of ``image_dir``
    (consumed by srsem_torch/eval/approaches.py); skip-existing resumable.
    ``model``: a TranSalNetDense (moved to ``device``, default the card)
    or any callable from a ``(1, H, W, 3)`` float tensor in [0, 1] to a
    ``(1, H', W')`` map.

    ``geometry="pad"`` (default): ``preprocess_pad`` in, ``postprocess_crop``
    back to the SOURCE resolution; ``"resize"``: a distorting PIL bicubic
    resize to ``image_size``, maps saved at ``image_size``.
    ``channel_order="bgr"`` matches the reference's cv2.imread input.  The
    tree carries a ``.srsem_saliency_meta.json`` marker, and resuming with
    other flags raises rather than mixing geometries in one tree; an
    unmarked tree with maps in it resumes with a warning on stderr.  Stems
    keep their dots (``a.v1.jpg`` → ``a.v1.npy``)."""
    from PIL import Image

    if geometry not in ("pad", "resize"):
        raise ValueError(f"unknown geometry {geometry!r}")
    if channel_order not in ("bgr", "rgb"):
        raise ValueError(f"unknown channel_order {channel_order!r}")
    dev = resolve_device(device)
    if isinstance(model, nn.Module):
        model = model.to(dev)
    os.makedirs(out_dir, exist_ok=True)
    meta = {"geometry": geometry, "channel_order": channel_order,
            "image_size": list(image_size)}
    meta_path = os.path.join(out_dir, ".srsem_saliency_meta.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            prev = json.load(f)
        if prev != meta:
            raise ValueError(
                f"SaliencyMaps tree {out_dir!r} was generated with {prev}, "
                f"resuming with {meta} would mix map geometries in one "
                "tree — use a fresh out_dir or pass matching flags")
    else:
        existing = sum(f.endswith(".npy") for f in os.listdir(out_dir))
        if existing:
            print(f"saliency: warning: resuming an unmarked tree with "
                  f"{existing} existing maps; cannot verify they used "
                  f"geometry={geometry!r} channel_order={channel_order!r}",
                  file=sys.stderr, flush=True)
        with open(meta_path, "w") as f:
            json.dump(meta, f)

    def predict(arr: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            out = model(torch.from_numpy(np.ascontiguousarray(arr)).to(dev))
        return out[0].float().cpu().numpy()

    n = 0
    for name in sorted(os.listdir(image_dir)):
        if not name.endswith(exts):
            continue
        out_path = os.path.join(out_dir, name.rsplit(".", 1)[0] + ".npy")
        if os.path.exists(out_path):
            continue
        img = Image.open(os.path.join(image_dir, name)).convert("RGB")
        if geometry == "pad":
            src = np.asarray(img, np.uint8)
            if channel_order == "bgr":
                src = src[..., ::-1]
            arr = preprocess_pad(src, image_size).astype(np.float32)[None]
            arr /= 255.0
            sal = postprocess_crop(predict(arr), src.shape[:2])
        else:
            img = img.resize((image_size[1], image_size[0]), Image.BICUBIC)
            arr = np.asarray(img, np.float32)[None]
            if channel_order == "bgr":
                arr = arr[..., ::-1]
            sal = predict(arr / 255.0)
        np.save(out_path, np.ascontiguousarray(sal))
        n += 1
    return n
