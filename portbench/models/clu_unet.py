"""A CLU map configuration (``"model": "clu_unet"``): OpenAI CLIP's
ResNet-50 tower with the CLIP_lpips_Unet decoder, as the port builds it
(``make_local_model``) and as the plain reference computes it."""

from __future__ import annotations

import torch

from portbench.common import kernels
from portbench.models import count_flops, meta_state
from portbench.reference import heads, layout, lowprec, towers
from portbench.reference import train as ref_train


#: PairScorer's model_kind; the name of the number its outputs are
#: compared by: the decoder alone, from the program's own taps.  No whole
#: chain: its gap reads the bfloat16 tower's last-place flips, which the
#: decoder magnifies into a few hundredths of a map, within 3x of the
#: control's (PERF.md).
KIND = "local"
GAP = None
STAGE_GAP = "decoder_gap"
#: Decoder levels the decoder kernel runs.
KERNEL_LEVELS = (0, 1, 2)


def gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The worst map's mean absolute gap between two sets of (N, H, W)
    maps (values in [0, 1])."""
    return float((got - want).abs().mean(dim=(1, 2)).max())


def port_config(cfg: dict):
    from srsem_torch.config import BackboneConfig, LocalModelConfig

    p = cfg["port_config"]
    return LocalModelConfig(backbone=BackboneConfig(**p["backbone"]),
                            v2=p["v2"], decoder_dtype=p["decoder_dtype"],
                            output_dtype=p["output_dtype"])


def image_size(cfg: dict) -> int:
    return cfg["port_config"]["backbone"]["image_size"]


def tower_dtype(cfg: dict) -> str:
    return cfg["port_config"]["backbone"]["compute_dtype"]


def tap_names(cfg: dict):
    return heads.CLU_TAPS


def raw_layout(cfg: dict):
    if cfg["port_config"]["v2"]:
        raise ValueError("the reference decoder here is v1's")
    return layout.clip_resnet50(image_size(cfg)) + layout.clu_decoder()


def build(cfg: dict, sd: dict, device):
    """The port's model, on ``device``, holding the raw weights ``sd``."""
    from srsem_torch.models.local_models import make_local_model

    pcfg = port_config(cfg)
    model = make_local_model(pcfg, generator=torch.Generator().manual_seed(0))
    model.to(device).load_state_dict(sd, strict=True)
    return pcfg, model


def frozen_tower(model):
    """The training step's frozen tower over the port's model (NHWC
    images to ``(embedding, taps)``), as ``build_training`` makes it."""
    from srsem_torch.train.loop import frozen_tower as make

    return make(model.backbone, "resnet50_clip", True)


def settle(cfg: dict, sd: dict, xa, xb) -> None:
    """Set the decoder's BatchNorm running statistics to the batch
    statistics of the float32 reference on a sample of the traffic's
    normalized NCHW pairs, as a trained decoder's would match its inputs
    (random statistics leave the maps saturated)."""
    with torch.no_grad():
        ta, tb = towers.clip_taps(xa, sd), towers.clip_taps(xb, sd)
        heads.clu_maps(ta, tb, sd, train=True, momentum=1.0)


class Reference:
    """Plain maps from uint8 NHWC arrays: the tower at the configuration's
    precision (a bfloat16 tower's rounding points, ``towers.py``), the
    decoder in float32 with TF32 off; ``control`` names a control of
    ``lowprec.CONTROLS`` computed in the program's place."""

    mean, std = heads.CLIP_MEAN, heads.CLIP_STD

    def __init__(self, cfg: dict, sd: dict, control=None):
        self.sd = sd
        self.prec = lowprec.Precision(tower_dtype(cfg), control)

    def tower(self, x: torch.Tensor):
        """Taps of normalized NCHW images."""
        return towers.clip_taps(x, self.sd, rounding=self.prec.tower)

    def taps(self, x_u8: torch.Tensor):
        return self.tower(towers.normalize(x_u8, self.mean, self.std))

    def head(self, taps_a, taps_b):
        with self.prec.head_ctx():
            return heads.clu_maps(taps_a, taps_b, self.sd, q=self.prec.head_q)

    def train(self, batches, lr: float, fault=None, start=None) -> dict:
        """Adam steps on ``((taps_a, taps_b), y, mask)`` batches, from the
        raw weights or from ``start``."""
        return ref_train.train_steps(self.sd, batches, lr,
                                     decoder_ctx=self.prec.head_ctx,
                                     q=self.prec.head_q, fault=fault,
                                     start=start)


def flops(cfg: dict) -> dict:
    """Model FLOPs of one image's tower pass, of one pair's decode, and of
    one pair's decode forward and backward in training (the decoder is
    what trains), by the dtype the configuration states for each."""
    size = image_size(cfg)
    sd = meta_state(raw_layout(cfg))
    ref = Reference(cfg, sd)
    x = torch.zeros(1, size, size, 3, dtype=torch.uint8, device="meta")
    tower, taps = count_flops(lambda: ref.taps(x))
    decode, _ = count_flops(lambda: ref.head(taps, taps))
    params = [sd[k].requires_grad_(True) for k in ref_train.trainable_keys(sd)]

    def step():
        maps = heads.clu_maps(taps, taps, sd, train=True)
        return torch.autograd.grad(maps.sum(), params)

    trained, _ = count_flops(step)
    dec = cfg["port_config"]["decoder_dtype"]
    return {"tower": (tower_dtype(cfg), tower), "pair": (dec, decode),
            "train_pair": (dec, trained)}


def kernel_work(cfg: dict, passes, pairs: int, decodes: bool) -> dict:
    """Each kernel's work items in one call: the tower's stride-1 blocks
    over ``passes`` images each, and where the call ``decodes`` (serving,
    not training) the decoder levels the kernel runs over ``pairs``."""
    size = image_size(cfg)
    out = {"fused_bottleneck": kernels.resnet50_blocks(
        passes, size, layout.STAGE_BLOCKS, layout.STAGE_CHANNELS,
        tower_dtype(cfg))}
    if decodes:
        ch, dec = layout.LEVEL_CHANNELS, cfg["port_config"]["decoder_dtype"]
        out["fused_decoder"] = [
            kernels.decoder_level(pairs, size // 2 ** (lvl + 1), ch[lvl],
                                  ch[lvl + 1], *((64, 1, 1) if lvl == 0
                                                 else (ch[lvl], ch[lvl], 3)),
                                  dec)
            for lvl in KERNEL_LEVELS]
    return out
