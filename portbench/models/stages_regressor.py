"""A global regressor configuration (``"model": "stages_regressor"``): an
ImageNet ResNet-50 tower with the stages head, as the port builds it
(``make_global_model``) and as the plain reference computes it."""

from __future__ import annotations

import torch

from portbench.common import kernels
from portbench.models import count_flops, meta_state
from portbench.reference import heads, layout, lowprec, towers


#: PairScorer's model_kind; the names of the numbers its outputs are
#: compared by: the whole chain from the inputs, and the head alone from
#: the program's own taps.
KIND = "global"
GAP = "score_gap"
STAGE_GAP = "head_gap"


def gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The widest gap between two sets of scores, as a share of the
    reference's median magnitude."""
    return float((got - want).abs().max() / want.abs().median())


def port_config(cfg: dict):
    from srsem_torch.config import BackboneConfig, GlobalModelConfig

    p = cfg["port_config"]
    return GlobalModelConfig(backbone=BackboneConfig(**p["backbone"]),
                             head=p["head"], depth=p["depth"])


def image_size(cfg: dict) -> int:
    return cfg["port_config"]["backbone"]["image_size"]


def tower_dtype(cfg: dict) -> str:
    return cfg["port_config"]["backbone"]["compute_dtype"]


def tap_names(cfg: dict):
    return heads.stage_taps(cfg["port_config"]["depth"])


def raw_layout(cfg: dict):
    depth = cfg["port_config"]["depth"]
    return (layout.imagenet_resnet50()
            + layout.stages_head(layout.STAGE_CHANNELS[3 - depth:]))


def build(cfg: dict, sd: dict, device):
    """The port's model, on ``device``, holding the raw weights ``sd``."""
    from srsem_torch.models.global_models import make_global_model

    pcfg = port_config(cfg)
    model = make_global_model(pcfg, torch.Generator().manual_seed(0))
    model.to(device).load_state_dict(sd, strict=True)
    return pcfg, model


class Reference:
    """Plain scores from uint8 NHWC arrays: the tower at the
    configuration's precision (a bfloat16 tower's rounding points,
    ``towers.py``), the head in float32 with TF32 off; ``control`` names a
    control of ``lowprec.CONTROLS`` computed in the program's place."""

    mean, std = heads.IMAGENET_MEAN, heads.IMAGENET_STD

    def __init__(self, cfg: dict, sd: dict, control=None):
        self.sd = sd
        self.names = tap_names(cfg)
        self.prec = lowprec.Precision(tower_dtype(cfg), control)

    def taps(self, x_u8: torch.Tensor):
        x = towers.normalize(x_u8, self.mean, self.std)
        taps = towers.imagenet_taps(x, self.sd, rounding=self.prec.tower)
        return {k: taps[k] for k in self.names}

    def head(self, taps_a, taps_b):
        with self.prec.head_ctx():
            return heads.stages_scores(taps_a, taps_b, self.sd, self.names,
                                       q=self.prec.head_q)


def flops(cfg: dict) -> dict:
    """Model FLOPs of one image's tower pass and of one pair's head, by
    the dtype the configuration states for each."""
    size = image_size(cfg)
    sd = meta_state(raw_layout(cfg))
    ref = Reference(cfg, sd)
    x = torch.zeros(1, size, size, 3, dtype=torch.uint8, device="meta")
    tower, taps = count_flops(lambda: ref.taps(x))
    head, _ = count_flops(lambda: ref.head(taps, taps))
    return {"tower": (tower_dtype(cfg), tower), "pair": ("float32", head)}


def kernel_work(cfg: dict, passes, pairs: int, decodes: bool = True) -> dict:
    """Each kernel's work items in one call: the tower's stride-1 blocks
    over ``passes`` images each, and the stages head over their taps and
    ``pairs`` scores."""
    size, dt = image_size(cfg), tower_dtype(cfg)
    depth = cfg["port_config"]["depth"]
    taps = [(size // 4 // 2 ** s, layout.STAGE_CHANNELS[s])
            for s in range(3 - depth, 4)]
    return {"fused_bottleneck": kernels.resnet50_blocks(
                passes, size, layout.STAGE_BLOCKS, layout.STAGE_CHANNELS, dt),
            "fused_head": [kernels.stages_head(passes, pairs, taps, dt)]}
