"""Configuration dataclasses — a copy of srsem/core/config.py.

The PyTorch port keeps its own copy (``import srsem`` pulls in JAX) with
the same dataclasses and field names, so one config means the same model
in both packages.  The CLI overrides fields with ``--set key=value``
flags (srsem_torch/cli/main.py).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Mapping, Optional, Sequence, Tuple, Union


@dataclass(frozen=True)
class BackboneConfig:
    """Frozen feature-pyramid backbone.

    ``kind`` selects the architecture:

    * ``"resnet50_clip"`` — OpenAI CLIP's modified ResNet-50 (3-conv stem,
      avg-pool anti-aliased downsampling, attention-pool head).  Mirrors the
      reference's ``timm.create_model("resnet50_clip.openai")``
      (reference: models/global_eval_models.py:315).
    * ``"resnet50"`` — ImageNet ResNet-50 (7x7 stem, max-pool, GAP+fc head).
      Mirrors ``timm.create_model("resnet50")``
      (reference: models/global_eval_models.py:695-698).
    * ``"vit_clip"`` — CLIP ViT-B/16 visual tower, per-block residual-branch
      ("ls2") taps (reference: models/global_eval_models.py:19).
    """

    kind: str = "resnet50"
    image_size: int = 224
    # Compute dtype for the frozen tower.  bfloat16 keeps the MXU fed;
    # params always stay float32.
    compute_dtype: str = "bfloat16"
    # ViT-only fields.
    vit_patch: int = 16
    vit_width: int = 768
    vit_depth: int = 12
    vit_heads: int = 12

    @property
    def is_vit(self) -> bool:
        return self.kind.startswith("vit")

    @property
    def stage_channels(self) -> Tuple[int, ...]:
        """Channel count of each residual stage's output (ResNet kinds)."""
        return (256, 512, 1024, 2048)

    @property
    def stem_channels(self) -> int:
        """Channels of the stem tap (stem.conv3 for CLIP / conv1 for ImageNet)."""
        return 64


@dataclass(frozen=True)
class GlobalModelConfig:
    """Global pair-scoring regressor ("CLIP-LPIPS").

    ``head`` selects one of the reference's eight variants
    (reference: models/global_eval_models.py — see SURVEY.md §2.1):

    * ``"stages_cnn"``     — per-stage 1x1-conv heads on squared feature
      diffs, spatial+layer mean, final ReLU (the flagship;
      reference: models/global_eval_models.py:308-429).
    * ``"wperlay_cnn"``    — one 1x1-conv head per tapped bottleneck block
      (reference: models/global_eval_models.py:815-914).
    * ``"stages_cnn_pooling"`` — per-stage GAP of absolute features, concat
      A and B, MLP 2056→1028→512→1
      (reference: models/global_eval_models.py:431-564).
    * ``"emb_lin"``        — final-embedding-only MLP 2048→1028→512→1
      (reference: models/global_eval_models.py:566-680).
    * ``"single_lin_vit"`` / ``"stages_vit"`` / ``"wperlay_vit"`` — ViT-token
      linear heads (reference: models/global_eval_models.py:6-305).
    """

    backbone: BackboneConfig = field(default_factory=BackboneConfig)
    head: str = "stages_cnn"
    # Number of deepest stages/blocks tapped; the reference sweeps depth in
    # {1,2,3} (reference: CLIPLPIPS_REG_training_sweep_example.py:110-113).
    depth: int = 3
    # Fine-tune the encoder too (reference ``enc_ft`` flag,
    # models/global_eval_models.py:316-321).
    enc_ft: bool = False
    # Fresh-init distribution of the scoring-head BIAS:
    # * "live"  — constant +0.01 (default): squared-diff head inputs are
    #   nonnegative, so under torch's symmetric default a fresh head has a
    #   ~50% chance of a dead final ReLU; +0.01 sits inside torch's own
    #   U(±1/√fan_in) range but on the live side.
    # * "torch" — torch's Conv2d/Linear default U(±1/√fan_in) verbatim
    #   (the reference heads never call init_weights →
    #   reference: models/global_eval_models.py:361-369 get torch defaults),
    #   so a from-scratch srsem sweep samples the reference's init
    #   distribution exactly.
    # Converter-initialized models never consult this.
    head_bias_init: str = "live"


@dataclass(frozen=True)
class LocalModelConfig:
    """Local map model ("CLU" — frozen backbone + trained UNet decoder).

    ``v2`` adds the pixel-space squared-error channel concatenated at every
    decoder level (reference: models/local_eval_models.py:343-514).
    ``lora_rank``: None = frozen backbone, int = LoRA rank, "full" =
    full fine-tune (reference: models/local_eval_models.py:17-24).
    """

    backbone: BackboneConfig = field(default_factory=lambda: BackboneConfig(kind="resnet50_clip"))
    v2: bool = False
    lora_rank: Optional[Union[int, str]] = None
    # Decoder conv/upsample compute dtype: "float32" is the torch-parity
    # default; "bfloat16" is the serving mode (measured faster on v5e,
    # BENCH_NOTES.md round 2; maps agree to ~1e-2).
    decoder_dtype: str = "float32"
    # Dtype of the returned map (sigmoid always computed in f32).
    # "bfloat16" halves the output buffer and its host delivery — the
    # dominant cost of full-map serving at 512px (BENCH_NOTES r5); map
    # values round to bf16's ~3 significant digits.
    output_dtype: str = "float32"

    @property
    def full_finetune(self) -> bool:
        return self.lora_rank == "full"


@dataclass(frozen=True)
class MeshConfig:
    """Device mesh. A single data axis is the warranted layout for these
    ~25M-param models (SURVEY.md §2.9); ``model_axis`` > 1 additionally
    shards conv channels for the (optional) tensor-parallel path exercised
    by ``dryrun_multichip``."""

    data_axis: int = -1  # -1 = all devices
    model_axis: int = 1

    def resolved_data_axis(self, n_devices: int) -> int:
        if self.data_axis == -1:
            return max(1, n_devices // self.model_axis)
        return self.data_axis


@dataclass(frozen=True)
class TrainConfig:
    """Training-loop hyperparameters.

    Defaults mirror the reference sweeps: global regressor — Adam 1e-4,
    batch 5, 30 epochs (reference: CLIPLPIPS_REG_training_sweep_example.py:
    110-113,169); CLU — batch 80, 60 epochs
    (reference: CLU_training_sweep_example.py:81-89,148).
    """

    lr: float = 1e-4
    batch_size: int = 5
    epochs: int = 30
    seed: int = 42  # split seed (reference: CLIPLPIPS_REG_training_sweep_example.py:155)
    val_fraction: float = 0.2
    mesh: MeshConfig = field(default_factory=MeshConfig)
    checkpoint_dir: Optional[str] = None
    # Retention: keep the newest N per-epoch checkpoints.  Default None =
    # keep all, matching the reference's per-epoch torch.save behavior
    # (CLIPLPIPS_REG_training_sweep_example.py:95) so older epochs stay
    # restorable for rollback/comparison; pass --set
    # checkpoint_keep_last=N to bound disk use (resume needs only the
    # latest).
    checkpoint_keep_last: Optional[int] = None
    log_every: int = 1  # batches between metric-writer calls
    # Loss-label binarization threshold for cosine maps; None = raw maps
    # (reference: datasets/local_eval_torch_ds.py:35-37).
    map_threshold: Optional[float] = None


def override(cfg: Any, overrides: Mapping[str, Any]) -> Any:
    """Return a copy of a (possibly nested) frozen dataclass with
    dotted-path overrides applied, e.g. ``{"backbone.kind": "resnet50"}``."""
    updates: dict = {}
    nested: dict = {}
    for key, value in overrides.items():
        if "." in key:
            head, rest = key.split(".", 1)
            nested.setdefault(head, {})[rest] = value
        else:
            updates[key] = value
    for head, sub in nested.items():
        updates[head] = override(getattr(cfg, head), sub)
    return dataclasses.replace(cfg, **updates)


def grid(base: Any, axes: Mapping[str, Sequence[Any]]):
    """Yield configs for the cartesian product of ``axes`` — the replacement
    for the reference's wandb grid sweeps
    (reference: CLIPLPIPS_REG_training_sweep_example.py:107-114)."""
    import itertools

    keys = list(axes)
    for values in itertools.product(*(axes[k] for k in keys)):
        yield override(base, dict(zip(keys, values)))
