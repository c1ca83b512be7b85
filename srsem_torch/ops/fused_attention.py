"""The attention core of a ViT block — from the qkv Linear's output to the
heads merged — in one launch of a hand-written Hopper kernel.

It replaces no TPU kernel: the JAX package leaves attention to XLA
(srsem/backbones/vit.py), and so did the port, in plain PyTorch
(``plain_attention``: two batched products, copies of q, k, v and of the
merged heads, the division, the float32 softmax and its cast; 46% of the
ViT regressor's device time).  The kernel (csrc/fused_attention.cu, CUDA
C++) reads the qkv output in place and writes the merged heads, nothing
else: bytes bound it, 77.5 MB a ViT-B/16 pass at batch 64 (23.1 us at
3.35 TB/s); the source says how its design meets that.  It keeps the
plain version's rounding points: the scores' product rounded to bf16,
divided by ``scale`` (the float32 reciprocal, as PyTorch divides by a
scalar on the card, which must be a bf16 value) and rounded again, the
softmax in float32 rounded to bf16, P·V rounded once.  Only the float32
sums run in another order.

* ``kernel_route(device_type, dtype, head_dim, tokens, needs_grad)`` — the
  rule: the kernel for bf16 on CUDA at head width 64 and at most 256
  tokens when no gradient is needed; ``attention_route(qkv, heads)``
  reads it off a qkv tensor.  ``ViTBlock.forward`` takes the kernel
  where it says "kernel", ``plain_attention`` elsewhere.
* ``fused_attention(qkv, heads, scale)`` — ``(N, T, 3W)`` → ``(N, T, W)``:
  the plain version for a CPU tensor; for any other the kernel where
  ``attention_route`` says "kernel", or it raises.  It counts its launches
  in ``.launches``.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from srsem_torch.ops import _build

Tensor = torch.Tensor

HEAD_DIM = 64     # csrc/fused_attention.cu kHeadDim: one 128-byte bf16 line
MAX_TOKENS = 256  # kMaxTokens: a row of scores in one warpgroup's registers


def kernel_route(device_type: str, dtype: torch.dtype, head_dim: int,
                 tokens: int, needs_grad: bool) -> bool:
    """Whether the kernel takes an attention core of these properties."""
    return (device_type == "cuda" and dtype == torch.bfloat16
            and head_dim == HEAD_DIM and tokens <= MAX_TOKENS
            and not needs_grad)


def attention_route(qkv: Tensor, heads: int) -> str:
    """``"kernel"`` or ``"plain"`` for a ``(N, T, 3W)`` qkv output."""
    needs_grad = torch.is_grad_enabled() and qkv.requires_grad
    hit = kernel_route(qkv.device.type, qkv.dtype,
                       qkv.shape[-1] // (3 * heads), qkv.shape[1], needs_grad)
    return "kernel" if hit else "plain"


def plain_attention(qkv: Tensor, heads: int, scale: float) -> Tensor:
    """The attention core in plain PyTorch, in ``qkv``'s dtype: scores
    ``q · kᵀ / scale``, the softmax in float32 cast back, ``P · v``, the
    heads merged into ``(N, T, W)``."""
    n, t, c3 = qkv.shape
    c = c3 // 3
    qkv = qkv.reshape(n, t, 3, heads, c // heads)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))  # (n,h,t,d)
    attn = (q @ k.transpose(-1, -2)) / scale
    # The float32 softmax upcasts its input itself: one pass fewer.
    attn = torch.softmax(attn, dim=-1, dtype=torch.float32).to(qkv.dtype)
    return (attn @ v).transpose(1, 2).reshape(n, t, c)


@functools.lru_cache(maxsize=None)
def _kernel() -> ctypes.CDLL:
    """fused_attention.cu's library with its export typed (built on first
    use)."""
    lib = _build.load("fused_attention")
    lib.srsem_fused_attention.restype = ctypes.c_int
    lib.srsem_fused_attention.argtypes = (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_void_p)
    return lib


@functools.lru_cache(maxsize=None)
def _inv_scale(scale: float) -> float:
    """The float32 reciprocal of ``scale``, as PyTorch takes it to divide a
    bf16 tensor by a scalar on the card; the kernel scales the bf16 scores
    by it in one bf16 multiply, so it must be a bf16 value (1/8 for heads
    of 64, whose scale is 8)."""
    inv = np.float32(1.0) / np.float32(scale)
    if int(inv.view(np.uint32)) & 0xFFFF:
        raise ValueError(f"the fused_attention kernel takes a scale whose "
                         f"float32 reciprocal is a bf16 value, got {scale}")
    return float(inv)


def _check(qkv: Tensor, heads: int) -> None:
    if qkv.dim() != 3 or heads < 1 or qkv.shape[-1] % (3 * heads) \
            or qkv.numel() == 0:
        raise ValueError(f"qkv must be a nonempty (N, T, 3W) tensor with W "
                         f"a multiple of {heads} heads, got "
                         f"{tuple(qkv.shape)}")


def fused_attention(qkv: Tensor, heads: int, scale: float) -> Tensor:
    """``(N, T, 3W)`` qkv → ``(N, T, W)`` attention output with the heads
    merged, ``plain_attention``'s function."""
    _check(qkv, heads)
    if qkv.device.type == "cpu":
        return plain_attention(qkv, heads, scale)
    if attention_route(qkv, heads) != "kernel":
        raise ValueError(f"the fused_attention kernel takes bf16 heads of "
                         f"{HEAD_DIM} over at most {MAX_TOKENS} tokens on "
                         f"CUDA with no gradient needed, got {qkv.device} "
                         f"{qkv.dtype} {tuple(qkv.shape)} in {heads} heads "
                         f"(requires_grad={qkv.requires_grad})")
    n, t, c3 = qkv.shape
    if not qkv.is_contiguous():
        raise ValueError("qkv must be contiguous")
    inv_scale = _inv_scale(scale)
    out = torch.empty(n, t, c3 // 3, dtype=qkv.dtype, device=qkv.device)
    dev = qkv.device
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    args = (qkv.data_ptr(), out.data_ptr(), n, t, heads, inv_scale, stream)
    if dev.index == torch.cuda.current_device():
        err = _kernel().srsem_fused_attention(*args)
    else:
        with torch.cuda.device(dev):
            err = _kernel().srsem_fused_attention(*args)
    if err != 0:
        raise RuntimeError(f"fused_attention kernel launch failed: CUDA "
                           f"error {err} (qkv {tuple(qkv.shape)}, {heads} "
                           f"heads)")
    fused_attention.launches += 1
    return out


fused_attention.launches = 0
