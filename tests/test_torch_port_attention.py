"""The ViT attention core's routing rule and the plain version beside its
kernel (srsem_torch/ops/fused_attention.py), on the CPU.  The kernel itself
runs in tests/test_torch_port_attention_cuda.py on a card."""

import pytest
import torch

from srsem_torch.backbones.vit import ViTBlock
from srsem_torch.ops import fused_attention as tfa
from srsem_torch.utils import profiling


@pytest.mark.parametrize("device,dtype,head_dim,tokens,needs_grad,route", [
    ("cuda", torch.bfloat16, 64, 197, False, "kernel"),   # ViT-B/16, SLIP
    ("cuda", torch.bfloat16, 64, 1, False, "kernel"),
    ("cuda", torch.bfloat16, 64, 256, False, "kernel"),
    ("cuda", torch.bfloat16, 64, 257, False, "plain"),    # longer rows
    ("cuda", torch.bfloat16, 64, 577, False, "plain"),    # ALBEF at 384 px
    ("cuda", torch.float32, 64, 577, False, "plain"),     # ALBEF's DeiT
    ("cuda", torch.float32, 64, 197, False, "plain"),
    ("cuda", torch.float16, 64, 197, False, "plain"),
    ("cuda", torch.bfloat16, 32, 197, False, "plain"),    # other widths
    ("cuda", torch.bfloat16, 128, 197, False, "plain"),
    ("cuda", torch.bfloat16, 64, 197, True, "plain"),     # Grad-CAM, enc_ft
    ("cpu", torch.bfloat16, 64, 197, False, "plain"),
    ("cpu", torch.float32, 64, 197, False, "plain"),
    ("meta", torch.bfloat16, 64, 197, False, "plain"),
])
def test_routing_rule(device, dtype, head_dim, tokens, needs_grad, route):
    got = tfa.kernel_route(device, dtype, head_dim, tokens, needs_grad)
    assert ("kernel" if got else "plain") == route


@pytest.mark.parametrize("grad", [False, True])
def test_attention_route_reads_the_tensor(grad, monkeypatch):
    """A CPU qkv routes plain with and without a gradient; the rule sees
    the head width and the tokens of the tensor, and a gradient only
    where autograd records one."""
    qkv = torch.zeros(2, 197, 3 * 768, dtype=torch.bfloat16,
                      requires_grad=grad)
    assert tfa.attention_route(qkv, 12) == "plain"
    seen = []
    monkeypatch.setattr(tfa, "kernel_route",
                        lambda *a: seen.append(a) or False)
    with torch.no_grad():
        tfa.attention_route(qkv, 12)
    tfa.attention_route(qkv, 12)
    assert seen == [("cpu", torch.bfloat16, 64, 197, False),
                    ("cpu", torch.bfloat16, 64, 197, grad)]


def old_block_attention(qkv, heads, scale, dtype):
    """ViTBlock.forward's attention core as it was written before the
    kernel: the plain arithmetic the port and the JAX package share."""
    n, t, c3 = qkv.shape
    c = c3 // 3
    qkv = qkv.reshape(n, t, 3, heads, c // heads)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    attn = (q @ k.transpose(-1, -2)) / scale
    attn = torch.softmax(attn, dim=-1, dtype=torch.float32).to(dtype)
    return (attn @ v).transpose(1, 2).reshape(n, t, c)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,t,width,heads", [(2, 197, 192, 3), (1, 5, 64, 1),
                                             (3, 17, 96, 4)])
def test_cpu_branch_is_the_plain_arithmetic(dtype, n, t, width, heads):
    """fused_attention on a CPU tensor is plain_attention, which is the
    block's plain arithmetic to the bit; no launch is counted."""
    g = torch.Generator().manual_seed(n * t)
    qkv = torch.randn(n, t, 3 * width, generator=g).to(dtype)
    scale = float(torch.tensor(float(width // heads), dtype=dtype).sqrt())
    before = tfa.fused_attention.launches
    got = tfa.fused_attention(qkv, heads, scale)
    assert tfa.fused_attention.launches == before
    assert got.dtype == dtype and got.shape == (n, t, width)
    assert torch.equal(got, tfa.plain_attention(qkv, heads, scale))
    assert torch.equal(got, old_block_attention(qkv, heads, scale, dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_takes_the_plain_route_on_the_cpu(dtype):
    """A ViTBlock on the CPU: the attention span names the plain route and
    the block's output is its old arithmetic's, with the proj Linear, the
    residual and the MLP around it as they were."""
    torch.manual_seed(0)
    block = ViTBlock(96, 4, dtype)
    x = torch.randn(2, 10, 96)
    profiling.reset()
    profiling.enable()
    try:
        with torch.no_grad():
            x_attn, branch = block(x)
    finally:
        profiling.disable()
    spans = [s for s in profiling.snapshot()["spans"]
             if s["name"] == "srsem.vit.attention"]
    assert [s["attrs"] for s in spans] == [{"route": "plain"}]
    with torch.no_grad():
        ln = torch.nn.functional.layer_norm
        h = ln(x, (96,), block.norm1.weight, block.norm1.bias,
               block.norm1.eps).to(dtype)
        qkv = torch.nn.functional.linear(h, block.attn.qkv.weight.to(dtype),
                                         block.attn.qkv.bias.to(dtype))
        core = old_block_attention(qkv, 4, block.scale, dtype)
        want = x + torch.nn.functional.linear(
            core, block.attn.proj.weight.to(dtype),
            block.attn.proj.bias.to(dtype))
    assert torch.equal(x_attn, want)


@pytest.mark.parametrize("shape,heads", [((2, 8), 12), ((2, 8, 100), 12),
                                         ((0, 8, 36), 1), ((2, 8, 36), 0)])
def test_fused_attention_refuses_bad_shapes(shape, heads):
    with pytest.raises(ValueError):
        tfa.fused_attention(torch.zeros(shape), heads, 8.0)


@pytest.mark.parametrize("scale,inv", [(8.0, 0.125), (4.0, 0.25),
                                       (9.8125, None), (3.0, None)])
def test_kernel_takes_scales_with_a_bf16_reciprocal(scale, inv):
    """The kernel scales the bf16 scores by one bf16 multiply: the float32
    reciprocal PyTorch divides by must be a bf16 value (heads of 64 give
    1/8); any other scale is refused before a launch."""
    if inv is None:
        with pytest.raises(ValueError):
            tfa._inv_scale(scale)
    else:
        assert tfa._inv_scale(scale) == inv


def test_launches_counter_in_snapshot():
    counters = profiling.snapshot()["counters"]
    assert counters["launches.fused_attention"] == tfa.fused_attention.launches
