"""The 3xTF32 float32 route of the conv kernels (csrc/conv_wgmma.cuh), on
the CPU: the port's plain split (srsem_torch/ops/tf32x3.py) and an
emulation of the kernel's products put through the tile emulations of the
bottleneck and decoder tests, against the interpret-mode Pallas kernels
(srsem/ops/fused_bottleneck.py, srsem/ops/fused_decoder.py) in float32.

The kernel splits each float32 operand x into hi = tf32(x) and lo =
tf32(x - hi) (rounded to nearest, ties away from zero) and sums lo.hi +
hi.lo + hi.hi on the tensor cores, a k-step at a time.  The emulation does
the same per 64-channel k-step in torch (products of tf32 values are exact
in float32).  Shapes are ResNet-50's and the CLU decoder's at 64 px
(``small_backbone_cfg``), batch 1.  Tolerance: the float32 tests' 1e-4;
1xTF32 (hi.hi alone) misses it, which shows the test tells them apart.
The card's kernel against its plain version is in test_torch_port_cuda.py.
"""

import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import example, given, settings
from hypothesis import strategies as st

import srsem.ops.fused_bottleneck as jfb
from srsem.ops.fused_decoder import fused_decoder_level as jax_level
from srsem_torch.ops import fused_bottleneck as tfb
from srsem_torch.ops import fused_decoder as tfd
from srsem_torch.ops.tf32x3 import split_tf32, split_weights, to_tf32
from test_torch_port_bottleneck import _three_pass, _weights
from test_torch_port_decoder import _inputs, _two_pass
from test_torch_port_train import _two_threads  # noqa: F401 — fixture

TOL = 1e-4


def tf32x3(a, b):
    """The kernel's product of float32 a (M, K) and b (K, N): the small
    terms, then the large one."""
    ah, al = split_tf32(a.contiguous())
    bh, bl = split_tf32(b.contiguous())
    return (al @ bh + ah @ bl) + ah @ bh


def tf32x1(a, b):
    """hi.hi alone: what TF32 without the split computes."""
    return to_tf32(a.contiguous()) @ to_tf32(b.contiguous())


# Finite float32 magnitudes where lo stays a normal number: below 2^-100
# lo's rounding floor (2^-136, tf32 in the subnormals) passes 2^-22 |x|,
# and from 0x7F7FF000 on hi rounds to infinity.
MAGNITUDES = st.floats(min_value=2.0 ** -100, max_value=3.3999999521443642e38,
                       width=32,
                       allow_nan=False, allow_infinity=False)


@settings(max_examples=400, deadline=None, database=None)
@given(MAGNITUDES, st.booleans())
@example(1.0, False)
@example(2.0 ** 70, True)                   # powers of two split exactly
@example(1.0 + 2.0 ** -11, False)           # a tie: away from zero
@example(1.0 + 2.0 ** -11, True)
@example(1.0 + 3 * 2.0 ** -11, False)       # a tie above an odd hi
@example(2.0 - 2.0 ** -23, False)           # rounds up into the next binade
@example(3.3e38, True)
def test_split_tf32_rounds_to_nearest_and_lo_recovers_x(mag, negative):
    """hi's 13 low mantissa bits are zero and hi is the nearest tf32 value
    (ties away from zero), and |x - hi - lo| <= 2^-22 |x|."""
    x = np.float32(-mag if negative else mag)
    hi, lo = split_tf32(torch.tensor([x]))
    assert int(hi.view(torch.int32)) & 0x1FFF == 0
    assert int(lo.view(torch.int32)) & 0x1FFF == 0
    xv, hv, lv = float(x), float(hi), float(lo)
    half_ulp = 2.0 ** (math.frexp(xv)[1] - 1 - 10) / 2  # tf32: 10 bits
    assert abs(xv - hv) <= half_ulp
    if abs(xv - hv) == half_ulp:
        assert abs(hv) > abs(xv)
    assert abs(xv - hv - lv) <= 2.0 ** -22 * abs(xv)


def test_split_weights_stacks_hi_over_lo():
    rng = np.random.default_rng(0)
    w = torch.tensor(rng.normal(size=(8, 72)).astype(np.float32))
    s = split_weights(w)
    assert s.shape == (2, 8, 72) and s.is_contiguous()
    torch.testing.assert_close(s[0], to_tf32(w), rtol=0, atol=0)
    torch.testing.assert_close((s[0].double() + s[1].double()),
                               w.double(), rtol=2.0 ** -22, atol=0)


def test_float32_pack_holds_the_split():
    """pack_weights in float32 keeps w1t, w2t, w3t as they were and adds
    their splits; bf16 packs stay plain ``Packed``."""
    rng = np.random.default_rng(1)
    ws = list(map(torch.tensor, _weights(rng, 64, 32)))
    p = tfb.pack_weights(ws, torch.float32)
    assert isinstance(p, tfb.PackedTF32)
    for mat, split in ((p.w1t, p.w1s), (p.w2t, p.w2s), (p.w3t, p.w3s)):
        torch.testing.assert_close(split, split_weights(mat), rtol=0, atol=0)
    assert type(tfb.pack_weights(ws, torch.bfloat16)) is tfb.Packed
    x = torch.tensor(rng.normal(size=(1, 4, 4, 64)).astype(np.float32))
    with pytest.raises(TypeError, match="pack_weights"):
        tfb.fused_bottleneck(x, tfb.pack_weights(ws, torch.bfloat16))


# ResNet-50's stride-1 blocks at 64 px (stages 1-3) and the CLU decoder's
# levels 2 and 0 at 64 px.
BOTTLENECKS = [(1, 8, 8, 512, 128, (8, 8), True),
               (1, 4, 4, 1024, 256, (4, 4), True),
               (1, 2, 2, 2048, 512, (2, 2), True)]
DECODER_LEVELS = [(1, 8, 8, 512, 1024, 512, 512, 3),
                  (1, 32, 32, 64, 256, 64, 1, 1)]


def _bottleneck_case(case):
    n, h, w, c, wd, patch, flat = case
    rng = np.random.default_rng(11)
    xn = rng.normal(size=(n, h, w, c)).astype(np.float32)
    ws = _weights(rng, c, wd, scale=c ** -0.5)
    x = torch.tensor(xn)
    p = tfb.pack_weights(list(map(torch.tensor, ws)), torch.float32)
    want = jfb.fused_bottleneck(jnp.asarray(xn), *map(jnp.asarray, ws),
                                compute_dtype=jnp.float32, interpret=True)
    return (lambda mm: _three_pass(x, p, patch, flat, mm=mm),
            torch.tensor(np.asarray(want)))


def _decoder_case(case):
    args = _inputs(7, *case)
    fk = case[-1]
    d, u, *ws = map(torch.tensor, args)
    prepared = tfd._prepare(d, u, *ws, fk)
    want = jax_level(*(None if a is None else jnp.asarray(a) for a in args),
                     final_kernel=fk, compute_dtype=jnp.float32,
                     interpret=True)
    return (lambda mm: _two_pass(*prepared, fk, mm=mm),
            torch.tensor(np.asarray(want)))


CASES = ([("bottleneck", c) for c in BOTTLENECKS]
         + [("decoder", c) for c in DECODER_LEVELS])


@functools.lru_cache(maxsize=None)
def _case(kind, case):
    return (_bottleneck_case if kind == "bottleneck" else _decoder_case)(case)


@pytest.mark.parametrize("kind,case", CASES)
def test_tf32x3_products_match_pallas_in_float32(kind, case):
    """The kernel's float32 structure with its 3xTF32 products matches the
    interpret-mode Pallas kernel at the float32 tolerance, 1e-4."""
    run, want = _case(kind, case)
    torch.testing.assert_close(run(tf32x3), want, rtol=TOL, atol=TOL)


def test_tf32x1_products_miss_the_float32_tolerance():
    """hi.hi alone (TF32 without the split) misses 1e-4 on these cases:
    the tolerance tells 3xTF32 from 1xTF32."""
    misses = []
    for kind, case in CASES:
        run, want = _case(kind, case)
        got = run(tf32x1)
        misses.append(not torch.allclose(got, want, rtol=TOL, atol=TOL))
    assert any(misses), misses
