"""Port head (srsem_torch/ops/fused_head.py) vs the JAX Pallas head
(srsem/ops/fused_head.py, interpret mode) and ConvHeadAggregator.

The same numpy inputs go to both packages; the port runs its plain
PyTorch version on the CPU.  Tolerance 1e-5: float32 sums of at most a few
thousand terms, differing only in reduction order.  The card tests are
in tests/test_torch_port_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import srsem.ops.fused_head as jfh
from srsem.models.global_models import ConvHeadAggregator as JaxAggregator
from srsem_torch.models.global_models import (
    ConvHeadAggregator,
    conv_head_from_stats,
    squared_diffs,
)
from srsem_torch.ops import fused_head as tfh


def _port_head_from_jax(params, channels):
    head = ConvHeadAggregator(channels)
    with torch.no_grad():
        for j, layer in enumerate(head.w_layers):
            p = params[f"w_layers.{j}"]
            layer.weight.copy_(torch.tensor(np.asarray(p["kernel"])).t()
                               .reshape(1, -1, 1, 1))
            layer.bias.copy_(torch.tensor(np.asarray(p["bias"])))
    return head


def test_stage_score_matches_jax(np_rng):
    n, h, w, c = 3, 8, 8, 32
    fa = np_rng.standard_normal((n, h, w, c)).astype(np.float32)
    fb = np_rng.standard_normal((n, h, w, c)).astype(np.float32)
    wt = np_rng.standard_normal((c,)).astype(np.float32)
    want = np.asarray(jfh.fused_stage_score(
        jnp.asarray(fa), jnp.asarray(fb), jnp.asarray(wt),
        jnp.asarray(np.float32(0.3)), interpret=True))
    got = tfh.fused_stage_score(torch.tensor(fa), torch.tensor(fb),
                                torch.tensor(wt), 0.3)
    assert got.dtype == torch.float32 and got.shape == (n,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_global_score_matches_jax_and_aggregator(np_rng):
    """Port fused_global_score == port ConvHeadAggregator == JAX
    fused_global_score (interpret) == JAX ConvHeadAggregator."""
    shapes = {"s0": (2, 8, 8, 16), "s1": (2, 4, 4, 32)}
    names = ("s0", "s1")
    taps_a = {k: np_rng.standard_normal(v).astype(np.float32)
              for k, v in shapes.items()}
    taps_b = {k: np_rng.standard_normal(v).astype(np.float32)
              for k, v in shapes.items()}
    diffs = [(jnp.asarray(taps_a[k]) - jnp.asarray(taps_b[k])) ** 2
             for k in names]
    agg = JaxAggregator(len(names))
    params = agg.init(jax.random.PRNGKey(0), diffs)["params"]
    # Push the biases past the final ReLU so the comparison is not 0 == 0.
    params = jax.tree.map(lambda v: v + 1.0 if v.shape == (1,) else v, params)
    want_agg = np.asarray(agg.apply({"params": params}, diffs))
    want_fused = np.asarray(jfh.fused_global_score(
        {k: jnp.asarray(v) for k, v in taps_a.items()},
        {k: jnp.asarray(v) for k, v in taps_b.items()},
        params, names, interpret=True))
    assert (want_agg > 0).all()

    head = _port_head_from_jax(params, [16, 32])
    ta = {k: torch.tensor(v) for k, v in taps_a.items()}
    tb = {k: torch.tensor(v) for k, v in taps_b.items()}
    with torch.no_grad():
        got_fused = tfh.fused_global_score(ta, tb, head, names).numpy()
        got_agg = head(squared_diffs(ta, tb, names)).numpy()
        stats = [d.mean(dim=(1, 2)) for d in squared_diffs(ta, tb, names)]
        got_stats = conv_head_from_stats(head, stats).numpy()
    for got in (got_fused, got_agg, got_stats):
        np.testing.assert_allclose(got, want_agg, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got, want_fused, rtol=1e-5, atol=1e-5)


def test_stage_score_multi_tile_matches_jax(np_rng, monkeypatch):
    """JAX multi-tile grid (VMEM budget shrunk to 48-row tiles) == port."""
    n, h, w, c = 2, 16, 12, 8
    monkeypatch.setattr(jfh, "_VMEM_BUDGET", 48 * c * 4)
    assert jfh._tile_rows(h * w, c, 4) < h * w
    fa = np_rng.standard_normal((n, h, w, c)).astype(np.float32)
    fb = np_rng.standard_normal((n, h, w, c)).astype(np.float32)
    wt = np_rng.standard_normal((c,)).astype(np.float32)
    want = np.asarray(jfh.fused_stage_score(
        jnp.asarray(fa), jnp.asarray(fb), jnp.asarray(wt),
        jnp.asarray(np.float32(0.0)), interpret=True))
    got = tfh.fused_stage_score(torch.tensor(fa), torch.tensor(fb),
                                torch.tensor(wt), 0.0).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", ["shape", "dtype", "weight", "contiguous",
                                  "device"])
def test_stage_score_rejects_bad_inputs(case):
    fa = torch.zeros(2, 4, 4, 8)
    fb = torch.zeros(2, 4, 4, 8)
    w = torch.zeros(8)
    if case == "shape":
        fb = torch.zeros(2, 4, 4, 16)
    elif case == "dtype":
        fb = fb.double()
    elif case == "weight":
        w = w.to(torch.bfloat16)
    elif case == "contiguous":
        fa = torch.zeros(2, 8, 4, 4).permute(0, 2, 3, 1)
    else:
        w = torch.zeros(8, device="meta")
    with pytest.raises((ValueError, TypeError)):
        tfh.fused_stage_score(fa, fb, w, 0.0)


def test_cpu_path_counts_no_launch():
    before = tfh.fused_stage_score.launches
    tfh.fused_stage_score(torch.ones(1, 2, 2, 4), torch.zeros(1, 2, 2, 4),
                          torch.ones(4), 0.0)
    assert tfh.fused_stage_score.launches == before
