"""Port head (srsem_torch/ops/fused_head.py) vs the JAX Pallas head
(srsem/ops/fused_head.py, interpret mode), ConvHeadAggregator and
fused_grouped_head.

The same numpy inputs go to both packages; the port runs its plain
PyTorch version on the CPU.  Tolerance 1e-5: float32 sums of at most a few
thousand terms, differing only in reduction order.  A torch emulation of
the CUDA kernel's work list (``_emulate``: the wrapper's own plan, the
fixed channels of each thread, the GT reused across K, the fixed-order
finish) is held against the plain version.  The card tests are in
tests/test_torch_port_cuda.py.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import srsem.ops.fused_head as jfh
from srsem.models.global_models import ConvHeadAggregator as JaxAggregator
from srsem.models.global_models import fused_grouped_head as jax_grouped_head
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
    wrappers = (tfh.fused_stage_score, tfh.fused_global_score,
                tfh.fused_grouped_score)
    before = [f.launches for f in wrappers]
    tfh.fused_stage_score(torch.ones(1, 2, 2, 4), torch.zeros(1, 2, 2, 4),
                          torch.ones(4), 0.0)
    head = ConvHeadAggregator([4])
    taps = {"s0": torch.ones(1, 2, 2, 4)}
    tfh.fused_global_score(taps, {"s0": torch.zeros(1, 2, 2, 4)}, head, ["s0"])
    tfh.fused_grouped_score(taps, {"s0": torch.zeros(2, 2, 2, 4)}, head, ["s0"])
    assert [f.launches for f in wrappers] == before


# ---- the grouped (G, K) head and the packed head ------------------------

_SHAPES = ((8, 8, 16), (4, 4, 32), (2, 2, 64), (1, 1, 128))


def _jax_head_params(rng, channels):
    """JAX ``w_layers.{j}`` params: nonnegative weights and biases +1, so
    the final ReLU passes every score."""
    return {f"w_layers.{j}": {
        "kernel": np.abs(rng.standard_normal((c, 1))).astype(np.float32),
        "bias": (rng.standard_normal((1,)) + 1.0).astype(np.float32)}
        for j, c in enumerate(channels)}


@pytest.mark.parametrize("depth", [1, 3])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_grouped_score_matches_jax(np_rng, k, depth):
    """Port fused_grouped_score (plain path) == JAX fused_grouped_head,
    G = 3, with the ConvHeadAggregator and with its pack."""
    g = 3
    shapes = _SHAPES[3 - depth:]
    names = [f"s{j}" for j in range(len(shapes))]
    taps_g = {n: np_rng.standard_normal((g, *s)).astype(np.float32)
              for n, s in zip(names, shapes)}
    taps_s = {n: np_rng.standard_normal((g * k, *s)).astype(np.float32)
              for n, s in zip(names, shapes)}
    params = _jax_head_params(np_rng, [s[-1] for s in shapes])
    want = np.asarray(jax_grouped_head(
        params, {n: jnp.asarray(v) for n, v in taps_g.items()},
        {n: jnp.asarray(v) for n, v in taps_s.items()}, names))
    assert want.shape == (g, k) and (want > 0).all()
    head = _port_head_from_jax(params, [s[-1] for s in shapes])
    tg = {n: torch.tensor(v) for n, v in taps_g.items()}
    ts = {n: torch.tensor(v) for n, v in taps_s.items()}
    for h in (head, tfh.pack_head(head)):
        got = tfh.fused_grouped_score(tg, ts, h, names)
        assert got.dtype == torch.float32 and got.shape == (g, k)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        tfh.plain_grouped_score(tg, ts, head, names).numpy(), want,
        rtol=1e-5, atol=1e-5)


def test_global_score_packed_matches_jax(np_rng):
    """The one-launch fused_global_score with a packed head (plain path)
    == JAX fused_global_score (interpret mode)."""
    names = ["s0", "s1", "s2", "s3"]
    taps_a = {n: np.abs(np_rng.standard_normal((2, *s))).astype(np.float32)
              for n, s in zip(names, _SHAPES)}
    taps_b = {n: np.abs(np_rng.standard_normal((2, *s))).astype(np.float32)
              for n, s in zip(names, _SHAPES)}
    params = _jax_head_params(np_rng, [s[-1] for s in _SHAPES])
    want = np.asarray(jfh.fused_global_score(
        {n: jnp.asarray(v) for n, v in taps_a.items()},
        {n: jnp.asarray(v) for n, v in taps_b.items()},
        params, names, interpret=True))
    packed = tfh.pack_head(_port_head_from_jax(params,
                                               [s[-1] for s in _SHAPES]))
    ta = {n: torch.tensor(v) for n, v in taps_a.items()}
    tb = {n: torch.tensor(v) for n, v in taps_b.items()}
    got = tfh.fused_global_score(ta, tb, packed, names)
    assert got.shape == (2,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        tfh.plain_global_score(ta, tb, packed, names).numpy(), want,
        rtol=1e-5, atol=1e-5)


def test_pack_head_layout():
    head = ConvHeadAggregator([16, 32, 8])
    head.reset_parameters(torch.Generator().manual_seed(0))
    p = tfh.pack_head(head)
    assert p.channels == (16, 32, 8) and p.offsets == (0, 16, 48)
    assert p.w.shape == (56,) and p.b.shape == (3,)
    assert p.w.dtype == p.b.dtype == torch.float32
    for j, layer in enumerate(head.w_layers):
        w, b = p.stage(j)
        torch.testing.assert_close(w, layer.weight.reshape(-1))
        torch.testing.assert_close(b, layer.bias[0])


@pytest.mark.parametrize("case", ["sr_batch", "dtype", "contiguous",
                                  "channels"])
@pytest.mark.parametrize("fn", ["global", "grouped"])
def test_score_rejects_bad_inputs(case, fn):
    head = ConvHeadAggregator([8])
    gt = torch.zeros(2, 4, 4, 8)
    sr = torch.zeros(2 if fn == "global" else 4, 4, 4, 8)
    if case == "sr_batch":
        sr = torch.zeros(3, 4, 4, 8)
    elif case == "dtype":
        sr = sr.to(torch.bfloat16)
    elif case == "contiguous":
        sr = torch.zeros(sr.shape[0], 8, 4, 4).permute(0, 2, 3, 1)
    else:
        head = ConvHeadAggregator([16])
    wrapper = (tfh.fused_global_score if fn == "global"
               else tfh.fused_grouped_score)
    with pytest.raises((ValueError, TypeError)):
        wrapper({"s0": gt}, {"s0": sr}, head, ["s0"])


# ---- the kernel's work list, emulated -----------------------------------


def _emulate(stages, k, packed, plan, per_stage=False, b_const=0.0):
    """What csrc/fused_head.cu computes, item by item, from the wrapper's
    ``plan``: each item decoded from its index as the kernel does, the GT
    chunk read once against its k-block's SR chunks, per-thread sums (on
    the fixed-channel path each thread's 8 channels stay fixed, which is
    asserted; a block is the launch's step / 8 threads: 256 for 2048
    elements, 192 for 1536), the block's sum written to its partial (each
    exactly once), then the finish: per pair, stage by stage, then chunk
    by chunk.  Returns the (G·K,) scores."""
    g = stages[0][0].shape[0]
    threads = (max(plan.step) or 2048) // 8
    part = torch.full((plan.partials,), float("nan"))
    written = torch.zeros(plan.partials, dtype=torch.int64)
    lanes8 = torch.arange(8)
    for it in range(plan.items):
        i = max(j for j in range(len(plan.order)) if plan.item0[j] <= it)
        s = plan.order[i]
        gt_t, sr_t = stages[s]
        per_image, c = gt_t[0].numel(), gt_t.shape[-1]
        local = it - plan.item0[i]
        chunk, rest = local % plan.chunks[i], local // plan.chunks[i]
        k0, grp = (rest % plan.kblocks) * plan.kb, rest // plan.kblocks
        kn = min(plan.kb, k - k0)
        begin = chunk * plan.chunk[i]
        length = min(plan.chunk[i], per_image - begin)
        gt = gt_t.reshape(g, -1)[grp, begin: begin + length].float()
        sr = sr_t.reshape(g * k, -1)[grp * k + k0: grp * k + k0 + kn,
                                     begin: begin + length].float()
        w = packed.w[packed.offsets[s]: packed.offsets[s] + c]
        acc = torch.zeros(kn, threads)
        done = 0
        if plan.vec[i]:
            step = plan.step[i]
            assert step == threads * 8
            steps = length // step
            done = steps * step
            chans = (torch.arange(threads)[:, None] * 8) % c + lanes8
            elems = begin + torch.arange(done).reshape(steps, threads, 8)
            assert torch.equal(elems % c, chans.expand(steps, threads, 8))
            d = gt[:done].reshape(steps, threads, 8) - sr[:, :done].reshape(
                kn, steps, threads, 8)
            acc += (d * d * w[chans]).sum(dim=(1, 3))
        e = torch.arange(done, length)
        d = gt[done:] - sr[:, done:]
        acc.index_add_(1, (e - done) % threads, d * d * w[(begin + e) % c])
        idx = (plan.part0[i] + (grp * k + k0 + torch.arange(kn))
               * plan.chunks[i] + chunk)
        part[idx] = acc.reshape(kn, threads // 32, 32).sum(dim=2).sum(dim=1)
        written[idx] += 1
    assert (written == 1).all()
    out = torch.empty(g * k)
    for q in range(g * k):
        total = torch.zeros(())
        for i, s in enumerate(plan.order):
            n = plan.chunks[i]
            mine = part[plan.part0[i] + q * n: plan.part0[i] + (q + 1) * n]
            hw = math.prod(stages[s][0].shape[1:-1])  # H·W, or T tokens
            total = total + sum(mine.unbind(), torch.zeros(())) / hw + (
                b_const if per_stage else packed.b[s])
        out[q] = total if per_stage else torch.relu(total / len(stages))
    return out


def _unaligned(shape, rng):
    """A contiguous tensor one float32 past a 16-byte boundary."""
    flat = torch.tensor(rng.standard_normal(int(np.prod(shape)) + 1)
                        .astype(np.float32))
    return flat[1:].view(shape)


# wperlay_cnn's 12 per-block taps at 224 px (three each of 56x56x256,
# 28x28x512, 14x14x1024, 7x7x2048), scaled down: a quarter of the width
# and of the channels.
_WPERLAY = [(2, h, h, c) for h, c in ((14, 64), (7, 128), (4, 256), (2, 512))
            for _ in range(3)]


@pytest.mark.parametrize("shapes,k,unaligned", [
    ([(2, 9, 11, 40)], 1, False),                 # C = 40: general path
    ([(2, 9, 11, 40)], 4, False),
    ([(2, 16, 16, 64)], 1, False),                # chunks inside an image
    ([(2, 9, 11, 64), (2, 16, 16, 64)], 4, False),  # ragged last chunk
    ([(2, 16, 16, 64), (2, 8, 8, 128), (2, 4, 4, 256), (2, 9, 11, 40)], 1,
     False),
    ([(1, 8, 8, 64)], 10, False),                 # two k-blocks, 8 + 2
    ([(2, 16, 16, 64)], 4, True),                 # unaligned: general path
    (_WPERLAY, 1, False),                         # wperlay_cnn's 12 taps
    (_WPERLAY, 3, False),
], ids=["c40", "c40_k4", "chunks", "ragged_k4", "four_stages", "k10",
        "unaligned", "twelve_stages", "twelve_stages_k3"])
def test_kernel_work_list_matches_plain(shapes, k, unaligned):
    rng = np.random.default_rng(11)
    mk = (lambda s: _unaligned(s, rng)) if unaligned else (
        lambda s: torch.tensor(rng.standard_normal(s).astype(np.float32)))
    stages = [(mk(s), mk((k * s[0], *s[1:]))) for s in shapes]
    names = [f"s{j}" for j in range(len(shapes))]
    head = ConvHeadAggregator([s[-1] for s in shapes])
    head.reset_parameters(torch.Generator().manual_seed(1))
    packed = tfh.pack_head(head)
    plan = tfh.kernel_plan(stages, sms=132)
    assert plan.vec == tuple(s[-1] % 8 == 0 and 2048 % s[-1] == 0
                             and not unaligned
                             for s in (shapes[j] for j in plan.order))
    assert plan.kt >= plan.kb == min(k, 8)
    got = _emulate(stages, k, packed, plan)
    want = tfh.plain_grouped_score(dict(zip(names, (a for a, _ in stages))),
                                   dict(zip(names, (b for _, b in stages))),
                                   packed, names).reshape(-1)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_kernel_work_list_per_stage_mode():
    """fused_stage_score's mode (S = 1, no mean, no ReLU, b by value)."""
    rng = np.random.default_rng(12)
    fa, fb = (torch.tensor(rng.standard_normal((3, 9, 11, 64))
                           .astype(np.float32)) for _ in range(2))
    w = torch.tensor(rng.standard_normal(64).astype(np.float32))
    packed = tfh.PackedHead(w, torch.zeros(1), (64,))
    plan = tfh.kernel_plan([(fa, fb)], sms=132)
    got = _emulate([(fa, fb)], 1, packed, plan, per_stage=True, b_const=-0.5)
    want = tfh.fused_stage_score(fa, fb, w, -0.5)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def _sized(shape, dtype=torch.bfloat16):
    """A tensor of ``shape`` over one element (the plan reads shapes and
    the data pointer only)."""
    return torch.zeros(1, dtype=dtype).as_strided(shape, (0,) * len(shape))


@pytest.mark.parametrize("taps", [1, 3], ids=["stages_cnn", "wperlay_cnn"])
@pytest.mark.parametrize("g,k", [(64, 1), (16, 4)])
def test_plan_at_main_path_shapes(g, k, taps):
    """At 224 px on 132 SMs, stages_cnn's 4 taps and wperlay_cnn's 12
    (each stage's shape three times): every stage on the fixed-channel
    path, largest first (equal sizes in tap order), chunks of whole
    unrolled groups (4 steps of 2048 elements, at most 32 steps) spread
    evenly over each tap, 5-9 items a block over 528 blocks (5-10 at 12
    taps, where the chunk reaches its cap), one partial a pair and
    chunk."""
    shapes = [s for s in ((56, 56, 256), (28, 28, 512), (14, 14, 1024),
                          (7, 7, 2048)) for _ in range(taps)]
    stages = [(_sized((g, *s)), _sized((g * k, *s))) for s in shapes]
    plan = tfh.kernel_plan(stages, sms=132)
    assert plan.order == tuple(range(len(shapes))) and all(plan.vec)
    assert plan.kb == plan.kt == k and plan.kblocks == 1
    assert plan.grid == 528
    assert 5 <= plan.items / plan.grid <= (9 if taps == 1 else 10)
    assert max(plan.chunk) <= 32 * 2048
    for i, (h, w_, c) in enumerate(shapes):
        n = h * w_ * c
        assert plan.chunk[i] % 8192 == 0
        assert (plan.chunks[i] - 1) * plan.chunk[i] < n <= (
            plan.chunks[i] * plan.chunk[i])
        assert plan.chunk[i] - (n - (plan.chunks[i] - 1) * plan.chunk[i]) \
            < plan.chunks[i] * 8192
    assert plan.partials == g * k * sum(plan.chunks)
    assert plan.items == g * sum(plan.chunks)


def test_plan_takes_at_most_twelve_stages():
    """csrc/fused_head.cu passes at most 12 stage descriptors by value: a
    13th stage raises before a plan is made; the plain version takes it."""
    shapes = [(2, 4, 4, 8)] * 13
    stages = [(_sized(s, torch.float32), _sized(s, torch.float32))
              for s in shapes]
    assert len(tfh.kernel_plan(stages[:12], sms=132).order) == 12
    with pytest.raises(ValueError, match="at most 12 stages"):
        tfh.kernel_plan(stages, sms=132)
    names = [f"s{j}" for j in range(13)]
    taps = {n: torch.ones(*s) for n, s in zip(names, shapes)}
    head = ConvHeadAggregator([8] * 13)
    head.reset_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():
        for layer in head.w_layers:
            layer.weight.abs_()
    got = tfh.fused_global_score(taps, {n: t * 0 for n, t in taps.items()},
                                 head, names)
    assert (got > 0).all()
    torch.testing.assert_close(got, head(squared_diffs(
        taps, {n: t * 0 for n, t in taps.items()}, names)))
