"""The port's tracer (srsem_torch/utils/profiling.py) and its spans at the
layer boundaries of the scorer, the decoder and the training step.

Off, ``span`` returns one shared no-op context and enters no
``record_function``; ``enable()``, or a running ``torch.profiler``, turns
it on.  The scorers and the training step record the trees their layers
make, on the CPU (the kernels' plain versions run there).
"""

import json

import numpy as np
import pytest
import torch

from srsem_torch.config import BackboneConfig, GlobalModelConfig, LocalModelConfig
from srsem_torch.eval.scorer import PairScorer
from srsem_torch.models.global_models import make_global_model
from srsem_torch.models.local_models import make_local_model
from srsem_torch.utils import profiling
from srsem_torch.utils.profiling import self_ms, snapshot, span
from torch_port_tmp import remove_tmp_path  # noqa: F401 — autouse fixture

GLOBAL_CFG = GlobalModelConfig(backbone=BackboneConfig(
    kind="resnet50", image_size=64, compute_dtype="float32"), depth=3)
MAP_CFG = LocalModelConfig(backbone=BackboneConfig(
    kind="resnet50_clip", image_size=32, compute_dtype="float32"))
#: A narrow ViT with all 12 blocks (stages_vit taps blocks 2, 5, 8, 11).
VIT_CFG = GlobalModelConfig(backbone=BackboneConfig(
    kind="vit_clip", image_size=32, compute_dtype="float32", vit_width=32,
    vit_heads=2), head="stages_vit", depth=3)


@pytest.fixture(autouse=True)
def _fresh_tracer():
    """Each test starts from an empty, disabled tracer on two threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    profiling.disable()
    profiling.reset()
    yield
    profiling.disable()
    profiling.reset()
    torch.set_num_threads(n)


def names(spans):
    return [s["name"] for s in spans]


def by_id(spans):
    return {s["id"]: s for s in spans}


def test_off_span_records_nothing(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered while off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    first, second = span("srsem.a", rows=1), span("srsem.b")
    assert first is second
    with first:
        with span("srsem.c"):
            torch.ones(4).sum()
    profiling.record("srsem.d", 0)
    assert snapshot()["spans"] == []


def test_enable_records_a_tree():
    profiling.enable()
    with span("srsem.root", rows=3):
        with span("srsem.child"):
            with span("srsem.leaf"):
                pass
        with span("srsem.child"):
            pass
    with span("srsem.root"):
        pass
    profiling.disable()
    with span("srsem.root"):
        pass
    spans = snapshot()["spans"]
    assert names(spans) == ["srsem.leaf", "srsem.child", "srsem.child",
                            "srsem.root", "srsem.root"]
    leaf, c1, c2, r1, r2 = spans
    assert r1["parent"] is None and r1["call"] == r1["id"]
    assert r1["attrs"] == {"rows": 3}
    assert c1["parent"] == c2["parent"] == r1["id"] and leaf["parent"] == c1["id"]
    assert {s["call"] for s in (leaf, c1, c2, r1)} == {r1["id"]}
    assert r2["call"] == r2["id"] != r1["id"]
    assert all(s["t0_ns"] <= s["t1_ns"] for s in spans)
    assert r1["t0_ns"] <= c1["t0_ns"] and c2["t1_ns"] <= r1["t1_ns"]


def test_self_ms_on_a_hand_built_tree():
    ms = 1_000_000

    def s(i, name, parent, t0, t1):
        return {"name": name, "id": i, "parent": parent, "call": 1,
                "t0_ns": t0 * ms, "t1_ns": t1 * ms, "attrs": {}}

    spans = [s(1, "root", None, 0, 100),
             s(2, "a", 1, 10, 40), s(3, "a", 1, 30, 50),   # union 10-50
             s(4, "b", 1, 70, 80),
             s(5, "leaf", 2, 15, 35),                      # a grandchild
             s(6, "root", None, 200, 210)]
    assert self_ms(spans, "root") == pytest.approx(100 - 40 - 10 + 10)
    assert self_ms(spans, "a") == pytest.approx(30 - 20 + 20)
    assert self_ms(spans, "leaf") == pytest.approx(20)
    assert self_ms(spans, "missing") == 0


def test_profiler_turns_spans_on():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("srsem.outer"):
            with span("srsem.inner"):
                torch.ones(8).sum()
    events = {e.name for e in prof.events()}
    assert {"srsem.outer", "srsem.inner"} <= events
    assert names(snapshot()["spans"]) == ["srsem.inner", "srsem.outer"]
    with span("srsem.after"):
        pass
    assert len(snapshot()["spans"]) == 2


def test_count_and_snapshot_counters():
    profiling.count("construct_s", 0.25)
    profiling.count("construct_s", 0.5)
    profiling.count("constructs")
    counters = snapshot()["counters"]
    assert counters["construct_s"] == pytest.approx(0.75)
    assert counters["constructs"] == 1
    assert {"launches.fused_bottleneck", "launches.fused_decoder_level",
            "launches.fused_global_score"} <= set(counters)
    profiling.reset()
    assert "construct_s" not in snapshot()["counters"]


def test_span_buffer_is_bounded(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 3)
    profiling.enable()
    for _ in range(5):
        with span("srsem.x"):
            pass
    snap = snapshot()
    assert len(snap["spans"]) == 3 and snap["counters"]["spans_dropped"] == 2


def _global_model():
    m = make_global_model(GLOBAL_CFG, torch.Generator().manual_seed(3))
    with torch.no_grad():
        for layer in m.aggregator.w_layers:
            layer.weight.abs_()
    return m


def _map_model():
    return make_local_model(MAP_CFG, generator=torch.Generator().manual_seed(6))


#: Per call: the spans (name, parent's name) each scorer records.
SCORER_TREES = {
    "global": (GLOBAL_CFG, _global_model, "global", [
        ("srsem.normalize", "srsem.score"), ("srsem.normalize", "srsem.score"),
        ("srsem.tower", "srsem.score"), ("srsem.tower", "srsem.score"),
        ("srsem.head", "srsem.score"), ("srsem.score", None)]),
    "local": (MAP_CFG, _map_model, "local", [
        ("srsem.normalize", "srsem.score"), ("srsem.normalize", "srsem.score"),
        ("srsem.tower", "srsem.score"), ("srsem.tower", "srsem.score"),
        ("srsem.diffs", "srsem.score")]
        + [("srsem.decode.level", "srsem.decode")] * 5
        + [("srsem.decode", "srsem.score"), ("srsem.score", None)]),
}


@pytest.mark.parametrize("kind", sorted(SCORER_TREES))
def test_pair_scorer_records_each_call(kind):
    cfg, build, model_kind, tree = SCORER_TREES[kind]
    before = snapshot()["counters"].get("constructs", 0)
    scorer = PairScorer(cfg, build(), batch_size=2, model_kind=model_kind,
                        device="cpu")
    counters = snapshot()["counters"]
    assert counters["constructs"] == before + 1 and counters["construct_s"] > 0
    size = cfg.backbone.image_size
    rng = np.random.default_rng(0)
    a, b = (rng.integers(0, 256, (2, size, size, 3), dtype=np.uint8)
            for _ in range(2))
    scorer.score_arrays(a, b)  # off: nothing recorded
    assert snapshot()["spans"] == []
    profiling.enable()
    for _ in range(2):
        scorer.score_arrays(a, b)
    spans = snapshot()["spans"]
    ids = by_id(spans)
    roots = [s for s in spans if s["parent"] is None]
    assert [r["name"] for r in roots] == ["srsem.score"] * 2
    assert roots[0]["attrs"] == {"rows": 2, "kind": model_kind}
    for root in roots:
        mine = [s for s in spans if s["call"] == root["id"]]
        got = [(s["name"], ids[s["parent"]]["name"] if s["parent"] else None)
               for s in mine]
        assert got == tree
    norm = next(s for s in spans if s["name"] == "srsem.normalize")
    assert norm["attrs"] == {"bytes": 2 * size * size * 3, "pinned": False}
    if kind == "local":
        levels = [s["attrs"] for s in spans if s["call"] == roots[0]["id"]
                  and s["name"] == "srsem.decode.level"]
        assert [lv["level"] for lv in levels] == [4, 3, 2, 1, 0]
        assert [lv["route"] for lv in levels] == ["kernel"] * 5


def test_training_step_records_its_tree():
    from srsem_torch.train.loop import batch_to_device, build_training
    from srsem_torch.train.partition import trainable_predicate

    cpu = torch.device("cpu")
    steps, _ = build_training(_global_model(), False, trainable_predicate(),
                              1e-3, cpu)
    assert snapshot()["counters"]["constructs"] == 1
    rng = np.random.default_rng(1)
    a, b = (rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
            for _ in range(2))
    batch = (((a, b), np.ones(2, np.float32)), np.ones(2, np.float32))
    profiling.enable()
    loss = steps.train_step(*batch_to_device(batch, cpu))
    assert torch.isfinite(loss)
    spans = snapshot()["spans"]
    ids = by_id(spans)
    moved, step = spans[0], spans[-1]
    assert moved["name"] == "srsem.batch_to_device" and moved["parent"] is None
    assert moved["attrs"] == {"bytes": 2 * a.nbytes + 16, "pinned": False}
    assert step["name"] == "srsem.train_step" and step["attrs"] == {"rows": 2}
    children = [s["name"] for s in spans if s["parent"] == step["id"]]
    assert children == ["srsem.tower", "srsem.forward", "srsem.loss",
                        "srsem.backward", "srsem.optimizer"]
    assert all(ids[s["parent"]]["name"] == "srsem.train_step"
               for s in spans[1:-1])


def test_profile_flag_writes_spans(tmp_path):
    from PIL import Image

    from srsem_torch.cli.main import main

    rng = np.random.default_rng(2)
    rows = []
    for i in range(3):
        pair = []
        for side in ("gt", "sr"):
            p = tmp_path / f"{side}{i}.png"
            Image.fromarray(rng.integers(0, 256, (72, 80, 3),
                                         dtype=np.uint8)).save(p)
            pair.append(str(p))
        rows.append(",".join(pair))
    csv_path = tmp_path / "pairs.csv"
    csv_path.write_text("img_a_pth,img_b_pth\n" + "\n".join(rows) + "\n")
    prof = tmp_path / "prof"
    assert main(["--profile", str(prof), "score", str(csv_path),
                 "--device", "cpu", "--batch-size", "2",
                 "--out", str(tmp_path / "scores.csv"),
                 "--set", "backbone.image_size=64",
                 "--set", "backbone.compute_dtype=float32"]) == 0
    assert not profiling._on
    spans = json.loads((prof / "spans.json").read_text())
    got = names(spans["spans"])
    assert got.count("srsem.score") == 2 and got.count("srsem.wait_decode") == 2
    assert {"srsem.normalize", "srsem.tower", "srsem.head"} <= set(got)
    assert spans["counters"]["constructs"] >= 1
    assert "launches.fused_global_score" in spans["counters"]
    trace = json.loads((prof / "trace.json").read_text())
    assert any(e.get("name") == "srsem.score" for e in trace["traceEvents"])


def test_off_vit_spans_are_the_shared_no_op(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered while off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert span("srsem.vit.block", block=0) is span("srsem.a") is profiling._OFF
    vit_spans("cpu", rounds=0)  # a ViT call with the tracer off
    assert snapshot()["spans"] == []


def vit_spans(device, rounds=1):
    """The spans of one ``score_arrays`` call of two 32 px pairs through
    the ViT regressor on ``device``, recorded with the tracer on; each
    further round resets the tracer and records the call again (no
    round: only the untraced call, and None)."""
    model = make_global_model(VIT_CFG, torch.Generator().manual_seed(4))
    scorer = PairScorer(VIT_CFG, model, batch_size=2, device=device)
    rng = np.random.default_rng(5)
    a, b = (rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
            for _ in range(2))
    scorer.score_arrays(a, b)  # off: nothing recorded
    spans = None
    for _ in range(rounds):
        profiling.reset()
        profiling.enable()
        scorer.score_arrays(a, b)
        profiling.disable()
        spans = snapshot()["spans"]
    return spans


def vit_blocks(spans):
    """``(block span, its one attention span)`` of each block, in order;
    every attention span names the plain route (VIT_CFG's float32 tower
    with heads of 16 takes no kernel, on the CPU or the card)."""
    ids = by_id(spans)
    (root,) = [s for s in spans if s["parent"] is None]
    assert root["name"] == "srsem.score"
    blocks = [s for s in spans if s["name"] == "srsem.vit.block"]
    assert [s["attrs"] for s in blocks] == [{"block": i}
                                            for i in range(12)] * 2
    out = []
    for blk in blocks:
        assert blk["call"] == root["id"]
        assert ids[blk["parent"]]["name"] == "srsem.tower"
        children = [s for s in spans if s["parent"] == blk["id"]]
        assert names(children) == ["srsem.vit.attention"]
        assert children[0]["attrs"] == {"route": "plain"}
        out.append((blk, children[0]))
    return out


def test_vit_records_each_block_and_its_attention():
    spans = vit_spans("cpu")
    pairs = vit_blocks(spans)
    assert len(pairs) == 24
    for blk, att in pairs:  # the attention core lies inside its block
        assert blk["t0_ns"] <= att["t0_ns"] <= att["t1_ns"] <= blk["t1_ns"]
    assert not any("device_ms" in s for s in spans)  # host spans only


@pytest.mark.cuda
def test_vit_spans_annotate_the_card_trace():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m cuda on the H100)")
    assert len(vit_blocks(vit_spans("cuda", rounds=2))) == 24
    # Under a running profiler the spans record and annotate its trace.
    with torch.profiler.profile() as prof:
        vit_spans("cuda", rounds=0)
    got = [e.key for e in prof.key_averages()]
    assert "srsem.vit.block" in got and "srsem.vit.attention" in got
