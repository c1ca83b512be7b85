"""Port scoring service (srsem_torch/cli/serve.py) vs the JAX package's
(srsem/cli/serve.py): protocol, NaN failure contract, bucket ladder,
micro-batching, decode LRU, maps, the HTTP batcher, shared weights, and
``python -m srsem_torch serve`` as a subprocess.

Weights: a seeded port model with random frozen-BN statistics and a live
head (nonnegative weights, biases +1), carried to JAX variables through
srsem/utils/convert.py, as tests/test_torch_port_grouped.py does.  f32,
64 px (maps at 32 px).  Against JAX the scores agree within 1e-3 (the
tolerance of tests/test_torch_port_grouped.py:100) and the maps' means
within 2e-3 (tests/test_torch_port_clu.py:199); the JAX services run
``group_batch=2`` and one K, so JAX compiles one program each.  Within the
port, a bucket's choice moves a score by at most 1e-5.
"""

import io
import json
import os
import shutil
import subprocess
import sys
import threading
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from srsem.cli.serve import ScoreService as JaxScoreService
from srsem.core.config import BackboneConfig as JaxBackboneConfig
from srsem.core.config import GlobalModelConfig as JaxGlobalConfig
from srsem.core.config import LocalModelConfig as JaxLocalConfig
from srsem.utils.convert import (
    convert_clip_resnet50,
    convert_clu_decoder,
    convert_global_head,
    convert_torch_resnet50,
)
from srsem_torch.backbones.resnet import FrozenBatchNorm
from srsem_torch.cli.serve import (
    ScoreService,
    _normalize,
    serve_http,
    serve_stdio,
)
from srsem_torch.config import BackboneConfig, GlobalModelConfig, LocalModelConfig
from srsem_torch.eval.grouped import GroupedMapScorer, GroupedPairScorer
from srsem_torch.models.global_models import make_global_model
from srsem_torch.models.local_models import make_local_model
from torch_port_tmp import remove_tmp_path  # noqa: F401 — autouse fixture

REPO = Path(__file__).resolve().parents[1]
CFG = GlobalModelConfig(backbone=BackboneConfig(
    kind="resnet50", image_size=64, compute_dtype="float32"), depth=3)
MAP_CFG = LocalModelConfig(backbone=BackboneConfig(
    kind="resnet50_clip", image_size=32, compute_dtype="float32"))


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Small CPU ops: two intra-op threads a process beat the host's count
    when test workers share its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _random_bn(model, seed):
    """Random frozen-BN statistics; small gammas on the BNs closing each
    residual branch keep activations O(1) through 16 blocks."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.tensor(a, dtype=torch.float32)  # noqa: E731
    with torch.no_grad():
        for name, m in model.named_modules():
            if isinstance(m, (FrozenBatchNorm, torch.nn.BatchNorm2d)):
                c = m.weight.shape[0]
                closing = (name.endswith(("bn3", "downsample.1"))
                           and "layer" in name)
                m.weight.copy_(f32(rng.uniform(0.1, 0.3, c) if closing
                                   else rng.uniform(0.5, 1.5, c)))
                m.bias.copy_(f32(rng.uniform(-0.5, 0.5, c)))
                m.running_mean.copy_(f32(rng.uniform(-0.5, 0.5, c)))
                m.running_var.copy_(f32(rng.uniform(0.5, 1.5, c)))


@pytest.fixture(scope="module")
def model():
    """The global model: live head (nonnegative weights x100, biases +1,
    so the squared diffs carry each score and the ReLU passes it)."""
    m = make_global_model(CFG, torch.Generator().manual_seed(3))
    _random_bn(m.backbone, 3)
    with torch.no_grad():
        for layer in m.aggregator.w_layers:
            layer.weight.abs_().mul_(100.0)
            layer.bias.add_(1.0)
    return m


@pytest.fixture(scope="module")
def map_model():
    """The CLU model with a map head scaled to keep the sigmoid off its
    flat ends (as tests/test_torch_port_clu.py::seeded_clu)."""
    m = make_local_model(MAP_CFG, generator=torch.Generator().manual_seed(6))
    _random_bn(m, 6)
    with torch.no_grad():
        m.decoder[0][3].weight.mul_(0.1)
        m.decoder[0][3].bias.add_(0.5)
    return m


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("serve_imgs")
    rng = np.random.default_rng(0)
    gt = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
    out = {}
    for name in ("gt", "sr_a", "sr_b"):
        img = gt if name == "gt" else np.clip(
            gt.astype(int) + rng.integers(-40, 41, gt.shape), 0, 255)
        p = d / f"{name}.png"
        Image.fromarray(img.astype(np.uint8)).save(p)
        out[name] = str(p)
    bad = d / "corrupt.png"
    bad.write_bytes(b"not an image")
    out["bad"] = str(bad)
    yield out
    shutil.rmtree(d, ignore_errors=True)


def _service(model, **kw):
    return ScoreService(CFG, model, device="cpu", **{"group_batch": 4, **kw})


def _grouped_want(model, paths, names):
    """The grouped scorer's (K,) scores for the GT against ``names``."""
    sc = GroupedPairScorer(CFG, model, k=len(names), batch_size=1,
                           device="cpu")
    gt = sc.preprocess.decode_uint8(paths["gt"])[None]
    sr = np.stack([sc.preprocess.decode_uint8(paths[n]) for n in names])[None]
    return sc.score_arrays(gt, sr).numpy()[0]


def test_normalize_never_raises_and_uniform_k_guard():
    """A malformed 'sr' comes back as an error RESPONSE (serve_stdio calls
    _normalize outside its per-request try); mixed-K micro-batches are
    rejected at the public scoring boundary."""
    for bad_sr in (5, 1.5, True, {"x": "y"}, [1, 2], ["a.jpg", 7], [], ""):
        out = _normalize({"gt": "a.jpg", "sr": bad_sr, "id": 9})
        assert "error" in out and out["id"] == 9, bad_sr
    assert _normalize({"gt": "a.jpg", "sr": "b.jpg", "maps": 1,
                       "maps_dir": "m"}) == {
        "gt": "a.jpg", "sr": ["b.jpg"], "_scalar": True, "maps": True,
        "maps_dir": "m"}
    assert ScoreService._uniform_k([{"sr": ["a"]}, {"sr": ["b"]}]) == 1
    with pytest.raises(ValueError, match="mixed"):
        ScoreService._uniform_k([{"sr": ["a"]}, {"sr": ["a", "b"]}])


def test_bucket_ladder_logic(model):
    """Powers of two up to group_batch; the smallest bucket that fits each
    micro-batch; an oversize micro-batch is rejected at this boundary."""
    svc = _service(model, group_batch=8)
    assert svc._ladder() == [1, 2, 4, 8]
    assert [svc._pick_g(n) for n in (1, 2, 3, 5, 8)] == [1, 2, 4, 8, 8]
    with pytest.raises(ValueError, match="exceeds group_batch"):
        svc._pick_g(20)
    assert svc._chunk_g(20) == 8
    svc.close()
    svc6 = _service(model, group_batch=6)
    assert svc6._ladder() == [1, 2, 4, 6]
    assert svc6._pick_g(5) == 6
    svc6.close()


def test_buckets_share_one_core(model, map_model):
    """Every (K, G) bucket's scorer reads the same folded tower, packed
    head and folded decoder (one copy on the card, whatever the buckets)."""
    svc = _service(model, map_cfg=MAP_CFG, map_model=map_model)
    a, b = svc.scorer(1, 1), svc.scorer(4, 4)
    assert a.pairs is b.pairs is svc._core
    assert a.pairs._tower_folded is b.pairs._tower_folded
    ma, mb = svc.map_scorer(1, 2), svc.map_scorer(3, 4)
    assert ma.pairs is mb.pairs is svc._map_core
    assert ma.pairs._decoder_folded is mb.pairs._decoder_folded
    svc.warmup([2])
    assert set(svc._scorers) == {(1, 1), (4, 4), (2, 1), (2, 2), (2, 4)}
    assert set(svc._map_scorers) == {(1, 2), (3, 4), (2, 1), (2, 2), (2, 4)}
    svc.close()
    with pytest.raises(ValueError, match="same model"):
        GroupedPairScorer(CFG, make_global_model(CFG), k=1, device="cpu",
                          pairs=svc._core)


def test_serve_stdio_protocol(model, paths):
    service = _service(model)
    lines = [
        json.dumps({"cmd": "ping"}),
        "this is not json",
        json.dumps({"id": 1, "gt": paths["gt"],
                    "sr": [paths["sr_a"], paths["sr_b"]]}),
        json.dumps({"id": 2, "gt": paths["gt"], "sr": paths["sr_a"]}),
        json.dumps({"id": 3, "gt": paths["bad"], "sr": [paths["sr_a"]]}),
        json.dumps({"id": 4, "sr": [paths["sr_a"]]}),  # missing gt
        json.dumps({"cmd": "shutdown"}),
        json.dumps({"id": 5, "gt": paths["gt"], "sr": paths["sr_a"]}),
    ]
    out = io.StringIO()
    rc = serve_stdio(service, io.StringIO("\n".join(lines) + "\n"), out)
    service.close()
    assert rc == 0
    resps = [json.loads(line) for line in out.getvalue().splitlines()]
    # Answered up to and including the shutdown ack, in order.
    assert resps[0] == {"ok": True}
    assert "bad JSON" in resps[1]["error"]
    r1 = resps[2]
    assert r1["id"] == 1 and len(r1["scores"]) == 2
    want = _grouped_want(model, paths, ("sr_a", "sr_b"))
    assert (want > 1.5).all()
    np.testing.assert_allclose(r1["scores"], want, rtol=1e-5, atol=1e-5)
    r2 = resps[3]
    assert r2["id"] == 2 and r2["score"] == r2["scores"][0]
    assert resps[4] == {"id": 3, "scores": [None]}  # NaN failure contract
    assert resps[5]["id"] == 4 and "error" in resps[5]
    assert resps[6] == {"ok": True, "shutdown": True}
    assert len(resps) == 7


def test_serve_stdio_micro_batch_order(model, paths):
    """Mixed-K requests already queued are answered in request order, and
    the same pair scores alike through the K = 1 and K = 2 buckets."""
    service = _service(model)
    reqs = [
        {"id": 10, "gt": paths["gt"], "sr": [paths["sr_a"]]},
        {"id": 11, "gt": paths["gt"], "sr": [paths["sr_a"], paths["sr_b"]]},
        {"id": 12, "gt": paths["gt"], "sr": [paths["sr_b"]]},
    ]
    out = io.StringIO()
    inp = io.StringIO("".join(json.dumps(r) + "\n" for r in reqs))
    assert serve_stdio(service, inp, out) == 0
    assert service.stats["device_batches"] == 2  # one a K
    service.close()
    resps = [json.loads(line) for line in out.getvalue().splitlines()]
    assert [r["id"] for r in resps] == [10, 11, 12]
    assert [len(r["scores"]) for r in resps] == [1, 2, 1]
    np.testing.assert_allclose(resps[0]["scores"][0], resps[1]["scores"][0],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(resps[2]["scores"][0], resps[1]["scores"][1],
                               rtol=1e-5, atol=1e-5)


def test_oversize_micro_batch_chunks_without_truncation(model, paths):
    """A micro-batch beyond group_batch goes as successive chunks (4 + 4 +
    1): every request answered, in order, as a lone request scores."""
    service = _service(model)
    req = {"gt": paths["gt"], "sr": [paths["sr_a"]]}
    r1 = service.handle(dict(req))
    resps = service.score_requests([dict(req, id=i) for i in range(9)])
    assert [r["id"] for r in resps] == list(range(9))
    assert service.stats["device_batches"] == 1 + 3
    for r in resps:
        np.testing.assert_allclose(r["scores"], r1["scores"],
                                   rtol=1e-5, atol=1e-5)
    service.close()


def test_bucketed_single_request_matches_full_batch(model, paths):
    """A lone request rides the G = 1 bucket and scores as a full batch
    does; a 3-request micro-batch picks G = 4."""
    service = _service(model)
    req = {"gt": paths["gt"], "sr": [paths["sr_a"]]}
    r1 = service.handle(dict(req))
    assert set(service._scorers) == {(1, 1)}
    resps = service.score_requests([dict(req) for _ in range(3)])
    assert set(service._scorers) == {(1, 1), (1, 4)}
    for r in resps:
        np.testing.assert_allclose(r["scores"], r1["scores"],
                                   rtol=1e-5, atol=1e-5)
    service.close()


def test_decode_cache_and_stats(model, paths, tmp_path):
    """Repeat requests hit the decoded-image LRU; {"cmd": "stats"} reports
    the counters; a new mtime is a miss; decode_cache=0 disables it."""
    gt = str(tmp_path / "gt_copy.png")  # own copy: the test rewrites it
    shutil.copyfile(paths["gt"], gt)
    service = _service(model, decode_cache=64)
    req = {"gt": gt, "sr": [paths["sr_a"]]}
    r1 = service.handle(dict(req))
    r2 = service.handle(dict(req))
    assert r1["scores"] == r2["scores"]
    st = service.handle({"cmd": "stats"})
    assert st["requests"] == 2 and st["device_batches"] == 2
    assert st["batched_pairs"] == 2 and st["errors"] == 0
    assert st["decode_cache_misses"] == 2
    assert st["decode_cache_hits"] == 2
    assert st["decode_cache_entries"] == 2
    assert st["warmed_k"] == [1]
    shutil.copyfile(paths["sr_b"], gt)
    os.utime(gt, ns=(1, 1))  # a new mtime: a miss
    service.handle(dict(req))
    assert service.handle({"cmd": "stats"})["decode_cache_misses"] == 3
    assert "error" in service.handle({"cmd": "nope"})
    service.close()

    off = _service(model, decode_cache=0)
    off.handle(dict(req))
    st3 = off.handle({"cmd": "stats"})
    assert st3["decode_cache_hits"] == 0 and st3["decode_cache_misses"] == 0
    assert st3["decode_cache_entries"] == 0
    off.close()


def test_collector_queue_wait_fill_and_spans(model, paths):
    """Concurrent requests: the collector counts each one's wait from its
    arrival to its take, ``stats`` reports the mean wait and the batch
    fill, and with the recorder on each request's queue span carries its
    id and each collected batch's span its requests' ids, with the device
    call's spans under it."""
    from srsem_torch.utils import profiling

    service = _service(model, linger_ms=50.0)
    st = service.handle({"cmd": "stats"})
    assert st["queue_wait_ms_mean"] is None and st["batch_fill"] is None
    n = 3
    results = [None] * n
    barrier = threading.Barrier(n)

    def worker(i):
        barrier.wait()
        results[i] = service.handle_concurrent(
            {"id": i, "gt": paths["gt"], "sr": [paths["sr_a"], paths["bad"]]})

    profiling.reset()
    profiling.enable()
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(n)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
            assert not th.is_alive()
    finally:
        profiling.disable()
    assert [r["id"] for r in results] == list(range(n))
    st = service.handle({"cmd": "stats"})
    assert st["collected_requests"] == n and st["queue_wait_s"] > 0
    assert st["queue_wait_ms_mean"] == pytest.approx(
        1e3 * st["queue_wait_s"] / n)
    # One null SR a request: half of the K = 2 slots of the n requests at
    # most, padding rows of the bucket empty too.
    assert st["batched_pairs"] == n
    assert st["batch_fill"] == pytest.approx(n / st["batch_slots"])
    assert 0 < st["batch_fill"] <= 0.5
    spans = profiling.snapshot()["spans"]
    profiling.reset()
    queued = [s for s in spans if s["name"] == "srsem.serve.queue"]
    assert sorted(s["attrs"]["id"] for s in queued) == list(range(n))
    batches = [s for s in spans if s["name"] == "srsem.serve.batch"]
    assert sorted(i for b in batches for i in b["attrs"]["ids"]) == list(range(n))
    ids = {b["id"] for b in batches}
    scored = [s for s in spans if s["name"] == "srsem.score"]
    assert scored and all(s["parent"] in ids and s["call"] == s["parent"]
                          for s in scored)
    assert {s["attrs"]["kind"] for s in scored} == {"grouped"}
    service.close()


def test_serve_maps(model, map_model, paths, tmp_path):
    """CLU map requests: mean/min summaries and .npy maps in maps_dir, with
    service-unique names; a corrupt SR gives nulls; a maps request against
    a score-only service errors instead of crashing."""
    service = _service(model, map_cfg=MAP_CFG, map_model=map_model)
    req = {"id": 20, "gt": paths["gt"], "sr": [paths["sr_a"], paths["bad"]],
           "maps": True, "maps_dir": str(tmp_path / "maps")}
    resp = service.handle(dict(req))
    again = service.handle(dict(req))
    assert resp["id"] == 20 and resp["map_means"][1] is None
    assert resp["maps"][1] is None and resp["map_mins"][1] is None
    assert 0.5 <= resp["map_mins"][0] <= resp["map_means"][0] <= 1.0
    m = np.load(resp["maps"][0])
    assert m.shape == (32, 32) and np.isfinite(m).all()
    assert abs(float(m.mean()) - resp["map_means"][0]) < 1e-6
    assert again["maps"][0] != resp["maps"][0]  # never overwritten
    assert sorted(os.listdir(tmp_path / "maps")) == [
        "sr_a__0_0.npy", "sr_a__1_0.npy"]
    scalar = service.handle({"gt": paths["gt"], "sr": paths["sr_a"],
                             "maps": True})
    assert "maps" not in scalar and scalar["map_min"] == scalar["map_mins"][0]
    assert abs(scalar["map_mean"] - resp["map_means"][0]) < 1e-5
    # The maps agree with the grouped map scorer on the same images.
    msc = GroupedMapScorer(MAP_CFG, map_model, k=1, batch_size=1,
                           device="cpu")
    gt = msc.preprocess.decode_uint8(paths["gt"])[None]
    sr = msc.preprocess.decode_uint8(paths["sr_a"])[None, None]
    np.testing.assert_allclose(m, msc.score_arrays(gt, sr).numpy()[0, 0],
                               rtol=1e-5, atol=1e-5)
    service.close()

    score_only = _service(model)
    r2 = score_only.handle({"gt": paths["gt"], "sr": paths["sr_a"],
                            "maps": True})
    score_only.close()
    assert "error" in r2 and "CLU" in r2["error"]


def test_http_coalesces_concurrent_requests(model, paths):
    """Concurrent HTTP clients share padded device calls (the dynamic
    batcher): 8 same-K requests land in fewer device batches, with the
    lone request's scores; a maps request without a CLU model resolves to
    an error; shutdown stops the server; after close() no call hangs."""
    service = _service(model, linger_ms=500.0)
    want = service.handle({"gt": paths["gt"], "sr": [paths["sr_a"],
                                                       paths["sr_b"]]})
    server = serve_http(service, 0)  # ephemeral port
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    port = server.server_address[1]

    def post(obj):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/", data=json.dumps(obj).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            return json.loads(r.read())

    assert post({"cmd": "ping"}) == {"ok": True}
    before = service.stats["device_batches"]
    n = 8
    results = [None] * n
    barrier = threading.Barrier(n)

    def worker(i):
        barrier.wait()
        results[i] = post({"id": i, "gt": paths["gt"],
                           "sr": [paths["sr_a"], paths["sr_b"]]})

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
        assert not th.is_alive()
    for i, r in enumerate(results):
        assert r["id"] == i
        np.testing.assert_allclose(r["scores"], want["scores"],
                                   rtol=1e-5, atol=1e-5)
    batches = service.stats["device_batches"] - before
    assert 1 <= batches < n, batches
    r_err = post({"id": 9, "gt": paths["gt"], "sr": paths["sr_a"],
                  "maps": True})
    assert "CLU" in r_err["error"] and r_err["id"] == 9
    assert post({"cmd": "shutdown"})["shutdown"] is True
    t.join(timeout=30)
    assert not t.is_alive()
    server.server_close()
    service.close()
    late = service.handle_concurrent({"id": 1, "gt": paths["gt"],
                                      "sr": paths["sr_a"]})
    assert late == {"error": "service closed", "id": 1}


def _jax_global_variables(model):
    head = convert_global_head(model.aggregator.state_dict())
    return {"params": {
        "backbone": convert_torch_resnet50(model.backbone.state_dict()),
        **head}}


def _jax_local_variables(model):
    sd = model.state_dict()
    dec = convert_clu_decoder({k: v for k, v in sd.items()
                               if k.startswith("decoder.")})
    tower = convert_clip_resnet50({k[len("backbone."):]: v
                                   for k, v in sd.items()
                                   if k.startswith("backbone.")})
    return {"params": {"backbone": tower, **dec["params"]},
            "batch_stats": dec["batch_stats"]}


def test_score_and_map_requests_match_jax(model, map_model, paths):
    """The port's score_requests and map_requests against JAX's
    ScoreService on the same weights and files: one (G = 2, K = 2) bucket,
    a corrupt SR in the second request."""
    reqs = [{"id": 0, "gt": paths["gt"], "sr": [paths["sr_a"], paths["sr_b"]]},
            {"id": 1, "gt": paths["gt"], "sr": [paths["sr_b"], paths["bad"]]}]
    jbb = JaxBackboneConfig(kind="resnet50", image_size=64,
                            compute_dtype="float32")
    jcfg = JaxGlobalConfig(backbone=jbb, head="stages_cnn", depth=3)
    jlcfg = JaxLocalConfig(backbone=JaxBackboneConfig(
        kind="resnet50_clip", image_size=32, compute_dtype="float32"))
    jsvc = JaxScoreService(jcfg, _jax_global_variables(model), group_batch=2,
                           map_cfg=jlcfg,
                           map_variables=_jax_local_variables(map_model))
    port = _service(model, group_batch=2, map_cfg=MAP_CFG,
                    map_model=map_model)
    mreqs = [dict(r, maps=True) for r in reqs]
    try:
        scored = (jsvc.score_requests(reqs), port.score_requests(reqs))
        mapped = (jsvc.map_requests(mreqs), port.map_requests(mreqs))
        assert [r["id"] for r in scored[1] + mapped[1]] == [0, 1, 0, 1]
        for (want, got), key, tol in ((scored, "scores", 1e-3),
                                      (mapped, "map_means", 2e-3),
                                      (mapped, "map_mins", 2e-3)):
            g = [v for r in got for v in r[key]]
            w = [v for r in want for v in r[key]]
            assert [v is None for v in g] == [v is None for v in w] == [
                False, False, False, True]
            np.testing.assert_allclose(g[:3], w[:3], rtol=tol, atol=tol)
        assert min(s for s in scored[0][0]["scores"]) > 1.5  # live head
        means = mapped[0][0]["map_means"]
        assert 0.5 < min(means) and max(means) < 1.0  # live sigmoid range
    finally:
        jsvc.close()
        port.close()


def _cli(args, stdin=""):
    return subprocess.run(
        [sys.executable, "-m", "srsem_torch", *args], input=stdin,
        cwd=REPO, capture_output=True, text=True, timeout=300)


def test_cli_serve_stdio(paths, tmp_path):
    """``python -m srsem_torch serve --device cpu`` fed a JSONL script:
    warmup ready line, ping, a K = 2 request, a corrupt GT, a maps request
    with maps_dir, stats, shutdown; exit 0."""
    script = "".join(json.dumps(r) + "\n" for r in (
        {"cmd": "ping"},
        {"id": 1, "gt": paths["gt"], "sr": [paths["sr_a"], paths["sr_b"]]},
        {"id": 2, "gt": paths["bad"], "sr": paths["sr_a"]},
        {"id": 3, "gt": paths["gt"], "sr": [paths["sr_a"]], "maps": True,
         "maps_dir": str(tmp_path / "maps")},
        {"cmd": "stats"},
        {"cmd": "shutdown"}))
    proc = _cli(["serve", "--device", "cpu", "--image-size", "32",
                 "--dtype", "float32", "--depth", "2", "--warmup-k", "1",
                 "--with-maps", "--group-batch", "2"], script)
    assert proc.returncode == 0, proc.stderr
    ready = json.loads(proc.stderr.strip().splitlines()[-1])
    assert ready == {"ready": True, "warmed_k": [1], "device": "cpu"}
    resps = [json.loads(line) for line in proc.stdout.splitlines()]
    assert resps[0] == {"ok": True}
    assert resps[1]["id"] == 1 and len(resps[1]["scores"]) == 2
    assert all(isinstance(s, float) for s in resps[1]["scores"])
    assert resps[2] == {"id": 2, "scores": [None], "score": None}
    assert resps[3]["id"] == 3 and os.path.exists(resps[3]["maps"][0])
    assert 0.0 <= resps[3]["map_means"][0] <= 1.0
    assert resps[4]["warmed_k"] == [1, 2]
    assert resps[5] == {"ok": True, "shutdown": True}


def test_cli_serve_refuses_without_card_and_vit_heads():
    """``serve`` runs on cuda unless given --device cpu; a ViT head needs
    ``--backbone vit_clip`` (the default ResNet tower refuses it)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = _cli(["serve", "--image-size", "32", "--warmup-k"])
    assert proc.returncode != 0 and "device='cpu'" in proc.stderr
    proc = _cli(["serve", "--device", "cpu", "--head", "stages_vit"])
    assert proc.returncode != 0 and "ViT tower" in proc.stderr


def test_profile_flag_writes_trace(tmp_path):
    """The global --profile DIR wraps the subcommand in a torch.profiler
    trace; ``info`` without --devices leaves CUDA uninitialized."""
    from srsem_torch.cli.main import main

    out = tmp_path / "prof"
    assert main(["--profile", str(out), "info"]) == 0
    trace = json.loads((out / "trace.json").read_text())
    assert "traceEvents" in trace
    assert set(json.loads((out / "spans.json").read_text())) == {
        "spans", "counters"}
    assert not torch.cuda.is_initialized()
    proc = _cli(["info", "--native"])
    assert proc.returncode == 0, proc.stderr
    info = json.loads(proc.stdout)
    assert set(info["versions"]) == {"torch", "numpy", "Pillow"}
    assert "native_decoder" in info and "cuda" not in info


def test_profiling_helpers(tmp_path):
    """span names a region in the capture_trace Chrome trace, and
    capture_trace writes the block's spans and the counters beside it;
    outside the capture the recorder is off again."""
    from srsem_torch.utils import profiling
    from srsem_torch.utils.profiling import capture_trace, span

    with capture_trace(str(tmp_path)):
        with span("srsem_region", rows=8):
            torch.ones(8).sum()
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert any(e.get("name") == "srsem_region" for e in trace["traceEvents"])
    spans = json.loads((tmp_path / "spans.json").read_text())
    mine = [s for s in spans["spans"] if s["name"] == "srsem_region"]
    assert len(mine) == 1 and mine[0]["attrs"] == {"rows": 8}
    assert mine[0]["parent"] is None and mine[0]["call"] == mine[0]["id"]
    assert "launches.fused_bottleneck" in spans["counters"]
    assert not profiling._on
    assert span("srsem_region") is span("srsem_other")
