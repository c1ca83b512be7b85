"""Persistent scoring service — the port of srsem/cli/serve.py, the
production serving surface: ONE process builds the frozen model once,
folds its weights onto the card once, and serves requests.

Protocol (JSON Lines over stdio; the same schema over the optional
embedded HTTP endpoint):

    → {"id": 7, "gt": "gt.jpg", "sr": ["a.jpg", "b.jpg"]}
    ← {"id": 7, "scores": [0.013, 0.175]}

* ``sr`` may be a single path (``"score"`` is then echoed as a scalar
  beside the one-element ``"scores"``).
* A failed decode gives ``null`` for that pair — the NaN-row failure
  contract (reference: 1_compute_image_metrics.py:119-134) — never a crash.
* ``{"cmd": "ping"}`` → ``{"ok": true}``; ``{"cmd": "stats"}`` → the
  counters; ``{"cmd": "shutdown"}`` ends the loop.  Malformed requests get
  ``{"error": ...}`` responses.
* With a CLU model (``serve --with-maps``), ``{"maps": true[, "maps_dir":
  DIR]}`` asks for fidelity maps: mean/min summaries in the response, the
  full maps as ``.npy`` under ``maps_dir``.

Serving mechanics:

* Requests are scored by a :class:`GroupedPairScorer` (maps: a
  :class:`GroupedMapScorer`), so the GT tower pass is shared across the K
  SR pairs of a request: 1 + K tower images instead of 2K.
* Device calls are padded to (G, K) with G from a power-of-two bucket
  ladder up to ``group_batch``: a lone request runs G = 1, full
  micro-batches G = group_batch, and a response does not depend on which
  bucket served it.  Same-K requests arriving together are micro-batched
  into one device call (``linger_ms`` collection window); concurrent HTTP
  requests coalesce the same way through a dynamic batcher
  (:meth:`ScoreService.handle_concurrent`).
* One card, no mesh.  Every (K, G) bucket's scorer shares ONE PairScorer
  core a model, so the folded tower (or the ViT module), the packed head
  and the folded decoder exist once on the card whatever the number of
  buckets.
* Device calls (and their ``.cpu()``) run under the service lock; host
  decode runs in a thread pool and through a decoded-image LRU.
"""

from __future__ import annotations

import concurrent.futures as cf
import json
import math
import os
import queue
import sys
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, TextIO

import numpy as np

from srsem_torch.device import DeviceLike
from srsem_torch.eval.grouped import (
    GroupedMapScorer,
    GroupedPairScorer,
    check_grouped_head,
)
from srsem_torch.eval.scorer import PairScorer


def _nan_to_none(x: float) -> Optional[float]:
    return None if math.isnan(x) else float(x)


class ScoreService:
    """Long-lived scorer registry: one GroupedPairScorer per (K, G) bucket,
    all sharing one PairScorer core.

    Thread-safe for the HTTP handler (device calls serialized by a lock —
    one card, one batch at a time).  ``model`` is the global model
    (a linear head: stages_cnn, wperlay_cnn or a ViT token head);
    ``map_cfg``/``map_model`` a CluUnet for maps requests.  Load weights
    before building the service: the weights are folded here, once."""

    def __init__(self, cfg, model, group_batch: int = 8,
                 num_workers: int = 16, fast_jpeg: bool = False,
                 map_cfg=None, map_model=None, linger_ms: float = 2.0,
                 decode_cache: int = 256, device: DeviceLike = None):
        check_grouped_head(cfg.head)
        if group_batch < 1:
            raise ValueError(f"group_batch must be >= 1, got {group_batch}")
        self.cfg = cfg
        self.group_batch = group_batch
        self._buckets = self._build_ladder()
        self.num_workers = num_workers
        self.fast_jpeg = fast_jpeg
        self.map_cfg = map_cfg
        self.linger_ms = linger_ms
        self.decode_cache = max(0, int(decode_cache))  # <=0 disables
        # The shared cores: the model's weights folded onto the card once.
        self._core = PairScorer(cfg, model, batch_size=group_batch,
                                fast_jpeg=fast_jpeg, device=device)
        self.device = self._core.device
        self._map_core = None
        if map_cfg is not None:
            self._map_core = PairScorer(map_cfg, map_model,
                                        batch_size=group_batch,
                                        model_kind="local",
                                        fast_jpeg=fast_jpeg,
                                        device=self.device)
        self._scorers: Dict[tuple, GroupedPairScorer] = {}
        self._map_scorers: Dict[tuple, GroupedMapScorer] = {}
        self._lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self._pool = cf.ThreadPoolExecutor(max_workers=num_workers)
        self._batch_q: "queue.Queue" = queue.Queue()
        self._collector: Optional[threading.Thread] = None
        self._collector_lock = threading.Lock()
        self._closed = False
        self._map_seq = 0  # service-unique .npy naming (map_requests)
        self._decoded: "OrderedDict" = OrderedDict()  # LRU: see _decode_cached
        self._cache_lock = threading.Lock()
        self.stats: Dict[str, int] = {
            "requests": 0, "errors": 0, "device_batches": 0,
            "batched_pairs": 0, "decode_cache_hits": 0,
            "decode_cache_misses": 0,
        }

    def _count(self, key: str, n: int = 1) -> None:
        """All counter mutations go through ONE lock — mixed-lock
        read-modify-writes drop increments under concurrency."""
        with self._stats_lock:
            self.stats[key] += n

    def _build_ladder(self) -> List[int]:
        """Batch-shape buckets: powers of two below group_batch, then
        group_batch.  A lone request pays a G = 1 call, not the full padded
        (group_batch, K) one."""
        out, g = [], 1
        while g < self.group_batch:
            out.append(g)
            g *= 2
        out.append(self.group_batch)
        return out

    def _ladder(self) -> List[int]:
        return self._buckets

    def _pick_g(self, n: int) -> int:
        """Smallest bucket that fits ``n``.  Rejects ``n`` beyond the top
        bucket: a (G, K) device call holds at most ``group_batch``
        requests, so an oversize micro-batch would silently score only the
        first G.  Chunking oversize batches is ``_decoded_chunks``'s job."""
        if n > self.group_batch:
            raise ValueError(
                f"micro-batch of {n} exceeds group_batch="
                f"{self.group_batch}; chunk it (see _decoded_chunks)")
        for g in self._buckets:
            if g >= n:
                return g
        return self.group_batch

    def _chunk_g(self, n: int) -> int:
        """Bucket for the NEXT chunk of an ``n``-request stream (``n``
        beyond ``group_batch`` clamps to the top bucket)."""
        return self._pick_g(min(n, self.group_batch))

    def scorer(self, k: int, g: Optional[int] = None) -> GroupedPairScorer:
        g = g or self.group_batch
        with self._lock:
            sc = self._scorers.get((k, g))
            if sc is None:
                sc = GroupedPairScorer(
                    self.cfg, self._core.model, k=k, batch_size=g,
                    num_workers=self.num_workers, pairs=self._core)
                self._scorers[(k, g)] = sc
        return sc

    def map_scorer(self, k: int, g: Optional[int] = None) -> GroupedMapScorer:
        if self._map_core is None:
            raise RuntimeError(
                "map requests need a CLU model — start the service with "
                "map_cfg/map_model (CLI: serve --with-maps)")
        g = g or self.group_batch
        with self._lock:
            sc = self._map_scorers.get((k, g))
            if sc is None:
                sc = GroupedMapScorer(self.map_cfg, self._map_core.model, k=k,
                                      batch_size=g, pairs=self._map_core)
                self._map_scorers[(k, g)] = sc
        return sc

    def warmup(self, ks: Sequence[int]) -> None:
        """Build every kernel library (on the card) and run every ladder
        (G, K) bucket once — scoring AND (with a CLU model) maps — so the
        first request pays neither nvcc nor cuDNN's autotuning.  Unwarmed
        K values still work; their first call pays those costs."""
        if self.device.type == "cuda":
            from srsem_torch.ops import _build

            _build.build_all()
        size = self.cfg.backbone.image_size
        for k in ks:
            for g in self._ladder():
                sc = self.scorer(k, g)
                with self._lock:
                    sc.score_arrays(np.zeros((g, size, size, 3), np.uint8),
                                    np.zeros((g, k, size, size, 3), np.uint8)
                                    ).cpu()
                if self._map_core is not None:
                    msize = self.map_cfg.backbone.image_size
                    msc = self.map_scorer(k, g)
                    with self._lock:
                        msc.score_arrays(
                            np.zeros((g, msize, msize, 3), np.uint8),
                            np.zeros((g, k, msize, msize, 3), np.uint8)).cpu()

    def close(self) -> None:
        self._closed = True
        if self._collector is not None:
            self._batch_q.put(None)
            self._collector.join(timeout=60)
            # Resolve anything enqueued after the sentinel (e.g. an HTTP
            # handler thread racing shutdown) — futures must never hang.
            while True:
                try:
                    item = self._batch_q.get_nowait()
                except queue.Empty:
                    break
                if item is not None:
                    try:
                        item[1].set_result({"error": "service closed"})
                    except cf.InvalidStateError:
                        pass  # already resolved (raced the put-side guard)
        self._pool.shutdown(wait=False)

    # ---- cross-request dynamic batching ------------------------------------

    def handle_concurrent(self, req: dict) -> dict:
        """:meth:`handle` for CONCURRENT callers (the HTTP threads).

        Each device call runs a padded (G, K) batch, so N concurrent
        clients going through :meth:`handle` would cost N calls with one
        used slot each.  This path parks the request on a collector that
        coalesces whatever arrives within ``linger_ms`` (grouped by
        maps?/K, up to G per call) into SHARED device calls, with identical
        responses.  Control and malformed requests answer inline."""
        if not isinstance(req, dict) or "cmd" in req:
            return self.handle(req)
        norm = _normalize(req)
        if "error" in norm:
            self._count("errors")
            return norm
        if self._closed:
            out = {"error": "service closed"}
            if "id" in norm:
                out["id"] = norm["id"]
            return out
        fut: "cf.Future" = cf.Future()
        self._ensure_collector()
        self._batch_q.put((norm, fut))
        if self._closed and not fut.done():
            # Raced close(): the collector may already have exited and
            # close()'s drain may have run before our put — never hang.
            try:
                fut.set_result({"error": "service closed"})
            except cf.InvalidStateError:
                pass  # already resolved by the collector or the drain
        return fut.result()

    def _ensure_collector(self) -> None:
        if self._collector is None:
            with self._collector_lock:
                if self._collector is None:
                    t = threading.Thread(target=self._collect_loop,
                                         daemon=True)
                    t.start()
                    self._collector = t

    def _collect_loop(self) -> None:
        while True:
            item = self._batch_q.get()
            if item is None:
                return
            pending = [item]
            stop = False
            # Absolute deadline: a per-get timeout would RESTART the window
            # on every arrival, stretching the first request's wait to
            # (group_batch-1)x linger under a slow trickle.
            deadline = (time.monotonic()
                        + max(self.linger_ms, 0.0) / 1000.0)
            while len(pending) < self.group_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._batch_q.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    stop = True
                    break
                pending.append(nxt)
            self._drain_batch(pending)
            if stop:
                return

    def _drain_batch(self, pending) -> None:
        """Score a collected batch grouped by (maps?, K); EVERY future
        resolves — failures become error responses, never hangs."""
        by_key: Dict[tuple, list] = {}
        for norm, fut in pending:
            by_key.setdefault(
                (bool(norm.get("maps")), len(norm["sr"])), []).append(
                (norm, fut))
        for (is_maps, _k), items in by_key.items():
            fn = self.map_requests if is_maps else self.score_requests
            try:
                resps = fn([n for n, _ in items])
            except Exception as e:  # the collector must outlive a bad batch
                self._count("errors", len(items))
                resps = [{"error": str(e)[:300],
                          **({"id": n["id"]} if "id" in n else {})}
                         for n, _ in items]
            for (_, fut), resp in zip(items, resps):
                try:
                    fut.set_result(resp)
                except cf.InvalidStateError:
                    # Raced close(): handle_concurrent's put-side guard or
                    # close()'s drain already resolved this future.
                    pass

    # ---- request handling --------------------------------------------------

    def _decode_cached(self, sc, path: str):
        """Decode one image through the service LRU.

        Serving traffic repeats images (the same GT against successive SR
        batches, retries).  The key is (path, mtime, preprocess identity):
        an overwritten file is a miss, and the score and maps pipelines
        (different backbones → different crop_pct) never share pixels.
        ``decode_cache=0`` disables."""
        pre = sc.preprocess
        key = None
        if self.decode_cache > 0:
            try:
                key = (str(path), os.stat(path).st_mtime_ns, pre.size,
                       float(pre.crop_pct), int(pre.interpolation))
            except OSError:
                return None
            with self._cache_lock:
                if key in self._decoded:
                    self._decoded.move_to_end(key)
                    self._count("decode_cache_hits")
                    return self._decoded[key]
        try:
            img = pre.decode_uint8(str(path))
        except Exception:  # per-item failure contract: the pair becomes null
            return None
        if key is not None:
            self._count("decode_cache_misses")
            with self._cache_lock:
                self._decoded[key] = img
                while len(self._decoded) > self.decode_cache:
                    self._decoded.popitem(last=False)
        return img

    def _decoded_chunks(self, get_scorer, requests: List[dict], k: int):
        """Decode a same-K micro-batch (thread pool) and pack it into
        padded (G, K) device shapes, G picked per chunk from the bucket
        ladder.  Yields ``(chunk_requests, ok, result)`` per chunk, the
        result as a float32 numpy array; ``ok[i, m]`` is False where the
        GT or that SR failed to decode (→ the NaN failure contract)."""
        sc0 = get_scorer(self._chunk_g(len(requests)))
        size = sc0.preprocess.size

        flat: List[str] = []
        for r in requests:
            flat.append(r["gt"])
            flat.extend(r["sr"])
        decoded = list(self._pool.map(
            lambda p: self._decode_cached(sc0, p), flat))

        start = 0
        while start < len(requests):
            g = self._chunk_g(len(requests) - start)
            sc = get_scorer(g)
            chunk = requests[start: start + g]
            gt = np.zeros((g, size, size, 3), np.uint8)
            sr = np.zeros((g, k, size, size, 3), np.uint8)
            ok = np.zeros((g, k), bool)
            for i, r in enumerate(chunk):
                j = (start + i) * (1 + k)
                imgs = decoded[j: j + 1 + k]
                if imgs[0] is not None:
                    gt[i] = imgs[0]
                    for m, im in enumerate(imgs[1:]):
                        if im is not None:
                            sr[i, m] = im
                            ok[i, m] = True
            self._count("device_batches")
            self._count("batched_pairs", int(ok.sum()))
            with self._lock:
                result = sc.score_arrays(gt, sr).float().cpu().numpy()
            yield chunk, ok, result
            start += len(chunk)

    @staticmethod
    def _uniform_k(requests: List[dict]) -> int:
        """The batchers group by K before calling the public scoring
        methods, but those are public API: a mixed-K batch would misalign
        ``_decoded_chunks``'s (1+K)-strided layout and return WRONG
        scores, so the invariant is enforced at this boundary."""
        k = len(requests[0]["sr"])
        if any(len(r["sr"]) != k for r in requests):
            raise ValueError(
                f"mixed per-request K in one micro-batch "
                f"({sorted({len(r['sr']) for r in requests})}); group "
                "requests by K (serve_stdio/_drain_batch do)")
        return k

    def score_requests(self, requests: List[dict]) -> List[dict]:
        """Score a same-K micro-batch in padded device calls of at most
        ``group_batch`` requests."""
        self._count("requests", len(requests))
        k = self._uniform_k(requests)
        out: List[dict] = []
        for chunk, ok, scores in self._decoded_chunks(
                lambda g: self.scorer(k, g), requests, k):
            scores[~ok] = np.nan
            for i, r in enumerate(chunk):
                resp = {"scores": [_nan_to_none(v) for v in scores[i]]}
                if "id" in r:
                    resp["id"] = r["id"]
                if r.get("_scalar"):
                    resp["score"] = resp["scores"][0]
                out.append(resp)
        return out

    def map_requests(self, requests: List[dict]) -> List[dict]:
        """Same-K CLU map micro-batch: per pair a fidelity map — its
        mean/min in the response, the full map as .npy when the request
        names a ``maps_dir``.  Filesystem failures (an unwritable
        maps_dir) error that REQUEST only, never the batch or the server."""
        self._count("requests", len(requests))
        k = self._uniform_k(requests)
        self.map_scorer(  # CLU model check before any decode work
            k, self._chunk_g(len(requests)))
        out: List[dict] = []
        for chunk, ok, maps in self._decoded_chunks(
                lambda g: self.map_scorer(k, g), requests, k):
            for i, r in enumerate(chunk):
                means, mins, paths = [], [], []
                maps_dir = r.get("maps_dir")
                write_err = None
                if maps_dir:
                    try:
                        os.makedirs(maps_dir, exist_ok=True)
                    except OSError as e:
                        write_err = f"maps_dir: {e}"
                for m in range(k):
                    if not ok[i, m]:
                        means.append(None)
                        mins.append(None)
                        paths.append(None)
                        continue
                    means.append(float(maps[i, m].mean()))
                    mins.append(float(maps[i, m].min()))
                    if maps_dir and write_err is None:
                        stem = os.path.splitext(
                            os.path.basename(r["sr"][m]))[0]
                        # Service-unique sequence number: batch-relative
                        # indices would collide across micro-batches that
                        # share a maps_dir.
                        with self._stats_lock:
                            seq = self._map_seq
                            self._map_seq += 1
                        p = os.path.join(maps_dir, f"{stem}__{seq}_{m}.npy")
                        try:
                            np.save(p, maps[i, m])
                            paths.append(p)
                        except OSError as e:
                            write_err = f"map write: {e}"
                            paths.append(None)
                    elif maps_dir:
                        paths.append(None)
                resp = {"map_means": means, "map_mins": mins}
                if r.get("_scalar"):
                    resp["map_mean"] = means[0]
                    resp["map_min"] = mins[0]
                if maps_dir:
                    resp["maps"] = paths
                if write_err:
                    resp["error"] = write_err[:300]
                if "id" in r:
                    resp["id"] = r["id"]
                out.append(resp)
        return out

    def handle(self, req: dict) -> dict:
        """One request → one response (control commands included)."""
        if not isinstance(req, dict):
            return {"error": "request must be a JSON object"}
        if "cmd" in req:
            if req["cmd"] == "ping":
                return {"ok": True}
            if req["cmd"] == "stats":
                with self._stats_lock:
                    out = dict(self.stats)
                with self._cache_lock:
                    out["decode_cache_entries"] = len(self._decoded)
                with self._lock:  # the registries change under _lock
                    out["warmed_k"] = sorted({kk for kk, _g in self._scorers})
                return out
            if req["cmd"] == "shutdown":
                return {"ok": True, "shutdown": True}
            return {"error": f"unknown cmd {req['cmd']!r}"}
        norm = _normalize(req)
        if "error" in norm:
            self._count("errors")
            return norm
        try:
            if norm.get("maps"):
                return self.map_requests([norm])[0]
            return self.score_requests([norm])[0]
        except Exception as e:  # one bad request must never kill the loop
            self._count("errors")
            out = {"error": str(e)[:300]}
            if "id" in norm:
                out["id"] = norm["id"]
            return out


def _normalize(req: dict) -> dict:
    """Validate + normalize a scoring request (sr always a list).

    Never raises: callers invoke it outside their per-request try blocks,
    so a malformed value — e.g. a non-iterable ``sr: 5`` — must come back
    as an error RESPONSE, not a TypeError that kills the serve loop."""
    gt = req.get("gt")
    sr = req.get("sr")
    if (not isinstance(gt, str) or not sr
            or not isinstance(sr, (str, list, tuple))):
        out = {"error": "request needs 'gt' (path) and 'sr' (path or list)"}
        if "id" in req:
            out["id"] = req["id"]
        return out
    scalar = isinstance(sr, str)
    sr_list = [sr] if scalar else list(sr)
    if not all(isinstance(p, str) for p in sr_list):
        out = {"error": "'sr' entries must be paths"}
        if "id" in req:
            out["id"] = req["id"]
        return out
    norm = {"gt": gt, "sr": sr_list, "_scalar": scalar}
    if req.get("maps"):
        norm["maps"] = True
        if req.get("maps_dir"):
            norm["maps_dir"] = str(req["maps_dir"])
    if "id" in req:
        norm["id"] = req["id"]
    return norm


def serve_stdio(service: ScoreService, inp: TextIO, out: TextIO,
                linger_ms: float = 0.0) -> int:
    """JSONL request/response loop.

    A reader thread drains ``inp`` into a queue; the main loop
    micro-batches same-K requests that are already waiting (plus an
    optional ``linger_ms`` collection window) into padded device calls.
    Responses keep request order."""
    q: "queue.Queue[Optional[str]]" = queue.Queue()

    def reader() -> None:
        for line in inp:
            q.put(line)
        q.put(None)  # EOF

    t = threading.Thread(target=reader, daemon=True)
    t.start()

    def emit(resp: dict) -> None:
        out.write(json.dumps(resp) + "\n")
        out.flush()

    eof = False
    while not eof:
        line = q.get()
        if line is None:
            break
        pending = [line]
        # Drain whatever is already queued (micro-batch window), against
        # an absolute deadline (see _collect_loop).
        deadline = time.monotonic() + linger_ms / 1000.0
        while len(pending) < service.group_batch:
            try:
                if linger_ms:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    nxt = q.get(timeout=remaining)
                else:
                    nxt = q.get_nowait()
            except queue.Empty:
                break
            if nxt is None:
                eof = True
                break
            pending.append(nxt)

        # Parse; control and malformed lines answer inline, scoring ones
        # are batched.
        batch: List[dict] = []
        order: List[tuple] = []  # ("resp", dict) | ("req", index into batch)
        shutdown = False
        for raw in pending:
            raw = raw.strip()
            if not raw:
                continue
            try:
                req = json.loads(raw)
            except ValueError as e:
                order.append(("resp", {"error": f"bad JSON: {e}"}))
                continue
            if isinstance(req, dict) and "cmd" in req:
                resp = service.handle(req)
                order.append(("resp", resp))
                if resp.get("shutdown"):
                    shutdown = True
                    break
                continue
            norm = _normalize(req if isinstance(req, dict) else {})
            if "error" in norm:
                order.append(("resp", norm))
            else:
                order.append(("req", len(batch)))
                batch.append(norm)

        # Score: group by (maps?, K), keep the order within the batch.
        responses: Dict[int, dict] = {}
        by_k: Dict[tuple, List[int]] = {}
        for i, r in enumerate(batch):
            by_k.setdefault((bool(r.get("maps")), len(r["sr"])), []).append(i)
        for (is_maps, _k), idxs in by_k.items():
            fn = service.map_requests if is_maps else service.score_requests
            try:
                resps = fn([batch[i] for i in idxs])
            except Exception as e:  # maps without a CLU model, a bad
                # maps_dir, decode surprises: error the micro-batch, never
                # the serve loop.
                resps = [{"error": str(e)[:300],
                          **({"id": batch[i]["id"]}
                             if "id" in batch[i] else {})} for i in idxs]
            for i, resp in zip(idxs, resps):
                responses[i] = resp
        for kind, val in order:
            emit(val if kind == "resp" else responses[val])
        if shutdown:
            return 0
    return 0


def serve_http(service: ScoreService, port: int, host: str = "127.0.0.1"):
    """Embedded HTTP endpoint (stdlib only): POST / with the stdio
    protocol's JSON schema, one thread a connection, a listen backlog of
    128.  Returns the bound server (the caller runs ``serve_forever``);
    ``port=0`` binds an ephemeral port."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def do_POST(self) -> None:  # noqa: N802 (stdlib API name)
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                # Concurrent HTTP threads coalesce into shared padded
                # device calls (ScoreService.handle_concurrent).
                resp = service.handle_concurrent(req)
            except Exception as e:  # answer every request
                resp = {"error": str(e)[:300]}
            body = json.dumps(resp).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            if resp.get("shutdown"):
                threading.Thread(target=self.server.shutdown,
                                 daemon=True).start()

        def log_message(self, *args) -> None:  # quiet
            pass

    class Server(ThreadingHTTPServer):
        # socketserver's default listen backlog of 5 resets connections
        # when more clients connect at once than that.
        request_queue_size = 128

    return Server((host, port), Handler)


def run_serve(args) -> int:
    """CLI entry: build the models once (seeded weights, then the given
    checkpoints), then serve over stdio or HTTP."""
    import torch

    from srsem_torch.cli.main import _load_backbone, _load_checkpoint
    from srsem_torch.config import (
        BackboneConfig,
        GlobalModelConfig,
        LocalModelConfig,
    )
    from srsem_torch.models.global_models import make_global_model
    from srsem_torch.models.local_models import make_local_model

    cfg = GlobalModelConfig(
        backbone=BackboneConfig(kind=args.backbone,
                                image_size=args.image_size,
                                compute_dtype=args.dtype),
        head=args.head, depth=args.depth)
    check_grouped_head(cfg.head)
    model = make_global_model(cfg, torch.Generator().manual_seed(0))
    _load_backbone(model.backbone, cfg.backbone.kind, args.backbone_checkpoint)
    _load_checkpoint(model, args.checkpoint)

    map_cfg = map_model = None
    if args.with_maps:
        map_cfg = LocalModelConfig(
            backbone=BackboneConfig(kind=args.clu_backbone,
                                    image_size=args.image_size,
                                    compute_dtype=args.dtype))
        map_model = make_local_model(
            map_cfg, generator=torch.Generator().manual_seed(0))
        _load_checkpoint(map_model, args.clu_checkpoint)

    service = ScoreService(cfg, model, group_batch=args.group_batch,
                           num_workers=args.num_workers,
                           fast_jpeg=args.fast_jpeg,
                           map_cfg=map_cfg, map_model=map_model,
                           linger_ms=(2.0 if args.linger_ms is None
                                      else args.linger_ms),
                           decode_cache=args.decode_cache,
                           device=args.device)
    try:
        if args.warmup_k:
            service.warmup(args.warmup_k)
            print(json.dumps({"ready": True, "warmed_k": args.warmup_k,
                              "device": str(service.device)}),
                  file=sys.stderr, flush=True)
        if args.http is not None:
            server = serve_http(service, args.http)
            print(json.dumps({"serving": "http",
                              "port": server.server_address[1]}),
                  file=sys.stderr, flush=True)
            try:
                server.serve_forever()
            finally:
                server.server_close()
            return 0
        return serve_stdio(service, sys.stdin, sys.stdout,
                           linger_ms=args.linger_ms or 0.0)
    finally:
        service.close()
