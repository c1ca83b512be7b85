"""Training-free embedding-metric evaluation orchestrators — the port of
srsem/eval/approaches.py.

``compute_embedding_sim_metrics``
(reference: additional_approaches/src/eval_utils/compute_metrics.py:81-168)
and the three approach drivers
(reference: additional_approaches/src/eval_utils/embedding_approaches.py:
6-75): per HQ/reconstruction pair the embedding-metric score, classical
SSIM/PSNR/LPIPS, and the Grad-CAM comparison suite against a saliency map
(PSNR/SSIM/overlap between the metric CAM, the plain-embedding CAM, and the
saliency map).  Rows carry the JAX package's keys.

Devices: a pair is computed on the device of the images ``load_img``
returns, or on ``device`` (default the card) when they are host arrays:
the score, SSIM, PSNR, Grad-CAM through ``embed_fn_for_cam(img,
tap_offsets)`` (a module tower), the saliency map and the CAM comparisons
all stay there, as ``jnp`` values stay on JAX's default device.  Only the
row's numbers come to the host, at the end, in one read.  The drivers take
an optional ``lpips_fn`` (srsem_torch/eval/lpips.py::make_lpips) and
``device`` that the JAX drivers lack.

Saliency maps load from a parallel ``SaliencyMaps/`` tree with the same
relative path and a ``.npy`` stem (reference :130-134 inserts
"SaliencyMaps" as the second path component).
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from srsem_torch.device import DeviceLike, resolve_device
from srsem_torch.explain.embedders import to_numpy
from srsem_torch.explain.gradcam import grad_cam_tensor
from srsem_torch.explain.iqa import psnr, ssim
from srsem_torch.explain.overlap import overlap_metrics
from srsem_torch.explain.targets import as_tensor, vector_sum_target
from srsem_torch.ops.image import resize_bilinear

Tensor = torch.Tensor


def saliency_path_for(img_path: str) -> str:
    """Insert "SaliencyMaps" as the 2nd path component, swap ext
    (reference: compute_metrics.py:130-134 — byte-identical on the
    relative paths the reference uses).  Two hardenings over the
    reference: absolute paths skip the leading root component (the
    reference's literal insert(1) would produce /SaliencyMaps/... at the
    filesystem root), and only the FILENAME's extension is swapped (a
    dotted parent directory must not truncate the path)."""
    parts = img_path.split(os.sep)
    parts.insert(2 if parts and parts[0] == "" else 1, "SaliencyMaps")
    name = parts[-1]
    parts[-1] = (name.rsplit(".", 1)[0] if "." in name else name) + ".npy"
    return os.sep.join(parts)


def load_saliency(img_path: str) -> Optional[np.ndarray]:
    path = saliency_path_for(img_path)
    if os.path.exists(path):
        return np.load(path)
    return None


def _map_pair_scores(a: Tensor, b: Tensor, prefix: str) -> Dict[str, Tensor]:
    """PSNR/SSIM between two single-channel maps on a's device, b resized
    to a."""
    a4 = a[None, ..., None]
    b4 = resize_bilinear(b[None, ..., None], tuple(a.shape))
    return {f"{prefix}_psnr": psnr(a4, b4)[0],
            f"{prefix}_ssim": ssim(a4, b4)[0]}


def _overlap_scores(a, b, name_a: str, name_b: str) -> Dict[str, float]:
    pa, pb, pt = overlap_metrics(a, b)
    return {f"{name_a}_vsoverlap_{name_b}": pa,
            f"{name_b}_vsoverlap_{name_a}": pb,
            f"{name_a}_overlap_{name_b}": pt}


def _to_host(data: dict, device: torch.device) -> dict:
    """The row's tensor values as floats, read back in one transfer."""
    keys = [k for k, v in data.items() if isinstance(v, Tensor)]
    if keys:
        values = torch.stack([data[k].detach().float().reshape(()).to(device)
                              for k in keys]).tolist()
        data.update(zip(keys, values))
    return data


def compute_embedding_sim_metrics(
    embedder: Callable,
    embed_fn_for_cam: Optional[Callable],
    tap_name: Optional[str],
    hq_path: str,
    rec_path: str,
    target_factory: Callable,
    load_img: Callable,
    do_gradcam: bool = True,
    grid_hw=None,
    saliency: Optional[np.ndarray] = None,
    lpips_fn: Optional[Callable] = None,
    device: DeviceLike = None,
) -> Dict[str, float]:
    """One pair × one metric → result dict (reference :81-168).

    ``embedder``: pixels → embedding (any of the suite's five embedders);
    ``embed_fn_for_cam``: (img, tap_offsets) → (emb, taps) for Grad-CAM;
    ``target_factory``: embedding → scalar target fn
    (srsem_torch.explain.targets).  ``device`` places host-array images
    (default the card); tensor images keep theirs.
    """
    hq_img = load_img(hq_path)
    rec_img = load_img(rec_path)
    dev = (hq_img.device if isinstance(hq_img, Tensor)
           else resolve_device(device))
    hq_emb = as_tensor(embedder(hq_img)).detach().float().to(dev)
    rec_emb = as_tensor(embedder(rec_img)).detach().float().to(dev)

    target = target_factory(hq_emb)
    data: Dict[str, float] = {
        "hq_pth": hq_path, "rec_pth": rec_path,
        "metric": getattr(target_factory, "__name__", str(target_factory)),
        "score": torch.mean(target(rec_emb)),
    }
    hq4 = as_tensor(hq_img).float().to(dev)
    rec4 = as_tensor(rec_img).float().to(dev)
    if hq4.dim() == 3:
        hq4, rec4 = hq4[None], rec4[None]
    data["ssim"] = ssim(hq4, rec4)[0]
    data["psnr"] = psnr(hq4, rec4)[0]
    if lpips_fn is not None:
        # reference computes lpips alongside ssim/psnr per pair
        # (compute_metrics.py:121-123); srsem_torch.eval.lpips.make_lpips
        # is the learned backend ([0,1] NHWC batches).
        data["lpips"] = as_tensor(lpips_fn(hq4, rec4))[0]

    if do_gradcam and embed_fn_for_cam is not None and tap_name is not None:
        out_hw = tuple(hq4.shape[1:3])
        cam = grad_cam_tensor(embed_fn_for_cam, rec4, tap_name,
                              target_factory(hq_emb), out_hw, grid_hw)[0]
        hq_cam = grad_cam_tensor(embed_fn_for_cam, hq4, tap_name,
                                 vector_sum_target(), out_hw, grid_hw)[0]
        cam, hq_cam = cam.to(dev), hq_cam.to(dev)
        if saliency is None:
            saliency = load_saliency(hq_path)
        if saliency is not None:
            saliency = as_tensor(saliency).float().to(dev)
            data.update(_map_pair_scores(cam, saliency, "gcam_saliency"))
            data.update(_map_pair_scores(hq_cam, saliency, "hqgcam_saliency"))
            data.update(_overlap_scores(hq_cam, saliency, "hqgcam", "saliency"))
            data.update(_overlap_scores(cam, saliency, "gradcam", "saliency"))
        data.update(_map_pair_scores(cam, hq_cam, "gcam_hqgcam"))
        data.update(_overlap_scores(hq_cam, cam, "hqgcam", "gradcam"))
    return _to_host(data, dev)


def cluster_concepts(txt_embedder: Callable, concepts: List[str],
                     n_clusters: int = 3) -> List[str]:
    """KMeans-cluster concept embeddings and keep one representative per
    cluster — ≤3 focus concepts (reference: embedding_approaches.py:6-32;
    note the reference keeps the concepts indexed by np.unique of the
    labels, i.e. the first ``n_clusters`` indices — reproduced)."""
    if len(concepts) <= n_clusters:
        return list(concepts)
    from sklearn.cluster import KMeans

    embs = to_numpy(txt_embedder(concepts))
    labels = KMeans(n_clusters=n_clusters, random_state=42).fit_predict(embs)
    keep_idx = np.unique(labels)
    return list(np.array(concepts)[keep_idx])


def simple_embedding_similarity(suite, ram_projector, target_factories,
                                tap_name, hq_pth, rec_pth, data: list,
                                do_gradcam=True, embed_fn_for_cam=None,
                                grid_hw=None, lpips_fn=None, device=None):
    """(reference: embedding_approaches.py:35-44)"""
    for factory in target_factories:
        res = compute_embedding_sim_metrics(
            suite.img_embedder, embed_fn_for_cam, tap_name, hq_pth, rec_pth,
            factory, suite.load_img, do_gradcam, grid_hw, lpips_fn=lpips_fn,
            device=device)
        res["embedding_method"] = "simple"
        data.append(res)


def focus_embedding_similarity(suite, ram_tagger, target_factories, tap_name,
                               hq_pth, rec_pth, data: list, do_gradcam=True,
                               embed_fn_for_cam=None, grid_hw=None,
                               lpips_fn=None, device=None):
    """RAM tags → ≤3 clustered concepts → per-concept focus scoring
    (reference: embedding_approaches.py:46-62)."""
    elements = cluster_concepts(suite.txt_embedder, list(ram_tagger(hq_pth)))
    for elem in elements:
        focus_emb = to_numpy(suite.txt_embedder([elem]))[0]
        suite.focus_img_embedder.focus_emb = focus_emb
        for factory in target_factories:
            res = compute_embedding_sim_metrics(
                suite.focus_img_embedder, embed_fn_for_cam, tap_name,
                hq_pth, rec_pth, factory, suite.load_img, do_gradcam, grid_hw,
                lpips_fn=lpips_fn, device=device)
            res["img_element"] = elem
            res["embedding_method"] = "focus"
            data.append(res)


def splice_focus_embedding_similarity(suite, target_factories, tap_name,
                                      hq_pth, rec_pth, data: list, rank=None,
                                      do_gradcam=True, embed_fn_for_cam=None,
                                      grid_hw=None, lpips_fn=None,
                                      device=None):
    """(reference: embedding_approaches.py:64-75)"""
    if rank is not None:
        suite.splice_focus_img_embedder.rank = rank
    for factory in target_factories:
        res = compute_embedding_sim_metrics(
            suite.splice_focus_img_embedder, embed_fn_for_cam, tap_name,
            hq_pth, rec_pth, factory, suite.load_img, do_gradcam, grid_hw,
            lpips_fn=lpips_fn, device=device)
        res["embedding_method"] = "splice_focus"
        res["rank"] = rank
        data.append(res)
