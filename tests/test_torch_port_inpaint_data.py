"""The inpainting datasets in the port (srsem_torch/data/datasets.py::
ImpaintMapsDataset, srsem_torch/data/contrastive.py) against the JAX
package's (srsem/data/datasets.py, srsem/data/contrastive.py) on files made
from a seed: every item equal (the same host numpy recipe, read with
``csv`` instead of pandas)."""

import numpy as np
import pytest
from PIL import Image

from srsem.data.contrastive import InpaintContrastiveDataset as JaxContrastive
from srsem.data.contrastive import grow_box_to_size as jax_grow
from srsem.data.contrastive import parse_bbox_string as jax_parse
from srsem.data.datasets import ImpaintMapsDataset as JaxImpaintMaps
from srsem.data.preprocess import Preprocess as JaxPreprocess
from srsem_torch.data.contrastive import (
    InpaintContrastiveDataset,
    grow_box_to_size,
    parse_bbox_string,
)
from srsem_torch.data.datasets import ImpaintMapsDataset
from srsem_torch.data.preprocess import Preprocess
from torch_port_tmp import remove_tmp_path  # noqa: F401 — autouse fixture


def _save(rng, path, w, h, gray=False):
    shape = (h, w) if gray else (h, w, 3)
    Image.fromarray(rng.integers(0, 255, shape, dtype=np.uint8)).save(path)


@pytest.fixture()
def maps_tree(tmp_path):
    """A maps CSV (one row with a segmentation mask, one without) and
    ``positive_pairs/`` with groups of 3 and 2 same-image positives (and
    a file in a group of its own)."""
    rng = np.random.default_rng(0)
    (tmp_path / "positive_pairs").mkdir()
    rows = ["gt_image_path,impainted_pth,segmentation_map_path"]
    for j in range(2):
        gt, inp = tmp_path / f"gt_{j}.jpg", tmp_path / f"inp_{j}.png"
        _save(rng, gt, 96, 80)
        _save(rng, inp, 96, 80)
        seg = ""
        if j == 0:
            seg = tmp_path / "seg_0.png"
            _save(rng, seg, 96, 80, gray=True)
        rows.append(f"{gt},{inp},{seg}")
    for key, n in (("7", 3), ("12", 2), ("30", 1)):
        for i in range(n):
            _save(rng, tmp_path / "positive_pairs" / f"{key}_{i}.png", 72, 64)
    (tmp_path / "maps.csv").write_text("\n".join(rows) + "\n")
    return str(tmp_path / "maps.csv")


def test_impaint_maps_matches_jax(maps_tree):
    want = JaxImpaintMaps(maps_tree, JaxPreprocess.for_backbone(
        "resnet50_clip", 64))
    got = ImpaintMapsDataset(maps_tree, Preprocess.for_backbone(
        "resnet50_clip", 64))
    assert len(got) == len(want) == 2 + 3 + 1
    for i in range(len(want)):
        ((ga, gb), gy), ((wa, wb), wy) = got[i], want[i]
        for g, w in ((ga, wa), (gb, wb), (gy, wy)):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w, err_msg=str(i))


@pytest.fixture()
def inpaint_tree(tmp_path):
    """Three instances: two with negatives (keyed by row index) and
    positives (keyed by instance id), one missing its positives; a
    bookkeeping file without an id prefix."""
    root = tmp_path / "ImpaintSDD"
    (root / "impainted_proposals").mkdir(parents=True)
    (root / "positive_pairs").mkdir()
    rng = np.random.default_rng(1)
    rows = ["id,bbox,gt_image_path"]
    for j, (w, h, bbox) in enumerate([(320, 240, "[40.3,30.0,60.5,50.2]"),
                                      (200, 300, "[150.0,250.7,40.0,30.0]"),
                                      (240, 240, "[0,0,10,10]")]):
        gt = root / f"gt_{j}.jpg"
        _save(rng, gt, w, h)
        _save(rng, root / "impainted_proposals" / f"{j}_0.png", w, h)
        if j < 2:
            for i in range(j + 1):
                _save(rng, root / "positive_pairs" / f"{100 + j}_{i}.png",
                      w, h)
        rows.append(f'{100 + j},"{bbox}",{gt}')
    (root / "positive_pairs" / ".gitkeep").write_text("")
    (root / "instances.csv").write_text("\n".join(rows) + "\n")
    return str(root)


def test_inpaint_contrastive_matches_jax(inpaint_tree):
    want = JaxContrastive(inpaint_tree)
    got = InpaintContrastiveDataset(inpaint_tree)
    assert len(got) == len(want) == 2
    for s, w in zip(got.samples, want.samples):
        assert s == {**w, "id": int(w["id"])}
    for i in range(len(want)):
        for g, w in zip(got[i], want[i]):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)


def test_bbox_helpers_match_jax():
    for text in ("[10.7,20.2,30.1,40.9]", "[0,0,224,224]", "[3.0,4.5,5,6.01]"):
        assert parse_bbox_string(text) == jax_parse(text)
    for box in ((0, 0, 50, 50, 224, 400, 300), (350, 0, 400, 50, 224, 400, 300),
                (100, 0, 130, 50, 224, 230, 300), (10, 200, 60, 280, 224, 300, 300)):
        assert grow_box_to_size(*box) == jax_grow(*box)
