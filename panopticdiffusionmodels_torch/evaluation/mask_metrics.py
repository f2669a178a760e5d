"""Panoptic mask metrics and visualisation, on the host in numpy.

Port of `panopticdiffusionmodels_tpu/evaluation/mask_metrics.py` (reference
`utils.py:521-560`), with the same results:
  * `eval_mask_cnt`: the per-class pixel bin-count L1 difference between
    predicted and ground-truth category-id maps;
  * `get_colormap` / `color_map`: id -> RGB through a persisted random table,
    so colours are stable across runs and across the two packages;
  * `category2rgb`: the official COCO palette through panopticapi when it is
    installed, else `color_map`.
"""
from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

NUM_CLASSES = 201  # COCO panoptic category ids run 1..200 (reference utils.py:555)


def eval_mask_cnt(pred_mask: np.ndarray, panoptic: np.ndarray) -> float:
    """Mean |bincount(pred) - bincount(gt)| / pixels (reference `utils.py:548-560`).

    pred_mask, panoptic: integer maps, shape (B, H, W) or (B, H, W, 1)."""
    pred = np.asarray(pred_mask).reshape(pred_mask.shape[0], -1).astype(np.int64)
    gt = np.asarray(panoptic).reshape(panoptic.shape[0], -1).astype(np.int64)
    batch, pixel_num = gt.shape
    cnt_diff = 0.0
    for i in range(batch):
        pred_cnt = np.bincount(np.clip(pred[i], 0, None), minlength=NUM_CLASSES)
        gt_cnt = np.bincount(np.clip(gt[i], 0, None), minlength=NUM_CLASSES)
        cnt_diff += np.abs(pred_cnt[:NUM_CLASSES] - gt_cnt[:NUM_CLASSES]).sum()
    return float(cnt_diff) / pixel_num / batch


def get_colormap(path: str = "colormap.npy", force: bool = False, seed: int = 0) -> np.ndarray:
    """(256, 3) uint8 id -> RGB table, persisted for stable colours
    (reference `utils.py:521-530`).  Reads the reference's torch-format
    `colormap.pt` too, so existing runs keep their colours."""
    if not force and not os.path.isfile(path) and os.path.isfile("colormap.pt"):
        import torch

        return torch.load("colormap.pt", map_location="cpu",
                          weights_only=True).numpy().astype(np.uint8)
    if os.path.isfile(path) and not force:
        return np.load(path)
    rng = np.random.default_rng(seed)
    cmap = rng.integers(0, 255, (256, 3)).astype(np.uint8)
    try:
        np.save(path, cmap)
    except OSError:  # a read-only directory: the seeded table is the same next time
        pass
    return cmap


def color_map(x: np.ndarray, colormap: Optional[np.ndarray] = None) -> np.ndarray:
    """Integer map (B, H, W[, 1]) -> RGB uint8 (B, H, W, 3)
    (reference `utils.py:533-543`, channel-last here)."""
    x = np.asarray(x)
    if x.ndim == 4:
        x = x[..., 0]
    if colormap is None:
        colormap = get_colormap()
    return colormap[np.clip(x, 0, 255).astype(np.int64)]


def category2rgb(id_map: np.ndarray, categories_json: str) -> np.ndarray:
    """The official COCO panoptic palette (reference `utils.py:457-471`); needs
    panopticapi and the categories json, else falls back to `color_map`."""
    try:
        from panopticapi.utils import IdGenerator
    except ImportError:
        return color_map(id_map[None])[0]
    with open(categories_json) as f:
        categories = {c["id"]: c for c in json.load(f)}
    gen = IdGenerator(categories)
    h, w = id_map.shape
    rgb = np.zeros((h, w, 3), dtype=np.uint8)
    for i in range(h):
        for j in range(w):
            c = int(id_map[i, j])
            while c not in categories:
                c -= 1
                if c <= 0:
                    c = 1
                    break
            rgb[i, j] = gen.get_color(c)
    return rgb
