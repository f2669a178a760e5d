"""The sample writer: generate -> copy back -> PNG files and mask metrics.

Port of `panopticdiffusionmodels_tpu/evaluation/sampler_io.py` (reference
`sample2dir`, `utils.py:561-640`) for one process: the amortised batches,
the `idx + 10000 * (written // 4992)` file names that pair samples with the
5-captions-per-image CLIP-score protocol, the analog-bit -> id -> colour map
decode of the mask PNGs, and the running mask metrics.  PNGs are written
through PIL, as the JAX package writes them.
"""
from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import torch

from ..diffusion.analog_bits import analog_to_ints
from ..utils.misc import amortize, one_deep, to_numpy
from .mask_metrics import color_map, eval_mask_cnt, get_colormap


def save_uint8_png(arr: np.ndarray, path: str):
    """HWC uint8 -> a PNG file (through PIL, as the JAX package)."""
    from PIL import Image

    Image.fromarray(arr).save(path)


def save_png(arr01: np.ndarray, path: str):
    """[0, 1] HWC floats -> an 8-bit PNG (rounded to nearest)."""
    save_uint8_png(np.clip(arr01 * 255.0 + 0.5, 0, 255).astype(np.uint8), path)


def mask_ids(pred_mask, mask_bits: int = 8) -> np.ndarray:
    """Analog bits (B, H, W, mask_bits), a tensor on any device or an array ->
    integer ids (B, H, W, 1) as numpy; a card tensor is decoded on the card."""
    return to_numpy(analog_to_ints(torch.as_tensor(pred_mask), n=mask_bits))


def make_grid(images01: np.ndarray, ncol: int = 8, pad: int = 2) -> np.ndarray:
    """Tile [0, 1] NHWC images into one grid image (the reference's
    torchvision.make_grid role, `train.py:167`)."""
    n, h, w, c = images01.shape
    ncol = min(ncol, n)
    nrow = (n + ncol - 1) // ncol
    grid = np.ones((nrow * (h + pad) + pad, ncol * (w + pad) + pad, c), dtype=np.float32)
    for i in range(n):
        r, col = divmod(i, ncol)
        y0, x0 = pad + r * (h + pad), pad + col * (w + pad)
        grid[y0:y0 + h, x0:x0 + w] = images01[i]
    return grid


def save_grid(images01: np.ndarray, path: str, ncol: int = 8):
    save_png(make_grid(images01, ncol), path)


def sample2dir(path: str, n_samples: int, batch_size: int, sample_fn: Callable,
               unpreprocess_fn: Optional[Callable] = None, use_panoptic: bool = False,
               mask_path: Optional[str] = None, mask_bits: int = 8, overlap: bool = True):
    """sample_fn(batch_size) -> (indices, images[, pred_mask, loss_mask, panoptic]).

    Images NHWC in [-1, 1] (unpreprocess maps them to [0, 1]); pred_mask are
    analog bits (B, H, W, mask_bits); loss_mask is NaN for a batch without
    ground truth.  Tensors may be on the card; they are copied back here.
    Returns the mask metrics when use_panoptic.

    With `overlap=True` the loop runs one batch deep: batch i + 1 is
    enqueued on the card before batch i is copied back and written, so the
    PNG encoding overlaps the sampling.  `overlap=False` writes the same
    files and returns the same metrics."""
    os.makedirs(path, exist_ok=True)
    if use_panoptic and mask_path:
        os.makedirs(mask_path, exist_ok=True)
    colormap = get_colormap()
    written = 0
    loss_mask_all, cnt_diff_all = [], []

    def process(out, n_keep):
        nonlocal written
        if use_panoptic:
            sample_idx, samples, pred_mask, loss_mask, panoptic = out
            lm = float(np.mean(to_numpy(loss_mask)))
            if np.isfinite(lm):  # NaN marks "no ground truth for this batch"
                loss_mask_all.append(lm)
        else:
            sample_idx, samples = out
        samples = to_numpy(samples)[:n_keep]
        if unpreprocess_fn is not None:
            samples = unpreprocess_fn(samples)
        if use_panoptic:
            ids = mask_ids(pred_mask, mask_bits)
            if panoptic is not None:
                cnt_diff_all.append(eval_mask_cnt(ids, to_numpy(panoptic)))
            colors = color_map(ids, colormap)
        sample_idx = to_numpy(sample_idx)
        for i, sample in enumerate(samples):
            # the 5-caption pairing contract (reference utils.py:631-636)
            name = f"{int(sample_idx[i]) + 10000 * (written // 4992)}.png"
            save_png(sample, os.path.join(path, name))
            if use_panoptic and mask_path:
                save_uint8_png(colors[i].astype(np.uint8), os.path.join(mask_path, name))
            written += 1

    sizes = amortize(n_samples, batch_size)
    if overlap:
        for n_keep, out in one_deep(sizes, lambda _: sample_fn(batch_size)):
            process(out, n_keep)
    else:
        for n_keep in sizes:
            process(sample_fn(batch_size), n_keep)
    metrics = {}
    if use_panoptic and loss_mask_all:
        metrics["eval_loss_mask"] = float(np.mean(loss_mask_all))
        if cnt_diff_all:
            metrics["eval_cnt_mask_diff"] = float(np.mean(cnt_diff_all))
    return metrics
