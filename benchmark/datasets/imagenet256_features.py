"""Feature files of `imagenet256_features`, written from the seed in that
dataset's on-disk format, and the check that a fed row is one of them.

`{i}.npy` pickles a pair (latent moments (8, 32, 32) f32, label in 0..999);
the loader drops a label to the null class 1000 at the config's p_uncond.
"""
from __future__ import annotations

import os

import numpy as np
import torch

CLASSES = 1000


def write(path, rows, config, gen, device):
    h, w, c = config.z_shape
    os.makedirs(path)
    moments = torch.randn((rows, 2 * c, h, w), generator=gen, device=device).cpu().numpy()
    labels = torch.randint(0, CLASSES, (rows,), generator=gen, device=device).cpu().numpy()
    for i in range(rows):
        pair = np.empty(2, dtype=object)
        pair[0], pair[1] = moments[i], int(labels[i])
        np.save(os.path.join(path, f"{i}.npy"), pair, allow_pickle=True)
    return {"moments": moments, "labels": labels}


def check(data, batch):
    """Rows of a fed batch (moments (B, h, w, 2C), labels (B,)) that are none
    of the written samples: exact moments, its label or the null class."""
    index = {data["moments"][i].tobytes(): i for i in range(len(data["moments"]))}
    moments = batch[0].float().cpu().numpy().transpose(0, 3, 1, 2)
    labels = batch[1].cpu().numpy()
    bad = 0
    for r in range(moments.shape[0]):
        i = index.get(np.ascontiguousarray(moments[r]).tobytes())
        bad += int(i is None or labels[r] not in (data["labels"][i], CLASSES))
    return bad
