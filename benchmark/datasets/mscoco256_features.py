"""Feature files of `mscoco256_features`, written from the seed in that
dataset's on-disk format, and the check that a fed row is one of them.

`train/{i}.npy` latent moments (8, 32, 32) f32, `train/{i}_{k}.npy` one CLIP
context (77, 768) f32 for each of 5 captions, `train/{i}_seg.npy` a 256 x
256 int32 panoptic map (ids below 200, constant on 4 x 4 cells, so that the
loader's 4 x 4 min-pool gives back the 64 x 64 map), `empty_context.npy`,
and an empty `val/`.
"""
from __future__ import annotations

import os

import numpy as np
import torch

CAPTIONS = 5
IDS = 200


def write(path, rows, config, gen, device):
    """Write `rows` samples under `path`; returns what `check` needs."""
    h, w, c = config.z_shape
    nn = config.nnet
    ms = nn.mask_size
    train = os.path.join(path, "train")
    os.makedirs(train)
    os.makedirs(os.path.join(path, "val"))
    moments = torch.randn((rows, 2 * c, h, w), generator=gen, device=device).cpu().numpy()
    contexts = torch.randn((rows, CAPTIONS, nn.num_clip_token, nn.clip_dim), generator=gen,
                           device=device).cpu().numpy()
    seg = torch.randint(0, IDS, (rows, ms, ms), generator=gen, device=device,
                        dtype=torch.int32).cpu().numpy()
    empty = torch.randn((nn.num_clip_token, nn.clip_dim), generator=gen,
                        device=device).cpu().numpy()
    pool = 256 // ms
    for i in range(rows):
        np.save(os.path.join(train, f"{i}.npy"), moments[i])
        for k in range(CAPTIONS):
            np.save(os.path.join(train, f"{i}_{k}.npy"), contexts[i, k])
        np.save(os.path.join(train, f"{i}_seg.npy"),
                np.repeat(np.repeat(seg[i], pool, 0), pool, 1))
    np.save(os.path.join(path, "empty_context.npy"), empty)
    return {"moments": moments, "contexts": contexts, "seg": seg, "empty": empty}


def check(data, batch):
    """Rows of a fed batch (moments (B, h, w, 2C), context, ids (B, S, S, 1))
    that are none of the written samples: moments, one of the sample's
    contexts (or the empty one, CFG's drop) and its map, all exact."""
    index = {data["moments"][i].tobytes(): i for i in range(len(data["moments"]))}
    moments = batch[0].float().cpu().numpy().transpose(0, 3, 1, 2)
    context = batch[1].float().cpu().numpy()
    ids = batch[2].cpu().numpy()[..., 0].astype(np.int32)
    bad = 0
    for r in range(moments.shape[0]):
        i = index.get(np.ascontiguousarray(moments[r]).tobytes())
        if i is None:
            bad += 1
            continue
        ok_ctx = any(np.array_equal(context[r], c) for c in data["contexts"][i]) or \
            np.array_equal(context[r], data["empty"])
        bad += int(not (ok_ctx and np.array_equal(ids[r], data["seg"][i])))
    return bad
