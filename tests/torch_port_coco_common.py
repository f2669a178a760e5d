"""Shared by the data-slice test files (not collected itself): a tiny
MS-COCO tree and a tiny feature directory, written with numpy and PIL.

`write_coco_tree` lays out what `data/mscoco.py::MSCOCODatabase` and the
extraction scripts read: `{root}/{split}/*.png` images of mixed sizes,
`{root}/annotations/captions_{split}.json` and, for every image but the
last, `panoptic_{split}.json` with RGB-encoded segment-id PNGs under
`annotations/panoptic_{split}/` (at least three segments each, category
ids up to 200).  Image ids are not in file order; one image has six
captions, one two and one none."""
from __future__ import annotations

import json
import os

import numpy as np

SIZES = [(40, 30), (24, 36), (32, 32), (50, 20), (36, 44)]  # (W, H)
IMAGE_IDS = [9, 3, 25, 14, 7]
N_CAPTIONS = [6, 5, 2, 0, 5]


def write_coco_tree(root, split: str = "train2017", seed: int = 0) -> str:
    from PIL import Image

    rng = np.random.default_rng(seed)
    root = str(root)
    img_dir = os.path.join(root, split)
    ann_dir = os.path.join(root, "annotations")
    pan_dir = os.path.join(ann_dir, f"panoptic_{split}")
    for d in (img_dir, pan_dir):
        os.makedirs(d, exist_ok=True)
    images, captions, panoptic = [], [], []
    for n, ((w, h), image_id, n_cap) in enumerate(zip(SIZES, IMAGE_IDS, N_CAPTIONS)):
        name = f"{image_id:012d}.png"
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
            os.path.join(img_dir, name))
        images.append(dict(id=image_id, file_name=name, width=w, height=h))
        captions += [dict(image_id=image_id, id=100 * image_id + k,
                          caption=f"image {image_id} caption {k}: a cat on a mat")
                     for k in range(n_cap)]
        if n == len(SIZES) - 1:  # the last image has no panoptic annotation
            continue
        seg_ids = [int(rng.integers(1, 1 << 24)) for _ in range(4)]
        rows = np.minimum(np.arange(h)[:, None] * 4 // h + (np.arange(w)[None] * 2 // w), 3)
        ids = np.asarray(seg_ids, dtype=np.int64)[rows]
        rgb = np.stack([ids % 256, ids // 256 % 256, ids // 65536], -1).astype(np.uint8)
        Image.fromarray(rgb).save(os.path.join(pan_dir, name))
        panoptic.append(dict(image_id=image_id, file_name=name, segments_info=[
            dict(id=s, category_id=int(rng.integers(1, 201))) for s in seg_ids[:3]]))
    with open(os.path.join(ann_dir, f"captions_{split}.json"), "w") as f:
        json.dump(dict(images=images, annotations=captions), f)
    with open(os.path.join(ann_dir, f"panoptic_{split}.json"), "w") as f:
        json.dump(dict(annotations=panoptic,
                       categories=[dict(id=i, name=f"c{i}") for i in range(1, 201)]), f)
    return root


def write_feature_dir(path, n: int = 10, moments=(8, 4, 4), context=(7, 12), seg: int = 16,
                      seed: int = 0, seg_dtype=np.int64) -> str:
    """`{i}.npy` moments, `{i}_{k}.npy` five contexts and `{i}_seg.npy` maps
    (seg = 0: none) for i < n."""
    rng = np.random.default_rng(seed)
    os.makedirs(path, exist_ok=True)
    for i in range(n):
        np.save(os.path.join(path, f"{i}.npy"), rng.normal(size=moments).astype(np.float32))
        for k in range(5):
            np.save(os.path.join(path, f"{i}_{k}.npy"),
                    rng.normal(size=context).astype(np.float32))
        if seg:
            np.save(os.path.join(path, f"{i}_seg.npy"),
                    rng.integers(0, 201, (seg, seg)).astype(seg_dtype))
    return str(path)
