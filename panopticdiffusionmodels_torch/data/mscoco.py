"""Raw MS-COCO with captions and panoptic segmentation maps, for the offline
feature extraction (`scripts/extract_mscoco_feature.py`).

A numpy + PIL copy of `panopticdiffusionmodels_tpu/data/mscoco.py`
(reference `datasets.py:461-548`): images are centre-cropped and resized,
each paired with 5 captions, and the panoptic PNG annotations (RGB-encoded
segment ids) become category-id maps through the panoptic JSON's
`segments_info`.  Captions load from the annotation JSON directly.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np


def rgb2id(color: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 panoptic PNG -> (H, W) int64 segment ids, the COCO
    panoptic encoding id = R + 256*G + 256^2*B."""
    color = color.astype(np.int64)
    return color[..., 0] + 256 * color[..., 1] + 256 * 256 * color[..., 2]


def center_crop_resize(img, size: int, nearest: bool = False):
    """The centred square crop of a PIL image, resized to size x size: BICUBIC,
    or NEAREST for label maps, where BICUBIC would blend the RGB-encoded ids
    into colours of segments that do not exist."""
    from PIL import Image

    w, h = img.size
    s = min(w, h)
    img = img.crop(((w - s) // 2, (h - s) // 2, (w + s) // 2, (h + s) // 2))
    return img.resize((size, size), Image.NEAREST if nearest else Image.BICUBIC)


class MSCOCODatabase:
    """Item i, in the order of sorted image ids: (image (size, size, 3) f32 in
    [-1, 1], exactly 5 captions (the last repeated when an image has fewer),
    category-id map (size, size) int32, or None without panoptic files)."""

    def __init__(self, root: str, ann_file: str, panoptic_ann_file: Optional[str] = None,
                 panoptic_root: Optional[str] = None, size: int = 256):
        self.root = root
        self.size = size
        with open(ann_file) as f:
            ann = json.load(f)
        self.images: Dict[int, dict] = {im["id"]: im for im in ann["images"]}
        self.captions: Dict[int, List[str]] = {}
        for a in ann["annotations"]:
            self.captions.setdefault(a["image_id"], []).append(a["caption"])
        self.keys = sorted(self.images)
        self.panoptic: Dict[int, dict] = {}
        self.categories: Dict[int, dict] = {}
        self.panoptic_root = panoptic_root
        if panoptic_ann_file and os.path.exists(panoptic_ann_file):
            with open(panoptic_ann_file) as f:
                pan = json.load(f)
            self.panoptic = {a["image_id"]: a for a in pan["annotations"]}
            self.categories = {c["id"]: c for c in pan["categories"]}

    def __len__(self):
        return len(self.keys)

    def image_id(self, index: int) -> int:
        return self.keys[index]

    def _seg_map(self, image_id: int) -> Optional[np.ndarray]:
        from PIL import Image

        if image_id not in self.panoptic or not self.panoptic_root:
            return None
        a = self.panoptic[image_id]
        png = Image.open(os.path.join(self.panoptic_root, a["file_name"]))
        seg_ids = rgb2id(np.asarray(center_crop_resize(png, self.size, nearest=True),
                                    dtype=np.uint8))
        cat_map = np.zeros_like(seg_ids)  # segment id -> category id (reference l.527-535)
        for seg in a["segments_info"]:
            cat_map[seg_ids == seg["id"]] = seg["category_id"]
        return cat_map.astype(np.int32)

    def load_image(self, index: int) -> np.ndarray:
        """Item `index`'s image alone, (size, size, 3) f32 in [-1, 1]."""
        from PIL import Image

        info = self.images[self.keys[index]]
        img = Image.open(os.path.join(self.root, info["file_name"])).convert("RGB")
        img = np.asarray(center_crop_resize(img, self.size), dtype=np.float32)
        return img / 127.5 - 1.0

    def __getitem__(self, index: int):
        k = self.keys[index]
        captions = self.captions.get(k, [""])[:5]
        while len(captions) < 5:
            captions.append(captions[-1] if captions else "")
        return self.load_image(index), captions, self._seg_map(k)
