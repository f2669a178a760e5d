"""CLIP score of generated images against their prompts.

Port of `panopticdiffusionmodels_tpu/evaluation/clip_score.py` (reference
`tools/clip_score.py`): CLIP ViT-B/32, logit_scale x the cosine of the image
and text embeddings, averaged over the pairs, and the `i + 10000 * k` file
pairing of each image with the k-th of its 5 COCO captions (reference
`tools/clip_score.py:165-186`).  The model is `models/clip.py::CLIPModel`
from a local directory (config.json, vocab.json, merges.txt, weights and
optionally preprocessor_config.json); nothing is downloaded.

The image path is the processor's (shortest side to `size` with bicubic
resampling, centre crop, rescale, CLIP mean / std), on the card:
transformers resizes with PIL's bicubic on uint8 images; here
`F.interpolate(mode="bicubic", antialias=True)` (PIL's a = -0.5 kernel,
widened when shrinking), as PIL in two passes (the width, then the height),
each rounded and clipped to [0, 255] like PIL's uint8 intermediate.

    python -m panopticdiffusionmodels_torch.evaluation.clip_score \
        --sample-dir D --caption-dir C [--version DIR] [--device cuda]
"""
from __future__ import annotations

import json
import os
from typing import List

import numpy as np
import torch
import torch.nn.functional as F

from ..models.clip import CLIPTokenizer, load_clip_model
from .inception import no_tf32

CLIP_SCORE_MODEL = "assets/clip-vit-base-patch32"
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def _edge(v, key):
    return v if isinstance(v, int) else v[key]


def load_image_config(version: str) -> dict:
    """The processor's image settings: preprocessor_config.json where the
    directory has one, else CLIP's (224, bicubic, CLIP mean / std)."""
    cfg = {}
    path = os.path.join(version, "preprocessor_config.json")
    if os.path.exists(path):
        with open(path, encoding="utf-8") as f:
            cfg = json.load(f)
    crop = cfg.get("crop_size", 224)
    return dict(size=_edge(cfg.get("size", 224), "shortest_edge"),
                crop=(_edge(crop, "height"), _edge(crop, "width")),
                mean=tuple(cfg.get("image_mean", CLIP_MEAN)),
                std=tuple(cfg.get("image_std", CLIP_STD)),
                rescale=float(cfg.get("rescale_factor", 1 / 255)))


def preprocess(images: np.ndarray, cfg: dict, device) -> torch.Tensor:
    """(N, H, W, 3) uint8 -> (N, 3, crop_h, crop_w) normalised f32 on device."""
    x = torch.as_tensor(images, device=device).permute(0, 3, 1, 2).float()
    h, w = x.shape[-2:]
    short, long = (w, h) if w <= h else (h, w)
    new_short, new_long = cfg["size"], int(cfg["size"] * long / short)
    size = (new_long, new_short) if w <= h else (new_short, new_long)
    # PIL resamples the width, then the height, each pass rounded to uint8
    for step in ((h, size[1]), size):
        if step != tuple(x.shape[-2:]):
            x = F.interpolate(x, size=step, mode="bicubic", align_corners=False,
                              antialias=True).add(0.5).floor().clamp(0, 255)
    (ch, cw), (h, w) = cfg["crop"], size
    if ch > h or cw > w:
        raise ValueError(f"images of {size} after the resize are smaller than the crop {ch, cw}")
    top, left = (h - ch) // 2, (w - cw) // 2
    x = x[..., top:top + ch, left:left + cw] * cfg["rescale"]
    mean = torch.tensor(cfg["mean"], device=device).view(1, 3, 1, 1)
    std = torch.tensor(cfg["std"], device=device).view(1, 3, 1, 1)
    return (x - mean) / std


@torch.no_grad()
def clip_score(images: np.ndarray, texts: List[str], version: str = CLIP_SCORE_MODEL,
               batch_size: int = 64, device="cuda") -> float:
    """Mean logit_scale * cosine(image_emb, text_emb) over the pairs.

    images: (N, H, W, 3) uint8 or [0, 1] float; len(texts) == N.  Runs on
    the card unless the caller passes device="cpu", in f32 (TF32 off for the
    patch convolution, scoped)."""
    model = load_clip_model(version, device=device)
    device = model.logit_scale.device
    tokenizer = CLIPTokenizer.from_dir(version)
    cfg = load_image_config(version)
    if images.dtype != np.uint8:
        images = np.clip(images * 255.0 + 0.5, 0, 255).astype(np.uint8)
    logit_scale = model.logit_scale.exp()
    scores = []
    for i in range(0, len(images), batch_size):
        batch = tokenizer(list(texts[i:i + batch_size]), max_length=77, padding="longest")
        ids, mask = (torch.as_tensor(batch[k], device=device)
                     for k in ("input_ids", "attention_mask"))
        with no_tf32():  # the patch embedding is a cuDNN convolution: f32, as in JAX
            img = F.normalize(model.image_embeds(preprocess(images[i:i + batch_size], cfg,
                                                            device)), dim=-1)
        txt = F.normalize(model.text_embeds(ids, mask), dim=-1)
        scores.append((img * txt).sum(-1) * logit_scale)
    return float(torch.cat(scores).mean())


def clip_score_from_dirs(sample_dir: str, caption_dir: str, version: str = CLIP_SCORE_MODEL,
                         device="cuda") -> float:
    """Directory protocol: image `{i + 10000*k}.png` pairs with caption file
    `{i}_{k}_text.txt`, else `{i}_text.txt` (reference
    `tools/clip_score.py:165-186`)."""
    from PIL import Image

    images, texts = [], []
    for name in sorted(os.listdir(sample_dir)):
        if not name.endswith(".png"):
            continue
        n = int(os.path.splitext(name)[0])
        i, k = n % 10000, n // 10000
        cap_path = os.path.join(caption_dir, f"{i}_{k}_text.txt")
        if not os.path.exists(cap_path):
            cap_path = os.path.join(caption_dir, f"{i}_text.txt")
        if not os.path.exists(cap_path):
            continue
        with open(cap_path) as f:
            texts.append(f.readline().strip())
        with Image.open(os.path.join(sample_dir, name)) as img:
            images.append(np.asarray(img.convert("RGB")))
    if not images:
        raise FileNotFoundError("no (image, caption) pairs found")
    return clip_score(np.stack(images), texts, version=version, device=device)


def _main():
    """CLI (reference tools/clip_score.py:227)."""
    import argparse

    p = argparse.ArgumentParser(description="CLIP score over a sample directory")
    p.add_argument("--sample-dir", required=True)
    p.add_argument("--caption-dir", required=True)
    p.add_argument("--version", default=CLIP_SCORE_MODEL,
                   help="local directory of a CLIP model (config.json, vocab.json, "
                        "merges.txt, pytorch_model.bin or model.safetensors)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    print("CLIP score:", clip_score_from_dirs(args.sample_dir, args.caption_dir,
                                              version=args.version, device=args.device))


if __name__ == "__main__":
    _main()
