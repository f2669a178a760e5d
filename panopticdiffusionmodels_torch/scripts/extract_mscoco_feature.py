"""Pre-encode MS-COCO into the training features of `mscoco256_features`.

    python -m panopticdiffusionmodels_torch.scripts.extract_mscoco_feature \
        --split val2017 --datadir assets/datasets/coco \
        --outdir assets/datasets/coco256_features \
        --autoencoder assets/stable-diffusion/autoencoder_kl.pth \
        --clip assets/clip-vit-large-patch14 [--batch 8] [--device cuda|cpu]

Port of `scripts/extract_mscoco_feature.py` (reference
`scripts/extract_mscoco_feature.py`), with its arguments and file contract,
into `{outdir}/train` or `{outdir}/val` by the split's name: per image i of
`data/mscoco.py::MSCOCODatabase` (`{datadir}/{split}/`, the captions and
panoptic JSONs and PNGs under `{datadir}/annotations/`),

  * `{i}.npy`       the SD KL-VAE's latent moments (2C, h, w) f32, from
                    `models/vae.py::AutoencoderKL.encode_moments` on the
                    `--autoencoder` .pth (its reference state dict), f32
                    convolutions (TF32 off);
  * `{i}_{k}.npy`   the CLIP context (77, 768) f32 of caption k = 0..4, from
                    `models/clip.py::FrozenCLIPEmbedder` on the local CLIP
                    directory `--clip`;
  * `{i}_text.txt`  the 5 captions, one a line;
  * `{i}_seg.npy`   the panoptic category-id map (size, size) int32, when the
                    image has a panoptic annotation.

The captions of `--batch` images are encoded a call (JAX's script parses
`--batch` and encodes one image at a time); the VAE still encodes one image
a call, because a batched convolution may sum in another order, and so the
files equal those of `--batch 1`.  `--device` defaults to the card.  At the
end one JSON line reports the images, the seconds, images/s and the split
between the VAE, CLIP and the host (reading, resizing, writing).
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--split", default="val2017")
    p.add_argument("--datadir", required=True)
    p.add_argument("--outdir", required=True)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--autoencoder", default="assets/stable-diffusion/autoencoder_kl.pth")
    p.add_argument("--clip", default="openai/clip-vit-large-patch14",
                   help="local CLIP directory: config.json, vocab.json, merges.txt and the "
                        "text tower's weights")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    from ..data.mscoco import MSCOCODatabase
    from ..models.clip import FrozenCLIPEmbedder

    device = torch.device(args.device)
    split, ann = args.split, os.path.join(args.datadir, "annotations")
    db = MSCOCODatabase(root=os.path.join(args.datadir, split),
                        ann_file=os.path.join(ann, f"captions_{split}.json"),
                        panoptic_ann_file=os.path.join(ann, f"panoptic_{split}.json"),
                        panoptic_root=os.path.join(ann, f"panoptic_{split}"), size=args.size)
    out = os.path.join(args.outdir, "val" if "val" in split else "train")
    os.makedirs(out, exist_ok=True)
    vae = load_vae(args.autoencoder, device)
    clip = FrozenCLIPEmbedder(args.clip, device=device)
    timer = Timer(device)
    t0 = time.perf_counter()

    for start in range(0, len(db), args.batch):
        items = [db[i] for i in range(start, min(start + args.batch, len(db)))]
        moments = timer("vae", lambda: [encode_moments(vae, img, device) for img, _, _ in items])
        ctx = timer("clip", lambda: clip.encode([c for _, caps, _ in items for c in caps])
                    .cpu().numpy())
        for j, (_, captions, seg) in enumerate(items):
            idx = start + j
            np.save(os.path.join(out, f"{idx}.npy"), moments[j])
            for k in range(len(captions)):
                np.save(os.path.join(out, f"{idx}_{k}.npy"), ctx[5 * j + k])
            with open(os.path.join(out, f"{idx}_text.txt"), "w") as f:
                f.write("\n".join(captions))
            if seg is not None:
                np.save(os.path.join(out, f"{idx}_seg.npy"), seg)
            if idx % 100 == 0:
                print(f"{idx}/{len(db)}")
    seconds = time.perf_counter() - t0
    vae_s, clip_s = timer.parts.get("vae", 0.0), timer.parts.get("clip", 0.0)
    report = dict(images=len(db), seconds=seconds, images_per_s=len(db) / seconds,
                  vae_s=vae_s, clip_s=clip_s, host_s=seconds - vae_s - clip_s,
                  device=str(device), batch=args.batch)
    print(json.dumps(report))
    return report


def load_vae(path: str, device):
    """The SD KL-VAE of `models/vae.py::get_model` with the reference state
    dict at `path`, strictly, in f32 on `device`."""
    from ..models import vae as vae_lib
    from ..utils.weights import load_torch_state_dict

    vae = vae_lib.get_model()
    vae.load_state_dict(load_torch_state_dict(path), strict=True)
    return vae.to(device).eval().requires_grad_(False)


@torch.no_grad()
def encode_moments(vae, image: np.ndarray, device) -> np.ndarray:
    """One (H, W, 3) image in [-1, 1] -> its moments (2C, h, w) f32, with
    cuDNN's TF32 off (`evaluation/inception.py::no_tf32`): f32 convolutions,
    as the JAX package's."""
    from ..evaluation.inception import no_tf32

    with no_tf32():
        x = torch.from_numpy(np.ascontiguousarray(image)).to(device)[None].permute(0, 3, 1, 2)
        return vae.encode_moments(x)[0].cpu().numpy()


class Timer:
    """Seconds per part, synchronising the card before each reading."""

    def __init__(self, device):
        self.sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else None
        self.parts = {}

    def __call__(self, part: str, fn):
        t0 = time.perf_counter()
        out = fn()
        if self.sync is not None:
            self.sync()
        self.parts[part] = self.parts.get(part, 0.0) + time.perf_counter() - t0
        return out


if __name__ == "__main__":
    main()
