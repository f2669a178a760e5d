"""Pre-encode ImageNet into flip-augmented latent moments.

    python -m panopticdiffusionmodels_torch.scripts.extract_imagenet_feature \
        --datadir <root with train/<class>/*.JPEG> --outdir <dir> \
        --autoencoder assets/stable-diffusion/autoencoder_kl.pth [--size 256] \
        [--device cuda|cpu]

Port of `scripts/extract_imagenet_feature.py` (reference
`scripts/extract_imagenet_feature.py:32-44`): the images of the sorted class
directories, in sorted name order, labelled by their class's index, are
centre-cropped and resized by `data/datasets.py::FolderImageDataset`; image
i writes `{2i}.npy` (as it is) and `{2i+1}.npy` (flipped left to right),
each a pickled object array (moments (2C, h, w) f32, label), which
`data/datasets.py::FeatureDataset` reads back.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--datadir", required=True, help="ImageNet root with train/<class>/*.JPEG")
    p.add_argument("--outdir", required=True)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--autoencoder", default="assets/stable-diffusion/autoencoder_kl.pth")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    from ..data.datasets import FolderImageDataset
    from .extract_mscoco_feature import encode_moments, load_vae

    train_root = os.path.join(args.datadir, "train")
    paths, labels = [], []
    for ci, cname in enumerate(sorted(os.listdir(train_root))):
        cdir = os.path.join(train_root, cname)
        for n in sorted(os.listdir(cdir)):
            paths.append(os.path.join(cdir, n))
            labels.append(ci)
    ds = FolderImageDataset(paths, args.size, labels=labels, random_flip=False)
    device = torch.device(args.device)
    vae = load_vae(args.autoencoder, device)
    os.makedirs(args.outdir, exist_ok=True)
    for i in range(len(ds)):
        img, label = ds[i]
        for j, arr in enumerate([img, img[:, ::-1, :]]):  # the flip augmentation
            np.save(os.path.join(args.outdir, f"{2 * i + j}.npy"),
                    np.asarray((encode_moments(vae, arr, device), label), dtype=object))
        if i % 1000 == 0:
            print(f"{i}/{len(ds)}")
    return len(ds)


if __name__ == "__main__":
    main()
