"""FID: the Frechet distance, activation statistics and stats files.

Port of `panopticdiffusionmodels_tpu/evaluation/fid.py`.  The math is
pytorch-fid's (reference `tools/fid_score.py:149-211`): FID = |mu1 - mu2|^2 +
tr(S1 + S2 - 2 sqrt(S1 S2)), with scipy's `sqrtm` on the host and the same
eps retry for a near-singular product.  Stats files are the reference's
`.npz` (keys `mu` / `sigma`), so either package reads the other's.  The
features come from `inception.make_extractor`, which runs on the card.

    python -m panopticdiffusionmodels_torch.evaluation.fid DIR_OR_NPZ DIR_OR_NPZ \
        [--inception assets/fid_stats/pt_inception-2015-12-05.pth] [--device cuda]
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Tuple

import numpy as np
import torch
from scipy import linalg

from ..utils.misc import one_deep, to_numpy

INCEPTION_WEIGHTS = "assets/fid_stats/pt_inception-2015-12-05.pth"
IMAGE_SUFFIXES = (".png", ".jpg", ".jpeg")


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """reference `tools/fid_score.py:149-199` (numpy / scipy semantics)."""
    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    if mu1.shape != mu2.shape or sigma1.shape != sigma2.shape:
        raise ValueError(f"statistics differ in shape: {mu1.shape} / {mu2.shape}, "
                         f"{sigma1.shape} / {sigma2.shape}")
    diff = mu1 - mu2

    def _sqrtm(m):
        out = linalg.sqrtm(m)
        return out[0] if isinstance(out, tuple) else out

    covmean = _sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = _sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            raise ValueError(f"Imaginary component {np.max(np.abs(covmean.imag))}")
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * np.trace(covmean))


def compute_statistics(activations: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(N, D) activations -> (mu, sigma) (reference `tools/fid_score.py:202-236`)."""
    return np.mean(activations, axis=0), np.cov(activations, rowvar=False)


def load_stats(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """A reference-format stats npz (keys mu / sigma,
    reference `tools/fid_score.py:218-221`)."""
    with np.load(path) as f:
        return f["mu"][:], f["sigma"][:]


def save_stats(path: str, mu: np.ndarray, sigma: np.ndarray):
    np.savez(path, mu=mu, sigma=sigma)


def fid_from_stats(stat_a, stat_b) -> float:
    """stat_*: (mu, sigma) tuples or paths to npz files."""
    if isinstance(stat_a, (str, os.PathLike)):
        stat_a = load_stats(stat_a)
    if isinstance(stat_b, (str, os.PathLike)):
        stat_b = load_stats(stat_b)
    return frechet_distance(stat_a[0], stat_a[1], stat_b[0], stat_b[1])


def activations_from_images(images: Iterable[np.ndarray],
                            extractor: Callable[[np.ndarray], torch.Tensor]) -> np.ndarray:
    """The pool3 extractor over batches of [0, 1] NHWC images."""
    return np.concatenate([to_numpy(extractor(batch)) for batch in images], axis=0)


def fid_given_samples(samples: np.ndarray, ref_stat_path: str,
                      extractor: Callable[[np.ndarray], torch.Tensor],
                      batch_size: int = 50) -> float:
    """FID of [0, 1] NHWC samples against a reference stats npz (reference
    `train.py:142`, `tools/fid_score.py:239-260`)."""
    batches = [samples[i:i + batch_size] for i in range(0, len(samples), batch_size)]
    mu, sigma = compute_statistics(activations_from_images(batches, extractor))
    return fid_from_stats((mu, sigma), ref_stat_path)


def load_image(path: str) -> np.ndarray:
    """An image file -> (H, W, 3) f32 in [0, 1], through PIL as the JAX package."""
    from PIL import Image

    with Image.open(path) as img:
        return np.asarray(img.convert("RGB")).astype(np.float32) / 255.0


def dir_statistics(path: str, extractor: Callable[[np.ndarray], torch.Tensor],
                   batch_size: int = 50, workers: int = 8) -> Tuple[np.ndarray, np.ndarray]:
    """(mu, sigma) over every image of a directory, in name order.

    With `workers > 0` the files are decoded on a thread pool (PIL releases
    the GIL in the decode), and batch i + 1 is decoded and enqueued on the
    card before batch i's features are copied back (`one_deep`).
    `workers=0` is the sequential path; both give the same outputs."""
    names = sorted(n for n in os.listdir(path) if n.lower().endswith(IMAGE_SUFFIXES))
    if not names:
        raise ValueError(f"dir_statistics: no images found in {path!r}")
    paths = [os.path.join(path, n) for n in names]
    chunks = [paths[i:i + batch_size] for i in range(0, len(paths), batch_size)]
    if workers <= 0:
        feats = [to_numpy(extractor(np.stack([load_image(p) for p in c]))) for c in chunks]
    else:
        with ThreadPoolExecutor(workers) as ex:
            dispatch = lambda chunk: extractor(np.stack(list(ex.map(load_image, chunk))))  # noqa: E731
            feats = [to_numpy(out) for _, out in one_deep(chunks, dispatch)]
    return compute_statistics(np.concatenate(feats, axis=0))


def fid_given_paths(path_a: str, path_b: str, extractor: Callable[[np.ndarray], torch.Tensor],
                    batch_size: int = 50) -> float:
    """FID between two stats files / image directories (reference
    `tools/fid_score.py:239-260`); a path ending in .npz is read as stats."""

    def stats_for(path):
        if path.endswith(".npz"):
            return load_stats(path)
        return dir_statistics(path, extractor, batch_size)

    a, b = stats_for(path_a), stats_for(path_b)
    return frechet_distance(a[0], a[1], b[0], b[1])


def _main():
    """CLI: FID between two image dirs / stat files (the reference
    tools/fid_score.py CLI)."""
    import argparse

    from .inception import load_inception_weights, make_extractor

    p = argparse.ArgumentParser(description="FID between two image dirs / stat files")
    p.add_argument("path_a")
    p.add_argument("path_b", nargs="?")
    p.add_argument("--batch-size", type=int, default=50)
    p.add_argument("--inception", default=INCEPTION_WEIGHTS)
    p.add_argument("--device", default="cuda")
    p.add_argument("--save-stats", default=None,
                   help="compute the stats of path_a and write them to this npz instead")
    args = p.parse_args()
    extractor = make_extractor(load_inception_weights(args.inception), device=args.device)
    if args.save_stats:
        save_stats(args.save_stats, *dir_statistics(args.path_a, extractor, args.batch_size))
        print(f"saved stats of {args.path_a} to {args.save_stats}")
        return
    if args.path_b is None:
        p.error("path_b is required unless --save-stats is given")
    print("FID:", fid_given_paths(args.path_a, args.path_b, extractor, args.batch_size))


if __name__ == "__main__":
    _main()
