"""Protocol-scale evaluation rehearsal on the card: sample2dir ->
dir_statistics -> FID, each phase timed.

    python -m panopticdiffusionmodels_torch.scripts.eval_rehearsal

Port of `scripts/eval_rehearsal.py`: the reference's FID loop (sample N
images to a directory, extract their Inception statistics, the Frechet
distance against reference statistics) end to end on the flagship
geometry, the port bench's ImageNet-256 U-ViT-L/2 (`scripts/bench.py`:
seeded weights, bf16, 50-NFE CFG 0.4, the bf16 VAE decode) at batch 32:

  1. sample2dir: N samples to PNGs (`evaluation/sampler_io.py`, the next
     batch enqueued before the last is written);
  2. dir_statistics: the PNGs' (mu, sigma) with the FID InceptionV3 at the
     fixed random weights of `random_state_dict(0)`, on the card;
  3. frechet_distance against the port gate's exact statistics
     (QG_DIR/imagenet/exactB.npz of `scripts/quality_gate.py`) when present,
     else against the run's own (mu, sigma): a self-FD of about 0.

Prints one JSON line with JAX's keys: the seconds of each phase, end-to-end
images/s, the distance and its reference, and the wall-clock extrapolated
to the reference's 10k and 50k FID protocols.
Env: REH_N (1024), REH_BATCH (32), REH_DIR (default build/eval_rehearsal in
the checkout), QG_DIR as the quality gate's.  Runs on the card; `main(device=
"cpu", ...)` with small components runs it on the CPU.
"""
from __future__ import annotations

import json
import os
import shutil
import time
from pathlib import Path

import numpy as np
import torch

DEFAULT_DIR = Path(__file__).resolve().parents[2] / "build" / "eval_rehearsal"
EXTRACT_BATCH = 64


def reference_stats() -> str:
    from .quality_gate import gate_dir

    return os.path.join(gate_dir(), "imagenet", "exactB.npz")


def main(components=None, extractor=None, device="cuda") -> dict:
    """Run the rehearsal on `components` (default `bench.build_components`)
    with `extractor` (default the random-weight Inception), print and return
    the JSON record."""
    from ..evaluation.fid import dir_statistics, frechet_distance
    from ..evaluation.inception import from_state_dict, make_extractor, random_state_dict
    from ..evaluation.sampler_io import sample2dir
    from . import bench
    from .bench_panoptic_modes import require_device

    device = require_device(device, "eval_rehearsal")
    n = int(os.environ.get("REH_N", "1024"))
    batch = int(os.environ.get("REH_BATCH", "32"))
    out_dir = os.environ.get("REH_DIR", str(DEFAULT_DIR))
    png_dir = os.path.join(out_dir, "samples")
    shutil.rmtree(png_dir, ignore_errors=True)

    pipe = bench.build_pipeline(components or bench.build_components(device))
    h, w, c = pipe.config.z_shape
    state = {"i": 0}

    def sample_fn(nb):
        # no device-to-host copy here: sample2dir enqueues the next batch
        # before it writes this one
        i = state["i"]
        state["i"] += 1
        g = torch.Generator(device=pipe.device).manual_seed(4242 + i)
        z = torch.randn((batch, c, h, w), generator=g, device=pipe.device)
        y = torch.from_numpy(np.random.RandomState(7000 + i).randint(0, 1000, size=batch)
                             .astype(np.int64)).to(pipe.device)
        img = pipe.sample(z, None, y)[0].float().permute(0, 2, 3, 1)  # [-1, 1] NHWC
        return np.arange(i * batch, i * batch + nb), img[:nb]

    def unpre(x):  # sample2dir hands the images over as numpy
        return np.clip(np.asarray(x, np.float32) * 0.5 + 0.5, 0.0, 1.0)

    # the first request outside the timed region (kernel builds, allocator)
    _, img0 = sample_fn(batch)
    float(img0[:1, ::64, ::64].sum())
    state["i"] = 0

    t0 = time.perf_counter()
    sample2dir(png_dir, n, batch, sample_fn, unpreprocess_fn=unpre)
    t_sample = time.perf_counter() - t0
    n_png = len([f for f in os.listdir(png_dir) if f.endswith(".png")])
    assert n_png == n, (n_png, n)

    if extractor is None:
        extractor = make_extractor(from_state_dict(random_state_dict(0)), device=device)
    extractor(np.zeros((EXTRACT_BATCH, *_png_size(png_dir), 3), np.float32))  # warm-up
    t0 = time.perf_counter()
    mu, sigma = dir_statistics(png_dir, extractor, batch_size=EXTRACT_BATCH)
    t_stats = time.perf_counter() - t0

    ref_npz = reference_stats()
    t0 = time.perf_counter()
    if os.path.exists(ref_npz):
        with np.load(ref_npz) as ref:
            fd = frechet_distance(mu, sigma, ref["mu"], ref["sigma"])
        ref_kind = "quality_gate exactB"
    else:
        fd = frechet_distance(mu, sigma, mu, sigma)
        ref_kind = "self"
    t_fd = time.perf_counter() - t0

    total = t_sample + t_stats + t_fd
    result = {
        "metric": "eval_rehearsal_flagship",
        "n": n,
        "sample2dir_s": round(t_sample, 1),
        "dir_statistics_s": round(t_stats, 1),
        "frechet_s": round(t_fd, 1),
        "end_to_end_img_per_s": round(n / total, 2),
        "fd_vs_ref": fd,
        "ref": ref_kind,
        # stats and FD are O(N) + O(1): both protocols extrapolate linearly
        "protocol_10k_min": round((t_sample + t_stats) * (10000 / n) / 60 + t_fd / 60, 1),
        "protocol_50k_min": round((t_sample + t_stats) * (50000 / n) / 60 + t_fd / 60, 1),
    }
    print(json.dumps(result))
    return result


def _png_size(png_dir: str) -> tuple:
    """(H, W) of the first PNG in `png_dir`."""
    from PIL import Image

    name = sorted(f for f in os.listdir(png_dir) if f.endswith(".png"))[0]
    with Image.open(os.path.join(png_dir, name)) as im:
        return im.size[1], im.size[0]


if __name__ == "__main__":
    main()
