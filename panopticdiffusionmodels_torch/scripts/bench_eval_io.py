"""A/B of the evaluation loop's overlap on the card: `sample2dir` with and
without its one-deep pipeline, then the FID statistics pass with and
without its decode workers.

    python -m panopticdiffusionmodels_torch.scripts.bench_eval_io

Port of `scripts/bench_eval_io.py`.  The headline sampling pipeline
(`scripts/bench.py`: ImageNet-256 U-ViT-L/2, 50-NFE CFG + the bf16 VAE
decode, a `serving.GenerationPipeline.sample` call) writes BENCH_N (160)
samples in batches of BENCH_BATCH (32) through
`evaluation.sampler_io.sample2dir` (the loop the 10k / 50k-sample FID
evaluations run), with `overlap` False and then True: with it the host's
PNG encoding overlaps the card's sampling.  BENCH_ROUNDS (1) repeats the
pair in turns (off, on, on, off, ...), so that the two arms share the
host's state.  Then
`evaluation.fid.dir_statistics` scores the written PNGs with the
random-weight Inception (`inception.random_state_dict(0)`; throughput does
not depend on the weights) at `workers` 0 (sequential) and 8 (threaded
decode, one batch deep on the card), after one untimed pass.
`--device=cpu` runs on the CPU.
"""
from __future__ import annotations

import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from ..evaluation.fid import dir_statistics
from ..evaluation.inception import from_state_dict, make_extractor, random_state_dict
from ..evaluation.sampler_io import sample2dir
from . import bench
from .measure import finish, read_counts, require_device, split_device, sync, zero_counts


def main(argv=None, device="cuda", components=None, extractor=None) -> dict:
    """`components` (`bench.build_components`) and `extractor` (images ->
    features) cut it to a tiny size for the CPU."""
    argv = sys.argv[1:] if argv is None else list(argv)
    device, _ = split_device(argv, device)
    device = require_device(device, "bench_eval_io")
    batch = int(os.environ.get("BENCH_BATCH", "32"))
    n_samples = int(os.environ.get("BENCH_N", "160"))
    rounds = int(os.environ.get("BENCH_ROUNDS", "1"))
    pipe = bench.build_pipeline(components or bench.build_components(device))
    h, w, c = pipe.config.z_shape
    y = torch.zeros((batch,), dtype=torch.int64, device=pipe.device)
    counter = {}

    def sample_fn(n):
        idx = np.arange(counter["n"], counter["n"] + n)
        counter["n"] += n
        z = torch.randn((n, c, h, w), generator=counter["g"], device=pipe.device)
        return idx, pipe.sample(z, None, y[:n])[0].float().permute(0, 2, 3, 1)

    counter.update(n=0, g=torch.Generator(device=pipe.device).manual_seed(0))
    float(sample_fn(batch)[1][0, 0, 0, 0])  # warm-up
    png_dir, arms = None, []
    zero_counts()
    for overlap in [bool((r + i) % 2) for r in range(rounds) for i in (0, 1)]:  # off, on, on, off
        counter.update(n=0, g=torch.Generator(device=pipe.device).manual_seed(0))
        d = tempfile.mkdtemp(prefix=f"evalio{int(overlap)}_")
        sync(device)
        t0 = time.perf_counter()
        sample2dir(d, n_samples, batch, sample_fn,
                   unpreprocess_fn=lambda v: np.clip((v + 1) / 2, 0, 1), overlap=overlap)
        dt = time.perf_counter() - t0
        n_png = len(os.listdir(d))
        if png_dir is None:
            png_dir = d
        else:
            shutil.rmtree(d)
        print(f"overlap={overlap}: {n_samples} samples + {n_png} PNG writes "
              f"in {dt:.2f}s = {n_samples / dt:.2f} img/s", flush=True)
        arms.append(dict(overlap=overlap, seconds=dt, pngs=n_png, images_per_s=n_samples / dt))
    launches = read_counts()["fused_attention_qkv"]

    extractor = extractor or make_extractor(from_state_dict(random_state_dict(0)), device)
    stats = []
    try:
        dir_statistics(png_dir, extractor, batch_size=50, workers=0)  # warm-up
        for workers in (0, 8):
            sync(device)
            t0 = time.perf_counter()
            dir_statistics(png_dir, extractor, batch_size=50, workers=workers)
            dt = time.perf_counter() - t0
            print(f"fid stats workers={workers}: {n_samples} PNGs in {dt:.2f}s "
                  f"= {n_samples / dt:.1f} img/s")
            stats.append(dict(workers=workers, seconds=dt, images_per_s=n_samples / dt))
    finally:
        shutil.rmtree(png_dir)
    for overlap in (False, True):
        secs = [a["seconds"] for a in arms if a["overlap"] == overlap]
        print(f"overlap={overlap}: median {np.median(secs):.2f}s over {len(secs)} "
              f"[{min(secs):.2f}-{max(secs):.2f}]")
    return finish("bench_eval_io", dict(
        batch=batch, n_samples=n_samples, rounds=rounds, sample2dir=arms, fid_stats=stats,
        kernel_launches=launches, real_evals_per_batch=pipe.last_real_evals), device)


if __name__ == "__main__":
    main()
