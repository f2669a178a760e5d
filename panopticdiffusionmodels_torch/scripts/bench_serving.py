"""Serving latency and throughput: `serving.GenerationPipeline.generate` on
the card.

    python -m panopticdiffusionmodels_torch.scripts.bench_serving [batch ...]

Port of `scripts/bench_serving.py`.  For each request batch (default 1, 4,
8 and 32 CLIP contexts) the end-to-end `generate(contexts=...)` latency of
`mscoco_uvit_small` on seeded random weights (50-NFE panoptic dual-stream
DPM-Solver with CFG, the f32 VAE decode, and the host's postprocess:
analog-bit decode and [0, 1] images), median of BENCH_REPS (5) requests
after a warm-up, and images + masks a second; for the exact protocol and
for the gate-validated speed configuration (tanh GELU + accel = 0.2).  The
attention runs kernel 1; the JSON line counts its launches over the timed
requests of each mode.  `--device=cpu` runs on the CPU.
"""
from __future__ import annotations

import copy
import os
import sys
import time

import numpy as np

from ..configs import get_config
from ..serving import GenerationPipeline
from .measure import finish, read_counts, require_device, split_device, zero_counts

DEFAULT_BATCHES = [1, 4, 8, 32]
MODES = {"exact protocol": False, "gelu+accel=0.2": True}


def build(speed: bool, device="cuda", config=None) -> GenerationPipeline:
    """The pipeline from `mscoco_uvit_small` (or `config`), seed 0; with
    `speed` the tanh GELU and forecast-skip tau 0.2."""
    config = copy.deepcopy(config or get_config("mscoco_uvit_small"))
    if speed:
        config.nnet.gelu_approx = True
        config.sample.accel = 0.2
    return GenerationPipeline.from_config(config, device=device)


def bench(pipe: GenerationPipeline, n: int, reps: int = 5):
    """(median latency s, images a second, launches) of `reps` requests of
    n zero contexts after a warm-up request."""
    nn = pipe.config.nnet
    ctx = np.zeros((n, nn.num_clip_token, nn.clip_dim), np.float32)
    pipe.generate(contexts=ctx)
    zero_counts()
    times = []
    for r in range(reps):
        t0 = time.perf_counter()
        out = pipe.generate(contexts=ctx, seed=r)  # ends on the host: numpy images and ids
        assert np.isfinite(out[0]).all()
        times.append(time.perf_counter() - t0)
    lat = float(np.median(times))
    return lat, n / lat, read_counts()["fused_attention_qkv"]


def main(argv=None, device="cuda", config=None) -> dict:
    argv = sys.argv[1:] if argv is None else list(argv)
    device, rest = split_device(argv, device)
    device = require_device(device, "bench_serving")
    batches = [int(b) for b in rest] or DEFAULT_BATCHES
    reps = int(os.environ.get("BENCH_REPS", "5"))
    modes = {}
    for tag, speed in MODES.items():
        pipe = build(speed, device, config)
        print(f"--- {tag} (50 NFE, CFG, panoptic S/2 + VAE decode) ---")
        rows = []
        for n in batches:
            lat, ips, launches = bench(pipe, n, reps)
            print(f"batch {n:3d}: {lat * 1000:8.0f} ms/request  {ips:6.2f} img+mask/s",
                  flush=True)
            rows.append(dict(batch=n, latency_ms=lat * 1e3, img_mask_per_s=ips,
                             kernel_launches=launches))
        modes[tag] = rows
        del pipe
    return finish("bench_serving", dict(reps=reps, modes=modes), device)


if __name__ == "__main__":
    main()
