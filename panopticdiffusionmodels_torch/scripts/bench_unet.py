"""The UNet / PNDM family (`mscoco_unet`) on the card: a smoke run and its
throughput.

    python -m panopticdiffusionmodels_torch.scripts.bench_unet

Port of `scripts/bench_unet.py`.  The reference's `use_unet=True` path
samples an SD-1.x UNet with PNDM (PLMS) and a mask stream held fixed across
the NFEs; here `models/unet.py` (UNet2DCondition with the zero-gated mask
stream) at `mscoco_unet`'s geometry from seed 0 in bf16, served by
`serving.GenerationPipeline`: the t2i CFG at scale 1.0 against the zero
context as one 2x batch, BENCH_STEPS (50) PNDM steps, then the SD KL-VAE
decode (seed 1, bf16), on the CLIP contexts of numpy seed 7.  It prints
the parameter count, the first run (with its finite check) and images
(+ masks) a second, the best of BENCH_REPS (3) requests after it.  The
UNet's attention is the plain one, as in the JAX package
(`models/unet.py`, impl="xla"): no kernel of the port runs, and the JSON
line counts that none did.  Env: BENCH_BATCH (8), BENCH_STEPS (50),
BENCH_PANOPTIC=off drops the mask stream.  `--device=cpu` runs on the CPU.
"""
from __future__ import annotations

import copy
import os
import sys
import time

import numpy as np
import torch

from ..configs import get_config
from ..models import get_nnet
from ..models.vae import AutoencoderKL
from ..models.vae import get_model as get_vae
from ..serving import GenerationPipeline
from .measure import finish, read_counts, require_device, split_device, sync, zero_counts


def build(panoptic: bool, device="cuda", config=None, vae_geometry=None) -> GenerationPipeline:
    """`mscoco_unet` (or `config`) with or without its mask stream: the UNet
    from seed 0 and the bf16 VAE (or `AutoencoderKL(**vae_geometry)`) from
    seed 1."""
    config = copy.deepcopy(config or get_config("mscoco_unet"))
    config.compute_dtype = "bfloat16"
    config.nnet.enable_panoptic = panoptic
    kwargs = dict(config.nnet)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        nnet = get_nnet(kwargs.pop("name"), **kwargs)
        torch.manual_seed(1)
        vae = (get_vae(dtype=torch.bfloat16) if vae_geometry is None
               else AutoencoderKL(**vae_geometry, dtype=torch.bfloat16))
    return GenerationPipeline(config, nnet, vae, device=device)


def main(argv=None, device="cuda", config=None, vae_geometry=None) -> dict:
    argv = sys.argv[1:] if argv is None else list(argv)
    device, _ = split_device(argv, device)
    device = require_device(device, "bench_unet")
    batch = int(os.environ.get("BENCH_BATCH", "8"))
    steps = int(os.environ.get("BENCH_STEPS", "50"))
    reps = int(os.environ.get("BENCH_REPS", "3"))
    panoptic = os.environ.get("BENCH_PANOPTIC", "on") != "off"
    pipe = build(panoptic, device, config, vae_geometry)
    n_params = sum(p.numel() for p in pipe.nnet.parameters())
    print(f"UNet2DCondition({'panoptic' if panoptic else 'image-only'}): "
          f"{n_params / 1e6:.1f}M params", flush=True)
    nn = pipe.config.nnet
    ctx = torch.from_numpy(np.random.RandomState(7).normal(
        size=(batch, nn.num_clip_token, nn.clip_dim)).astype(np.float32)).to(pipe.device)
    size, mask = nn.sample_size, nn.mask_size

    def run(i):
        g = torch.Generator(device=pipe.device).manual_seed(42 + i)
        z = torch.randn((batch, nn.in_chans, size, size), generator=g, device=pipe.device)
        m = (torch.randn((batch, nn.mask_bits, mask, mask), generator=g, device=pipe.device)
             if panoptic else None)
        img, pm = pipe.sample(z, m, ctx, steps)
        s = float(img[:1, :, ::64, ::64].float().sum())  # device -> host
        if pm is not None:
            s += float(pm[:1, 0, ::32, ::32].float().sum())
        return img, pm

    zero_counts()
    t0 = time.perf_counter()
    img, pm = run(-1)
    first_s = time.perf_counter() - t0
    finite = bool(torch.isfinite(img).all())
    finite_mask = None if pm is None else bool(torch.isfinite(pm).all())
    print(f"compile+first run: {first_s:.1f}s; img {tuple(img.shape)} finite={finite}"
          + (f"; mask {tuple(pm.shape)} finite={finite_mask}" if pm is not None else ""),
          flush=True)
    times = []
    for i in range(reps):
        sync(device)
        t0 = time.perf_counter()
        run(i)
        times.append(time.perf_counter() - t0)
    unit = "img+mask/s" if panoptic else "img/s"
    ips = batch / min(times)
    print(f"mscoco_unet {steps}-NFE PNDM CFG + decode, batch {batch}: {ips:.2f} {unit}")
    return finish("bench_unet", dict(
        batch=batch, steps=steps, reps=reps, panoptic=panoptic, params=n_params,
        first_run_s=first_s, finite=finite, finite_mask=finite_mask,
        image_shape=list(img.shape), images_per_s=ips, best_ms=min(times) * 1e3,
        real_evals=pipe.last_real_evals, launches=read_counts()), device)


if __name__ == "__main__":
    main()
