"""Panoptic (dual-stream) pipeline speed modes on the card: throughput and
joint-output deviation.

    python -m panopticdiffusionmodels_torch.scripts.bench_panoptic_modes \
        [accel=0.2] [interval=0.0,0.5] [combo=0.2:0.0,0.5] ...

Port of `scripts/bench_panoptic_modes.py`.  The headline panoptic protocol:
the dual-stream U-ViT (`mscoco_uvit_small`'s geometry by default) from
seeded random weights in bf16, with the packed-qkv attention kernel,
50-NFE mask-aware DPM-Solver-fast, t2i CFG at scale 1.0 against the zero
context with the mask extrapolated, then the SD KL-VAE decode in bf16: image
and mask trajectories in one request.  For each speed mode it prints
images + masks a second, the relative L2 deviation of the decoded images
and of the analog-bit mask prediction from the exact protocol on the same
noise, and the share of flipped mask bits (what decides whether mask ids
survive).  The geometry `512` (`mscoco_uvit_small_512`, L = 1102 / 2126
tokens a stream) runs the attention kernel's long-sequence rows.

Modes, in the quality gate's spec grammar (`quality_gate.parse_spec`):
accel=<tau>, interval=<lo>,<hi>, combo=<tau>:<lo>,<hi>, gelu=tanh,
gelu_accel=<tau>, full=<tau>:<lo>,<hi>, ihold=<lo>,<hi>,
full_hold=<tau>:<lo>,<hi>; default accel=0.2 combo=0.2:0.0,0.5.
Env: BENCH_BATCH (32), BENCH_GEO (256, large or 512).  Runs on the card;
`build(..., device="cpu")` runs it on the CPU.
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from ..diffusion.cfg import make_cfg_t2i
from ..diffusion.schedule import Schedule, stable_diffusion_beta_schedule
from ..models import UViTT2I
from ..models.vae import get_model as get_vae
from ..samplers.dpm_solver import DPMSolver
from ..samplers.noise_schedule import NoiseScheduleVP

GEOS = {
    # img, patch, embed, depth, heads, mask_size
    # (mscoco_uvit_small / mscoco_uvit_large / mscoco_uvit_small_512)
    "256": dict(img=32, patch=2, embed=512, depth=12, heads=8, mask=64),
    "large": dict(img=32, patch=2, embed=1024, depth=20, heads=16, mask=64),
    "512": dict(img=64, patch=2, embed=512, depth=12, heads=8, mask=128),
}


def require_device(device, what: str = "bench_panoptic_modes") -> torch.device:
    """`device` as a torch.device; a CUDA device when there is none raises
    (the port's scripts run on the card unless the caller passes the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{what} runs on the card and no CUDA device was found; pass "
                           f"device='cpu' (--device=cpu on the command line) to run it on the "
                           f"CPU")
    return device


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def solve(model_fn, z, steps: int, accel: float, interval, hold: bool = False, m=None):
    """The protocol's solver on NCHW noise: order-3 DPM-Solver++ 'fast'
    (eps 1/1000, T 1) on the discrete SD schedule with the speed modes;
    returns z0, or (z0, pred_mask) with a mask token."""
    ns = NoiseScheduleVP("discrete", betas=stable_diffusion_beta_schedule())
    solver = DPMSolver(model_fn, ns, predict_x0=True, accel_tau=accel,
                       cfg_interval=tuple(interval) if interval else None,
                       mask_guidance_hold=hold)
    return solver.sample(z, steps=steps, eps=1.0 / 1000, T=1.0, order=3, method="fast",
                         mask_token=m)


def t2i_sampler(model, vae, empty_context: torch.Tensor, accel: float, interval, hold: bool,
                steps: int = 50):
    """run(context, z, m) -> (images in [-1, 1], pred_mask, z0), channel-last
    f32 on the device, from NCHW noise z and m: the t2i CFG at scale 1.0 (one
    2x batch a guided NFE, the mask extrapolated too) around `solve`, then
    the VAE decode."""
    n_train = Schedule(stable_diffusion_beta_schedule()).N
    cfg_fn = make_cfg_t2i(lambda xx, tt, cc, mask_token=None: model(xx, tt, cc,
                                                                    mask_token=mask_token),
                          empty_context, scale=1.0, enabled=True)

    @torch.no_grad()
    def run(context, z, m):
        def model_fn(xx, tt, mask_token=None, cfg_on=True, **mkw):
            return cfg_fn(xx, tt * n_train, context, mask_token=mask_token, cfg_on=cfg_on,
                          **mkw)

        z0, pred_mask = solve(model_fn, z, steps, accel, interval, hold, m)
        img = vae.decode(z0)
        return tuple(t.float().permute(0, 2, 3, 1) for t in (img, pred_mask, z0))

    return run


def build(batch: int, accel: float, interval, gelu: bool = False, hold: bool = False,
          geo: str = None, device="cuda"):
    """(run, z_shape, m_shape): the protocol at `geo` (default BENCH_GEO,
    else 256) on seeded weights (the network from seed 0, the VAE from seed
    1, whatever the GELU), `run` as `t2i_sampler`'s, the NCHW noise shapes of
    a batch."""
    g = GEOS[geo or os.environ.get("BENCH_GEO", "256")]
    device = require_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = UViTT2I(img_size=g["img"], patch_size=g["patch"], in_chans=4,
                        embed_dim=g["embed"], depth=g["depth"], num_heads=g["heads"],
                        clip_dim=768, num_clip_token=77, mask_bits=8, mask_size=g["mask"],
                        enable_panoptic=True, separate=True, attn_impl="infer",
                        gelu_approx=gelu)
        torch.manual_seed(1)
        vae = get_vae(dtype=torch.bfloat16)
    model = model.to(device, torch.bfloat16).eval()
    vae = vae.to(device).eval()
    empty = torch.zeros((77, 768), device=device)
    run = t2i_sampler(model, vae, empty, accel, interval, hold)
    return run, (batch, 4, g["img"], g["img"]), (batch, 8, g["mask"], g["mask"])


def run_mode(batch: int, accel: float, interval, gelu: bool = False, hold: bool = False,
             device="cuda"):
    """(images + masks a second, best of 3 after a warm-up; images; pred_mask)
    on the noise of seed 7 and zero contexts."""
    run, z_shape, m_shape = build(batch, accel, interval, gelu, hold, device=device)
    gen = torch.Generator(device=device).manual_seed(7)
    z = torch.randn(z_shape, generator=gen, device=device)
    m = torch.randn(m_shape, generator=gen, device=device)
    ctx = torch.zeros((batch, 77, 768), device=device)
    run(ctx, z, m)
    times, img, pm = [], None, None
    for _ in range(3):
        sync(device)
        t0 = time.perf_counter()
        img, pm, _ = run(ctx, z, m)
        sync(device)
        times.append(time.perf_counter() - t0)
    return batch / min(times), img.cpu().numpy(), pm.cpu().numpy()


def main(argv=None, device="cuda") -> None:
    from .quality_gate import parse_spec  # the gate's grammar (it imports this module)

    argv = sys.argv[1:] if argv is None else argv
    device = next((a.split("=", 1)[1] for a in argv if a.startswith("--device=")), device)
    modes = [a for a in argv if not a.startswith("--")] or ["accel=0.2", "combo=0.2:0.0,0.5"]
    specs = {mode: parse_spec(mode) for mode in modes}
    for mode, (_, _, _, steps, _) in specs.items():
        if steps != 50:
            raise SystemExit(f"{mode}: the protocol runs 50 steps; steps=<n> is a gate control")
    batch = int(os.environ.get("BENCH_BATCH", "32"))
    ips0, img0, pm0 = run_mode(batch, 0.0, None, device=device)
    print(f"exact panoptic protocol: {ips0:.2f} img+mask/s")
    bits0 = pm0 > 0.0
    for mode, (accel, interval, gelu, _, hold) in specs.items():
        ips, img, pm = run_mode(batch, accel, interval, gelu, hold, device=device)
        rel_img = float(np.linalg.norm(img - img0)) / float(np.linalg.norm(img0))
        rel_mask = float(np.linalg.norm(pm - pm0)) / float(np.linalg.norm(pm0))
        flips = float(np.mean((pm > 0.0) != bits0))
        print(f"{mode:18s}: {ips:6.2f} img+mask/s ({ips / ips0:.2f}x)  "
              f"img dev {100 * rel_img:.2f}%  mask dev {100 * rel_mask:.2f}%  "
              f"bit flips {100 * flips:.2f}%")


if __name__ == "__main__":
    main()
