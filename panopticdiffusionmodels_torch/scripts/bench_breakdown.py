"""Wall-time breakdown of the headline pipeline (ImageNet-256 U-ViT-L/2,
50-NFE DPM-Solver++ with CFG, then the VAE decode) on the card.

    python -m panopticdiffusionmodels_torch.scripts.bench_breakdown

Port of `scripts/bench_breakdown.py`.  On the objects `scripts/bench.py`
runs (`bench.build_components`, one `serving.GenerationPipeline`), it times
the full pipeline, the solver alone (`sample(..., decode=False)`), the
decode alone (the VAE decoder on a fixed latent) and one CFG forward (the
2x-batch network call the solver makes each NFE), each the best of
BENCH_REPS (3) after a warm-up, and prints each part's share of the full
time and the residual.  Env as `bench.py`: BENCH_BATCH (32),
BENCH_CFG_INTERVAL, BENCH_ACCEL.  `--device=cpu` runs on the CPU.
"""
from __future__ import annotations

import os
import sys

import torch

from . import bench
from .measure import finish, read_counts, require_device, split_device, times_s, zero_counts


def main(argv=None, device="cuda", components=None) -> dict:
    """The four timings; `components` (`bench.build_components`) cut the
    pipeline to a tiny size for the CPU."""
    argv = sys.argv[1:] if argv is None else list(argv)
    device, _ = split_device(argv, device)
    device = require_device(device, "bench_breakdown")
    batch = int(os.environ.get("BENCH_BATCH", "32"))
    reps = int(os.environ.get("BENCH_REPS", "3"))
    components = components or bench.build_components(device)
    _, model, vae = components
    pipe = bench.build_pipeline(components)
    h, w, c = pipe.config.z_shape
    g = torch.Generator(device=pipe.device).manual_seed(0)
    z = torch.randn((batch, c, h, w), generator=g, device=pipe.device)
    y = torch.zeros((batch,), dtype=torch.int64, device=pipe.device)
    x2 = torch.cat([z, z]).to(pipe.dtype)
    t2 = torch.full((2 * batch,), 500.0, device=pipe.device)
    y2 = torch.cat([y, torch.full((batch,), 1000, dtype=torch.int64, device=pipe.device)])

    @torch.no_grad()
    def forward():
        return model(x2, t2, y2)

    @torch.no_grad()
    def decode():
        return vae.decode(z)

    parts = {"full": lambda: pipe.sample(z, None, y),
             "solver": lambda: pipe.sample(z, None, y, decode=False),
             "decode": decode, "cfg_forward": forward}
    best = {}
    launches = {}
    for name, fn in parts.items():
        zero_counts()
        best[name] = min(times_s(fn, reps, device))
        launches[name] = read_counts()["fused_attention_qkv"] // (reps + 1)
    t_full, t_solver, t_decode, t_fwd = (best[k] for k in parts)
    interval = pipe.config.sample.cfg_interval or None
    print(f"batch={batch} cfg_interval={interval}")
    print(f"full pipeline : {t_full * 1e3:9.1f} ms   ({batch / t_full:.2f} img/s)")
    print(f"solver only   : {t_solver * 1e3:9.1f} ms   ({100 * t_solver / t_full:.1f}% of full)")
    print(f"decode only   : {t_decode * 1e3:9.1f} ms   ({100 * t_decode / t_full:.1f}% of full)")
    nfe = pipe.last_real_evals
    print(f"1 CFG forward : {t_fwd * 1e3:9.1f} ms   (x{nfe} = {nfe * t_fwd * 1e3:.0f} ms, "
          f"{100 * nfe * t_fwd / t_full:.1f}% of full)")
    residual = t_full - t_solver - t_decode
    print(f"residual (full - solver - decode): {residual * 1e3:.1f} ms")
    return finish("bench_breakdown", dict(
        batch=batch, reps=reps, cfg_interval=list(interval or ()),
        full_ms=t_full * 1e3, solver_ms=t_solver * 1e3, decode_ms=t_decode * 1e3,
        cfg_forward_ms=t_fwd * 1e3, real_evals=nfe, images_per_s=batch / t_full,
        solver_share=t_solver / t_full, decode_share=t_decode / t_full,
        forwards_share=nfe * t_fwd / t_full, residual_ms=residual * 1e3,
        kernel_launches_per_call=launches), device)


if __name__ == "__main__":
    main()
