"""Speed modes of the headline pipeline on the card: throughput and
deviation from the exact protocol.

    python -m panopticdiffusionmodels_torch.scripts.bench_speed_modes \
        [accel=<tau>] [interval=<lo>,<hi>] [combo=<tau>:<lo>,<hi>] [gelu=tanh] \
        [full=<tau>:<lo>,<hi>] [gelu_accel=<tau>] ...

Modes are in the quality gate's spec grammar (`quality_gate.parse_spec`).

Port of `scripts/bench_speed_modes.py`.  For each mode (default accel=0.2,
accel=0.3, interval=0.0,0.5, combo=0.2:0.0,0.5) the ImageNet-256
U-ViT-L/2 50-NFE pipeline of `scripts/bench.py` (seeded weights, bf16, the
packed-qkv attention kernel, CFG 0.4, the bf16 VAE decode, a
`serving.GenerationPipeline.sample` call) runs on the same noise as the
exact protocol; it prints images/s (best of BENCH_REPS (3) after a
warm-up) and the relative L2 and mean absolute deviation of the decoded
images from the exact protocol's.  accel approximates the same trajectory
(the deviation is numerical error); cfg_interval is another guidance
protocol, whose deviation only shows the output stays in distribution.
gelu=tanh runs the tanh GELU on the same weights.  BENCH_BATCH (32).
`--device=cpu` runs on the CPU.
"""
from __future__ import annotations

import os
import sys

import numpy as np
import torch

from . import bench
from .measure import finish, read_counts, require_device, split_device, sync, times_s, zero_counts
from .quality_gate import parse_spec

DEFAULT_MODES = ["accel=0.2", "accel=0.3", "interval=0.0,0.5", "combo=0.2:0.0,0.5"]
NOISE_SEED = 7  # every mode samples the same noise


def mode_knobs(mode: str):
    """(accel, interval or None, gelu) of a mode in the quality gate's spec
    grammar (`quality_gate.parse_spec`); its steps= controls and mask-hold
    specs are refused: this pipeline runs 50 steps and has no mask."""
    accel, interval, gelu, steps, hold = parse_spec(mode)
    if steps != 50 or hold:
        raise SystemExit(f"{mode}: bench_speed_modes runs the 50-step image protocol")
    return accel, interval, gelu


def run_mode(components, batch: int, accel: float, interval, gelu: bool, reps: int = 3):
    """(images a second, decoded images NHWC f32 numpy, real evals, kernel
    launches a request) of the mode on seed NOISE_SEED's noise and label 0."""
    pipe = bench.build_pipeline(components, accel=accel, cfg_interval=tuple(interval or ()),
                                gelu=gelu)
    h, w, c = pipe.config.z_shape
    g = torch.Generator(device=pipe.device).manual_seed(NOISE_SEED)
    z = torch.randn((batch, c, h, w), generator=g, device=pipe.device)
    y = torch.zeros((batch,), dtype=torch.int64, device=pipe.device)
    out = {}

    def request():
        out["img"] = pipe.sample(z, None, y)[0]

    request()
    sync(pipe.device)
    zero_counts()
    times = times_s(request, reps, pipe.device, warmup=0)
    launches = read_counts()["fused_attention_qkv"] // reps
    img = out["img"].float().permute(0, 2, 3, 1).cpu().numpy()
    return batch / min(times), img, pipe.last_real_evals, launches


def deviation(img: np.ndarray, base: np.ndarray):
    """(relative L2, mean absolute) deviation of img from base."""
    diff = img.astype(np.float64) - base.astype(np.float64)
    return (float(np.linalg.norm(diff)) / float(np.linalg.norm(base.astype(np.float64))),
            float(np.abs(diff).mean()))


def main(argv=None, device="cuda", components=None) -> dict:
    """Every mode against the exact protocol; `components`
    (`bench.build_components`) cut the pipeline to a tiny size for the CPU."""
    argv = sys.argv[1:] if argv is None else list(argv)
    device, modes = split_device(argv, device)
    device = require_device(device, "bench_speed_modes")
    modes = modes or DEFAULT_MODES
    specs = {mode: mode_knobs(mode) for mode in modes}
    batch = int(os.environ.get("BENCH_BATCH", "32"))
    reps = int(os.environ.get("BENCH_REPS", "3"))
    components = components or bench.build_components(device)
    base_ips, base_img, base_evals, base_launches = run_mode(components, batch, 0.0, None,
                                                             False, reps)
    print(f"exact protocol: {base_ips:.2f} img/s")
    rows = [dict(mode="exact", images_per_s=base_ips, rel_l2_dev=0.0, mean_abs_dev=0.0,
                 real_evals=base_evals, kernel_launches=base_launches)]
    for mode, (accel, interval, gelu) in specs.items():
        ips, img, evals, launches = run_mode(components, batch, accel, interval, gelu, reps)
        rel, mad = deviation(img, base_img)
        print(f"{mode:18s}: {ips:6.2f} img/s ({ips / base_ips:.2f}x)  "
              f"rel L2 dev {100 * rel:.2f}%  mean abs dev {mad:.4f}")
        rows.append(dict(mode=mode, images_per_s=ips, speedup=ips / base_ips, rel_l2_dev=rel,
                         mean_abs_dev=mad, real_evals=evals, kernel_launches=launches))
    return finish("bench_speed_modes", dict(batch=batch, reps=reps, modes=rows), device)


if __name__ == "__main__":
    main()
