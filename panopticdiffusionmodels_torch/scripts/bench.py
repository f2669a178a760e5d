"""Headline benchmark of the port: ImageNet-256 U-ViT-L/2 50-step DPM-Solver++
sampling on one card, through the port's serving path.

    python -m panopticdiffusionmodels_torch.scripts.bench

Port of the root `bench.py`, with its protocol: seeded random U-ViT-L/2
weights in bf16 (throughput does not depend on the weights), the solver's
state in f32, 50-NFE order-3 DPM-Solver-fast (eps 1/1000, T 1.0), CFG scale
0.4 with the null class 1000 as one 2x-batch forward per NFE, and the SD
KL-VAE decode in bf16 (`models/vae.py`, dtype=bfloat16).  Every run is a
`serving.GenerationPipeline.sample` call on the `imagenet256_uvit_large`
config, so the number moves with the serving path users call; it ends on a
device-to-host copy of a few pixels.

The same environment variables as `bench.py`:
  BENCH_BATCH (32), BENCH_REPS (3): batch and timed repetitions (best of);
  BENCH_ACCEL=<tau>, BENCH_CFG_INTERVAL=lo,hi, BENCH_GELU=tanh: opt-in speed
  modes (the headline protocol keeps all three off);
  BENCH_STEPS (50): off-protocol NFE counts;
  BENCH_RECOMMENDED (on): also time the recommended accelerated mode (tanh
  GELU on the same weights and forecast-skip tau = 0.2, `RECOMMENDED_KNOBS`).

Prints one JSON line with `bench.py`'s keys.  vs_baseline divides images/s
by A100_BASELINE_EST, the root `bench.py`'s compute-model estimate of the
reference PyTorch pipeline on an A100 (about 17.4 TFLOPs an image at 20-30 %
of 312 TFLOP/s peak, bracketed at [3.2, 7.2] images/s in BASELINE.md): an
estimate for an A100, not a measurement, and not a TPU number.
`recommended_gate_verdict` and `recommended_certification` read
quality_gate/trained_L/report.json, the quality gate the JAX package ran on
its own trained weights: a verdict carried over from that package, not a
gate run on this port.
"""
from __future__ import annotations

import copy
import json
import os
import time
from pathlib import Path

import numpy as np
import torch

from ..configs import get_config
from ..models import get_nnet
from ..models.layers import with_gelu
from ..models.vae import AutoencoderKL
from ..models.vae import get_model as get_vae
from ..serving import GenerationPipeline

A100_BASELINE_EST = 4.0  # images/s, see the module docstring

# The recommended accelerated operating point for the image flagship and the
# quality-gate spec key that certifies it, as in `bench.py`.
RECOMMENDED_MODE_NAME = "gelu_approx+accel0.2"
RECOMMENDED_MODE_SPEC = "gelu_accel=0.2"
# cfg_interval=() is explicitly off (None defers to BENCH_CFG_INTERVAL)
RECOMMENDED_KNOBS = dict(accel=0.2, cfg_interval=(), gelu=True)

REPORT = Path(__file__).resolve().parents[2] / "quality_gate" / "trained_L" / "report.json"

_DTYPE_NAMES = {torch.bfloat16: "bfloat16", torch.float32: "float32"}


def build_components(device="cuda", depth: int = 20, embed_dim: int = 1024,
                     num_heads: int = 16, img_size: int = 32, vae_geometry=None,
                     dtype: torch.dtype = torch.bfloat16):
    """The protocol's pieces: (config, model, vae).  The config is
    `imagenet256_uvit_large` computing in `dtype`; the model is its U-ViT-L/2
    from seed 0 (tanh GELU with BENCH_GELU=tanh), with the packed-qkv
    attention kernel on the card; the VAE is the SD f8 KL-VAE (or
    `AutoencoderKL(**vae_geometry)`) from seed 1, computing in bf16 over f32
    parameters.  The other arguments cut it to a tiny size for the CPU."""
    config = get_config("imagenet256_uvit_large")
    config.compute_dtype = _DTYPE_NAMES[dtype]
    config.z_shape = (img_size, img_size, 4)
    config.nnet.update(depth=depth, embed_dim=embed_dim, num_heads=num_heads,
                       img_size=img_size, gelu_approx=os.environ.get("BENCH_GELU", "") == "tanh")
    kwargs = dict(config.nnet)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = get_nnet(kwargs.pop("name"), **kwargs)
        torch.manual_seed(1)
        vae = (get_vae(dtype=torch.bfloat16) if vae_geometry is None
               else AutoencoderKL(**vae_geometry, dtype=torch.bfloat16))
    return config, model.to(device, dtype).eval(), vae.to(device).eval()


def build_pipeline(components=None, accel=None, cfg_interval=None,
                   gelu=None) -> GenerationPipeline:
    """The protocol's serving pipeline; the speed modes come from the
    arguments, else from BENCH_ACCEL / BENCH_CFG_INTERVAL (BENCH_GELU acts in
    `build_components`).  A GELU other than the model's runs on a copy that
    shares its weights."""
    config, model, vae = components or build_components()
    if cfg_interval is None:
        ci_env = os.environ.get("BENCH_CFG_INTERVAL", "")
        cfg_interval = tuple(float(v) for v in ci_env.split(",")) if ci_env else None
    if accel is None:
        accel = float(os.environ.get("BENCH_ACCEL", "0"))
    config = copy.deepcopy(config)
    config.sample.update(accel=accel, cfg_interval=tuple(cfg_interval or ()),
                         sample_steps=int(os.environ.get("BENCH_STEPS", "50")))
    if gelu is not None and gelu != config.nnet.gelu_approx:
        model = with_gelu(model, gelu)
        config.nnet.gelu_approx = gelu
    return GenerationPipeline(config, model, vae, device=next(model.parameters()).device)


def gate_certification(report_path, mode_spec):
    """(verdict, certifiable) for a recommended mode against a quality-gate
    report, `bench.py`'s four cases:
      - report absent or unreadable -> ("UNMEASURED", False);
      - report present, mode never gated -> ("UNMEASURED", True);
      - report present, no channel armed -> ("UNARMED", False);
      - otherwise the mode's verdict, certifiable."""
    try:
        with open(report_path) as f:
            rep = json.load(f)
    except (OSError, ValueError):
        return "UNMEASURED", False
    entry = rep.get("modes", {}).get(mode_spec)
    if entry is None:
        return "UNMEASURED", True
    if not rep.get("report_armed", False):
        return "UNARMED", False
    return entry["verdict"], True


def _time_pipeline(pipe: GenerationPipeline, batch_size: int, reps: int) -> float:
    """Images/s of the best of `reps` timed requests after one warm-up; each
    draws its noise on the device and ends on a device-to-host copy."""
    y = torch.zeros((batch_size,), dtype=torch.int64, device=pipe.device)
    h, w, c = pipe.config.z_shape

    def run(i):
        g = torch.Generator(device=pipe.device).manual_seed(
            int(np.random.SeedSequence([42, i + 1]).generate_state(1)[0]))
        z = torch.randn((batch_size, c, h, w), generator=g, device=pipe.device)
        img = pipe.sample(z, None, y)[0]
        return float(img[:, :, ::64, ::64].float().sum())

    run(-1)
    times = []
    for i in range(reps):
        t0 = time.perf_counter()
        run(i)
        times.append(time.perf_counter() - t0)
    return batch_size / min(times)


def main(components=None) -> dict:
    """Time the exact protocol (and the recommended mode) on the card, or on
    given components; print and return the JSON record."""
    batch_size = int(os.environ.get("BENCH_BATCH", "32"))
    reps = int(os.environ.get("BENCH_REPS", "3"))
    components = components or build_components()
    imgs_per_sec = _time_pipeline(build_pipeline(components), batch_size, reps)
    record = {
        "metric": "imagenet256_uvitL_50step_dpmpp_cfg_images_per_sec_per_chip",
        "value": round(imgs_per_sec, 3),
        "unit": "images/sec",
        "vs_baseline": round(imgs_per_sec / A100_BASELINE_EST, 3),
    }
    if os.environ.get("BENCH_RECOMMENDED", "on") != "off":
        rec = _time_pipeline(build_pipeline(components, **RECOMMENDED_KNOBS), batch_size, reps)
        record.update(
            recommended_mode=RECOMMENDED_MODE_NAME,
            recommended_value=round(rec, 3),
            recommended_vs_baseline=round(rec / A100_BASELINE_EST, 3),
        )
        verdict, certified = gate_certification(REPORT, RECOMMENDED_MODE_SPEC)
        record["recommended_gate_verdict"] = verdict
        if certified:
            record["recommended_certification"] = "quality_gate/trained_L/report.json"
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()
