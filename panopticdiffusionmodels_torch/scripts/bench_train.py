"""Training throughput on the card through the `Trainer` users run, on
synthetic (host-random) data.

    python -m panopticdiffusionmodels_torch.scripts.bench_train [policy ...]

Port of `scripts/bench_train.py`, with its protocols (BENCH_TASK):
  panoptic (default) — the dual-stream U-ViT-S/2, 32x32x4 latent moments,
      77x768 CLIP context, 64x64 panoptic map (`train_t2i_discrete.py`);
  latentL — class-conditional ImageNet-256 U-ViT-L/2 latent training
      (`configs/imagenet256_uvit_large.py`), the model `bench.py` serves;
  panoptic512 — the dual-stream S/2 at 512 res (64x64x4 latents, 128x128
      map, L = 2126 tokens a stream, sp = 1), default batch 48.
Each remat policy of argv (default '' and dots_no_batch) trains one step
untimed, then BENCH_REPS (8) steps timed one by one, each ending on the
loss's device-to-host copy; it prints the best ms a step and images/s.
Env as the JAX script: BENCH_BATCH (64, or 48 for panoptic512),
BENCH_TRANSFER=bfloat16 (`train.transfer_dtype`), BENCH_GELU=tanh,
BENCH_REMAT=off (no activation checkpointing), BENCH_ATTN=<impl>
(`nnet.attn_impl`: auto, pallas_vjp, pallas_recompute, xla), BENCH_FIT=1
(then 41 more steps of `Trainer.fit`, logged every 10: the best window).
The attention runs kernels 1 and 2 (`attn_impl='auto'`); the JSON line
counts their launches over the timed steps.  `--device=cpu` runs on the CPU.
"""
from __future__ import annotations

import os
import sys
import tempfile
import time
from typing import Callable, Optional

from ..configs.base import (
    adamw,
    autoencoder_block,
    base_config,
    d,
    sample_block,
    train_block,
    uvit,
    uvit_t2i,
    warmup,
)
from ..train.trainer import Trainer
from .measure import finish, read_counts, require_device, split_device, sync, zero_counts

TASKS = ("panoptic", "latentL", "panoptic512")
DEFAULT_POLICIES = ["", "dots_no_batch"]
ENV = ("BENCH_TASK", "BENCH_BATCH", "BENCH_TRANSFER", "BENCH_GELU", "BENCH_REMAT",
       "BENCH_ATTN", "BENCH_FIT", "BENCH_REPS")


def default_batch(task: str) -> int:
    return 48 if task == "panoptic512" else 64


def build_config(policy: str, batch: int, task: Optional[str] = None):
    """The protocol's config, as the JAX script's `build_config`."""
    task = task or os.environ.get("BENCH_TASK", "panoptic")
    if task not in TASKS:
        raise SystemExit(f"BENCH_TASK={task!r}: one of {TASKS}")
    config = base_config()
    config.compute_dtype = "bfloat16"
    config.autoencoder = autoencoder_block(scale_factor=0.23010)
    if task == "latentL":
        config.task = "latent_discrete"
        config.z_shape = (32, 32, 4)
        config.train = train_block(10, batch, mode="cond", log_interval=100,
                                   eval_interval=10**9, save_interval=10**9)
        config.optimizer = adamw(2e-4, 0.03, (0.99, 0.99))
        config.lr_scheduler = warmup(10)
        config.nnet = uvit(img_size=32, patch_size=2, in_chans=4, embed_dim=1024, depth=20,
                           num_heads=16, num_classes=1001, use_checkpoint=True,
                           scan_blocks=True, conv=False, remat_policy=policy)
        config.dataset = d(name="synthetic", style="imagenet", n=4 * batch,
                           z_shape=(32, 32, 8), num_classes=1001)
        config.sample = sample_block(50, 16, 16, algorithm="dpm_solver", cfg=True, scale=0.4)
        return config
    img, mask = (64, 128) if task == "panoptic512" else (32, 64)
    config.task = "t2i_discrete"
    config.z_shape = (img, img, 4)
    config.train = train_block(10, batch, log_interval=100, eval_interval=10**9,
                               save_interval=10**9)
    config.optimizer = adamw(2e-4, 0.03, (0.9, 0.9))
    config.lr_scheduler = warmup(10)
    config.nnet = uvit_t2i(img_size=img, patch_size=2, embed_dim=512, depth=12, num_heads=8,
                           clip_dim=768, num_clip_token=77, enable_panoptic=True,
                           separate=True, mask_size=mask, use_checkpoint=True,
                           scan_blocks=True, remat_policy=policy)
    config.dataset = d(name="synthetic", n=4 * batch, z_shape=(img, img, 8),
                       clip_shape=(77, 768), mask_size=mask)
    config.sample = sample_block(50, 16, 16, algorithm="dpm_solver", cfg=True, scale=1.0)
    return config


def apply_env_overrides(config):
    """BENCH_TRANSFER, BENCH_GELU, BENCH_REMAT and BENCH_ATTN, as the JAX
    script's `apply_env_overrides`."""
    td = os.environ.get("BENCH_TRANSFER", "")
    if td:
        config.train.transfer_dtype = td
    if os.environ.get("BENCH_GELU", "") == "tanh":
        config.nnet.gelu_approx = True
    if os.environ.get("BENCH_REMAT", "") == "off":
        config.nnet.use_checkpoint = False
    ai = os.environ.get("BENCH_ATTN", "")
    if ai:
        config.nnet.attn_impl = ai
    return config


def run(policy: str, batch: int, steps: int = 8, device="cuda",
        shrink: Optional[Callable] = None) -> dict:
    """One policy: a warm-up step, then `steps` timed steps on one batch;
    with BENCH_FIT the real loop after them.  `shrink(config)` cuts the
    config to a tiny size for the CPU."""
    config = apply_env_overrides(build_config(policy, batch))
    if shrink is not None:
        shrink(config)
    with tempfile.TemporaryDirectory() as wd:
        trainer = Trainer(config, wd, device=device)
        batch_data = next(trainer.data_stream())
        float(trainer.train_step(batch_data)["loss"])  # warm-up
        sync(device)
        zero_counts()
        times, loss = [], None
        for _ in range(steps):
            t0 = time.perf_counter()
            loss = float(trainer.train_step(batch_data)["loss"])  # device -> host
            times.append(time.perf_counter() - t0)
        launches = read_counts()
        best = min(times)
        print(f"policy={policy or '(default)':14s} batch={batch}  "
              f"{best * 1e3:7.1f} ms/step  {batch / best:7.1f} img/s  loss={loss:.4f}",
              flush=True)
        result = dict(policy=policy, batch=batch, steps=steps, best_ms=best * 1e3,
                      step_ms=[t * 1e3 for t in times], images_per_s=batch / best, loss=loss,
                      launches=launches)
        if os.environ.get("BENCH_FIT", ""):
            trainer.config.train.log_interval = 10
            hist = trainer.fit(max_steps=trainer.state.step + 41)
            rates = [m["images_per_sec"] for m in hist[1:]]  # the first window holds the warm-up
            print(f"fit loop: best window {max(rates):7.1f} img/s "
                  f"(windows: {[round(r, 1) for r in rates]})")
            result.update(fit_best_images_per_s=max(rates), fit_windows=rates)
    return result


def main(argv=None, device="cuda", shrink: Optional[Callable] = None) -> dict:
    argv = sys.argv[1:] if argv is None else list(argv)
    device, policies = split_device(argv, device)
    device = require_device(device, "bench_train")
    task = os.environ.get("BENCH_TASK", "panoptic")
    batch = int(os.environ.get("BENCH_BATCH", str(default_batch(task))))
    steps = int(os.environ.get("BENCH_REPS", "8"))
    runs = [run(p, batch, steps, device, shrink) for p in (policies or DEFAULT_POLICIES)]
    return finish("bench_train", dict(task=task, batch=batch, runs=runs), device)


if __name__ == "__main__":
    main()
