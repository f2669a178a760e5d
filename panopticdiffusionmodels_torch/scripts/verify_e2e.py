"""End-to-end smoke on the card: train, sample, checkpoint and resume,
through the `Trainer` users run, on synthetic data with the tiny panoptic
dual-stream config.

    python -m panopticdiffusionmodels_torch.scripts.verify_e2e

Port of `scripts/verify_e2e_tpu.py`.  `synthetic_tiny` (16 samples, batch
16, 150 steps, a log line every 25, a checkpoint at 150, lr 1e-3 after 5
warm-up steps) must:
  1. train with a falling loss (loss + loss_mask, the mean of the first two
     logged windows against the last two: it overfits the tiny set);
  2. sample 4 images and masks in one 6-step request
     (`Trainer.build_sample_fn`), all finite;
  3. write a checkpoint at step 150 that resumes into a fresh `Trainer`
     (`train/checkpoint.py::resume`) with the same step and parameters.
On the card the kernels take bf16 with a head dim that is a multiple of 8:
the config computes in bf16 autocast with one head of 64 (as
`chip_smoke.py`'s tiny config), and the JSON line counts the kernel
launches of the training.  `--device=cpu` runs `synthetic_tiny` itself, in
f32.
"""
from __future__ import annotations

import sys
import tempfile

import numpy as np
import torch

from ..configs import get_config
from ..train import checkpoint as ckpt_lib
from ..train.trainer import Trainer
from .measure import finish, read_counts, require_device, split_device, zero_counts

STEPS = 150


def build_config(device, steps: int = STEPS):
    config = get_config("synthetic_tiny")
    config.dataset.n = 16
    config.train.batch_size = 16
    config.train.n_steps = steps
    config.train.log_interval = 25
    config.train.save_interval = steps
    config.train.eval_interval = 0
    config.optimizer.lr = 1e-3
    config.lr_scheduler.warmup_steps = 5
    config.num_workers = 0
    if device.type == "cuda":
        config.compute_dtype = "bfloat16"
        config.nnet.update(embed_dim=64, num_heads=1)
    return config


def main(argv=None, device="cuda", steps: int = STEPS) -> dict:
    """`steps` (a multiple of 25, at least 100) cuts the run for the CPU."""
    argv = sys.argv[1:] if argv is None else list(argv)
    device, _ = split_device(argv, device)
    device = require_device(device, "verify_e2e")
    config = build_config(device, steps)
    with tempfile.TemporaryDirectory() as wd:
        trainer = Trainer(config, wd, device=device)
        zero_counts()
        metrics = trainer.fit()
        launches = read_counts()
        first = float(np.mean([m["loss"] + m["loss_mask"] for m in metrics[:2]]))
        last = float(np.mean([m["loss"] + m["loss_mask"] for m in metrics[-2:]]))
        print(f"loss+loss_mask: {first:.4f} -> {last:.4f} over {len(metrics)} windows")
        assert last < first, f"loss did not decrease on {device}: {first} -> {last}"

        sample_fn = trainer.build_sample_fn(sample_steps=6)
        h, w, c = config.z_shape
        m = config.nnet.mask_size
        g = torch.Generator(device=trainer.device).manual_seed(0)
        z = torch.randn((4, h, w, c), generator=g, device=trainer.device)
        m0 = torch.randn((4, m, m, config.nnet.mask_bits), generator=g, device=trainer.device)
        ctx = torch.zeros((4, *config.dataset.clip_shape), device=trainer.device)
        out = sample_fn(ctx, z, m0)
        imgs, pred_mask = out if isinstance(out, tuple) else (out, None)
        assert torch.isfinite(imgs).all()
        assert pred_mask is None or torch.isfinite(pred_mask).all()
        print(f"sampling OK: {tuple(imgs.shape)}")

        trainer2 = Trainer(config, wd, device=device)
        assert ckpt_lib.resume(trainer2.ckpt_root, trainer2.state), "checkpoint did not resume"
        assert trainer2.state.step == steps, trainer2.state.step
        for name, p in trainer.state.params.items():
            assert torch.equal(p.detach().cpu(), trainer2.state.params[name].detach().cpu()), name
        print(f"checkpoint resume OK (step {steps}, parameters equal)")
    print("E2E SMOKE OK")
    return finish("verify_e2e", dict(
        steps=steps, windows=len(metrics), loss_first=first, loss_last=last,
        sample_shape=list(imgs.shape), mask_shape=None if pred_mask is None else
        list(pred_mask.shape), resumed_step=steps, launches=launches, ok=True), device)


if __name__ == "__main__":
    main()
