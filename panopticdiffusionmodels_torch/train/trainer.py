"""The training engine of the port: tasks `t2i_discrete`, `latent_discrete`,
`pixel_sde` and `latent_sde`.

Port of `panopticdiffusionmodels_tpu/train/trainer.py::Trainer` for the
panoptic text-to-image task (reference `train_t2i_discrete.py`), the
class-conditional latent task of U-ViT on ImageNet features (reference
`train_ldm_discrete.py`) and the continuous-time VP-SDE tasks of U-ViT on
images (`pixel_sde`, unconditional or class-conditional, reference
`train.py`) or on latent moments (`latent_sde`, reference `train_ldm.py`):

  * the model is built with `attn_impl='auto'` (the attention kernels'
    forward and backward on the card) and the config's `use_checkpoint` /
    `remat_policy`; its f32 parameters are the master weights, and
    `compute_dtype='bfloat16'` runs the forward and backward under
    `torch.autocast` (GEMMs in bf16; LayerNorm, softmax and the loss in f32);
  * one `train_step(batch)` = the loss of `_loss` (the VAE reparameterised
    draw from the moments, then `l_simple_panoptic`, or `l_simple` with the
    labels for `latent_discrete`; for the SDE tasks the continuous
    `diffusion/sde.py::l_simple` of the `VPSDE`, on the images or on the
    draw from the moments), its gradients
    (optionally over `grad_accum` micro-batches), the global gradient norm,
    AdamW and the EMA (`train/state.py`);
  * `fit` keeps a bounded queue of in-flight steps and reads a step's loss
    only once `max_inflight_steps` newer steps are queued, so the host does
    not wait on the card every step; it logs to `workdir/metrics.jsonl` and
    checkpoints to `workdir/ckpts/{step}.ckpt`;
  * `mesh.sp > 1` (the other axes at 1) trains sequence-parallel, as the
    JAX trainer does: the model's attention becomes the ring
    (`attn_impl='ring'`) over the context `parallel.mesh.from_mesh` builds.
    Every sp rank reads the same batch and draws the same noise; under
    `sp_mode='process_group'` each of the sp processes computes the whole
    loss after the model's gather, so the loss is scaled by 1/sp before the
    backward (whose gather transposes to a reduce-scatter) and every
    gradient, frozen ones too, is summed over the ranks before the norm and
    AdamW: the step equals the unsharded one.  Only rank 0 writes
    checkpoints and metrics.

Batches are channel-last numpy arrays as the JAX package's (moments
(B, h, w, 2C), context (B, 77, D), panoptic ids (B, H, W, 1); or moments and
labels (B,); or images (B, H, W, 3) in [-1, 1] with or without labels); the
trainer transposes to the network's NCHW at the model boundary only.  Every
random draw of a step (the VAE noise `z`, the timesteps `n`, `eps`, `eps_m`;
the last only for the panoptic task; the continuous times `t` and `eps` for
the SDE tasks) can be
passed in through `noise`, so a test can hand the JAX trainer's draws to
both sides; otherwise they come from the trainer's `torch.Generator`,
reseeded before every step from (`config.seed`, step) as the JAX trainer
folds the step into its key, so a resumed run draws what the uninterrupted
run would have.
"""
from __future__ import annotations

import json
import logging
import os
import time
from collections import deque
from typing import Dict, Optional

import numpy as np
import torch

from ..data import Loader, get_dataset, prefetch_to_device
from ..diffusion.schedule import (
    Schedule,
    l_simple,
    l_simple_panoptic,
    stable_diffusion_beta_schedule,
)
from ..diffusion.sde import VPSDE, ScoreModel
from ..diffusion.sde import l_simple as l_simple_continuous
from ..models import get_nnet
from ..models.vae import sample_from_moments
from ..parallel.mesh import from_mesh
from ..utils.weights import load_torch_state_dict, reference_nnet_state_dict
from . import checkpoint as ckpt_lib
from .state import TrainState, make_lr_schedule, panoptic_image_stream_frozen

log = logging.getLogger(__name__)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def step_seed(seed: int, step: int) -> int:
    """The generator seed of the step that takes the state from `step - 1` to
    `step`; reproducible in (seed, step)."""
    return int(np.random.SeedSequence([seed, step]).generate_state(1)[0])


def _check_supported(config) -> None:
    task = config.get("task", "")
    if task == "t2i_discrete":
        if config.nnet.name != "uvit_t2i":
            raise NotImplementedError(f"training nnet {config.nnet.name!r} comes with a later "
                                      "slice")
        if not config.nnet.get("enable_panoptic", True):
            raise NotImplementedError("image-only t2i training (l_simple) comes with a later "
                                      "slice")
    elif task in ("latent_discrete", "pixel_sde", "latent_sde"):
        mode = config.train.get("mode", "uncond" if task == "pixel_sde" else "cond")
        if config.nnet.name != "uvit":
            raise NotImplementedError(
                f"{task} training of nnet {config.nnet.name!r}: the port trains the uvit; "
                "the others come with a later slice")
        if task == "latent_discrete" and mode != "cond":
            raise NotImplementedError("latent_discrete with train.mode != 'cond' comes with "
                                      "a later slice")
        if mode not in ("cond", "uncond"):
            raise ValueError(f"train.mode must be 'cond' or 'uncond', got {mode!r}")
        if (mode == "cond") != (config.nnet.get("num_classes", -1) > 0):
            raise ValueError(f"{task} with train.mode={mode!r} needs a "
                             f"{'class-conditional' if mode == 'cond' else 'unconditional'} "
                             f"uvit, got num_classes={config.nnet.get('num_classes')}")
        if config.get("mesh", {}).get("sp", 1) != 1:
            raise NotImplementedError("sequence-parallel uvit training comes with the "
                                      "distributed slice")
    else:
        raise NotImplementedError(
            f"task {task!r} is not ported: the port trains t2i_discrete, latent_discrete, "
            "pixel_sde and latent_sde")
    mesh = config.get("mesh", {})
    dp = mesh.get("dp", -1)
    if dp not in (-1, 1) or any(mesh.get(k, 1) != 1 for k in ("fsdp", "tp")):
        raise NotImplementedError(
            f"mesh {dict(mesh)}: data / tensor parallel training comes with the "
            "distributed slice; this one trains on one device or sequence-parallel (sp)")
    if mesh.get("pp", 1) != 1:
        raise NotImplementedError("mesh.pp > 1 (the boomerang pipeline) comes with the "
                                  "distributed slice")
    if config.optimizer.name != "adamw":
        raise NotImplementedError(f"optimizer {config.optimizer.name!r}: the configs of this "
                                  "slice train with adamw")


class Trainer:
    def __init__(self, config, workdir: Optional[str] = None, device="cuda"):
        _check_supported(config)
        self.config = config
        self.task = config.task
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Trainer(device='cuda'): no CUDA device; pass device='cpu'")
        self.sp = from_mesh(config.get("mesh", {}))
        self.is_main = self.sp is None or self.sp.rank == 0
        self.workdir = workdir or config.get("workdir", "") or "results/run"
        self.ckpt_root = os.path.join(self.workdir, "ckpts")
        if self.is_main:
            os.makedirs(self.ckpt_root, exist_ok=True)

        ds_kwargs = dict(config.dataset)
        self.dataset = get_dataset(ds_kwargs.pop("name"), **ds_kwargs)

        nnet_kwargs = dict(config.nnet)
        nnet_kwargs.pop("name")
        nnet_kwargs["attn_impl"] = "auto"
        if self.sp is not None:
            nnet_kwargs.update(attn_impl="ring", sp=self.sp)
            if self.sp.mode == "in_process":
                log.info("mesh.sp=%d in_process: every sp shard runs in this process on %s, "
                         "folded into the batch (the ring's rotation is a torch.roll)",
                         self.sp.sp, self.device)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(config.seed)
            self.nnet = get_nnet(config.nnet.name, **nnet_kwargs)

        frozen = set()
        pretrained = config.get("pretrained", "")
        if pretrained:
            if not os.path.exists(pretrained):
                # Proceeding would freeze a randomly initialised image stream
                # and train the mask stream against it without an error.
                raise FileNotFoundError(f"config.pretrained={pretrained!r} does not exist")
            self.nnet.load_state_dict(
                reference_nnet_state_dict(load_torch_state_dict(pretrained)), strict=True)
            if self.task == "t2i_discrete":  # a class-conditional fine-tune freezes nothing
                frozen = panoptic_image_stream_frozen(
                    n for n, _ in self.nnet.named_parameters())
        self.nnet.to(self.device)

        lr_sched = make_lr_schedule(
            config.optimizer.lr, config.lr_scheduler.name,
            warmup_steps=config.lr_scheduler.get("warmup_steps", -1),
            total_steps=config.train.n_steps)
        self.state = TrainState(
            self.nnet, lr_sched, betas=config.optimizer.betas,
            weight_decay=config.optimizer.get("weight_decay", 0.0), frozen=frozen)
        if self.task in ("pixel_sde", "latent_sde"):
            self.sde = VPSDE()
        else:
            self.schedule = Schedule(stable_diffusion_beta_schedule())
        self.generator = torch.Generator(device=self.device)
        self.compute_dtype = _DTYPES[config.get("compute_dtype", "bfloat16")]

    # --- loss and step ------------------------------------------------------

    def _nnet_fn(self, context):
        """(xn, t, mask_token=, use_ground_truth=) on channel-last tensors ->
        (eps_pred, mask_pred) channel-last, through the NCHW network."""

        def fn(xn, t, mask_token=None, use_ground_truth=False):
            with torch.autocast(self.device.type, dtype=self.compute_dtype,
                                enabled=self.compute_dtype != torch.float32):
                eps, mask = self.nnet(xn.permute(0, 3, 1, 2), t, context,
                                      mask_token=mask_token.permute(0, 3, 1, 2),
                                      use_ground_truth=use_ground_truth)
            return eps.permute(0, 2, 3, 1), mask.permute(0, 2, 3, 1)

        return fn

    def _label_nnet_fn(self, y=None):
        """(xn, t) on channel-last tensors -> the prediction channel-last,
        through the NCHW uvit with labels y (None: unconditional)."""

        def fn(xn, t):
            with torch.autocast(self.device.type, dtype=self.compute_dtype,
                                enabled=self.compute_dtype != torch.float32):
                eps = self.nnet(xn.permute(0, 3, 1, 2), t, y)
            return eps.permute(0, 2, 3, 1)

        return fn

    def _loss(self, batch, noise: Optional[Dict[str, torch.Tensor]] = None):
        """(scalar loss, metrics) of one (micro-)batch: JAX `Trainer._loss`,
        t2i_discrete and latent_discrete branches (the SDE tasks in
        `_sde_loss`)."""
        noise = noise or {}
        if self.task in ("pixel_sde", "latent_sde"):
            return self._sde_loss(batch, noise)
        moments = batch[0].float()
        z = sample_from_moments(moments, self.config.autoencoder.scale_factor,
                                noise=noise.get("z"), generator=self.generator)
        if self.task == "latent_discrete":
            loss = l_simple(z, self._label_nnet_fn(batch[1]), self.schedule,
                            n=noise.get("n"), eps=noise.get("eps"), generator=self.generator)
            return loss.mean(), {"loss": loss.mean().detach()}
        context = batch[1]
        use_gt = bool(self.config.nnet.get("use_ground_truth", False))
        loss_eps, loss_mask = l_simple_panoptic(
            z, self._nnet_fn(context), self.schedule, batch[2],
            mask_bits=self.config.nnet.mask_bits, use_ground_truth=use_gt,
            use_twophases=bool(self.config.get("use_twophases", False)),
            n=noise.get("n"), eps=noise.get("eps"), eps_m=noise.get("eps_m"),
            generator=self.generator)
        metrics = {"loss": loss_eps.mean().detach(), "loss_mask": loss_mask.mean().detach()}
        if use_gt:
            return loss_eps.mean(), metrics
        return loss_eps.mean() + loss_mask.mean(), metrics

    def _sde_loss(self, batch, noise):
        """JAX `Trainer._loss`, pixel_sde and latent_sde branches: the
        continuous loss of the VPSDE on the images, or on the draw from the
        moments, with the labels when `train.mode` is 'cond'."""
        default = "uncond" if self.task == "pixel_sde" else "cond"
        y = batch[1] if self.config.train.get("mode", default) == "cond" else None
        x = batch[0].float()
        if self.task == "latent_sde":
            x = sample_from_moments(x, self.config.autoencoder.scale_factor,
                                    noise=noise.get("z"), generator=self.generator)
        sm = ScoreModel(self._label_nnet_fn(y), self.config.pred, self.sde)
        loss = l_simple_continuous(sm, x, pred=self.config.pred, t=noise.get("t"),
                                   eps=noise.get("eps"), generator=self.generator)
        return loss.mean(), {"loss": loss.mean().detach()}

    def _as_device(self, batch, noise):
        if not isinstance(batch, (tuple, list)):  # an unlabeled dataset's images
            batch = (batch,)
        batch = tuple(torch.as_tensor(x).to(self.device) for x in batch)
        if noise is not None:
            noise = {k: torch.as_tensor(v).to(self.device) for k, v in noise.items()
                     if v is not None}
        return batch, noise

    def loss_and_grads(self, batch, noise: Optional[Dict[str, torch.Tensor]] = None):
        """Forward and backward of one step; leaves the gradient in each
        parameter's .grad and returns the metrics (device tensors) with the
        global gradient norm over every parameter, frozen ones too."""
        batch, noise = self._as_device(batch, noise)
        self.generator.manual_seed(step_seed(self.config.seed, self.state.step + 1))
        for p in self.state.params.values():
            p.grad = None
        accum = int(self.config.train.get("grad_accum", 1))
        # Each of `world` processes computes the whole loss (sp of them under
        # sp_mode='process_group', else one); their gradients are summed below.
        world = 1 if self.sp is None else self.sp.world_size
        if accum <= 1:
            loss, metrics = self._loss(batch, noise)
            (loss / world).backward()
        else:
            # Micro-batches of B/accum, each with its slice of the draws; the
            # gradient is the mean of theirs, the metrics the mean of theirs.
            micro = [tuple(x.chunk(accum)) for x in batch]
            parts = []
            for i in range(accum):
                mn = None if noise is None else {k: v.chunk(accum)[i] for k, v in noise.items()}
                loss, m = self._loss(tuple(x[i] for x in micro), mn)
                (loss / (accum * world)).backward()
                parts.append(m)
            metrics = {k: torch.stack([m[k] for m in parts]).mean() for k in parts[0]}
        if self.sp is not None:
            self.sp.all_reduce_grads(self.state.params.values())
        grads = [p.grad for p in self.state.params.values() if p.grad is not None]
        metrics["grad_norm"] = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads)))
        return metrics

    def train_step(self, batch, noise: Optional[Dict[str, torch.Tensor]] = None):
        """One optimizer step on `batch`; returns metrics as device tensors."""
        metrics = self.loss_and_grads(batch, noise)
        self.state.apply_gradients(ema_rate=self.config.get("ema_rate", 0.9999))
        return metrics

    # --- data and loop ------------------------------------------------------

    def data_stream(self, start_step: int = 0):
        """Batches on the trainer's device from step `start_step` on: the
        loader's index-only skip, then the device feed (uint8 panoptic ids by
        default, labels as they are, optional bf16 float fields,
        `train.transfer_dtype`)."""
        cfgt = self.config.train
        cast_f32 = torch.bfloat16 if cfgt.get("transfer_dtype", "") == "bfloat16" else None
        cast_int = (np.uint8 if self.config.nnet.get("enable_panoptic", False)
                    and self.config.nnet.get("mask_bits", 8) <= 8
                    and cfgt.get("transfer_mask_uint8", True) else None)
        loader = Loader(self.dataset.get_split("train", labeled=True),
                        batch_size=cfgt.batch_size,
                        num_workers=self.config.get("num_workers", 8), seed=self.config.seed)
        if start_step:
            loader.skip(start_step)
        return prefetch_to_device(iter(loader), self.device, cast_f32=cast_f32,
                                  cast_int=cast_int)

    def resume(self) -> bool:
        return ckpt_lib.resume(self.ckpt_root, self.state)

    def fit(self, max_steps: Optional[int] = None):
        """Train to `config.train.n_steps` (or `max_steps`) from the latest
        checkpoint; returns the logged metrics.  Evaluation and sample-grid
        callbacks come with the evaluation slice."""
        config = self.config
        self.resume()
        stream = self.data_stream(start_step=self.state.step)
        n_steps = max_steps or config.train.n_steps
        log_interval = config.train.get("log_interval", 10)
        save_interval = config.train.get("save_interval", 50000)
        max_inflight = int(config.train.get("max_inflight_steps", 8))
        inflight: deque = deque()
        history = []
        t0 = time.time()
        while self.state.step < n_steps:
            metrics = self.train_step(next(stream))
            step = self.state.step
            inflight.append(metrics["loss"])
            if len(inflight) > max_inflight:
                float(inflight.popleft())  # wait for step (step - max_inflight)
            if step % log_interval == 0 and self.is_main:
                m = {k: float(v) for k, v in metrics.items()}
                m["step"] = step
                m["steps_per_sec"] = log_interval / max(time.time() - t0, 1e-9)
                m["images_per_sec"] = m["steps_per_sec"] * config.train.batch_size
                t0 = time.time()
                history.append(m)
                log.info(json.dumps(m))
                with open(os.path.join(self.workdir, "metrics.jsonl"), "a") as f:
                    f.write(json.dumps(m) + "\n")
            if save_interval and step % save_interval == 0 and self.is_main:
                ckpt_lib.save_checkpoint(self.ckpt_root, self.state)
        return history
