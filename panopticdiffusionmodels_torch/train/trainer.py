"""The training engine of the port: tasks `t2i_discrete`, `latent_discrete`,
`pixel_sde` and `latent_sde`.

Port of `panopticdiffusionmodels_tpu/train/trainer.py::Trainer` for the
panoptic text-to-image task (reference `train_t2i_discrete.py`, with the
U-ViT or, `nnet.name='unet_t2i'`, the SD-1.x UNet of `models/unet.py`,
whose `config.pretrained` is an LDM checkpoint read by `utils/ldm_bridge.py`
and whose attention is the plain one), the
class-conditional latent task of U-ViT on ImageNet features (reference
`train_ldm_discrete.py`) and the continuous-time VP-SDE tasks of U-ViT on
images (`pixel_sde`, unconditional or class-conditional, reference
`train.py`) or on latent moments (`latent_sde`, reference `train_ldm.py`):

  * the model is built with `attn_impl='auto'` (the attention kernels'
    forward and backward on the card) unless the config sets
    `nnet.attn_impl` (e.g. 'pallas_recompute': the forward kernel and a
    plain f32 recompute backward), and the config's `use_checkpoint` /
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
    checkpoints to `workdir/ckpts/{step}.ckpt`, or hands the checkpoint to
    the eval callback (`evaluation/runner.py`, FID-gated), and writes
    sample grids through the vis callback;
  * `build_sample_fn` samples with the EMA weights through
    `serving.GenerationPipeline.sample` (kernel 1, no gradient), decoding
    with the config's VAE when its file exists;
  * the layout is `parallel.mesh.from_mesh`'s for the world it finds, JAX's
    (pp, dp, fsdp, sp, tp) mesh laid over the processes.  Every process
    takes its (dp, fsdp) shard's rows of the GLOBAL batch `train.batch_size`
    and keeps its rows of the global batch's draws (its pp, sp and tp peers
    take the rows the first of them reads, and draw the same), and the
    metrics are averaged over the data shards, so a step computes what one
    process computes on the global batch.  The default mesh (dp = -1) over
    several processes (`torchrun`) trains data parallel through
    `DistributedDataParallel` (every micro-batch but the last under
    `no_sync()`);
  * `mesh.fsdp > 1` shards the network over fsdp (and replicates it over
    dp: HSDP) before the train state is built, so the optimizer moments and
    the EMA are sharded with it (`parallel/sharding.py`, FSDP2; its gradient
    collective is held off between micro-batches);
  * `mesh.tp > 1` cuts every block's qkv / MLP (and the UNet's attention
    and GEGLU) per head over tp (`parallel/tensor.py`); `mesh.pp > 1` keeps
    this stage's blocks and runs the trunk as JAX's boomerang pipeline
    (`parallel/pipeline.py`, `train.pp_microbatches`, default pp); what JAX
    refuses under pp the trainer refuses with its reason; beside fsdp a
    stage's parameters are sharded over fsdp, gathered whole once a step
    and their gradients reduce-scattered once (`sharding.GatheredStage`);
  * `mesh.sp > 1` trains sequence-parallel, as the JAX trainer does: the
    model's attention becomes the ring (`attn_impl='ring'`) over the
    layout's sp context, token streams that do not divide sp padded;
  * each of the sp processes (sp_mode 'process_group') and each pipeline
    stage computes the whole loss, so the loss is scaled by 1/(sp x pp);
    `parallel/placement.py` then sums the gradients over sp, the replicated
    parameters' over pp, and averages over dp where neither DDP nor FSDP
    does; `grad_norm` is the norm of the whole gradient, each tensor counted
    once;
  * only rank 0 makes the directories, writes `metrics.jsonl` and the
    checkpoints (every rank enters the state's gathers: a checkpoint is one
    process's file, which resumes under any layout); every rank runs the
    callbacks and samples, rank 0 writes; the ranks wait at a barrier after
    a callback, and every rank resumes from the same checkpoint.

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

import contextlib
import json
import logging
import os
import time
from collections import deque
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..data import Loader, get_dataset, prefetch_to_device
from ..diffusion.schedule import (
    MASK_NOISE_SCALE,
    Schedule,
    l_simple,
    l_simple_panoptic,
    stable_diffusion_beta_schedule,
)
from ..diffusion.sde import VPSDE, ScoreModel
from ..diffusion.sde import l_simple as l_simple_continuous
from ..models import get_nnet
from ..models.vae import get_model as get_vae
from ..models.vae import sample_from_moments
from ..parallel import sharding
from ..parallel import tensor as tp_lib
from ..parallel.mesh import (
    DataParallel,
    FullyShardedDataParallel,
    SequenceParallel,
    from_mesh,
    host_staged,
)
from ..parallel.pipeline import Pipelined, ProcessExchange, keep_stage
from ..parallel.placement import Placement
from ..utils.weights import load_nnet_state_dict, load_torch_state_dict
from . import checkpoint as ckpt_lib
from .state import TrainState, make_lr_schedule, panoptic_image_stream_frozen

log = logging.getLogger(__name__)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
TASKS = ("pixel_sde", "latent_sde", "latent_discrete", "t2i_discrete")


def infer_task(config) -> str:
    """The task of a config that does not set `config.task` (every zoo
    config does), as JAX `infer_task`: the t2i models train t2i_discrete;
    a latent config is refused rather than guessed, since latent_discrete
    and latent_sde read the same fields; anything else is pixel_sde."""
    if config.nnet.name in ("uvit_t2i", "unet_t2i"):
        return "t2i_discrete"
    if "autoencoder" in config and "z_shape" in config:
        raise ValueError("ambiguous latent config: set config.task to 'latent_discrete' "
                         "or 'latent_sde' explicitly")
    return "pixel_sde"


def step_seed(seed: int, step: int) -> int:
    """The generator seed of the step that takes the state from `step - 1` to
    `step`; reproducible in (seed, step)."""
    return int(np.random.SeedSequence([seed, step]).generate_state(1)[0])


def _check_supported(config, task: str) -> None:
    if task == "t2i_discrete":
        if config.nnet.name not in ("uvit_t2i", "unet_t2i"):
            raise NotImplementedError(f"training nnet {config.nnet.name!r}: t2i_discrete "
                                      "trains uvit_t2i and unet_t2i")
        if config.nnet.name == "unet_t2i" and config.get("mesh", {}).get("sp", 1) > 1:
            # JAX `Trainer.__init__` l.133-137: the UNet's conv / attention mix
            # has no single token axis to shard
            raise ValueError(f"mesh.sp>1 is not supported for nnet {config.nnet.name!r}")
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
    else:
        raise NotImplementedError(
            f"task {task!r} is not ported: the port trains t2i_discrete, latent_discrete, "
            "pixel_sde and latent_sde")
    if config.optimizer.name not in ("adamw", "adam"):
        raise NotImplementedError(f"optimizer {config.optimizer.name!r}: one of 'adamw', "
                                  "'adam'")


def make_train_state(config, nnet: torch.nn.Module, task: str, placement=None) -> TrainState:
    """The train state of `nnet` as `Trainer` builds it: the config's
    optimizer and learning-rate schedule; with `config.pretrained` set, a
    t2i_discrete fine-tune leaves the image stream out of the optimizer (a
    class-conditional one freezes nothing; JAX's freeze set matches U-ViT
    names only, so a UNet fine-tune freezes nothing there and here).
    `scripts/convert_checkpoint.py` builds the same, so that
    `Trainer.resume` loads its checkpoint strictly.  Under a process mesh
    `placement` names the whole network's parameters."""
    frozen = ()
    if config.get("pretrained", "") and task == "t2i_discrete":
        names = placement.full_names if placement is not None else \
            [n for n, _ in nnet.named_parameters()]
        frozen = panoptic_image_stream_frozen(names)
    lr_sched = make_lr_schedule(
        config.optimizer.lr, config.lr_scheduler.name,
        warmup_steps=config.lr_scheduler.get("warmup_steps", -1),
        total_steps=config.train.n_steps)
    return TrainState(nnet, lr_sched, betas=config.optimizer.betas,
                      weight_decay=config.optimizer.get("weight_decay", 0.0), frozen=frozen,
                      optimizer=config.optimizer.name, placement=placement)


class Trainer:
    def __init__(self, config, workdir: Optional[str] = None, device="cuda"):
        self.task = config.get("task", None) or infer_task(config)
        _check_supported(config, self.task)
        self.config = config
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("Trainer(device='cuda'): no CUDA device; pass device='cpu'")
            if self.device.index is None:
                self.device = torch.device("cuda", torch.cuda.current_device())
        layout = from_mesh(config.get("mesh", {}))
        # `dp`: the process mesh (rows, draws, averaged metrics, barriers),
        # None in one process; `sp`: the sequence-parallel context
        self.dp = layout if isinstance(layout, DataParallel) else None
        self.sp = layout if isinstance(layout, SequenceParallel) else \
            getattr(layout, "seq", None)
        self.fsdp = layout if isinstance(layout, FullyShardedDataParallel) else None
        self.tp = 1 if self.dp is None else self.dp.tp
        self.pp = 1 if self.dp is None else self.dp.pp
        self.is_main = layout is None or layout.is_main
        self._check_layout(config)
        if self.dp is not None:  # every axis's process group, on every rank at once
            self.dp.init_groups(self.device.type)
        self.workdir = workdir or config.get("workdir", "") or "results/run"
        self.ckpt_root = os.path.join(self.workdir, "ckpts")
        if self.is_main:
            os.makedirs(self.ckpt_root, exist_ok=True)

        ds_kwargs = dict(config.dataset)
        self.dataset = get_dataset(ds_kwargs.pop("name"), **ds_kwargs)

        nnet_kwargs = dict(config.nnet)
        nnet_kwargs.pop("name")
        self.is_unet = config.nnet.name == "unet_t2i"
        if not self.is_unet:  # the UNet's attention is the plain one, as in JAX
            nnet_kwargs.setdefault("attn_impl", "auto")  # or the config's, e.g. pallas_recompute
        if self.sp is not None:  # the ring, or with nnet.attn_impl='ring_plain' its plain hops
            ring = "ring_plain" if nnet_kwargs.get("attn_impl") == "ring_plain" else "ring"
            nnet_kwargs.update(attn_impl=ring, sp=self.sp)
            if self.sp.mode == "in_process":
                log.info("mesh.sp=%d in_process: every sp shard runs in this process on %s, "
                         "folded into the batch (the ring's rotation is a torch.roll)",
                         self.sp.sp, self.device)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(config.seed)
            self.nnet = get_nnet(config.nnet.name, **nnet_kwargs)
        full_names = [n for n, _ in self.nnet.named_parameters()]

        pretrained = config.get("pretrained", "")
        if pretrained:
            if not os.path.exists(pretrained):
                # Proceeding would freeze a randomly initialised image stream
                # and train the mask stream against it without an error.
                raise FileNotFoundError(f"config.pretrained={pretrained!r} does not exist")
            # a UNet reads an LDM / miniSD checkpoint into its image stream (JAX l.220-229)
            load_nnet_state_dict(self.nnet, load_torch_state_dict(pretrained), config.nnet)
        # The whole network, the same on every rank, is cut to this rank's part:
        # its tp slices, its pipeline stage's blocks, then its fsdp shards.
        tp_rules = self._place(self.nnet)
        self.nnet.to(self.device)
        if self.fsdp is not None:  # before the state: its moments and EMA follow the shards
            if self.pp > 1:  # gathered once a step, around the pipeline schedule
                sharding.shard_stage(self.nnet, self.fsdp, self.device)
            else:
                sharding.shard_model(self.nnet, self.fsdp, self.device)
        self.placement = None
        if self.dp is not None and not self.dp.pure_data_parallel:
            self.placement = Placement(self.dp, full_names, tp_rules,
                                       half=config.nnet.get("depth", 0) // 2)

        self.state = make_train_state(config, self.nnet, self.task, self.placement)
        # What the loss calls: the network (sharded or not), its pipelined
        # trunk, or its data-parallel wrapper, whose backward all-reduces
        # (averages) the gradients bucket by bucket.
        self.model = self.nnet
        if self.pp > 1:
            self.model = Pipelined(self.nnet, ProcessExchange(self.dp), self.num_micro)
            if self.fsdp is not None:
                self.model = sharding.GatheredStage(self.model, self.fsdp)
        elif self.dp is not None and self.dp.pure_data_parallel:
            self.model = torch.nn.parallel.DistributedDataParallel(
                self.nnet, device_ids=[self.device.index] if self.device.type == "cuda" else None,
                # the mask head takes no gradient when the true mask is fed in
                find_unused_parameters=bool(config.nnet.get("use_ground_truth", False)))
        if self.task in ("pixel_sde", "latent_sde"):
            self.sde = VPSDE()
        else:
            self.schedule = Schedule(stable_diffusion_beta_schedule())
        self.generator = torch.Generator(device=self.device)
        self.compute_dtype = _DTYPES[config.get("compute_dtype", "bfloat16")]
        # The frozen VAE that decodes samples, as the JAX trainer's: loaded when
        # its file exists, else samples stay latents (training reads moments).
        self.vae = None
        ae_path = config.get("autoencoder", {}).get("pretrained_path", "")
        if ae_path and os.path.exists(ae_path):
            self.vae = get_vae(scale_factor=config.autoencoder.get("scale_factor", 0.18215))
            self.vae.load_state_dict(load_torch_state_dict(ae_path), strict=True)
            self.vae.to(self.device).eval().requires_grad_(False)
        self._pipeline = None  # the sampling pipeline, built by the first sampler
        self.input_pipeline = None  # 'native' or 'python', set by data_stream

    def _check_layout(self, config) -> None:
        """What JAX's `Trainer.__init__` refuses under pp (l.157-189), with
        its reasons; sets `num_micro` (`train.pp_microbatches`, default pp).
        pp beside fsdp (and dp) is accepted, as JAX accepts it: each stage's
        parameters sharded over fsdp (`sharding.shard_stage`)."""
        self.num_micro = int(config.train.get("pp_microbatches", 0) or 0) or self.pp
        if self.pp == 1:
            return
        name = config.nnet.name
        if name not in ("uvit", "uvit_t2i"):
            raise ValueError(f"mesh.pp>1 is not supported for nnet {name!r}")
        half = config.nnet.depth // 2
        if half % self.pp:
            raise ValueError(f"mesh.pp={self.pp} must divide depth/2={half}")
        shards = self.dp.data_shards
        if config.train.batch_size % (self.num_micro * shards):
            raise ValueError(f"batch_size {config.train.batch_size} must divide into "
                             f"{self.num_micro} microbatches x {shards} data shards")

    def _place(self, nnet) -> dict:
        """Cut the whole network `nnet` to this rank's part, in place: its tp
        slices (returns the tp rules) and its pipeline stage's blocks."""
        rules = {}
        if self.tp > 1:
            rules = tp_lib.shard_model(nnet, self.dp.group("tp"), self.tp,
                                       self.dp.coords["tp"])
        if self.pp > 1:
            keep_stage(nnet, self.pp, self.dp.coords["pp"])
        return rules

    # --- loss and step ------------------------------------------------------

    def _nnet_fn(self, context):
        """(xn, t, mask_token=, use_ground_truth=) on channel-last tensors ->
        (eps_pred, mask_pred) channel-last, through the NCHW network."""

        def fn(xn, t, mask_token=None, use_ground_truth=False):
            with torch.autocast(self.device.type, dtype=self.compute_dtype,
                                enabled=self.compute_dtype != torch.float32):
                eps, mask = self.model(xn.permute(0, 3, 1, 2), t, context,
                                      mask_token=mask_token.permute(0, 3, 1, 2),
                                      use_ground_truth=use_ground_truth)
            return eps.permute(0, 2, 3, 1), mask.permute(0, 2, 3, 1)

        return fn

    def _cond_nnet_fn(self, y=None):
        """(xn, t) on channel-last tensors -> the prediction channel-last,
        through the NCHW network with the labels or the context y (None:
        unconditional)."""

        def fn(xn, t):
            with torch.autocast(self.device.type, dtype=self.compute_dtype,
                                enabled=self.compute_dtype != torch.float32):
                eps = self.model(xn.permute(0, 3, 1, 2), t, y)
            return eps.permute(0, 2, 3, 1)

        return fn

    def _loss(self, batch, noise: Dict[str, torch.Tensor]):
        """(scalar loss, metrics) of one (micro-)batch: JAX `Trainer._loss`,
        t2i_discrete (panoptic, or image-only `l_simple` on the context) and
        latent_discrete branches (the SDE tasks in `_sde_loss`).  A draw
        missing from `noise` is taken from the generator."""
        if self.task in ("pixel_sde", "latent_sde"):
            return self._sde_loss(batch, noise)
        g = self.generator
        z = sample_from_moments(batch[0].float(), self.config.autoencoder.scale_factor,
                                noise=noise.get("z"), generator=g)
        if self.task == "latent_discrete" or not self.config.nnet.get("enable_panoptic", True):
            # the labels, or image-only t2i's context (JAX l.400-406): no mask token
            loss = l_simple(z, self._cond_nnet_fn(batch[1]), self.schedule, n=noise.get("n"),
                            eps=noise.get("eps"), generator=g)
            return loss.mean(), {"loss": loss.mean().detach()}
        use_gt = bool(self.config.nnet.get("use_ground_truth", False))
        loss_eps, loss_mask = l_simple_panoptic(
            z, self._nnet_fn(batch[1]), self.schedule, batch[2],
            mask_bits=self.config.nnet.mask_bits, use_ground_truth=use_gt,
            use_twophases=bool(self.config.get("use_twophases", False)),
            n=noise.get("n"), eps=noise.get("eps"), eps_m=noise.get("eps_m"), generator=g)
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
        sm = ScoreModel(self._cond_nnet_fn(y), self.config.pred, self.sde)
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

    def _draw_noise(self, batch) -> Dict[str, torch.Tensor]:
        """The step's random draws for this process's rows, from the
        generator: the draws `_loss` would make for one call on the whole
        global batch, in its order and shapes (`z` from the moments; `n`, or
        the continuous `t`; `eps`; the mask's `eps_m`).  A data-parallel
        process draws the global batch's and keeps its rows, as JAX draws
        one key for the global batch, so the step does not depend on the
        number of processes."""
        g, dev = self.generator, self.device
        f32 = dict(generator=g, dtype=torch.float32, device=dev)
        b, rows = batch[0].shape[0], slice(None)
        if self.dp is not None:
            b *= self.dp.data_shards
            rows = self.dp.process_batch_slice(b)
        shape = (b, *batch[0].shape[1:])
        noise = {}
        if self.task != "pixel_sde":  # the draw from the (mean, logvar) moments
            shape = (*shape[:-1], shape[-1] // 2)
            noise["z"] = torch.randn(shape, **f32)
        if self.task in ("pixel_sde", "latent_sde"):
            noise["t"] = torch.rand((b,), **f32)
        else:
            noise["n"] = torch.randint(1, self.schedule.N + 1, (b,), generator=g, device=dev)
        noise["eps"] = torch.randn(shape, **f32)
        if self.task == "t2i_discrete" and self.config.nnet.get("enable_panoptic", True):
            ids = batch[2].shape  # (B, H, W, 1) integer maps -> mask_bits analog bits
            bits = (b, *ids[1:-1], ids[-1] * self.config.nnet.mask_bits)
            noise["eps_m"] = MASK_NOISE_SCALE * torch.randn(bits, **f32)
        return {k: v[rows] for k, v in noise.items()}

    def loss_and_grads(self, batch, noise: Optional[Dict[str, torch.Tensor]] = None):
        """Forward and backward of one step on this process's rows `batch`;
        leaves the gradient in each parameter's .grad and returns the
        metrics (device tensors, averaged over a data-parallel run's
        processes) with the global gradient norm over every parameter,
        frozen ones too.  `noise` holds the draws for these rows (one
        missing is taken from the generator); by default `_draw_noise` takes
        them all from the generator, reseeded from (seed, step)."""
        batch, noise = self._as_device(batch, noise)
        self.generator.manual_seed(step_seed(self.config.seed, self.state.step + 1))
        if noise is None:
            noise = self._draw_noise(batch)
        for p in self.state.params.values():
            p.grad = None
        accum = int(self.config.train.get("grad_accum", 1))
        # Each of `world` processes computes the whole loss of its rows (the
        # sp processes under sp_mode='process_group', and the pp stages, from
        # stage 0's broadcast outputs); their gradients are summed below.  The
        # tp ranks each compute it too, and their collectives make every
        # gradient whole on each.  A data-parallel process computes its rows'
        # loss; the gradients are averaged over the data shards (by
        # `DistributedDataParallel`, FSDP, or `Placement.reduce_grads`).
        world = (1 if self.sp is None else self.sp.world_size) * self.pp
        # Micro-batches of B/accum, each with its slice of the draws; the
        # gradient is the mean of theirs, the metrics the mean of theirs.
        micro = [tuple(x.chunk(accum)) for x in batch]
        parts = []
        staged = isinstance(self.model, sharding.GatheredStage)
        if staged:  # the stage's parameters whole for every micro-batch of the step
            self.model.gather()
        for i in range(accum):
            mn = {k: v.chunk(accum)[i] for k, v in noise.items()}
            last = i == accum - 1
            with self._grad_sync(last):
                loss, m = self._loss(tuple(x[i] for x in micro), mn)
                (loss / (accum * world)).backward()
            parts.append(m)
        metrics = {k: torch.stack([m[k] for m in parts]).mean() for k in parts[0]}
        if staged:  # averaged over fsdp; over dp below
            self.model.scatter_grads()
        if self.placement is not None:
            self.placement.reduce_grads(self.state.params,
                                        manual_data=self.fsdp is None or staged)
        if self.dp is not None:
            names = sorted(metrics)
            mean = torch.stack([metrics[k] for k in names])
            dist.all_reduce(mean)
            metrics = dict(zip(names, mean / self.dp.world_size))
        if self.placement is not None:
            metrics["grad_norm"] = self.placement.grad_norm(self.state.params)
        else:
            grads = [p.grad for p in self.state.params.values() if p.grad is not None]
            metrics["grad_norm"] = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(grads)))
        return metrics

    def _grad_sync(self, sync: bool):
        """The context of one micro-batch's backward: with `sync` False a
        data-parallel run keeps its gradients local (DDP's `no_sync`; FSDP's
        `set_requires_gradient_sync(False)`, which keeps them unsharded)."""
        if self.fsdp is not None and self.pp == 1:
            self.nnet.set_requires_gradient_sync(sync)
        elif self.dp is not None and self.dp.pure_data_parallel and not sync:
            return self.model.no_sync()
        return contextlib.nullcontext()

    def train_step(self, batch, noise: Optional[Dict[str, torch.Tensor]] = None):
        """One optimizer step on `batch`; returns metrics as device tensors."""
        metrics = self.loss_and_grads(batch, noise)
        self.state.apply_gradients(ema_rate=self.config.get("ema_rate", 0.9999))
        return metrics

    # --- sampling -----------------------------------------------------------

    def sample_weights(self):
        """(EMA parameters, VAE or None): what the sampler runs with."""
        return self.state.ema, self.vae

    def sample_pipeline(self):
        """The `serving.GenerationPipeline` that samples for this trainer: a
        sampling copy of the network with `attn_impl='infer'` (kernel 1 with
        no gradient, as JAX's `clone(attn_impl="infer")`; the ring under sp,
        its hops through kernel 3), laid out as the trainer's (this rank's tp
        slices and pipeline stage, the trunk pipelined with the microbatch
        count adapted to each batch, as JAX's `build_sample_fn` does under pp;
        whole over fsdp), in the config's compute dtype, the trainer's VAE,
        and the dataset's empty context for CFG.  Built once;
        `build_sample_fn` copies the EMA weights into it at every call.
        Under a process mesh every rank must sample together: the gathers,
        rings and sends need them all."""
        if self._pipeline is None:
            from ..serving import GenerationPipeline

            kwargs = dict(self.config.nnet)
            if not self.is_unet:
                kwargs.update(attn_impl="infer", use_checkpoint=False)
            if self.sp is not None:
                kwargs.update(attn_impl="ring", sp=self.sp)
            nnet = get_nnet(kwargs.pop("name"), **kwargs)
            self._place(nnet)
            if self.pp > 1:
                nnet = Pipelined(nnet, ProcessExchange(self.dp), self.num_micro)
            empty = getattr(self.dataset, "empty_context", None)
            self._pipeline = GenerationPipeline(self.config, nnet, self.vae, empty,
                                                device=self.device)
        return self._pipeline

    def build_sample_fn(self, sample_steps: Optional[int] = None,
                        decode: bool = True) -> Callable:
        """JAX `Trainer.build_sample_fn` (l.446-606) on
        `serving.GenerationPipeline.sample`: returns
        sample_fn(cond, z, m0=None, panoptic=None, generator=None).

        `cond` is the CLIP context (n, L, clip_dim), the labels (n,) or None;
        `z` the initial draw, channel-last (n, h, w, c) as the JAX sampler's
        `jax.random.normal(k1, (n, *z_shape))`, and `m0` the panoptic mask's
        (n, mask_size, mask_size, mask_bits); `panoptic`, integer maps (n,
        mask_size, mask_size, 1), runs a `nnet.use_ground_truth` model on the
        true mask; `generator` draws Euler-Maruyama's step noise.  At each call
        the sampling copy takes the EMA weights of that moment.  Returns the
        images channel-last in [-1, 1] (or the latents without a VAE), and
        the mask's analog bits (n, mask_size, mask_size, mask_bits) for a
        panoptic model, as tensors on the trainer's device (not synchronised);
        `decode=False` returns the latents without the VAE.
        Branches: continuous pixel_sde / latent_sde, latent_discrete with
        class CFG, t2i_discrete with the speed modes and the mask hold, or
        with `sample.algorithm='pndm'` PNDM with the mask token fixed (the
        ground-truth mode too, JAX l.574-604)."""
        pipe = self.sample_pipeline()
        steps = sample_steps or self.config.sample.sample_steps
        copy = pipe.nnet.nnet if isinstance(pipe.nnet, Pipelined) else pipe.nnet
        names = [n for n, _ in copy.named_parameters()]
        params = [p for _, p in copy.named_parameters()]

        def nchw(t):  # channel-last draws -> f32 NCHW on the device
            return None if t is None else self._on_device(t).float().permute(0, 3, 1, 2)

        @torch.no_grad()
        def sample_fn(cond, z, m0=None, panoptic=None, generator=None):
            for p, name in zip(params, names):  # whole over fsdp: a gather on every rank
                p.copy_(sharding.full(self.state.ema[name]))
            cond = self._on_device(cond)
            if cond is not None and cond.is_floating_point():
                cond = cond.float()
            x, mask = pipe.sample(nchw(z).contiguous(), nchw(m0), cond, steps,
                                  generator=generator, panoptic=self._on_device(panoptic),
                                  decode=decode)
            x = x.float().permute(0, 2, 3, 1)
            return x if mask is None else (x, mask.permute(0, 2, 3, 1))

        return sample_fn

    def _on_device(self, t):
        """None, a numpy array or a tensor -> None or a tensor on the device."""
        if t is None or torch.is_tensor(t):
            return None if t is None else t.to(self.device)
        return torch.from_numpy(np.array(t)).to(self.device)

    # --- data and loop ------------------------------------------------------

    def data_stream(self, start_step: int = 0):
        """Batches on the trainer's device from step `start_step` on: the
        native C++ loader's stream (`_native_stream`) where it applies, else
        the Python `Loader` with its index-only skip; then the device feed
        (uint8 panoptic ids by default, labels as they are, optional bf16
        float fields, `train.transfer_dtype`).  Sets `input_pipeline` to
        'native' or 'python'.

        Where several processes load one shard of the batch (they differ in
        pp, sp or tp alone, and JAX feeds them the same rows) the first of
        them reads it and hands it to the others (`_shared_stream`): both
        loaders draw the caption and the CFG drop at random, and the native
        loader's threads race for the order of the batches, so peers reading
        on their own would train on different rows."""
        peers = [] if self.dp is None else self.dp.data_peers()
        if len(peers) > 1:
            return self._shared_stream(start_step, peers[0])
        return self._read_stream(start_step)

    def _shared_stream(self, start_step: int, src: int):
        """`_read_stream` on global rank `src`, each batch broadcast over the
        data peers' group to the others, with the pipeline it came from
        (card tensors through host copies over gloo)."""
        group = self.dp.group("data")
        staged = self.device.type == "cuda" and host_staged(group)
        stream = self._read_stream(start_step) if self.dp.rank == src else None
        while True:
            batch = None if stream is None else next(stream)
            fields = batch if isinstance(batch, tuple) else (batch,)
            box = [None if stream is None else (
                self.input_pipeline, isinstance(batch, tuple),
                [(t.shape, t.dtype) for t in fields])]
            dist.broadcast_object_list(box, src=src, group=group)
            self.input_pipeline, is_tuple, meta = box[0]
            if stream is None:
                fields = tuple(torch.empty(shape, dtype=dtype, device=self.device)
                               for shape, dtype in meta)
            for t in fields:
                buf = t.cpu() if staged else t
                dist.broadcast(buf, src=src, group=group)
                if staged and stream is None:
                    t.copy_(buf)
            yield fields if is_tuple else fields[0]

    def _read_stream(self, start_step: int):
        """This process's batches, read from its loader (see `data_stream`)."""
        cfgt = self.config.train
        cast_f32 = torch.bfloat16 if cfgt.get("transfer_dtype", "") == "bfloat16" else None
        cast_int = (np.uint8 if self.config.nnet.get("enable_panoptic", False)
                    and self.config.nnet.get("mask_bits", 8) <= 8
                    and cfgt.get("transfer_mask_uint8", True) else None)
        native = self._native_stream(start_step)
        self.input_pipeline = "python" if native is None else "native"
        if native is not None:
            return prefetch_to_device(native, self.device, cast_f32=cast_f32,
                                      cast_int=cast_int)
        procs = {} if self.dp is None else dict(process_index=self.dp.data_rank,
                                                process_count=self.dp.data_shards)
        loader = Loader(self.dataset.get_split("train", labeled=True),
                        batch_size=cfgt.batch_size,
                        num_workers=self.config.get("num_workers", 8), seed=self.config.seed,
                        **procs)
        if start_step:
            loader.skip(start_step)
        return prefetch_to_device(iter(loader), self.device, cast_f32=cast_f32,
                                  cast_int=cast_int)

    def _native_stream(self, start_step: int = 0):
        """The native C++ loader's batches (`data/native_loader.py`), JAX
        `Trainer._native_stream` (l.708-777), or None where it does not
        apply: a task other than t2i_discrete, `config.native_loader` False,
        or a dataset other than `MSCOCO256Features` with a `train/`
        directory.  When the library cannot be built it logs a warning and
        returns None.

        Each batch shard (the (dp, fsdp) index) reads its strided subset of
        the files and its rows of the global batch; under pp, sp or tp one
        process of each shard reads it for its peers (`data_stream`).  The
        C++ loader cannot fast-forward, so its seed folds in the start step
        (seed + rank + 1_000_003 * step): a resumed run gets a fresh
        shuffle.  The CFG drop to the empty context (`dataset.p_uncond`) is
        drawn here, from `np.random.default_rng(seed + rank + start_step)`,
        as JAX draws it."""
        from ..data import native_loader
        from ..data.datasets import MSCOCO256Features

        config = self.config
        if self.task != "t2i_discrete" or not config.get("native_loader", True):
            return None
        if not isinstance(self.dataset, MSCOCO256Features):
            return None
        train_dir = os.path.join(self.dataset.path, "train")
        if not os.path.isdir(train_dir):
            return None
        if not native_loader.available():
            log.warning("the native C++ loader could not be built; the Python Loader "
                        "feeds the trainer")
            return None
        rank, world = (0, 1) if self.dp is None else (self.dp.data_rank, self.dp.data_shards)
        h, w, c = config.z_shape
        enable_panoptic = config.nnet.get("enable_panoptic", True)
        mask_size = config.nnet.mask_size if enable_panoptic else None
        seg_probe = next((n for n in os.listdir(train_dir) if n.endswith("_seg.npy")), None)
        seg_in = (np.load(os.path.join(train_dir, seg_probe)).shape[0] if seg_probe
                  else mask_size or 0)
        loader = native_loader.NativeFeatureLoader(
            train_dir, batch_size=config.train.batch_size, moments_shape=(2 * c, h, w),
            context_shape=(config.nnet.num_clip_token, config.nnet.clip_dim),
            seg_in=seg_in, mask_size=mask_size, seed=config.seed + rank + 1_000_003 * start_step,
            num_threads=max(1, config.get("num_workers", 8)), process_index=rank,
            process_count=world)
        p_uncond = float(config.dataset.get("p_uncond", 0.0) or 0.0)
        empty = np.asarray(self.dataset.empty_context, dtype=np.float32)
        rng = np.random.default_rng(config.seed + rank + start_step)

        def stream():
            try:
                for batch in loader:
                    if p_uncond > 0.0:
                        context = batch[1]
                        context[rng.random(context.shape[0]) < p_uncond] = empty
                    yield batch
            finally:
                loader.close()

        log.info("the native C++ loader feeds the trainer")
        return stream()

    def resume(self) -> bool:
        return ckpt_lib.resume(self.ckpt_root, self.state)

    def save_checkpoint(self, block: bool = True) -> None:
        """A checkpoint of the state at its step; over several processes
        every rank enters the state's gathers and rank 0 writes."""
        if self.dp is None:
            ckpt_lib.save_checkpoint(self.ckpt_root, self.state, block=block)
        else:
            ckpt_lib.save_checkpoint(self.ckpt_root, self.state, block=block,
                                     write=self.is_main)

    def _barrier(self) -> None:
        """Every process of a multi-process run waits here for the others."""
        if self.dp is not None:
            dist.barrier()  # NCCL's on the device `cli.init_distributed` bound

    def fit(self, max_steps: Optional[int] = None, eval_callback: Optional[Callable] = None,
            vis_callback: Optional[Callable] = None):
        """Train to `config.train.n_steps` (or `max_steps`) from the latest
        checkpoint; returns the logged metrics.

        vis_callback(trainer, step) runs every `train.eval_interval` steps
        (sample grids) and eval_callback(trainer, step) every
        `train.save_interval` steps (FID), where it takes over the checkpoint
        (best-FID retention), as in JAX `fit` (l.783-845); both live in
        `evaluation/runner.py`.  Over several processes every rank runs them:
        every rank samples (under a process mesh the sampler's gathers, rings
        and sends need them all; under plain data parallelism rank 0 alone),
        and rank 0 alone writes the grid and the samples and computes FID;
        the ranks then wait for each other at a barrier (the process group's
        timeout, `cli.DIST_TIMEOUT`, is long enough for a FID evaluation).
        Without an eval callback every `save_interval` step is checkpointed
        asynchronously (`block=False`; every rank enters the state's
        gathers, rank 0 writes), and every write is on disk when `fit`
        returns."""
        config = self.config
        self.resume()
        stream = self.data_stream(start_step=self.state.step)
        n_steps = max_steps or config.train.n_steps
        log_interval = config.train.get("log_interval", 10)
        save_interval = config.train.get("save_interval", 50000)
        eval_interval = config.train.get("eval_interval", 0)
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
            called = False
            if vis_callback is not None and eval_interval and step % eval_interval == 0:
                vis_callback(self, step)
                called = True
            if save_interval and step % save_interval == 0:
                if eval_callback is not None:
                    eval_callback(self, step)
                    called = True
                else:
                    self.save_checkpoint(block=False)
            if called:
                self._barrier()
        ckpt_lib.wait_for_saves()
        self._barrier()  # every rank returns with rank 0's checkpoints on disk
        return history
