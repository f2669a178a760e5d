"""Inference API of the port: load a config and weights once, generate batches.

Port of `panopticdiffusionmodels_tpu/serving.py::GenerationPipeline`: the
t2i / panoptic, class-conditional and unconditional DPM-Solver branches of
the discrete schedule, and the continuous VP-SDE branch of the `pixel_sde` /
`latent_sde` configs:

    from panopticdiffusionmodels_torch.serving import GenerationPipeline
    pipe = GenerationPipeline.from_config("mscoco_uvit_small",
                                          nnet_path="nnet_ema.pth",
                                          vae_path="autoencoder_kl.pth")
    images, masks = pipe.generate(contexts=clip_contexts, steps=50)

    pipe = GenerationPipeline.from_config("imagenet256_uvit_large")
    images = pipe.generate(labels=[207, 360, 387, 974], steps=50)

    pipe = GenerationPipeline.from_config("cifar10_uvit_small")
    images = pipe.generate(n=16)  # 1000-step Euler-Maruyama, the config's sampler

A discrete request runs 50-NFE order-3 DPM-Solver++ ('fast'), mask-aware for
the panoptic model, with CFG as one 2x-batch forward per NFE (the empty
context, or the null class num_classes - 1; an unconditional model has no
CFG), then the KL-VAE decode and, for the panoptic model, the analog-bit ->
panoptic-id decode.  A continuous request samples the `VPSDE` with the
config's `sample.algorithm`: Euler-Maruyama on the reverse SDE or on the
probability-flow ODE, or else the upstream DPM-Solver plan ('fast_upstream',
noise prediction, the linear schedule, eps 1e-4, order 3, logSNR steps);
labels go to a class-conditional model as `y`, and only a config with an
`autoencoder` decodes.  The config's opt-in speed modes (`sample.accel`,
`sample.cfg_interval` with the mask-guidance hold
`sample.cfg_interval_mask_hold`, `nnet.gelu_approx`) are checked against
`samplers/speed_budget.py` once per distinct set of knobs.  Entry points run
on the card unless the caller passes `device="cpu"`.  The network computes
in `config.compute_dtype` (bf16: GEMMs in bf16 with f32 accumulation; norms,
softmax and the solver state in f32; the continuous score model takes the
network's output in f32); the VAE keeps its parameters in f32 and computes
in its own dtype: f32 from `from_config`, as in the JAX package (the port's
bench passes a bf16 one).
"""
from __future__ import annotations

import logging
import os
from typing import Optional, Sequence

import numpy as np
import torch

from .configs import CONFIG_NAMES, get_config
from .diffusion.analog_bits import analog_to_ints
from .diffusion.cfg import make_cfg_class_cond, make_cfg_t2i
from .diffusion.schedule import Schedule, stable_diffusion_beta_schedule
from .diffusion.sde import ODE, VPSDE, ReverseSDE, ScoreModel
from .models import get_nnet
from .models.vae import get_model as get_vae
from .samplers.dpm_solver import DPMSolver
from .samplers.euler_maruyama import euler_maruyama
from .samplers.noise_schedule import NoiseScheduleVP
from .samplers.speed_budget import check_speed_modes
from .utils.weights import load_torch_state_dict, reference_nnet_state_dict

log = logging.getLogger(__name__)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _batch_seed(seed: int, i: int) -> int:
    """Seed of batch i of generate_batches: reproducible in (seed, i), and
    batch 0 is not the draw of generate(seed=seed)."""
    return int(np.random.SeedSequence([seed, i]).generate_state(1)[0])


class GenerationPipeline:
    """Text-conditioned image + panoptic-mask generation, class-conditional
    image generation (`uvit` with num_classes > 0) or unconditional image
    generation (`uvit` without classes)."""

    def __init__(self, config, nnet: torch.nn.Module, vae: Optional[torch.nn.Module] = None,
                 empty_context=None, device="cuda"):
        name = config.nnet.name
        if name not in ("uvit", "uvit_t2i"):
            raise NotImplementedError(f"serving {name!r} comes with a later slice of the port")
        self.class_cond = name == "uvit" and config.nnet.get("num_classes", -1) > 0
        self.is_t2i = name == "uvit_t2i"
        task = config.get("task", "")
        algorithm = config.sample.get("algorithm", "dpm_solver")
        self.continuous = task in ("pixel_sde", "latent_sde")
        if self.continuous and self.is_t2i:
            raise NotImplementedError(f"serving task={task!r} samples a uvit; a t2i model "
                                      "serves t2i_discrete")
        if not self.continuous and algorithm not in ("dpm_solver", ""):
            raise NotImplementedError(
                f"serving task={task!r} / algorithm={algorithm!r}: the discrete schedule "
                "serves dpm_solver; pndm comes with the UNet-family slice")
        self.config = config
        self.device = torch.device(device)
        self.dtype = _DTYPES[config.get("compute_dtype", "bfloat16")]
        self.nnet = nnet.to(self.device, self.dtype).eval()
        self.vae = vae.to(self.device, torch.float32).eval() if vae is not None else None
        hw = config.nnet.img_size
        self.z_shape = tuple(config.get("z_shape", (hw, hw, config.nnet.get("in_chans", 4))))
        if self.continuous:
            self.sde = VPSDE()
            self.ns = NoiseScheduleVP("linear")
        else:
            betas = stable_diffusion_beta_schedule()
            self.N = Schedule(betas).N
            self.ns = NoiseScheduleVP("discrete", betas=betas)
        self.panoptic = self.is_t2i and bool(config.nnet.get("enable_panoptic", True))
        self._checked_knobs = set()  # speed-mode knob sets already checked
        self.last_real_evals = 0  # network evals of the last request's sampler
        self.empty_context = None  # the unconditional CLIP context of a t2i model
        if self.is_t2i:
            if empty_context is None:
                if config.sample.get("cfg", False):
                    log.warning(
                        "serving: CFG is enabled but no empty_context was given — guidance "
                        "will extrapolate against a ZEROS context the model never saw in "
                        "training; pass empty_context_path=.../empty_context.npy for correct "
                        "unconditional guidance")
                empty_context = np.zeros((config.nnet.num_clip_token, config.nnet.clip_dim),
                                         np.float32)
            self.empty_context = torch.as_tensor(np.asarray(empty_context, np.float32),
                                                 device=self.device)

    @classmethod
    def from_config(cls, config_or_name, nnet_path: Optional[str] = None,
                    vae_path: Optional[str] = None, empty_context_path: Optional[str] = None,
                    seed: int = 0, device="cuda") -> "GenerationPipeline":
        """Build the network (and the VAE when the config has one) from seeded
        random weights, then load reference-format `.pth` files strictly when
        given."""
        config = (get_config(config_or_name)
                  if isinstance(config_or_name, str) and config_or_name in CONFIG_NAMES
                  else config_or_name)
        kwargs = dict(config.nnet)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            nnet = get_nnet(kwargs.pop("name"), **kwargs)
            vae = (get_vae(scale_factor=config.autoencoder.scale_factor)
                   if "autoencoder" in config else None)
        for path, what in ((nnet_path, "nnet_path"), (vae_path, "vae_path")):
            if path and not os.path.exists(path):
                raise FileNotFoundError(
                    f"{what}={path!r} does not exist — serving would otherwise "
                    "silently generate from random weights")
        if nnet_path:
            nnet.load_state_dict(reference_nnet_state_dict(load_torch_state_dict(nnet_path)),
                                 strict=True)
        if vae_path:
            vae.load_state_dict(load_torch_state_dict(vae_path), strict=True)
        empty_context = None
        if empty_context_path and os.path.exists(empty_context_path):
            empty_context = np.load(empty_context_path)
        return cls(config, nnet, vae, empty_context, device)

    # --- generation ------------------------------------------------------

    @torch.no_grad()
    def sample(self, z: torch.Tensor, m0: Optional[torch.Tensor], cond: Optional[torch.Tensor],
               steps: Optional[int] = None, generator: Optional[torch.Generator] = None):
        """The sampler on given noise: z (n, C, h, w) and m0 (n, mask_bits,
        mask_size, mask_size) or None, both f32 on the pipeline's device;
        `cond` is the CLIP context (n, 77, clip_dim), the labels (n,) of a
        class-conditional model, or None for an unconditional one;
        `generator` draws the noise of Euler-Maruyama's steps.  Returns
        (decoded images (n, 3, H, W), or the sample without a VAE, pred_mask
        or None)."""
        steps = steps or self.config.sample.sample_steps
        sample_cfg = self.config.sample
        scale = float(sample_cfg.get("scale", 0.0))
        enabled = bool(sample_cfg.get("cfg", False))
        accel_tau = float(sample_cfg.get("accel", 0.0))
        cfg_interval = tuple(sample_cfg.get("cfg_interval", ())) or None
        # The hold only has something to hold on a guided panoptic request
        # (JAX `serving.py:315-318`).
        hold = bool(cfg_interval and self.panoptic and enabled and scale
                    and sample_cfg.get("cfg_interval_mask_hold", True))
        knobs = (scale, enabled, accel_tau, cfg_interval, hold,
                 bool(self.config.nnet.get("gelu_approx", False)))
        if knobs not in self._checked_knobs:
            # once per distinct set of knobs, as JAX once per compiled program
            check_speed_modes(self.config)
            self._checked_knobs.add(knobs)
        if self.continuous:
            z0 = self._sample_continuous(z, cond, steps, generator)
            return (self.vae.decode(z0) if self.vae is not None else z0), None
        if self.class_cond:
            cfg_fn = make_cfg_class_cond(lambda xx, tt, yy: self.nnet(xx, tt, yy),
                                         null_label=self.config.nnet.num_classes - 1,
                                         scale=scale, enabled=enabled)

            def model_fn(xx, tt, mask_token=None, cfg_on=True):
                return cfg_fn(xx, tt * self.N, cond, cfg_on=cfg_on)
        elif self.is_t2i:
            cfg_fn = make_cfg_t2i(
                lambda xx, tt, cc, mask_token=None: self.nnet(xx, tt, cc, mask_token=mask_token),
                self.empty_context, scale=scale, enabled=enabled)

            def model_fn(xx, tt, mask_token=None, cfg_on=True, **mkw):
                return cfg_fn(xx, tt * self.N, cond, mask_token=mask_token, cfg_on=cfg_on,
                              **mkw)
        else:
            # No CFG wrapper, so the guidance interval does not apply; the
            # forecast-skip does (JAX `serving.py:354-367`).
            cfg_interval = None

            def model_fn(xx, tt, mask_token=None):
                return self.nnet(xx, tt * self.N)
        solver = DPMSolver(model_fn, self.ns, predict_x0=True, accel_tau=accel_tau,
                           cfg_interval=cfg_interval, mask_guidance_hold=hold)
        out = solver.sample(z, steps=steps, eps=1.0 / self.N, T=1.0, order=3,
                            method="fast", mask_token=m0)
        self.last_real_evals = solver.real_evals
        z0, pred_mask = out if m0 is not None else (out, None)
        if self.vae is not None:
            z0 = self.vae.decode(z0)
        return z0, pred_mask

    def _sample_continuous(self, z, y, steps: int, generator):
        """JAX `serving.py:212-246`: the VPSDE's score model, integrated with
        the config's `sample.algorithm`."""
        algorithm = self.config.sample.get("algorithm", "dpm_solver")
        kwargs = {} if y is None else {"y": y}
        sm = ScoreModel(lambda xx, tt, **kw: self.nnet(xx, tt, **kw).to(xx.dtype),
                        self.config.get("pred", "noise_pred"), self.sde)
        if algorithm in ("euler_maruyama_sde", "euler_maruyama_ode"):
            rsde = ReverseSDE(sm) if algorithm == "euler_maruyama_sde" else ODE(sm)
            self.last_real_evals = steps
            return euler_maruyama(rsde, z, steps, generator=generator, **kwargs)
        # the continuous DPM-Solver: the upstream plan
        solver = DPMSolver(lambda xx, tt, mask_token=None: sm.noise_pred(xx, tt, **kwargs),
                           self.ns, predict_x0=False)
        x = solver.sample(z, steps=steps, eps=1e-4, T=1.0, order=3, method="fast_upstream",
                          skip_type="logSNR")
        self.last_real_evals = solver.real_evals
        return x

    def _draw(self, n: int, generator: torch.Generator):
        h, w, c = self.z_shape
        z = torch.randn((n, c, h, w), generator=generator, device=self.device)
        m0 = None
        if self.panoptic:
            ms, bits = self.config.nnet.mask_size, self.config.nnet.mask_bits
            m0 = torch.randn((n, bits, ms, ms), generator=generator, device=self.device)
        return z, m0

    def _cond(self, prompts, contexts, labels, n):
        """(conditioning, batch size) of one request: labels (n,) int64 for a
        class-conditional model (n= alone gives n samples of the null class),
        CLIP contexts (n, 77, clip_dim) f32 for a t2i model (n= alone gives
        the empty context), None for an unconditional model (n= only)."""
        if self.class_cond:
            if prompts is not None or contexts is not None:
                raise ValueError("a class-conditional model takes labels= or n=, not "
                                 "prompts= / contexts=")
            if labels is None:
                if n is None:
                    raise ValueError("generate needs labels= or n=")
                labels = np.full((n,), self.config.nnet.num_classes - 1)
            y = torch.as_tensor(np.asarray(labels, np.int64), device=self.device)
            return y, y.shape[0]
        if not self.is_t2i:
            if prompts is not None or contexts is not None or labels is not None:
                raise ValueError("an unconditional model takes n= only")
            if n is None:
                raise ValueError("generate needs n=")
            return None, n
        if labels is not None:
            raise ValueError("labels= is for class-conditional models; a text-to-image "
                             "model takes contexts=")
        if prompts is not None:
            raise NotImplementedError(
                "prompts= needs the frozen CLIP text encoder, which comes with a later "
                "slice of the port; pass pre-extracted CLIP contexts= instead")
        if contexts is not None:
            ctx = torch.as_tensor(np.asarray(contexts, np.float32), device=self.device)
            return ctx, ctx.shape[0]
        if n is None:
            raise ValueError("generate needs contexts= or n=")
        return self.empty_context.expand(n, *self.empty_context.shape[-2:]), n

    def _postprocess(self, images, pred_mask):
        """-> numpy NHWC images in [0, 1] (+ integer panoptic-id maps (B, H, W, 1))."""
        images01 = ((images.float() + 1) / 2).clamp(0, 1).permute(0, 2, 3, 1).cpu().numpy()
        if pred_mask is None:
            return images01
        ids = analog_to_ints(pred_mask.permute(0, 2, 3, 1), n=self.config.nnet.mask_bits)
        return images01, ids.cpu().numpy()

    def _run(self, cond, n: int, seed_value: int, steps: int):
        g = torch.Generator(device=self.device).manual_seed(seed_value)
        z, m0 = self._draw(n, g)
        return self.sample(z, m0, cond, steps, generator=g)

    def generate(self, prompts: Optional[Sequence[str]] = None, contexts=None,
                 labels=None, n: Optional[int] = None, steps: Optional[int] = None,
                 seed: int = 0):
        """Images in [0, 1] NHWC (numpy), plus integer panoptic-id maps for
        panoptic models: (images, mask_ids)."""
        cond, n = self._cond(prompts, contexts, labels, n)
        out = self._run(cond, n, seed, steps or self.config.sample.sample_steps)
        return self._postprocess(*out)

    def generate_batches(self, batches, steps: Optional[int] = None, seed: int = 0):
        """One generate()-shaped result per input batch (dicts of generate()'s
        conditioning keys), in order.  Batch i+1 is enqueued on the card before
        batch i is copied back and decoded on the host; batch i draws its noise
        from a generator seeded by (seed, i)."""
        steps = steps or self.config.sample.sample_steps
        pending = None
        for i, kw in enumerate(batches):
            cond, n = self._cond(kw.get("prompts"), kw.get("contexts"), kw.get("labels"),
                                 kw.get("n"))
            out = self._run(cond, n, _batch_seed(seed, i), steps)
            if pending is not None:
                yield self._postprocess(*pending)
            pending = out
        if pending is not None:
            yield self._postprocess(*pending)
