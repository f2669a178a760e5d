"""Distribution-level quality gate for the opt-in sampling speed modes, on the
port.

    python -m panopticdiffusionmodels_torch.scripts.quality_gate <geo> \
        <spec | train[=seconds] | report> ... [--device=cpu]

Port of `scripts/quality_gate.py`.  For each configuration it generates N
samples, extracts their pool3 features with the FID InceptionV3
(`evaluation/inception.py`) at FIXED random weights (`random_state_dict(0)`,
the values of JAX's `random_params(0)`; random-feature distances are a
standard proxy, arXiv:2002.01365), and compares the distance between a speed
mode and the exact protocol against the seed-to-seed noise floor of exact
runs that differ only in their noise seed.  Nothing is downloaded: the
`trained*` geometries train their own gate models here (`train`), on a
synthetic class-structured distribution the model can learn in minutes.

Channels and verdicts, as JAX's (`report`):
  * image: KID (unbiased polynomial-kernel MMD^2, `evaluation/kid.py`,
    index-matched pairs excluded) against the worst exact pair's
    |mean| + 2 std; the Frechet distance (`evaluation/fid.py`) is recorded,
    and is the image channel only for runs without activations;
  * mask (panoptic geometries): total variation between mask-id histograms;
  * latent (trained geometries): the larger TV of the class-match and
    match-quality histograms of z0 against the class patterns;
  * PASS <= 2x the floor, MARGINAL 2x..5x, FAIL > 5x; the mask and latent
    channels are judged against the 25-NFE control's own TV where it is
    non-zero (PASS <= 2x, MARGINAL <= 3x);
  * a channel is ARMED when the 25-NFE control passes it (PASS / MARGINAL)
    and a dose below 25 NFE FAILs it; a mode's verdict is the worst over its
    armed channels, UNARMED when none is.

Runs are incremental: each spec writes QG_DIR/<geo>[_<instance>]/<spec>.npz
with JAX's keys (mu, sigma, mask_hist, n, wall, spec, acts,
latent_class_hist, latent_q_hist), so either package's `report` reads the
other's files; `report` writes report.json beside them.  `train` writes the
EMA parameters, a torch state dict, to QG_DIR/<geo>[_<instance>]_params.pt.

Specs: exactA|exactB|exactC, gelu, accel=<tau>, gelu_accel=<tau>,
  interval=<lo>,<hi>, ihold=<lo>,<hi>, combo=<tau>:<lo>,<hi>,
  full=<tau>:<lo>,<hi>, full_hold=<tau>:<lo>,<hi>, steps=<n>.
Geos: imagenet (the port bench's U-ViT-L/2 on seeded weights), panoptic
  (S/2) and panoptic_large (L) through `bench_panoptic_modes.py`, and the
  trained ones: trained (class-conditional S/2), trained_L (U-ViT-L/2),
  trained_panoptic (the dual-stream S/2 at 256 res), trained_panoptic_512
  (at 512 res, L = 1102 / 2126 a stream).
Env: QG_N (samples, 1024), QG_BATCH (32), QG_DIR (default
  build/quality_gate_torch in the checkout; nothing is written under
  quality_gate/, which holds the JAX package's reports), QG_INSTANCE (an
  independent trained instance: its own seed offset, parameters and
  directory), QG_LR (the learning rate of `train`).
Training and sampling run on the card (attention kernels 1 and 2 in
training, kernel 1 in sampling) and raise without one unless `--device=cpu`;
`report` touches no device.
"""
from __future__ import annotations

import json
import os
import sys
import time
import zlib
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from ..diffusion.cfg import make_cfg_class_cond
from ..diffusion.schedule import (
    Schedule,
    l_simple,
    l_simple_panoptic,
    stable_diffusion_beta_schedule,
)
from ..evaluation.fid import frechet_distance
from ..evaluation.kid import kid
from ..models import UViT, UViTT2I
from ..models.vae import AutoencoderKL
from ..models.vae import get_model as get_vae
from ..train.state import TrainState, make_lr_schedule
from . import bench_panoptic_modes
from .bench_panoptic_modes import require_device, sync

# Noise seeds: exact runs A/B/C differ ONLY here; every mode uses seed A so
# a mode's distance to exactA isolates its effect from seed noise.
SEEDS = {"exactA": 101, "exactB": 202, "exactC": 303}
MODE_SEED = 101

GEOS = ("imagenet", "panoptic", "panoptic_large", "trained", "trained_L", "trained_panoptic",
        "trained_panoptic_512")
DEFAULT_DIR = Path(__file__).resolve().parents[2] / "build" / "quality_gate_torch"

# Model scale per trained image geometry: (embed_dim, depth, num_heads).
# trained_L is the flagship U-ViT-L/2 (configs/imagenet256_uvit_large).
_GEO_SCALE = {"trained": (512, 12, 8), "trained_L": (1024, 20, 16)}

# Latent pattern-match channel binning: per-sample max correlation against
# the 10 class patterns, histogrammed over [0, 1].
Q_BINS = 32

# Control-normalised ladder of the mask / latent TV channels: ratios to the
# same instance's 25-NFE control (JAX's thresholds).
TV_CTRL_PASS = 2.0
TV_CTRL_MARGINAL = 3.0
CONTROL_SPEC = "steps=25"
_RANK = {"PASS": 0, "MARGINAL": 1, "FAIL": 2}

NULL_LABEL = 10  # the class-conditional gate models' CFG null class (11 labels)
EMA_RATE = 0.999
WARMUP = 500
WEIGHT_DECAY = 0.03


def _instance() -> str:
    return os.environ.get("QG_INSTANCE", "")


def _instance_seed() -> int:
    """Stable per-instance seed offset: independent instances differ in init,
    data order and noise draws."""
    inst = _instance()
    return zlib.crc32(inst.encode()) % 100000 if inst else 0


def gate_dir() -> str:
    return os.environ.get("QG_DIR", str(DEFAULT_DIR))


def _suffix() -> str:
    return f"_{_instance()}" if _instance() else ""


def _params_path(geo: str) -> str:
    return os.path.join(gate_dir(), f"{geo}{_suffix()}_params.pt")


# --- the synthetic distributions (host numpy, JAX's values) -------------------


def _class_patterns(num_classes=10, size=32):
    """Deterministic per-class smooth 2-D sinusoid latents (C, size, size, 4),
    shared by the image-only and panoptic trained geometries; size 64 is the
    same continuous per-class function on a finer grid."""
    h = np.linspace(0, 2 * np.pi, size, endpoint=False)
    pats = []
    for c in range(num_classes):
        pr = np.random.RandomState(1234 + c)
        chans = []
        for _ in range(4):
            fx, fy = pr.randint(1, 5, 2)
            px, py = pr.uniform(0, 2 * np.pi, 2)
            chans.append(np.outer(np.sin(fx * h + px), np.sin(fy * h + py)))
        pats.append(np.stack(chans, axis=-1))
    return np.stack(pats)


def _structured_batch(rs: np.random.RandomState, batch: int, num_classes=10, size=32):
    """Class-conditional structured latents (B, size, size, 4) and labels:
    each class's pattern at a random amplitude plus noise, a 10-mode
    distribution a small diffusion model learns in minutes."""
    pats = _class_patterns(num_classes, size)
    y = rs.randint(0, num_classes, batch)
    amp = rs.uniform(0.7, 1.3, (batch, 1, 1, 1))
    x0 = amp * pats[y] + 0.25 * rs.normal(size=(batch, size, size, 4))
    return x0.astype(np.float32), y.astype(np.int32)


def _latent_stats(z0, patterns):
    """(class_hist (10,), q_hist (Q_BINS,)) of a channel-last latent batch:
    which class pattern each sample matches best, and how well."""
    z = np.asarray(z0, np.float32).reshape(z0.shape[0], -1)
    z = z - z.mean(axis=1, keepdims=True)
    z /= np.linalg.norm(z, axis=1, keepdims=True) + 1e-9
    p = patterns.reshape(patterns.shape[0], -1).astype(np.float32)
    p = p - p.mean(axis=1, keepdims=True)
    p /= np.linalg.norm(p, axis=1, keepdims=True) + 1e-9
    corr = z @ p.T
    cls = corr.argmax(axis=1)
    q = np.clip(corr.max(axis=1), 0.0, 1.0 - 1e-9)
    class_hist = np.bincount(cls, minlength=patterns.shape[0])
    q_hist = np.bincount((q * Q_BINS).astype(np.int64), minlength=Q_BINS)
    return class_hist.astype(np.int64), q_hist.astype(np.int64)


def _panoptic_geo_dims(geo):
    """(latent grid, mask grid): (32, 64) at 256 res, (64, 128) at 512."""
    return (64, 128) if geo.endswith("512") else (32, 64)


def _panoptic_class_assets(num_classes=10, mask=64, size=32):
    """Per-class (latent pattern, mask-id map, context): the ids quantise the
    pattern's first channel upsampled to the mask grid (background 0 and two
    class-disjoint regions), so image and mask are coupled; the context is
    the class's 'caption embedding'."""
    pats = _class_patterns(num_classes, size)
    masks, ctxs = [], []
    for c in range(num_classes):
        r = mask // size
        up = np.repeat(np.repeat(pats[c, ..., 0], r, axis=0), r, axis=1)
        ids = np.zeros((mask, mask), np.int32)
        ids[up >= 0.3] = 1 + 2 * c
        ids[up <= -0.3] = 2 + 2 * c
        masks.append(ids)
        ctxs.append(np.random.RandomState(5000 + c).normal(size=(77, 768)).astype(np.float32))
    return pats, np.stack(masks), np.stack(ctxs)


def _context_assets(geometry: "Geometry", mask: int, size: int):
    """`_panoptic_class_assets` at `geometry`'s context shape (the gate's is
    77 x 768; a smaller one keeps the leading tokens and features)."""
    pats, masks, ctxs = _panoptic_class_assets(mask=mask, size=size)
    return pats, masks, ctxs[:, :geometry.clip_tokens, :geometry.clip_dim]


# --- the gate models -------------------------------------------------------


@dataclass(frozen=True)
class Geometry:
    """A trained gate geometry: latent grid, network width / depth / heads,
    mask grid and context shape (panoptic), the VAE (None: the SD f8
    KL-VAE, else `AutoencoderKL` kwargs) and the dtype training (autocast
    over f32 parameters) and sampling compute in.
    The gate runs `geometry(geo)`; tests run a tiny one."""

    size: int = 32
    embed_dim: int = 512
    depth: int = 12
    num_heads: int = 8
    mask: int = 64
    clip_dim: int = 768
    clip_tokens: int = 77
    vae: Optional[dict] = None
    dtype: torch.dtype = torch.bfloat16


def geometry(geo: str) -> Geometry:
    if geo in _GEO_SCALE:
        embed, depth, heads = _GEO_SCALE[geo]
        return Geometry(embed_dim=embed, depth=depth, num_heads=heads)
    size, msize = _panoptic_geo_dims(geo)
    return Geometry(size=size, mask=msize)


def _trained_model(gelu, attn_impl="infer", geo="trained", use_checkpoint=False,
                   geo_dims: Optional[Geometry] = None) -> UViT:
    """The class-conditional gate U-ViT (10 classes + the null label 10),
    S/2 ('trained') or L/2 ('trained_L') at 32x32x4; attn_impl 'auto' to
    train, 'infer' to sample (the parameters do not depend on either)."""
    g = geo_dims or geometry(geo)
    return UViT(img_size=g.size, patch_size=2, in_chans=4, embed_dim=g.embed_dim, depth=g.depth,
                num_heads=g.num_heads, num_classes=NULL_LABEL + 1, attn_impl=attn_impl,
                gelu_approx=gelu, use_checkpoint=use_checkpoint)


def _trained_panoptic_model(gelu, attn_impl="infer", use_checkpoint=False,
                            geo="trained_panoptic", geo_dims: Optional[Geometry] = None):
    """The dual-stream gate model: mscoco_uvit_small's geometry (S/2, mask
    64, separate zero convs), or mscoco_uvit_small_512's for
    'trained_panoptic_512'."""
    g = geo_dims or geometry(geo)
    return UViTT2I(img_size=g.size, patch_size=2, in_chans=4, embed_dim=g.embed_dim,
                   depth=g.depth, num_heads=g.num_heads, clip_dim=g.clip_dim,
                   num_clip_token=g.clip_tokens, mask_bits=8, mask_size=g.mask,
                   enable_panoptic=True, separate=True, attn_impl=attn_impl, gelu_approx=gelu,
                   use_checkpoint=use_checkpoint)


class GateTrainer:
    """One optimizer step of a gate model, JAX's recipe: the f32 parameters
    under bf16 autocast (`dtype`), AdamW (optax's, `train/state.py`) with a
    linear warm-up over 500 updates to `lr` and weight decay 0.03, the EMA at
    0.999.  `step` takes channel-last latents, the labels or contexts, the
    panoptic ids (B, H, W, 1) for a dual-stream model, and optionally the
    draws `n`, `eps` (and `eps_m`), else draws them from `generator`."""

    def __init__(self, model, lr: float, device, dtype=torch.bfloat16, seed: int = 0):
        self.device = torch.device(device)
        self.model = model.to(self.device).train()
        self.panoptic = isinstance(model, UViTT2I)
        self.dtype = dtype
        self.schedule = Schedule(stable_diffusion_beta_schedule())
        self.state = TrainState(model, make_lr_schedule(lr, "customized", warmup_steps=WARMUP),
                                weight_decay=WEIGHT_DECAY)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    def _fn(self, cond):
        model = self.model
        if self.panoptic:
            def fn(xn, t, mask_token=None, use_ground_truth=False):
                eps, mask = model(xn.permute(0, 3, 1, 2), t, cond,
                                  mask_token=mask_token.permute(0, 3, 1, 2),
                                  use_ground_truth=use_ground_truth)
                return eps.permute(0, 2, 3, 1), mask.permute(0, 2, 3, 1)
        else:
            def fn(xn, t):
                return model(xn.permute(0, 3, 1, 2), t, cond).permute(0, 2, 3, 1)
        return fn

    def step(self, x0, cond, pan=None, draws: Optional[dict] = None):
        """(loss_eps, loss_mask) for a dual-stream model, else (loss,), as
        device tensors (not synchronised)."""
        draws = {k: v.to(self.device) for k, v in (draws or {}).items()}
        x0, cond = x0.to(self.device), cond.to(self.device)
        for p in self.state.params.values():
            p.grad = None
        g = None if "eps" in draws else self.generator
        with torch.autocast(self.device.type, dtype=self.dtype,
                            enabled=self.dtype != torch.float32):
            if self.panoptic:
                le, lm = l_simple_panoptic(x0, self._fn(cond), self.schedule, pan.to(self.device),
                                           mask_bits=8, n=draws.get("n"), eps=draws.get("eps"),
                                           eps_m=draws.get("eps_m"), generator=g)
                parts = (le.mean(), lm.mean())
            else:
                parts = (l_simple(x0, self._fn(cond), self.schedule, n=draws.get("n"),
                                  eps=draws.get("eps"), generator=g).mean(),)
        sum(parts).backward()
        self.state.apply_gradients(ema_rate=EMA_RATE)
        return tuple(p.detach() for p in parts)

    def save_ema(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        torch.save({k: v.detach().cpu() for k, v in self.state.ema.items()}, path)


def _train_loop(trainer: GateTrainer, batches: Callable, seconds: float, geo: str,
                max_steps: Optional[int], names) -> int:
    t0 = time.perf_counter()
    i, parts = 0, None
    while time.perf_counter() - t0 < seconds and (max_steps is None or i < max_steps):
        parts = trainer.step(*batches())
        if i % 100 == 0:  # a sync every 100 steps; the loop stays queued otherwise
            print(f"  step {i}: " + " ".join(f"{n} {float(v):.4f}" for n, v in zip(names, parts))
                  + f" ({time.perf_counter() - t0:.0f}s)", flush=True)
        i += 1
    path = _params_path(geo)
    trainer.save_ema(path)
    last = " ".join(f"{n} {float(v):.4f}" for n, v in zip(names, parts)) if parts else "-"
    print(f"trained {i} steps, final {last} -> {path}")
    return i


def train_gate_model(seconds: float = 600.0, batch: int = 64, geo="trained", device="cuda",
                     geo_dims: Optional[Geometry] = None,
                     max_steps: Optional[int] = None) -> GateTrainer:
    """Train the class-conditional gate model on the structured distribution
    (labels dropped to the null class at 0.1 for CFG) for `seconds` (or
    `max_steps`), EMA the parameters, save them to `_params_path(geo)`.
    trained_L trains with remat, at lr 1e-4 (QG_LR)."""
    device = require_device(device, "quality_gate")
    g = geo_dims or geometry(geo)
    iseed = _instance_seed()
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(iseed)
        model = _trained_model(False, attn_impl="auto", geo=geo,
                               use_checkpoint=geo == "trained_L", geo_dims=g)
    lr = float(os.environ.get("QG_LR", "1e-4" if geo == "trained_L" else "2e-4"))
    trainer = GateTrainer(model, lr, device, g.dtype, seed=42 + iseed)
    rs = np.random.RandomState(iseed)

    def batches():
        x0, y = _structured_batch(rs, batch, size=g.size)
        y[rs.uniform(size=batch) < 0.1] = NULL_LABEL  # unconditional dropout for CFG
        return (torch.from_numpy(x0).to(device, non_blocking=True),
                torch.from_numpy(y.astype(np.int64)).to(device, non_blocking=True))

    trainer.steps = _train_loop(trainer, batches, seconds, geo, max_steps, ("loss",))
    return trainer


def train_gate_panoptic(seconds: float = 900.0, batch: int = 32, geo: str = "trained_panoptic",
                        device="cuda", geo_dims: Optional[Geometry] = None,
                        max_steps: Optional[int] = None) -> GateTrainer:
    """Train the dual-stream gate model on the coupled (latent, mask,
    context) distribution with the panoptic loss (`l_simple_panoptic`: eps
    MSE + analog-bit mask regression), remat on, contexts dropped to zeros
    at 0.1; EMA the parameters, save them."""
    device = require_device(device, "quality_gate")
    g = geo_dims or geometry(geo)
    iseed = _instance_seed()
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(iseed)
        model = _trained_panoptic_model(False, attn_impl="auto", use_checkpoint=True, geo=geo,
                                        geo_dims=g)
    trainer = GateTrainer(model, 2e-4, device, g.dtype, seed=42 + iseed)
    pats, masks, ctxs = _context_assets(g, g.mask, g.size)
    rs = np.random.RandomState(iseed)

    def batches():
        y = rs.randint(0, len(pats), batch)
        amp = rs.uniform(0.7, 1.3, (batch, 1, 1, 1))
        x0 = amp * pats[y] + 0.25 * rs.normal(size=(batch, g.size, g.size, 4))
        ctx = ctxs[y].copy()
        ctx[rs.uniform(size=batch) < 0.1] = 0.0  # p_uncond dropout for CFG
        return (torch.from_numpy(x0.astype(np.float32)).to(device, non_blocking=True),
                torch.from_numpy(ctx).to(device, non_blocking=True),
                torch.from_numpy(masks[y][..., None].astype(np.int64)).to(device,
                                                                          non_blocking=True))

    trainer.steps = _train_loop(trainer, batches, seconds, geo, max_steps,
                                ("loss_eps", "loss_mask"))
    return trainer


# --- the sampling pipelines ---------------------------------------------------


def _batch_seed(seed: int, i: int) -> int:
    return int(np.random.SeedSequence([seed, i]).generate_state(1)[0])


class GatePipeline:
    """A geometry's sampler for one spec: `cond(i)` is the conditioning of
    batch i (the same for every spec), `noise(seed, i)` its NCHW initial
    draws from a `torch.Generator` seeded by (seed, i), and the call
    (cond, z, m) -> (images in [-1, 1], pred_mask or None, z0 or None),
    channel-last f32 on the device.  The tests feed their own noise."""

    def __init__(self, run, cond, z_shape, m_shape, device):
        self.run, self.cond, self.device = run, cond, torch.device(device)
        self.z_shape, self.m_shape = z_shape, m_shape

    def noise(self, seed: int, i: int):
        g = torch.Generator(device=self.device).manual_seed(_batch_seed(seed, i))
        z = torch.randn(self.z_shape, generator=g, device=self.device)
        m = None if self.m_shape is None else torch.randn(self.m_shape, generator=g,
                                                           device=self.device)
        return z, m

    def __call__(self, cond, z, m=None):
        return self.run(cond, z, m)


def _gate_vae(g: Geometry, device):
    """The seeded decode VAE (seed 1): the SD f8 KL-VAE computing in
    `g.dtype`, or `AutoencoderKL(**g.vae)`; its parameters in f32."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(1)
        vae = (get_vae(dtype=g.dtype) if g.vae is None
               else AutoencoderKL(**g.vae, dtype=g.dtype))
    return vae.to(device).eval()


def _load_gate(model, geo: str, device, dtype):
    sd = torch.load(_params_path(geo), map_location="cpu", weights_only=True)
    model.load_state_dict(sd, strict=True)
    return model.to(device, dtype).eval()


def _build_trained(batch, accel, interval, gelu, steps, geo="trained", device="cuda",
                   geo_dims: Optional[Geometry] = None, vae=None) -> GatePipeline:
    """The trained class-conditional model's protocol: CFG scale 0.4 against
    the null label 10 (one 2x batch a guided NFE), order-3 DPM-Solver-fast
    with the speed modes, the VAE decode; z0 feeds the latent channel."""
    device = require_device(device, "quality_gate")
    g = geo_dims or geometry(geo)
    with torch.device("meta"):
        model = _trained_model(gelu, geo=geo, geo_dims=g)
    model = _load_gate(model.to_empty(device="cpu"), geo, device, g.dtype)
    vae = vae if vae is not None else _gate_vae(g, device)
    n_train = Schedule(stable_diffusion_beta_schedule()).N
    cfg_fn = make_cfg_class_cond(lambda xx, tt, yy: model(xx, tt, yy), null_label=NULL_LABEL,
                                 scale=0.4, enabled=True)

    @torch.no_grad()
    def run(y, z, m=None):
        def model_fn(xx, tt, mask_token=None, cfg_on=True):
            return cfg_fn(xx, tt * n_train, y, cfg_on=cfg_on)

        z0 = bench_panoptic_modes.solve(model_fn, z, steps, accel, interval)
        img = vae.decode(z0)
        return img.float().permute(0, 2, 3, 1), None, z0.float().permute(0, 2, 3, 1)

    def cond(i):  # class labels: fixed per batch index, shared by all runs
        return torch.from_numpy(np.random.RandomState(9000 + i).randint(0, 10, size=batch)
                                .astype(np.int64)).to(device)

    return GatePipeline(run, cond, (batch, 4, g.size, g.size), None, device)


def _build_trained_panoptic(batch, accel, interval, gelu, steps, hold=False,
                            geo="trained_panoptic", device="cuda",
                            geo_dims: Optional[Geometry] = None, vae=None) -> GatePipeline:
    """The trained dual-stream model's protocol: t2i CFG at scale 1.0
    against the zero context with the mask extrapolated, the mask-aware
    solver with the speed modes and the mask-guidance hold, the VAE decode."""
    device = require_device(device, "quality_gate")
    g = geo_dims or geometry(geo)
    with torch.device("meta"):
        model = _trained_panoptic_model(gelu, geo=geo, geo_dims=g)
    model = _load_gate(model.to_empty(device="cpu"), geo, device, g.dtype)
    vae = vae if vae is not None else _gate_vae(g, device)
    empty = torch.zeros((g.clip_tokens, g.clip_dim), device=device)
    run = bench_panoptic_modes.t2i_sampler(model, vae, empty, accel, interval, hold, steps)
    _, _, ctxs = _context_assets(g, g.mask, g.size)

    def cond(i):  # class contexts: fixed per batch index, shared by all runs
        y = np.random.RandomState(9000 + i).randint(0, 10, size=batch)
        return torch.from_numpy(ctxs[y]).to(device)

    return GatePipeline(run, cond, (batch, 4, g.size, g.size), (batch, 8, g.mask, g.mask),
                        device)


def _build_imagenet(batch, accel, interval, gelu, steps=50, device="cuda",
                    components=None) -> GatePipeline:
    """The headline protocol through the port bench (`scripts/bench.py`:
    U-ViT-L/2 from seed 0, bf16, CFG 0.4 with the null class 1000, the bf16
    VAE); images only."""
    from . import bench

    device = require_device(device, "quality_gate")
    components = components or bench.build_components(device)
    pipe = bench.build_pipeline(components, accel=accel, cfg_interval=tuple(interval or ()),
                                gelu=gelu)

    def run(y, z, m=None):
        img, _ = pipe.sample(z, None, y, steps=steps)
        return img.float().permute(0, 2, 3, 1), None, None

    def cond(i):  # class labels: fixed per batch index, shared by all runs
        return torch.from_numpy(np.random.RandomState(9000 + i).randint(0, 1000, size=batch)
                                .astype(np.int64)).to(device)

    h, w, c = pipe.config.z_shape
    return GatePipeline(run, cond, (batch, c, h, w), None, device)


def _build_panoptic(batch, accel, interval, gelu, large, hold=False, device="cuda"):
    """The untrained panoptic protocol through `bench_panoptic_modes.build`
    (S/2, or the L geometry), contexts drawn per batch index."""
    run, z_shape, m_shape = bench_panoptic_modes.build(
        batch, accel, interval, gelu, hold, geo="large" if large else "256", device=device)

    def cond(i):  # CLIP-shaped contexts: fixed per batch index, shared by all runs
        return torch.from_numpy(np.random.RandomState(7000 + i).normal(size=(batch, 77, 768))
                                .astype(np.float32)).to(device)

    return GatePipeline(run, cond, z_shape, m_shape, device)


def parse_spec(spec):
    """spec -> (accel, interval, gelu, steps, hold)"""
    if spec.startswith("exact"):
        return 0.0, None, False, 50, False
    kind, _, val = spec.partition("=")
    if kind == "steps":  # positive control: an off-protocol NFE count the gate must flag
        return 0.0, None, False, int(val), False
    if kind == "gelu":
        return 0.0, None, True, 50, False
    if kind == "accel":
        return float(val), None, False, 50, False
    if kind == "gelu_accel":  # the interval-free combo (the panoptic recommendation)
        return float(val), None, True, 50, False
    if kind == "interval":
        return 0.0, tuple(float(v) for v in val.split(",")), False, 50, False
    if kind == "ihold":  # interval + the mask-guidance hold
        return 0.0, tuple(float(v) for v in val.split(",")), False, 50, True
    if kind in ("combo", "full", "full_hold"):
        tau, _, iv = val.partition(":")
        return (float(tau), tuple(float(v) for v in iv.split(",")),
                kind in ("full", "full_hold"), 50, kind == "full_hold")
    raise SystemExit(f"unknown spec {spec!r}")


def build_pipeline(geo, spec, batch, device="cuda", geo_dims: Optional[Geometry] = None,
                   vae=None) -> GatePipeline:
    """The sampler of `spec` at `geo`."""
    accel, interval, gelu, steps, hold = parse_spec(spec)
    if geo == "imagenet":
        assert not hold, "mask-hold specs need a panoptic geometry"
        return _build_imagenet(batch, accel, interval, gelu, steps, device)
    if geo in ("trained", "trained_L"):
        assert not hold, "mask-hold specs need a panoptic geometry"
        return _build_trained(batch, accel, interval, gelu, steps, geo, device, geo_dims, vae)
    if geo.startswith("trained_panoptic"):
        return _build_trained_panoptic(batch, accel, interval, gelu, steps, hold, geo, device,
                                       geo_dims, vae)
    assert steps == 50, "steps=<n> controls need a trained geometry's sampler"
    return _build_panoptic(batch, accel, interval, gelu, geo == "panoptic_large", hold, device)


def _extractor(device):
    from ..evaluation.inception import from_state_dict, make_extractor, random_state_dict

    return make_extractor(from_state_dict(random_state_dict(0)), device=device)


def _mask_hist(pm) -> np.ndarray:
    bits = (np.asarray(pm) > 0.0).astype(np.int64)  # (B, H, W, 8)
    ids = np.zeros(bits.shape[:3], np.int64)
    for b in range(8):
        ids = ids * 2 + bits[..., b]
    return np.bincount(ids.ravel(), minlength=256)


def run_spec(geo, spec, out_dir, n, batch, device="cuda", geo_dims: Optional[Geometry] = None,
             vae=None, extractor=None) -> dict:
    """Sample `n` images of `spec` at `geo` (a multiple of `batch`), extract
    their features and write `<spec>.npz` in `out_dir`; returns its fields
    and the seconds of sampling and feature extraction (card time,
    synchronised)."""
    device = require_device(device, "quality_gate")
    pipeline = build_pipeline(geo, spec, batch, device, geo_dims, vae)
    extractor = extractor or _extractor(device)
    seed = SEEDS.get(spec, MODE_SEED)
    if n % batch:
        print(f"QG_N={n} is not a multiple of QG_BATCH={batch}: "
              f"running {n - n % batch} samples (the recorded n matches)")
        n -= n % batch
    feats, mask_hist = [], np.zeros(256, np.int64)
    latent_class = np.zeros(10, np.int64)
    latent_q = np.zeros(Q_BINS, np.int64)
    have_latents = False
    size = (geo_dims or geometry(geo)).size if geo.startswith("trained") else 32
    patterns = _class_patterns(size=size)
    debug = os.environ.get("QG_DEBUG", "")
    sample_s = 0.0
    sync(device)
    t0 = time.perf_counter()
    for i in range(n // batch):
        tb = time.perf_counter()
        img, pm, z0 = pipeline(pipeline.cond(i), *pipeline.noise(seed, i))
        sync(device)
        sample_s += time.perf_counter() - tb
        if z0 is not None:
            ch, qh = _latent_stats(z0.cpu().numpy(), patterns)
            latent_class += ch
            latent_q += qh
            have_latents = True
        # decoded images live in [-1, 1]; Inception expects [0, 1]
        img01 = (img * 0.5 + 0.5).clamp(0.0, 1.0)
        feats.append(np.asarray(extractor(img01).cpu(), np.float64))
        if pm is not None:
            mask_hist += _mask_hist(pm.cpu().numpy())
        if debug:
            print(f"  batch {i}: {time.perf_counter() - tb:.2f}s", flush=True)
    wall = time.perf_counter() - t0
    acts = np.concatenate(feats, axis=0)
    fields = dict(
        mu=acts.mean(axis=0), sigma=np.cov(acts, rowvar=False), mask_hist=mask_hist, n=n,
        wall=wall, spec=spec, acts=acts.astype(np.float32),
        latent_class_hist=latent_class if have_latents else np.zeros(0),
        latent_q_hist=latent_q if have_latents else np.zeros(0))
    os.makedirs(out_dir, exist_ok=True)
    np.savez(os.path.join(out_dir, f"{spec.replace(':', '_').replace(',', '-')}.npz"), **fields)
    print(f"{geo}/{spec}: {n} samples in {wall:.1f}s "
          f"({n / wall:.2f} samples/s incl. feature extraction)")
    return dict(fields, sample_s=sample_s, extract_s=wall - sample_s)


# --- the verdicts (host numpy) ---------------------------------------------


def _ladder(ratio):
    return "PASS" if ratio <= 2.0 else ("MARGINAL" if ratio <= 5.0 else "FAIL")


def _ladder_ctrl(ratio):
    return ("PASS" if ratio <= TV_CTRL_PASS
            else ("MARGINAL" if ratio <= TV_CTRL_MARGINAL else "FAIL"))


def _steps_of(name):
    """NFE dose of a `steps=<n>` control spec, else None."""
    if name.startswith("steps="):
        return int(name.split("=", 1)[1])
    return None


def _arm_channels(channel_verdicts):
    """{mode: {channel: verdict}} -> {channel: {armed, control_verdict,
    armed_at_steps}}; armed_at_steps is the largest failing sub-control
    dose."""
    channels = sorted({c for ch in channel_verdicts.values() for c in ch})
    out = {}
    for c in channels:
        ctrl_v = channel_verdicts.get(CONTROL_SPEC, {}).get(c)
        fails = [s for name, ch in channel_verdicts.items()
                 if (s := _steps_of(name)) is not None and s < 25 and ch.get(c) == "FAIL"]
        out[c] = {"armed": ctrl_v in ("PASS", "MARGINAL") and bool(fails),
                  "control_verdict": ctrl_v,
                  "armed_at_steps": max(fails) if fails else None}
    return out


def _load_runs(out_dir) -> dict:
    runs = {}
    for fname in sorted(os.listdir(out_dir)):
        if not fname.endswith(".npz"):
            continue
        with np.load(os.path.join(out_dir, fname)) as f:
            runs[str(f["spec"])] = {
                "mu": f["mu"], "sigma": f["sigma"], "mask_hist": f["mask_hist"],
                "n": int(f["n"]), "acts": f["acts"] if "acts" in f else None,
                "latent_class_hist": (f["latent_class_hist"] if "latent_class_hist" in f
                                      else np.zeros(0)),
                "latent_q_hist": f["latent_q_hist"] if "latent_q_hist" in f else np.zeros(0),
            }
    return runs


def _hist_tv(ha, hb):
    return 0.5 * float(np.abs(ha / max(ha.sum(), 1) - hb / max(hb.sum(), 1)).sum())


def report(geo, out_dir):
    """Score every run in `out_dir` against the exact runs' floors, print
    the verdict table and write report.json (JAX's keys and numbers)."""
    runs = _load_runs(out_dir)
    exact = {k: v for k, v in runs.items() if k.startswith("exact")}
    modes = {k: v for k, v in runs.items() if not k.startswith("exact")}
    assert len(exact) >= 2, "need >=2 exact seeds for the noise floor"
    have_acts = all(r["acts"] is not None for r in runs.values())

    def fd(a, b):
        return frechet_distance(a["mu"], a["sigma"], b["mu"], b["sigma"])

    def kd(a, b):
        # half-N subsets, so that the 100 block estimates differ
        sub = max(2, min(len(a["acts"]), len(b["acts"])) // 2)
        return kid(a["acts"], b["acts"], subset_size=sub, n_subsets=100, exclude_matched=True)

    def tv(a, b):
        if a["mask_hist"].sum() == 0:
            return None
        pa = a["mask_hist"] / a["mask_hist"].sum()
        pb = b["mask_hist"] / b["mask_hist"].sum()
        return 0.5 * float(np.abs(pa - pb).sum())

    def ltv(a, b):
        for k in ("latent_class_hist", "latent_q_hist"):
            if k not in a or k not in b or a[k].size == 0 or b[k].size == 0:
                return None
        return max(_hist_tv(a["latent_class_hist"], b["latent_class_hist"]),
                   _hist_tv(a["latent_q_hist"], b["latent_q_hist"]))

    keys = sorted(exact)
    floor_pairs = [(keys[i], keys[j]) for i in range(len(keys)) for j in range(i + 1, len(keys))]
    fd_floor = float(np.mean([fd(exact[a], exact[b]) for a, b in floor_pairs]))
    kid_floor = None
    if have_acts:
        pair_kids = [kd(exact[a], exact[b]) for a, b in floor_pairs]
        kid_floor = float(max(abs(m) + 2.0 * s for m, s in pair_kids))
    tvs = [tv(exact[a], exact[b]) for a, b in floor_pairs]
    tv_floor = (float(np.mean([t for t in tvs if t is not None]))
                if tvs[0] is not None else None)
    ltvs = [ltv(exact[a], exact[b]) for a, b in floor_pairs]
    ltv_floor = (float(np.mean([t for t in ltvs if t is not None]))
                 if ltvs and ltvs[0] is not None else None)

    # mode runs reuse exactA's seed, so exactA is the paired reference when
    # present; else the first exact run
    ref = exact.get("exactA", exact[keys[0]])
    n = ref["n"]
    print(f"\n=== quality gate: {geo} (N={n}/run, Inception proxy at fixed "
          f"random weights) ===")
    print(f"seed-to-seed floors over {len(floor_pairs)} exact pairs: "
          f"FD {fd_floor:.4f} (bias-dominated at N<D, recorded only)"
          + (f"   KID null scale {kid_floor:.3e}" if kid_floor is not None else "")
          + (f"   mask TV {tv_floor:.5f}" if tv_floor is not None else "")
          + (f"   latent TV {ltv_floor:.5f}" if ltv_floor is not None else ""))
    tv_ctrl = tv(ref, modes[CONTROL_SPEC]) if CONTROL_SPEC in modes else None
    ltv_ctrl = ltv(ref, modes[CONTROL_SPEC]) if CONTROL_SPEC in modes else None
    for nm, c in (("mask", tv_ctrl), ("latent", ltv_ctrl)):
        if c == 0.0:  # a 0.0 control cannot normalise anything
            print(f"WARNING: {nm}-TV 25-NFE control is exactly 0.0 — "
                  "degenerate yardstick; falling back to the floor ladder")
    results = {"geo": geo, "n": n, "instance": _instance() or "default",
               "fd_floor": fd_floor, "kid_floor": kid_floor,
               "tv_floor": tv_floor, "tv_control_25nfe": tv_ctrl,
               "latent_tv_floor": ltv_floor, "latent_tv_control_25nfe": ltv_ctrl,
               "tv_ctrl_thresholds": [TV_CTRL_PASS, TV_CTRL_MARGINAL],
               "modes": {}}
    # Pass 1: per-mode, per-channel entries and channel verdicts.
    channel_verdicts, lines = {}, {}
    for name, run in sorted(modes.items()):
        d = fd(ref, run)
        fd_ratio = d / max(fd_floor, 1e-12)
        entry = {"fd": d, "fd_ratio": fd_ratio}
        ch = {}
        line = f"{name:22s} FD={d:8.4f} ({fd_ratio:4.2f}x)"
        if have_acts:
            km, ks = kd(ref, run)
            kr = max(km, 0.0) / max(kid_floor, 1e-12)
            ch["image"] = _ladder(kr)
            entry.update(kid=km, kid_std=ks, kid_ratio=kr)
            line += f"  KID={km:9.3e}±{ks:.1e} ({kr:5.2f}x floor) {ch['image']}"
        else:  # stats-only runs: the FD channel
            ch["image"] = _ladder(fd_ratio)
            line += f" {ch['image']}"
        m = tv(ref, run)
        entry["mask_tv"] = m
        if m is not None and tv_floor is not None:
            mr = m / max(tv_floor, 1e-12)
            entry["mask_tv_floor_ratio"] = mr
            if tv_ctrl is not None and tv_ctrl > 0.0 and name != CONTROL_SPEC:
                cr = m / tv_ctrl
                ch["mask"] = _ladder_ctrl(cr)
                entry["mask_tv_ctrl_ratio"] = cr
                line += (f"   mask TV={m:.5f} ({mr:5.2f}x floor, "
                         f"{cr:5.2f}x 25-NFE ctrl) {ch['mask']}")
            else:  # no or degenerate control (or this is it): the floor ladder
                ch["mask"] = _ladder(mr)
                line += f"   mask TV={m:.5f} ({mr:5.2f}x floor) {ch['mask']}"
        lm = ltv(ref, run)
        entry["latent_tv"] = lm
        if lm is not None and ltv_floor is not None:
            lr = lm / max(ltv_floor, 1e-12)
            entry["latent_tv_floor_ratio"] = lr
            if ltv_ctrl is not None and ltv_ctrl > 0.0 and name != CONTROL_SPEC:
                lcr = lm / ltv_ctrl
                ch["latent"] = _ladder_ctrl(lcr)
                entry["latent_tv_ctrl_ratio"] = lcr
                line += (f"   latent TV={lm:.5f} ({lr:5.2f}x floor, "
                         f"{lcr:5.2f}x 25-NFE ctrl) {ch['latent']}")
            else:
                ch["latent"] = _ladder(lr)
                line += f"   latent TV={lm:.5f} ({lr:5.2f}x floor) {ch['latent']}"
        entry["channel_verdicts"] = ch
        channel_verdicts[name] = ch
        lines[name] = line
        results["modes"][name] = entry
    # Pass 2: arm the channels from this instance's dose-response, then take
    # each mode's verdict over its armed channels only.
    arming = _arm_channels(channel_verdicts)
    results["channels"] = arming
    results["report_armed"] = any(a["armed"] for a in arming.values())
    for name in sorted(modes):
        ch = channel_verdicts[name]
        if _steps_of(name) is not None:  # the dose controls are the arming evidence
            verdict = max(ch.values(), key=_RANK.get) if ch else "UNARMED"
            results["modes"][name]["role"] = "control"
        else:
            armed_vs = [v for c, v in ch.items() if arming.get(c, {}).get("armed")]
            verdict = max(armed_vs, key=_RANK.get) if armed_vs else "UNARMED"
        results["modes"][name]["verdict"] = verdict
        print(f"{lines[name]}   => {verdict}")
    armed_desc = ", ".join(
        f"{c}:{'ARMED@' + str(a['armed_at_steps']) + 'NFE' if a['armed'] else 'unarmed'}"
        for c, a in arming.items()) or "no channels"
    print(f"channel arming (this instance's NFE dose-response): {armed_desc}")
    if not results["report_armed"]:
        print("WARNING: NO channel is armed on this instance — verdicts are "
              "UNARMED, not PASS (run steps=25 + a sub-25 dose control, or "
              "retrain the instance)")
    out = os.path.join(out_dir, "report.json")
    with open(out, "w") as f:
        json.dump(results, f, indent=1)
    print(f"report -> {out}")
    return results


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    device = next((a.split("=", 1)[1] for a in argv if a.startswith("--device=")), "cuda")
    argv = [a for a in argv if not a.startswith("--device=")]
    if not argv or argv[0] not in GEOS:
        raise SystemExit(f"usage: quality_gate <geo> <spec|train[=s]|report>... "
                         f"[--device=cpu]; geo one of {GEOS}")
    geo, specs = argv[0], argv[1:]
    out_dir = os.path.join(gate_dir(), geo + _suffix())
    n = int(os.environ.get("QG_N", "1024"))
    batch = int(os.environ.get("QG_BATCH", "32"))
    for spec in specs:
        if spec == "report":
            report(geo, out_dir)
        elif spec.startswith("train"):
            _, _, secs = spec.partition("=")
            if geo.startswith("trained_panoptic"):
                train_gate_panoptic(float(secs) if secs else 900.0, batch, geo, device)
            elif geo in _GEO_SCALE:
                train_gate_model(float(secs) if secs else 600.0, geo=geo, device=device)
            else:
                raise SystemExit(f"train: {geo!r} samples seeded random weights; the trained "
                                 f"geometries are {sorted(_GEO_SCALE)} and trained_panoptic*")
        else:
            parse_spec(spec)
            run_spec(geo, spec, out_dir, n, batch, device)


if __name__ == "__main__":
    main()
