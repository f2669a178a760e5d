"""Plain training steps: the discrete-time noise-prediction losses (the
panoptic model's joint image + analog-bit mask loss, the class-conditional
latent loss), f32 gradients and AdamW, as published (Loshchilov & Hutter's
decoupled weight decay, bias-corrected moments, eps outside the root) with
a linear learning-rate warm-up evaluated in float32, then the exponential
moving average of every parameter.

The step's random draws are taken again from a CUDA generator seeded from
(seed, step) by numpy's SeedSequence, in the order the trained system states
for them: the VAE draw z from the latent moments, the timesteps n in
[1, N], the image noise, and for the panoptic model the mask noise (x2).
"""
from __future__ import annotations

import numpy as np
import torch

from . import solver, uvit

MASK_NOISE_SCALE = 2.0
# Top-level modules of the image stream that fine-tuning the panoptic model
# leaves out of the optimizer (reference `train_t2i_discrete.py`).
IMAGE_STREAM = ("patch_embed", "context_embed", "time_embed", "mid_block", "in_blocks",
                "out_blocks")


def step_seed(seed, step):
    return int(np.random.SeedSequence([seed, step]).generate_state(1)[0])


def draws(seed, step, batch, moments_shape, mask_shape, n_train, device):
    """The step's draws for a batch of latent moments (B, h, w, 2C) and, for
    the panoptic model, ids of mask_shape (B, S, S, 1) -> analog bits."""
    g = torch.Generator(device=device).manual_seed(step_seed(seed, step))
    f32 = dict(generator=g, dtype=torch.float32, device=device)
    h, w, c2 = moments_shape
    out = {"z": torch.randn((batch, h, w, c2 // 2), **f32),
           "n": torch.randint(1, n_train + 1, (batch,), generator=g, device=device)}
    out["eps"] = torch.randn((batch, h, w, c2 // 2), **f32)
    if mask_shape is not None:
        s, bits = mask_shape
        out["eps_m"] = MASK_NOISE_SCALE * torch.randn((batch, s, s, bits), **f32)
    return out


def ids_to_analog(ids, bits):
    """(B, S, S, 1) integer ids -> (B, S, S, bits) in {-1, 1}, MSB first."""
    shifts = torch.arange(bits - 1, -1, -1, device=ids.device)
    on = (ids.to(torch.int64) >> shifts) & 1
    return on.reshape(*ids.shape[:-1], bits).float() * 2.0 - 1.0


def sqrt_tables(device):
    betas = np.append(0.0, solver.sd_betas())
    cum = np.cumprod(1.0 - betas)
    return (torch.tensor(np.sqrt(cum), dtype=torch.float32, device=device),
            torch.tensor(np.sqrt(1.0 - cum), dtype=torch.float32, device=device))


def loss(family, w, sizes, batch, d, scale_factor, quant=uvit.identity):
    """The mean loss parts of rows `batch` = (moments, cond[, ids]) with their
    draws: (image,) for the class-conditional model, (image, mask) for the
    panoptic one; the objective is their sum."""
    mean, logvar = batch[0].float().chunk(2, dim=-1)
    z = scale_factor * (mean + torch.exp(0.5 * logvar.clamp(-30.0, 20.0)) * d["z"])
    sa, sb = sqrt_tables(z.device)
    a, b = sa[d["n"]][:, None, None, None], sb[d["n"]][:, None, None, None]
    xn = a * z + b * d["eps"]
    t = d["n"].float()

    def nchw(v):
        return v.permute(0, 3, 1, 2)

    def mos(v):
        return v.reshape(v.shape[0], -1).square().mean(1)

    if family == "uvit":
        pred = uvit.uvit(w, sizes, nchw(xn), t, batch[1].long(), quant=quant)
        return (mos(d["eps"] - pred.permute(0, 2, 3, 1)).mean(),)
    target = ids_to_analog(batch[2], sizes["mask_bits"])
    mask_n = a * target + b * d["eps_m"]
    eps_pred, mask_pred = uvit.uvit_t2i(w, sizes, nchw(xn), t, batch[1].float(), nchw(mask_n),
                                        quant=quant)
    return (mos(d["eps"] - eps_pred.permute(0, 2, 3, 1)).mean(),
            mos(mask_pred.permute(0, 2, 3, 1) - target).mean())


def frozen(names, fine_tune):
    return {n for n in names if fine_tune and n.split(".")[0] in IMAGE_STREAM}


def loss_and_grads(family, w, sizes, batch, d, scale_factor, trained, rows, quant=uvit.identity):
    """(loss parts, {name: grad of their sum}) of the whole batch, run `rows`
    rows at a time: each block's means weighted by its share of the rows."""
    total = batch[0].shape[0]
    grads = {n: torch.zeros_like(w[n]) for n in trained}
    parts = None
    for lo in range(0, total, rows):
        part = tuple(v[lo:lo + rows] for v in batch)
        dp = {k: v[lo:lo + rows] for k, v in d.items()}
        leaves = {n: (w[n].detach().requires_grad_() if n in trained else w[n]) for n in w}
        share = part[0].shape[0] / total
        pieces = [x * share for x in loss(family, leaves, sizes, part, dp, scale_factor, quant)]
        got = torch.autograd.grad(sum(pieces), [leaves[n] for n in trained])
        for n, g in zip(trained, got):
            grads[n] += g
        values = [float(x.detach()) for x in pieces]
        parts = values if parts is None else [a + b for a, b in zip(parts, values)]
    return parts, grads


class AdamW:
    """Decoupled weight decay, then bias-corrected moments."""

    def __init__(self, names, base_lr, warmup, betas, weight_decay, eps=1e-8):
        self.names, self.base_lr, self.warmup = list(names), base_lr, warmup
        self.b1, self.b2 = betas
        self.wd, self.eps = weight_decay, eps
        self.m, self.v, self.k = {}, {}, 0

    def lr(self, count):
        f32 = np.float32
        if self.warmup <= 0:
            return float(self.base_lr)
        return float(f32(self.base_lr) * np.minimum(f32(count) / f32(self.warmup), f32(1.0)))

    def step(self, w, grads):
        lr = self.lr(self.k)
        self.k += 1
        c1, c2 = 1.0 - self.b1 ** self.k, 1.0 - self.b2 ** self.k
        for n in self.names:
            g = grads[n]
            m = self.m.get(n, torch.zeros_like(g)) * self.b1 + (1.0 - self.b1) * g
            v = self.v.get(n, torch.zeros_like(g)) * self.b2 + (1.0 - self.b2) * g * g
            self.m[n], self.v[n] = m, v
            p = w[n] * (1.0 - lr * self.wd)
            w[n] = p - (lr / c1) * m / (v.sqrt() / c2 ** 0.5 + self.eps)


def ema_update(ema, w, rate):
    """ema <- rate * ema + (1 - rate) * w, for every parameter, frozen ones
    too."""
    for n in ema:
        ema[n] = ema[n] * rate + w[n] * (1.0 - rate)
