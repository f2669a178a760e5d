"""The discrete diffusion schedule and the panoptic co-training losses.

Port of `panopticdiffusionmodels_tpu/diffusion/schedule.py`: the tables are
built on the host in float64 numpy and looked up on the device as float32,
as the JAX package does.  Tensors are channel-last like the JAX package's
(latents (B, h, w, C), analog-bit masks (B, H, W, bits)), so a test can hand
both sides the same arrays; the trainer transposes at the model boundary.

Every random draw of `Schedule.sample` (the timestep n, the image noise eps,
the mask noise eps_m) can be passed in; what is not passed is drawn from the
given `torch.Generator`.  The losses are per example, shape (B,).
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .analog_bits import ints_to_analog
from .math import mos, stp

# Std multiplier of the analog-bit mask noise, so that it can flip bits
# (reference `train_t2i_discrete.py:137`).
MASK_NOISE_SCALE = 2.0


def stable_diffusion_beta_schedule(linear_start: float = 0.00085, linear_end: float = 0.0120,
                                   n_timestep: int = 1000) -> np.ndarray:
    """Sqrt-linear SD betas (reference `train_t2i_discrete.py:40-44`)."""
    return np.linspace(linear_start ** 0.5, linear_end ** 0.5, n_timestep,
                       dtype=np.float64) ** 2


class Schedule:
    """Discrete-time schedule: betas[0] = 0, betas[1..N] given."""

    def __init__(self, _betas: np.ndarray):
        self._betas = np.asarray(_betas, dtype=np.float64)
        self.betas = np.append(0.0, self._betas)
        self.alphas = 1.0 - self.betas
        self.N = len(self._betas)
        self.cum_alphas = np.cumprod(self.alphas)
        # cum_betas[t] = sum_{k<=t} betas[k] * prod(alphas[k+1..t]) = Var[x_t | x_0]
        cum_betas = np.zeros_like(self.cum_alphas)
        acc = 0.0
        for t in range(1, self.N + 1):
            acc = acc * self.alphas[t] + self.betas[t]
            cum_betas[t] = acc
        self.cum_betas = cum_betas
        self._tables = {}

    def _sqrt_tables(self, device):
        """sqrt of the float32 cum_alphas / cum_betas tables on `device`."""
        key = str(device)
        if key not in self._tables:
            self._tables[key] = tuple(
                torch.sqrt(torch.as_tensor(t, dtype=torch.float32, device=device))
                for t in (self.cum_alphas, self.cum_betas))
        return self._tables[key]

    def sample(self, x0: torch.Tensor, panoptic: Optional[torch.Tensor] = None, *,
               n: Optional[torch.Tensor] = None, eps: Optional[torch.Tensor] = None,
               eps_m: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None):
        """n ~ U{1..N} per example and the noisy (x_n [, mask_n]).

        Returns (n, eps, xn) or (n, eps, xn, eps_m, mask_n); `panoptic` is the
        analog-bit mask in [-1, 1] and eps_m already carries the x2.0 scale."""
        dev = x0.device
        if n is None:
            n = torch.randint(1, self.N + 1, (x0.shape[0],), generator=generator, device=dev)
        if eps is None:
            eps = torch.randn(x0.shape, generator=generator, dtype=x0.dtype, device=dev)
        sa, sb = self._sqrt_tables(dev)
        n = torch.as_tensor(n, device=dev).long()
        a, b = sa[n].to(x0.dtype), sb[n].to(x0.dtype)
        xn = stp(a, x0) + stp(b, eps)
        if panoptic is None:
            return n, eps, xn
        if eps_m is None:
            eps_m = MASK_NOISE_SCALE * torch.randn(panoptic.shape, generator=generator,
                                                   dtype=panoptic.dtype, device=dev)
        mask_n = stp(a.to(panoptic.dtype), panoptic) + stp(b.to(panoptic.dtype), eps_m)
        return n, eps, xn, eps_m, mask_n

    def __repr__(self):
        return f"Schedule({self.betas[:5]}..., N={self.N})"


def l_simple(x0: torch.Tensor, nnet_fn: Callable, schedule: Schedule, *, n=None, eps=None,
             generator: Optional[torch.Generator] = None, **kwargs) -> torch.Tensor:
    """Per-example noise-prediction MSE of the non-panoptic discrete models."""
    n, eps, xn = schedule.sample(x0, n=n, eps=eps, generator=generator)
    return mos(eps - nnet_fn(xn, n.to(x0.dtype), **kwargs))


def l_simple_panoptic(x0: torch.Tensor, nnet_fn: Callable, schedule: Schedule,
                      panoptic: torch.Tensor, mask_bits: int = 8,
                      use_ground_truth: bool = False, use_twophases: bool = False, *,
                      n=None, eps=None, eps_m=None,
                      generator: Optional[torch.Generator] = None):
    """Joint image + panoptic-mask loss: (loss_eps, loss_mask), each (B,).

    `panoptic` is the integer id map (B, H, W, 1), analog-bit encoded here;
    `nnet_fn(xn, n, mask_token=..., use_ground_truth=...)` returns
    (eps_pred, mask_pred).  As in the JAX package, the reference's `mask_gt`
    branch is not replicated (the network never reads its extra input) and
    `use_ground_truth` / `use_twophases` are static config."""
    scaled = ints_to_analog(panoptic, n=mask_bits, dtype=x0.dtype)
    n, eps, xn, eps_m, mask_n = schedule.sample(x0, scaled, n=n, eps=eps, eps_m=eps_m,
                                                generator=generator)
    t = n.to(x0.dtype)
    if use_ground_truth:
        eps_pred, mask_pred = nnet_fn(xn, t, mask_token=scaled, use_ground_truth=True)
    else:
        eps_pred, mask_pred = nnet_fn(xn, t, mask_token=mask_n, use_ground_truth=False)
    loss_eps = mos(eps - eps_pred)
    if use_twophases and not use_ground_truth:
        # Phase two: the same noisy image with the ground-truth mask features
        # merged in; the two eps losses are averaged.
        eps_pred2, _ = nnet_fn(xn, t, mask_token=scaled, use_ground_truth=True)
        loss_eps = 0.5 * (loss_eps + mos(eps - eps_pred2))
    if use_ground_truth:
        return loss_eps, loss_eps
    # x0-style analog-bit regression target (reference `train_t2i_discrete.py:209`).
    return loss_eps, mos(mask_pred - scaled)
