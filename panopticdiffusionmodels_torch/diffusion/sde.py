"""Continuous-time VP SDEs, the score-model wrapper and the simple loss.

Port of `panopticdiffusionmodels_tpu/diffusion/sde.py` (reference
`sde.py:33-279`):

  * time runs in [0, 1]; the network is called with `t * 999` in float32
    (reference `sde.py:174`), whatever dtype the network computes in;
  * `cum_alpha` / `cum_beta` are the mean and variance coefficients of
    q(x_t | x_0);
  * `pred` is 'noise_pred' or 'x0_pred'.

Every method takes t as a tensor, (B,) or 0-d, and computes in its dtype.
Random draws come from an explicit `torch.Generator`, or are passed in.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from .math import mos, stp


def get_sde(name: str, **kwargs):
    if name == "vpsde":
        return VPSDE(**kwargs)
    if name == "vpsde_cosine":
        return VPSDECosine(**kwargs)
    raise NotImplementedError(name)


class SDE:
    """dx = f(x, t) dt + g(t) dw, 0 <= t <= 1."""

    def drift(self, x, t):
        raise NotImplementedError

    def diffusion(self, t):
        raise NotImplementedError

    def cum_beta(self, t):
        raise NotImplementedError

    def cum_alpha(self, t):
        raise NotImplementedError

    def snr(self, t):
        raise NotImplementedError

    def nsr(self, t):
        raise NotImplementedError

    def marginal_prob(self, x0, t):
        """Mean and std of q(x_t | x_0)."""
        return stp(self.cum_alpha(t).sqrt(), x0), self.cum_beta(t).sqrt()

    def sample(self, x0, t_init: float = 0.0, *, t=None, eps=None,
               generator: Optional[torch.Generator] = None):
        """(t, eps, x_t) with t ~ U(t_init, 1) for each batch element and eps
        standard normal, both drawn from `generator` unless passed in."""
        if t is None:
            t = torch.rand((x0.shape[0],), generator=generator, dtype=x0.dtype,
                           device=x0.device) * (1.0 - t_init) + t_init
        if eps is None:
            eps = torch.randn(x0.shape, generator=generator, dtype=x0.dtype, device=x0.device)
        mean, std = self.marginal_prob(x0, t)
        return t, eps, mean + stp(std, eps)


class VPSDE(SDE):
    """Linear-beta VP SDE (reference `sde.py:72-113`) on beta in [0.1, 20]."""

    beta_0 = 0.1
    beta_1 = 20.0

    def drift(self, x, t):
        return -0.5 * stp(self.squared_diffusion(t), x)

    def diffusion(self, t):
        return self.squared_diffusion(t).sqrt()

    def squared_diffusion(self, t):  # beta(t)
        return self.beta_0 + t * (self.beta_1 - self.beta_0)

    def squared_diffusion_integral(self, s, t):  # \int_s^t beta(tau) dtau
        return self.beta_0 * (t - s) + (self.beta_1 - self.beta_0) * (t ** 2 - s ** 2) * 0.5

    def skip_alpha(self, s, t):
        return torch.exp(-self.squared_diffusion_integral(s, t))

    def skip_beta(self, s, t):
        return 1.0 - self.skip_alpha(s, t)

    def cum_beta(self, t):
        return self.skip_beta(0.0, t)

    def cum_alpha(self, t):
        return self.skip_alpha(0.0, t)

    def nsr(self, t):
        return torch.expm1(self.squared_diffusion_integral(0.0, t))

    def snr(self, t):
        return 1.0 / self.nsr(t)

    def __repr__(self):
        return f"vpsde beta_0={self.beta_0} beta_1={self.beta_1}"


class VPSDECosine(SDE):
    """Cosine VP SDE (reference `sde.py:116-152`)."""

    def __init__(self, s: float = 0.008):
        self.s = s
        self.F0 = math.cos(s / (1 + s) * math.pi / 2) ** 2

    def _angle(self, t):
        return (t + self.s) / (1 + self.s) * math.pi / 2

    def _F(self, t):
        return torch.cos(self._angle(t)) ** 2

    def drift(self, x, t):
        return stp(-torch.tan(self._angle(t)) / (1 + self.s) * math.pi / 2, x)

    def diffusion(self, t):
        return (torch.tan(self._angle(t)) / (1 + self.s) * math.pi).sqrt()

    def cum_beta(self, t):
        return 1.0 - self.cum_alpha(t)

    def cum_alpha(self, t):
        return self._F(t) / self.F0

    def snr(self, t):
        ft = self._F(t)
        return ft / (self.F0 - ft)

    def nsr(self, t):
        return self.F0 / self._F(t) - 1.0

    def __repr__(self):
        return "vpsde_cosine"


class ScoreModel:
    """A network in the noise / x0 / score parameterisations.

    `nnet_fn(x, t_scaled, **kwargs) -> pred` receives `t * 999` (reference
    `sde.py:174`)."""

    def __init__(self, nnet_fn: Callable, pred: str, sde: SDE):
        self.nnet_fn = nnet_fn
        self.pred = pred
        self.sde = sde

    def predict(self, xt, t, **kwargs):
        t = torch.as_tensor(t, dtype=xt.dtype, device=xt.device)
        if t.dim() == 0:
            t = t.expand(xt.shape[0])
        return self.nnet_fn(xt, t * 999.0, **kwargs)

    def noise_pred(self, xt, t, **kwargs):
        pred = self.predict(xt, t, **kwargs)
        if self.pred == "noise_pred":
            return pred
        if self.pred == "x0_pred":
            return -stp(self.sde.snr(t).sqrt(), pred) + stp(self.sde.cum_beta(t).rsqrt(), xt)
        raise NotImplementedError(self.pred)

    def x0_pred(self, xt, t, **kwargs):
        pred = self.predict(xt, t, **kwargs)
        if self.pred == "noise_pred":
            return stp(self.sde.cum_alpha(t).rsqrt(), xt) - stp(self.sde.nsr(t).sqrt(), pred)
        if self.pred == "x0_pred":
            return pred
        raise NotImplementedError(self.pred)

    def score(self, xt, t, **kwargs):
        cum_beta = self.sde.cum_beta(t)
        return stp(-cum_beta.rsqrt(), self.noise_pred(xt, t, **kwargs))


class ReverseSDE:
    """dx = [f - g^2 s] dt + g dw (reference `sde.py:202-217`)."""

    def __init__(self, score_model: ScoreModel):
        self.sde = score_model.sde
        self.score_model = score_model

    def drift(self, x, t, **kwargs):
        drift = self.sde.drift(x, t)
        diffusion = self.sde.diffusion(t)
        score = self.score_model.score(x, t, **kwargs)
        return drift - stp(diffusion ** 2, score)

    def diffusion(self, t):
        return self.sde.diffusion(t)


class ODE:
    """Probability-flow ODE: dx = [f - 0.5 g^2 s] dt (reference `sde.py:220-236`)."""

    def __init__(self, score_model: ScoreModel):
        self.sde = score_model.sde
        self.score_model = score_model

    def drift(self, x, t, **kwargs):
        drift = self.sde.drift(x, t)
        diffusion = self.sde.diffusion(t)
        score = self.score_model.score(x, t, **kwargs)
        return drift - 0.5 * stp(diffusion ** 2, score)

    def diffusion(self, t):
        return 0.0


def l_simple(score_model: ScoreModel, x0, pred: str = "noise_pred", *, t=None, eps=None,
             generator: Optional[torch.Generator] = None, **kwargs):
    """Per-example simple loss, shape (B,) (reference `sde.py:270-279`); t
    and eps are drawn from `generator` unless passed in."""
    t, noise, xt = score_model.sde.sample(x0, t=t, eps=eps, generator=generator)
    if pred == "noise_pred":
        return mos(noise - score_model.noise_pred(xt, t, **kwargs))
    if pred == "x0_pred":
        return mos(x0 - score_model.x0_pred(xt, t, **kwargs))
    raise NotImplementedError(pred)
