"""Plain DPM-Solver++ 'fast' (order 3, data prediction) on the discrete
Stable-Diffusion schedule, with the panoptic mask carried beside the image
(Lu et al., arXiv:2211.01095; the mask channel of the panoptic model keeps
the reference implementation's '+' in front of the data term of the first
intermediate mask state).  Host coefficients in float64, state in float32.

`model(x, t_model, mask)` returns (noise, mask prediction) or, without a
mask, the noise; t_model is the continuous time t in (0, 1] times N.
"""
from __future__ import annotations

import numpy as np
import torch

N_TRAIN = 1000


def sd_betas(n=N_TRAIN, start=0.00085, end=0.0120):
    """Stable Diffusion's scaled-linear betas."""
    return np.linspace(start ** 0.5, end ** 0.5, n, dtype=np.float64) ** 2


class DiscreteVP:
    """alpha_t, sigma_t, lambda_t of the discrete schedule on knots i / N,
    linear between knots and beyond the outermost ones."""

    def __init__(self, betas):
        self.log_alpha = 0.5 * np.cumsum(np.log(1.0 - betas))
        self.t = np.linspace(1.0 / len(betas), 1.0, len(betas))

    @staticmethod
    def _interp(x, xp, yp):
        if xp[0] > xp[-1]:
            xp, yp = xp[::-1], yp[::-1]
        i = np.clip(np.searchsorted(xp, x, side="right") - 1, 0, len(xp) - 2)
        return yp[i] + (x - xp[i]) * (yp[i + 1] - yp[i]) / (xp[i + 1] - xp[i])

    def log_alpha_at(self, t):
        return float(self._interp(np.float64(t), self.t, self.log_alpha))

    def alpha(self, t):
        return float(np.exp(self.log_alpha_at(t)))

    def sigma(self, t):
        return float(np.sqrt(1.0 - np.exp(2.0 * self.log_alpha_at(t))))

    def lam(self, t):
        la = self.log_alpha_at(t)
        return la - 0.5 * float(np.log(1.0 - np.exp(2.0 * la)))

    def t_of_lam(self, lam):
        la = -0.5 * np.logaddexp(0.0, -2.0 * lam)
        return float(self._interp(np.float64(la), self.log_alpha, self.t))


def fast_plan(steps, order=3):
    """The orders of DPM-Solver-fast: as many third-order steps as fit, then
    one of the remainder (or 2 + 1 when 3 divides the steps)."""
    k = steps // 3 + 1
    if steps % 3 == 0:
        return [3] * (k - 2) + [2, 1]
    if steps % 3 == 1:
        return [3] * (k - 1) + [1]
    return [3] * (k - 1) + [2]


def sample(model, ns, x, mask, steps=50, t_end=1.0 / N_TRAIN, t_start=1.0):
    """Integrate (x, mask) from t_start to t_end on the uniform time grid;
    returns (x, the mask prediction of the last step's first eval) or x."""
    grid = np.linspace(t_start, t_end, steps + 1)
    pred_mask = mask

    def data(xx, t, m):
        out = model(xx, torch.full((xx.shape[0],), t * N_TRAIN, device=xx.device), m)
        noise, pm = out if isinstance(out, tuple) else (out, None)
        x0 = (xx - noise.float() * ns.sigma(t)) / ns.alpha(t)
        return x0, None if pm is None else pm.float()

    i = 0
    for o in fast_plan(steps):
        s, t = grid[i], grid[i + o]
        h = ns.lam(t) - ns.lam(s)
        phi1 = np.expm1(-h)
        a = ns.sigma(t) / ns.sigma(s)
        out, pm = data(x, s, mask)
        pred_mask = pm
        if o == 1:
            b = -ns.alpha(t) * phi1
            x_new = x * a + out * b
            m_new = None if mask is None else mask * a + pm * b
        else:
            r1 = (ns.lam(grid[i + 1]) - ns.lam(s)) / h
            s1 = ns.t_of_lam(ns.lam(s) + r1 * h)
            a1 = ns.sigma(s1) / ns.sigma(s)
            b1 = ns.alpha(s1) * np.expm1(-r1 * h)
            x1 = x * a1 - out * b1
            m1 = None if mask is None else mask * a1 + pm * b1
            out1, pm1 = data(x1, s1, m1)
            b = ns.alpha(t) * phi1
            if o == 2:
                d = 0.5 / r1 * ns.alpha(t) * phi1
                x_new = x * a - out * b - (out1 - out) * d
                m_new = None if mask is None else mask * a - pm * b - (pm1 - pm) * d
            else:
                r2 = (ns.lam(grid[i + 2]) - ns.lam(s)) / h
                s2 = ns.t_of_lam(ns.lam(s) + r2 * h)
                a2 = ns.sigma(s2) / ns.sigma(s)
                b2 = ns.alpha(s2) * np.expm1(-r2 * h)
                phi22 = np.expm1(-r2 * h) / (r2 * h) + 1.0
                d2 = r2 / r1 * ns.alpha(s2) * phi22
                x2 = x * a2 - out * b2 + (out1 - out) * d2
                m2 = None if mask is None else mask * a2 - pm * b2 + (pm1 - pm) * d2
                out2, pm2 = data(x2, s2, m2)
                d = 1.0 / r2 * ns.alpha(t) * (phi1 / h + 1.0)
                x_new = x * a - out * b + (out2 - out) * d
                m_new = None if mask is None else mask * a - pm * b + (pm2 - pm) * d
        x, mask = x_new, m_new
        i += o
    return x if mask is None else (x, pred_mask)
