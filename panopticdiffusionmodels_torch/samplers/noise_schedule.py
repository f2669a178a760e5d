"""The VP noise schedules of DPM-Solver, a host-side float64 object.

Own copy of `panopticdiffusionmodels_tpu/samplers/noise_schedule.py::NoiseScheduleVP`:

  * 'discrete': log alpha_bar = 0.5*cumsum(log(1-beta)) on knots t_i = i/N,
    piecewise-linear interpolation with linear extrapolation beyond the
    outermost knots;
  * 'linear': the closed-form VP SDE on DDPM's beta range (BETA_0, BETA_1),
    T = 1;
  * 'cosine': the improved-DDPM cosine schedule, T = 0.9946.

Every quantity depends on the schedule and the step plan only, never on data.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np


def interp_with_extrapolation(x, xp, yp):
    """Piecewise-linear interpolation, extrapolating the outermost segments;
    xp strictly monotonic."""
    x = np.asarray(x, dtype=np.float64)
    xp = np.asarray(xp, dtype=np.float64)
    yp = np.asarray(yp, dtype=np.float64)
    if xp[0] > xp[-1]:
        xp, yp = xp[::-1], yp[::-1]
    idx = np.clip(np.searchsorted(xp, x, side="right") - 1, 0, len(xp) - 2)
    x0, x1 = xp[idx], xp[idx + 1]
    y0, y1 = yp[idx], yp[idx + 1]
    return y0 + (x - x0) * (y1 - y0) / (x1 - x0)


# The linear schedule's beta range: DDPM's per-step 1e-4 and 2e-2, times 1000
# for continuous time.
BETA_0 = 0.1
BETA_1 = 20.0


class NoiseScheduleVP:
    """alpha_t, sigma_t, lambda_t and the inverse lambda -> t map."""

    def __init__(self, schedule: str = "discrete", betas: Optional[np.ndarray] = None,
                 alphas_cumprod: Optional[np.ndarray] = None):
        if schedule not in ("linear", "discrete", "cosine"):
            raise ValueError(f"unsupported noise schedule {schedule}")
        self.schedule = schedule
        if schedule == "discrete":
            if betas is not None:
                log_alphas = 0.5 * np.cumsum(np.log(1.0 - np.asarray(betas, np.float64)))
            else:
                log_alphas = 0.5 * np.log(np.asarray(alphas_cumprod, np.float64))
            self.t_discrete = np.linspace(1.0 / len(log_alphas), 1.0, len(log_alphas))
            self.log_alpha_discrete = log_alphas
        self.cosine_s = 0.008
        self.cosine_beta_max = 999.0
        self.cosine_t_max = (math.atan(self.cosine_beta_max * (1.0 + self.cosine_s) / math.pi)
                             * 2.0 * (1.0 + self.cosine_s) / math.pi - self.cosine_s)
        self.cosine_log_alpha_0 = math.log(
            math.cos(self.cosine_s / (1.0 + self.cosine_s) * math.pi / 2.0))
        self.T = 0.9946 if schedule == "cosine" else 1.0

    def marginal_log_mean_coeff(self, t):
        t = np.asarray(t, dtype=np.float64)
        if self.schedule == "linear":
            return -0.25 * t ** 2 * (BETA_1 - BETA_0) - 0.5 * t * BETA_0
        if self.schedule == "discrete":
            return interp_with_extrapolation(t, self.t_discrete, self.log_alpha_discrete)
        log_alpha = np.log(np.cos((t + self.cosine_s) / (1.0 + self.cosine_s) * math.pi / 2.0))
        return log_alpha - self.cosine_log_alpha_0

    def marginal_alpha(self, t):
        return np.exp(self.marginal_log_mean_coeff(t))

    def marginal_std(self, t):
        return np.sqrt(np.maximum(1.0 - np.exp(2.0 * self.marginal_log_mean_coeff(t)), 0.0))

    def marginal_lambda(self, t):
        log_mean = self.marginal_log_mean_coeff(t)
        return log_mean - 0.5 * np.log(1.0 - np.exp(2.0 * log_mean))

    def inverse_lambda(self, lamb):
        lamb = np.asarray(lamb, dtype=np.float64)
        if self.schedule == "linear":
            tmp = 2.0 * (BETA_1 - BETA_0) * np.logaddexp(-2.0 * lamb, np.zeros_like(lamb))
            return tmp / (np.sqrt(BETA_0 ** 2 + tmp) + BETA_0) / (BETA_1 - BETA_0)
        if self.schedule == "discrete":
            log_alpha = -0.5 * np.logaddexp(np.zeros_like(lamb), -2.0 * lamb)
            return interp_with_extrapolation(log_alpha, self.log_alpha_discrete,
                                             self.t_discrete)
        log_alpha = -0.5 * np.logaddexp(-2.0 * lamb, np.zeros_like(lamb))
        return (np.arccos(np.exp(log_alpha + self.cosine_log_alpha_0)) * 2.0
                * (1.0 + self.cosine_s) / math.pi - self.cosine_s)
