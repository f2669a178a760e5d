"""The discrete VP noise schedule for DPM-Solver, a host-side float64 object.

Own copy of the 'discrete' part of
`panopticdiffusionmodels_tpu/samplers/noise_schedule.py::NoiseScheduleVP`:
log alpha_bar = 0.5*cumsum(log(1-beta)) on knots t_i = i/N, piecewise-linear
interpolation with linear extrapolation beyond the outermost knots.  Every
quantity depends on the schedule and the step plan only, never on data.
"""
from __future__ import annotations

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


class NoiseScheduleVP:
    """alpha_t, sigma_t, lambda_t and the inverse lambda -> t map."""

    def __init__(self, schedule: str = "discrete", betas: Optional[np.ndarray] = None,
                 alphas_cumprod: Optional[np.ndarray] = None):
        if schedule != "discrete":
            raise NotImplementedError(
                f"noise schedule {schedule!r} comes with the continuous-SDE slice")
        if betas is not None:
            log_alphas = 0.5 * np.cumsum(np.log(1.0 - np.asarray(betas, np.float64)))
        else:
            log_alphas = 0.5 * np.log(np.asarray(alphas_cumprod, np.float64))
        self.schedule = schedule
        self.total_N = len(log_alphas)
        self.t_discrete = np.linspace(1.0 / self.total_N, 1.0, self.total_N)
        self.log_alpha_discrete = log_alphas
        self.T = 1.0

    def marginal_log_mean_coeff(self, t):
        return interp_with_extrapolation(t, self.t_discrete, self.log_alpha_discrete)

    def marginal_alpha(self, t):
        return np.exp(self.marginal_log_mean_coeff(t))

    def marginal_std(self, t):
        return np.sqrt(np.maximum(1.0 - np.exp(2.0 * self.marginal_log_mean_coeff(t)), 0.0))

    def marginal_lambda(self, t):
        log_mean = self.marginal_log_mean_coeff(t)
        return log_mean - 0.5 * np.log(1.0 - np.exp(2.0 * log_mean))

    def inverse_lambda(self, lamb):
        lamb = np.asarray(lamb, dtype=np.float64)
        log_alpha = -0.5 * np.logaddexp(np.zeros_like(lamb), -2.0 * lamb)
        return interp_with_extrapolation(log_alpha, self.log_alpha_discrete, self.t_discrete)
