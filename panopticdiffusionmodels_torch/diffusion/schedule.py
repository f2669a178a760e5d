"""The discrete diffusion schedule (host float64 numpy).

Port of the sampling half of `panopticdiffusionmodels_tpu/diffusion/schedule.py`;
`Schedule.sample` and the losses come with the training slice.
"""
from __future__ import annotations

import numpy as np


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
