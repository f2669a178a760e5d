"""Euler-Maruyama integrator of the reverse SDE or the probability-flow ODE.

Port of `panopticdiffusionmodels_tpu/samplers/euler_maruyama.py` (reference
`sde.py:243-267`) as a Python loop over the host grid
`append(0, linspace(1e-3, 1, N))`, walked in descending (s, t) pairs.  The
grid is float64 on the host and cast to x's dtype, as the JAX package casts
it; the last step (s = 0) adds no noise.  One normal a step is drawn from a
`torch.Generator` on x's device.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..diffusion.sde import ODE


def em_step(rsde, x, s, t, noise=None, **model_kwargs):
    """One step from time t down to s (0-d tensors of x's dtype): the drift
    step, plus diffusion * sqrt(t - s) * noise when noise is given."""
    drift = rsde.drift(x, t, **model_kwargs)
    diffusion = rsde.diffusion(t)
    dt = s - t  # negative
    mean = x + drift * dt
    if noise is None:
        return mean
    return mean + diffusion * torch.sqrt(-dt) * noise


def euler_maruyama(rsde, x_init, sample_steps: int,
                   generator: Optional[torch.Generator] = None, **model_kwargs):
    """Integrate `rsde` (`diffusion.sde.ReverseSDE` or `ODE`) from T = 1 to
    0 on the grid append(0, linspace(1e-3, 1, sample_steps)); the ODE draws
    no noise."""
    timesteps = np.append(0.0, np.linspace(1e-3, 1.0, sample_steps))
    s_arr = timesteps[:-1][::-1].copy()  # target times, descending pairs
    noise_on = s_arr != 0.0  # the step to s = 0 is mean only
    s_all = torch.as_tensor(s_arr, dtype=x_init.dtype, device=x_init.device)
    t_all = torch.as_tensor(timesteps[1:][::-1].copy(), dtype=x_init.dtype,
                            device=x_init.device)
    noisy = not isinstance(rsde, ODE)
    x = x_init
    for i in range(sample_steps):
        noise = None
        if noisy and noise_on[i]:
            noise = torch.randn(x.shape, generator=generator, dtype=x.dtype, device=x.device)
        x = em_step(rsde, x, s_all[i], t_all[i], noise, **model_kwargs)
    return x
