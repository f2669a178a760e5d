"""PNDM / PLMS sampler of the UNet family.

Port of `panopticdiffusionmodels_tpu/samplers/pndm.py`: Stable Diffusion's
`PNDMScheduler` as the reference samples its `use_unet=True` path with it
(reference `train_t2i_discrete.py:525-534`; 1000 train steps, scaled-linear
betas, `skip_prk_steps=True`, `set_alpha_to_one=False`, `steps_offset=1`,
epsilon prediction).  With `skip_prk_steps=True` PNDM is PLMS: a 4th-order
Adams-Bashforth multistep on the epsilon history with a counter-dependent
warm-up for the first three steps.

Everything counter-dependent is planned on the host into per-row tables
(`make_pndm_plan`, numpy, the JAX tables); the per-row update coefficients
are computed in f64 and cast to f32, as JAX's scan inputs are.  The loop
keeps a 4-deep f32 eps history, the saved sample and an f32 `pred_mask`
whatever the network's dtype.  The panoptic loop passes a FIXED
`mask_token` every evaluation and returns the last `pred_mask`, as the
reference does.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch


class PNDMPlan(NamedTuple):
    """Host-side static plan: one row per model evaluation."""

    timesteps: np.ndarray       # int32 (K,)   t fed to the model
    ts_used: np.ndarray         # int32 (K,)   t used in the update (counter == 1 shifts it)
    prev_ts: np.ndarray         # int32 (K,)   t' of the update target
    coeffs: np.ndarray          # f64 (K, 4)   weights over the eps history [e_t, e_{t-1}, ...]
    use_cur_sample: np.ndarray  # bool (K,)    step 1 restarts from the saved sample
    store_et: np.ndarray        # bool (K,)    push the model output into the history


def make_pndm_plan(num_inference_steps: int, num_train_timesteps: int = 1000,
                   steps_offset: int = 1) -> PNDMPlan:
    """PLMS plan equal to diffusers' PNDMScheduler.set_timesteps + step_plms
    counter logic with skip_prk_steps=True: K = steps + 1 rows."""
    step_ratio = num_train_timesteps // num_inference_steps
    base = (np.arange(0, num_inference_steps) * step_ratio).round().astype(np.int64)
    base = base + steps_offset
    # skip_prk_steps=True: duplicate the second-to-last timestep, reverse.
    plms = np.concatenate([base[:-1], base[-2:-1], base[-1:]])[::-1].copy()

    k_rows = len(plms)
    ts_used = plms.copy()
    prev_ts = plms - step_ratio
    coeffs = np.zeros((k_rows, 4))
    use_cur = np.zeros(k_rows, bool)
    store = np.ones(k_rows, bool)
    n_ets = 0
    for counter, t in enumerate(plms):
        if counter != 1:
            n_ets = min(n_ets, 3) + 1
        else:
            # counter == 1: redo the first interval from the saved sample with
            # the trapezoidal (Heun) average of the two epsilons.
            prev_ts[counter] = t
            ts_used[counter] = t + step_ratio
            store[counter] = False
            use_cur[counter] = True
        if n_ets == 1 and counter == 0:
            coeffs[counter] = [1.0, 0, 0, 0]
        elif n_ets == 1 and counter == 1:
            coeffs[counter] = [0.5, 0.5, 0, 0]  # (new + ets[-1]) / 2
        elif n_ets == 2:
            coeffs[counter] = [3 / 2, -1 / 2, 0, 0]
        elif n_ets == 3:
            coeffs[counter] = [23 / 12, -16 / 12, 5 / 12, 0]
        else:
            coeffs[counter] = [55 / 24, -59 / 24, 37 / 24, -9 / 24]
    return PNDMPlan(plms.astype(np.int32), ts_used.astype(np.int32),
                    prev_ts.astype(np.int32), coeffs, use_cur, store)


def _f32(values) -> list:
    """f64 host values -> Python floats exactly representable in f32."""
    return [float(v) for v in np.asarray(values, np.float64).astype(np.float32)]


def pndm_sample(model_fn: Callable, x: torch.Tensor, steps: int, alphas_cumprod,
                num_train_timesteps: int = 1000, steps_offset: int = 1,
                mask_token: Optional[torch.Tensor] = None):
    """Run the PLMS loop.

    model_fn(x, t[, mask_token=]) -> eps, or (eps, pred_mask) when mask_token
    is given; t is (B,) f32 holding the integer timestep.  `alphas_cumprod`
    is the 1000-entry training table (f64 host numpy, `Schedule.cum_alphas[1:]`).
    Returns the x0-domain latents x (and the last pred_mask, f32, when
    panoptic).  No host sync inside the loop."""
    plan = make_pndm_plan(steps, num_train_timesteps, steps_offset)
    acp = np.asarray(alphas_cumprod, np.float64)
    final_acp = acp[0]  # set_alpha_to_one=False

    def gather(ts):
        return np.array([acp[t] if t >= 0 else final_acp for t in ts])

    a_t, a_prev = gather(plan.ts_used), gather(plan.prev_ts)
    # diffusers _get_prev_sample, epsilon prediction:
    #   x' = sqrt(a'/a) x - (a' - a) eps / [ a sqrt(1-a') + sqrt(a (1-a) a') ]
    sample_coeff = _f32(np.sqrt(a_prev / a_t))
    denom = a_t * np.sqrt(1.0 - a_prev) + np.sqrt(a_t * (1.0 - a_t) * a_prev)
    eps_coeff = _f32((a_prev - a_t) / denom)
    coeffs = [_f32(row) for row in plan.coeffs]

    panoptic = mask_token is not None
    ets = torch.zeros((4, *x.shape), dtype=torch.float32, device=x.device)
    cur = x.float()
    pred_mask = None
    for k in range(len(plan.timesteps)):
        t = torch.full((x.shape[0],), float(plan.timesteps[k]), dtype=torch.float32,
                       device=x.device)
        if panoptic:
            eps, pred_mask = model_fn(x, t, mask_token=mask_token)
            pred_mask = pred_mask.float()
        else:
            eps = model_fn(x, t)
        # the history as the update sees it: the fresh eps first, the past shifted
        # behind it; kept only when store_et (counter 1 blends without recording)
        hist = torch.cat([eps.float()[None], ets[:-1]])
        if plan.store_et[k]:
            ets = hist
        c = coeffs[k]
        model_out = c[0] * hist[0] + c[1] * hist[1] + c[2] * hist[2] + c[3] * hist[3]
        # On the warm-up's second half-step the update starts from the SAVED
        # sample; that same choice is the saved sample of the next step.
        base = cur if plan.use_cur_sample[k] else x.float()
        x = (sample_coeff[k] * base - eps_coeff[k] * model_out).to(x.dtype)
        cur = base
    if panoptic:
        return x, pred_mask
    return x
