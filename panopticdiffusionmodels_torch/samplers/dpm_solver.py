"""Mask-aware DPM-Solver++ ('fast', predict-x0), as a host loop over steps.

Port of `panopticdiffusionmodels_tpu/samplers/dpm_solver.py::DPMSolver` for the
serving path: the mixed-order 'fast' plan, data prediction, and the joint
(x, pred_mask, mask_t) trajectory of the panoptic model.  The schedule math
and every per-step coefficient are computed on the host in float64 and then
rounded to float32, as the JAX package stacks them (`_stack_coeffs`); the
coefficient products are float32 arithmetic too, so the two packages see the
same numbers.  The solver state stays float32 under a bf16 network.

The mask channel keeps the reference's intermediate sign convention: '+' in
front of the data term of mask_s1 where the image update has '-'
(`dpm_solver_pp.py:536-539,730-733`), because it is what produced the paper's
results.

The other methods, the eps-prediction form and the speed modes (accel_tau,
cfg_interval, mask_guidance_hold) come with later slices and raise here.
"""
from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch

from .noise_schedule import NoiseScheduleVP

F32 = np.float32


def get_time_steps(ns: NoiseScheduleVP, skip_type: str, t_T: float, t_0: float, N: int):
    """Host-side step grid (reference `dpm_solver_pp.py:330-363`)."""
    if skip_type == "logSNR":
        lams = np.linspace(ns.marginal_lambda(t_T), ns.marginal_lambda(t_0), N + 1)
        return ns.inverse_lambda(lams)
    if skip_type == "time_uniform":
        return np.linspace(t_T, t_0, N + 1)
    raise NotImplementedError(f"skip_type {skip_type!r} comes with the other-samplers slice")


def get_orders_for_fast(steps: int, order: int) -> List[int]:
    """Mixed-order plan of DPM-Solver-fast (reference `dpm_solver_pp.py:365-405`)."""
    if order == 3:
        k = steps // 3 + 1
        if steps % 3 == 0:
            return [3] * (k - 2) + [2, 1]
        if steps % 3 == 1:
            return [3] * (k - 1) + [1]
        return [3] * (k - 1) + [2]
    if order == 2:
        k = steps // 2
        return [2] * k if steps % 2 == 0 else [2] * k + [1]
    raise ValueError("fast method requires order >= 2")


def step_coeffs(ns: NoiseScheduleVP, s: float, t: float, order: int,
                r1: Optional[float], r2: Optional[float]) -> dict:
    """float64 coefficients of one data-prediction step, rounded to float32."""
    lam_s, lam_t = ns.marginal_lambda(s), ns.marginal_lambda(t)
    h = lam_t - lam_s
    d = dict(s=s, t=t, h=h, sigma_s=ns.marginal_std(s), sigma_t=ns.marginal_std(t),
             alpha_s=ns.marginal_alpha(s), alpha_t=ns.marginal_alpha(t),
             phi_1=np.expm1(-h))
    if order >= 2:
        r1 = (0.5 if order == 2 else 1.0 / 3.0) if r1 is None else r1
        s1 = float(ns.inverse_lambda(lam_s + r1 * h))
        d.update(r1=r1, s1=s1, sigma_s1=ns.marginal_std(s1), alpha_s1=ns.marginal_alpha(s1),
                 phi_11=np.expm1(-r1 * h), phi_2=d["phi_1"] / h + 1.0)
    if order >= 3:
        r2 = 2.0 / 3.0 if r2 is None else r2
        s2 = float(ns.inverse_lambda(lam_s + r2 * h))
        d.update(r2=r2, s2=s2, sigma_s2=ns.marginal_std(s2), alpha_s2=ns.marginal_alpha(s2),
                 phi_12=np.expm1(-r2 * h), phi_22=np.expm1(-r2 * h) / (r2 * h) + 1.0)
    return {k: F32(v) for k, v in d.items()}


class DPMSolver:
    """DPM-Solver++ with joint image + mask trajectories.

    `model_fn(x, t_vec, mask_token=None) -> noise | (noise, pred_mask)` is the
    (CFG-wrapped) network in noise-prediction form on continuous time t in
    (0, 1]; the conversion to data prediction happens here."""

    def __init__(self, model_fn: Callable, noise_schedule: NoiseScheduleVP,
                 predict_x0: bool = True, accel_tau: float = 0.0,
                 cfg_interval=None, mask_guidance_hold: bool = False):
        if not predict_x0:
            raise NotImplementedError("eps-prediction DPM-Solver comes with the "
                                      "continuous-SDE slice")
        if accel_tau or cfg_interval is not None or mask_guidance_hold:
            raise NotImplementedError("accel_tau / cfg_interval / mask_guidance_hold "
                                      "come with the speed-modes slice")
        self.model = model_fn
        self.ns = noise_schedule

    def _net(self, x, t, sigma_t, alpha_t, mask_token):
        """One network eval converted to data prediction; (x0, pred_mask)."""
        t_vec = torch.full((x.shape[0],), float(t), dtype=x.dtype, device=x.device)
        if mask_token is None:
            out = self.model(x, t_vec)
            noise, pred_mask = out if isinstance(out, tuple) else (out, None)
        else:
            noise, pred_mask = self.model(x, t_vec, mask_token=mask_token)
        noise = noise.to(x.dtype)  # the carry stays f32 under a bf16 network
        if pred_mask is not None:
            pred_mask = pred_mask.to(x.dtype)
        return (x - noise * float(sigma_t)) / float(alpha_t), pred_mask

    def _first_update(self, x, c, mask_t, mask_on):
        """Order-1 step (reference `dpm_solver_pp.py:420-494`)."""
        x0, pm = self._net(x, c["s"], c["sigma_s"], c["alpha_s"], mask_t)
        a = float(c["sigma_t"] / c["sigma_s"])
        b = float(c["alpha_t"] * -c["phi_1"])
        x_t = x * a + x0 * b
        mask_next = mask_t * a + pm * b if mask_on else mask_t
        return x_t, pm, mask_next

    def _second_update(self, x, c, mask_t, mask_on):
        """Order-2 step (reference `dpm_solver_pp.py:496-599`)."""
        x0, pm = self._net(x, c["s"], c["sigma_s"], c["alpha_s"], mask_t)
        a1 = float(c["sigma_s1"] / c["sigma_s"])
        b1 = float(c["alpha_s1"] * c["phi_11"])
        x_s1 = x * a1 - x0 * b1
        # '+' on the intermediate mask step: the reference's own convention
        mask_s1 = mask_t * a1 + pm * b1 if mask_on else mask_t
        x0_s1, pm_s1 = self._net(x_s1, c["s1"], c["sigma_s1"], c["alpha_s1"],
                                 mask_s1 if mask_t is not None else None)
        a = float(c["sigma_t"] / c["sigma_s"])
        b = float(c["alpha_t"] * c["phi_1"])
        d = float(F32(0.5) / c["r1"] * c["alpha_t"] * c["phi_1"])
        x_t = x * a - x0 * b - (x0_s1 - x0) * d
        mask_next = mask_t * a - pm * b - (pm_s1 - pm) * d if mask_on else mask_t
        return x_t, pm, mask_next

    def _third_update(self, x, c, mask_t, mask_on):
        """Order-3 step (reference `dpm_solver_pp.py:679-829`)."""
        x0, pm = self._net(x, c["s"], c["sigma_s"], c["alpha_s"], mask_t)
        a1 = float(c["sigma_s1"] / c["sigma_s"])
        b1 = float(c["alpha_s1"] * c["phi_11"])
        x_s1 = x * a1 - x0 * b1
        mask_s1 = mask_t * a1 + pm * b1 if mask_on else mask_t  # reference sign
        x0_s1, pm_s1 = self._net(x_s1, c["s1"], c["sigma_s1"], c["alpha_s1"],
                                 mask_s1 if mask_t is not None else None)
        a2 = float(c["sigma_s2"] / c["sigma_s"])
        b2 = float(c["alpha_s2"] * c["phi_12"])
        d2 = float(c["r2"] / c["r1"] * c["alpha_s2"] * c["phi_22"])
        x_s2 = x * a2 - x0 * b2 + (x0_s1 - x0) * d2
        mask_s2 = mask_t * a2 - pm * b2 + (pm_s1 - pm) * d2 if mask_on else mask_t
        x0_s2, pm_s2 = self._net(x_s2, c["s2"], c["sigma_s2"], c["alpha_s2"],
                                 mask_s2 if mask_t is not None else None)
        a = float(c["sigma_t"] / c["sigma_s"])
        b = float(c["alpha_t"] * c["phi_1"])
        d = float(F32(1.0) / c["r2"] * c["alpha_t"] * c["phi_2"])
        x_t = x * a - x0 * b + (x0_s2 - x0) * d
        mask_next = mask_t * a - pm * b + (pm_s2 - pm) * d if mask_on else mask_t
        return x_t, pm, mask_next

    def build_plan(self, steps: int, order: int, skip_type: str, t_0: float, t_T: float):
        """Host: (order, float32 coefficients) of each step of the 'fast' plan,
        with r1/r2 from the fine grid (reference :1032-1035)."""
        orders = get_orders_for_fast(steps, order)
        ts = get_time_steps(self.ns, skip_type, t_T, t_0, steps)
        lam = self.ns.marginal_lambda
        plan, i = [], 0
        for o in orders:
            s, t = ts[i], ts[i + o]
            h = lam(t) - lam(s)
            r1 = float((lam(ts[i + 1]) - lam(s)) / h) if o > 1 else None
            r2 = float((lam(ts[i + 2]) - lam(s)) / h) if o > 2 else None
            plan.append((o, step_coeffs(self.ns, float(s), float(t), o, r1, r2)))
            i += o
        return plan

    def sample(self, x, steps: int = 50, eps: float = 1e-4, T: Optional[float] = None,
               order: int = 3, method: str = "fast", skip_type: str = "time_uniform",
               mask_token=None):
        """Integrate from t_T to t_0; returns x, or (x, pred_mask) with a mask."""
        if method != "fast":
            raise NotImplementedError(f"method {method!r} comes with the other-samplers slice")
        t_T = self.ns.T if T is None else T
        mask_on = mask_token is not None
        updates = {1: self._first_update, 2: self._second_update, 3: self._third_update}
        pred_mask = mask_t = mask_token
        for o, c in self.build_plan(steps, order, skip_type, eps, t_T):
            x, pm, mask_t = updates[o](x, c, mask_t, mask_on)
            if mask_on:
                pred_mask = pm
        return (x, pred_mask) if mask_on else x
