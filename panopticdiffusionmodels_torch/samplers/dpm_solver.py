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

The opt-in speed modes of the JAX solver are here too: forecast-skip
(`accel_tau`), the guidance interval (`cfg_interval`) and the mask-guidance
hold.  The JAX solver takes the skip decision on the device with `lax.cond`;
this host loop takes it with an `if` on the same float32 numbers (lambda from
the float32 coefficients, the threshold as float32), so both make the same
decisions and the same number of network evals.  The other methods and the
eps-prediction form come with a later slice and raise here.
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
    (0, 1]; the conversion to data prediction happens here.  With a
    `cfg_interval` it is also passed `cfg_on=`, and under the mask-guidance
    hold a guided masked call gets `want_mask_delta=True` and returns the
    mask's guidance delta as a third output (`diffusion/cfg.py`).

    `real_evals` is the number of network evals the last `sample()` made
    (forecast steps are not evals)."""

    def __init__(self, model_fn: Callable, noise_schedule: NoiseScheduleVP,
                 predict_x0: bool = True, accel_tau: float = 0.0,
                 cfg_interval=None, mask_guidance_hold: bool = False):
        if not predict_x0:
            raise NotImplementedError("eps-prediction DPM-Solver comes with the "
                                      "continuous-SDE slice")
        self.model = model_fn
        self.ns = noise_schedule
        # Forecast-skip: where the logSNR advance since the last real eval is
        # <= accel_tau (and two real evals are cached), the eval is replaced by
        # the linear extrapolation in lambda of the last two real outputs.
        self.accel_tau = float(accel_tau)
        # Guidance interval: CFG only at steps whose start time s lies in
        # [lo, hi]; the other steps run one cond-only forward.
        if cfg_interval is None:
            self.cfg_interval = None
        else:
            if len(cfg_interval) != 2:
                raise ValueError(f"cfg_interval must be (lo, hi), got {tuple(cfg_interval)}")
            lo, hi = float(cfg_interval[0]), float(cfg_interval[1])
            if lo > hi:
                raise ValueError(
                    f"cfg_interval lo must be <= hi, got ({lo}, {hi}) — a reversed"
                    " interval would silently disable guidance at every step")
            self.cfg_interval = (lo, hi)
        # Mask-guidance hold: the mask's guidance delta of the last guided eval
        # is added to the cond-only mask prediction of the unguided steps.
        self.mask_guidance_hold = bool(mask_guidance_hold)
        if self.mask_guidance_hold and self.cfg_interval is None:
            raise ValueError(
                "mask_guidance_hold requires cfg_interval — without an "
                "interval every step is guided and there is nothing to hold")
        self.real_evals = 0

    def _net(self, x, t, sigma_t, alpha_t, mask_token, cfg_on: bool = True):
        """One network eval converted to data prediction: (x0, pred_mask, gd),
        gd the mask's guidance delta on a guided step under the hold, else
        None."""
        self.real_evals += 1
        t_vec = torch.full((x.shape[0],), float(t), dtype=x.dtype, device=x.device)
        kw = {} if self.cfg_interval is None else {"cfg_on": cfg_on}
        gd = None
        if mask_token is None:
            out = self.model(x, t_vec, **kw)
            noise, pred_mask = out if isinstance(out, tuple) else (out, None)
        elif self.mask_guidance_hold and cfg_on:
            noise, pred_mask, gd = self.model(x, t_vec, mask_token=mask_token,
                                              want_mask_delta=True, **kw)
            gd = gd.to(x.dtype)
        else:
            noise, pred_mask = self.model(x, t_vec, mask_token=mask_token, **kw)
        noise = noise.to(x.dtype)  # the carry stays f32 under a bf16 network
        if pred_mask is not None:
            pred_mask = pred_mask.to(x.dtype)
        return (x - noise * float(sigma_t)) / float(alpha_t), pred_mask, gd

    def init_forecast(self, x, mask_token):
        """The solver's cache: the forecast entries under accel_tau (the last
        two real outputs, their lambdas as float32 and the count k of real
        evals behind them), the held guidance delta 'gd' under the hold.
        None when neither mode is on."""
        fc = {}
        if self.accel_tau:
            fc.update(y1=torch.zeros_like(x), y2=torch.zeros_like(x),
                      lam1=F32(0.0), lam2=F32(0.0), k=0)
            if mask_token is not None:
                fc.update(m1=torch.zeros_like(mask_token), m2=torch.zeros_like(mask_token))
        if self.mask_guidance_hold and mask_token is not None:
            # zeros: no correction until the first guided eval fills it
            fc["gd"] = torch.zeros_like(mask_token)
        return fc or None

    def _call_model(self, x, t, sigma_t, alpha_t, mask_token, fc=None, cfg_on: bool = True):
        """A real eval or, under accel_tau, its forecast: (x0, pred_mask, fc')."""
        if fc is None:
            out, pm, _ = self._net(x, t, sigma_t, alpha_t, mask_token, cfg_on)
            return out, pm, None
        has_mask = mask_token is not None
        if self.accel_tau:
            # float32, as the JAX solver computes it from its f32 coefficients
            lam = F32(np.log(F32(alpha_t))) - F32(np.log(F32(sigma_t)))
            if fc["k"] >= 2 and (lam - fc["lam1"]) <= F32(self.accel_tau):
                w = float((lam - fc["lam1"]) / (fc["lam1"] - fc["lam2"]))
                out = fc["y1"] + w * (fc["y1"] - fc["y2"])
                pm = fc["m1"] + w * (fc["m1"] - fc["m2"]) if has_mask else None
                return out, pm, fc
        out, pm, gd = self._net(x, t, sigma_t, alpha_t, mask_token, cfg_on)
        new = dict(fc)
        if has_mask and "gd" in fc:
            if cfg_on:
                new["gd"] = gd
            else:
                pm = pm + fc["gd"]
        if self.accel_tau:
            # m1 / m2 cache the held mask outputs: the forecast extrapolates
            # the trajectory the solver integrates.
            new.update(y1=out, y2=fc["y1"], lam1=lam, lam2=fc["lam1"], k=fc["k"] + 1)
            if has_mask:
                new.update(m1=pm, m2=fc["m1"])
        return out, pm, new

    def _first_update(self, x, c, mask_t, mask_on, fc, cfg_on):
        """Order-1 step (reference `dpm_solver_pp.py:420-494`)."""
        x0, pm, fc = self._call_model(x, c["s"], c["sigma_s"], c["alpha_s"], mask_t, fc, cfg_on)
        a = float(c["sigma_t"] / c["sigma_s"])
        b = float(c["alpha_t"] * -c["phi_1"])
        x_t = x * a + x0 * b
        mask_next = mask_t * a + pm * b if mask_on else mask_t
        return x_t, pm, mask_next, fc

    def _second_update(self, x, c, mask_t, mask_on, fc, cfg_on):
        """Order-2 step (reference `dpm_solver_pp.py:496-599`)."""
        x0, pm, fc = self._call_model(x, c["s"], c["sigma_s"], c["alpha_s"], mask_t, fc, cfg_on)
        a1 = float(c["sigma_s1"] / c["sigma_s"])
        b1 = float(c["alpha_s1"] * c["phi_11"])
        x_s1 = x * a1 - x0 * b1
        # '+' on the intermediate mask step: the reference's own convention
        mask_s1 = mask_t * a1 + pm * b1 if mask_on else mask_t
        x0_s1, pm_s1, fc = self._call_model(x_s1, c["s1"], c["sigma_s1"], c["alpha_s1"],
                                            mask_s1 if mask_t is not None else None, fc, cfg_on)
        a = float(c["sigma_t"] / c["sigma_s"])
        b = float(c["alpha_t"] * c["phi_1"])
        d = float(F32(0.5) / c["r1"] * c["alpha_t"] * c["phi_1"])
        x_t = x * a - x0 * b - (x0_s1 - x0) * d
        mask_next = mask_t * a - pm * b - (pm_s1 - pm) * d if mask_on else mask_t
        return x_t, pm, mask_next, fc

    def _third_update(self, x, c, mask_t, mask_on, fc, cfg_on):
        """Order-3 step (reference `dpm_solver_pp.py:679-829`)."""
        x0, pm, fc = self._call_model(x, c["s"], c["sigma_s"], c["alpha_s"], mask_t, fc, cfg_on)
        a1 = float(c["sigma_s1"] / c["sigma_s"])
        b1 = float(c["alpha_s1"] * c["phi_11"])
        x_s1 = x * a1 - x0 * b1
        mask_s1 = mask_t * a1 + pm * b1 if mask_on else mask_t  # reference sign
        x0_s1, pm_s1, fc = self._call_model(x_s1, c["s1"], c["sigma_s1"], c["alpha_s1"],
                                            mask_s1 if mask_t is not None else None, fc, cfg_on)
        a2 = float(c["sigma_s2"] / c["sigma_s"])
        b2 = float(c["alpha_s2"] * c["phi_12"])
        d2 = float(c["r2"] / c["r1"] * c["alpha_s2"] * c["phi_22"])
        x_s2 = x * a2 - x0 * b2 + (x0_s1 - x0) * d2
        mask_s2 = mask_t * a2 - pm * b2 + (pm_s1 - pm) * d2 if mask_on else mask_t
        x0_s2, pm_s2, fc = self._call_model(x_s2, c["s2"], c["sigma_s2"], c["alpha_s2"],
                                            mask_s2 if mask_t is not None else None, fc, cfg_on)
        a = float(c["sigma_t"] / c["sigma_s"])
        b = float(c["alpha_t"] * c["phi_1"])
        d = float(F32(1.0) / c["r2"] * c["alpha_t"] * c["phi_2"])
        x_t = x * a - x0 * b + (x0_s2 - x0) * d
        mask_next = mask_t * a - pm * b + (pm_s2 - pm) * d if mask_on else mask_t
        return x_t, pm, mask_next, fc

    def _fast_steps(self, steps: int, order: int, skip_type: str, t_0: float, t_T: float):
        """Host, float64: (order, s, t, r1, r2) of each step of the 'fast'
        plan, with r1/r2 from the fine grid (reference :1032-1035)."""
        orders = get_orders_for_fast(steps, order)
        ts = get_time_steps(self.ns, skip_type, t_T, t_0, steps)
        lam = self.ns.marginal_lambda
        out, i = [], 0
        for o in orders:
            s, t = ts[i], ts[i + o]
            h = lam(t) - lam(s)
            r1 = float((lam(ts[i + 1]) - lam(s)) / h) if o > 1 else None
            r2 = float((lam(ts[i + 2]) - lam(s)) / h) if o > 2 else None
            out.append((o, float(s), float(t), r1, r2))
            i += o
        return out

    def build_plan(self, steps: int, order: int, skip_type: str, t_0: float, t_T: float):
        """Host: (order, float32 coefficients) of each step of the 'fast' plan."""
        return [(o, step_coeffs(self.ns, s, t, o, r1, r2))
                for o, s, t, r1, r2 in self._fast_steps(steps, order, skip_type, t_0, t_T)]

    def _cfg_flag(self, s: float) -> bool:
        """Guidance on / off for a step starting at model time s (float64)."""
        if self.cfg_interval is None:
            return True
        lo, hi = self.cfg_interval
        return lo <= s <= hi

    def sample(self, x, steps: int = 50, eps: float = 1e-4, T: Optional[float] = None,
               order: int = 3, method: str = "fast", skip_type: str = "time_uniform",
               mask_token=None):
        """Integrate from t_T to t_0; returns x, or (x, pred_mask) with a mask."""
        if method != "fast":
            raise NotImplementedError(f"method {method!r} comes with the other-samplers slice")
        t_T = self.ns.T if T is None else T
        mask_on = mask_token is not None
        updates = {1: self._first_update, 2: self._second_update, 3: self._third_update}
        self.real_evals = 0
        pred_mask = mask_t = mask_token
        fc = self.init_forecast(x, mask_token)
        prev_cfg = None
        for o, s, t, r1, r2 in self._fast_steps(steps, order, skip_type, eps, t_T):
            cfg_on = self._cfg_flag(s)
            # Where guidance flips, outputs cached under the other protocol
            # must not be extrapolated: real evals until two are cached again
            # (the held delta 'gd' survives the flip: carrying it is its use).
            if fc is not None and "k" in fc and prev_cfg is not None and cfg_on != prev_cfg:
                fc = {**fc, "k": 0}
            prev_cfg = cfg_on
            x, pm, mask_t, fc = updates[o](x, step_coeffs(self.ns, s, t, o, r1, r2), mask_t,
                                           mask_on, fc, cfg_on)
            if mask_on:
                pred_mask = pm
        return (x, pred_mask) if mask_on else x
