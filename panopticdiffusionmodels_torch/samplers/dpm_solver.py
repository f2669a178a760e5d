"""Mask-aware DPM-Solver / DPM-Solver++, as a host loop over steps.

Port of `panopticdiffusionmodels_tpu/samplers/dpm_solver.py::DPMSolver`: the
joint (x, pred_mask, mask_t) trajectory of the panoptic model, data (x0) or
noise (eps) prediction, and every method of the JAX solver:

  * 'fast': the mixed-order plan with r1 / r2 from the fine grid;
  * 'fast_upstream': the same orders on a coarse grid with the default r1 /
    r2 (the continuous-time models' protocol);
  * 'singlestep': one order throughout, with a lower-order remainder step
    that keeps the full NFE budget;
  * 'multistep' (image only, warm-up with rising orders);
  * 'adaptive' (image only, a step size driven by an error estimate read
    back to the host every iteration; the lower and higher candidate steps
    share their evals).

Options: `thresholding` (each sample's x0 clipped to the 0.995 quantile of
|x0|, at least 1, then scaled to `max_val`), `solver_type='taylor'`,
`denoise` (a final x0 projection) and `update_mask=False` (the mask
conditions every call but is not integrated).  The schedule math and every
per-step coefficient are computed on the host in float64 and then rounded to
float32, as the JAX package stacks them (`_stack_coeffs`); the coefficient
products are float32 arithmetic too, so the two packages see the same
numbers.  The solver state stays float32 under a bf16 network.

The mask channel keeps the reference's intermediate sign convention: '+' in
front of the data term of mask_s1 where the image update has '-'
(`dpm_solver_pp.py:536-539,730-733`), because it is what produced the paper's
results.

The opt-in speed modes of the JAX solver are here too: forecast-skip
(`accel_tau`), the guidance interval (`cfg_interval`) and the mask-guidance
hold.  The JAX solver takes the skip decision on the device with `lax.cond`;
this host loop takes it with an `if` on the same float32 numbers (lambda from
the float32 coefficients, the threshold as float32), so both make the same
decisions and the same number of network evals.
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
    if skip_type == "t2":
        return np.linspace(t_T ** 0.5, t_0 ** 0.5, N + 1) ** 2
    if skip_type == "time_quadratic":
        t = np.linspace(t_0, t_T, 10_000_000)
        quadratic_t = np.sqrt(t)
        quadratic_steps = np.linspace(quadratic_t[0], quadratic_t[-1], N + 1)
        picked = t[np.searchsorted(quadratic_t, quadratic_steps)[:-1]]
        return np.concatenate([picked, [t_T]])[::-1].copy()
    raise ValueError(f"unsupported skip_type {skip_type}")


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
                r1: Optional[float], r2: Optional[float], predict_x0: bool = True) -> dict:
    """float64 coefficients of one step, rounded to float32; the phi terms of
    data prediction, or their noise-prediction duals."""
    lam_s, lam_t = ns.marginal_lambda(s), ns.marginal_lambda(t)
    h = lam_t - lam_s
    log_a_s, log_a_t = ns.marginal_log_mean_coeff(s), ns.marginal_log_mean_coeff(t)
    d = dict(s=s, t=t, h=h, sigma_s=ns.marginal_std(s), sigma_t=ns.marginal_std(t),
             alpha_s=np.exp(log_a_s), alpha_t=np.exp(log_a_t),
             log_alpha_s=log_a_s, log_alpha_t=log_a_t)
    sign = -1.0 if predict_x0 else 1.0
    d["phi_1"] = np.expm1(sign * h)
    if order >= 2:
        r1 = (0.5 if order == 2 else 1.0 / 3.0) if r1 is None else r1
        s1 = float(ns.inverse_lambda(lam_s + r1 * h))
        log_a_s1 = ns.marginal_log_mean_coeff(s1)
        d.update(r1=r1, s1=s1, sigma_s1=ns.marginal_std(s1), alpha_s1=np.exp(log_a_s1),
                 log_alpha_s1=log_a_s1, phi_11=np.expm1(sign * r1 * h),
                 phi_2=d["phi_1"] / h - sign)
    if order >= 3:
        r2 = 2.0 / 3.0 if r2 is None else r2
        s2 = float(ns.inverse_lambda(lam_s + r2 * h))
        log_a_s2 = ns.marginal_log_mean_coeff(s2)
        d.update(r2=r2, s2=s2, sigma_s2=ns.marginal_std(s2), alpha_s2=np.exp(log_a_s2),
                 log_alpha_s2=log_a_s2, phi_12=np.expm1(sign * r2 * h),
                 phi_22=np.expm1(sign * r2 * h) / (r2 * h) - sign, phi_3=d["phi_2"] / h - 0.5)
    return {k: F32(v) for k, v in d.items()}


def quantile_rows(a: torch.Tensor, q: float) -> torch.Tensor:
    """The q-quantile of each row of a 2-D tensor with linear interpolation
    between the two nearest ranks (`jnp.quantile`'s default), through a sort:
    `torch.quantile` refuses inputs past 2**24 elements."""
    n = a.shape[1]
    pos = F32(q) * F32(n - 1)
    lo, hi = int(np.floor(pos)), int(np.ceil(pos))
    w = float(pos - F32(lo))
    srt = a.sort(dim=1).values
    return srt[:, lo] * (1.0 - w) + srt[:, hi] * w


class DPMSolver:
    """DPM-Solver(++) with joint image + mask trajectories.

    `model_fn(x, t_vec, mask_token=None) -> noise | (noise, pred_mask)` is the
    (CFG-wrapped) network in noise-prediction form on continuous time t in
    (0, 1]; with `predict_x0` the conversion to data prediction happens here.
    With a `cfg_interval` it is also passed `cfg_on=`, and under the
    mask-guidance hold a guided masked call gets `want_mask_delta=True` and
    returns the mask's guidance delta as a third output (`diffusion/cfg.py`).

    `real_evals` is the number of network evals the last `sample()` made
    (forecast steps are not evals)."""

    def __init__(self, model_fn: Callable, noise_schedule: NoiseScheduleVP,
                 predict_x0: bool = True, thresholding: bool = False, max_val: float = 1.0,
                 solver_type: str = "dpm_solver", accel_tau: float = 0.0,
                 cfg_interval=None, mask_guidance_hold: bool = False):
        if solver_type not in ("dpm_solver", "taylor"):
            raise ValueError(f"solver_type must be 'dpm_solver' or 'taylor', got {solver_type!r}")
        self.model = model_fn
        self.ns = noise_schedule
        self.predict_x0 = predict_x0
        self.thresholding = thresholding
        self.max_val = max_val
        self.solver_type = solver_type
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
        """One network eval: (out, pred_mask, gd), out the noise or, with
        predict_x0, the (optionally thresholded) data prediction; gd the
        mask's guidance delta on a guided step under the hold, else None."""
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
        if not self.predict_x0:
            return noise, pred_mask, gd
        x0 = (x - noise * float(sigma_t)) / float(alpha_t)
        if self.thresholding:
            s = quantile_rows(x0.abs().reshape(x0.shape[0], -1), 0.995)
            s = s.clamp_min(1.0).reshape(-1, *(1,) * (x0.dim() - 1))
            x0 = torch.minimum(torch.maximum(x0, -s), s) / (s / self.max_val)
        return x0, pred_mask, gd

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
        """A real eval or, under accel_tau, its forecast: (out, pred_mask, fc')."""
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

    def _memo_eval(self, evals, tag, *args):
        """`_call_model`, memoized in `evals` under `tag` for the adaptive
        pair: its lower- and higher-order candidate steps share their common
        evals.  evals=None is a plain call."""
        if evals is not None and tag in evals:
            return evals[tag]
        res = self._call_model(*args)
        if evals is not None:
            evals[tag] = res
        return res

    def _first_update(self, x, c, mask_t, mask_on, fc=None, cfg_on=True, evals=None):
        """Order-1 step (reference `dpm_solver_pp.py:420-494`)."""
        out, pm, fc = self._memo_eval(evals, "s", x, c["s"], c["sigma_s"], c["alpha_s"],
                                      mask_t, fc, cfg_on)
        if not self.predict_x0:
            x_t = (x * float(np.exp(c["log_alpha_t"] - c["log_alpha_s"]))
                   - out * float(c["sigma_t"] * c["phi_1"]))
            return x_t, pm, mask_t, fc
        a = float(c["sigma_t"] / c["sigma_s"])
        b = float(c["alpha_t"] * -c["phi_1"])
        x_t = x * a + out * b
        mask_next = mask_t * a + pm * b if mask_on else mask_t
        return x_t, pm, mask_next, fc

    def _second_update(self, x, c, mask_t, mask_on, fc=None, cfg_on=True, evals=None):
        """Order-2 step (reference `dpm_solver_pp.py:496-599`)."""
        out, pm, fc = self._memo_eval(evals, "s", x, c["s"], c["sigma_s"], c["alpha_s"],
                                      mask_t, fc, cfg_on)
        if not self.predict_x0:
            x_s1 = (x * float(np.exp(c["log_alpha_s1"] - c["log_alpha_s"]))
                    - out * float(c["sigma_s1"] * c["phi_11"]))
            out_s1, _, fc = self._memo_eval(evals, "s1", x_s1, c["s1"], c["sigma_s1"],
                                            c["alpha_s1"], mask_t, fc, cfg_on)
            a = float(np.exp(c["log_alpha_t"] - c["log_alpha_s"]))
            b = float(c["sigma_t"] * c["phi_1"])
            if self.solver_type == "taylor":  # reference `dpm_solver_pp.py:584-589`
                d = float(F32(1.0) / c["r1"] * c["sigma_t"] * c["phi_2"])
            else:
                d = float(F32(0.5) / c["r1"] * c["sigma_t"] * c["phi_1"])
            return x * a - out * b - (out_s1 - out) * d, pm, mask_t, fc
        a1 = float(c["sigma_s1"] / c["sigma_s"])
        b1 = float(c["alpha_s1"] * c["phi_11"])
        x_s1 = x * a1 - out * b1
        # '+' on the intermediate mask step: the reference's own convention
        mask_s1 = mask_t * a1 + pm * b1 if mask_on else mask_t
        out_s1, pm_s1, fc = self._memo_eval(evals, "s1", x_s1, c["s1"], c["sigma_s1"],
                                            c["alpha_s1"], mask_s1, fc, cfg_on)
        a = float(c["sigma_t"] / c["sigma_s"])
        b = float(c["alpha_t"] * c["phi_1"])
        d = float(F32(0.5) / c["r1"] * c["alpha_t"] * c["phi_1"])
        if self.solver_type == "taylor":  # reference `dpm_solver_pp.py:559-564`
            x_t = x * a - out * b + (out_s1 - out) * float(F32(1.0) / c["r1"] * c["alpha_t"]
                                                           * c["phi_2"])
        else:
            x_t = x * a - out * b - (out_s1 - out) * d
        mask_next = mask_t * a - pm * b - (pm_s1 - pm) * d if mask_on else mask_t
        return x_t, pm, mask_next, fc

    def _taylor_d(self, out, out_s1, out_s2, c):
        """The first and second divided differences of the order-3 Taylor
        step (reference `dpm_solver_pp.py:767-777`)."""
        d1_0 = (out_s1 - out) * float(F32(1.0) / c["r1"])
        d1_1 = (out_s2 - out) * float(F32(1.0) / c["r2"])
        rdiff = float(c["r2"] - c["r1"])
        d1 = (d1_0 * float(c["r2"]) - d1_1 * float(c["r1"])) / rdiff
        d2 = 2.0 * (d1_1 - d1_0) / rdiff
        return d1, d2

    def _third_update(self, x, c, mask_t, mask_on, fc=None, cfg_on=True, evals=None):
        """Order-3 step (reference `dpm_solver_pp.py:679-829`)."""
        out, pm, fc = self._memo_eval(evals, "s", x, c["s"], c["sigma_s"], c["alpha_s"],
                                      mask_t, fc, cfg_on)
        if not self.predict_x0:
            x_s1 = (x * float(np.exp(c["log_alpha_s1"] - c["log_alpha_s"]))
                    - out * float(c["sigma_s1"] * c["phi_11"]))
            out_s1, _, fc = self._memo_eval(evals, "s1", x_s1, c["s1"], c["sigma_s1"],
                                            c["alpha_s1"], mask_t, fc, cfg_on)
            x_s2 = (x * float(np.exp(c["log_alpha_s2"] - c["log_alpha_s"]))
                    - out * float(c["sigma_s2"] * c["phi_12"])
                    - (out_s1 - out) * float(c["r2"] / c["r1"] * c["sigma_s2"] * c["phi_22"]))
            out_s2, _, fc = self._memo_eval(evals, "s2", x_s2, c["s2"], c["sigma_s2"],
                                            c["alpha_s2"], mask_t, fc, cfg_on)
            x_t = (x * float(np.exp(c["log_alpha_t"] - c["log_alpha_s"]))
                   - out * float(c["sigma_t"] * c["phi_1"]))
            if self.solver_type == "taylor":  # reference `dpm_solver_pp.py:809-819`
                d1, d2 = self._taylor_d(out, out_s1, out_s2, c)
                x_t = (x_t - d1 * float(c["sigma_t"] * c["phi_2"])
                       - d2 * float(c["sigma_t"] * c["phi_3"]))
            else:
                x_t = x_t - (out_s2 - out) * float(F32(1.0) / c["r2"] * c["sigma_t"]
                                                   * c["phi_2"])
            return x_t, pm, mask_t, fc
        a1 = float(c["sigma_s1"] / c["sigma_s"])
        b1 = float(c["alpha_s1"] * c["phi_11"])
        x_s1 = x * a1 - out * b1
        mask_s1 = mask_t * a1 + pm * b1 if mask_on else mask_t  # reference sign
        out_s1, pm_s1, fc = self._memo_eval(evals, "s1", x_s1, c["s1"], c["sigma_s1"],
                                            c["alpha_s1"], mask_s1, fc, cfg_on)
        a2 = float(c["sigma_s2"] / c["sigma_s"])
        b2 = float(c["alpha_s2"] * c["phi_12"])
        d2 = float(c["r2"] / c["r1"] * c["alpha_s2"] * c["phi_22"])
        x_s2 = x * a2 - out * b2 + (out_s1 - out) * d2
        mask_s2 = mask_t * a2 - pm * b2 + (pm_s1 - pm) * d2 if mask_on else mask_t
        out_s2, pm_s2, fc = self._memo_eval(evals, "s2", x_s2, c["s2"], c["sigma_s2"],
                                            c["alpha_s2"], mask_s2, fc, cfg_on)
        a = float(c["sigma_t"] / c["sigma_s"])
        b = float(c["alpha_t"] * c["phi_1"])
        d = float(F32(1.0) / c["r2"] * c["alpha_t"] * c["phi_2"])
        if self.solver_type == "taylor":
            t1, t2 = self._taylor_d(out, out_s1, out_s2, c)
            x_t = (x * a - out * b + t1 * float(c["alpha_t"] * c["phi_2"])
                   - t2 * float(c["alpha_t"] * c["phi_3"]))
        else:
            x_t = x * a - out * b + (out_s2 - out) * d
        mask_next = mask_t * a - pm * b + (pm_s2 - pm) * d if mask_on else mask_t
        return x_t, pm, mask_next, fc

    def _update(self, order: int):
        return {1: self._first_update, 2: self._second_update, 3: self._third_update}[order]

    def _steps(self, steps: int, order: int, method: str, skip_type: str, t_0: float,
               t_T: float):
        """Host, float64: (order, s, t, r1, r2) of each step of the plan of
        `method` ('fast', 'fast_upstream' or 'singlestep')."""
        if method == "fast":
            # r1 / r2 of each mixed-order step from the fine grid (reference :1032-1035)
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
        if method == "fast_upstream":
            # The upstream plan (reference dpm_solver_pytorch.py:509-588): a
            # coarse grid of one point a step, the default r1 / r2.
            orders = get_orders_for_fast(steps, order)
        elif method == "singlestep":
            # A lower-order remainder step keeps the full `steps` NFE budget.
            k, rem = divmod(steps, order)
            orders = [order] * k + ([rem] if rem else [])
        else:
            raise ValueError(method)
        ts = get_time_steps(self.ns, skip_type, t_T, t_0, len(orders))
        return [(o, float(ts[i]), float(ts[i + 1]), None, None) for i, o in enumerate(orders)]

    def build_plan(self, steps: int, order: int, skip_type: str, t_0: float, t_T: float,
                   method: str = "fast"):
        """Host: (order, float32 coefficients) of each step of the plan."""
        return [(o, step_coeffs(self.ns, s, t, o, r1, r2, self.predict_x0))
                for o, s, t, r1, r2 in self._steps(steps, order, method, skip_type, t_0, t_T)]

    def _cfg_flag(self, s: float) -> bool:
        """Guidance on / off for a step starting at model time s (float64)."""
        if self.cfg_interval is None:
            return True
        lo, hi = self.cfg_interval
        return lo <= s <= hi

    def sample(self, x, steps: int = 50, eps: float = 1e-4, T: Optional[float] = None,
               order: int = 3, method: str = "fast", skip_type: str = "time_uniform",
               mask_token=None, update_mask: bool = True, denoise: bool = False):
        """Integrate from t_T to t_0; returns x, or (x, pred_mask) with a
        mask.  `update_mask=False` (the reference's enable_mask_opt=False):
        the mask conditions every call, but each step hands the model's mask
        prediction on instead of integrating it."""
        t_0 = eps
        t_T = self.ns.T if T is None else T
        mask_on = mask_token is not None and update_mask
        mask_fixed = mask_token is not None and not update_mask
        self.real_evals = 0
        if method in ("adaptive", "multistep"):
            if self.cfg_interval is not None:
                raise ValueError("cfg_interval is supported for the 'fast'/'fast_upstream'/"
                                 "'singlestep' methods only")
            if self.accel_tau:
                raise ValueError(
                    "accel_tau (forecast-skip) is supported for the 'fast'/"
                    "'fast_upstream'/'singlestep' methods only — it would be "
                    "silently inactive here")
            if method == "adaptive":
                x = self._sample_adaptive(x, order, t_T, t_0)
            else:
                x = self._sample_multistep(x, steps, order, skip_type, t_T, t_0)
            return (x, mask_token) if mask_on else x
        pred_mask = mask_t = mask_token
        fc = self.init_forecast(x, mask_token)
        prev_cfg = None
        for o, s, t, r1, r2 in self._steps(steps, order, method, skip_type, t_0, t_T):
            cfg_on = self._cfg_flag(s)
            # Where guidance flips, outputs cached under the other protocol
            # must not be extrapolated: real evals until two are cached again
            # (the held delta 'gd' survives the flip: carrying it is its use).
            if fc is not None and "k" in fc and prev_cfg is not None and cfg_on != prev_cfg:
                fc = {**fc, "k": 0}
            prev_cfg = cfg_on
            c = step_coeffs(self.ns, s, t, o, r1, r2, self.predict_x0)
            x, pm, mask_t, fc = self._update(o)(x, c, mask_t, mask_on, fc, cfg_on)
            if mask_on:
                pred_mask = pm
            elif mask_fixed:
                pred_mask = mask_t = pm
        if denoise:
            x = self._denoise(x, t_0, mask_token=mask_t)
        return (x, pred_mask) if mask_token is not None else x

    def _denoise(self, x, s: float, mask_token=None):
        """Final x0 projection (reference `dpm_solver_pp.py:407-418`)."""
        self.real_evals += 1
        t_vec = torch.full((x.shape[0],), float(s), dtype=x.dtype, device=x.device)
        kw = {} if self.cfg_interval is None else {"cfg_on": self._cfg_flag(s)}
        if mask_token is not None:
            kw["mask_token"] = mask_token
        out = self.model(x, t_vec, **kw)
        noise = (out[0] if isinstance(out, tuple) else out).to(x.dtype)
        return (x - noise * float(self.ns.marginal_std(s))) / float(
            np.exp(self.ns.marginal_log_mean_coeff(s)))

    # --- multistep (image only, reference dpm_solver_pp.py:602-677,995-1017) --

    def _sample_multistep(self, x, steps, order, skip_type, t_T, t_0):
        if steps < order:
            raise ValueError(f"multistep needs steps >= order, got {steps} < {order}")
        ts = get_time_steps(self.ns, skip_type, t_T, t_0, steps)
        log_a = self.ns.marginal_log_mean_coeff(ts)
        tab = dict(ts=ts, lam=self.ns.marginal_lambda(ts), log_a=log_a,
                   sig=self.ns.marginal_std(ts), alpha=np.exp(log_a))

        def call(x, i):
            return self._call_model(x, ts[i], tab["sig"][i], tab["alpha"][i], None)[0]

        # warm-up with rising orders, then fixed-order updates
        prev, idx = [call(x, 0)], [0]
        for init_order in range(1, order):
            x = self._multistep_update(x, prev, idx, init_order, init_order, tab)
            prev.append(call(x, init_order))
            idx.append(init_order)
        for step in range(order, steps + 1):
            x = self._multistep_update(x, prev, idx, step, order, tab)
            prev = prev[1:] + [prev[-1]]
            idx = idx[1:] + [step]
            if step < steps:
                prev[-1] = call(x, step)
        return x

    def _multistep_update(self, x, prev, idx, i, order, tab):
        """One multistep update to grid point i from the cached model outputs
        `prev` at the grid points `idx`; `tab` holds the grid's float64
        schedule values."""
        if order == 1:
            # the order-1 step on the cached output: no eval
            c = step_coeffs(self.ns, float(tab["ts"][idx[-1]]), float(tab["ts"][i]), 1, None,
                            None, self.predict_x0)
            return self._first_update(x, c, None, False, evals={"s": (prev[-1], None, None)})[0]
        lam, log_a, sig, alpha = tab["lam"], tab["log_a"], tab["sig"], tab["alpha"]
        i0, i1 = idx[-1], idx[-2]
        h = lam[i] - lam[i0]
        r0 = (lam[i0] - lam[i1]) / h
        d1_0 = (prev[-1] - prev[-2]) * float(1.0 / r0)
        if self.predict_x0:
            a, b, phi = sig[i] / sig[i0], alpha[i] * np.expm1(-h), np.expm1(-h)
        else:
            a, b, phi = np.exp(log_a[i] - log_a[i0]), sig[i] * np.expm1(h), np.expm1(h)
        x_t = x * float(a) - prev[-1] * float(b)
        if order == 2:
            return x_t - d1_0 * float(F32(0.5) * F32(b))
        # order 3 (reference dpm_solver_pp.py:645-677)
        r1 = (lam[i1] - lam[idx[-3]]) / h
        d1_1 = (prev[-2] - prev[-3]) * float(1.0 / r1)
        d1 = d1_0 + (d1_0 - d1_1) * float(r0 / (r0 + r1))
        d2 = (d1_0 - d1_1) * float(1.0 / (r0 + r1))
        if self.predict_x0:
            return (x_t + d1 * float(alpha[i] * (phi / h + 1.0))
                    - d2 * float(alpha[i] * ((phi + h) / h ** 2 - 0.5)))
        return (x_t - d1 * float(sig[i] * (phi / h - 1.0))
                - d2 * float(sig[i] * ((phi - h) / h ** 2 - 0.5)))

    # --- adaptive (host loop; dynamic NFE, reference dpm_solver_pp.py:873-925) --

    def _sample_adaptive(self, x, order, t_T, t_0, h_init=0.05, atol=0.0078, rtol=0.05,
                         theta=0.9, t_err=1e-5):
        """Adaptive step size: the error of the lower- against the
        higher-order candidate is read back to the host every iteration."""
        if order == 2:
            lower, higher = dict(order=1), dict(order=2, r1=0.5)
        elif order == 3:
            lower, higher = dict(order=2, r1=1.0 / 3.0), dict(order=3, r1=1.0 / 3.0,
                                                                 r2=2.0 / 3.0)
        else:
            raise ValueError("adaptive solver order must be 2 or 3")
        s = t_T
        lam_s = float(self.ns.marginal_lambda(s))
        lam_0 = float(self.ns.marginal_lambda(t_0))
        h = h_init
        x_prev = x
        while abs(s - t_0) > t_err:
            t = float(self.ns.inverse_lambda(np.array(lam_s + h)))
            evals = {}
            x_lower = self._run_single(x, s, t, evals=evals, **lower)
            x_higher = self._run_single(x, s, t, evals=evals, **higher)
            delta = torch.clamp_min(rtol * torch.maximum(x_lower.abs(), x_prev.abs()), atol)
            err = float(((x_higher - x_lower) / delta).square().reshape(x.shape[0], -1)
                        .mean(dim=-1).sqrt().max())
            if err <= 1.0:
                x, s, x_prev = x_higher, t, x_lower
                lam_s = float(self.ns.marginal_lambda(s))
            h = min(theta * h * max(err, 1e-10) ** (-1.0 / order), lam_0 - lam_s)
        return x

    def _run_single(self, x, s, t, order, r1=None, r2=None, evals=None):
        c = step_coeffs(self.ns, float(s), float(t), order, r1, r2, self.predict_x0)
        return self._update(order)(x, c, None, False, evals=evals)[0]
