"""Classifier-free guidance as one 2x-batch forward: t2i / panoptic and
class-conditional.

Port of `panopticdiffusionmodels_tpu/diffusion/cfg.py::make_cfg_t2i` and
`::make_cfg_class_cond`.  The mask
prediction is extrapolated like the noise, m_c + scale * (m_c - m_u)
(reference `train_t2i_discrete.py:429`).

Both wrappers take a `cfg_on` keyword per call: False skips the uncond half
(one cond-only forward at batch B instead of 2B).  The solver's guidance
interval (`DPMSolver(cfg_interval=...)`, arXiv:2404.07724) resolves it per
step on the host.  `want_mask_delta=True` on a guided panoptic call also
returns the guidance correction scale * (m_c - m_u) of the mask, which the
solver's mask-guidance hold re-applies on cond-only steps.
"""
from __future__ import annotations

from typing import Callable

import torch


def make_cfg_t2i(apply_fn: Callable, empty_context: torch.Tensor, scale: float,
                 enabled: bool = True):
    """apply_fn(x, t, context, mask_token=None) -> noise | (noise, pred_mask);
    returns cfg_fn(x, t, context, mask_token=None, cfg_on=True,
    want_mask_delta=False) with the same contract, plus the mask's guidance
    delta as a third output when want_mask_delta on a guided masked call."""

    def cfg_fn(x, t, context, mask_token=None, cfg_on: bool = True,
               want_mask_delta: bool = False):
        if not enabled or scale == 0.0 or not cfg_on:
            return apply_fn(x, t, context, mask_token=mask_token)
        b = x.shape[0]
        ctx_u = empty_context.to(context.dtype).expand(b, *empty_context.shape[-2:])
        x2 = torch.cat([x, x])
        t2 = torch.cat([t, t])
        ctx2 = torch.cat([context, ctx_u])
        if mask_token is None:
            cond, uncond = apply_fn(x2, t2, ctx2).chunk(2)
            return cond + scale * (cond - uncond)
        noise, pred_mask = apply_fn(x2, t2, ctx2, mask_token=torch.cat([mask_token, mask_token]))
        n_c, n_u = noise.chunk(2)
        m_c, m_u = pred_mask.chunk(2)
        delta = scale * (m_c - m_u)
        if want_mask_delta:
            return n_c + scale * (n_c - n_u), m_c + delta, delta
        return n_c + scale * (n_c - n_u), m_c + delta

    return cfg_fn


def make_cfg_class_cond(apply_fn: Callable, null_label: int, scale: float,
                        enabled: bool = True):
    """apply_fn(x, t, y) -> noise; returns cfg_fn(x, t, y, cfg_on=True) that
    runs the labels and the null class `null_label` (the config's
    num_classes - 1, reference `eval.py:43-46`) as one 2x batch and
    extrapolates cond + scale * (cond - uncond)."""

    def cfg_fn(x, t, y, cfg_on: bool = True):
        if not enabled or scale == 0.0 or not cfg_on:
            return apply_fn(x, t, y)
        y_u = torch.full_like(y, null_label)
        cond, uncond = apply_fn(torch.cat([x, x]), torch.cat([t, t]),
                                torch.cat([y, y_u])).chunk(2)
        return cond + scale * (cond - uncond)

    return cfg_fn
