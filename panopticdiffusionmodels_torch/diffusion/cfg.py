"""Classifier-free guidance as one 2x-batch forward: t2i / panoptic and
class-conditional.

Port of `panopticdiffusionmodels_tpu/diffusion/cfg.py::make_cfg_t2i` and
`::make_cfg_class_cond`.  The mask
prediction is extrapolated like the noise, m_c + scale * (m_c - m_u)
(reference `train_t2i_discrete.py:429`).  The guidance-interval keywords of
the JAX wrapper come with the speed-modes slice.
"""
from __future__ import annotations

from typing import Callable

import torch


def make_cfg_t2i(apply_fn: Callable, empty_context: torch.Tensor, scale: float,
                 enabled: bool = True):
    """apply_fn(x, t, context, mask_token=None) -> noise | (noise, pred_mask);
    returns cfg_fn(x, t, context, mask_token=None) with the same contract."""

    def cfg_fn(x, t, context, mask_token=None):
        if not enabled or scale == 0.0:
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
        return n_c + scale * (n_c - n_u), m_c + scale * (m_c - m_u)

    return cfg_fn


def make_cfg_class_cond(apply_fn: Callable, null_label: int, scale: float,
                        enabled: bool = True):
    """apply_fn(x, t, y) -> noise; returns cfg_fn(x, t, y) that runs the
    labels and the null class `null_label` (the config's num_classes - 1,
    reference `eval.py:43-46`) as one 2x batch and extrapolates
    cond + scale * (cond - uncond)."""

    def cfg_fn(x, t, y):
        if not enabled or scale == 0.0:
            return apply_fn(x, t, y)
        y_u = torch.full_like(y, null_label)
        cond, uncond = apply_fn(torch.cat([x, x]), torch.cat([t, t]),
                                torch.cat([y, y_u])).chunk(2)
        return cond + scale * (cond - uncond)

    return cfg_fn
