"""Small tensor helpers of the diffusion losses.

Port of `panopticdiffusionmodels_tpu/diffusion/math.py` (`stp`, `mos`;
reference `sde.py:18-26`).
"""
from __future__ import annotations

import torch


def stp(s: torch.Tensor, ts: torch.Tensor) -> torch.Tensor:
    """Scalar-tensor product: a per-example (B,) scalar over the trailing dims."""
    s = torch.as_tensor(s, dtype=ts.dtype, device=ts.device)
    return s.reshape(-1, *(1,) * (ts.dim() - 1)) * ts


def mos(a: torch.Tensor, start_dim: int = 1) -> torch.Tensor:
    """Mean of squares over every dim from `start_dim` on; (B,) for the default."""
    return a.reshape(*a.shape[:start_dim], -1).square().mean(dim=-1)
