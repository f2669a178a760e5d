"""Analog-bit codec for panoptic masks, channel-last like the JAX package.

Port of `panopticdiffusionmodels_tpu/diffusion/analog_bits.py`.  Channel 0 is
the most significant bit (reference `utils.py:475-518`).
"""
from __future__ import annotations

import torch


def int2bits(x: torch.Tensor, n: int = 8, out_dtype=torch.float32) -> torch.Tensor:
    """Integer maps (..., H, W, C) -> bits (..., H, W, C*n), MSB first."""
    x = x.to(torch.int32)
    shifts = torch.arange(n - 1, -1, -1, dtype=torch.int32, device=x.device)
    bits = torch.bitwise_and(torch.bitwise_right_shift(x[..., None], shifts), 1)
    return bits.reshape(*x.shape[:-1], x.shape[-1] * n).to(out_dtype)


def bits2int(x: torch.Tensor, n: int = 8, out_dtype=torch.int32) -> torch.Tensor:
    """Bit maps (..., H, W, C*n) -> integers (..., H, W, C); inverse of int2bits."""
    x = x.to(torch.int32)
    bits = x.reshape(*x.shape[:-1], x.shape[-1] // n, n)
    weights = torch.bitwise_left_shift(
        torch.ones((), dtype=torch.int32, device=x.device),
        torch.arange(n - 1, -1, -1, dtype=torch.int32, device=x.device))
    return (bits * weights).sum(-1).to(out_dtype)


def ints_to_analog(x: torch.Tensor, n: int = 8, dtype=torch.float32) -> torch.Tensor:
    """Integer map -> analog bits in [-1, 1]."""
    return int2bits(x, n=n, out_dtype=dtype) * 2.0 - 1.0


def analog_to_ints(x: torch.Tensor, n: int = 8) -> torch.Tensor:
    """Analog bits (any real values) -> integer map, thresholding at > 0."""
    return bits2int(x > 0, n=n)
