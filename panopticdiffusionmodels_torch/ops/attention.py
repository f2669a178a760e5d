"""Attention dispatch for the packed (B, L, 3C) qkv layout.

Port of `panopticdiffusionmodels_tpu/ops/attention.py::attention_qkv`.  The
inference path goes to the hand-written Hopper kernel (`ops/kernels`); the
training and sequence-parallel flavours of the JAX dispatch belong to later
slices of the port.
"""
from __future__ import annotations

from typing import Optional

import torch

from .kernels.fused_qkv_attention import attention_qkv_plain, fused_attention_qkv

_LATER = {
    "auto": "the training slice (kernel forward + fused_attention_qkv_vjp backward)",
    "pallas_vjp": "the training slice (fused_attention_qkv_vjp)",
    "pallas_recompute": "the training slice",
    "ring": "the sequence-parallel slice (attention_hop)",
}


def attention_qkv(qkv: torch.Tensor, heads: int, *, scale: Optional[float] = None,
                  impl: str = "infer") -> torch.Tensor:
    """Attention from packed qkv; returns (B, L, C) with heads concatenated.

    impl:
      'infer' / 'kernel' — the Hopper kernel for CUDA tensors (its plain
                           version for CPU tensors, inside the wrapper);
      'plain'            — the plain PyTorch version on any device.
    """
    if scale is None:
        scale = (qkv.shape[-1] // 3 // heads) ** -0.5
    if impl == "plain":
        return attention_qkv_plain(qkv, heads, scale)
    if impl in ("infer", "kernel"):
        return fused_attention_qkv(qkv, heads, scale)
    if impl in _LATER:
        raise NotImplementedError(
            f"attention_qkv impl={impl!r} is not ported yet: it comes with {_LATER[impl]}")
    raise ValueError(f"unknown attention impl: {impl!r}")
