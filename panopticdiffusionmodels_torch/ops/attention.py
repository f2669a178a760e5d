"""Attention dispatch: the packed (B, L, 3C) qkv layout and (B, H, L, D).

Port of `panopticdiffusionmodels_tpu/ops/attention.py::attention_qkv` and
`::multi_head_attention`.  The
inference path goes to the hand-written Hopper forward kernel; the training
path (`'auto'`) is a `torch.autograd.Function` whose forward is that kernel
(with the log-sum-exp saved) and whose backward is the Hopper backward
kernel (`ops/kernels`), as the JAX package's custom VJP pairs
`fused_attention_qkv` with `fused_attention_qkv_vjp`.  `'pallas_recompute'`
is the JAX package's other training pair: the forward kernel without lse,
saving only qkv, and a backward that re-differentiates the plain attention
in f32.  `'ring'` is the
sequence-parallel flavour (`ops/ring_attention.py`, one `attention_hop`
kernel launch per hop), given the sp context of `parallel/mesh.py`.
`multi_head_attention` is the (B, H, L, D) entry: the plain path, or the
`fused_attention` kernel forward with its plain recompute backward.
"""
from __future__ import annotations

import logging
from typing import Optional

import torch

from .kernels.fused_attention import FusedAttention, xla_attention
from .kernels.fused_qkv_attention import (
    attention_qkv_plain,
    fused_attention_qkv,
    fused_attention_qkv_vjp,
)
from .ring_attention import ring_attention_local

log = logging.getLogger(__name__)


class QKVAttention(torch.autograd.Function):
    """Kernel forward that saves (qkv, out, lse); kernel backward.  On CPU
    tensors both sides are the plain versions."""

    @staticmethod
    def forward(ctx, qkv, heads: int, scale: float):
        out, lse = fused_attention_qkv(qkv, heads, scale, with_lse=True)
        ctx.save_for_backward(qkv, out, lse)
        ctx.heads, ctx.scale = heads, scale
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        qkv, out, lse = ctx.saved_tensors
        dqkv = fused_attention_qkv_vjp(qkv, g.contiguous(), ctx.heads, ctx.scale,
                                       out=out, lse=lse)
        return dqkv, None, None


class QKVAttentionRecompute(torch.autograd.Function):
    """Kernel forward without lse that saves only qkv; the backward
    re-differentiates `attention_qkv_plain` in f32 (JAX `_qkv_attn_trainable`
    with bwd='xla_recompute', `ops/attention.py:55-99`).  JAX takes it where
    the backward kernel misses the VMEM budget; here it is a chosen pair, not
    a fallback.  On CPU tensors the forward is the plain version."""

    @staticmethod
    def forward(ctx, qkv, heads: int, scale: float):
        ctx.save_for_backward(qkv)
        ctx.heads, ctx.scale = heads, scale
        return fused_attention_qkv(qkv, heads, scale)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        (qkv,) = ctx.saved_tensors
        with torch.enable_grad():
            x = qkv.detach().float().requires_grad_()
            out = attention_qkv_plain(x, ctx.heads, ctx.scale)
            (dqkv,) = torch.autograd.grad(out, x, g.float())
        return dqkv.to(qkv.dtype), None, None


def attention_qkv(qkv: torch.Tensor, heads: int, *, scale: Optional[float] = None,
                  impl: str = "infer", sp=None) -> torch.Tensor:
    """Attention from packed qkv; returns (B, L, C) with heads concatenated.

    impl:
      'ring' / 'ring_plain' — with a sequence-parallel context `sp`
                              (`parallel.mesh`): qkv is this rank's token
                              shard in sp's layout, and the ring runs its hops
                              through the `attention_hop` kernel ('ring') or
                              its plain version ('ring_plain'); trainable.
                              Without `sp`, as the JAX package does, it warns
                              for batch > 1 and takes the unsharded path,
                              here 'auto' (the kernels, plain on CPU);
      'auto' / 'pallas_vjp' — trainable: the forward kernel with lse and the
                              backward kernel (their plain versions on CPU);
      'pallas_recompute'    — trainable: the forward kernel without lse and
                              the plain f32 recompute backward;
      'infer' / 'kernel'    — the forward kernel only (its plain version for
                              CPU tensors); raises on a CUDA tensor that needs
                              a gradient;
      'plain' / 'xla'       — the plain PyTorch version on any device.
    """
    if scale is None:
        scale = (qkv.shape[-1] // 3 // heads) ** -0.5
    if impl in ("ring", "ring_plain"):
        if sp is not None:
            return ring_attention_local(qkv, heads, scale, sp, use_kernel=impl == "ring")
        if qkv.shape[0] > 1:
            log.warning("attention_qkv: impl=%r without a sequence-parallel context, batch=%d, "
                        "L=%d: taking the unsharded attention (impl='auto')",
                        impl, qkv.shape[0], qkv.shape[1])
        impl = "auto"
    if impl in ("plain", "xla"):
        return attention_qkv_plain(qkv, heads, scale)
    if impl in ("infer", "kernel"):
        return fused_attention_qkv(qkv, heads, scale)
    if impl in ("auto", "pallas_vjp"):
        return QKVAttention.apply(qkv, heads, scale)
    if impl == "pallas_recompute":
        return QKVAttentionRecompute.apply(qkv, heads, scale)
    raise ValueError(f"unknown attention impl: {impl!r}")


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         scale: Optional[float] = None, impl: str = "auto") -> torch.Tensor:
    """Scaled dot-product attention over (B, H, L, D) tensors.

    impl:
      'auto' / 'infer' — the plain path, as the JAX package resolves them
                         there (the inference kernel lives behind
                         `attention_qkv`, which needs no transposes);
      'xla' / 'plain'  — the plain PyTorch version of the JAX
                         `_xla_attention` (P in v's dtype for PV), on any
                         device, differentiable by autograd;
      'pallas' / 'kernel' — the `fused_attention` kernel forward (its plain
                         version, f32 throughout, on CPU tensors) with the
                         JAX package's f32 recompute backward; trainable.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if impl in ("auto", "infer", "xla", "plain"):
        return xla_attention(q, k, v, scale)
    if impl in ("pallas", "kernel"):
        return FusedAttention.apply(q, k, v, scale)
    raise ValueError(f"unknown attention impl: {impl!r}")
