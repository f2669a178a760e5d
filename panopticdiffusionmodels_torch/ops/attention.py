"""Attention dispatch for the packed (B, L, 3C) qkv layout.

Port of `panopticdiffusionmodels_tpu/ops/attention.py::attention_qkv`.  The
inference path goes to the hand-written Hopper forward kernel; the training
path (`'auto'`) is a `torch.autograd.Function` whose forward is that kernel
(with the log-sum-exp saved) and whose backward is the Hopper backward
kernel (`ops/kernels`), as the JAX package's custom VJP pairs
`fused_attention_qkv` with `fused_attention_qkv_vjp`.  `'ring'` is the
sequence-parallel flavour (`ops/ring_attention.py`, one `attention_hop`
kernel launch per hop), given the sp context of `parallel/mesh.py`.
"""
from __future__ import annotations

import logging
from typing import Optional

import torch

from .kernels.fused_qkv_attention import (
    attention_qkv_plain,
    fused_attention_qkv,
    fused_attention_qkv_vjp,
)
from .ring_attention import ring_attention_local

_LATER = {
    # JAX's A/B handle (kernel forward + XLA-recompute backward), picked there
    # only when the backward misses the VMEM budget; on the card its backward
    # would be the plain version on a CUDA path.
    "pallas_recompute": "a later slice (kernel forward + recompute backward)",
}
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
    if impl in _LATER:
        raise NotImplementedError(
            f"attention_qkv impl={impl!r} is not ported yet: it comes with {_LATER[impl]}")
    raise ValueError(f"unknown attention impl: {impl!r}")
