"""Ring attention over the sequence-parallel axis `sp`.

Port of `panopticdiffusionmodels_tpu/ops/ring_attention.py`.  Each sp rank
keeps its (L/sp)-token query shard, and the key/value shards rotate around
the ring one hop at a time (`parallel.mesh` `rotate`, i -> i+1).  Every hop
yields unnormalised flash partials (o, m, den) from the hop kernel
(`ops/kernels/ring_hop.py`, CUDA C++ on the card), and a streaming softmax
combines them exactly, in f32, in the JAX package's order:

    m' = max(m, m_hop); corr = exp(m - m'); corr_hop = exp(m_hop - m')
    den = den * corr + den_hop * corr_hop; o = o * corr + o_hop * corr_hop

and the output is (o / den) cast to the network dtype.  Token counts that do
not divide sp are padded (by `ring_attention_qkv`, or by the context's
`shard` on a model's streams); the padded keys of a hop are masked through
the per-row `nvalid`, the real tokens of the shard the keys came from
(`clip(l_true - src * l_loc, 0, l_loc)` for a stream padded at its end).

Gradients: each hop is a `torch.autograd.Function` (`RingHop`) whose forward
is the kernel and whose backward re-differentiates the plain hop.  The
rotation's backward rotates the other way, so autograd runs the ring
backward.
"""
from __future__ import annotations

import torch

from ..parallel.mesh import SequenceParallel
from .kernels.ring_hop import attention_hop, attention_hop_plain


class RingHop(torch.autograd.Function):
    """One hop: the kernel forward (its plain version on CPU tensors), or
    with `use_kernel=False` the plain forward on any device.

    The backward recomputes the hop with `attention_hop_plain` under
    `torch.enable_grad()` and differentiates it with real cotangents into o,
    m and den (the combine passes gradients to all three).  This is the
    counterpart of the JAX package's `_hop_pallas_bwd`, which re-differentiates
    the XLA hop expression (`ring_attention.py:131-139`): the JAX package has
    no backward kernel for the hop, so neither has the port.  It is the
    hop's gradient as designed, on every device, not a fallback."""

    @staticmethod
    def forward(ctx, q, kv, nvalid, heads: int, scale: float, use_kernel: bool = True):
        ctx.save_for_backward(q, kv, nvalid)
        ctx.heads, ctx.scale = heads, scale
        return (attention_hop if use_kernel else attention_hop_plain)(q, kv, heads, scale, nvalid)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, go, gm, gden):
        q, kv, nvalid = ctx.saved_tensors
        with torch.enable_grad():
            q_, kv_ = q.detach().requires_grad_(), kv.detach().requires_grad_()
            outs = attention_hop_plain(q_, kv_, ctx.heads, ctx.scale, nvalid)
            dq, dkv = torch.autograd.grad(outs, (q_, kv_), (go, gm, gden))
        return dq, dkv, None, None, None, None


def ring_attention_local(qkv: torch.Tensor, heads: int, scale: float, sp: SequenceParallel,
                         l_true: int = None, use_kernel: bool = True) -> torch.Tensor:
    """Ring attention on this rank's local packed (b, l_loc, 3C) shard, in
    `sp`'s layout (folded shards for `InProcessSP`); returns (b, l_loc, C).
    Each shard's real tokens come first: the keys of a shard past its count
    are masked, the counts being those `sp.set_counts` registered for
    `l_loc` (a model's token streams), or with `l_true` those of l_true
    global tokens padded at their end (default: every token is real).  Pad
    rows are garbage as queries.  `use_kernel=False` runs every hop's
    forward through the plain version (the reference the card's kernel path
    is held to); the backward is the same plain recompute either way."""
    b, l_loc, c3 = qkv.shape
    c = c3 // 3
    d = c // heads
    counts = sp.counts(l_loc) if l_true is None else sp.contiguous_counts(l_true)
    acc = torch.promote_types(qkv.dtype, torch.float32)
    q, kv = qkv[..., :c], qkv[..., c:]

    def partials(kv, hop):
        nvalid = sp.nvalid(hop, counts, b, qkv.device)
        o_hop, m_hop, den_hop = RingHop.apply(q, kv, nvalid, heads, scale, use_kernel)
        return o_hop.to(acc).reshape(b, l_loc, heads, d), m_hop[..., None], den_hop[..., None]

    o, m, den = partials(kv, 0)
    for hop in range(1, sp.sp):
        kv = sp.rotate(kv)
        o_hop, m_hop, den_hop = partials(kv, hop)
        m_new = torch.maximum(m, m_hop)
        corr = torch.exp(m - m_new)
        corr_hop = torch.exp(m_hop - m_new)
        den = den * corr + den_hop * corr_hop
        o = o * corr + o_hop * corr_hop
        m = m_new
    return (o / den).to(qkv.dtype).reshape(b, l_loc, c)


def ring_attention_qkv(qkv: torch.Tensor, heads: int, scale: float, sp: SequenceParallel,
                       use_kernel: bool = True) -> torch.Tensor:
    """softmax(Q K^T * scale) V from the packed (B, L, 3C) qkv of ALL tokens,
    computed as a ring over `sp`; returns (B, L, C), heads concatenated, on
    every rank.  L is padded to a multiple of sp and the padding masked, as
    JAX's `ring_attention_qkv` does."""
    l = qkv.shape[1]
    return sp.gather(ring_attention_local(sp.shard(qkv), heads, scale, sp, l_true=l,
                                          use_kernel=use_kernel), l)
