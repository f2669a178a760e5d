"""Multi-head attention over (B, H, L, D) tensors as a Hopper kernel.

Replaces the Pallas TPU kernel
`panopticdiffusionmodels_tpu/ops/pallas/fused_attention.py::fused_attention`
with the hand-written CUDA C++ kernel in `csrc/fused_attention.cu` (sm_90a,
mma.sync bf16 tensor cores).  `FusedAttention` is the JAX function's custom
VJP: the kernel forward, and the JAX package's own f32 recompute of the
attention gradient (`_fused_attention_bwd`) as the backward, in plain
PyTorch on both sides, because the TPU kernel has no backward kernel.  That
backward holds (B, H, L, L) f32 blocks (136 MB each at (32, 16, 258)).

What bounds the kernel on an H100: 4*B*H*L^2*D flops against 8*B*H*L*D
bytes, L/2 flops per byte, far below the card's bf16 ridge at the U-ViT's
L = 258, so it is bound by the traffic of q, k, v and the output; the
(L, L) scores never reach device memory (online softmax over 64-key tiles,
one path for every L; see the source).  The TPU kernel keeps P in f32 for
PV; the Hopper kernel rounds the unnormalised P to bf16 for the tensor
cores and divides by the row sum in its epilogue.

q, k and v may be strided views (a transpose of a (B, L, H, D) projection)
as long as D is contiguous and rows stay 16-byte aligned; the kernel reads
them in place.  On a CPU tensor `fused_attention` computes the plain
PyTorch version (`attention_plain`); on a CUDA tensor it launches the kernel
or raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

NAME = "fused_attention"
# Longest L of the TPU kernel's whole-sequence block; past it the JAX
# function takes `_xla_attention`, and so does the plain version here.
MAX_FULL_SEQ = 1024
# Calls of `fused_attention` that launched the kernel since the last reset;
# chip_smoke.py zeroes and reads it.
launches = 0
_fn = None


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """f32 for bf16/f32 operands (the kernel's accumulation type), f64 for f64."""
    return torch.promote_types(dtype, torch.float32)


def xla_attention(q, k, v, scale: float) -> torch.Tensor:
    """The JAX package's `_xla_attention` over (B, H, L, D): f32 scores and
    softmax, P cast to v's dtype before PV, which accumulates in f32; the
    result in v's dtype."""
    acc = _acc_dtype(q.dtype)
    s = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.matmul(p.to(acc), v.to(acc)).to(v.dtype)


def attention_plain(q, k, v, scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v over (B, H, L, D), with the numerics of the
    JAX `fused_attention`: for L <= MAX_FULL_SEQ its kernel body
    (`_attention_kernel`: q, k, v cast up to f32, scores, softmax and PV all
    f32, the output in q's dtype); past it `_xla_attention`."""
    if q.shape[-2] > MAX_FULL_SEQ:
        return xla_attention(q, k, v, scale)
    acc = _acc_dtype(q.dtype)
    s = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, v.to(acc)).to(q.dtype)


def attention_vjp_plain(q, k, v, g, scale: float):
    """The JAX package's `_fused_attention_bwd`: the softmax weights
    recomputed in f32 and the analytic attention VJP, all f32; (dq, dk, dv)
    in the dtypes of q, k, v."""
    acc = _acc_dtype(q.dtype)
    qf, kf, vf, gf = (t.to(acc) for t in (q, k, v, g))
    p = torch.softmax(torch.matmul(qf, kf.transpose(-1, -2)) * scale, dim=-1)
    dv = torch.matmul(p.transpose(-1, -2), gf)
    dp = torch.matmul(gf, vf.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq = scale * torch.matmul(ds, kf)
    dk = scale * torch.matmul(ds.transpose(-1, -2), qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load(NAME).pdm_fused_attention
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 9 + [ctypes.c_int] * 4
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v over (B, H, L, D) -> (B, H, L, D), contiguous.

    The kernel for CUDA tensors (bf16, D a multiple of 8 up to 128, q, k and
    v of one shape with unit stride along D).  It has no gradient of its
    own: on a CUDA tensor that requires grad under grad mode this raises
    (`FusedAttention.apply` is the trainable route)."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "fused_attention: the forward-only kernel would drop the gradient; use "
            "multi_head_attention(impl='pallas') (kernel forward + plain recompute "
            "backward) to train, or run under torch.no_grad()")
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention: no kernel for device {q.device}")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"fused_attention: need q, k, v of one (B, H, L, D) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, l, d = q.shape
    if d % 8 or d > 128:
        raise ValueError(f"fused_attention: head dim {d} must be a multiple of 8, <= 128")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16 or t.device != q.device:
            raise ValueError(f"fused_attention: {name} must be bfloat16 on {q.device}, got "
                             f"{t.dtype} on {t.device}")
        if t.stride(3) != 1 or any(s % 8 for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(f"fused_attention: {name} needs unit stride along D and "
                             f"16-byte aligned rows, got strides {t.stride()}")
    out = torch.empty((b, h, l, d), dtype=q.dtype, device=q.device)
    err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], b, h, l, d,
                    float(scale), q.device.index or 0,
                    torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"fused_attention: CUDA error {err} at launch "
                           f"(B={b}, H={h}, L={l}, D={d})")
    global launches
    launches += 1
    return out


class FusedAttention(torch.autograd.Function):
    """The JAX `fused_attention` custom VJP: the kernel forward (its plain
    version on CPU tensors), saving q, k and v; the plain f32 recompute
    backward on every device."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return fused_attention(q, k, v, scale)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        return (*attention_vjp_plain(q, k, v, g, ctx.scale), None)
