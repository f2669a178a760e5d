"""LayerNorm -> qkv GEMM -> multi-head attention as Hopper kernels.

Replaces the Pallas TPU kernel
`panopticdiffusionmodels_tpu/ops/pallas/fused_ln_qkv_attention.py::fused_ln_qkv_attention`,
which does all three in one kernel with the (L, 3C) qkv and the whole
(C, 3C) weight in VMEM.  A Hopper block has 227 KB of shared memory, so the
wrapper here makes two launches: the hand-written LN-prologue GEMM of
`csrc/fused_ln_qkv_attention.cu` writes the packed bf16 qkv (B, L, 3C) to a
scratch buffer, and the packed-qkv attention kernel of
`csrc/fused_qkv_attention.cu` reads it.  Both are CUDA C++ for sm_90a on
mma.sync bf16 tensor cores; no library GEMM or attention does any part.

What bounds it on an H100: the qkv product is 2*B*L*C*3C flops, about 86 %
of the work at the A/B chain's shapes (B = 32, L = 258, C = 1024: 52.0 of
60.7 GFLOP), far above the bf16 ridge, so the tensor cores bound it (61 us
for the whole function).  The split keeps one HBM round trip of qkv
(101 MB at B = 32) that the TPU kernel avoided; the normalised x stays in
shared memory.

The rounding points are the JAX kernel's: LayerNorm statistics and affine
map in f32 (eps inside the rsqrt), xn cast to the weight's dtype, the
product accumulated in f32 and cast to x's dtype, then the attention with
f32 softmax and P in the network dtype for PV (the attention kernel divides
by the row sum after PV instead of before).

Inference only, as in JAX: on a CUDA tensor that needs a gradient under
grad mode the wrapper raises.  It raises for L > 1024 (the JAX function
asserts it) and for a qkv bias (the U-ViT family has none).  On a CPU
tensor it computes the plain PyTorch version
(`fused_ln_qkv_attention_plain`); on a CUDA tensor it launches the kernels
or raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build
from . import fused_qkv_attention as fqa

NAME = "fused_ln_qkv_attention"
MAX_FULL_SEQ = 1024
MAX_C = 1280  # the GEMM keeps a CTA's 64 rows of x whole in shared memory
# Calls of `fused_ln_qkv_attention` that launched its kernels since the last
# reset (one call = the GEMM launch and one attention launch); chip_smoke.py
# zeroes and reads it.  The attention launch does not count in fqa.launches.
launches = 0
_fn = None


def fused_ln_qkv_attention_plain(x, ln_scale, ln_bias, w_qkv, heads: int, attn_scale: float,
                                 eps: float = 1e-5) -> torch.Tensor:
    """The JAX kernel's arithmetic in plain PyTorch: x (B, L, C), ln_scale and
    ln_bias (C,), w_qkv (C, 3C) head-major [q | k | v] -> (B, L, C) in x's
    dtype, heads concatenated."""
    acc = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(acc)
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    xn = (xf - mu) * torch.rsqrt(var + eps)
    xn = xn * ln_scale.to(acc) + ln_bias.to(acc)
    qkv = torch.matmul(xn.to(w_qkv.dtype).to(acc), w_qkv.to(acc)).to(x.dtype)
    return fqa.attention_qkv_plain(qkv, heads, attn_scale)


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load(NAME).pdm_ln_qkv_gemm
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 2
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def fused_ln_qkv_attention(x: torch.Tensor, ln_scale: torch.Tensor, ln_bias: torch.Tensor,
                           w_qkv: torch.Tensor, heads: int, attn_scale: float,
                           eps: float = 1e-5, qkv_bias: Optional[torch.Tensor] = None):
    """LayerNorm(x) @ w_qkv -> multi-head attention; (B, L, C) -> (B, L, C).

    x (B, L, C) with L <= 1024; ln_scale / ln_bias (C,) (taken in f32);
    w_qkv (C, 3C) packed head-major, the JAX layout.  The kernels for CUDA
    tensors (x and w_qkv bf16 and contiguous, C a multiple of 32 up to 1280,
    head dim a multiple of 8 up to 128)."""
    b, l, c = x.shape
    if qkv_bias is not None:
        raise NotImplementedError("fused_ln_qkv_attention: no qkv bias (the U-ViT family "
                                  "uses qkv_bias=False), as in the JAX kernel")
    if l > MAX_FULL_SEQ:
        raise ValueError(f"fused_ln_qkv_attention: L={l} > {MAX_FULL_SEQ}; the kernel covers "
                         "the whole-sequence path only, as in the JAX kernel")
    if tuple(w_qkv.shape) != (c, 3 * c) or c % heads:
        raise ValueError(f"fused_ln_qkv_attention: need w_qkv ({c}, {3 * c}) and C divisible "
                         f"by heads={heads}, got {tuple(w_qkv.shape)}")
    if x.device.type == "cpu":
        return fused_ln_qkv_attention_plain(x, ln_scale, ln_bias, w_qkv, heads, attn_scale, eps)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, ln_scale, ln_bias, w_qkv)):
        raise RuntimeError("fused_ln_qkv_attention: inference only (no gradient, as in the "
                           "JAX kernel); run under torch.no_grad()")
    if x.device.type != "cuda":
        raise ValueError(f"fused_ln_qkv_attention: no kernel for device {x.device}")
    d = c // heads
    if c % 32 or c > MAX_C or d % 8 or d > 128:
        raise ValueError(f"fused_ln_qkv_attention: C={c} must be a multiple of 32 up to "
                         f"{MAX_C}, head dim {d} a multiple of 8 up to 128")
    for name, t in (("x", x), ("w_qkv", w_qkv)):
        if t.dtype != torch.bfloat16 or t.device != x.device or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError(f"fused_ln_qkv_attention: {name} must be a contiguous, 16-byte "
                             f"aligned bfloat16 tensor on {x.device}")
    # f32, contiguous and 8-byte aligned (the kernel reads them as float2)
    gamma, beta = (t.to(x.device, torch.float32).contiguous() for t in (ln_scale, ln_bias))
    gamma, beta = (t.clone() if t.data_ptr() % 8 else t for t in (gamma, beta))
    if gamma.shape != (c,) or beta.shape != (c,):
        raise ValueError(f"fused_ln_qkv_attention: ln_scale and ln_bias must be ({c},)")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    dev = x.device.index or 0
    qkv = torch.empty((b, l, 3 * c), dtype=x.dtype, device=x.device)
    err = _kernel()(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w_qkv.data_ptr(),
                    qkv.data_ptr(), b * l, c, float(eps), dev, stream)
    if err:
        raise RuntimeError(f"fused_ln_qkv_attention: CUDA error {err} at the LN-GEMM launch "
                           f"(M={b * l}, C={c})")
    out = torch.empty((b, l, c), dtype=x.dtype, device=x.device)
    err = fqa._kernel(fqa.NAME, "pdm_fused_qkv_attention", 3)(
        qkv.data_ptr(), out.data_ptr(), None, b, l, heads, d, float(attn_scale), dev, stream)
    if err:
        raise RuntimeError(f"fused_ln_qkv_attention: CUDA error {err} at the attention launch "
                           f"(B={b}, L={l}, H={heads}, D={d})")
    global launches
    launches += 1
    return out
