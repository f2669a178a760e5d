"""LayerNorm -> qkv GEMM -> multi-head attention as Hopper kernels.

Replaces the Pallas TPU kernel
`panopticdiffusionmodels_tpu/ops/pallas/fused_ln_qkv_attention.py::fused_ln_qkv_attention`,
which does all three in one kernel with the (L, 3C) qkv and the whole
(C, 3C) weight in VMEM.  A Hopper block has 227 KB of shared memory, so the
wrapper here launches the hand-written kernels of
`csrc/fused_ln_qkv_attention.cu` (a row-statistics pass, then the
LayerNorm-prologue qkv GEMM: TMA into an mbarrier ring, wgmma, 128 x 256
tiles), which write the packed bf16 qkv (B, L, 3C) to a scratch buffer
(`ln_qkv_gemm`), and then the packed-qkv attention kernel of
`csrc/fused_qkv_attention.cu` reads it.  All are CUDA C++ for sm_90a; no
library GEMM or attention does any part.

What bounds it on an H100: the qkv product is 2*B*L*C*3C flops, about 86 %
of the work at the A/B chain's shapes (B = 32, L = 258, C = 1024: 52.0 of
60.7 GFLOP), far above the bf16 ridge, so the tensor cores bound it (61 us
for the whole function).  The split keeps one HBM round trip of qkv
(101 MB at B = 32) that the TPU kernel avoided; the normalised x never
reaches device memory.

The rounding points are the JAX kernel's: LayerNorm statistics and affine
map in f32 (two passes, eps inside the rsqrt), xn cast to the weight's
dtype, the product accumulated in f32 and cast to x's dtype, then the
attention with f32 softmax and P in the network dtype for PV (the attention
kernel divides by the row sum after PV instead of before).

Inference only, as in JAX: on a CUDA tensor that needs a gradient under
grad mode the wrapper raises.  It raises for L > 1024 (the JAX function
asserts it) and for a qkv bias (the U-ViT family has none).  On a CPU
tensor it computes the plain PyTorch version
(`fused_ln_qkv_attention_plain`, the composition of `ln_row_stats_plain`,
`ln_qkv_gemm_plain` and `attention_qkv_plain`); on a CUDA tensor it
launches the kernels or raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build
from . import fused_qkv_attention as fqa
from .tensor_map import tma_eligible

NAME = "fused_ln_qkv_attention"
MAX_FULL_SEQ = 1024
C_MULTIPLE = 64  # the GEMM's k tile: one 128-byte TMA row of x
# Calls of `fused_ln_qkv_attention` that launched its kernels since the last
# reset (one call = the statistics and GEMM launches of `ln_qkv_gemm` and one
# attention launch); chip_smoke.py zeroes and reads it.  The attention launch
# does not count in fqa.launches.  `gemm_launches` counts calls of
# `ln_qkv_gemm` that launched its two kernels, from this wrapper or alone.
launches = 0
gemm_launches = 0
_fns = {}


def ln_row_stats_plain(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Each row's LayerNorm statistics over the last dim of x (..., C):
    (..., 2) in f32 (f64 for f64 x) holding the mean and rsqrt(var + eps),
    var the biased mean of (x - mean)^2 (two passes, as the JAX kernel)."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    return torch.cat([mu, torch.rsqrt(var + eps)], dim=-1)


def ln_qkv_gemm_plain(x, ln_scale, ln_bias, w_qkv, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm(x) @ w_qkv with the JAX kernel's rounding points: x (..., C),
    ln_scale and ln_bias (C,), w_qkv (C, 3C) -> (..., 3C) in x's dtype.  The
    statistics and affine map in f32, xn cast to w's dtype, the product
    accumulated in f32."""
    acc = torch.promote_types(x.dtype, torch.float32)
    stats = ln_row_stats_plain(x, eps)
    xn = (x.to(acc) - stats[..., :1]) * stats[..., 1:]
    xn = xn * ln_scale.to(acc) + ln_bias.to(acc)
    return torch.matmul(xn.to(w_qkv.dtype).to(acc), w_qkv.to(acc)).to(x.dtype)


def fused_ln_qkv_attention_plain(x, ln_scale, ln_bias, w_qkv, heads: int, attn_scale: float,
                                 eps: float = 1e-5) -> torch.Tensor:
    """The JAX kernel's arithmetic in plain PyTorch: x (B, L, C), ln_scale and
    ln_bias (C,), w_qkv (C, 3C) head-major [q | k | v] -> (B, L, C) in x's
    dtype, heads concatenated."""
    return fqa.attention_qkv_plain(ln_qkv_gemm_plain(x, ln_scale, ln_bias, w_qkv, eps), heads,
                                   attn_scale)


def kernel_limits_error(c: int, heads: int) -> Optional[str]:
    """Why the kernels cannot take width C with `heads` heads, or None: C a
    multiple of 64 (no upper bound), head dim a multiple of 8 up to 128."""
    d = c // heads
    if c % C_MULTIPLE or c < C_MULTIPLE or d % 8 or d > 128:
        return (f"C={c} must be a positive multiple of {C_MULTIPLE}, head dim {d} a multiple "
                "of 8 up to 128")
    return None


def _kernel(symbol: str, argtypes):
    if symbol not in _fns:
        fn = getattr(build.load(NAME), symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        _fns[symbol] = fn
    return _fns[symbol]


def ln_row_stats(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """(M, 2) f32 LayerNorm statistics of a contiguous bf16 (M, C) x on the
    card: the statistics kernel (`ln_row_stats_plain` for a CPU tensor)."""
    if x.device.type == "cpu":
        return ln_row_stats_plain(x, eps).float()
    m, c = x.shape
    if x.dtype != torch.bfloat16 or not x.is_contiguous() or not tma_eligible(x) \
            or c % C_MULTIPLE:
        raise ValueError(f"ln_row_stats: x must be a contiguous, 16-byte aligned bfloat16 "
                         f"(M, C) tensor with C a multiple of {C_MULTIPLE}")
    stats = torch.empty((m, 2), dtype=torch.float32, device=x.device)
    err = _kernel("pdm_ln_row_stats", [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
                  + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])(
        x.data_ptr(), stats.data_ptr(), m, c, float(eps), x.device.index or 0,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"ln_row_stats: CUDA error {err} at launch (M={m}, C={c})")
    return stats


def ln_qkv_gemm(x: torch.Tensor, ln_scale: torch.Tensor, ln_bias: torch.Tensor,
                w_qkv: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm(x) @ w_qkv, (M, C) -> packed (M, 3C), the first half of
    `fused_ln_qkv_attention`: the statistics kernel and the LN-prologue GEMM
    kernel for CUDA tensors (bf16, contiguous, C a multiple of 64),
    `ln_qkv_gemm_plain` for CPU tensors."""
    if x.device.type == "cpu":
        return ln_qkv_gemm_plain(x, ln_scale, ln_bias, w_qkv, eps)
    if x.device.type != "cuda":
        raise ValueError(f"ln_qkv_gemm: no kernel for device {x.device}")
    m, c = x.shape
    if tuple(w_qkv.shape) != (c, 3 * c) or c % C_MULTIPLE:
        raise ValueError(f"ln_qkv_gemm: need C a multiple of {C_MULTIPLE} and w_qkv "
                         f"({c}, {3 * c}), got C={c}, {tuple(w_qkv.shape)}")
    # f32, contiguous and 8-byte aligned (the kernel reads them as float2)
    gamma, beta = (t.to(x.device, torch.float32).contiguous() for t in (ln_scale, ln_bias))
    gamma, beta = (t.clone() if t.data_ptr() % 8 else t for t in (gamma, beta))
    for name, t in (("x", x), ("w_qkv", w_qkv)):
        if t.dtype != torch.bfloat16 or t.device != x.device or not t.is_contiguous() \
                or not tma_eligible(t):
            raise ValueError(f"ln_qkv_gemm: {name} must be a contiguous, 16-byte aligned "
                             f"bfloat16 tensor on {x.device}")
    if gamma.shape != (c,) or beta.shape != (c,):
        raise ValueError(f"ln_qkv_gemm: ln_scale and ln_bias must be ({c},)")
    stats = ln_row_stats(x, eps)
    qkv = torch.empty((m, 3 * c), dtype=x.dtype, device=x.device)
    err = _kernel("pdm_ln_qkv_gemm", [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
                  + [ctypes.c_void_p])(
        x.data_ptr(), stats.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w_qkv.data_ptr(),
        qkv.data_ptr(), m, c, x.device.index or 0,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"ln_qkv_gemm: CUDA error {err} at the GEMM launch (M={m}, C={c})")
    global gemm_launches
    gemm_launches += 1
    return qkv


def gemm_smem_bytes() -> int:
    """The GEMM kernel's dynamic shared memory per CTA (on the card)."""
    return _kernel("pdm_ln_qkv_gemm_smem_bytes", [])()


def fused_ln_qkv_attention(x: torch.Tensor, ln_scale: torch.Tensor, ln_bias: torch.Tensor,
                           w_qkv: torch.Tensor, heads: int, attn_scale: float,
                           eps: float = 1e-5, qkv_bias: Optional[torch.Tensor] = None):
    """LayerNorm(x) @ w_qkv -> multi-head attention; (B, L, C) -> (B, L, C).

    x (B, L, C) with L <= 1024; ln_scale / ln_bias (C,) (taken in f32);
    w_qkv (C, 3C) packed head-major, the JAX layout.  The kernels for CUDA
    tensors (x and w_qkv bf16 and contiguous, C a multiple of 64, head dim a
    multiple of 8 up to 128)."""
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
    why = kernel_limits_error(c, heads)
    if why:
        raise ValueError(f"fused_ln_qkv_attention: {why}")
    if not x.is_contiguous():
        raise ValueError("fused_ln_qkv_attention: x must be contiguous")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    dev = x.device.index or 0
    qkv = ln_qkv_gemm(x.reshape(b * l, c), ln_scale, ln_bias, w_qkv, eps).view(b, l, 3 * c)
    out = torch.empty((b, l, c), dtype=x.dtype, device=x.device)
    err = fqa._kernel(fqa.NAME, "pdm_fused_qkv_attention", 3)(
        qkv.data_ptr(), out.data_ptr(), None, b, l, heads, d, float(attn_scale), dev, stream)
    if err:
        raise RuntimeError(f"fused_ln_qkv_attention: CUDA error {err} at the attention launch "
                           f"(B={b}, L={l}, H={heads}, D={d})")
    global launches
    launches += 1
    return out
