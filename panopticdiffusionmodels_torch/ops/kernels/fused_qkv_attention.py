"""Attention from the qkv GEMM's packed (B, L, 3C) output, as a Hopper kernel.

Replaces the Pallas TPU kernel
`panopticdiffusionmodels_tpu/ops/pallas/fused_qkv_attention.py::fused_attention_qkv`
with the hand-written CUDA C++ kernel in `csrc/fused_qkv_attention.cu`
(sm_90a, mma.sync bf16 tensor cores, online softmax over 64-key K/V tiles).

What bounds it on an H100: 4*B*L^2*C flops against 8*B*L*C bytes of qkv read
and output written, i.e. L/2 flops per byte, which is below the card's bf16
ridge (~295 flops/byte) for the U-ViT's L = 334 and level with it at L = 590.
The kernel keeps the (L, L) scores out of device memory, so its floor is one
read of qkv and one write of the output; see the source for the layout.

The TPU kernel normalises the probabilities before the PV product; this one
defers the division by the row sum to its epilogue (flash style).  The two
differ only in where P is rounded to bf16.

On a CPU tensor `fused_attention_qkv` computes the plain PyTorch version
(`attention_qkv_plain`); on a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

NAME = "fused_qkv_attention"
# Launches of the kernel since the last reset; chip_smoke.py zeroes and reads it.
launches = 0
_fn = None


def attention_qkv_plain(qkv: torch.Tensor, heads: int, scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v per head from packed (B, L, 3C) -> (B, L, C).

    Operands stay in their dtype's values, scores and softmax are f32, P is
    cast to v's dtype before PV, which accumulates in f32 (the JAX package's
    `_xla_attention_qkv`)."""
    b, l, c3 = qkv.shape
    c = c3 // 3
    t = qkv.reshape(b, l, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
    q, k, v = t[0], t[1], t[2]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.matmul(p.float(), v.float()).to(v.dtype)
    return o.transpose(1, 2).reshape(b, l, c)


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load(NAME).pdm_fused_qkv_attention
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def fused_attention_qkv(qkv: torch.Tensor, heads: int, scale: float) -> torch.Tensor:
    """Packed (B, L, 3C) -> (B, L, C); the kernel for CUDA tensors."""
    if qkv.device.type == "cpu":
        return attention_qkv_plain(qkv, heads, scale)
    if qkv.device.type != "cuda":
        raise ValueError(f"fused_attention_qkv: no kernel for device {qkv.device}")
    if qkv.dtype != torch.bfloat16:
        raise ValueError(f"fused_attention_qkv: kernel takes bfloat16, got {qkv.dtype}")
    if qkv.dim() != 3 or qkv.shape[2] % (3 * heads):
        raise ValueError(
            f"fused_attention_qkv: need (B, L, 3C) with C divisible by heads={heads}, "
            f"got {tuple(qkv.shape)}")
    b, l, c3 = qkv.shape
    c = c3 // 3
    d = c // heads
    if d % 8 or d > 128:
        raise ValueError(f"fused_attention_qkv: head dim {d} must be a multiple of 8, <= 128")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("fused_attention_qkv: qkv must be contiguous and 16-byte aligned")
    out = torch.empty((b, l, c), dtype=qkv.dtype, device=qkv.device)
    err = _kernel()(qkv.data_ptr(), out.data_ptr(), b, l, heads, d, float(scale),
                    qkv.device.index or 0,
                    torch.cuda.current_stream(qkv.device).cuda_stream)
    if err:
        raise RuntimeError(f"fused_attention_qkv: CUDA error {err} at launch "
                           f"(B={b}, L={l}, H={heads}, D={d})")
    global launches
    launches += 1
    return out
