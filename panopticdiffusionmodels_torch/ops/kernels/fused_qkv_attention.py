"""Attention from the qkv GEMM's packed (B, L, 3C) output, and its gradient,
as Hopper kernels.

Replaces the Pallas TPU kernels
`panopticdiffusionmodels_tpu/ops/pallas/fused_qkv_attention.py::fused_attention_qkv`
(forward) and `::fused_attention_qkv_vjp` (backward) with the hand-written
CUDA C++ kernels in `csrc/fused_qkv_attention.cu` and
`csrc/fused_qkv_attention_bwd.cu` (sm_90a).  The forward runs the attention
loop of `csrc/attention_fwd.cuh`: TMA loads into an mbarrier ring and wgmma
for head dims 64 and 72, mma.sync for every other head dim
(`attention_loop`); the backward's two kernels take the same structure for
head dims 64 and 72 (TMA ring, mbarriers, wgmma) and mma.sync for the others
(`attention_bwd_loop`).

What bounds them on an H100: the forward does 4*B*L^2*C flops against
8*B*L*C bytes of qkv read and output written, i.e. L/2 flops per byte, below
the card's bf16 ridge (~295 flops/byte) for the U-ViT's L = 334 and level
with it at L = 590; the backward does 10*B*L^2*C flops against 14*B*L*C
bytes (qkv and the cotangent in, dqkv out).  Both keep the (L, L) scores out
of device memory; see the sources for the layouts.

The TPU forward normalises the probabilities before the PV product; the
Hopper forward defers the division by the row sum to its epilogue (flash
style) and can also write each row's log-sum-exp, from which the backward
rebuilds P instead of recomputing the row max and sum.  The two differ only
in where P is rounded to bf16.

On a CPU tensor the wrappers compute the plain PyTorch versions
(`attention_qkv_plain`, `attention_qkv_vjp_plain`); on a CUDA tensor they
launch the kernels or raise.  `attention_qkv_vjp_lse_plain` restates the
backward kernel's own decomposition (P from lse, delta from out), so that a
difference of formulation can be told apart from a fault of the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .tensor_map import tma_eligible

NAME = "fused_qkv_attention"
BWD_NAME = "fused_qkv_attention_bwd"
# Calls of each wrapper that launched its kernel since the last reset;
# chip_smoke.py zeroes and reads them.  `launches` counts forward calls, with
# or without the lse output; one backward call launches two CUDA kernels.
launches = 0
bwd_launches = 0
_fns = {}


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """f32 for bf16/f32 operands (the kernels' accumulation type), f64 for f64."""
    return torch.promote_types(dtype, torch.float32)


def _split_heads(qkv: torch.Tensor, heads: int):
    b, l, c3 = qkv.shape
    c = c3 // 3
    t = qkv.reshape(b, l, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
    return t[0], t[1], t[2]


def attention_qkv_plain(qkv: torch.Tensor, heads: int, scale: float, with_lse: bool = False):
    """softmax(q k^T * scale) v per head from packed (B, L, 3C) -> (B, L, C).

    Operands stay in their dtype's values, scores and softmax are f32, P is
    cast to v's dtype before PV, which accumulates in f32 (the JAX package's
    `_xla_attention_qkv`).  With `with_lse`, also returns each row's
    log-sum-exp of the scaled scores, (B, H, L) f32, taken as max + log of
    the shifted sum as the kernel does."""
    b, l, c3 = qkv.shape
    q, k, v = _split_heads(qkv, heads)
    acc = _acc_dtype(qkv.dtype)
    s = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.matmul(p.to(acc), v.to(acc)).to(v.dtype)
    out = o.transpose(1, 2).reshape(b, l, c3 // 3)
    if not with_lse:
        return out
    m = s.amax(dim=-1, keepdim=True)
    lse = (m + torch.log(torch.exp(s - m).sum(dim=-1, keepdim=True)))[..., 0]
    return out, lse


def attention_qkv_vjp_plain(qkv: torch.Tensor, g: torch.Tensor, heads: int,
                            scale: float) -> torch.Tensor:
    """dL/dqkv of `attention_qkv_plain` from packed qkv (B, L, 3C) and the
    output cotangent g (B, L, C); packed (B, L, 3C) in qkv's dtype.

    Mirrors the JAX package's `_attend_bwd` step by step: normalised f32 P;
    P cast to v's dtype for dV = P^T dO; dP = dO V^T in f32;
    dS = P * (dP - rowsum(dP * P)) * scale cast to v's dtype; dQ = dS K;
    dK = dS^T Q; every product accumulates in f32."""
    b, l, c3 = qkv.shape
    c = c3 // 3
    q, k, v = _split_heads(qkv, heads)
    acc = _acc_dtype(qkv.dtype)
    do = g.reshape(b, l, heads, c // heads).transpose(1, 2).to(acc)
    q, k, vf = q.to(acc), k.to(acc), v.to(acc)
    p = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) * scale, dim=-1)
    dv = torch.matmul(p.to(v.dtype).to(acc).transpose(-1, -2), do)
    dp = torch.matmul(do, vf.transpose(-1, -2))
    ds = (p * (dp - (dp * p).sum(dim=-1, keepdim=True)) * scale).to(v.dtype).to(acc)
    dq = torch.matmul(ds, k)
    dk = torch.matmul(ds.transpose(-1, -2), q)
    dqkv = torch.stack([dq, dk, dv])  # (3, B, H, L, D)
    return dqkv.permute(1, 3, 0, 2, 4).reshape(b, l, c3).to(qkv.dtype)


def attention_qkv_vjp_lse_plain(qkv: torch.Tensor, g: torch.Tensor, out: torch.Tensor,
                                lse: torch.Tensor, heads: int, scale: float) -> torch.Tensor:
    """`attention_qkv_vjp_plain` as the backward kernel decomposes it: P is
    rebuilt as exp(S * scale - lse) from the forward's lse (B, H, L) and
    delta = rowsum(dO * out) is taken from the forward's `out` (B, L, C) as
    it was stored (bf16 on the kernel's path) instead of rowsum(dP * P).  P
    and dS are rounded to v's dtype for their products; everything else is
    the accumulation dtype.  Packed (B, L, 3C) in qkv's dtype."""
    b, l, c3 = qkv.shape
    c = c3 // 3
    d = c // heads
    q, k, v = _split_heads(qkv, heads)
    acc = _acc_dtype(qkv.dtype)
    do = g.reshape(b, l, heads, d).transpose(1, 2).to(acc)
    o = out.reshape(b, l, heads, d).transpose(1, 2).to(acc)
    q, k, vf = q.to(acc), k.to(acc), v.to(acc)
    p = torch.exp(torch.matmul(q, k.transpose(-1, -2)) * scale - lse.to(acc)[..., None])
    delta = (do * o).sum(dim=-1, keepdim=True)
    dv = torch.matmul(p.to(v.dtype).to(acc).transpose(-1, -2), do)
    dp = torch.matmul(do, vf.transpose(-1, -2))
    ds = (p * (dp - delta) * scale).to(v.dtype).to(acc)
    dq = torch.matmul(ds, k)
    dk = torch.matmul(ds.transpose(-1, -2), q)
    dqkv = torch.stack([dq, dk, dv])  # (3, B, H, L, D)
    return dqkv.permute(1, 3, 0, 2, 4).reshape(b, l, c3).to(qkv.dtype)


def _kernel(name: str, symbol: str, n_pointers: int):
    if name not in _fns:
        fn = getattr(build.load(name), symbol)
        fn.argtypes = ([ctypes.c_void_p] * n_pointers
                       + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


def _check(what: str, qkv: torch.Tensor, heads: int) -> int:
    """The kernels' shared preconditions on a non-CPU qkv; returns head dim."""
    if qkv.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {qkv.device}")
    if qkv.dtype != torch.bfloat16:
        raise ValueError(f"{what}: kernel takes bfloat16, got {qkv.dtype}")
    if qkv.dim() != 3 or qkv.shape[2] % (3 * heads):
        raise ValueError(f"{what}: need (B, L, 3C) with C divisible by heads={heads}, "
                         f"got {tuple(qkv.shape)}")
    d = qkv.shape[2] // 3 // heads
    if d % 8 or d > 128:
        raise ValueError(f"{what}: head dim {d} must be a multiple of 8, <= 128")
    if not qkv.is_contiguous() or not tma_eligible(qkv):
        raise ValueError(f"{what}: qkv must be contiguous and 16-byte aligned")
    return d


def attention_loop(d: int, name: str = NAME) -> str:
    """Which loop of `csrc/attention_fwd.cuh` head dim `d` takes in the
    library `name` (this kernel's, or kernel 4's `fused_attention`), as the
    compiled library reports it (a static dispatch on D): 'wgmma+tma' or
    'mma.sync'.  Builds the library if needed, so on the card only."""
    fn = build.load(name).pdm_attention_path
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    return "wgmma+tma" if fn(d) else "mma.sync"


def attention_bwd_loop(d: int) -> str:
    """Which kernels of `csrc/fused_qkv_attention_bwd.cu` head dim `d`
    takes, as the compiled library reports it (a static dispatch on D):
    'wgmma+tma' or 'mma.sync'.  On the card only."""
    fn = build.load(BWD_NAME).pdm_attention_bwd_path
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    return "wgmma+tma" if fn(d) else "mma.sync"


def attention_bwd_tma_smem_bytes(d: int) -> dict:
    """Dynamic shared memory a CTA of each wgmma backward kernel takes at
    head dim `d` (0 where `d` does not take them; on the card)."""
    fn = build.load(BWD_NAME).pdm_attention_bwd_tma_smem_bytes
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    return {"dq_tma_kernel": fn(0, d), "dkv_tma_kernel": fn(1, d)}


def attention_tma_smem_bytes(d: int) -> int:
    """Dynamic shared memory a CTA of the wgmma loop takes at head dim `d`
    (0 where `d` does not take it; on the card)."""
    fn = build.load(NAME).pdm_attention_tma_smem_bytes
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    return fn(d)


def encode_us(qkv: torch.Tensor, heads: int) -> float:
    """Host microseconds one forward launch spends encoding its TMA tensor
    maps at qkv's shape (one map at head dim 64, two at 72), the mean of 1000
    encodes."""
    b, l, c3 = qkv.shape
    fn = build.load(NAME).pdm_fused_qkv_attention_encode_us
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 5
    fn.restype = ctypes.c_double
    us = fn(qkv.data_ptr(), b, l, heads, c3 // 3 // heads, 1000)
    if us < 0:
        raise RuntimeError(f"fused_attention_qkv: tensor map encode failed for {tuple(qkv.shape)}")
    return us


def fused_attention_qkv(qkv: torch.Tensor, heads: int, scale: float, with_lse: bool = False):
    """Packed (B, L, 3C) -> (B, L, C) [, lse (B, H, L) f32]; the kernel for
    CUDA tensors.  The kernel has no gradient of its own: on a CUDA tensor
    that requires grad under grad mode this raises, because the result would
    carry none (`ops.attention.attention_qkv(impl='auto')` is the trainable
    route: this kernel forward plus the backward kernel)."""
    if qkv.device.type == "cpu":
        return attention_qkv_plain(qkv, heads, scale, with_lse)
    if torch.is_grad_enabled() and qkv.requires_grad:
        raise RuntimeError(
            "fused_attention_qkv: the forward-only kernel would drop the gradient of "
            "qkv; use attention_qkv(impl='auto') (kernel forward + "
            "fused_attention_qkv_vjp backward) to train, or run under torch.no_grad()")
    d = _check("fused_attention_qkv", qkv, heads)
    b, l, c3 = qkv.shape
    out = torch.empty((b, l, c3 // 3), dtype=qkv.dtype, device=qkv.device)
    lse = (torch.empty((b, heads, l), dtype=torch.float32, device=qkv.device)
           if with_lse else None)
    err = _kernel(NAME, "pdm_fused_qkv_attention", 3)(
        qkv.data_ptr(), out.data_ptr(), None if lse is None else lse.data_ptr(),
        b, l, heads, d, float(scale), qkv.device.index or 0,
        torch.cuda.current_stream(qkv.device).cuda_stream)
    if err:
        raise RuntimeError(f"fused_attention_qkv: CUDA error {err} at launch "
                           f"(B={b}, L={l}, H={heads}, D={d})")
    global launches
    launches += 1
    return (out, lse) if with_lse else out


def fused_attention_qkv_vjp(qkv: torch.Tensor, g: torch.Tensor, heads: int, scale: float, *,
                            out: torch.Tensor = None, lse: torch.Tensor = None) -> torch.Tensor:
    """dL/dqkv (B, L, 3C) from packed qkv and the output cotangent g (B, L, C).

    The kernel for CUDA tensors, which also takes the forward's `out` and
    `lse` (`fused_attention_qkv(..., with_lse=True)`); g must be a tensor a
    TMA map can take (`tma_eligible`), as qkv; on CPU tensors the plain
    version, which needs neither."""
    if qkv.device.type == "cpu":
        return attention_qkv_vjp_plain(qkv, g, heads, scale)
    d = _check("fused_attention_qkv_vjp", qkv, heads)
    b, l, c3 = qkv.shape
    for name, t in (("g", g), ("out", out)):
        if t is None or t.shape != (b, l, c3 // 3) or t.dtype != qkv.dtype \
                or t.device != qkv.device or not t.is_contiguous() or not tma_eligible(t):
            raise ValueError(f"fused_attention_qkv_vjp: {name} must be a contiguous, "
                             f"16-byte aligned {qkv.dtype} ({b}, {l}, {c3 // 3}) tensor on "
                             f"{qkv.device}")
    if lse is None or lse.shape != (b, heads, l) or lse.dtype != torch.float32 \
            or lse.device != qkv.device or not lse.is_contiguous():
        raise ValueError(f"fused_attention_qkv_vjp: lse must be a contiguous float32 "
                         f"({b}, {heads}, {l}) tensor on {qkv.device}")
    dqkv = torch.empty_like(qkv)
    # Each row's lse and delta, per (batch, head) padded to 64-row tiles.
    rows = torch.empty((b, heads, 2, -(-l // 64) * 64), dtype=torch.float32, device=qkv.device)
    err = _kernel(BWD_NAME, "pdm_fused_qkv_attention_bwd", 6)(
        qkv.data_ptr(), out.data_ptr(), g.data_ptr(), lse.data_ptr(), rows.data_ptr(),
        dqkv.data_ptr(), b, l, heads, d, float(scale), qkv.device.index or 0,
        torch.cuda.current_stream(qkv.device).cuda_stream)
    if err:
        raise RuntimeError(f"fused_attention_qkv_vjp: CUDA error {err} at launch "
                           f"(B={b}, L={l}, H={heads}, D={d})")
    global bwd_launches
    bwd_launches += 1
    return dqkv
