"""One ring-attention hop as a Hopper kernel.

Replaces the Pallas TPU kernel
`panopticdiffusionmodels_tpu/ops/pallas/ring_hop.py::attention_hop` with the
hand-written CUDA C++ kernel in `csrc/ring_hop.cu` (sm_90a).  For head dims
64 and 72 (U-ViT-H's 16 heads of 72 train at mesh.sp > 1) it is the forward
attention loop of `csrc/attention_fwd.cuh` in its hop mode (TMA into an
mbarrier ring, wgmma), with TMA tensor maps over the views the ring passes;
every other head dim, which no path of the port runs, keeps an mma.sync
kernel (`hop_loop`).  A hop is the local attention of one sequence-parallel
shard's
queries against one shard of keys and values, left unnormalised so that
`ops/ring_attention.py` can combine the hops exactly:

    o   = exp(S - m) V        (B, Lq, C), the network dtype
    m   = rowmax(S)           (B, Lq, H) f32, S = q k^T * scale
    den = rowsum(exp(S - m))  (B, Lq, H) f32

Keys at or past `nvalid` (padding of a sequence that does not divide the
ring) score -1e30, finite, so an all-padding hop gives m = -1e30, den = Lk
and no NaN.  The JAX kernel packs m and den into (B, groups, Lq, 128) lane
blocks; here they are (B, Lq, H).  `nvalid` is an int, a 0-d tensor or one
value per batch row: the in-process sequence-parallel layout folds the sp
shards into the batch, and one launch then covers every shard of a hop, each
row with its own source shard.

What bounds it on an H100: 4*B*Lq*Lk*C flops against about 4*B*(Lq+Lk)*C
bytes, so it is bound by the tensor cores at the 512-res mask-stream shard
(Lq = Lk = 1063) and by both at the image-stream shard (551); see the source.

On a CPU tensor `attention_hop` computes the plain PyTorch version
(`attention_hop_plain`); on a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .tensor_map import tma_eligible

NAME = "ring_hop"
NEG_BIG = -1e30
# Calls of `attention_hop` that launched the kernel since the last reset;
# chip_smoke.py zeroes and reads it.
launches = 0
_fn = None


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """f32 for bf16/f32 operands (the kernel's accumulation type), f64 for f64."""
    return torch.promote_types(dtype, torch.float32)


def attention_hop_plain(q: torch.Tensor, kv: torch.Tensor, heads: int, scale: float, nvalid):
    """One hop's flash partials: the JAX package's `_hop_xla`.

    q (B, Lq, C) in the packed column layout (a strided view is fine), kv
    (B, Lk, 2C) packed [k | v], nvalid an int, a 0-d tensor or (B,) ints.
    Scores, m, den and the PV accumulation are f32 (autocast is off inside);
    exp(S - m) is cast to v's dtype before PV.  Returns (o (B, Lq, C) in q's
    dtype, m (B, Lq, H) f32, den (B, Lq, H) f32)."""
    b, lq, c = q.shape
    lk = kv.shape[1]
    d = c // heads
    acc = _acc_dtype(q.dtype)
    with torch.autocast(q.device.type, enabled=False):
        qh = q.reshape(b, lq, heads, d).transpose(1, 2).to(acc)
        kh = kv[..., :c].reshape(b, lk, heads, d).transpose(1, 2).to(acc)
        vh = kv[..., c:].reshape(b, lk, heads, d).transpose(1, 2)
        s = torch.matmul(qh, kh.transpose(-1, -2)) * scale
        nv = torch.as_tensor(nvalid, device=q.device).reshape(-1, 1, 1, 1)
        col = torch.arange(lk, device=q.device)
        s = torch.where(col < nv, s, NEG_BIG)
        m = s.amax(dim=-1, keepdim=True)  # (b, h, lq, 1)
        p = torch.exp(s - m)
        den = p.sum(dim=-1, keepdim=True)
        o = torch.matmul(p.to(vh.dtype).to(acc), vh.to(acc)).to(q.dtype)
    return (o.transpose(1, 2).reshape(b, lq, c), m[..., 0].transpose(1, 2),
            den[..., 0].transpose(1, 2))


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load(NAME).pdm_ring_hop
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [ptr, i64, i64, ptr, i64, i64, ptr, ptr, ptr, ptr,
                       i32, i32, i32, i32, i32, ctypes.c_float, i32, ptr]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def hop_loop(d: int) -> str:
    """Which loop head dim `d` takes in `csrc/ring_hop.cu`, as the compiled
    library reports it (a static dispatch on D): 'wgmma+tma' or 'mma.sync'.
    On the card only."""
    fn = build.load(NAME).pdm_ring_hop_path
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    return "wgmma+tma" if fn(d) else "mma.sync"


def encode_us(q: torch.Tensor, kv: torch.Tensor, heads: int) -> float:
    """Host microseconds one hop launch spends encoding its TMA tensor maps
    over these views (two maps at head dim 64, four at 72), the mean of 1000
    encodes.  On the card only; raises for a head dim off the wgmma loop."""
    b, lq, c = q.shape
    fn = build.load(NAME).pdm_ring_hop_encode_us
    i64, i32 = ctypes.c_longlong, ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, i64, i64, ctypes.c_void_p, i64, i64] + [i32] * 6
    fn.restype = ctypes.c_double
    us = fn(q.data_ptr(), q.stride(0), q.stride(1), kv.data_ptr(), kv.stride(0), kv.stride(1),
            b, lq, kv.shape[1], heads, c // heads, 1000)
    if us < 0:
        raise RuntimeError(f"attention_hop: tensor map encode failed for q {tuple(q.shape)}, "
                           f"kv {tuple(kv.shape)}, {heads} heads")
    return us


def _check_operand(name: str, t: torch.Tensor, width: int) -> None:
    """A (B, L, width) view the kernel can read: unit column stride, base and
    row and batch strides 16-byte aligned, which is also what a TMA tensor
    map of the wgmma loop needs (`tma_eligible`)."""
    if t.dim() != 3 or t.shape[2] != width:
        raise ValueError(f"attention_hop: {name} must be (B, L, {width}), got {tuple(t.shape)}")
    if not tma_eligible(t):
        raise ValueError(f"attention_hop: {name} needs unit column stride, row and batch "
                         f"strides that are multiples of 8 elements and a 16-byte aligned "
                         f"base (a TMA tensor map's rule); got strides {t.stride()}")


def attention_hop(q: torch.Tensor, kv: torch.Tensor, heads: int, scale: float, nvalid):
    """(o, m, den) of one hop, as `attention_hop_plain`; the kernel for CUDA
    tensors, which takes bf16 q and kv with any row and batch strides that
    are 16-byte aligned (a view of the packed qkv; it raises otherwise), and
    nvalid as an int or an int32 device tensor of B values (or one value)."""
    if q.device.type == "cpu":
        return attention_hop_plain(q, kv, heads, scale, nvalid)
    if q.device.type != "cuda" or kv.device != q.device:
        raise ValueError(f"attention_hop: no kernel for devices {q.device} / {kv.device}")
    if q.dtype != torch.bfloat16 or kv.dtype != torch.bfloat16:
        raise ValueError(f"attention_hop: kernel takes bfloat16, got {q.dtype} / {kv.dtype}")
    b, lq, c = q.shape
    if c % heads:
        raise ValueError(f"attention_hop: C={c} not divisible by heads={heads}")
    d = c // heads
    if d % 8 or d > 128:
        raise ValueError(f"attention_hop: head dim {d} must be a multiple of 8, <= 128")
    _check_operand("q", q, c)
    _check_operand("kv", kv, 2 * c)
    if kv.shape[0] != b:
        raise ValueError(f"attention_hop: batch of q {b} != batch of kv {kv.shape[0]}")
    lk = kv.shape[1]
    if isinstance(nvalid, int):
        nvalid = torch.full((b,), nvalid, dtype=torch.int32, device=q.device)
    elif nvalid.numel() == 1:
        nvalid = nvalid.reshape(1).expand(b)
    if nvalid.dtype != torch.int32 or nvalid.device != q.device or nvalid.shape != (b,):
        raise ValueError(f"attention_hop: nvalid must be int32 ({b},) on {q.device}, got "
                         f"{nvalid.dtype} {tuple(nvalid.shape)} on {nvalid.device}")
    nvalid = nvalid.contiguous()
    out = torch.empty((b, lq, c), dtype=q.dtype, device=q.device)
    m = torch.empty((b, lq, heads), dtype=torch.float32, device=q.device)
    den = torch.empty_like(m)
    err = _kernel()(
        q.data_ptr(), q.stride(0), q.stride(1), kv.data_ptr(), kv.stride(0), kv.stride(1),
        nvalid.data_ptr(), out.data_ptr(), m.data_ptr(), den.data_ptr(),
        b, lq, lk, heads, d, float(scale), q.device.index or 0,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"attention_hop: CUDA error {err} at launch "
                           f"(B={b}, Lq={lq}, Lk={lk}, H={heads}, D={d})")
    global launches
    launches += 1
    return out, m, den
