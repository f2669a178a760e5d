"""Transformer layers of the U-ViT family, in PyTorch (NCHW, reference names).

Port of `panopticdiffusionmodels_tpu/models/layers.py`.  Parameter names are
the reference's (`libs/uvit.py`, `libs/timm.py`), so reference-format state
dicts load with `strict=True`.  Parameters may be cast to bf16 as a whole
(`module.to(torch.bfloat16)`): GEMMs then run in bf16 with f32 accumulation,
while LayerNorm statistics and the attention softmax stay in f32.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.attention import attention_qkv


def timestep_embedding(timesteps: torch.Tensor, dim: int, max_period: float = 10000.0):
    """Sinusoidal embeddings in [cos | sin] order; timesteps (B,), f32 out."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=timesteps.device) / half
    )
    args = timesteps.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def unpatchify(x: torch.Tensor, channels: int) -> torch.Tensor:
    """(B, h*w, p*p*C) -> (B, C, h*p, w*p); per-patch vector ordered (p1, p2, C)."""
    b, l, pd = x.shape
    h = w = int(round(l ** 0.5))
    p = int(round((pd // channels) ** 0.5))
    assert h * w == l and p * p * channels == pd
    x = x.reshape(b, h, w, p, p, channels).permute(0, 5, 1, 3, 2, 4)
    return x.reshape(b, channels, h * p, w * p)


def trunc_normal_init(module: nn.Module) -> None:
    """The reference initialisation: trunc_normal(std=.02) Linear weights,
    zero biases, unit LayerNorms (`libs/uvit.py` `_init_weights`)."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            nn.init.trunc_normal_(m.weight, std=0.02)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, nn.LayerNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)


class LayerNorm(nn.LayerNorm):
    """LayerNorm whose statistics and affine map run in f32 for any input dtype."""

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight.float(),
                            self.bias.float(), self.eps).to(x.dtype)


class PatchEmbed(nn.Module):
    """Stride-p convolution, (B, C, H, W) -> (B, h*w, D)."""

    def __init__(self, patch_size: int, in_chans: int, embed_dim: int):
        super().__init__()
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size, stride=patch_size)

    def forward(self, x):
        return self.proj(x).flatten(2).transpose(1, 2)


class ZeroConv(nn.Module):
    """The reference's zero-initialised Conv1d(k=1) coupling, on (B, L, D) tokens."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv = nn.Conv1d(dim, dim, 1)
        nn.init.zeros_(self.conv.weight)
        nn.init.zeros_(self.conv.bias)

    def forward(self, x):
        return F.linear(x, self.conv.weight[:, :, 0], self.conv.bias)


class Mlp(nn.Module):
    """fc1 -> GELU (erf; tanh when gelu_approx) -> fc2."""

    def __init__(self, dim: int, hidden: int, gelu_approx: bool = False):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)
        self.approximate = "tanh" if gelu_approx else "none"

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate=self.approximate))


class Attention(nn.Module):
    """qkv Linear -> packed-qkv attention -> proj Linear.  `sp` is the
    sequence-parallel context (`parallel/mesh.py`) that `attn_impl='ring'`
    runs its ring over; the tokens it sees are then this rank's shard."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = False,
                 qk_scale: Optional[float] = None, attn_impl: str = "infer", sp=None):
        super().__init__()
        self.num_heads = num_heads
        self.scale = qk_scale or (dim // num_heads) ** -0.5
        self.attn_impl = attn_impl
        self.sp = sp
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def attend(self, qkv):
        return attention_qkv(qkv, self.num_heads, scale=self.scale, impl=self.attn_impl,
                             sp=self.sp)

    def forward(self, x):
        return self.proj(self.attend(self.qkv(x)))


class Block(nn.Module):
    """Pre-norm transformer block; the long-skip projection runs before the
    attention residual, as in the reference.

    `use_checkpoint` with `remat_policy='save_attn'` (the JAX package's
    `scan_stack.resolve_remat_policy`): under grad mode the two regions
    around the attention, norm1 -> qkv and proj -> +res -> norm2 -> mlp ->
    +res, are recomputed in backward (non-reentrant `torch.utils.checkpoint`),
    while the attention itself stays outside them, so its output is kept and
    its forward kernel is not replayed (under `attn_impl='ring'` the ring's
    output is the kept tensor, and no hop is relaunched).  Values equal the
    unchecked block."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = False, qk_scale: Optional[float] = None,
                 skip: bool = False, attn_impl: str = "infer", gelu_approx: bool = False,
                 use_checkpoint: bool = False, remat_policy: Optional[str] = "save_attn",
                 sp=None):
        super().__init__()
        if use_checkpoint and remat_policy != "save_attn":
            raise NotImplementedError(
                f"remat_policy={remat_policy!r} is not ported yet (only 'save_attn' is); "
                "the other policies come with a later PR")
        self.use_checkpoint = use_checkpoint
        self.norm1 = LayerNorm(dim, eps=1e-5)
        self.attn = Attention(dim, num_heads, qkv_bias, qk_scale, attn_impl, sp)
        self.norm2 = LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), gelu_approx)
        self.skip_linear = nn.Linear(2 * dim, dim) if skip else None

    def _qkv(self, x):
        return self.attn.qkv(self.norm1(x))

    def _out(self, x, a):
        x = x + self.attn.proj(a)
        return x + self.mlp(self.norm2(x))

    def forward(self, x, skip=None):
        if self.skip_linear is not None:
            x = self.skip_linear(torch.cat([x, skip], dim=-1))
        if self.use_checkpoint and torch.is_grad_enabled():
            a = self.attn.attend(checkpoint(self._qkv, x, use_reentrant=False))
            return checkpoint(self._out, x, a, use_reentrant=False)
        return self._out(x, self.attn.attend(self._qkv(x)))


def time_embed(embed_dim: int, mlp: bool) -> nn.Module:
    """Optional MLP over the sinusoidal embedding (reference names .0 / .2)."""
    if not mlp:
        return nn.Identity()
    return nn.Sequential(nn.Linear(embed_dim, 4 * embed_dim), nn.SiLU(),
                         nn.Linear(4 * embed_dim, embed_dim))


def conv3x3(channels: int) -> nn.Conv2d:
    """The final 3x3 'same' conv head."""
    return nn.Conv2d(channels, channels, 3, padding=1)
