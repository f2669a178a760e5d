"""SD-style UNet2DCondition with the optional panoptic mask stream, in PyTorch (NCHW).

Port of `panopticdiffusionmodels_tpu/models/unet.py::UNet2DCondition`: the
Stable-Diffusion-1.x conditional UNet (conv_in, levels of [ResBlock +
SpatialTransformer] with stride-2 downsampling and no attention at the
deepest level, mid ResBlock / SpatialTransformer / ResBlock, the symmetric up
path with skip concatenation and nearest-2x upsampling, GroupNorm-silu-conv
out) and the package's own mask stream: a strided conv encoder brings the
(mask_bits, mask_size, mask_size) analog bits to the latent resolution and a
zero-initialised 1x1 conv (`mask_zero_gate`) adds them to the conv_in
features, so at init the image path is exactly the pretrained one; a conv
head decodes the last up-path features back to the mask resolution, then
tanh.  `use_ground_truth=True` returns the given mask unchanged.

Parameter names are the JAX package's module names (`time_fc1`,
`down_{i}_res_{j}.conv1`, `down_{i}_attn_{j}.block_0.attn1.to_q`,
`mask_zero_gate`, ...): the reference's UNet module was never published, and
`utils/weights.py::unet_state_dict` carries JAX parameters over by name;
`utils/ldm_bridge.py` maps an LDM checkpoint onto them.

Numerics follow the JAX module: stride-2 convs pad as flax's "SAME" does
(0 before and 1 after on an even size, not `padding=1`); GroupNorm-32 takes
eps 1e-5, except the SpatialTransformer's input norm at 1e-6; LayerNorm eps
1e-5; the GEGLU feed-forward is a * gelu_erf(g) with a the first half; the
attention is the plain `multi_head_attention(impl='xla')` (f32 scores and
softmax), as JAX's `_Attn` calls it (head dims 40 / 80 / 160 at SD width, and
77 cross-attention keys, which no hand-written kernel of the package takes).
Parameters may be cast to bf16 as a whole: convolutions and GEMMs then run
in bf16, while norms compute their statistics and affine map in f32.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import multi_head_attention
from .layers import LayerNorm, timestep_embedding
from .vae import GroupNorm


def _gn(channels: int, eps: float = 1e-5) -> GroupNorm:
    return GroupNorm(32, channels, eps=eps)


def conv_same_stride2(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A stride-2 3x3 conv (built unpadded) with flax's "SAME" padding:
    ceil(n / 2) outputs, the extra row and column of padding after."""
    pads = []
    for n in (x.shape[-1], x.shape[-2]):  # F.pad takes the last axis first
        total = max(((n + 1) // 2 - 1) * 2 + 3 - n, 0)
        pads += [total // 2, total - total // 2]
    return conv(F.pad(x, pads))


def _upsample2x(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2.0, mode="nearest")


class ResBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, temb_dim: int):
        super().__init__()
        self.norm1 = _gn(in_channels)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb_dim, out_channels)
        self.norm2 = _gn(out_channels)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        self.shortcut = (nn.Conv2d(in_channels, out_channels, 1)
                         if in_channels != out_channels else None)

    def forward(self, x, temb):
        h = self.conv1(F.silu(self.norm1(x)))
        h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if self.shortcut is not None:
            x = self.shortcut(x)
        return x + h


class _Attn(nn.Module):
    """to_q / to_k / to_v (no bias) -> plain attention -> to_out; self-attention
    without a context, cross-attention over it with one."""

    def __init__(self, dim: int, num_heads: int, context_dim: Optional[int] = None):
        super().__init__()
        self.num_heads = num_heads
        self.to_q = nn.Linear(dim, dim, bias=False)
        self.to_k = nn.Linear(context_dim or dim, dim, bias=False)
        self.to_v = nn.Linear(context_dim or dim, dim, bias=False)
        self.to_out = nn.Linear(dim, dim)

    def forward(self, x, context=None):
        b, l = x.shape[:2]
        ctx = x if context is None else context

        def split(t):  # the heads this module holds (H/tp of them under tp)
            return t.reshape(b, -1, self.num_heads, t.shape[-1] // self.num_heads).transpose(1, 2)

        out = multi_head_attention(split(self.to_q(x)), split(self.to_k(ctx)),
                                   split(self.to_v(ctx)), impl="xla")
        return self.to_out(out.transpose(1, 2).reshape(b, l, -1))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, context_dim: int):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=1e-5)
        self.attn1 = _Attn(dim, num_heads)
        self.norm2 = LayerNorm(dim, eps=1e-5)
        self.attn2 = _Attn(dim, num_heads, context_dim)
        self.norm3 = LayerNorm(dim, eps=1e-5)
        self.ff_proj = nn.Linear(dim, 8 * dim)
        self.ff_out = nn.Linear(4 * dim, dim)

    def forward(self, x, context):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        a, g = self.ff_proj(self.norm3(x)).chunk(2, dim=-1)  # GEGLU
        return x + self.ff_out(a * F.gelu(g))


class SpatialTransformer(nn.Module):
    def __init__(self, channels: int, num_heads: int, context_dim: int, depth: int = 1):
        super().__init__()
        self.norm = _gn(channels, eps=1e-6)  # LDM's attention Normalize
        self.proj_in = nn.Conv2d(channels, channels, 1)
        for i in range(depth):
            self.add_module(f"block_{i}", BasicTransformerBlock(channels, num_heads,
                                                                context_dim))
        self.depth = depth
        self.proj_out = nn.Conv2d(channels, channels, 1)

    def forward(self, x, context):
        b, c, h, w = x.shape
        t = self.proj_in(self.norm(x)).flatten(2).transpose(1, 2)  # (B, h*w, C), row-major
        for i in range(self.depth):
            t = getattr(self, f"block_{i}")(t, context)
        return self.proj_out(t.transpose(1, 2).reshape(b, c, h, w)) + x


class UNet2DCondition(nn.Module):
    """SD-1.x conditional UNet (+ optional panoptic mask stream).

    `context_dim` (the port's own argument) is the width of the context the
    caller passes when it is not `clip_dim`: the JAX module then creates
    `context_proj` on first call; here it is created up front."""

    def __init__(
        self,
        sample_size: int = 32,
        in_chans: int = 4,
        out_chans: int = 4,
        model_channels: int = 320,
        channel_mult: Sequence[int] = (1, 2, 4, 4),
        num_res_blocks: int = 2,
        num_heads: int = 8,
        clip_dim: int = 768,
        num_clip_token: int = 77,
        enable_panoptic: bool = False,
        mask_bits: int = 8,
        mask_size: int = 64,
        context_dim: Optional[int] = None,
    ):
        super().__init__()
        self.sample_size, self.mask_size = sample_size, mask_size
        self.channel_mult, self.num_res_blocks = tuple(channel_mult), num_res_blocks
        self.clip_dim, self.num_clip_token = clip_dim, num_clip_token
        self.enable_panoptic, self.mask_bits = enable_panoptic, mask_bits
        ch0 = model_channels
        temb = 4 * ch0
        self.time_fc1 = nn.Linear(ch0, temb)
        self.time_fc2 = nn.Linear(temb, temb)
        self.context_proj = (nn.Linear(context_dim, clip_dim)
                             if context_dim is not None and context_dim != clip_dim else None)
        self.conv_in = nn.Conv2d(in_chans, ch0, 3, padding=1)

        if enable_panoptic:
            steps, size = 0, mask_size
            while size > sample_size:
                steps, size = steps + 1, size // 2
            self.mask_down_steps = steps
            for i in range(steps):
                self.add_module(f"mask_down_{i}",
                                nn.Conv2d(mask_bits if i == 0 else ch0 // 2, ch0 // 2, 3, stride=2))
            self.mask_embed_conv = nn.Conv2d(ch0 // 2 if steps else mask_bits, ch0, 3, padding=1)
            self.mask_zero_gate = nn.Conv2d(ch0, ch0, 1)
            nn.init.zeros_(self.mask_zero_gate.weight)
            nn.init.zeros_(self.mask_zero_gate.bias)

        levels = len(self.channel_mult)
        ch_in, skips = ch0, [ch0]
        for i, mult in enumerate(self.channel_mult):
            ch = ch0 * mult
            for j in range(num_res_blocks):
                self.add_module(f"down_{i}_res_{j}", ResBlock(ch_in, ch, temb))
                ch_in = ch
                if i < levels - 1:  # SD: no attention at the deepest level
                    self.add_module(f"down_{i}_attn_{j}",
                                    SpatialTransformer(ch, num_heads, clip_dim))
                skips.append(ch)
            if i < levels - 1:
                self.add_module(f"down_{i}_downsample", nn.Conv2d(ch, ch, 3, stride=2))
                skips.append(ch)
        self.mid_res_1 = ResBlock(ch_in, ch_in, temb)
        self.mid_attn = SpatialTransformer(ch_in, num_heads, clip_dim)
        self.mid_res_2 = ResBlock(ch_in, ch_in, temb)
        for i, mult in reversed(list(enumerate(self.channel_mult))):
            ch = ch0 * mult
            for j in range(num_res_blocks + 1):
                self.add_module(f"up_{i}_res_{j}", ResBlock(ch_in + skips.pop(), ch, temb))
                ch_in = ch
                if i < levels - 1:
                    self.add_module(f"up_{i}_attn_{j}",
                                    SpatialTransformer(ch, num_heads, clip_dim))
            if i > 0:
                self.add_module(f"up_{i}_upsample", nn.Conv2d(ch, ch, 3, padding=1))
        assert not skips
        self.norm_out = _gn(ch_in)
        self.conv_out = nn.Conv2d(ch_in, out_chans, 3, padding=1)

        if enable_panoptic:
            cc, size, k = ch_in, sample_size, 0
            while size < mask_size:
                width = max(cc // 2, mask_bits * 4)
                self.add_module(f"mask_up_{k}", nn.Conv2d(cc, width, 3, padding=1))
                cc, size, k = width, size * 2, k + 1
            self.mask_up_steps = k
            self.mask_out = nn.Conv2d(cc, mask_bits, 3, padding=1)

    def forward(self, x, timesteps, context, mask_token=None, use_ground_truth=False):
        """x (B, in_chans, h, w) latents; timesteps (B,); context (B, L,
        clip_dim or context_dim); mask_token optional (B, mask_bits,
        mask_size, mask_size) analog bits.  Returns noise (B, out_chans, h,
        w), or (noise, mask_pred) when mask_token is given."""
        if mask_token is not None and not self.enable_panoptic:
            raise ValueError("mask_token given to a UNet2DCondition built with "
                             "enable_panoptic=False")
        dt = self.conv_in.weight.dtype
        temb = self.time_fc1(timestep_embedding(timesteps, self.time_fc1.in_features).to(dt))
        temb = self.time_fc2(F.silu(temb))
        if context.shape[-1] != self.clip_dim:
            if self.context_proj is None:
                raise ValueError(f"context width {context.shape[-1]} != clip_dim "
                                 f"{self.clip_dim}: build the UNet with context_dim="
                                 f"{context.shape[-1]}")
            context = self.context_proj(context.to(dt))
        else:
            context = context.to(dt)

        h = self.conv_in(x.to(dt))
        if mask_token is not None:
            # the mask encoder at latent resolution, zero-gated into conv_in's features
            m = mask_token.to(dt)
            for i in range(self.mask_down_steps):
                m = F.silu(conv_same_stride2(getattr(self, f"mask_down_{i}"), m))
            h = h + self.mask_zero_gate(self.mask_embed_conv(m))

        levels = len(self.channel_mult)
        skips = [h]
        for i in range(levels):
            for j in range(self.num_res_blocks):
                h = getattr(self, f"down_{i}_res_{j}")(h, temb)
                if i < levels - 1:
                    h = getattr(self, f"down_{i}_attn_{j}")(h, context)
                skips.append(h)
            if i < levels - 1:
                h = conv_same_stride2(getattr(self, f"down_{i}_downsample"), h)
                skips.append(h)
        h = self.mid_res_2(self.mid_attn(self.mid_res_1(h, temb), context), temb)
        for i in reversed(range(levels)):
            for j in range(self.num_res_blocks + 1):
                h = getattr(self, f"up_{i}_res_{j}")(torch.cat([h, skips.pop()], dim=1), temb)
                if i < levels - 1:
                    h = getattr(self, f"up_{i}_attn_{j}")(h, context)
            if i > 0:
                h = getattr(self, f"up_{i}_upsample")(_upsample2x(h))

        noise = self.conv_out(F.silu(self.norm_out(h)))
        if mask_token is None:
            return noise
        if use_ground_truth:
            return noise, mask_token
        m = h  # the mask head decodes the last up-path features
        for k in range(self.mask_up_steps):
            m = F.silu(getattr(self, f"mask_up_{k}")(_upsample2x(m)))
        return noise, torch.tanh(self.mask_out(m))
