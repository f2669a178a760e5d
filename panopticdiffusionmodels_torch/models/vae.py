"""The frozen Stable-Diffusion KL autoencoder, in PyTorch (NCHW, reference names).

Port of `panopticdiffusionmodels_tpu/models/vae.py`: ResnetBlocks of
GroupNorm-32 (eps 1e-6) + swish, one single-head attention block in the
middle, stride-2 downsampling with the reference's asymmetric (0, 1, 0, 1)
padding, nearest-2x + conv upsampling.  Parameter names follow
`libs/autoencoder.py`, so the reference `autoencoder_kl.pth` loads with
`strict=True`.  Serving only decodes; the encoder is here for that load.
Training reads pre-encoded moments through `sample_from_moments`.

`dtype` is the compute dtype, as the JAX `get_model(dtype=...)`: the
parameters stay float32 (flax's param_dtype) and every convolution runs in
`dtype`; GroupNorm computes its statistics and affine in float32 and returns
`dtype`, as flax's GroupNorm does; the attention logits and softmax are
float32.  The default is float32.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


class GroupNorm(nn.GroupNorm):
    """Statistics and affine in float32, the result in the input's dtype."""

    def forward(self, x):
        return F.group_norm(x.float(), self.num_groups, self.weight.float(),
                            self.bias.float(), self.eps).to(x.dtype)


class Conv2d(nn.Conv2d):
    """A convolution in the input's dtype over float32 parameters."""

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


def _norm(c: int) -> GroupNorm:
    return GroupNorm(32, c, eps=1e-6)


class ResnetBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.norm1 = _norm(in_channels)
        self.conv1 = Conv2d(in_channels, out_channels, 3, padding=1)
        self.norm2 = _norm(out_channels)
        self.conv2 = Conv2d(out_channels, out_channels, 3, padding=1)
        self.nin_shortcut = (Conv2d(in_channels, out_channels, 1)
                             if in_channels != out_channels else None)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head spatial self-attention over the H*W tokens."""

    def __init__(self, c: int):
        super().__init__()
        self.norm = _norm(c)
        self.q = Conv2d(c, c, 1)
        self.k = Conv2d(c, c, 1)
        self.v = Conv2d(c, c, 1)
        self.proj_out = Conv2d(c, c, 1)

    def forward(self, x):
        b, c, h, w = x.shape
        hid = self.norm(x)
        q = self.q(hid).flatten(2).transpose(1, 2)  # (B, HW, C)
        k = self.k(hid).flatten(2)                  # (B, C, HW)
        v = self.v(hid).flatten(2).transpose(1, 2)
        attn = torch.softmax(torch.bmm(q.float(), k.float()) * c ** -0.5, dim=-1)
        out = torch.bmm(attn.to(v.dtype), v)        # (B, HW, C)
        out = out.transpose(1, 2).reshape(b, c, h, w)
        return x + self.proj_out(out)


class Downsample(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = Conv2d(c, c, 3, stride=2)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = Conv2d(c, c, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class _Mid(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.block_1 = ResnetBlock(c, c)
        self.attn_1 = AttnBlock(c)
        self.block_2 = ResnetBlock(c, c)

    def forward(self, x):
        return self.block_2(self.attn_1(self.block_1(x)))


class Encoder(nn.Module):
    def __init__(self, ch=128, ch_mult=(1, 2, 4, 4), num_res_blocks=2, in_channels=3,
                 z_channels=4, double_z=True):
        super().__init__()
        self.conv_in = Conv2d(in_channels, ch, 3, padding=1)
        self.down = nn.ModuleList()
        block_in = ch
        for i, mult in enumerate(ch_mult):
            level = nn.Module()
            level.block = nn.ModuleList()
            for _ in range(num_res_blocks):
                level.block.append(ResnetBlock(block_in, ch * mult))
                block_in = ch * mult
            if i != len(ch_mult) - 1:
                level.downsample = Downsample(block_in)
            self.down.append(level)
        self.mid = _Mid(block_in)
        self.norm_out = _norm(block_in)
        self.conv_out = Conv2d(block_in, 2 * z_channels if double_z else z_channels,
                                  3, padding=1)

    def forward(self, x):
        h = self.conv_in(x)
        for level in self.down:
            for blk in level.block:
                h = blk(h)
            if hasattr(level, "downsample"):
                h = level.downsample(h)
        h = self.mid(h)
        return self.conv_out(F.silu(self.norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, ch=128, ch_mult=(1, 2, 4, 4), num_res_blocks=2, out_ch=3,
                 z_channels=4):
        super().__init__()
        block_in = ch * ch_mult[-1]
        self.conv_in = Conv2d(z_channels, block_in, 3, padding=1)
        self.mid = _Mid(block_in)
        up = [None] * len(ch_mult)
        for i in reversed(range(len(ch_mult))):
            level = nn.Module()
            level.block = nn.ModuleList()
            for _ in range(num_res_blocks + 1):
                level.block.append(ResnetBlock(block_in, ch * ch_mult[i]))
                block_in = ch * ch_mult[i]
            if i != 0:
                level.upsample = Upsample(block_in)
            up[i] = level
        self.up = nn.ModuleList(up)
        self.norm_out = _norm(block_in)
        self.conv_out = Conv2d(block_in, out_ch, 3, padding=1)

    def forward(self, z):
        h = self.mid(self.conv_in(z))
        for level in reversed(self.up):
            for blk in level.block:
                h = blk(h)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        return self.conv_out(F.silu(self.norm_out(h)))


class AutoencoderKL(nn.Module):
    def __init__(self, ch: int = 128, ch_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2, z_channels: int = 4, embed_dim: int = 4,
                 out_ch: int = 3, scale_factor: float = 0.18215,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.scale_factor = scale_factor
        self.compute_dtype = dtype
        self.encoder = Encoder(ch, ch_mult, num_res_blocks, out_ch, z_channels)
        self.decoder = Decoder(ch, ch_mult, num_res_blocks, out_ch, z_channels)
        self.quant_conv = Conv2d(2 * z_channels, 2 * embed_dim, 1)
        self.post_quant_conv = Conv2d(embed_dim, z_channels, 1)

    def encode_moments(self, x):
        return self.quant_conv(self.encoder(x.to(self.compute_dtype)))

    def decode(self, z):
        """Latents (B, C, h, w) -> images (B, 3, 8h, 8w) in the compute dtype."""
        z = ((1.0 / self.scale_factor) * z).to(self.compute_dtype)
        return self.decoder(self.post_quant_conv(z))


def sample_from_moments(moments: torch.Tensor, scale_factor: float = 0.18215,
                        noise: torch.Tensor = None, generator: torch.Generator = None):
    """Reparameterised draw from pre-extracted moments, channel-last
    (..., 2*C) -> (..., C): the training hot path reads (mean, logvar)
    features (JAX `models/vae.py::sample_from_moments`).  `noise` is the
    standard-normal draw; without it one is taken from `generator`."""
    mean, logvar = torch.chunk(moments, 2, dim=-1)
    logvar = torch.clamp(logvar, -30.0, 20.0)
    std = torch.exp(0.5 * logvar)
    if noise is None:
        noise = torch.randn(mean.shape, generator=generator, dtype=mean.dtype,
                            device=mean.device)
    return scale_factor * (mean + std * noise)


def get_model(scale_factor: float = 0.18215, dtype: torch.dtype = torch.float32) -> AutoencoderKL:
    """The SD f8 KL-VAE configuration, computing in `dtype`."""
    return AutoencoderKL(scale_factor=scale_factor, dtype=dtype)
