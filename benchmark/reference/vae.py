"""Plain float32 decoder of the Stable-Diffusion KL autoencoder (f8, 4 latent
channels; Rombach et al., arXiv:2112.10752, the `ldm` AutoencoderKL), on a
dict of weights under the reference checkpoint's names.

Latents are scaled by 1 / scale_factor, then post_quant_conv (1x1), conv_in,
a middle of ResNet block, single-head spatial attention, ResNet block, then
four levels from the deepest (channel multipliers 4, 4, 2, 1 of 128; other
geometries in the CPU tests), each of three ResNet blocks and, but for the
last, a nearest 2x upsampling and a 3x3 convolution; GroupNorm(32, eps 1e-6)
+ SiLU and a 3x3 convolution to RGB.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

SD_F8 = {"ch": 128, "ch_mult": (1, 2, 4, 4), "num_res_blocks": 2}


def _conv(w, x, name, **kw):
    return F.conv2d(x, w[name + ".weight"], w[name + ".bias"], **kw)


def _norm(w, x, name):
    return F.group_norm(x, 32, w[name + ".weight"], w[name + ".bias"], 1e-6)


def _resnet(w, x, name):
    h = _conv(w, F.silu(_norm(w, x, name + ".norm1")), name + ".conv1", padding=1)
    h = _conv(w, F.silu(_norm(w, h, name + ".norm2")), name + ".conv2", padding=1)
    if name + ".nin_shortcut.weight" in w:
        x = _conv(w, x, name + ".nin_shortcut")
    return x + h


def _attn(w, x, name):
    b, c, hh, ww = x.shape
    h = _norm(w, x, name + ".norm")
    q = _conv(w, h, name + ".q").flatten(2).transpose(1, 2)
    k = _conv(w, h, name + ".k").flatten(2)
    v = _conv(w, h, name + ".v").flatten(2).transpose(1, 2)
    p = torch.softmax(torch.bmm(q, k) * c ** -0.5, dim=-1)
    o = torch.bmm(p, v).transpose(1, 2).reshape(b, c, hh, ww)
    return x + _conv(w, o, name + ".proj_out")


def decode(w, z, scale_factor, geometry=SD_F8):
    """Latents (B, 4, h, w) -> images (B, 3, 8h, 8w), roughly in [-1, 1]."""
    mult, nrb = geometry["ch_mult"], geometry["num_res_blocks"]
    h = _conv(w, z / scale_factor, "post_quant_conv")
    h = _conv(w, h, "decoder.conv_in", padding=1)
    h = _resnet(w, h, "decoder.mid.block_1")
    h = _attn(w, h, "decoder.mid.attn_1")
    h = _resnet(w, h, "decoder.mid.block_2")
    for level in reversed(range(len(mult))):
        for j in range(nrb + 1):
            h = _resnet(w, h, f"decoder.up.{level}.block.{j}")
        if level != 0:
            h = F.interpolate(h, scale_factor=2.0, mode="nearest")
            h = _conv(w, h, f"decoder.up.{level}.upsample.conv", padding=1)
    h = F.silu(_norm(w, h, "decoder.norm_out"))
    return _conv(w, h, "decoder.conv_out", padding=1)
