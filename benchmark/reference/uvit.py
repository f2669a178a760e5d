"""Plain float32 U-ViT and dual-stream U-ViT-T2I forwards, from the papers'
descriptions (U-ViT, arXiv:2209.12152; the panoptic co-generation model's
mask stream), written with plain torch operations on a dict of weights.

Nothing here imports the program: the weights are handed in by name (the
reference checkpoints' names, which the program also loads), every product
is an f32 matmul or convolution, and attention is softmax(q k^T / sqrt(d)) v
spelled out.  `lin` and `conv` take a `quant` callable, identity for the
reference; the lower-precision control passes a rounding to fp8 there.

Layout of the U-ViT: tokens [label | time | patches] (+ pos_embed), depth/2
in-blocks whose outputs are kept as long skips, a mid-block, depth/2
out-blocks that first project cat(x, skip), then LayerNorm, a linear patch
decoder, unpatchify and a 3x3 convolution.  The dual-stream model runs an
image stream on [time | 77 context | patches] and a mask stream on the
concatenation [image tokens ; mask tokens]; after each layer a 1x1
convolution of the mask stream's image half is added to the image stream.
The mask head reads the mask stream's last tokens without the final
LayerNorm, decodes analog bits and takes tanh.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def identity(t):
    return t


def lin(w, x, name, quant=identity):
    """x @ W^T + b for the weights `name`.weight / `name`.bias (bias optional)."""
    weight = quant(w[name + ".weight"])
    bias = w.get(name + ".bias")
    return F.linear(quant(x), weight, bias)


def conv(w, x, name, quant=identity, **kw):
    return F.conv2d(quant(x), quant(w[name + ".weight"]), w.get(name + ".bias"), **kw)


def layer_norm(w, x, name, eps=1e-5):
    return F.layer_norm(x, (x.shape[-1],), w[name + ".weight"], w[name + ".bias"], eps)


def timestep_embedding(t, dim, max_period=10000.0):
    """[cos | sin] sinusoidal embedding of (B,) times, as the U-ViT code."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def attention(w, x, name, heads, quant=identity):
    b, l, c = x.shape
    d = c // heads
    qkv = lin(w, x, name + ".qkv", quant).reshape(b, l, 3, heads, d).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    s = torch.matmul(quant(q), quant(k).transpose(-1, -2)) * d ** -0.5
    p = torch.softmax(s, dim=-1)
    o = torch.matmul(quant(p), quant(v)).transpose(1, 2).reshape(b, l, c)
    return lin(w, o, name + ".proj", quant)


def block(w, x, name, heads, skip=None, quant=identity, gelu="none"):
    if skip is not None:
        x = lin(w, torch.cat([x, skip], dim=-1), name + ".skip_linear", quant)
    x = x + attention(w, layer_norm(w, x, name + ".norm1"), name + ".attn", heads, quant)
    h = lin(w, layer_norm(w, x, name + ".norm2"), name + ".mlp.fc1", quant)
    return x + lin(w, F.gelu(h, approximate=gelu), name + ".mlp.fc2", quant)


def patchify(w, x, name, patch, quant=identity):
    return conv(w, x, name, quant, stride=patch).flatten(2).transpose(1, 2)


def unpatchify(x, channels):
    """(B, h*w, p*p*C) -> (B, C, h*p, w*p), each patch vector ordered (p1, p2, C)."""
    b, l, pd = x.shape
    h = int(round(l ** 0.5))
    p = int(round((pd // channels) ** 0.5))
    x = x.reshape(b, h, h, p, p, channels).permute(0, 5, 1, 3, 2, 4)
    return x.reshape(b, channels, h * p, h * p)


def uvit(w, sizes, x, t, y=None, quant=identity):
    """Class-conditional (or unconditional) U-ViT: x (B, C, H, W), t (B,)
    float timesteps, y (B,) int labels.  Returns the noise prediction."""
    heads, half = sizes["num_heads"], sizes["depth"] // 2
    tok = patchify(w, x, "patch_embed.proj", sizes["patch_size"], quant)
    l = tok.shape[1]
    extras = [timestep_embedding(t, tok.shape[-1])[:, None]]
    if sizes.get("num_classes", -1) > 0:
        extras.insert(0, w["label_emb.weight"][y][:, None])
    h = torch.cat([*extras, tok], dim=1) + w["pos_embed"]
    skips = []
    for i in range(half):
        h = block(w, h, f"in_blocks.{i}", heads, quant=quant)
        skips.append(h)
    h = block(w, h, "mid_block", heads, quant=quant)
    for i in range(half):
        h = block(w, h, f"out_blocks.{i}", heads, skips.pop(), quant)
    h = lin(w, layer_norm(w, h, "norm"), "decoder_pred", quant)
    out = unpatchify(h[:, h.shape[1] - l:], sizes["in_chans"])
    return conv(w, out, "final_layer", quant, padding=1)


def zero_conv(w, x, index, quant=identity):
    weight = w[f"zero_convs.{index}.conv.weight"][:, :, 0]
    return F.linear(quant(x), quant(weight), w[f"zero_convs.{index}.conv.bias"])


def uvit_t2i(w, sizes, x, t, context, mask, quant=identity):
    """The dual-stream panoptic U-ViT: x (B, C, h, w) latents, t (B,) float
    timesteps, context (B, 77, clip_dim), mask (B, bits, S, S) analog bits.
    Returns (noise prediction, mask prediction in (-1, 1))."""
    heads, half = sizes["num_heads"], sizes["depth"] // 2
    patch = sizes["patch_size"]
    mask_patch = patch * (sizes["mask_size"] // sizes["img_size"])
    tok = patchify(w, x, "patch_embed.proj", patch, quant)
    l = tok.shape[1]
    time = timestep_embedding(t, tok.shape[-1])[:, None]
    ctx = lin(w, context, "context_embed", quant)
    xs = torch.cat([time, ctx, tok], dim=1) + w["pos_embed"]
    ms = patchify(w, mask, "mask_embed.proj", mask_patch, quant) + w["pos_embed_mask"]
    n_img = xs.shape[1]

    def layer(xs, ms, image, masked, index, skip=None):
        mx = torch.cat([xs, ms], dim=1)
        xs = block(w, xs, image, heads, None if skip is None else skip[0], quant)
        mx = block(w, mx, masked, heads, None if skip is None else skip[1], quant)
        return xs + zero_conv(w, mx[:, :n_img], index, quant), mx[:, n_img:], mx

    skips = []
    for i in range(half):
        xs, ms, mx = layer(xs, ms, f"in_blocks.{i}", f"in_blocks_mask.{i}", 2 * i + 1)
        skips.append((xs, mx))
    xs, ms, _ = layer(xs, ms, "mid_block", "mid_block_mask", 2 * half + 1)
    for i in range(half):
        xs, ms, _ = layer(xs, ms, f"out_blocks.{i}", f"out_blocks_mask.{i}",
                          2 * (half + 1 + i) + 1, skips.pop())
    xs = layer_norm(w, xs, "norm")
    noise = unpatchify(lin(w, xs[:, n_img - l:], "decoder_pred", quant), sizes["in_chans"])
    noise = conv(w, noise, "final_layer", quant, padding=1)
    m = unpatchify(lin(w, ms, "decoder_pred_mask", quant), sizes["mask_bits"])
    m = conv(w, m, "final_layer_mask", quant, padding=1)
    return noise, torch.tanh(m)
