"""The dual-stream panoptic U-ViT-T2I: operation counts from its sizes, its
conditioning, and its plain reference's name.

The image stream runs depth + 1 blocks on [time | context | patches]; the
mask stream runs as many on [image tokens ; mask tokens]; after each layer a
1x1 convolution of the mask stream's image half joins the image stream.
Fine-tuning leaves the image stream's blocks and embeddings out of the
optimizer: their weights take no gradient, but the gradient still flows
through them to the trained position table, couplings and mask stream.
"""
from __future__ import annotations

import torch

from .. import work

REFERENCE = "uvit_t2i"


def _lengths(s):
    patches = (s["img_size"] // s["patch_size"]) ** 2
    image = 1 + s["num_clip_token"] + patches
    return patches, image, image + patches


def _block_linear(s, t, skip):
    c, r = s["embed_dim"], s["mlp_ratio"]
    f = work.linear(t, c, 3 * c) + work.linear(t, c, c) + 2 * work.linear(t, c, int(r * c))
    return f + (work.linear(t, 2 * c, c) if skip else 0)


def _stream(s, t):
    half = s["depth"] // 2
    lin = (half + 1) * _block_linear(s, t, False) + half * _block_linear(s, t, True)
    return lin, (2 * half + 1) * 4 * t * t * s["embed_dim"]


def _parts(s, b):
    """Ops at batch b: (image embeddings, image blocks' linears, image
    attention, mask embedding, mask blocks' linears, mask attention,
    couplings and heads)."""
    patches, lx, lm = _lengths(s)
    c, p, ch, bits = s["embed_dim"], s["patch_size"], s["in_chans"], s["mask_bits"]
    mp = p * (s["mask_size"] // s["img_size"])
    image_embed = (work.linear(patches, p * p * ch, c)
                   + work.linear(s["num_clip_token"], s["clip_dim"], c))
    image_lin, image_attn = _stream(s, lx)
    mask_embed = work.linear(patches, mp * mp * bits, c)
    mask_lin, mask_attn = _stream(s, lm)
    heads = ((s["depth"] + 1) * work.linear(lx, c, c)
             + work.linear(patches, c, p * p * ch) + work.linear(patches, c, mp * mp * bits)
             + work.conv(s["img_size"], s["img_size"], ch, ch, 3)
             + work.conv(s["mask_size"], s["mask_size"], bits, bits, 3))
    return tuple(b * x for x in (image_embed, image_lin, image_attn, mask_embed, mask_lin,
                                 mask_attn, heads))


def forward_flops(s, b):
    return sum(_parts(s, b))


def train_flops(s, b, fine_tune=True):
    """Forward of everything; input gradients of every layer the gradient
    crosses (not of the embeddings, whose inputs are data); weight gradients
    of the trained layers only: under fine-tuning not the image stream's
    blocks and embeddings.  Attention: 4 L^2 C forward, 8 L^2 C backward."""
    ie, il, ia, me, ml, ma, hd = _parts(s, b)
    image_w = 0 if fine_tune else 1
    return ((1 + image_w) * ie + (2 + image_w) * il + 3 * ia
            + 2 * me + 3 * (ml + ma + hd))


def attention_calls(s, b):
    """[(B, L, H, D, calls)] of one forward: each stream's blocks."""
    _, lx, lm = _lengths(s)
    h, n = s["num_heads"], s["depth"] + 1
    d = s["embed_dim"] // h
    return [(b, lx, h, d, n), (b, lm, h, d, n)]


def draw_cond(s, n, gen, device):
    """n CLIP contexts (77 x clip_dim), drawn from N(0, 1)."""
    return torch.randn((n, s["num_clip_token"], s["clip_dim"]), generator=gen, device=device)


def request(cond):
    return {"contexts": cond}


def uncond(s, gen, device):
    """The empty context, drawn like the others."""
    return torch.randn((s["num_clip_token"], s["clip_dim"]), generator=gen, device=device)
