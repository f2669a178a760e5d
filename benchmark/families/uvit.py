"""The class-conditional U-ViT (arXiv:2209.12152): operation counts from its
sizes, its conditioning, and its plain reference's name.

Tokens are [label | time | patches]; depth + 1 blocks (depth/2 in, one mid,
depth/2 out with a skip projection), each qkv, proj, fc1, fc2 and attention.
"""
from __future__ import annotations

import torch

from .. import work

REFERENCE = "uvit"


def _tokens(s):
    patches = (s["img_size"] // s["patch_size"]) ** 2
    return patches, patches + (2 if s.get("num_classes", -1) > 0 else 1)


def _block_linear(s, t, skip):
    c, r = s["embed_dim"], s["mlp_ratio"]
    f = work.linear(t, c, 3 * c) + work.linear(t, c, c) + 2 * work.linear(t, c, int(r * c))
    return f + (work.linear(t, 2 * c, c) if skip else 0)


def _parts(s, b):
    """(embedding ops, block linear ops, attention ops, head ops) at batch b."""
    patches, t = _tokens(s)
    c, p, ch, half = s["embed_dim"], s["patch_size"], s["in_chans"], s["depth"] // 2
    embed = work.linear(patches, p * p * ch, c)
    blocks = (half + 1) * _block_linear(s, t, False) + half * _block_linear(s, t, True)
    attn = (2 * half + 1) * 4 * t * t * c
    head = work.linear(patches, c, p * p * ch) + work.conv(s["img_size"], s["img_size"], ch, ch, 3)
    return b * embed, b * blocks, b * attn, b * head


def forward_flops(s, b):
    return sum(_parts(s, b))


def train_flops(s, b, fine_tune=False):
    """Forward, input gradients and weight gradients of every trained layer
    (nothing is frozen in this family); no input gradient of the patch
    embedding, no recompute."""
    embed, blocks, attn, head = _parts(s, b)
    return 2 * embed + 3 * (blocks + attn + head)


def attention_calls(s, b):
    """[(B, L, H, D, calls)] of one forward."""
    _, t = _tokens(s)
    h = s["num_heads"]
    return [(b, t, h, s["embed_dim"] // h, s["depth"] + 1)]


def draw_cond(s, n, gen, device):
    """n class labels of the ImageNet classes (the null class excluded)."""
    return torch.randint(0, s["num_classes"] - 1, (n,), generator=gen, device=device)


def request(cond):
    return {"labels": cond.cpu().numpy()}


def uncond(s, gen, device):
    return s["num_classes"] - 1
