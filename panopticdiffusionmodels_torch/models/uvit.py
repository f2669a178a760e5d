"""Unconditional / class-conditional U-ViT, in PyTorch.

Port of `panopticdiffusionmodels_tpu/models/uvit.py::UViT` with the
reference's parameter names (`libs/uvit.py`) and NCHW inputs:

  patchify -> [label token | time token | patches] + pos_embed
  -> depth/2 in-blocks (skips pushed) -> mid-block
  -> depth/2 out-blocks (skip_linear(cat(x, skip)))
  -> norm -> linear decode -> unpatchify -> 3x3 conv.

`num_classes` <= 0 is unconditional (one extra token, the time token);
> 0 puts a label token before the time token (two extras).  Blocks are
unrolled; `utils/weights.py::uvit_state_dict` unstacks the JAX package's
scanned layout.  `sp`, a sequence-parallel context (`parallel/mesh.py`),
shards the token stream after the embeddings (padded at its end to a
multiple of sp, the pad keys masked in the ring) and gathers it before the
head, with `attn_impl='ring'`, as JAX's `token_sharding` constrains the
tokens at every block boundary (`models/uvit.py:130-190`).  `forward` is
`head(trunk(embed(...)))`, JAX's `stage="embed"` / `stage="head"` split
(`models/uvit.py:93, 131`); `parallel/pipeline.py` runs the trunk's layers
(`in_layer`, `mid_layer`, `out_layer`) over pipeline stages.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .layers import (
    Block,
    LayerNorm,
    PatchEmbed,
    conv3x3,
    time_embed,
    timestep_embedding,
    trunc_normal_init,
    unpatchify,
)


class UViT(nn.Module):
    def __init__(
        self,
        img_size: int = 224,
        patch_size: int = 16,
        in_chans: int = 3,
        embed_dim: int = 768,
        depth: int = 12,
        num_heads: int = 12,
        mlp_ratio: float = 4.0,
        qkv_bias: bool = False,
        qk_scale: Optional[float] = None,
        mlp_time_embed: bool = False,
        num_classes: int = -1,
        use_checkpoint: bool = False,
        conv: bool = True,
        skip: bool = True,
        attn_impl: str = "infer",
        gelu_approx: bool = False,
        remat_policy: Optional[str] = "save_attn",
        sp=None,
    ):
        super().__init__()
        self.patch_size = patch_size
        self.in_chans = in_chans
        self.num_classes = num_classes
        self.extras = 2 if num_classes > 0 else 1
        self.sp = sp
        num_patches = (img_size // patch_size) ** 2

        def block(skip_on=False):
            return Block(embed_dim, num_heads, mlp_ratio, qkv_bias, qk_scale,
                         skip=skip_on, attn_impl=attn_impl, gelu_approx=gelu_approx,
                         use_checkpoint=use_checkpoint, remat_policy=remat_policy, sp=sp)

        half = depth // 2
        self.patch_embed = PatchEmbed(patch_size, in_chans, embed_dim)
        self.time_embed = time_embed(embed_dim, mlp_time_embed)
        if num_classes > 0:
            self.label_emb = nn.Embedding(num_classes, embed_dim)
        self.pos_embed = nn.Parameter(torch.zeros(1, self.extras + num_patches, embed_dim))
        self.in_blocks = nn.ModuleList(block() for _ in range(half))
        self.mid_block = block()
        self.out_blocks = nn.ModuleList(block(skip) for _ in range(half))
        self.norm = LayerNorm(embed_dim, eps=1e-5)
        self.decoder_pred = nn.Linear(embed_dim, patch_size ** 2 * in_chans)
        self.final_layer = conv3x3(in_chans) if conv else None
        trunc_normal_init(self)
        nn.init.trunc_normal_(self.pos_embed, std=0.02)
        if num_classes > 0:
            nn.init.trunc_normal_(self.label_emb.weight, std=0.02)

    def embed(self, x, timesteps, y=None):
        """The stage before the blocks (JAX `stage="embed"`): (carry, ctx),
        carry the token stream as a 1-tuple (this rank's shard under sp),
        ctx what `head` needs."""
        dt = self.pos_embed.dtype
        x = self.patch_embed(x.to(dt))
        ctx = dict(l=x.shape[1])
        t_emb = timestep_embedding(timesteps, x.shape[-1])
        x = torch.cat([self.time_embed(t_emb.to(dt)).to(x.dtype)[:, None, :], x], dim=1)
        if self.num_classes > 0:
            if y is None:
                raise ValueError("class-conditional UViT: labels y are required")
            x = torch.cat([self.label_emb(y)[:, None, :], x], dim=1)
        x = x + self.pos_embed
        ctx["tokens"] = x.shape[1]
        if self.sp is not None:  # this rank's token shard through the blocks
            self.sp.set_counts(self.sp.padded(x.shape[1]),
                               self.sp.contiguous_counts(x.shape[1]))
            x = self.sp.shard(x)
        return (x,), ctx

    def in_layer(self, i, carry, ctx):
        """In-block i: (carry, the skip it leaves)."""
        x = self.in_blocks[i](carry[0])
        return (x,), x

    def mid_layer(self, carry, ctx):
        return (self.mid_block(carry[0]),)

    def out_layer(self, i, carry, skip, ctx):
        """Out-block i on the skip of in-block depth/2 - 1 - i."""
        return (self.out_blocks[i](carry[0], skip),)

    def trunk(self, carry, ctx):
        """The blocks: in-blocks (skips pushed), mid, out-blocks (popped)."""
        skips = []
        for i in range(len(self.in_blocks)):
            carry, skip = self.in_layer(i, carry, ctx)
            skips.append(skip)
        carry = self.mid_layer(carry, ctx)
        for i in range(len(self.out_blocks)):
            carry = self.out_layer(i, carry, skips.pop(), ctx)
        return carry

    def head(self, carry, ctx):
        """The stage after the blocks (JAX `stage="head"`)."""
        x = carry[0]
        if self.sp is not None:
            x = self.sp.gather(x, ctx["tokens"])
        x = self.decoder_pred(self.norm(x))
        assert x.shape[1] == self.extras + ctx["l"]
        x = unpatchify(x[:, self.extras:], self.in_chans)
        return x if self.final_layer is None else self.final_layer(x)

    def forward(self, x, timesteps, y=None):
        """x (B, C, h, w); timesteps (B,); y (B,) int labels for a
        class-conditional model.  Returns (B, C, h, w)."""
        carry, ctx = self.embed(x, timesteps, y)
        return self.head(self.trunk(carry, ctx), ctx)
