"""Text-to-image U-ViT with joint panoptic-mask co-generation, in PyTorch.

Port of `panopticdiffusionmodels_tpu/models/uvit_t2i.py::UViTT2I` with the
reference's parameter names (`libs/uvit_t2i.py`) and NCHW inputs:

  * image stream: tokens [time | 77 context | patches] with long skips;
  * mask stream (`separate=True`): analog-bit mask patches run through their
    own blocks on the concatenated sequence [x ; m]; after every block the
    image half of the mask stream goes through a zero-initialised Conv1d
    (`zero_convs.{2i+1}`, the reference's odd indices) and is added into x;
  * `separate=False`: one stream with the mask tokens appended;
  * mask head: decoder_pred_mask -> unpatchify(mask_bits) -> 3x3 conv -> tanh;
  * `use_ground_truth=True`: mask features are merged into the image features
    and the given mask is returned unchanged.

Blocks are unrolled; the JAX package's scanned layout is a compile-time
device there, and `utils/weights.py` unstacks it.  `use_checkpoint` /
`remat_policy` recompute each block's non-attention regions in backward
(`layers.Block`); `attn_impl='auto'` is the trainable attention.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .layers import (
    Block,
    LayerNorm,
    PatchEmbed,
    ZeroConv,
    conv3x3,
    time_embed,
    timestep_embedding,
    trunc_normal_init,
    unpatchify,
)


class UViTT2I(nn.Module):
    def __init__(
        self,
        img_size: int = 32,
        patch_size: int = 2,
        in_chans: int = 4,
        embed_dim: int = 512,
        depth: int = 12,
        num_heads: int = 8,
        mlp_ratio: float = 4.0,
        qkv_bias: bool = False,
        qk_scale: Optional[float] = None,
        mlp_time_embed: bool = False,
        clip_dim: int = 768,
        num_clip_token: int = 77,
        conv: bool = True,
        skip: bool = True,
        enable_panoptic: bool = True,
        separate: bool = True,
        mask_bits: int = 8,
        mask_size: int = 64,
        attn_impl: str = "infer",
        gelu_approx: bool = False,
        use_checkpoint: bool = False,
        remat_policy: Optional[str] = "save_attn",
    ):
        super().__init__()
        self.patch_size = patch_size
        self.in_chans = in_chans
        self.depth = depth
        self.conv = conv
        self.enable_panoptic = enable_panoptic
        self.separate = separate
        self.mask_bits = mask_bits
        self.extras = 1 + num_clip_token
        num_patches = (img_size // patch_size) ** 2
        assert mask_size % img_size == 0
        # keeps the mask token count equal to the image token count
        self.mask_patch_size = patch_size * (mask_size // img_size)

        def block(skip_on=False):
            return Block(embed_dim, num_heads, mlp_ratio, qkv_bias, qk_scale,
                         skip=skip_on, attn_impl=attn_impl, gelu_approx=gelu_approx,
                         use_checkpoint=use_checkpoint, remat_policy=remat_policy)

        half = depth // 2
        self.patch_embed = PatchEmbed(patch_size, in_chans, embed_dim)
        self.time_embed = time_embed(embed_dim, mlp_time_embed)
        self.context_embed = nn.Linear(clip_dim, embed_dim)
        pos_len = self.extras + (2 * num_patches if enable_panoptic and not separate
                                 else num_patches)
        self.pos_embed = nn.Parameter(torch.zeros(1, pos_len, embed_dim))
        self.in_blocks = nn.ModuleList(block() for _ in range(half))
        self.mid_block = block()
        self.out_blocks = nn.ModuleList(block(skip) for _ in range(half))
        self.norm = LayerNorm(embed_dim, eps=1e-5)
        self.decoder_pred = nn.Linear(embed_dim, patch_size ** 2 * in_chans)
        self.final_layer = conv3x3(in_chans) if conv else None
        if enable_panoptic:
            self.mask_embed = PatchEmbed(self.mask_patch_size, mask_bits, embed_dim)
            self.decoder_pred_mask = nn.Linear(embed_dim,
                                               self.mask_patch_size ** 2 * mask_bits)
            self.final_layer_mask = conv3x3(mask_bits) if conv else None
            if separate:
                self.pos_embed_mask = nn.Parameter(torch.zeros(1, num_patches, embed_dim))
                self.in_blocks_mask = nn.ModuleList(block() for _ in range(half))
                self.mid_block_mask = block()
                self.out_blocks_mask = nn.ModuleList(block(skip) for _ in range(half))
                # in_i -> 2i+1, mid -> 2*half+1, out_i -> 2*(half+1+i)+1
                self.zero_convs = nn.ModuleDict(
                    {str(2 * i + 1): ZeroConv(embed_dim) for i in range(depth + 1)})
        trunc_normal_init(self)
        nn.init.trunc_normal_(self.pos_embed, std=0.02)
        if enable_panoptic and separate:
            nn.init.trunc_normal_(self.pos_embed_mask, std=0.02)
            for zc in self.zero_convs.values():
                nn.init.zeros_(zc.conv.weight)
                nn.init.zeros_(zc.conv.bias)

    def forward(self, x, timesteps, context, mask_token=None, use_ground_truth=False):
        """x (B, C, h, w) latent; timesteps (B,); context (B, 77, clip_dim);
        mask_token optional (B, mask_bits, mask_size, mask_size) analog bits.
        Returns noise (B, C, h, w), or (noise, mask_pred) when mask_token is given."""
        dt = self.pos_embed.dtype
        x = self.patch_embed(x.to(dt))
        l = x.shape[1]
        t_emb = timestep_embedding(timesteps, x.shape[-1])
        time_token = self.time_embed(t_emb.to(dt)).to(x.dtype)[:, None, :]
        context_token = self.context_embed(context.to(dt))
        panoptic = self.enable_panoptic and mask_token is not None
        dual = panoptic and self.separate

        m = None
        if panoptic:
            mask_embedding = self.mask_embed(mask_token.to(dt))
            assert mask_embedding.shape[1] == l, "mask tokens must match image tokens"
            if not self.separate:
                x = torch.cat([time_token, context_token, x, mask_embedding], dim=1)
                x = x + self.pos_embed
            else:
                x = torch.cat([time_token, context_token, x], dim=1) + self.pos_embed
                m = mask_embedding + self.pos_embed_mask
        else:
            x = torch.cat([time_token, context_token, x], dim=1)
            x = x + self.pos_embed[:, : self.extras + l]

        img_len = self.extras + l
        half = self.depth // 2

        def couple(mx, x, index):
            """Gate the image half of the mask stream into x; keep its mask half."""
            return x + self.zero_convs[str(index)](mx[:, :img_len]), mx[:, img_len:]

        skips, skips_mask = [], []
        for i in range(half):
            if dual:
                mx = torch.cat([x, m], dim=1)
            x = self.in_blocks[i](x)
            if dual:
                mx = self.in_blocks_mask[i](mx)
                x, m = couple(mx, x, 2 * i + 1)
                skips_mask.append(mx)
            skips.append(x)
        if dual:
            mx = torch.cat([x, m], dim=1)
        x = self.mid_block(x)
        if dual:
            mx = self.mid_block_mask(mx)
            x, m = couple(mx, x, 2 * half + 1)
        for i in range(half):
            if dual:
                mx = torch.cat([x, m], dim=1)
            x = self.out_blocks[i](x, skips.pop())
            if dual:
                mx = self.out_blocks_mask[i](mx, skips_mask.pop())
                x, m = couple(mx, x, 2 * (half + 1 + i) + 1)

        x = self.norm(x)
        mask_pred = None
        if panoptic:
            if self.separate:
                image_feature, mask_feature = x[:, self.extras:], m
            else:
                image_feature = x[:, self.extras: self.extras + l]
                mask_feature = x[:, self.extras + l:]
            if use_ground_truth:
                noise = self.decoder_pred(image_feature + mask_feature)
                mask_pred = mask_token
            else:
                noise = self.decoder_pred(image_feature)
                y = unpatchify(self.decoder_pred_mask(mask_feature), self.mask_bits)
                if self.final_layer_mask is not None:
                    y = self.final_layer_mask(y)
                mask_pred = torch.tanh(y)
        else:
            noise = self.decoder_pred(x[:, self.extras: self.extras + l])
        noise = unpatchify(noise, self.in_chans)
        if self.final_layer is not None:
            noise = self.final_layer(noise)
        if mask_token is not None:
            return noise, mask_pred
        return noise
