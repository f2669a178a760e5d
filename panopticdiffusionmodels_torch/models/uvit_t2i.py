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

Sequence parallelism (`sp`, a `parallel.mesh` context, with
`attn_impl='ring'`): after the embeddings each stream is sharded on its own,
x (img_len tokens) and m (num_patches tokens), each padded at its end to a
multiple of sp (the pads masked as keys, dropped at the gather), and both
are gathered again before `norm` and the heads, whose unpatchify and 3x3
convs cross tokens.  In between every op is token-local except the ring
attention, as under the JAX package's `constrain_tokens`.

`forward` is `head(trunk(embed(...)))`, JAX's `stage="embed"` /
`stage="head"` split (`models/uvit_t2i.py:129, 228`); the trunk is made of
`in_layer` / `mid_layer` / `out_layer` (a dual layer is the image block,
the mask block and their zero conv, JAX's `_DualBody`), which
`parallel/pipeline.py` runs over pipeline stages.
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
        sp=None,
    ):
        super().__init__()
        self.sp = sp
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
                         use_checkpoint=use_checkpoint, remat_policy=remat_policy, sp=sp)

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

    def embed(self, x, timesteps, context, mask_token=None, use_ground_truth=False):
        """The stage before the blocks (JAX `stage="embed"`): (carry, ctx),
        carry (x, m) for the dual streams or (x,) for one (this rank's
        shards under sp), ctx what the layers and `head` need."""
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

        ctx = dict(l=l, panoptic=panoptic, dual=dual, mask_token=mask_token,
                   use_ground_truth=use_ground_truth, img_len=self.extras + l,
                   tokens=(x.shape[1], None if m is None else m.shape[1]), order=None)
        if self.sp is not None:
            self._shard(x, m, ctx)
            x = self.sp.shard(x)
            m = None if m is None else self.sp.shard(m)
        return ((x, m) if dual else (x,)), ctx

    def _shard(self, x, m, ctx) -> None:
        """Register the streams' per-shard token counts with the sp context
        and lay out the mask stream's shards.  Each stream is padded at its
        end and sharded on its own, so a shard of the mask stream is [x
        shard ; m shard], and `couple` splits it at the local img_len.  The
        mask stream's ring then sees its tokens in the order [x_0; m_0; x_1;
        m_1; ...], a permutation of [x ; m]: attention is equivariant under a
        permutation of its tokens (positions enter through pos_embed only),
        and every other op of a block is token-local, so each token's output
        is unchanged.  When x's pad rows would sit before real m rows in a
        shard, the ring (which masks a shard's keys from its count on) needs
        them at the end: the mask stream's blocks then run on each shard
        reordered as [x real ; m real ; x pads ; m pads] (`ctx['order']`,
        undone before `couple`)."""
        sp = self.sp
        n_x = x.shape[1]
        lx, cx = sp.padded(n_x), sp.contiguous_counts(n_x)
        sp.set_counts(lx, cx)
        ctx["img_len"] = lx
        if m is None:
            return
        lm, cm = sp.padded(m.shape[1]), sp.contiguous_counts(m.shape[1])
        sp.set_counts(lx + lm, [a + b for a, b in zip(cx, cm)])
        if all(c == lx or b == 0 for c, b in zip(cx, cm)):
            return  # the pads already form each shard's tail
        orders = []
        for s in sp.local_shards():
            orders.append(list(range(cx[s])) + list(range(lx, lx + cm[s]))
                          + list(range(cx[s], lx)) + list(range(lx + cm[s], lx + lm)))
        order = torch.tensor(orders, device=x.device).repeat_interleave(x.shape[0], 0)
        ctx["order"] = (order, torch.argsort(order, dim=1))

    @staticmethod
    def _reorder(mx, index):
        return torch.gather(mx, 1, index[..., None].expand(-1, -1, mx.shape[-1]))

    def _mx(self, x, m, ctx):
        """The mask stream's input [x ; m], in its shard order under sp."""
        mx = torch.cat([x, m], dim=1)
        return mx if ctx["order"] is None else self._reorder(mx, ctx["order"][0])

    def couple(self, mx, x, index, ctx):
        """Gate the image half of the mask stream into x; keep its mask half."""
        if ctx["order"] is not None:
            mx = self._reorder(mx, ctx["order"][1])
        n = ctx["img_len"]
        return x + self.zero_convs[str(index)](mx[:, :n]), mx[:, n:]

    def in_layer(self, i, carry, ctx):
        """In-layer i: the image block (and the mask block with its zero
        conv); returns (carry, the skips it leaves)."""
        if not ctx["dual"]:
            x = self.in_blocks[i](carry[0])
            return (x,), (x,)
        x, m = carry
        mx = self._mx(x, m, ctx)
        x = self.in_blocks[i](x)
        mx = self.in_blocks_mask[i](mx)
        x, m = self.couple(mx, x, 2 * i + 1, ctx)
        return (x, m), (x, mx)

    def mid_layer(self, carry, ctx):
        if not ctx["dual"]:
            return (self.mid_block(carry[0]),)
        x, m = carry
        mx = self._mx(x, m, ctx)
        x = self.mid_block(x)
        mx = self.mid_block_mask(mx)
        return self.couple(mx, x, 2 * (self.depth // 2) + 1, ctx)

    def out_layer(self, i, carry, skip, ctx):
        """Out-layer i on the skips of in-layer depth/2 - 1 - i."""
        if not ctx["dual"]:
            return (self.out_blocks[i](carry[0], skip[0]),)
        x, m = carry
        mx = self._mx(x, m, ctx)
        x = self.out_blocks[i](x, skip[0])
        mx = self.out_blocks_mask[i](mx, skip[1])
        return self.couple(mx, x, 2 * (self.depth // 2 + 1 + i) + 1, ctx)

    def trunk(self, carry, ctx):
        """The blocks: in-layers (skips pushed), mid, out-layers (popped)."""
        half = self.depth // 2
        skips = []
        for i in range(half):
            carry, skip = self.in_layer(i, carry, ctx)
            skips.append(skip)
        carry = self.mid_layer(carry, ctx)
        for i in range(half):
            carry = self.out_layer(i, carry, skips.pop(), ctx)
        return carry

    def head(self, carry, ctx):
        """The stage after the blocks (JAX `stage="head"`)."""
        x, m = carry if ctx["dual"] else (carry[0], None)
        if self.sp is not None:
            x = self.sp.gather(x, ctx["tokens"][0])
            m = None if m is None else self.sp.gather(m, ctx["tokens"][1])
        x = self.norm(x)
        l, mask_token = ctx["l"], ctx["mask_token"]
        mask_pred = None
        if ctx["panoptic"]:
            if self.separate:
                image_feature, mask_feature = x[:, self.extras:], m
            else:
                image_feature = x[:, self.extras: self.extras + l]
                mask_feature = x[:, self.extras + l:]
            if ctx["use_ground_truth"]:
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

    def forward(self, x, timesteps, context, mask_token=None, use_ground_truth=False):
        """x (B, C, h, w) latent; timesteps (B,); context (B, 77, clip_dim);
        mask_token optional (B, mask_bits, mask_size, mask_size) analog bits.
        Returns noise (B, C, h, w), or (noise, mask_pred) when mask_token is given."""
        carry, ctx = self.embed(x, timesteps, context, mask_token, use_ground_truth)
        return self.head(self.trunk(carry, ctx), ctx)
