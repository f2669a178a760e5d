"""Tensor parallelism over the mesh axis `tp`: column- and row-parallel
Linear layers, their collectives, and the carry of whole tensors to a
rank's slices and back.

Port of `panopticdiffusionmodels_tpu/parallel/sharding.py`'s tp rule
(`sharding.py:26-31, 56-62`): the Linear layers named `qkv`, `fc1`, `to_q`,
`to_k`, `to_v`, `ff_proj` split their output features (column-parallel),
those named `proj`, `fc2`, `to_out`, `ff_out` their input features
(row-parallel); every other parameter is replicated.  Where JAX shards the
kernels by annotation and its partitioner adds the collectives, here
`shard_model` swaps each such layer for one holding this rank's slice:

  * a column-parallel layer's input goes through `_CopyToTP` (identity
    forward; backward, the all-reduce of the input's gradient over tp);
  * a row-parallel layer's output goes through `_ReduceFromTP` (forward,
    the all-reduce of the partial products; identity backward), and its
    bias is added once, after the sum.

Both all-reduces sum in f32 (cast back to the input's dtype).

The splits keep whole heads and whole GEGLU pairs on a rank:

  * `qkv` packs [q | k | v] (3C outputs); rank r holds [q_r | k_r | v_r],
    the columns of heads [r*H/tp, (r+1)*H/tp), so the attention kernels
    see (B, L, 3C/tp) with H/tp whole heads.  JAX cuts the 3C axis in tp
    contiguous pieces and its partitioner reshards; the numbers are the
    same;
  * the UNet's `ff_proj` packs [value | gate] (`chunk(2)`); rank r holds
    [value_r | gate_r], its values with their own gates.

A rank's Attention (and the UNet's `_Attn`) then runs H/tp heads.
Everything else (norms, embeddings, heads, biases of row-parallel layers,
convolutions) is replicated, and its gradient is the same on every tp rank
(the column-parallel backward all-reduce makes the residual stream's
gradient whole), so it needs no collective.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

COLUMN = ("qkv", "fc1", "to_q", "to_k", "to_v", "ff_proj")
ROW = ("proj", "fc2", "to_out", "ff_out")
# Output features packed as consecutive parts, each split on its own.
PARTS = {"qkv": 3, "ff_proj": 2}


def _all_reduce_f32(x: torch.Tensor, group) -> torch.Tensor:
    y = x.float().contiguous().clone()
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_f32(g, ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce_f32(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class ColumnParallelLinear(nn.Linear):
    """This rank's output features of a Linear; the input's gradient is
    summed over tp."""

    def __init__(self, in_features, out_features, bias, group, device=None, dtype=None):
        super().__init__(in_features, out_features, bias=bias, device=device, dtype=dtype)
        self.group = group

    def forward(self, x):
        return F.linear(_CopyToTP.apply(x, self.group), self.weight, self.bias)


class RowParallelLinear(nn.Linear):
    """This rank's input features of a Linear; the partial products are
    summed over tp, then the (replicated) bias is added."""

    def __init__(self, in_features, out_features, bias, group, device=None, dtype=None):
        super().__init__(in_features, out_features, bias=bias, device=device, dtype=dtype)
        self.group = group

    def forward(self, x):
        y = _ReduceFromTP.apply(F.linear(x, self.weight), self.group)
        return y if self.bias is None else y + self.bias


def split(t: torch.Tensor, rule: Tuple[int, int], tp: int, rank: int) -> torch.Tensor:
    """Rank `rank`'s slice of a whole tensor under `rule` = (dim, parts)."""
    dim, parts = rule
    return torch.cat([p.chunk(tp, dim)[rank] for p in t.chunk(parts, dim)], dim).contiguous()


def join(slices, rule: Tuple[int, int]) -> torch.Tensor:
    """The whole tensor from every rank's slice (inverse of `split`)."""
    dim, parts = rule
    pieces = [s.chunk(parts, dim) for s in slices]
    return torch.cat([torch.cat([p[i] for p in pieces], dim) for i in range(parts)], dim)


def rules_of(model: nn.Module) -> Dict[str, Tuple[int, int]]:
    """{parameter name: (dim, parts)} of every tp-split parameter of a
    model, by JAX's name rules; the names are the model's own."""
    rules = {}
    for mod_name, module in model.named_modules():
        if not isinstance(module, nn.Linear):
            continue
        owner = mod_name.rsplit(".", 1)[-1]
        prefix = f"{mod_name}." if mod_name else ""
        if owner in COLUMN:
            parts = PARTS.get(owner, 1)
            rules[prefix + "weight"] = (0, parts)
            if module.bias is not None:
                rules[prefix + "bias"] = (0, parts)
        elif owner in ROW:
            rules[prefix + "weight"] = (1, 1)
    return rules


def _check(model: nn.Module, tp: int) -> None:
    from ..models.layers import Attention
    from ..models.unet import _Attn

    for name, module in model.named_modules():
        if isinstance(module, (Attention, _Attn)) and module.num_heads % tp:
            raise ValueError(f"mesh.tp = {tp} must divide the heads of {name} "
                             f"({module.num_heads}): the port splits qkv per head")
        if isinstance(module, nn.Linear):
            owner = name.rsplit(".", 1)[-1]
            feats = module.out_features // PARTS.get(owner, 1) if owner in COLUMN else \
                module.in_features if owner in ROW else 0
            if feats % tp:
                raise ValueError(f"mesh.tp = {tp} does not divide the {feats} features of "
                                 f"{name}")


def shard_model(model: nn.Module, group, tp: int, rank: int) -> Dict[str, Tuple[int, int]]:
    """Swap every tp-split Linear of `model` for this rank's slice of it
    (the model's whole weights, the same on every rank, are cut here),
    and run its attentions on H/tp heads; returns `rules_of` the whole
    model.  In place."""
    from ..models.layers import Attention
    from ..models.unet import _Attn

    _check(model, tp)
    rules = rules_of(model)
    for parent in list(model.modules()):
        for name, child in list(parent.named_children()):
            if not isinstance(child, nn.Linear) or name not in COLUMN + ROW:
                continue
            col = name in COLUMN
            rule = (0, PARTS.get(name, 1)) if col else (1, 1)
            w = split(child.weight.detach(), rule, tp, rank)
            cls = ColumnParallelLinear if col else RowParallelLinear
            new = nn.utils.skip_init(cls, w.shape[1], w.shape[0], child.bias is not None, group,
                                     device=child.weight.device, dtype=child.weight.dtype)
            with torch.no_grad():
                new.weight.copy_(w)
                if child.bias is not None:
                    new.bias.copy_(split(child.bias.detach(), (0, rule[1]), tp, rank)
                                   if col else child.bias.detach())
            new.weight.requires_grad_(child.weight.requires_grad)
            setattr(parent, name, new)
    for module in model.modules():
        if isinstance(module, (Attention, _Attn)):
            module.num_heads //= tp
    return rules


def gather(t: torch.Tensor, rule: Tuple[int, int], group, tp: int) -> torch.Tensor:
    """The whole tensor from this rank's slice `t`; a collective over tp."""
    out = t.new_empty((tp * t.shape[0], *t.shape[1:]))
    dist.all_gather_into_tensor(out, t.contiguous(), group=group)
    return join(list(out.chunk(tp)), rule)
