"""Fully sharded data parallelism: the network's parameters sharded over the
layout's fsdp axis with FSDP2's `fully_shard`, and the gathers and scatters
that checkpoints and the gradient norm need.

Port of `panopticdiffusionmodels_tpu/parallel/sharding.py`'s fsdp rule.  JAX
shards each tensor of >= 2**16 elements on its largest dimension that fsdp
divides and leaves the smaller ones replicated; FSDP2 shards every
parameter on dim 0 (padding the last shard).  The layouts differ, the
numbers do not: either way a step computes what one process computes on
the global batch.  The units that gather their parameters together are the
transformer `Block`s and the UNet's `ResBlock`s and `SpatialTransformer`s,
then the root with what is left (embeddings, heads).  No
`MixedPrecisionPolicy` is given: the parameters gather in f32 and the
trainer's bf16 autocast runs over them, as in one process.

A sharded parameter is a `DTensor`; the optimizer moments and the EMA made
from it are sharded the same way.  Inside a unit's forward the gathered
parameters are plain tensors, so the attention kernels see what they see
in one process.
"""
from __future__ import annotations

import sys
from typing import Iterable

import torch
import torch.distributed as dist


def _units():
    from ..models.layers import Block
    from ..models.unet import ResBlock, SpatialTransformer

    return (Block, ResBlock, SpatialTransformer)


def shard_model(nnet: torch.nn.Module, layout, device: torch.device) -> torch.nn.Module:
    """`fully_shard` every unit of `nnet` and then its root on the layout's
    device mesh, in place; returns `nnet` (now an `FSDPModule`)."""
    from torch.distributed.fsdp import fully_shard

    mesh = layout.device_mesh(torch.device(device).type)
    units = _units()
    for module in list(nnet.modules())[1:]:
        if isinstance(module, units):
            fully_shard(module, mesh=mesh)
    fully_shard(nnet, mesh=mesh)
    return nnet


def is_sharded(t) -> bool:
    """Whether `t` is a DTensor; without importing torch.distributed.tensor
    (~1 s), which `shard_model` imports."""
    dtensor = sys.modules.get("torch.distributed.tensor")
    return dtensor is not None and isinstance(t, dtensor.DTensor)


def local(t: torch.Tensor) -> torch.Tensor:
    """This rank's shard of a sharded tensor (the tensor itself otherwise)."""
    return t.to_local() if is_sharded(t) else t


def full(obj):
    """`obj` (a tensor, or dicts / lists of them) with every sharded tensor
    gathered whole; a collective every rank of the mesh must enter."""
    if isinstance(obj, dict):
        return {k: full(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(full(v) for v in obj)
    return _gather(obj) if is_sharded(obj) else obj


def _gather(t) -> torch.Tensor:
    """The whole tensor of an FSDP2 DTensor: each `Shard(0)` mesh dim
    all-gathered over its group with `all_gather_into_tensor` (rank i holds
    rows [i*c, (i+1)*c) of c = ceil(rows / ranks), padded here).
    `DTensor.full_tensor` would do the same through a functional collective,
    which crashes (SIGSEGV) over gloo on card tensors with torch 2.11."""
    out = t.to_local()
    rows = t.shape[0]
    for dim, placement in enumerate(t.placements):
        if placement.is_replicate():
            continue
        if not placement.is_shard(0):
            raise NotImplementedError(f"gather of a {placement} placement")
        n = t.device_mesh.size(dim)
        chunk = -(-rows // n)
        padded = out.new_zeros((chunk, *out.shape[1:]))
        padded[:out.shape[0]] = out
        gathered = out.new_empty((n * chunk, *out.shape[1:]))
        dist.all_gather_into_tensor(gathered, padded, group=t.device_mesh.get_group(dim))
        out = gathered[:rows]
    return out


def shard_like(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The whole tensor `t` (the same on every rank) laid out as the sharded
    `like`: each rank keeps its own chunk, with no communication."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t.to(like.device, like.dtype), like.device_mesh, like.placements,
                             src_data_rank=None)


def grad_norm(grads: Iterable[torch.Tensor], layout) -> torch.Tensor:
    """The 2-norm of the whole gradient from sharded gradients: the squares
    of this rank's shards, summed over the fsdp ranks of its replica (the dp
    replicas hold the same shards)."""
    local_grads = [local(g) for g in grads]
    sq = torch.stack(torch._foreach_norm(local_grads)).square().sum()
    dist.all_reduce(sq, group=layout.device_mesh(sq.device.type).get_group("fsdp"))
    return sq.sqrt()
