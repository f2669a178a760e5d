"""Fully sharded data parallelism: the network's parameters sharded over the
layout's fsdp axis with FSDP2's `fully_shard`, and the gathers and scatters
that checkpoints and the sampler need (`parallel/placement.py` reduces the
gradient and takes its norm).

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

Beside pp (`shard_stage`, `GatheredStage`) FSDP2 is not used: a pipeline
stage calls each of its blocks once per microbatch and the trunk is entered
through `embed` / `in_layer` / `head`, not the root's forward, so FSDP2's
per-call hooks would neither gather the root's parameters nor reduce each
unit once.  The stage's parameters are `DTensor`s sharded on dim 0 over
fsdp as FSDP2 lays them out (so the state, its moments, EMA and checkpoint
code are the same); a step gathers them whole once before the schedule
and reduce-scatters their gradients once after the backward, as JAX's
pp x fsdp program holds each stage's slice of the stacked layers whole
while it runs.
"""
from __future__ import annotations

import sys

import torch
import torch.distributed as dist
from torch import nn

from .mesh import host_staged


def _units():
    from ..models.layers import Block
    from ..models.unet import ResBlock, SpatialTransformer

    return (Block, ResBlock, SpatialTransformer)


def shard_model(nnet: torch.nn.Module, layout, device: torch.device) -> torch.nn.Module:
    """`fully_shard` every unit of `nnet` and then its root on the layout's
    fsdp mesh (('dp', 'fsdp') for HSDP), in place; returns `nnet` (now an
    `FSDPModule`)."""
    from torch.distributed.fsdp import fully_shard

    mesh = layout.fsdp_mesh(torch.device(device).type)
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


def shard_stage(nnet: nn.Module, layout, device: torch.device) -> None:
    """pp beside fsdp: every parameter of `nnet` (this stage's part) becomes
    a `DTensor` sharded on dim 0 over the layout's fsdp axis, each rank
    keeping its chunk of the whole tensor it holds (no communication, no
    FSDP2 hooks).  Under dp beside them the shards are replicated over dp
    and the trainer averages the gradient over dp itself."""
    from torch.distributed.tensor import Shard, distribute_tensor

    mesh = layout.device_mesh(torch.device(device).type)["fsdp"]
    for module in nnet.modules():
        for name, p in list(module.named_parameters(recurse=False)):
            sharded = distribute_tensor(p.detach(), mesh, [Shard(0)], src_data_rank=None)
            module.register_parameter(name, nn.Parameter(sharded, requires_grad=p.requires_grad))


class GatheredStage(nn.Module):
    """`inner` (a `Pipelined` stage over a network sharded by `shard_stage`)
    run with its parameters whole.  `gather()` all-gathers them over fsdp
    once a step and installs them in place of the shards, as leaves that
    collect the gradient of every microbatch and micro-batch (and of a remat
    replay in the backward); `scatter_grads()` puts the shards back and
    reduce-scatters each gradient once, averaged over fsdp, into the
    shard's `.grad` (a `DTensor` laid out as the parameter)."""

    def __init__(self, inner: nn.Module, layout):
        super().__init__()
        self.inner = inner
        self.fsdp = layout.fsdp
        self.group = layout.group("fsdp")
        self._slots = [(module, name) for module in inner.modules()
                       for name, _ in module.named_parameters(recurse=False)]
        self._shards = None

    def gather(self) -> None:
        with torch.no_grad():
            self._shards = []
            for module, name in self._slots:
                p = module._parameters[name]
                self._shards.append(p)
                module._parameters[name] = nn.Parameter(full(p).detach(),
                                                        requires_grad=p.requires_grad)

    def forward(self, *args, **kwargs):
        if self._shards is None:
            raise RuntimeError("GatheredStage: call gather() before the step's forward")
        return self.inner(*args, **kwargs)

    def scatter_grads(self) -> None:
        from torch.distributed.tensor import DTensor

        for (module, name), p in zip(self._slots, self._shards):
            g = module._parameters[name].grad
            module._parameters[name] = p
            if g is None:
                continue
            chunk = -(-g.shape[0] // self.fsdp)
            padded = g.new_zeros((self.fsdp * chunk, *g.shape[1:]))
            padded[:g.shape[0]] = g
            staged = padded.is_cuda and host_staged(self.group)
            src = padded.cpu() if staged else padded
            out = src.new_empty((chunk, *g.shape[1:]))
            dist.reduce_scatter_tensor(out, src, group=self.group)
            shard = (out[:local(p).shape[0]] / self.fsdp).to(p.device)
            p.grad = DTensor.from_local(shard.contiguous(), p.device_mesh, p.placements,
                                        run_check=False, shape=p.shape, stride=p.stride())
        self._shards = None
