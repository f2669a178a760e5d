"""Sequence parallelism over a mesh axis `sp`.

Port of the sequence-parallel part of
`panopticdiffusionmodels_tpu/parallel/mesh.py`.  There, the token dim of
every activation is sharded over the mesh axis 'sp' by sharding annotations
and the partitioner inserts the collectives.  Here a context object says
where the shards live and moves them explicitly:

  * `shard(x)`  (B, L, C) of all tokens -> this rank's token shard;
  * `gather(x)` the inverse, every rank gets all tokens;
  * `rotate(kv)` one step of the ring: rank i's tensor moves to rank i+1;
  * `sources(hop)` which shard's keys each local row holds after `hop`
    rotations (the ring's `nvalid` masking needs it);
  * `all_reduce_grads(params)` sums the gradients over the sp ranks.

Two implementations, chosen by `mesh.sp_mode` and never inferred:

  * `ProcessGroupSP` ('process_group'): one process per rank under
    `torchrun`, over `torch.distributed` (NCCL on cards, gloo on the CPU).
    Each process holds (B, L/sp, C).  `rotate` is a `batch_isend_irecv` whose
    backward rotates the other way (the transpose of JAX's `ppermute`);
    `gather` is an all-gather whose backward is a reduce-scatter.
  * `InProcessSP` ('in_process'): every shard in one process on one device,
    folded into the batch: (B, L, C) -> (sp*B, L/sp, C), shard s of batch row
    b at row s*B + b.  `rotate` is a `torch.roll` over the shard axis and
    `gather` the inverse reshape; autograd sums the gradients of the shards,
    so `all_reduce_grads` has nothing to do.  This is the port's counterpart
    of JAX's virtual-device mesh, and how one card runs the ring.

Only sp is ported: dp, fsdp, tp and pp > 1 come with the distributed slice.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional

import torch
import torch.distributed as dist

SP_MODES = ("process_group", "in_process")


class SequenceParallel:
    """What the two implementations share: the ring's size, this process's
    rank, the number of processes that each compute the whole loss
    (`world_size`) and the per-row `nvalid` of a hop."""

    mode = ""
    world_size = 1

    def __init__(self, sp: int, rank: int = 0):
        if sp < 2:
            raise ValueError(f"sequence parallelism needs sp >= 2, got {sp}")
        self.sp = sp
        self.rank = rank
        self._nvalid: Dict[tuple, torch.Tensor] = {}

    def sources(self, hop: int) -> List[int]:
        """The source shard of the keys each local shard holds after `hop`
        rotations i -> i+1, one entry per local shard."""
        raise NotImplementedError

    def nvalid(self, hop: int, l_loc: int, l_true: int, rows: int,
               device: torch.device) -> torch.Tensor:
        """int32 (rows,): how many of this hop's `l_loc` keys are real tokens
        for each local batch row, clip(l_true - src*l_loc, 0, l_loc) as in
        JAX's `_ring_body`; cached, so a step makes no host-to-device copy."""
        key = (hop, l_loc, l_true, rows, device)
        if key not in self._nvalid:
            srcs = self.sources(hop)
            per = [min(max(l_true - s * l_loc, 0), l_loc) for s in srcs]
            vals = torch.tensor(per, dtype=torch.int32).repeat_interleave(rows // len(srcs))
            self._nvalid[key] = vals.to(device)
        return self._nvalid[key]

    def check_tokens(self, n: int, what: str) -> None:
        if n % self.sp:
            raise NotImplementedError(
                f"{what}: {n} tokens do not divide sp={self.sp}; padding a model's token "
                "streams comes with a later item of the distributed slice (ROADMAP Queue 1 "
                "item 16); ops.ring_attention.ring_attention_qkv pads on its own")

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def rotate(self, kv: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def all_reduce_grads(self, params: Iterable[torch.Tensor]) -> None:
        raise NotImplementedError


class InProcessSP(SequenceParallel):
    """All sp shards in this process, folded into the batch dimension."""

    mode = "in_process"

    def sources(self, hop: int) -> List[int]:
        return [(s - hop) % self.sp for s in range(self.sp)]

    def shard(self, x):
        b, l, c = x.shape
        self.check_tokens(l, "InProcessSP.shard")
        return x.reshape(b, self.sp, l // self.sp, c).transpose(0, 1).reshape(
            self.sp * b, l // self.sp, c)

    def gather(self, x):
        sb, l, c = x.shape
        return x.reshape(self.sp, sb // self.sp, l, c).transpose(0, 1).reshape(
            sb // self.sp, self.sp * l, c)

    def rotate(self, kv):
        sb = kv.shape[0]
        return torch.roll(kv.reshape(self.sp, sb // self.sp, *kv.shape[1:]), 1, 0).reshape(
            kv.shape)

    def all_reduce_grads(self, params):
        """Nothing to do: the shards share the parameters inside one graph."""


class _Rotate(torch.autograd.Function):
    """x from rank i to rank (i + shift) % sp; the backward sends the
    gradient back the other way."""

    @staticmethod
    def forward(ctx, x, shift: int):
        ctx.shift = shift
        return _p2p_rotate(x, shift)

    @staticmethod
    def backward(ctx, g):
        return _p2p_rotate(g, -ctx.shift), None


def _p2p_rotate(x: torch.Tensor, shift: int) -> torch.Tensor:
    sp, rank = dist.get_world_size(), dist.get_rank()
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, (rank + shift) % sp),
           dist.P2POp(dist.irecv, out, (rank - shift) % sp)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _GatherTokens(torch.autograd.Function):
    """(B, l, C) on each rank -> (B, sp*l, C) on every rank; the backward
    reduce-scatters (sums over ranks, keeps this rank's token block)."""

    @staticmethod
    def forward(ctx, x):
        sp = dist.get_world_size()
        b, l, c = x.shape
        out = torch.empty((sp * b, l, c), dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, x.contiguous())
        return out.reshape(sp, b, l, c).transpose(0, 1).reshape(b, sp * l, c)

    @staticmethod
    def backward(ctx, g):
        sp = dist.get_world_size()
        b, sl, c = g.shape
        blocks = g.reshape(b, sp, sl // sp, c).transpose(0, 1).contiguous()
        out = torch.empty((b, sl // sp, c), dtype=g.dtype, device=g.device)
        dist.reduce_scatter_tensor(out, blocks.reshape(sp * b, sl // sp, c))
        return out


class ProcessGroupSP(SequenceParallel):
    """One process per rank of the ring: the default torch.distributed
    group, whose world is the sp ring."""

    mode = "process_group"

    def __init__(self, sp: int):
        if not dist.is_initialized():
            raise RuntimeError(
                f"mesh.sp={sp} with sp_mode='process_group' needs torch.distributed "
                f"initialised with {sp} processes (run under torchrun "
                f"--nproc_per_node={sp}); on one device set mesh.sp_mode='in_process'")
        world = dist.get_world_size()
        if world != sp:
            raise ValueError(f"mesh.sp={sp} with sp_mode='process_group' needs a world of "
                             f"{sp} processes, got {world}")
        super().__init__(sp, dist.get_rank())
        self.world_size = world

    def sources(self, hop):
        return [(self.rank - hop) % self.sp]

    def shard(self, x):
        l = x.shape[1]
        self.check_tokens(l, "ProcessGroupSP.shard")
        l_loc = l // self.sp
        return x[:, self.rank * l_loc:(self.rank + 1) * l_loc]

    def gather(self, x):
        return _GatherTokens.apply(x)

    def rotate(self, kv):
        return _Rotate.apply(kv, 1)

    def all_reduce_grads(self, params):
        """Sum every gradient over the ranks, as one flat buffer."""
        grads = [p.grad for p in params if p.grad is not None]
        if not grads:
            return
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat)
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


def from_mesh(mesh) -> Optional[SequenceParallel]:
    """The sequence-parallel context of a config's `mesh` (None at sp = 1).

    Raises for any other axis > 1 beside sp, for an unknown `sp_mode`, and
    when the number of processes is neither 1 (in_process) nor sp
    (process_group)."""
    sp = int(mesh.get("sp", 1))
    if sp == 1:
        return None
    others = {k: mesh.get(k, 1) for k in ("dp", "fsdp", "tp", "pp")}
    if others["dp"] not in (-1, 1) or any(others[k] != 1 for k in ("fsdp", "tp", "pp")):
        raise NotImplementedError(
            f"mesh {dict(mesh)}: sp > 1 together with dp, fsdp, tp or pp > 1 comes with the "
            "distributed slice (ROADMAP Queue 1 item 16); this one runs sp alone")
    mode = mesh.get("sp_mode", "process_group")
    if mode not in SP_MODES:
        raise ValueError(f"mesh.sp_mode={mode!r}: one of {SP_MODES}")
    if mode == "in_process":
        world = dist.get_world_size() if dist.is_initialized() else 1
        if world != 1:
            raise ValueError(f"mesh.sp_mode='in_process' runs every shard in one process, but "
                             f"{world} processes were started; use sp_mode='process_group'")
        return InProcessSP(sp)
    return ProcessGroupSP(sp)
