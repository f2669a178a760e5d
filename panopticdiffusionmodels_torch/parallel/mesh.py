"""The layouts of a training run over processes: data parallelism, fully
sharded data parallelism (with replicas: HSDP), or sequence parallelism
over a mesh axis `sp`.

Port of `panopticdiffusionmodels_tpu/parallel/mesh.py`.  There, the mesh's
axes shard every array by annotation and the partitioner inserts the
collectives.  Here `from_mesh` returns a context for the world it finds:

  * None: one process and no process group, nothing to share;
  * `DataParallel` (JAX `make_mesh` with dp = -1 over every process,
    `process_batch_slice`, `local_batch_size`): each process holds a replica
    of the model and loads its contiguous rows of the global batch; the
    trainer wraps the model in `DistributedDataParallel`;
  * `FullyShardedDataParallel` (JAX `make_mesh` with fsdp > 1): the world
    as a (dp, fsdp) device mesh; parameters, gradients, optimizer moments
    and EMA are sharded over fsdp and replicated over dp (HSDP when
    dp > 1; `parallel/sharding.py` applies FSDP2's `fully_shard`), and each
    process loads the rows of its GLOBAL rank over (dp, fsdp) jointly, as
    JAX shards the batch over both axes (`mesh.py:69-72`);
  * a `SequenceParallel` context, which says where the token shards live and
    moves them explicitly:

      - `shard(x)`  (B, L, C) of all tokens -> this rank's token shard;
      - `gather(x)` the inverse, every rank gets all tokens;
      - `rotate(kv)` one step of the ring: rank i's tensor moves to rank i+1;
      - `sources(hop)` which shard's keys each local row holds after `hop`
        rotations (the ring's `nvalid` masking needs it);
      - `all_reduce_grads(params)` sums the gradients over the sp ranks.

    Two implementations, chosen by `mesh.sp_mode` and never inferred:

      - `ProcessGroupSP` ('process_group'): one process per rank under
        `torchrun`, over `torch.distributed` (NCCL on cards, gloo on the
        CPU).  Each process holds (B, L/sp, C).  `rotate` is a
        `batch_isend_irecv` whose backward rotates the other way (the
        transpose of JAX's `ppermute`); `gather` is an all-gather whose
        backward is a reduce-scatter.
      - `InProcessSP` ('in_process'): every shard in one process on one
        device, folded into the batch: (B, L, C) -> (sp*B, L/sp, C), shard s
        of batch row b at row s*B + b.  `rotate` is a `torch.roll` over the
        shard axis and `gather` the inverse reshape; autograd sums the
        gradients of the shards, so `all_reduce_grads` has nothing to do.
        This is the port's counterpart of JAX's virtual-device mesh, and how
        one card runs the ring.

Every context carries `rank`, `world_size` and `is_main` (rank 0, the one
process that writes).  tp, pp > 1, and dp or fsdp beside sp, raise: they
come with ROADMAP Queue 1 entry 4.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Union

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

    @property
    def is_main(self) -> bool:
        return self.rank == 0

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
                "streams comes with a later distributed slice (ROADMAP Queue 1 entry 4, "
                "north-star item 16); ops.ring_attention.ring_attention_qkv pads on its own")

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
        if world > sp:
            raise NotImplementedError(_LATER.format(
                f"mesh.sp={sp} with sp_mode='process_group' over {world} processes (data "
                "parallelism beside sp)"))
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


class DataParallel:
    """Data parallelism over the processes of the default group, JAX's
    dp = -1: every process holds a replica of the model and loads the
    contiguous rows `process_batch_slice(global_batch)` of each global
    batch (JAX `parallel/mesh.py::process_batch_slice` for a pure data
    layout)."""

    def __init__(self, world_size: int, rank: int):
        self.world_size = world_size
        self.rank = rank

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def local_batch_size(self, global_batch: int) -> int:
        if global_batch % self.world_size:
            raise ValueError(f"global batch {global_batch} does not divide into "
                             f"{self.world_size} processes")
        return global_batch // self.world_size

    def process_batch_slice(self, global_batch: int) -> slice:
        per = self.local_batch_size(global_batch)
        return slice(self.rank * per, (self.rank + 1) * per)


class FullyShardedDataParallel(DataParallel):
    """fsdp > 1: the world as a (dp, fsdp) mesh, global rank = dp index *
    fsdp + fsdp index.  The model's state is sharded over fsdp and
    replicated over dp; the batch rows follow the global rank, as
    `DataParallel`'s do."""

    def __init__(self, world_size: int, rank: int, dp: int, fsdp: int):
        super().__init__(world_size, rank)
        self.dp, self.fsdp = dp, fsdp
        self._meshes = {}

    def device_mesh(self, device_type: str):
        """The `DeviceMesh` that `fully_shard` shards over: ('fsdp',), or
        ('dp', 'fsdp') for HSDP; built once per device type."""
        if device_type not in self._meshes:
            from torch.distributed.device_mesh import init_device_mesh

            shape, names = ((self.fsdp,), ("fsdp",)) if self.dp == 1 else \
                ((self.dp, self.fsdp), ("dp", "fsdp"))
            self._meshes[device_type] = init_device_mesh(device_type, shape,
                                                         mesh_dim_names=names)
        return self._meshes[device_type]


_LATER = "{}: comes with a later distributed slice (ROADMAP Queue 1 entry 4)"


def _sharded(mesh, world: int, fsdp: int, dp: int) -> FullyShardedDataParallel:
    """The fsdp > 1 layout, or ValueError when the world cannot hold it."""
    if fsdp > world:
        raise ValueError(f"mesh.fsdp = {fsdp} needs {fsdp} processes, got {world}")
    if dp == -1:
        if world % fsdp:
            raise ValueError(f"mesh.fsdp = {fsdp} does not divide {world} processes")
        dp = world // fsdp
    if dp * fsdp != world:
        raise ValueError(f"mesh {dict(mesh)}: dp x fsdp = {dp * fsdp} is not the world of "
                         f"{world} processes")
    return FullyShardedDataParallel(world, dist.get_rank(), dp, fsdp)


def from_mesh(mesh) -> Union[None, DataParallel, SequenceParallel]:
    """The layout of a config's `mesh` for the world this process is in:
    None (one process and no process group, sp = 1, fsdp = 1), a
    `DataParallel` (sp = 1, dp = -1 or dp = world, over the initialised
    default group, of one process too), a `FullyShardedDataParallel` (fsdp >
    1, dp = -1 or dp x fsdp = world) or a `SequenceParallel` context (sp >
    1, dp at -1 or 1).

    Raises `NotImplementedError` for what the port cannot run yet (tp or pp
    > 1; dp or fsdp beside sp; an explicit dp other than the world at fsdp
    = 1; more processes than sp under 'process_group'), `ValueError` for an
    unknown `sp_mode`, when the number of processes is neither 1
    (in_process) nor sp (process_group), and when fsdp exceeds the world or
    dp x fsdp is not the world."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if any(int(mesh.get(k, 1)) != 1 for k in ("tp", "pp")):
        raise NotImplementedError(_LATER.format(f"mesh {dict(mesh)}: tp or pp > 1"))
    sp = int(mesh.get("sp", 1))
    dp = int(mesh.get("dp", -1))
    fsdp = int(mesh.get("fsdp", 1))
    if fsdp > 1 and sp == 1:
        return _sharded(mesh, world, fsdp, dp)
    if sp > 1:
        if dp not in (-1, 1) or fsdp != 1:
            raise NotImplementedError(_LATER.format(
                f"mesh {dict(mesh)}: dp or fsdp beside sp > 1"))
        mode = mesh.get("sp_mode", "process_group")
        if mode not in SP_MODES:
            raise ValueError(f"mesh.sp_mode={mode!r}: one of {SP_MODES}")
        if mode == "in_process":
            if world != 1:
                raise ValueError(f"mesh.sp_mode='in_process' runs every shard in one process, "
                                 f"but {world} processes were started; use "
                                 "sp_mode='process_group'")
            return InProcessSP(sp)
        return ProcessGroupSP(sp)
    if dp != -1 and dp != world:
        raise NotImplementedError(_LATER.format(
            f"mesh.dp={dp} over {world} processes (dp = -1 takes every process)"))
    return DataParallel(world, dist.get_rank()) if dist.is_initialized() else None
