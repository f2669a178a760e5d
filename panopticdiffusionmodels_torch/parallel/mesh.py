"""The layouts of a training run over processes: one process mesh in JAX's
axis order (pp, dp, fsdp, sp, tp), and the sequence-parallel contexts.

Port of `panopticdiffusionmodels_tpu/parallel/mesh.py`.  There, the mesh's
axes shard every array by annotation and the partitioner inserts the
collectives.  Here `from_mesh` returns a context for the world it finds:

  * None: one process and no process group, nothing to share;
  * `InProcessSP`: one process, `mesh.sp > 1` with sp_mode 'in_process' and
    every other axis at 1 (below);
  * otherwise a `DataParallel` (a `FullyShardedDataParallel` when fsdp > 1):
    the world laid out row-major as (pp, dp, fsdp, sp, tp), pp outermost, as
    JAX's `make_mesh` reshapes its device list (`mesh.py:41-66`), so global
    rank = ((((pp*DP + dp)*FSDP + fsdp)*SP + sp)*TP + tp).  sp counts
    processes only under sp_mode 'process_group'; 'in_process' folds its
    shards into each process.  Each process knows its coordinates, and
    `group(axis)` is the process group of the ranks that differ from it in
    that axis alone (one `DeviceMesh` over the axes of size > 1, built by
    `init_groups`, which every rank enters).  The batch is sharded over
    (dp, fsdp) only (JAX `batch_sharding`, `mesh.py:69-72`): the processes
    that differ only in pp, sp or tp load the same rows and draw the same
    noise.  The default mesh (dp = -1, the rest 1) over several processes
    is plain data parallelism, which the trainer runs through
    `DistributedDataParallel`.

A `SequenceParallel` context says where the token shards live and moves
them explicitly:

  - `shard(x)`  (B, L, C) of all tokens -> this rank's token shard, the
    stream padded with zero rows to a multiple of sp at its end;
  - `gather(x, l)` the inverse: every rank gets the first l tokens (the pad
    rows dropped);
  - `rotate(kv)` one step of the ring: rank i's tensor moves to rank i+1;
  - `sources(hop)` which shard's keys each local row holds after `hop`
    rotations, and `nvalid(hop, counts, ...)` how many of them are real
    tokens, from the per-shard counts of a stream (`set_counts`).

Two implementations, chosen by `mesh.sp_mode` and never inferred:

  - `ProcessGroupSP` ('process_group'): one process per sp rank, over the
    layout's sp group (NCCL on cards, gloo on the CPU; card tensors cross a
    gloo group through the host).  Each process holds (B, L/sp, C).
    `rotate` is a `batch_isend_irecv` to the global ranks of its ring
    neighbours, whose backward rotates the other way (the transpose of
    JAX's `ppermute`); `gather` is an all-gather whose backward is a
    reduce-scatter.  Each sp process computes the whole loss; the
    trainer sums the gradients over the sp group (`parallel/placement.py`).
  - `InProcessSP` ('in_process'): every shard in one process on one device,
    folded into the batch: (B, L, C) -> (sp*B, L/sp, C), shard s of batch
    row b at row s*B + b.  `rotate` is a `torch.roll` over the shard axis
    and `gather` the inverse reshape; autograd sums the gradients of the
    shards inside one graph.  This is the port's
    counterpart of JAX's virtual-device mesh, and how one card runs the
    ring; beside dp or fsdp each process folds its own shards.

What JAX refuses, `from_mesh` refuses with JAX's reason (pp beside sp or
tp, `train/trainer.py:169-174`); the trainer refuses the rest (pp or sp for
the UNet, depth/2 or the batch not dividing).  A mesh the world cannot hold
is a `ValueError`.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Union

import torch
import torch.distributed as dist

AXES = ("pp", "dp", "fsdp", "sp", "tp")
SP_MODES = ("process_group", "in_process")
# JAX `Trainer.__init__` l.169-174
PP_BESIDE_SP_OR_TP = ("mesh.pp>1 requires sp == tp == 1 (the pipelined trunk runs under manual "
                      "SPMD; sp/tp rely on the automatic partitioner)")


class SequenceParallel:
    """What the two implementations share: the ring's size, this process's
    rank in it, the number of processes that each compute the whole loss
    (`world_size`), the per-shard token counts of the streams of the current
    forward and the per-row `nvalid` of a hop."""

    mode = ""
    world_size = 1

    def __init__(self, sp: int, rank: int = 0):
        if sp < 2:
            raise ValueError(f"sequence parallelism needs sp >= 2, got {sp}")
        self.sp = sp
        self.rank = rank
        self._nvalid: Dict[tuple, torch.Tensor] = {}
        self._counts: Dict[int, tuple] = {}

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def sources(self, hop: int) -> List[int]:
        """The source shard of the keys each local shard holds after `hop`
        rotations i -> i+1, one entry per local shard."""
        raise NotImplementedError

    def local_shards(self) -> List[int]:
        """The shards this process holds, in its row order."""
        return self.sources(0)

    def padded(self, n: int) -> int:
        """The local length of a stream of n tokens: ceil(n / sp)."""
        return -(-n // self.sp)

    def contiguous_counts(self, n: int) -> tuple:
        """The real tokens of each shard of an n-token stream padded at its end."""
        l_loc = self.padded(n)
        return tuple(min(max(n - s * l_loc, 0), l_loc) for s in range(self.sp))

    def set_counts(self, l_loc: int, counts: Sequence[int]) -> None:
        """Register the per-shard real-token counts of the stream whose
        local length is `l_loc` (each shard's real tokens first): the ring
        attention of that stream masks the rest.  A model sets them at
        `shard` time; a length never registered is all real tokens."""
        self._counts[l_loc] = tuple(int(c) for c in counts)

    def counts(self, l_loc: int) -> tuple:
        return self._counts.get(l_loc, (l_loc,) * self.sp)

    def nvalid(self, hop: int, counts: Sequence[int], rows: int,
               device: torch.device) -> torch.Tensor:
        """int32 (rows,): how many keys of this hop are real tokens for each
        local batch row, counts[src] of the shard whose keys the row holds
        (JAX's `_ring_body` clip(l_true - src*l_loc, 0, l_loc) for a stream
        padded at its end); cached, so a step makes no host-to-device copy."""
        counts = tuple(counts)
        key = (hop, counts, rows, device)
        if key not in self._nvalid:
            srcs = self.sources(hop)
            per = [counts[s] for s in srcs]
            vals = torch.tensor(per, dtype=torch.int32).repeat_interleave(rows // len(srcs))
            self._nvalid[key] = vals.to(device)
        return self._nvalid[key]

    def pad(self, x: torch.Tensor) -> torch.Tensor:
        l = x.shape[1]
        l_pad = self.padded(l) * self.sp
        return x if l_pad == l else torch.nn.functional.pad(x, (0, 0, 0, l_pad - l))

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def gather(self, x: torch.Tensor, l: Optional[int] = None) -> torch.Tensor:
        raise NotImplementedError

    def rotate(self, kv: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


class InProcessSP(SequenceParallel):
    """All sp shards in this process, folded into the batch dimension."""

    mode = "in_process"

    def sources(self, hop: int) -> List[int]:
        return [(s - hop) % self.sp for s in range(self.sp)]

    def shard(self, x):
        x = self.pad(x)
        b, l, c = x.shape
        return x.reshape(b, self.sp, l // self.sp, c).transpose(0, 1).reshape(
            self.sp * b, l // self.sp, c)

    def gather(self, x, l=None):
        sb, l_loc, c = x.shape
        out = x.reshape(self.sp, sb // self.sp, l_loc, c).transpose(0, 1).reshape(
            sb // self.sp, self.sp * l_loc, c)
        return out if l is None or l == out.shape[1] else out[:, :l]

    def rotate(self, kv):
        sb = kv.shape[0]
        return torch.roll(kv.reshape(self.sp, sb // self.sp, *kv.shape[1:]), 1, 0).reshape(
            kv.shape)


def host_staged(group) -> bool:
    """Whether card tensors cross `group` through host memory: gloo's
    point-to-point ops read and write plain host pointers."""
    return dist.get_backend(group) == dist.Backend.GLOO


def p2p(sends: Sequence[tuple], recvs: Sequence[tuple], group=None) -> None:
    """Post every (tensor, global peer) send and receive at once and wait for
    them all; card tensors go through host copies over gloo."""
    staged = any(t.is_cuda for t, _ in (*sends, *recvs)) and host_staged(group)
    move = (lambda t: t.cpu()) if staged else (lambda t: t)
    bufs = [(move(t.contiguous()), peer) for t, peer in sends]
    outs = [(torch.empty(t.shape, dtype=t.dtype) if staged else t, peer) for t, peer in recvs]
    ops = [dist.P2POp(dist.isend, t, peer, group=group) for t, peer in bufs]
    ops += [dist.P2POp(dist.irecv, t, peer, group=group) for t, peer in outs]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    if staged:
        for (dst, _), (src, _) in zip(recvs, outs):
            dst.copy_(src)


class _Rotate(torch.autograd.Function):
    """x from ring position i to (i + shift) % sp; the backward sends the
    gradient back the other way."""

    @staticmethod
    def forward(ctx, x, shift: int, sp):
        ctx.shift, ctx.sp = shift, sp
        return sp.p2p_rotate(x, shift)

    @staticmethod
    def backward(ctx, g):
        return ctx.sp.p2p_rotate(g, -ctx.shift), None, None


class _GatherTokens(torch.autograd.Function):
    """(B, l, C) on each rank -> (B, sp*l, C) on every rank; the backward
    reduce-scatters (sums over ranks, keeps this rank's token block)."""

    @staticmethod
    def forward(ctx, x, sp):
        ctx.sp = sp
        b, l, c = x.shape
        out = torch.empty((sp.sp * b, l, c), dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, x.contiguous(), group=sp.group)
        return out.reshape(sp.sp, b, l, c).transpose(0, 1).reshape(b, sp.sp * l, c)

    @staticmethod
    def backward(ctx, g):
        n = ctx.sp.sp
        b, sl, c = g.shape
        blocks = g.reshape(b, n, sl // n, c).transpose(0, 1).contiguous()
        out = torch.empty((b, sl // n, c), dtype=g.dtype, device=g.device)
        dist.reduce_scatter_tensor(out, blocks.reshape(n * b, sl // n, c), group=ctx.sp.group)
        return out, None


def all_reduce_flat(tensors: Sequence[torch.Tensor], group=None,
                    op=dist.ReduceOp.SUM) -> None:
    """All-reduce a list of tensors in place as one flat f32 buffer."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, op=op, group=group)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


class ProcessGroupSP(SequenceParallel):
    """One process per rank of the ring: the layout's sp group, its peers
    addressed by their global ranks."""

    mode = "process_group"

    def __init__(self, sp: int, layout: "DataParallel"):
        super().__init__(sp, layout.coords["sp"])
        self.peers = layout.peers("sp")
        self.layout = layout
        self.world_size = sp

    @property
    def group(self):
        return self.layout.group("sp")

    def sources(self, hop):
        return [(self.rank - hop) % self.sp]

    def p2p_rotate(self, x: torch.Tensor, shift: int) -> torch.Tensor:
        out = torch.empty_like(x)
        p2p([(x, self.peers[(self.rank + shift) % self.sp])],
            [(out, self.peers[(self.rank - shift) % self.sp])], self.group)
        return out

    def shard(self, x):
        x = self.pad(x)
        l_loc = x.shape[1] // self.sp
        return x[:, self.rank * l_loc:(self.rank + 1) * l_loc]

    def gather(self, x, l=None):
        out = _GatherTokens.apply(x, self)
        return out if l is None or l == out.shape[1] else out[:, :l]

    def rotate(self, kv):
        return _Rotate.apply(kv, 1, self)


class DataParallel:
    """A process mesh (pp, dp, fsdp, sp, tp) over the default group's
    world, with this process's coordinates.  `dp` etc. are the axis sizes
    (sp: processes along it, 1 under 'in_process'), `seq` the
    sequence-parallel context or None.  With no axis but dp above 1 it is
    JAX's dp = -1 over every process: each process holds a replica and loads
    the contiguous rows `process_batch_slice(global_batch)` of each global
    batch (JAX `parallel/mesh.py::process_batch_slice`)."""

    def __init__(self, world_size: int, rank: int, shape: Optional[Dict[str, int]] = None):
        shape = dict(shape or {"dp": world_size})
        self.shape = {a: int(shape.get(a, 1)) for a in AXES}
        if math.prod(self.shape.values()) != world_size:
            raise ValueError(f"mesh {self.shape} does not cover {world_size} processes")
        self.world_size = world_size
        self.rank = rank
        self.coords = self.coords_of(rank)
        self.pp, self.dp, self.fsdp, self.tp = (self.shape[a] for a in ("pp", "dp", "fsdp", "tp"))
        self.seq: Optional[SequenceParallel] = None
        self._meshes: Dict[str, object] = {}

    def coords_of(self, rank: int) -> Dict[str, int]:
        """The coordinates of global rank `rank`: row-major, pp outermost."""
        coords = {}
        for axis in reversed(AXES):
            coords[axis] = rank % self.shape[axis]
            rank //= self.shape[axis]
        return {a: coords[a] for a in AXES}

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    @property
    def pure_data_parallel(self) -> bool:
        """Every axis but dp at 1 (and no folded sp): DDP's layout."""
        return self.world_size == self.dp and self.seq is None

    @property
    def data_shards(self) -> int:
        return self.dp * self.fsdp

    @property
    def data_rank(self) -> int:
        """This process's shard of the batch: its (dp, fsdp) index."""
        return self.coords["dp"] * self.fsdp + self.coords["fsdp"]

    def data_peers(self, shard: Optional[int] = None) -> List[int]:
        """The global ranks that load batch shard `shard` (this process's by
        default): those that differ in pp, sp or tp alone, which JAX feeds
        the same rows."""
        shard = self.data_rank if shard is None else shard
        coords = map(self.coords_of, range(self.world_size))
        return [r for r, c in enumerate(coords) if c["dp"] * self.fsdp + c["fsdp"] == shard]

    def stride(self, axis: str) -> int:
        return math.prod(self.shape[a] for a in AXES[AXES.index(axis) + 1:])

    def peers(self, axis: str) -> List[int]:
        """The global ranks that differ from this one in `axis` alone, by
        their index along it."""
        step = self.stride(axis)
        base = self.rank - self.coords[axis] * step
        return [base + i * step for i in range(self.shape[axis])]

    def local_batch_size(self, global_batch: int) -> int:
        if global_batch % self.data_shards:
            raise ValueError(f"global batch {global_batch} does not divide into "
                             f"{self.data_shards} processes")
        return global_batch // self.data_shards

    def process_batch_slice(self, global_batch: int) -> slice:
        per = self.local_batch_size(global_batch)
        return slice(self.data_rank * per, (self.data_rank + 1) * per)

    def device_mesh(self, device_type: str):
        """The `DeviceMesh` over the axes of size > 1, named as JAX's, built
        once (a collective every rank enters, on the first call)."""
        if not self._meshes:
            from torch.distributed.device_mesh import init_device_mesh

            names = tuple(a for a in AXES if self.shape[a] > 1) or ("dp",)
            self._meshes["mesh"] = init_device_mesh(
                device_type, tuple(self.shape[a] for a in names), mesh_dim_names=names)
        return self._meshes["mesh"]

    def init_groups(self, device_type: str) -> None:
        """Build the process groups of every axis now, and of the data peers
        where a shard has several (every rank must call it at the same
        point); a no-op for plain data parallelism."""
        if not self.pure_data_parallel:
            self.device_mesh(device_type)
            if self.world_size > self.data_shards:
                for shard in range(self.data_shards):  # every rank builds every group
                    group = dist.new_group(self.data_peers(shard))
                    if shard == self.data_rank:
                        self._meshes["data"] = group

    def group(self, axis: str):
        """The process group of `axis` (its size above 1), or with 'data' of
        `data_peers()` (more than one); needs `init_groups`."""
        size = self.world_size // self.data_shards if axis == "data" else self.shape[axis]
        if size == 1:
            raise ValueError(f"mesh axis {axis!r} has size 1")
        if not self._meshes:
            raise RuntimeError("DataParallel.group: call init_groups(device_type) first, on "
                               "every rank")
        return self._meshes["data"] if axis == "data" else self._meshes["mesh"].get_group(axis)

    def fsdp_mesh(self, device_type: str):
        """The mesh `fully_shard` shards over: ('fsdp',), or ('dp', 'fsdp')
        for HSDP."""
        mesh = self.device_mesh(device_type)
        return mesh["fsdp"] if self.dp == 1 else mesh["dp", "fsdp"]


class FullyShardedDataParallel(DataParallel):
    """fsdp > 1: the model's state is sharded over fsdp and replicated over
    dp (HSDP) and over the other axes' peers."""


def _describe(sizes: Dict[str, int]) -> str:
    shown = [f"{a} = {n}" for a, n in sizes.items() if n != -1 and (n != 1 or a == "dp")]
    return "mesh." + ", mesh.".join(shown) if shown else "the default mesh"


def from_mesh(mesh) -> Union[None, DataParallel, SequenceParallel]:
    """The layout of a config's `mesh` for the world this process is in:
    None (one process, no process group, every axis at 1), an `InProcessSP`
    (one process, sp > 1 'in_process', the rest 1), or a `DataParallel` /
    `FullyShardedDataParallel` over the world (a process group is
    initialised, or any axis but sp 'in_process' is above 1).

    Raises `ValueError` for an unknown `sp_mode`, for pp beside sp or tp
    (JAX's reason), and when the world cannot hold the mesh: an axis product
    above the world, one that does not divide it (dp = -1), or an explicit
    dp for which the product is not the world; `RuntimeError` for
    'process_group' without an initialised process group."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    pp, fsdp, sp, tp = (int(mesh.get(k, 1)) for k in ("pp", "fsdp", "sp", "tp"))
    dp = int(mesh.get("dp", -1))
    mode = mesh.get("sp_mode", "process_group")
    if sp > 1 and mode not in SP_MODES:
        raise ValueError(f"mesh.sp_mode={mode!r}: one of {SP_MODES}")
    if pp > 1 and (sp > 1 or tp > 1):
        raise ValueError(PP_BESIDE_SP_OR_TP)
    in_process = sp > 1 and mode == "in_process"
    sp_procs = 1 if in_process else sp
    if sp_procs > 1 and not dist.is_initialized():
        raise RuntimeError(
            f"mesh.sp={sp} with sp_mode='process_group' needs torch.distributed "
            f"initialised with {sp} processes a ring (run under torchrun "
            f"--nproc_per_node={sp}); on one device set mesh.sp_mode='in_process'")
    sizes = dict(pp=pp, dp=dp, fsdp=fsdp, sp=sp_procs, tp=tp)
    inner = pp * fsdp * sp_procs * tp
    need = inner * max(dp, 1)
    if dp == -1:
        if inner > world:
            raise ValueError(f"{_describe(sizes)} needs {inner} processes, got {world}")
        if world % inner:
            raise ValueError(f"{_describe(sizes)}: {inner} processes a replica does not divide "
                             f"{world} processes")
        dp = world // inner
    elif need != world:
        shown = [a for a in AXES if sizes[a] != 1 or a == "dp"]
        raise ValueError(f"{_describe(sizes)}: {' x '.join(shown)} = {need} is not the world "
                         f"of {world} processes")
    sizes["dp"] = dp
    if world == 1 and (in_process or not dist.is_initialized()):
        return InProcessSP(sp) if in_process else None
    cls = FullyShardedDataParallel if fsdp > 1 else DataParallel
    layout = cls(world, dist.get_rank(), sizes)
    if sp > 1:
        layout.seq = InProcessSP(sp) if in_process else ProcessGroupSP(sp, layout)
    return layout
