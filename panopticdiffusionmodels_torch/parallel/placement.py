"""Where each parameter of a trainer's network lives under a process mesh,
and what follows from it: the gradient's reductions, its global norm, and
the carry of the train state to the file one process writes and back.

A parameter of a rank is

  * cut over tp when `parallel/tensor.py`'s rules name it (the rank holds
    its slice), else the same on every tp rank;
  * held by one pipeline stage when it belongs to that stage's blocks
    (`parallel/pipeline.py::owner_stage`), else the same on every stage
    (embeddings, norms, heads);
  * sharded over fsdp when the layout has fsdp > 1 (a `DTensor`), and
    always the same on its dp and sp peers.

A checkpoint is one process's file: every tensor gathered whole over tp
and fsdp, the stages' parameters merged, the optimizer's state indexed as
one process indexes it; every rank enters the gathers, global rank 0
writes.  Loading takes each rank's part of the whole tensors, so a file
written under one layout resumes under another.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional

import torch
import torch.distributed as dist

from . import tensor as tp_lib
from .mesh import DataParallel, ProcessGroupSP, all_reduce_flat
from .pipeline import owner_stage
from .sharding import full, is_sharded, local, shard_like


class Placement:
    def __init__(self, layout: DataParallel, full_names: Iterable[str],
                 tp_rules: Optional[dict] = None, half: int = 0):
        self.layout = layout
        self.full_names: List[str] = list(full_names)
        self.tp_rules = dict(tp_rules or {})
        self.half = half
        self.coords = layout.coords

    def owner(self, name: str) -> Optional[int]:
        return owner_stage(name, self.half, self.layout.pp) if self.layout.pp > 1 else None

    def counted(self, name: str) -> bool:
        """Whether this rank's piece of `name` enters the global norm: once
        over dp and sp peers, once over tp for a replicated tensor, once
        over the stages for one every stage holds (fsdp shards all count)."""
        c = self.coords
        return (c["dp"] == 0 and c["sp"] == 0
                and (name in self.tp_rules or c["tp"] == 0)
                and (self.owner(name) is not None or c["pp"] == 0))

    # --- gradients ----------------------------------------------------------

    def reduce_grads(self, params: Dict[str, torch.Tensor], manual_data: bool) -> None:
        """After the backward: sum over sp (each sp process computed the
        whole loss, scaled by 1/sp), sum the replicated parameters over pp
        (stage 0 alone holds the embeddings' gradient, every stage 1/P of
        the head's), and, when `manual_data` (neither DDP nor FSDP reduce
        them), average over dp."""
        layout = self.layout
        if isinstance(layout.seq, ProcessGroupSP):  # this rank's fsdp shards, if sharded
            all_reduce_flat([local(p.grad) for p in params.values() if p.grad is not None],
                            layout.seq.group)
        if layout.pp > 1:
            shared = []
            for name, p in params.items():
                if self.owner(name) is None:
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
                    shared.append(local(p.grad))
            all_reduce_flat(shared, layout.group("pp"))
        if manual_data and layout.dp > 1:
            grads = [local(p.grad) for p in params.values() if p.grad is not None]
            all_reduce_flat(grads, layout.group("dp"))
            torch._foreach_div_(grads, float(layout.dp))

    def grad_norm(self, params: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The 2-norm of the whole gradient, every parameter counted once."""
        grads = [local(p.grad) for n, p in params.items()
                 if p.grad is not None and self.counted(n)]
        device = next(iter(params.values())).device
        sq = (torch.stack(torch._foreach_norm(grads)).square().sum() if grads
              else torch.zeros((), device=device))
        sq = sq.float()
        dist.all_reduce(sq)
        return sq.sqrt()

    # --- whole tensors --------------------------------------------------------

    def whole(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """`t`, this rank's piece of `name`, gathered over fsdp and tp (a
        collective over those groups)."""
        if is_sharded(t):
            t = full(t)
        if name in self.tp_rules:
            t = tp_lib.gather(t, self.tp_rules[name], self.layout.group("tp"), self.layout.tp)
        return t

    def part(self, name: str, whole: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        """This rank's piece of the whole tensor `name`, laid out as `like`."""
        if name in self.tp_rules:
            whole = tp_lib.split(whole, self.tp_rules[name], self.layout.tp, self.coords["tp"])
        return shard_like(whole, like) if is_sharded(like) else whole.to(like.device, like.dtype)

    def merge_stages(self, by_name: dict) -> dict:
        """{name: value} of every stage's names (values moved to the host);
        a collective over pp.  The replicated names come from stage 0."""
        if self.layout.pp == 1:
            return by_name
        stage = self.coords["pp"]
        mine = {n: _to_host(v) for n, v in by_name.items()
                if self.owner(n) == stage or (self.owner(n) is None and stage == 0)}
        parts = [None] * self.layout.pp
        dist.all_gather_object(parts, mine, group=self.layout.group("pp"))
        merged = {}
        for part in parts:
            merged.update(part)
        return merged


def _to_host(v):
    if torch.is_tensor(v):
        return v.detach().cpu()
    if isinstance(v, dict):
        return {k: _to_host(x) for k, x in v.items()}
    return v
