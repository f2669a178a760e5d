"""Pipeline parallelism over the U-ViT's long-skip depth: the mesh axis `pp`.

Port of `panopticdiffusionmodels_tpu/parallel/pipeline.py`
(`pipeline_blocks`, `make_pipelined_apply`, l.66-345), over processes with
point-to-point sends on the pp group.

**Boomerang stages.**  A U-ViT of depth 2H+1 is H in-layers, a mid layer
and H out-layers with LIFO long skips (in-layer i feeds out-layer H-1-i).
With P stages and k = H/P, stage s owns in-layers [s*k, (s+1)*k) and the
out-layers [H-(s+1)*k, H-s*k) that consume exactly their skips, so long
skips never cross a stage; the mid layer rides on the last stage.  A layer
is a model's `in_layer` / `mid_layer` / `out_layer` (for the dual-stream
UViTT2I the image block, the mask block and their zero conv move as one, as
JAX's `_DualBody` does).  The port has no scanned stacks: a stage holds
slices of the unrolled `ModuleList`s (`keep_stage` drops the others), and
JAX's reversed out-stack becomes the index map above.

**Schedule** (JAX's ticks): T = M + 2P - 2 ticks for M microbatches.
Microbatch u enters stage 0 at tick u, stage s runs its in-slice on it at
tick u+s, the last stage turns it around (in-slice, mid, out-slice) at tick
u+P-1, and stage s runs its out-slice on it at tick u+2(P-1)-s; stage 0's
out-slice output at tick u+2P-2 is microbatch u's, and the microbatch order
is restored by index.  A stage skips the slices of a tick on which it holds
no microbatch (JAX computes zeros there that never reach an output), so in
one step stage s runs its 2k layers (the last 2k+1) M times each.  After
every tick but the last, the stages exchange their carries: s sends its
in-slice output down to s+1 and its out-slice output up to s-1 (zeros on an
idle tick), as JAX's two ppermutes.

**Autograd** runs through the exchanges as JAX's does through `ppermute`:
each tick's exchange is one `torch.autograd.Function` whose backward sends
the received carries' gradients back and receives those of the sent ones.
A scalar token threads every exchange of a step in order, so each stage's
single `backward()` runs the exchanges' backwards in reverse tick order, the
same order on every stage, and the microbatches' gradients accumulate in
the parameters.  Stage 0's outputs are then broadcast over pp
(`_Broadcast`, backward: the sum of every stage's gradient), every stage
runs the replicated head and the whole loss, and the trainer scales the
loss by 1/P and sums the replicated parameters' gradients over pp: the
step is one process's.

The exchange is passed in: `ProcessExchange` over the layout's pp group,
or `LocalExchange`, every stage in one process, which holds the engine to
JAX's `pipeline_blocks` without processes.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from .mesh import p2p

# A carry's dtype on the wire, by its index here.  Under autocast the two
# directions differ (an in-layer keeps the f32 residual, an out-layer
# returns bf16), so every exchange first sends the dtypes of what follows
# and each receive is posted in its send's dtype.
_WIRE_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float64)


def _dtype_codes(tensors, device) -> torch.Tensor:
    return torch.tensor([float(_WIRE_DTYPES.index(t.dtype)) for t in tensors], device=device)


def _dtypes(codes: torch.Tensor) -> list:
    return [_WIRE_DTYPES[int(c)] for c in codes.tolist()]

Carry = Tuple[torch.Tensor, ...]


def adapt_micro(num_micro: int, batch: int) -> int:
    """The largest microbatch count <= `num_micro` that divides the batch
    (JAX `_adapt_micro`): eval-time batches of any size, CFG-doubled too."""
    m = min(num_micro, batch)
    while batch % m:
        m -= 1
    return m


def stage_of_in(i: int, half: int, pp: int) -> int:
    return i // (half // pp)


def stage_of_out(o: int, half: int, pp: int) -> int:
    return (half - 1 - o) // (half // pp)


def run_trunk(feed: Sequence[Carry], exchange, layers, half: int, pp: int):
    """The block trunk of M = len(feed) microbatches as a pp-stage pipeline
    over the stages `exchange.stages` of this process.  `layers` has
    `in_layer(i, carry) -> (carry, skip)`, `mid_layer(carry)` and
    `out_layer(o, carry, skip)`; `feed` holds every microbatch's carry (the
    embed output; only stage 0 reads it, the others take their shapes).
    Returns (the token, stage 0's outputs per microbatch, or None where
    stage 0 is not here)."""
    if half % pp:
        raise ValueError(f"mesh.pp={pp} must divide depth/2={half}")
    k, m = half // pp, len(feed)
    ticks = m + 2 * pp - 2
    zero = tuple(torch.zeros_like(t) for t in feed[0])
    down_in: Dict[int, Carry] = {s: zero for s in exchange.stages}
    up_in: Dict[int, Carry] = {s: zero for s in exchange.stages}
    skips: Dict[int, dict] = {s: {} for s in exchange.stages}
    outputs: Optional[List[Carry]] = [None] * m if 0 in exchange.stages else None
    token = exchange.token(feed[0][0])
    for t in range(ticks):
        outs = {}
        for s in exchange.stages:
            u = t - s
            down_out = up_out = zero
            if 0 <= u < m:
                carry, held = feed[u] if s == 0 else down_in[s], []
                for i in range(s * k, (s + 1) * k):
                    carry, skip = layers.in_layer(i, carry)
                    held.append(skip)
                skips[s][u] = held
                down_out = carry
            if s == pp - 1:
                uu, start = (u, layers.mid_layer(down_out)) if 0 <= u < m else (None, None)
            else:
                uu = t - 2 * (pp - 1) + s
                uu, start = (uu, up_in[s]) if 0 <= uu < m else (None, None)
            if uu is not None:
                carry, held = start, skips[s].pop(uu)
                for o in range(half - (s + 1) * k, half - s * k):
                    carry = layers.out_layer(o, carry, held.pop())
                up_out = carry
                if s == 0:
                    outputs[uu] = carry
            outs[s] = (down_out, up_out)
        if t < ticks - 1:
            token, ins = exchange.exchange(token, outs)
            for s in exchange.stages:
                down_in[s], up_in[s] = ins[s]
    return token, outputs


class LocalExchange:
    """Every stage in this process: the carries move between the stages'
    slots, and autograd follows them."""

    def __init__(self, pp: int):
        self.pp = pp
        self.stages = list(range(pp))

    def token(self, like):
        return None

    def exchange(self, token, outs):
        ins = {s: (outs[s - 1][0] if s > 0 else None,
                   outs[s + 1][1] if s < self.pp - 1 else None) for s in self.stages}
        return token, ins

    def collect(self, token, outputs, like, micro):
        return tuple(torch.cat(parts) for parts in zip(*outputs))


class _Exchange(torch.autograd.Function):
    """One tick's exchange: `sends` to the stage below (the down carry) and
    above (the up carry), receives from them; the backward swaps the roles."""

    @staticmethod
    def forward(ctx, ex, token, n_down, *sent):
        ctx.ex, ctx.n_down = ex, n_down
        got = ex.swap(sent[:n_down], sent[n_down:])
        ctx.n_got_down = len(got[0])
        return (token.clone(), *got[0], *got[1])

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_token, *g_got):
        ex, n = ctx.ex, ctx.n_got_down
        # gradients go back where their carries came from: the down carry
        # received from s-1 returns to s-1 (upwards), the up carry to s+1
        from_above, from_below = ex.swap(g_got[n:], g_got[:n])
        return (None, g_token, None, *from_below, *from_above)


class _Broadcast(torch.autograd.Function):
    """Stage 0's outputs to every stage of pp; the backward sums every
    stage's gradient into stage 0's."""

    @staticmethod
    def forward(ctx, ex, token, *tensors):
        ctx.ex = ex
        outs = []
        for t in tensors:
            buf = t.detach().float().contiguous().clone()
            dist.broadcast(buf, ex.peers[0], group=ex.group)
            outs.append(buf.to(t.dtype))
        return (token.clone(), *outs)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_token, *grads):
        ex, out = ctx.ex, []
        for g in grads:
            buf = g.float().contiguous().clone()
            dist.all_reduce(buf, group=ex.group)
            out.append(buf.to(g.dtype) if ex.stage == 0 else None)
        return (None, g_token, *out)


class ProcessExchange:
    """This process's stage of the layout's pp group: point-to-point sends
    to the global ranks of the stages below and above."""

    def __init__(self, layout):
        self.pp = layout.pp
        self.stage = layout.coords["pp"]
        self.stages = [self.stage]
        self.group = layout.group("pp")
        self.peers = layout.peers("pp")

    def token(self, like):
        return torch.zeros((), device=like.device, requires_grad=torch.is_grad_enabled())

    def swap(self, to_below, to_above):
        """Send `to_below` to stage s+1 and `to_above` to s-1 (forward: the
        down and up carries; backward: gradients); receive the matching
        tensors from s-1 and s+1.  Returns (from s-1, from s+1)."""
        s, pp = self.stage, self.pp
        below, above = (self.peers[s + 1] if s < pp - 1 else None,
                        self.peers[s - 1] if s > 0 else None)
        like = self._like
        dev = like[0].device
        codes = {peer: torch.empty(len(like), device=dev) for peer in (above, below)
                 if peer is not None}
        p2p([(_dtype_codes(ts, dev), peer) for ts, peer in ((to_below, below), (to_above, above))
             if ts], list((c, peer) for peer, c in codes.items()), self.group)

        def posted(peer):
            if peer is None:
                return []
            return [torch.empty(t.shape, dtype=dt, device=dev)
                    for t, dt in zip(like, _dtypes(codes[peer]))]

        from_above, from_below = posted(above), posted(below)
        sends = [(t, below) for t in to_below] + [(t, above) for t in to_above]
        p2p(sends, [(t, above) for t in from_above] + [(t, below) for t in from_below],
            self.group)
        return from_above, from_below

    def exchange(self, token, outs):
        down_out, up_out = outs[self.stage]
        self._like = down_out
        s, pp = self.stage, self.pp
        sent_down = list(down_out) if s < pp - 1 else []
        sent_up = list(up_out) if s > 0 else []
        if token is None or not token.requires_grad:
            got = self.swap(sent_down, sent_up)
        else:
            res = _Exchange.apply(self, token, len(sent_down), *sent_down, *sent_up)
            token, flat = res[0], res[1:]
            n = len(down_out) if s > 0 else 0
            got = (flat[:n], flat[n:])
        down_in = tuple(got[0]) if s > 0 else None
        up_in = tuple(got[1]) if s < pp - 1 else None
        return token, {s: (down_in, up_in)}

    def collect(self, token, outputs, like, micro):
        """Stage 0's outputs, whole-batch, on every stage of pp (`like`: a
        microbatch's carry, `micro` microbatches)."""
        dev = like[0].device
        if outputs is not None:
            mine = tuple(torch.cat(parts) for parts in zip(*outputs))
            codes = _dtype_codes(mine, dev)
        else:
            codes = torch.empty(len(like), device=dev)
        dist.broadcast(codes, self.peers[0], group=self.group)  # stage 0's dtypes
        if outputs is None:
            mine = tuple(t.new_empty((t.shape[0] * micro, *t.shape[1:]), dtype=dt)
                         for t, dt in zip(like, _dtypes(codes)))
        if token is not None and token.requires_grad:
            return _Broadcast.apply(self, token, *mine)[1:]
        outs = []
        for t in mine:
            buf = t.float().contiguous()
            dist.broadcast(buf, self.peers[0], group=self.group)
            outs.append(buf.to(t.dtype))
        return tuple(outs)


class _OnAnotherStage(nn.Module):
    """A block this pipeline stage does not hold."""

    def __init__(self, stage: int):
        super().__init__()
        self.stage = stage

    def forward(self, *args, **kwargs):
        raise RuntimeError(f"this block lives on pipeline stage {self.stage}")


def keep_stage(nnet: nn.Module, pp: int, stage: int) -> None:
    """Drop the blocks of the other stages from `nnet` (in place): its
    in-layers [s*k, (s+1)*k), the out-layers that consume their skips, and
    on the last stage the mid layer, stay; embeddings and heads stay on
    every stage."""
    half = len(nnet.in_blocks)
    for suffix in ("", "_mask"):
        ins, outs = getattr(nnet, "in_blocks" + suffix, None), getattr(nnet, "out_blocks" + suffix, None)
        if ins is None:
            continue
        for i in range(half):
            if stage_of_in(i, half, pp) != stage:
                ins[i] = _OnAnotherStage(stage_of_in(i, half, pp))
            if stage_of_out(i, half, pp) != stage:
                outs[i] = _OnAnotherStage(stage_of_out(i, half, pp))
        if stage != pp - 1:
            setattr(nnet, "mid_block" + suffix, _OnAnotherStage(pp - 1))
    zcs = getattr(nnet, "zero_convs", None)
    if zcs is not None:
        for i in range(half):
            if stage_of_in(i, half, pp) != stage:
                del zcs[str(2 * i + 1)]
            if stage_of_out(i, half, pp) != stage:
                del zcs[str(2 * (half + 1 + i) + 1)]
        if stage != pp - 1:
            del zcs[str(2 * half + 1)]


def owner_stage(name: str, half: int, pp: int) -> Optional[int]:
    """The stage that holds parameter `name`, or None for one every stage
    holds (embeddings, norms, heads)."""
    parts = name.split(".")
    head = parts[0]
    if head in ("in_blocks", "in_blocks_mask"):
        return stage_of_in(int(parts[1]), half, pp)
    if head in ("out_blocks", "out_blocks_mask"):
        return stage_of_out(int(parts[1]), half, pp)
    if head in ("mid_block", "mid_block_mask"):
        return pp - 1
    if head == "zero_convs":
        index = (int(parts[1]) - 1) // 2
        if index < half:
            return stage_of_in(index, half, pp)
        if index == half:
            return pp - 1
        return stage_of_out(index - half - 1, half, pp)
    return None


class _Layers:
    """A model's layers with the forward's ctx bound."""

    def __init__(self, nnet, ctx):
        self.nnet, self.ctx = nnet, ctx

    def in_layer(self, i, carry):
        return self.nnet.in_layer(i, carry, self.ctx)

    def mid_layer(self, carry):
        return self.nnet.mid_layer(carry, self.ctx)

    def out_layer(self, o, carry, skip):
        return self.nnet.out_layer(o, carry, skip, self.ctx)


class Pipelined(nn.Module):
    """`nnet`'s forward with its block trunk run as a pipeline (JAX
    `make_pipelined_apply`): every stage embeds (the replicated embed; only
    stage 0's output feeds the pipeline), the trunk runs over the stages in
    `adapt_micro(num_micro, batch)` microbatches, stage 0's outputs are
    broadcast and every stage runs the head.  Calls like `nnet`."""

    def __init__(self, nnet: nn.Module, exchange, num_micro: int):
        super().__init__()
        self.nnet = nnet
        self.exchange = exchange
        self.num_micro = num_micro
        self.pp = exchange.pp

    def forward(self, *args, **kwargs):
        ex = self.exchange
        first = 0 in ex.stages
        with torch.set_grad_enabled(torch.is_grad_enabled() and first):
            carry, ctx = self.nnet.embed(*args, **kwargs)
        m = adapt_micro(self.num_micro, carry[0].shape[0])
        feed = list(zip(*(t.chunk(m) for t in carry)))
        token, outputs = run_trunk(feed, ex, _Layers(self.nnet, ctx),
                                   len(self.nnet.in_blocks), self.pp)
        return self.nnet.head(ex.collect(token, outputs, feed[0], m), ctx)
