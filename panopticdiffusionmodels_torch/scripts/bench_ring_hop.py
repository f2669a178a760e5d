"""Ring attention's local hop math on the card: kernel 3 against the plain
hops, over a full sp hop sequence at the 512-res panoptic shard shape.

    python -m panopticdiffusionmodels_torch.scripts.bench_ring_hop

Port of `scripts/bench_ring_hop.py`.  One card holds one sp rank, so this
times the per-rank compute and memory of a whole sp = 2 hop sequence (the
part the kernel changes), with the rotation of the keys and values replaced
by a token roll (the hop inputs stay data-dependent), repeated over
RING_DEPTH (13) layers as the model's block stack does: each layer's
output, tiled back to the packed 3C width, is added to its input and the
sum RMS-normalised (in f32), so that the magnitude does not grow with depth.
The arms are the kernel (`ring_hop.attention_hop`) and the plain hops
(`attention_hop_plain`, the reference the kernel is held to), on the same
bf16 qkv of (RING_BATCH 8, RING_LQ 1063, 8 heads of 64) (L = 2126 at sp =
2).  It prints each arm's best of 5 after a warm-up (host clock around a
synchronised device), their parity (relative deviation, bar 5e-3) and each
arm's peak device memory (`torch.cuda.max_memory_allocated`, reset before
the arm), where the JAX script reads XLA's memory analysis.
`--device=cpu` runs on the CPU (both arms are then the plain hop).
"""
from __future__ import annotations

import os
import sys

import torch

from ..ops.kernels.ring_hop import attention_hop, attention_hop_plain
from .measure import finish, read_counts, rel_dev, require_device, split_device, times_s, \
    zero_counts

PARITY_BAR = 5e-3
HEADS, HEAD_DIM, SP = 8, 64, 2


def make_ring_local(heads: int, scale: float, sp: int, use_kernel: bool, depth: int):
    """fn(qkv) -> the carry after `depth` layers of emulated per-rank ring
    attention over `sp` hops (the JAX script's `make_ring_local`)."""
    hop_fn = attention_hop if use_kernel else attention_hop_plain

    def attn(qkv):
        b, lq, c3 = qkv.shape
        c = c3 // 3
        d = c // heads
        q, kv = qkv[..., :c], qkv[..., c:]
        o_hop, m, den = hop_fn(q, kv, heads, scale, lq)
        o = o_hop.float().reshape(b, lq, heads, d)
        m, den = m[..., None], den[..., None]
        for hop in range(1, sp):
            kv = torch.roll(kv, 7 * hop, dims=1)  # stands in for the rotation
            o_hop, m_hop, den_hop = hop_fn(q, kv, heads, scale, lq)
            m_hop, den_hop = m_hop[..., None], den_hop[..., None]
            m_new = torch.maximum(m, m_hop)
            corr, corr_hop = torch.exp(m - m_new), torch.exp(m_hop - m_new)
            den = den * corr + den_hop * corr_hop
            o = o * corr + o_hop.float().reshape(b, lq, heads, d) * corr_hop
            m = m_new
        return (o / den).to(qkv.dtype).reshape(b, lq, c)

    @torch.no_grad()
    def fn(qkv):
        x = qkv
        for _ in range(depth):
            o = attn(x)
            nxt = x + torch.cat([o, o, o], dim=-1)
            rms = torch.sqrt(nxt.float().square().mean(dim=-1, keepdim=True) + 1e-6)
            x = (nxt.float() / rms).to(x.dtype)
        return x

    return fn


def main(argv=None, device="cuda", heads: int = HEADS, head_dim: int = HEAD_DIM) -> dict:
    """`heads` and `head_dim`, with RING_BATCH / RING_LQ / RING_DEPTH, cut
    it to a tiny size for the CPU."""
    argv = sys.argv[1:] if argv is None else list(argv)
    device, _ = split_device(argv, device)
    device = require_device(device, "bench_ring_hop")
    b = int(os.environ.get("RING_BATCH", "8"))
    lq = int(os.environ.get("RING_LQ", "1063"))
    depth = int(os.environ.get("RING_DEPTH", "13"))
    reps = int(os.environ.get("BENCH_REPS", "5"))
    c = heads * head_dim
    scale = head_dim ** -0.5
    gen = torch.Generator(device=device).manual_seed(0)
    qkv = (torch.randn((b, lq, 3 * c), generator=gen, device=device) * 0.5).to(torch.bfloat16)
    on_card = device.type == "cuda"
    results = {}
    for use_kernel in (False, True):
        name = "kernel_hop" if use_kernel else "plain_hop"
        fn = make_ring_local(heads, scale, SP, use_kernel, depth)
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(device)
            base = torch.cuda.memory_allocated(device)
        zero_counts()
        out = {}
        times = times_s(lambda: out.update(x=fn(qkv)), reps, device)
        launches = read_counts()["attention_hop"] // (reps + 1)
        peak = torch.cuda.max_memory_allocated(device) if on_card else None
        results[name] = dict(best_ms=min(times) * 1e3, times_ms=[t * 1e3 for t in times],
                             hop_launches_per_call=launches,
                             peak_mb=None if peak is None else peak / 1e6,
                             peak_above_inputs_mb=None if peak is None else (peak - base) / 1e6)
        results[name]["out"] = out["x"]
        mem = ("" if peak is None else
               f"; peak device memory {peak / 1e6:.0f} MB ({(peak - base) / 1e6:.0f} MB above "
               "the inputs)")
        print(f"{name}: best {min(times) * 1e3:.1f} ms over {depth} layers x {SP} hops "
              f"(B{b} Lq{lq}){mem}", flush=True)
    plain, kernel = results["plain_hop"], results["kernel_hop"]
    dev = rel_dev(kernel.pop("out"), plain.pop("out"))
    print(f"parity: rel dev {dev:.2e}")
    print(f"speedup: {plain['best_ms'] / kernel['best_ms']:.2f}x"
          + ("" if not on_card else f"; peak memory {plain['peak_mb']:.0f} -> "
             f"{kernel['peak_mb']:.0f} MB"))
    assert dev < PARITY_BAR, dev
    return finish("bench_ring_hop", dict(
        batch=b, lq=lq, heads=heads, head_dim=head_dim, sp=SP, depth=depth, reps=reps,
        parity_rel_dev=dev, parity_bar=PARITY_BAR, **results), device)


if __name__ == "__main__":
    main()
