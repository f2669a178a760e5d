"""What the port's measurement scripts share: the device argument, timing on
the host's clock around a synchronised device, the kernels' launch counters,
the card's name and power limit, and the one JSON line each script ends
with.

Each script under `panopticdiffusionmodels_torch/scripts/` runs on the card
unless its caller passes the CPU (`--device=cpu`, or `device="cpu"` to its
`main`); without a card a CUDA device raises
(`bench_panoptic_modes.require_device`).
"""
from __future__ import annotations

import json
import subprocess
import time
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from ..models.layers import Attention
from ..ops.kernels import fused_attention as fa
from ..ops.kernels import fused_ln_qkv_attention as fl
from ..ops.kernels import fused_qkv_attention as fqa
from ..ops.kernels import ring_hop
from .bench_panoptic_modes import require_device, sync

__all__ = ["require_device", "sync", "split_device", "card", "finish", "zero_counts",
           "read_counts", "times_s", "rel_dev", "set_attn_impl", "device_ms", "alternate"]


def split_device(argv: Sequence[str], device) -> Tuple[str, List[str]]:
    """(`--device=<d>` of argv, else `device`; the other arguments)."""
    rest = [a for a in argv if not a.startswith("--device=")]
    given = [a.split("=", 1)[1] for a in argv if a.startswith("--device=")]
    return (given[-1] if given else device), rest


def card(device) -> dict:
    """The card's name and power limit as `nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader` gives them, for a CUDA device, or for 'host' (a
    host benchmark) where there is a card; else both are None."""
    on_card = (torch.cuda.is_available() if str(device) == "host"
               else torch.device(device).type == "cuda")
    if not on_card:
        return {"name": None, "power_limit": None}
    line = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    name, _, limit = line.rpartition(",")
    return {"name": name.strip(), "power_limit": limit.strip()}


def finish(script: str, record: dict, device) -> dict:
    """Print `record` with the script's name, the device and the card as the
    script's last line, one JSON object; returns what was printed."""
    record = dict(script=script, device=str(device), card=card(device), **record)
    print(json.dumps(record), flush=True)
    return record


def zero_counts() -> None:
    """Every kernel wrapper's launch counter to 0."""
    fqa.launches = fqa.bwd_launches = ring_hop.launches = fa.launches = fl.launches = 0
    fl.gemm_launches = 0


def read_counts() -> dict:
    """The launches each kernel wrapper counted since `zero_counts`."""
    return {"fused_attention_qkv": fqa.launches, "fused_attention_qkv_vjp": fqa.bwd_launches,
            "attention_hop": ring_hop.launches, "fused_attention": fa.launches,
            "fused_ln_qkv_attention": fl.launches, "ln_qkv_gemm": fl.gemm_launches}


def times_s(fn: Callable[[], object], reps: int, device, warmup: int = 1) -> List[float]:
    """Host seconds of `reps` calls of fn after `warmup` untimed ones, each
    call ending with the device synchronised."""
    for _ in range(warmup):
        fn()
    sync(device)
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync(device)
        out.append(time.perf_counter() - t0)
    return out


def rel_dev(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b|| in f32 (b the reference)."""
    a, b = a.detach().float(), b.detach().float()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def set_attn_impl(model: torch.nn.Module, impl: str) -> None:
    """Every attention of `model` to the route `impl` (`ops.attention_qkv`'s)."""
    for m in model.modules():
        if isinstance(m, Attention):
            m.attn_impl = impl



def device_ms(fn: Callable[[], object], device, iters: int = 20, warmup: int = 3) -> float:
    """Mean ms of fn over `iters` calls after `warmup`: CUDA events around
    them on the card, the host's clock around them elsewhere."""
    for _ in range(warmup):
        fn()
    sync(device)
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters * 1e3
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def alternate(kernel, library, device, repeats: int = 5, iters: int = 20) -> dict:
    """The kernel and a library call of the same function timed in turns
    (library, kernel, kernel, library) `repeats` times, `device_ms` each:
    medians and (min, max) spreads, so that the two share the card's
    state."""
    ks, ls = [], []
    for _ in range(repeats):
        ls.append(device_ms(library, device, iters))
        ks.append(device_ms(kernel, device, iters))
        ks.append(device_ms(kernel, device, iters))
        ls.append(device_ms(library, device, iters))
    return dict(ms=float(np.median(ks)), ms_spread=[min(ks), max(ks)],
                library_ms=float(np.median(ls)), library_ms_spread=[min(ls), max(ls)])
