"""Kernel 1, the packed-qkv attention, on the card: isolated and in situ.

    python -m panopticdiffusionmodels_torch.scripts.bench_attention

Port of `scripts/bench_attention.py`.
- Isolated: at (B, L, H, D) = (32, 258, 16, 64), (32, 590, 8, 64) and
  (64, 258, 16, 64), `attention_qkv(impl='infer')` (the kernel) against one
  PyTorch call of the same function, `scaled_dot_product_attention` on the
  packed qkv's views (the yardstick of `PERF.md`), timed in turns with CUDA
  events (library, kernel, kernel, library, 5 times: medians and spreads);
  the plain version (`impl='plain'`) is timed beside them and is no
  yardstick.
- In situ: a U-ViT-L/2 forward (ImageNet-256, 21 blocks, bf16, seeded) at
  batch 32 with `attn_impl='xla'` (the port's plain attention) and
  `'infer'` (the kernel) on the same weights, best of 5 after a warm-up on
  the host's clock, with the JAX script's count of TFLOP/s.
`--device=cpu` runs on the CPU (the kernel route is then the plain one).
"""
from __future__ import annotations

import sys
import time

import torch
import torch.nn.functional as F

from ..configs import get_config
from ..models import get_nnet
from ..ops.attention import attention_qkv
from .measure import (
    alternate,
    device_ms,
    finish,
    read_counts,
    require_device,
    set_attn_impl,
    split_device,
    sync,
    zero_counts,
)

ISOLATED_SHAPES = [(32, 258, 16, 64), (32, 590, 8, 64), (64, 258, 16, 64)]
INSITU_BATCH = 32


def bench_isolated(device, shapes=ISOLATED_SHAPES) -> list:
    rows = []
    gen = torch.Generator(device=device).manual_seed(0)
    for b, l, heads, d in shapes:
        c = heads * d
        qkv = torch.randn((b, l, 3 * c), generator=gen, device=device).to(torch.bfloat16)
        q, k, v = qkv.view(b, l, 3, heads, d).permute(2, 0, 3, 1, 4)
        with torch.no_grad():
            kernel = lambda: attention_qkv(qkv, heads, impl="infer")  # noqa: E731
            library = lambda: F.scaled_dot_product_attention(q, k, v)  # noqa: E731
            zero_counts()
            kernel()
            launches = read_counts()["fused_attention_qkv"]
            row = dict(shape=[b, l, heads, d], kernel_launches_per_call=launches,
                       **alternate(kernel, library, device),
                       plain_ms=device_ms(lambda: attention_qkv(qkv, heads, impl="plain"),
                                          device))
        print(f"isolated B{b} L{l} H{heads}: sdpa {row['library_ms']:.3f} ms | kernel "
              f"{row['ms']:.3f} ms | kernel/sdpa {row['ms'] / row['library_ms']:.2f} | plain "
              f"{row['plain_ms']:.3f} ms", flush=True)
        rows.append(row)
    return rows


def forward_tflop(nnet, b: int, l: int) -> float:
    """The JAX script's count: per block the qkv, proj, QK^T + PV and MLP
    GEMMs (2 flops a multiply-add), over every block of the U-ViT."""
    c = nnet.in_blocks[0].attn.qkv.in_features
    blocks = len(nnet.in_blocks) + 1 + len(nnet.out_blocks)
    per_block = 2 * l * c * 3 * c + 2 * l * c * c + 4 * l * l * c + 2 * 2 * l * c * 4 * c
    return blocks * per_block * b / 1e12


def bench_insitu(device, dims=None, batch: int = INSITU_BATCH, reps: int = 5) -> list:
    kw = dict(get_config("imagenet256_uvit_large").nnet)
    kw.update(dims or {})
    name = kw.pop("name")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = get_nnet(name, **kw).to(device, torch.bfloat16).eval()
    size = kw["img_size"]
    x = torch.zeros((batch, kw["in_chans"], size, size), device=device)
    t = torch.full((batch,), 500.0, device=device)
    y = torch.zeros((batch,), dtype=torch.int64, device=device)
    rows = []
    for impl in ("xla", "infer"):  # one set of weights, the attention switched
        set_attn_impl(model, impl)
        with torch.no_grad():
            model(x, t, y)
            sync(device)
            zero_counts()
            times = []
            for _ in range(reps):
                t0 = time.perf_counter()
                model(x, t, y)
                sync(device)
                times.append(time.perf_counter() - t0)
        tt = min(times)
        tokens = (size // kw["patch_size"]) ** 2 + 2
        tf = forward_tflop(model, batch, tokens)
        launches = read_counts()["fused_attention_qkv"] // reps
        print(f"UViT-L fwd B{batch} attn_impl={impl}: {tt * 1e3:.2f} ms ({tf / tt:.1f} TF/s)")
        rows.append(dict(attn_impl=impl, batch=batch, best_ms=tt * 1e3, tflop=tf,
                         tflop_per_s=tf / tt, kernel_launches_per_forward=launches))
    return rows


def main(argv=None, device="cuda", shapes=ISOLATED_SHAPES, dims=None,
         batch: int = INSITU_BATCH) -> dict:
    """`shapes`, `dims` (U-ViT-L/2's nnet fields) and `batch` cut it to a tiny
    size for the CPU."""
    argv = sys.argv[1:] if argv is None else list(argv)
    device, _ = split_device(argv, device)
    device = require_device(device, "bench_attention")
    print(f"device: {device}" + (f" ({torch.cuda.get_device_name(device)})"
                                 if device.type == "cuda" else ""))
    return finish("bench_attention", dict(isolated=bench_isolated(device, shapes),
                                          insitu=bench_insitu(device, dims, batch)), device)


if __name__ == "__main__":
    main()
