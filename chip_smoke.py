#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one NVIDIA H100 and check its kernel.

    python3 chip_smoke.py    # from the repository root, on a machine with the card

Phases (any failure exits non-zero; without a CUDA card it exits 1 at once):
  1. environment: card name and power limit, torch / CUDA / nvcc versions;
  2. build: every hand-written kernel of the path, from `csrc/`, with nvcc;
  3. kernel vs its plain PyTorch version in bf16 at the path's shapes
     (relative deviation < 5e-3), with CUDA-event times of the kernel, the
     plain version and `scaled_dot_product_attention` as the yardstick;
  4. the full-width UViTT2I forward (mscoco_uvit_small, B=8) with the kernel
     against the same weights with the plain attention (relative deviation
     < 2e-2 on noise and mask);
  5. serving: GenerationPipeline.from_config("mscoco_uvit_small"), seeded
     random weights, bf16; a 6-step request through the kernel against the
     same request through the plain attention (relative deviation < 2e-2 on
     images, < 5e-2 on the mask prediction); then it answers 3 requests of 4
     CLIP contexts at 50 steps
     through generate_batches; the kernel's launch counter must rise by
     exactly 1300 per request (13 blocks x 2 streams x 50 NFE);
  6. one more request under torch.profiler: device time by kernel and the
     device's busy share of the request;
  7. prints the card line, the `kernels` JSON line and, last, the ok line.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from panopticdiffusionmodels_torch.configs import get_config
from panopticdiffusionmodels_torch.models import get_nnet
from panopticdiffusionmodels_torch.models.layers import Attention
from panopticdiffusionmodels_torch.ops.kernels import build
from panopticdiffusionmodels_torch.ops.kernels import fused_qkv_attention as fqa
from panopticdiffusionmodels_torch.serving import GenerationPipeline

# H100 SXM dense peaks (NVIDIA data sheet): bf16 tensor cores, HBM3 bandwidth.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# (B, L, H, D): the serving path's two lengths at batch 2x4, U-ViT-L/2 and U-ViT-H.
KERNEL_SHAPES = [(8, 334, 8, 64), (8, 590, 8, 64), (32, 258, 16, 64), (8, 258, 16, 72)]
MAIN_PATH_SHAPES = KERNEL_SHAPES[:2]
LAUNCHES_PER_REQUEST = 1300
REQUESTS, PER_REQUEST, STEPS = 3, 4, 50


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rel_dev(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def phase_environment():
    nvcc = subprocess.run([build.nvcc_path(), "--version"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[-1]
    print(f"[1] card: {card_line()} | torch {torch.__version__} | CUDA {torch.version.cuda}"
          f" | nvcc: {nvcc} | devices {torch.cuda.device_count()}")


def phase_build():
    t0 = time.perf_counter()
    build.build_all([fqa.NAME])
    print(f"[2] built {fqa.NAME} in {time.perf_counter() - t0:.2f} s")
    for name, (secs, log) in build.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"    {name}: {line.strip()}")


def phase_kernel(gen):
    rows = []
    for b, l, h, d in KERNEL_SHAPES:
        c = h * d
        qkv = (torch.randn((b, l, 3 * c), generator=gen, device="cuda") * 0.5).to(torch.bfloat16)
        scale = d ** -0.5
        out = fqa.fused_attention_qkv(qkv, h, scale)
        ref = fqa.attention_qkv_plain(qkv, h, scale)
        torch.cuda.synchronize()
        rel = rel_dev(out, ref)
        max_abs = float((out.float() - ref.float()).abs().max())
        q, k, v = qkv.view(b, l, 3, h, d).permute(2, 0, 3, 1, 4)
        row = dict(
            shape=[b, l, h, d], max_rel_dev=rel, max_abs_err=max_abs,
            ms=cuda_ms(lambda: fqa.fused_attention_qkv(qkv, h, scale)),
            plain_ms=cuda_ms(lambda: fqa.attention_qkv_plain(qkv, h, scale)),
            library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale)))
        bytes_ms = (b * l * 3 * c + b * l * c) * 2 / PEAK_BYTES * 1e3
        flops_ms = 4 * b * l * l * c / PEAK_BF16_FLOPS * 1e3
        row.update(bound_ms=max(bytes_ms, flops_ms),
                   bound_by="bytes" if bytes_ms >= flops_ms else "operations")
        print(f"[3] B{b} L{l} H{h} D{d}: rel {rel:.2e} max|err| {max_abs:.2e} | kernel "
              f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, sdpa "
              f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
        assert np.isfinite(rel) and rel < 5e-3, (b, l, h, d, rel)
        rows.append(row)
    return rows


def set_attn_impl(model: torch.nn.Module, impl: str) -> None:
    for m in model.modules():
        if isinstance(m, Attention):
            m.attn_impl = impl


def phase_forward(gen):
    kw = dict(get_config("mscoco_uvit_small").nnet)
    torch.manual_seed(1)
    model = get_nnet(kw.pop("name"), **kw)
    with torch.no_grad():  # open the zero-conv gates so the coupling carries signal
        for zc in model.zero_convs.values():
            zc.conv.weight.normal_(0, 0.02)
            zc.conv.bias.normal_(0, 0.02)
    model = model.to("cuda", torch.bfloat16).eval()
    x = torch.randn((8, 4, 32, 32), generator=gen, device="cuda")
    t = torch.rand((8,), generator=gen, device="cuda") * 1000
    ctx = torch.randn((8, 77, 768), generator=gen, device="cuda")
    m = torch.randn((8, 8, 64, 64), generator=gen, device="cuda")
    outs = {}
    with torch.no_grad():
        for impl in ("kernel", "plain"):
            set_attn_impl(model, impl)
            outs[impl] = model(x, t, ctx, mask_token=m)
    torch.cuda.synchronize()
    for i, name in enumerate(("noise", "mask")):
        a, b = outs["kernel"][i], outs["plain"][i]
        rel = rel_dev(a, b)
        print(f"[4] full-width UViTT2I forward B=8, {name}: kernel vs plain rel {rel:.2e}")
        assert torch.isfinite(a).all() and rel < 2e-2, (name, rel)


def phase_serving():
    pipe = GenerationPipeline.from_config("mscoco_uvit_small", seed=0)
    rng = np.random.default_rng(0)
    batches = [{"contexts": rng.standard_normal((PER_REQUEST, 77, 768)).astype(np.float32)}
               for _ in range(REQUESTS)]
    pipe.generate(contexts=batches[0]["contexts"], steps=3)  # warm-up, not counted

    # The request path end to end (solver, CFG, VAE) at 6 steps on the same
    # draws, once through the kernel and once through the plain attention.
    ctx = torch.as_tensor(batches[0]["contexts"], device="cuda")
    z, m0 = pipe._draw(PER_REQUEST, torch.Generator(device="cuda").manual_seed(5))
    outs = {}
    for impl in ("kernel", "plain"):
        set_attn_impl(pipe.nnet, impl)
        outs[impl] = pipe.sample(z, m0, ctx, steps=6)
    set_attn_impl(pipe.nnet, "infer")
    # Images are held to the full-forward bar.  The mask prediction is the
    # raw tanh output of the last of 17 chained NFEs, with no decoder to
    # average it, so the per-forward 2e-2 compounds: it gets 5e-2.
    for i, (name, bar) in enumerate((("images", 2e-2), ("mask", 5e-2))):
        a, b = outs["kernel"][i], outs["plain"][i]
        rel = rel_dev(a, b)
        print(f"[5] 6-step request, {name}: kernel vs plain rel {rel:.2e} (bar {bar:.0e})")
        assert torch.isfinite(a).all() and rel < bar, (name, rel)
    torch.cuda.synchronize()

    fqa.launches = 0
    t0 = time.perf_counter()
    done = []
    for i, (images, ids) in enumerate(pipe.generate_batches(batches, steps=STEPS, seed=0)):
        done.append(time.perf_counter() - t0)
        dispatched = min(i + 2, REQUESTS)  # generate_batches runs one request ahead
        assert fqa.launches == dispatched * LAUNCHES_PER_REQUEST, (i, fqa.launches)
        assert images.shape == (PER_REQUEST, 256, 256, 3), images.shape
        assert np.isfinite(images).all() and images.min() >= 0 and images.max() <= 1
        assert ids.shape == (PER_REQUEST, 64, 64, 1) and ids.dtype == np.int32, ids.shape
        assert ids.min() >= 0 and ids.max() < 256
    total = done[-1]
    launches = fqa.launches
    assert launches == REQUESTS * LAUNCHES_PER_REQUEST, launches

    torch.cuda.synchronize()
    t1 = time.perf_counter()
    pipe.generate(contexts=batches[0]["contexts"], steps=STEPS, seed=1)
    latency = time.perf_counter() - t1
    result = dict(requests=REQUESTS, images_per_request=PER_REQUEST, steps=STEPS,
                  launches=launches, total_s=total, per_request_s=total / REQUESTS,
                  yields_s=done, single_request_latency_s=latency,
                  images_per_s=REQUESTS * PER_REQUEST / total)
    print(f"[5] serving: {json.dumps(result)}")
    return pipe, batches[0]["contexts"], launches, latency


def phase_profile(pipe, contexts, latency):
    """One more request under torch.profiler: device time by kernel, and the
    device's busy share of the request's wall time (the profiler slows the
    host, so the share is also given against the unprofiled `latency`)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe.generate(contexts=contexts, steps=STEPS, seed=2)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # kernels only: operator rows carry the device time of the kernels they launch
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0),
                  key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    print(f"[6] profiled request: wall {wall * 1e3:.1f} ms, device busy {busy_ms:.1f} ms "
          f"in {sum(r[2] for r in rows)} kernels ({busy_ms / (wall * 1e3):.1%} of the "
          f"profiled wall time, {busy_ms / (latency * 1e3):.1%} of the unprofiled "
          f"{latency * 1e3:.1f} ms)")
    for name, ms, count in rows[:25]:
        print(f"[6] {ms:9.3f} ms {count:6d}x  {name[:110]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script runs on the "
              "card only", file=sys.stderr)
        return 1
    phase_environment()
    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = phase_kernel(gen)
    phase_forward(gen)
    pipe, contexts, launches, latency = phase_serving()
    phase_profile(pipe, contexts, latency)

    main_rows = [r for r in rows if tuple(r["shape"]) in MAIN_PATH_SHAPES]
    per_pair = {k: sum(r[k] for r in main_rows) for k in ("ms", "plain_ms", "bound_ms",
                                                          "library_ms")}
    kernel = dict(
        name="fused_attention_qkv", route="cuda",
        source="panopticdiffusionmodels_torch/ops/kernels/csrc/fused_qkv_attention.cu",
        replaces="panopticdiffusionmodels_tpu/ops/pallas/fused_qkv_attention.py:302",
        launches=launches,
        max_abs_err=max(r["max_abs_err"] for r in rows),
        max_rel_dev=max(r["max_rel_dev"] for r in rows),
        kernel_ms=per_pair["ms"], **per_pair,
        bound_by="bytes" if all(r["bound_by"] == "bytes" for r in main_rows) else "operations",
        per="one launch at L=334 plus one at L=590 (B=8, H=8, D=64), the pair each "
            "dual-stream layer runs per NFE",
        shapes=rows)
    print(card_line())
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
