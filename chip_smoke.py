#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one NVIDIA H100 and
check their kernels.

    python3 chip_smoke.py    # from the repository root, on a machine with the card

Phases (any failure exits non-zero; without a CUDA card it exits 1 at once):
  1. environment: card name and power limit, torch / CUDA / nvcc versions;
  2. build: every hand-written kernel of the paths, from `csrc/`, with nvcc
     (one process per source, all at once);
  3. the forward kernel vs its plain PyTorch version in bf16 at the serving
     and training shapes (relative deviation < 5e-3), with CUDA-event times
     of the kernel, the plain version and `scaled_dot_product_attention` as
     the yardstick; the forward with its lse output is bit-identical to the
     forward without it and its lse is within 1e-4 relative of the plain one;
     `attn_impl='infer'` on a CUDA tensor that needs a gradient raises;
     3b. the backward kernel vs `attention_qkv_vjp_plain` at the training
     shapes and U-ViT-L/2 / U-ViT-H (relative deviation of dqkv < 5e-3),
     timed beside the plain version and SDPA's backward;
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
  7. training: `Trainer` for mscoco_uvit_small at full width and depth in
     fine-tune mode (a seeded reference-format `.pth` in a temporary
     directory, so the image stream is frozen) on synthetic coco data at the
     config's shapes; one step (batch 16) through the kernels against the
     same step through the plain attention (loss relative deviation < 5e-3,
     whole-gradient relative deviation < 2e-2);
  8. `Trainer.fit`: 3 warm-up steps, then 20 timed steps at batch 64: steps/s,
     images/s, peak memory, finite losses, and exactly 26 forward and 26
     backward kernel calls per step;
  9. one more step under torch.profiler: device busy time and top kernels;
 10. prints the computed bounds of the kernels still to be ported, the card
     line, the `kernels` JSON line and, last, the ok line.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from panopticdiffusionmodels_torch.configs import get_config
from panopticdiffusionmodels_torch.configs.base import d
from panopticdiffusionmodels_torch.models import get_nnet
from panopticdiffusionmodels_torch.models.layers import Attention
from panopticdiffusionmodels_torch.ops.attention import attention_qkv
from panopticdiffusionmodels_torch.ops.kernels import build
from panopticdiffusionmodels_torch.ops.kernels import fused_qkv_attention as fqa
from panopticdiffusionmodels_torch.serving import GenerationPipeline
from panopticdiffusionmodels_torch.train.trainer import Trainer

# H100 SXM dense peaks (NVIDIA data sheet): bf16 tensor cores, HBM3 bandwidth.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# (B, L, H, D): the serving path's two lengths at batch 2x4, U-ViT-L/2 and U-ViT-H,
# then the training path's two lengths at batch 64.
KERNEL_SHAPES = [(8, 334, 8, 64), (8, 590, 8, 64), (32, 258, 16, 64), (8, 258, 16, 72),
                 (64, 334, 8, 64), (64, 590, 8, 64)]
MAIN_PATH_SHAPES = KERNEL_SHAPES[:2]
TRAIN_SHAPES = KERNEL_SHAPES[4:]
BWD_SHAPES = [(64, 334, 8, 64), (64, 590, 8, 64), (32, 258, 16, 64), (8, 258, 16, 72)]
LAUNCHES_PER_REQUEST = 1300
REQUESTS, PER_REQUEST, STEPS = 3, 4, 50
# Training: batch of the config, 3 warm-up and 20 timed steps; 13 blocks per
# stream, one forward and one backward attention call each per step.
WARMUP_STEPS, TIMED_STEPS, PARITY_BATCH = 3, 20, 16
LAUNCHES_PER_STEP = 26


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
    build.build_all([fqa.NAME, fqa.BWD_NAME])
    print(f"[2] built {fqa.NAME}, {fqa.BWD_NAME} in {time.perf_counter() - t0:.2f} s")
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
        ref, lse_ref = fqa.attention_qkv_plain(qkv, h, scale, with_lse=True)
        out_lse, lse = fqa.fused_attention_qkv(qkv, h, scale, with_lse=True)
        torch.cuda.synchronize()
        assert torch.equal(out, out_lse), ("the lse output changed the forward", b, l, h, d)
        lse_rel = float(((lse - lse_ref).abs() / lse_ref.abs().clamp_min(1e-6)).max())
        assert lse_rel < 1e-4, ("lse", b, l, h, d, lse_rel)
        rel = rel_dev(out, ref)
        max_abs = float((out.float() - ref.float()).abs().max())
        q, k, v = qkv.view(b, l, 3, h, d).permute(2, 0, 3, 1, 4)
        row = dict(
            shape=[b, l, h, d], max_rel_dev=rel, max_abs_err=max_abs, lse_max_rel_dev=lse_rel,
            ms=cuda_ms(lambda: fqa.fused_attention_qkv(qkv, h, scale)),
            lse_ms=cuda_ms(lambda: fqa.fused_attention_qkv(qkv, h, scale, with_lse=True)),
            plain_ms=cuda_ms(lambda: fqa.attention_qkv_plain(qkv, h, scale)),
            library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale)))
        bytes_ms = (b * l * 3 * c + b * l * c) * 2 / PEAK_BYTES * 1e3
        flops_ms = 4 * b * l * l * c / PEAK_BF16_FLOPS * 1e3
        row.update(bound_ms=max(bytes_ms, flops_ms),
                   bound_by="bytes" if bytes_ms >= flops_ms else "operations")
        print(f"[3] B{b} L{l} H{h} D{d}: rel {rel:.2e} max|err| {max_abs:.2e} lse rel "
              f"{lse_rel:.1e} | kernel {row['ms']:.4f} ms (with lse {row['lse_ms']:.4f}), "
              f"plain {row['plain_ms']:.4f} ms, sdpa "
              f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
        assert np.isfinite(rel) and rel < 5e-3, (b, l, h, d, rel)
        rows.append(row)
    # The forward-only kernel would drop the gradient: it must refuse.
    qkv = torch.zeros((2, 18, 48), dtype=torch.bfloat16, device="cuda", requires_grad=True)
    for impl in ("infer", "kernel"):
        try:
            attention_qkv(qkv, 2, impl=impl)
        except RuntimeError as e:
            assert "impl='auto'" in str(e), e
        else:
            raise AssertionError(f"impl={impl!r} on a CUDA tensor that needs grad did not raise")
    print("[3] infer/kernel on a CUDA tensor that requires grad: raises, naming impl='auto'")
    return rows


def phase_backward(gen):
    """The backward kernel against its plain version; SDPA's backward as the
    yardstick (library_ms), on the same inputs in the (B, H, L, D) layout."""
    rows = []
    for b, l, h, d in BWD_SHAPES:
        c = h * d
        qkv = (torch.randn((b, l, 3 * c), generator=gen, device="cuda") * 0.5).to(torch.bfloat16)
        g = torch.randn((b, l, c), generator=gen, device="cuda").to(torch.bfloat16)
        scale = d ** -0.5
        out, lse = fqa.fused_attention_qkv(qkv, h, scale, with_lse=True)
        dqkv = fqa.fused_attention_qkv_vjp(qkv, g, h, scale, out=out, lse=lse)
        ref = fqa.attention_qkv_vjp_plain(qkv, g, h, scale)
        torch.cuda.synchronize()
        rel = rel_dev(dqkv, ref)
        max_abs = float((dqkv.float() - ref.float()).abs().max())
        q, k, v = (t.detach().requires_grad_()
                   for t in qkv.view(b, l, 3, h, d).permute(2, 0, 3, 1, 4))
        o = F.scaled_dot_product_attention(q, k, v, scale=scale)
        go = g.view(b, l, h, d).transpose(1, 2)
        row = dict(
            shape=[b, l, h, d], max_rel_dev=rel, max_abs_err=max_abs,
            ms=cuda_ms(lambda: fqa.fused_attention_qkv_vjp(qkv, g, h, scale, out=out, lse=lse)),
            plain_ms=cuda_ms(lambda: fqa.attention_qkv_vjp_plain(qkv, g, h, scale), iters=5),
            library_ms=cuda_ms(lambda: torch.autograd.grad(o, (q, k, v), go, retain_graph=True)))
        bytes_ms = 14 * b * l * c / PEAK_BYTES * 1e3  # qkv + g read, dqkv written, bf16
        flops_ms = 10 * b * l * l * c / PEAK_BF16_FLOPS * 1e3
        row.update(bound_ms=max(bytes_ms, flops_ms),
                   bound_by="bytes" if bytes_ms >= flops_ms else "operations")
        print(f"[3b] B{b} L{l} H{h} D{d}: dqkv rel {rel:.2e} max|err| {max_abs:.2e} | kernel "
              f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, sdpa backward "
              f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
        assert torch.isfinite(dqkv.float()).all() and np.isfinite(rel) and rel < 5e-3, \
            (b, l, h, d, rel)
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


def device_profile(fn, tag: str, what: str, unprofiled_s: float):
    """fn() under torch.profiler: device time by kernel, and the device's busy
    share of the wall time (the profiler slows the host, so the share is also
    given against the unprofiled time of the same work)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # kernels only: operator rows carry the device time of the kernels they launch
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0),
                  key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    print(f"[{tag}] profiled {what}: wall {wall * 1e3:.1f} ms, device busy {busy_ms:.1f} ms "
          f"in {sum(r[2] for r in rows)} kernels ({busy_ms / (wall * 1e3):.1%} of the "
          f"profiled wall time, {busy_ms / (unprofiled_s * 1e3):.1%} of the unprofiled "
          f"{unprofiled_s * 1e3:.1f} ms)")
    for name, ms, count in rows[:25]:
        print(f"[{tag}] {ms:9.3f} ms {count:6d}x  {name[:110]}")
    return busy_ms


def phase_profile(pipe, contexts, latency):
    """One more request under torch.profiler."""
    device_profile(lambda: pipe.generate(contexts=contexts, steps=STEPS, seed=2), "6",
                   "request", latency)


def write_pretrained(path: str, config) -> None:
    """A reference-format .pth from a seeded model, zero convs opened so the
    mask stream feeds the image stream."""
    kw = dict(config.nnet)
    torch.manual_seed(2)
    model = get_nnet(kw.pop("name"), **kw)
    with torch.no_grad():
        for zc in model.zero_convs.values():
            zc.conv.weight.normal_(0, 0.02)
            zc.conv.bias.normal_(0, 0.02)
    torch.save(model.state_dict(), path)


def grads_vector(trainer) -> torch.Tensor:
    return torch.cat([p.grad.flatten().float() for p in trainer.state.params.values()])


def phase_train_parity(trainer):
    """One step (batch 16) through the kernels and through the plain attention,
    same weights, batch and draws."""
    rng = np.random.default_rng(0)
    moments, context, ids = (np.stack(f) for f in zip(*(
        trainer.dataset.train[i] for i in range(PARITY_BATCH))))
    batch = (moments, context, ids)
    h, w, c2 = moments.shape[1:]
    m = trainer.config.nnet.mask_size
    noise = {"z": rng.standard_normal((PARITY_BATCH, h, w, c2 // 2)).astype(np.float32),
             "n": rng.integers(1, 1001, PARITY_BATCH),
             "eps": rng.standard_normal((PARITY_BATCH, h, w, c2 // 2)).astype(np.float32),
             "eps_m": 2.0 * rng.standard_normal(
                 (PARITY_BATCH, m, m, trainer.config.nnet.mask_bits)).astype(np.float32)}
    out = {}
    for impl in ("auto", "plain"):
        set_attn_impl(trainer.nnet, impl)
        metrics = trainer.loss_and_grads(batch, noise)
        out[impl] = (float(metrics["loss"] + metrics["loss_mask"]), grads_vector(trainer))
    set_attn_impl(trainer.nnet, "auto")
    for p in trainer.state.params.values():
        p.grad = None
    loss_rel = abs(out["auto"][0] - out["plain"][0]) / abs(out["plain"][0])
    grad_rel = rel_dev(out["auto"][1], out["plain"][1])
    print(f"[7] train step B={PARITY_BATCH}, kernels vs plain attention: loss "
          f"{out['auto'][0]:.6f} vs {out['plain'][0]:.6f} (rel {loss_rel:.2e}, bar 5e-3), "
          f"whole gradient rel {grad_rel:.2e} (bar 2e-2)")
    assert np.isfinite(out["auto"][0]) and loss_rel < 5e-3, loss_rel
    assert torch.isfinite(out["auto"][1]).all() and grad_rel < 2e-2, grad_rel


def phase_train(trainer):
    """Trainer.fit: warm-up, then the timed steps with the counters zeroed."""
    bsz = trainer.config.train.batch_size
    frozen = {n: trainer.state.params[n].detach().clone() for n in sorted(trainer.state.frozen)}
    assert frozen, "fine-tune mode froze nothing"
    trainer.fit(max_steps=WARMUP_STEPS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fqa.launches = fqa.bwd_launches = 0
    t0 = time.perf_counter()
    history = trainer.fit(max_steps=WARMUP_STEPS + TIMED_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fwd, bwd = fqa.launches, fqa.bwd_launches
    assert trainer.state.step == WARMUP_STEPS + TIMED_STEPS, trainer.state.step
    assert fwd == bwd == LAUNCHES_PER_STEP * TIMED_STEPS, (fwd, bwd)
    losses = [m["loss"] + m["loss_mask"] for m in history]
    assert losses and np.isfinite(losses).all(), losses
    assert all(torch.isfinite(p).all() for p in trainer.state.params.values())
    assert all(torch.equal(trainer.state.params[n], p) for n, p in frozen.items())
    result = dict(batch=bsz, steps=TIMED_STEPS, wall_s=wall, steps_per_s=TIMED_STEPS / wall,
                  images_per_s=TIMED_STEPS * bsz / wall, step_ms=wall / TIMED_STEPS * 1e3,
                  max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
                  fwd_launches=fwd, bwd_launches=bwd, logged_losses=losses,
                  frozen_params=len(trainer.state.frozen),
                  params=sum(p.numel() for p in trainer.state.params.values()))
    print(f"[8] training: {json.dumps(result)}")
    return fwd, bwd, wall / TIMED_STEPS


def phase_train_profile(trainer, step_s):
    stream = trainer.data_stream(start_step=trainer.state.step)
    batch = next(stream)
    device_profile(lambda: trainer.train_step(batch), "9", "train step (batch 64)", step_s)


def unported_bounds():
    """Computed (not measured) bounds of the TPU kernels still to be ported, at
    the shapes where the JAX package runs them, bf16: max(bytes / 3.35 TB/s,
    operations / 989 TFLOP/s), each input read once, each output written once."""
    def bound(name, shape, nbytes, flops):
        b_ms, f_ms = nbytes / PEAK_BYTES * 1e3, flops / PEAK_BF16_FLOPS * 1e3
        by = "bytes" if b_ms >= f_ms else "operations"
        print(f"[10] bound {name} {shape}: {max(b_ms, f_ms) * 1e3:.1f} us ({by}; "
              f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP) - computed, not measured")

    # attention_hop: one ring hop at the 512-res panoptic local shapes
    # (scripts/bench_ring_hop.py: B8, Lq = Lk = 1063, 8 heads, d 64): q and packed
    # kv in, o (bf16) and the per-head rowmax / denominator (f32) out.
    b, lq, lk, h, c = 8, 1063, 1063, 8, 512
    bound("attention_hop", (b, lq, lk, h, 64), 2 * b * (lq * c + 2 * lk * c + lq * c)
          + 2 * 4 * b * lq * h, 4 * b * lq * lk * c)
    # fused_attention: (B, H, L, D) attention at U-ViT-L/2 (32, 258, 16, 64).
    b, l, h, c = 32, 258, 16, 1024
    bound("fused_attention", (b, h, l, 64), 2 * 4 * b * l * c, 4 * b * l * l * c)
    # fused_ln_qkv_attention: LayerNorm + x W_qkv + attention at U-ViT-L/2
    # (scripts/bench_fused_ln.py: B32, L258, C1024, 16 heads): x, W_qkv and the
    # LayerNorm affine in, the attention output out.
    bound("fused_ln_qkv_attention", (b, l, h, 64), 2 * (b * l * c + 3 * c * c + 2 * c
                                                        + b * l * c),
          2 * b * l * c * 3 * c + 4 * b * l * l * c)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script runs on the "
              "card only", file=sys.stderr)
        return 1
    phase_environment()
    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = phase_kernel(gen)
    bwd_rows = phase_backward(gen)
    phase_forward(gen)
    pipe, contexts, launches, latency = phase_serving()
    phase_profile(pipe, contexts, latency)
    del pipe

    config = get_config("mscoco_uvit_small")
    h, w, c = config.z_shape
    m = config.nnet.mask_size
    config.dataset = d(name="synthetic", n=128, z_shape=(h, w, 2 * c),
                       clip_shape=(config.nnet.num_clip_token, config.nnet.clip_dim),
                       mask_size=m)
    config.train.log_interval = 5
    config.num_workers = 4
    with tempfile.TemporaryDirectory() as tmp:
        config.pretrained = os.path.join(tmp, "mscoco_uvit_small.pth")
        write_pretrained(config.pretrained, config)
        trainer = Trainer(config, os.path.join(tmp, "run"), device="cuda")
        phase_train_parity(trainer)
        fwd_train, bwd_train, step_s = phase_train(trainer)
        phase_train_profile(trainer, step_s)

    main_rows = [r for r in rows if tuple(r["shape"]) in MAIN_PATH_SHAPES]
    per_pair = {k: sum(r[k] for r in main_rows) for k in ("ms", "plain_ms", "bound_ms",
                                                          "library_ms")}
    kernel = dict(
        name="fused_attention_qkv", route="cuda",
        source="panopticdiffusionmodels_torch/ops/kernels/csrc/fused_qkv_attention.cu",
        replaces="panopticdiffusionmodels_tpu/ops/pallas/fused_qkv_attention.py:302",
        launches=launches,
        launches_by_path={"serving (3 requests)": launches,
                          f"training ({TIMED_STEPS} steps)": fwd_train},
        max_abs_err=max(r["max_abs_err"] for r in rows),
        max_rel_dev=max(r["max_rel_dev"] for r in rows),
        kernel_ms=per_pair["ms"], **per_pair,
        bound_by="bytes" if all(r["bound_by"] == "bytes" for r in main_rows) else "operations",
        per="one launch at L=334 plus one at L=590 (B=8, H=8, D=64), the pair each "
            "dual-stream layer runs per NFE",
        shapes=rows)
    train_rows = [r for r in bwd_rows if tuple(r["shape"]) in TRAIN_SHAPES]
    per_step = {k: sum(r[k] for r in train_rows) for k in ("ms", "plain_ms", "bound_ms",
                                                           "library_ms")}
    backward = dict(
        name="fused_attention_qkv_vjp", route="cuda",
        source="panopticdiffusionmodels_torch/ops/kernels/csrc/fused_qkv_attention_bwd.cu",
        replaces="panopticdiffusionmodels_tpu/ops/pallas/fused_qkv_attention.py:226",
        launches=bwd_train,
        launches_by_path={f"training ({TIMED_STEPS} steps)": bwd_train},
        max_abs_err=max(r["max_abs_err"] for r in bwd_rows),
        max_rel_dev=max(r["max_rel_dev"] for r in bwd_rows),
        kernel_ms=per_step["ms"], **per_step,
        bound_by="bytes" if all(r["bound_by"] == "bytes" for r in train_rows) else "operations",
        per="one call at L=334 plus one at L=590 (B=64, H=8, D=64), the pair each "
            "dual-stream layer runs per train step; one call is two CUDA kernels",
        shapes=bwd_rows)
    unported_bounds()
    print(card_line())
    print(json.dumps({"kernels": [kernel, backward]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
