#!/usr/bin/env python3
"""Drive the PyTorch port's serving (panoptic and ImageNet-256
class-conditional, exact and with the sampling speed modes; pixel-space
ImageNet-64 class-conditional and CIFAR-10 unconditional), its bench,
training (panoptic, U-ViT-L/2 latent_discrete and CIFAR-10 pixel_sde),
sequence-parallel training, (B, H, L, D) attention and fused-LayerNorm A/B
paths on one NVIDIA H100 and check their kernels.

    python3 chip_smoke.py    # from the repository root, on a machine with the card

Phases (any failure exits non-zero; without a CUDA card it exits 1 at once):
  1. environment: card name and power limit, torch / CUDA / nvcc versions;
  2. build: every hand-written kernel of the paths, from `csrc/`, with nvcc
     (one process per source, all at once), with ptxas' registers, spills,
     shared memory and wgmma warnings per kernel (named with its template
     arguments), and the dynamic shared memory of the wgmma attention loop,
     the wgmma backward kernels and the LN-prologue GEMM;
  3. the forward kernel vs its plain PyTorch version in bf16 at the serving
     and training shapes, the pixel-space ones among them (U-ViT-M/4 at
     (64, 258, 12, 64), U-ViT-S/2 at (32, 257, 8, 64) and, with lse, at
     (128, 257, 8, 64)) (relative deviation < 5e-3, and where L is not a
     whole number of 64-row tiles the tail rows on their own: < 5e-3, lse
     < 1e-4), each shape with the loop it took (wgmma + TMA for head dim 64, mma.sync for the others);
     timed in turns with `scaled_dot_product_attention`, its yardstick
     (library, kernel, kernel, library, 5 times: medians and spreads), and
     beside the plain version; the forward with its lse output is
     bit-identical to the forward without it and its lse is within 1e-4
     relative of the plain one; `attn_impl='infer'` on a CUDA tensor that
     needs a gradient raises;
     3b. the backward kernel vs `attention_qkv_vjp_plain` and vs
     `attention_qkv_vjp_lse_plain` (its own decomposition) at the training
     shapes (panoptic, U-ViT-L/2 at batch 64 and U-ViT-S/2 at (128, 257, 8,
     64)), U-ViT-L/2 / U-ViT-H and two ragged short L (relative deviation
     of dqkv < 5e-3 against each, the tail rows past the last whole tile
     < 5e-3 on their own), each shape with the loop it took (wgmma +
     TMA for head dim 64, mma.sync for the others); two calls bit-identical
     (no atomics); timed in turns with SDPA's backward, and both again with
     the L2 flushed (64 MB) before every launch; beside the plain version;
     3c. the ring-hop kernel vs `attention_hop_plain` at the 512-res and
     256-res sp=2 shard shapes, one Lq != Lk shard pair and the TPU verify
     shapes, nvalid = Lk, Lk - 64, 0 and a per-row mix, q a strided view of
     the packed qkv (max of the relative deviations of o, m and den < 5e-3),
     each shape with its loop; timed in turns with flash SDPA and beside the
     plain version;
     3d. the (B, H, L, D) kernel `fused_attention` vs `attention_plain` at
     U-ViT-L/2 (32, 16, 258, 64), the U-ViT-H and UNet head dims and one
     L > 1024, contiguous and as transposed views (relative deviation
     < 5e-3), each with its loop, timed in turns with SDPA and beside the
     plain version; then
     `multi_head_attention(impl='pallas')` forward + backward at U-ViT-L/2,
     one kernel launch, gradient vs the all-plain one < 2e-2;
     3e. `fused_ln_qkv_attention` (LN-prologue qkv GEMM + attention) vs its
     plain version at the A/B chain's shapes, L = 1024 and a ragged small L
     (relative deviation < 5e-3), timed in turns with F.layer_norm +
     torch.matmul + SDPA and beside the plain version; its GEMM half
     `ln_qkv_gemm` alone vs `ln_qkv_gemm_plain` (< 5e-3), timed in turns with
     F.layer_norm + torch.matmul, beside its operations bound, with the
     profiler's split of its device time between the statistics pass and
     the GEMM;
     3f. the full-width A/B chain (20 U-ViT-L/2 blocks) through
     `scripts/bench_fused_ln.main` at B = 32 and 64: ms per forward of each
     arm, fused vs shipped < 2e-2, exactly 20 kernel-5 launches (and 20
     `ln_qkv_gemm` calls) per fused forward and 20 kernel-1 launches per
     shipped forward;
  4. the full-width UViTT2I forward (mscoco_uvit_small, B=8) with the kernel
     against the same weights with the plain attention (relative deviation
     < 2e-2 on noise and mask);
     4b. the 512-res UViTT2I (mscoco_uvit_small_512, B=8) at sp=2 in-process
     through the ring against the same weights at sp=1 through the forward
     kernel at L = 1102 / 2126 (relative deviation < 2e-2, 52 hop launches);
  5. serving: GenerationPipeline.from_config("mscoco_uvit_small"), seeded
     random weights, bf16; a 6-step request through the kernel against the
     same request through the plain attention (relative deviation < 2e-2 on
     images, < 5e-2 on the mask prediction); then it answers 3 requests of 4
     CLIP contexts at 50 steps
     through generate_batches; the kernel's launch counter must rise by
     exactly 1300 per request (13 blocks x 2 streams x 50 NFE); the host
     cost of kernel 1's per-launch tensor-map encode for one request;
  6. one more request under torch.profiler: device time by kernel and the
     device's busy share of the request;
     6a. panoptic speed modes: the same pipeline with sample.accel = 0.2 and
     sample.cfg_interval = (0.5, 1.0) with the mask-guidance hold (guidance
     on the early steps); a 20-step request (15 real evals: 5 forecast
     steps) through the kernel against the plain attention (images < 2e-2,
     masks < 5e-2), then one 50-step request
     with exactly (real evals) x 26 kernel-1 launches, printing the guided
     (2x4) and cond-only (4) batch shapes kernel 1 saw;
     6b. ImageNet-256 serving: GenerationPipeline.from_config(
     "imagenet256_uvit_large"), seeded random weights, bf16 network, f32 VAE;
     a 6-step request of 32 labels through the kernel against the plain
     attention (images < 2e-2); then 1 warm-up and 3 requests of 32 labels
     at 50 steps, CFG 0.4: latency, images/s, peak memory, exactly 1050
     kernel-1 launches a request (21 blocks x 50 NFE, CFG as one 2x batch);
     6c. one more ImageNet-256 request under torch.profiler;
     6d. the recommended mode (tanh GELU on the same weights, sample.accel =
     0.2): a 50-step request of 32 labels through the kernel against the
     plain attention on the same draws (images < 2e-2), 20 real evals (the
     JAX plan's count, held in tests/test_torch_port_speed_modes.py) and
     exactly 20 x 21 kernel-1 launches a request; 1 warm-up and 3 timed
     requests beside phase 6b's;
     6e. the port's bench, `scripts/bench.main` at BENCH_BATCH = 32 and
     BENCH_REPS = 3 (exact protocol and recommended mode, each through
     `GenerationPipeline.sample` with a bf16 VAE decode, and the JAX
     package's gate verdict): its JSON line, exactly 4 x 21 x (50 + 20)
     kernel-1 launches;
     6f. ImageNet-64 pixel-space serving: GenerationPipeline.from_config(
     "imagenet64_uvit_mid") (U-ViT-M/4, 17 blocks, 12 heads, L = 258),
     seeded random weights, bf16 network, the config's protocol (continuous
     DPM-Solver fast_upstream, noise prediction, 50 evals, no CFG, no VAE);
     a 10-step request of 64 labels through the kernel against the plain
     attention (images < 2e-2); 1 warm-up and 3 requests of 64 labels at 50
     steps: latency, images/s, peak memory, exactly 850 kernel-1 launches a
     request; one request under torch.profiler;
     6g. CIFAR-10 pixel-space serving: GenerationPipeline.from_config(
     "cifar10_uvit_small") (U-ViT-S/2, 13 blocks, L = 257, unconditional),
     1000-step Euler-Maruyama on the reverse SDE; a 20-step request of 32
     through the kernel against the plain attention on the same draws and
     step noise (images < 2e-2); after a 10-step warm-up, one timed request
     of 32 at 1000 steps with exactly 13,000 kernel-1 launches; the device's
     idle share from a 100-step request under torch.profiler beside the
     same request without it;
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
 11. sequence-parallel training: `Trainer` for mscoco_uvit_small_512 at full
     width and depth, mesh.sp = 2 with sp_mode 'in_process' (both shards on
     the one card, folded into the batch), fine-tune mode, synthetic data at
     the config's shapes; one step (batch 8) through the hop kernels against
     the same step through `attention_hop_plain` (loss < 5e-3, whole
     gradient < 2e-2);
 12. `Trainer.fit` at sp=2: 3 warm-up and 20 timed steps at batch 8: steps/s,
     images/s, peak memory, finite losses, exactly 52 hop launches a step
     and none of the other kernels;
 13. one more sp step under torch.profiler;
 14. latent_discrete training: `Trainer` for imagenet256_uvit_large
     (U-ViT-L/2, full width and depth, use_checkpoint with save_attn, bf16
     autocast over f32 master weights, AdamW + EMA) on synthetic latent
     moments (32, 32, 8) with labels dropped to the null class 1000 at
     p_uncond 0.15; one step (batch 16) through the kernels against the
     plain attention (loss < 5e-3, whole gradient < 2e-2);
 15. `Trainer.fit`: 3 warm-up and 20 timed steps at batch 64, exactly 21
     forward and 21 backward kernel calls a step;
 16. one more U-ViT-L/2 step under torch.profiler;
 17. pixel_sde training: `Trainer` for cifar10_uvit_small (U-ViT-S/2, full
     width and depth, unconditional, bf16 autocast over f32 master weights,
     AdamW + EMA) at the config's batch of 128 on synthetic pixels from a
     numpy seed; one step through the kernels against the plain attention
     (loss < 5e-3, whole gradient < 2e-2);
 18. `Trainer.fit`: 3 warm-up and 20 timed steps at batch 128, exactly 13
     forward and 13 backward kernel calls a step;
 19. one more CIFAR-10 step under torch.profiler;
 20. prints the bench's JSON line, the card line, the `kernels` JSON line
     (all five kernels) and, last, the ok line.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from panopticdiffusionmodels_torch.configs import get_config
from panopticdiffusionmodels_torch.configs.base import d
from panopticdiffusionmodels_torch.data.datasets import CFGLabelDataset
from panopticdiffusionmodels_torch.models import get_nnet
from panopticdiffusionmodels_torch.models.layers import Attention, with_gelu
from panopticdiffusionmodels_torch.ops.attention import attention_qkv, multi_head_attention
from panopticdiffusionmodels_torch.ops.kernels import build
from panopticdiffusionmodels_torch.ops.kernels import fused_attention as fa
from panopticdiffusionmodels_torch.ops.kernels import fused_ln_qkv_attention as fl
from panopticdiffusionmodels_torch.ops.kernels import fused_qkv_attention as fqa
from panopticdiffusionmodels_torch.ops.kernels import ring_hop
from panopticdiffusionmodels_torch.parallel.mesh import InProcessSP
from panopticdiffusionmodels_torch.scripts import bench, bench_fused_ln
from panopticdiffusionmodels_torch.serving import GenerationPipeline
from panopticdiffusionmodels_torch.train.trainer import Trainer

# H100 SXM dense peaks (NVIDIA data sheet): bf16 tensor cores, HBM3 bandwidth.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# (B, L, H, D): the serving path's two lengths at batch 2x4, U-ViT-L/2 and U-ViT-H,
# the training path's two lengths at batch 64, and ImageNet-256 serving
# (U-ViT-L/2, CFG 2x32).
# The pixel-space slice: U-ViT-M/4 ImageNet-64 serving (64 labels, 12 heads,
# L = 2 + 256), U-ViT-S/2 CIFAR-10 serving (32 images, L = 1 + 256, one row
# past 4 x 64) and its training at batch 128 (with lse).
KERNEL_SHAPES = [(8, 334, 8, 64), (8, 590, 8, 64), (32, 258, 16, 64), (8, 258, 16, 72),
                 (64, 334, 8, 64), (64, 590, 8, 64), (64, 258, 16, 64),
                 (64, 258, 12, 64), (32, 257, 8, 64), (128, 257, 8, 64)]
MAIN_PATH_SHAPES = KERNEL_SHAPES[:2]
TRAIN_SHAPES = KERNEL_SHAPES[4:6]
IMAGENET_SHAPE = KERNEL_SHAPES[6]
PIXEL_SHAPES = KERNEL_SHAPES[7:]
# Backward: the training shapes, U-ViT-L/2 and U-ViT-H, and two ragged short
# L (one partial tile; one row past a tile).
BWD_SHAPES = [(64, 334, 8, 64), (64, 590, 8, 64), (32, 258, 16, 64), (8, 258, 16, 72),
              (2, 37, 8, 64), (2, 65, 8, 64), (64, 258, 16, 64), (128, 257, 8, 64)]
# U-ViT-L/2 latent_discrete training at batch 64: the lse forward (phase 3's
# row IMAGENET_SHAPE) and the backward at this shape; CIFAR-10 pixel_sde
# training at batch 128 (phase 3's last row with lse, and the backward).
LATENT_TRAIN_SHAPE = BWD_SHAPES[6]
CIFAR_TRAIN_SHAPE = BWD_SHAPES[7]
TILE_ROWS = 64  # the kernels' row tile: rows past the last whole tile are the tail
LAUNCHES_PER_REQUEST = 1300
REQUESTS, PER_REQUEST, STEPS = 3, 4, 50
# Training: batch of the config, 3 warm-up and 20 timed steps; 13 blocks per
# stream, one forward and one backward attention call each per step.
WARMUP_STEPS, TIMED_STEPS, PARITY_BATCH = 3, 20, 16
LAUNCHES_PER_STEP = 26
# Ring hops (B, Lq, Lk), 8 heads of 64: the 512-res shards at sp=2 and the
# config's batch 8 folded to 16 rows (mask stream 1063, image stream 551),
# the 256-res shards (295, 167), the TPU verify shapes
# (scripts/verify_kernel_tpu.py:189-190) at B=2, and one hop whose query and
# key shards differ in length.
HOP_SHAPES = [(16, 1063, 1063), (16, 551, 551), (16, 295, 295), (16, 167, 167),
              (2, 1063, 1063), (2, 1064, 1064), (2, 258, 258), (2, 295, 167)]
HOP_MAIN_SHAPES = HOP_SHAPES[:2]
HOP_HEADS, HOP_DIM = 8, 64
# Sequence-parallel training of mscoco_uvit_small_512 at sp = 2, in-process:
# 13 + 13 ring attentions a step, 2 hops each, one hop launch per hop over
# the folded batch.
SP, SP_BATCH = 2, 8
HOP_LAUNCHES_PER_STEP = 52
# (B, H, L, D) attention: U-ViT-L/2 at ImageNet-256 (B=32), the U-ViT-H head
# dim, the UNet head dim and one L past the JAX function's MAX_FULL_SEQ.
MHA_SHAPES = [(32, 16, 258, 64), (8, 16, 258, 72), (8, 8, 256, 40), (2, 8, 1100, 64)]
# (B, L, C, heads) of LayerNorm + qkv + attention: the A/B chain's two
# batches, the longest L of the whole-sequence path, and a ragged small L.
LN_SHAPES = [(32, 258, 1024, 16), (64, 258, 1024, 16), (4, 1024, 1024, 16), (2, 37, 256, 4)]
CHAIN_BATCHES = (32, 64)
# ImageNet-256 class-conditional serving (imagenet256_uvit_large): requests of
# 32 labels, 21 blocks x 50 NFE kernel-1 launches a request (CFG as one 2x
# batch of 64).
IMAGENET_LABELS, IMAGENET_LAUNCHES = 32, 21 * STEPS
UVIT_L_BLOCKS, UVIT_T2I_BLOCKS = 21, 26
# Speed modes.  The recommended ImageNet-256 mode (tanh GELU, accel 0.2) runs
# 20 real evals of 50 (the JAX plan's count); the panoptic request guides the
# early steps, t in [0.5, 1.0], with the mask-guidance hold.
RECOMMENDED_EVALS = 20
PANOPTIC_KNOBS = dict(accel=0.2, cfg_interval=(0.5, 1.0), cfg_interval_mask_hold=True)
# The panoptic kernel-vs-plain pair runs 20 steps, where these knobs forecast
# 5 of them (15 real evals): the forecast of the held mask lies inside the
# compared trajectory.  At 6 steps nothing is skipped.
PANOPTIC_COMPARE_STEPS = 20
# The port's bench: BENCH_BATCH 32, BENCH_REPS 3; 1 warm-up + 3 timed runs of
# the exact protocol (50 evals) and of the recommended mode (20).
BENCH_ENV = dict(BENCH_BATCH="32", BENCH_REPS="3")
BENCH_LAUNCHES = (1 + 3) * UVIT_L_BLOCKS * (STEPS + RECOMMENDED_EVALS)
# U-ViT-L/2 latent_discrete training: batch 64, labels dropped at 0.15.
LATENT_BATCH, P_UNCOND = 64, 0.15
# ImageNet-64 (imagenet64_uvit_mid, U-ViT-M/4, 17 blocks): requests of 64
# labels, the continuous DPM-Solver's 50 evals ([3] x 16 + [2]) of 17
# kernel-1 launches; the kernel-vs-plain pair at 10 steps.
IMAGENET64_LABELS, IMAGENET64_BLOCKS, IMAGENET64_COMPARE_STEPS = 64, 17, 10
# CIFAR-10 (cifar10_uvit_small, U-ViT-S/2, 13 blocks): a request of 32
# images by 1000 Euler-Maruyama steps, 13 kernel-1 launches each; the
# kernel-vs-plain pair at 20 steps; the device's idle share from a profiled
# 100-step request; pixel_sde training at the config's batch of 128.
CIFAR_IMAGES, CIFAR_BLOCKS, CIFAR_STEPS = 32, 13, 1000
CIFAR_WARMUP_STEPS, CIFAR_COMPARE_STEPS, CIFAR_PROFILE_STEPS = 10, 20, 100
CIFAR_BATCH = 128


def zero_counts() -> None:
    fqa.launches = fqa.bwd_launches = ring_hop.launches = fa.launches = fl.launches = 0
    fl.gemm_launches = 0


def read_counts() -> dict:
    return {"fused_attention_qkv": fqa.launches, "fused_attention_qkv_vjp": fqa.bwd_launches,
            "attention_hop": ring_hop.launches, "fused_attention": fa.launches,
            "fused_ln_qkv_attention": fl.launches, "ln_qkv_gemm": fl.gemm_launches}


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


def alternate(kernel, library, repeats: int = 5, iters: int = 20) -> dict:
    """The kernel and its library call timed in turns (library, kernel,
    kernel, library) `repeats` times, `cuda_ms` each: medians and (min, max)
    spreads, so that the two share the card's state."""
    ks, ls = [], []
    for _ in range(repeats):
        ls.append(cuda_ms(library, iters))
        ks.append(cuda_ms(kernel, iters))
        ks.append(cuda_ms(kernel, iters))
        ls.append(cuda_ms(library, iters))
    return dict(ms=float(np.median(ks)), ms_spread=[min(ks), max(ks)],
                library_ms=float(np.median(ls)), library_ms_spread=[min(ls), max(ls)])


def cold_ms(fn, iters: int = 10) -> float:
    """Mean device time of fn() with the 50 MB L2 flushed before each launch
    (a 64 MB buffer zeroed between launches), CUDA events around each."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    fn()
    events = []
    for _ in range(iters):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in events) / iters


def rel_dev(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def tail_rel_dev(a: torch.Tensor, b: torch.Tensor, l: int, dim: int = 1):
    """rel_dev over the rows past the last whole tile of TILE_ROWS along
    `dim` (None when L is a whole number of tiles)."""
    tail = l % TILE_ROWS
    if not tail:
        return None
    return rel_dev(a.narrow(dim, l - tail, tail), b.narrow(dim, l - tail, tail))


def fmt_spread(spread) -> str:
    return f"[{spread[0]:.4f}-{spread[1]:.4f}]"


def bound(nbytes: float, flops: float):
    """max(bytes / peak bandwidth, operations / peak bf16 rate) in ms, and
    which of the two it is."""
    bytes_ms, flops_ms = nbytes / PEAK_BYTES * 1e3, flops / PEAK_BF16_FLOPS * 1e3
    return max(bytes_ms, flops_ms), "bytes" if bytes_ms >= flops_ms else "operations"


def phase_environment():
    nvcc = subprocess.run([build.nvcc_path(), "--version"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[-1]
    print(f"[1] card: {card_line()} | torch {torch.__version__} | CUDA {torch.version.cuda}"
          f" | nvcc: {nvcc} | devices {torch.cuda.device_count()}")


def kernel_name(mangled: str) -> str:
    """A ptxas entry name without its namespaces and parameter types, with its
    integer and bool template arguments: `dkv_kernel<64>`,
    `attention_tma_kernel<3, 1>`."""
    rest, parts = mangled[3:] if mangled.startswith("_ZN") else mangled[2:], []
    while rest[:1].isdigit():
        n = len(rest) - len(rest.lstrip("0123456789"))
        size = int(rest[:n])
        parts.append(rest[n:n + size])
        rest = rest[n + size:]
    if not parts:
        return mangled[:72]
    args = re.match(r"I((?:L[ib]\d+E)+)E", rest)
    if not args:
        return parts[-1]
    values = re.findall(r"L[ib](\d+)E", args.group(1))
    return f"{parts[-1]}<{', '.join(values)}>"


def phase_build():
    t0 = time.perf_counter()
    build.build_all(build.KERNELS)
    print(f"[2] built {', '.join(build.KERNELS)} in {time.perf_counter() - t0:.2f} s")
    for name, (secs, log) in build.BUILD_LOG.items():
        kernel = "?"
        for line in log.splitlines():
            if "Compiling entry function" in line:
                kernel = kernel_name(line.split("'")[1])
            elif "registers" in line or "spill" in line or "C75" in line:
                print(f"    {name} [{kernel}]: {line.strip()}")
    bwd = fqa.attention_bwd_tma_smem_bytes()
    print(f"[2] dynamic shared memory a CTA: attention wgmma loop "
          f"{fqa.attention_tma_smem_bytes()} B (2 CTAs an SM; the hop's too), backward "
          f"dq_tma_kernel {bwd['dq_tma_kernel']} B, dkv_tma_kernel "
          f"{bwd['dkv_tma_kernel']} B (1 CTA an SM each), LN-prologue GEMM "
          f"{fl.gemm_smem_bytes()} B (1 CTA an SM)")


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
        # the rows past the last whole tile, on their own
        tail_rel = tail_rel_dev(out, ref, l)
        tail_lse = (None if tail_rel is None else
                    float(((lse - lse_ref).abs() / lse_ref.abs().clamp_min(1e-6))[..., -(l % 64):]
                          .max()))
        q, k, v = qkv.view(b, l, 3, h, d).permute(2, 0, 3, 1, 4)
        sdpa = lambda: F.scaled_dot_product_attention(q, k, v, scale=scale)  # noqa: E731
        row = dict(
            shape=[b, l, h, d], loop=fqa.attention_loop(d), max_rel_dev=rel,
            max_abs_err=max_abs, lse_max_rel_dev=lse_rel, tail_rel_dev=tail_rel,
            tail_lse_max_rel_dev=tail_lse,
            **alternate(lambda: fqa.fused_attention_qkv(qkv, h, scale), sdpa),
            plain_ms=cuda_ms(lambda: fqa.attention_qkv_plain(qkv, h, scale)))
        lse_times = alternate(lambda: fqa.fused_attention_qkv(qkv, h, scale, with_lse=True), sdpa)
        row.update(lse_ms=lse_times["ms"], lse_ms_spread=lse_times["ms_spread"])
        row["bound_ms"], row["bound_by"] = bound((b * l * 3 * c + b * l * c) * 2,
                                                 4 * b * l * l * c)
        # with lse: its (B, H, L) f32 written too
        row["lse_bound_ms"] = bound((b * l * 3 * c + b * l * c) * 2 + 4 * b * h * l,
                                    4 * b * l * l * c)[0]
        tail = ("" if tail_rel is None else
                f" tail ({l % 64} rows) rel {tail_rel:.2e} lse {tail_lse:.1e}")
        print(f"[3] B{b} L{l} H{h} D{d} ({row['loop']} loop): rel {rel:.2e} max|err| "
              f"{max_abs:.2e} lse rel {lse_rel:.1e}{tail} | kernel {row['ms']:.4f} ms "
              f"{fmt_spread(row['ms_spread'])} (with lse {row['lse_ms']:.4f} "
              f"{fmt_spread(row['lse_ms_spread'])}), plain {row['plain_ms']:.4f} ms, sdpa "
              f"{row['library_ms']:.4f} ms {fmt_spread(row['library_ms_spread'])} (kernel/sdpa "
              f"{row['ms'] / row['library_ms']:.2f}, with lse "
              f"{row['lse_ms'] / row['library_ms']:.2f}), bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']})")
        assert np.isfinite(rel) and rel < 5e-3, (b, l, h, d, rel)
        assert tail_rel is None or (tail_rel < 5e-3 and tail_lse < 1e-4), (b, l, h, d, tail_rel,
                                                                          tail_lse)
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
        again = fqa.fused_attention_qkv_vjp(qkv, g, h, scale, out=out, lse=lse)
        ref = fqa.attention_qkv_vjp_plain(qkv, g, h, scale)
        ref_lse = fqa.attention_qkv_vjp_lse_plain(qkv, g, out, lse, h, scale)
        torch.cuda.synchronize()
        assert torch.equal(dqkv, again), ("two calls differ", b, l, h, d)
        rel = rel_dev(dqkv, ref)
        rel_lse = rel_dev(dqkv, ref_lse)
        tail_rel = tail_rel_dev(dqkv, ref, l)  # the rows past the last whole tile
        max_abs = float((dqkv.float() - ref.float()).abs().max())
        q, k, v = (t.detach().requires_grad_()
                   for t in qkv.view(b, l, 3, h, d).permute(2, 0, 3, 1, 4))
        o = F.scaled_dot_product_attention(q, k, v, scale=scale)
        go = g.view(b, l, h, d).transpose(1, 2)
        kernel = lambda: fqa.fused_attention_qkv_vjp(qkv, g, h, scale, out=out, lse=lse)  # noqa
        library = lambda: torch.autograd.grad(o, (q, k, v), go, retain_graph=True)  # noqa: E731
        row = dict(
            shape=[b, l, h, d], loop=fqa.attention_bwd_loop(d), max_rel_dev=rel,
            max_rel_dev_lse_plain=rel_lse, tail_rel_dev=tail_rel, max_abs_err=max_abs,
            bit_identical=True,
            **alternate(kernel, library),
            plain_ms=cuda_ms(lambda: fqa.attention_qkv_vjp_plain(qkv, g, h, scale), iters=5),
            cold_ms=cold_ms(kernel), library_cold_ms=cold_ms(library))
        # qkv + g read, dqkv written, bf16
        row["bound_ms"], row["bound_by"] = bound(14 * b * l * c, 10 * b * l * l * c)
        tail = "" if tail_rel is None else f", tail ({l % 64} rows) rel {tail_rel:.2e}"
        print(f"[3b] B{b} L{l} H{h} D{d} ({row['loop']} loop): dqkv rel {rel:.2e} (vs its "
              f"decomposition {rel_lse:.2e}){tail} max|err| {max_abs:.2e}, two calls "
              f"bit-identical | "
              f"kernel {row['ms']:.4f} ms {fmt_spread(row['ms_spread'])}, plain {row['plain_ms']:.4f} "
              f"ms, sdpa backward {row['library_ms']:.4f} ms "
              f"{fmt_spread(row['library_ms_spread'])} (kernel/sdpa "
              f"{row['ms'] / row['library_ms']:.2f}); cold L2: kernel {row['cold_ms']:.4f} ms, "
              f"sdpa backward {row['library_cold_ms']:.4f} ms (kernel/sdpa "
              f"{row['cold_ms'] / row['library_cold_ms']:.2f}); bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']})")
        assert torch.isfinite(dqkv.float()).all() and np.isfinite(rel) and rel < 5e-3 \
            and rel_lse < 5e-3, (b, l, h, d, rel, rel_lse)
        assert tail_rel is None or tail_rel < 5e-3, (b, l, h, d, tail_rel)
        rows.append(row)
    return rows


def hop_bound(b, lq, lk, c, h):
    """q and packed kv read once (bf16), o (bf16), m and den (f32) and nvalid
    written / read once; 4*B*Lq*Lk*C operations (every key of the hop is
    scored, padding too)."""
    return bound(2 * b * (lq * c + 2 * lk * c + lq * c) + 2 * 4 * b * lq * h + 4 * b,
                 4 * b * lq * lk * c)


def phase_hop(gen):
    """The ring-hop kernel against `attention_hop_plain` in bf16: q always a
    strided view of a packed qkv (as the ring passes it), kv a contiguous
    rotated shard and, where Lq = Lk, also the hop-0 view of the packed qkv;
    nvalid = Lk, Lk - 64, 0 for every row (0: an all-padding hop) and a
    mix of the three over the rows.  Bar: max(rel o, rel m, rel den) < 5e-3.
    Timed at nvalid = Lk in turns with flash SDPA, whose (out, lse) is the
    same partial with den = 1, and beside the plain version."""
    rows = []
    h, d = HOP_HEADS, HOP_DIM
    c, scale = h * d, d ** -0.5
    for b, lq, lk in HOP_SHAPES:
        qkv = (torch.randn((b, lq, 3 * c), generator=gen, device="cuda") * 0.5).to(torch.bfloat16)
        q = qkv[..., :c]
        kv = (torch.randn((b, lk, 2 * c), generator=gen, device="cuda") * 0.5).to(torch.bfloat16)
        kvs = {"rotated": kv, "hop0 view": qkv[..., c:]} if lq == lk else {"rotated": kv}
        cases = {str(nv): torch.full((b,), nv, dtype=torch.int32, device="cuda")
                 for nv in sorted({lk, lk - 64, 0, 1000 if lk == 1064 else 0}, reverse=True)}
        cases["mixed"] = torch.tensor([(lk, lk - 64, 0)[i % 3] for i in range(b)],
                                      dtype=torch.int32, device="cuda")
        worst = dict(rel=0.0, max_abs_err=0.0)
        for kv_name, kv_in in kvs.items():
            for nv_name, nvalid in cases.items():
                got = ring_hop.attention_hop(q, kv_in, h, scale, nvalid)
                ref = ring_hop.attention_hop_plain(q, kv_in, h, scale, nvalid)
                torch.cuda.synchronize()
                rels = [rel_dev(a, r) for a, r in zip(got, ref)]
                abs_err = max(float((a.float() - r.float()).abs().max()) for a, r in zip(got, ref))
                ok = all(torch.isfinite(a.float()).all() for a in got) and max(rels) < 5e-3
                print(f"[3c] B{b} Lq{lq} Lk{lk} kv {kv_name} nvalid {nv_name}: rel o/m/den "
                      f"{rels[0]:.2e}/{rels[1]:.2e}/{rels[2]:.2e} max|err| {abs_err:.2e}")
                assert ok, (b, lq, lk, kv_name, nv_name, rels)
                worst = dict(rel=max(worst["rel"], *rels),
                             max_abs_err=max(worst["max_abs_err"], abs_err))
        row = dict(shape=[b, lq, lk, h, d], loop=ring_hop.hop_loop(d), max_rel_dev=worst["rel"],
                   max_abs_err=worst["max_abs_err"])
        print(f"[3c] B{b} Lq{lq} Lk{lk} H{h} D{d}: {row['loop']} loop")
        if (b, lq, lk) in HOP_MAIN_SHAPES:
            full = torch.full((b,), lk, dtype=torch.int32, device="cuda")
            qh, kh, vh = (t.reshape(b, -1, h, d).transpose(1, 2).contiguous()
                          for t in (q, kv[..., :c], kv[..., c:]))
            flash = torch.ops.aten._scaled_dot_product_flash_attention
            row.update(
                **alternate(lambda: ring_hop.attention_hop(q, kv, h, scale, full),
                            lambda: flash(qh, kh, vh, 0.0, False, False, scale=scale)),
                plain_ms=cuda_ms(lambda: ring_hop.attention_hop_plain(q, kv, h, scale, full),
                                 iters=5))
            row["bound_ms"], row["bound_by"] = hop_bound(b, lq, lk, c, h)
            print(f"[3c] B{b} Lq{lq} Lk{lk}: kernel {row['ms']:.4f} ms "
                  f"{fmt_spread(row['ms_spread'])}, plain {row['plain_ms']:.4f} ms, flash sdpa "
                  f"{row['library_ms']:.4f} ms {fmt_spread(row['library_ms_spread'])} "
                  f"(kernel/flash {row['ms'] / row['library_ms']:.2f}), bound "
                  f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
        rows.append(row)
    return rows


def phase_mha(gen):
    """Kernel 4, `fused_attention` over (B, H, L, D), against
    `attention_plain` in bf16 (relative deviation < 5e-3): contiguous q, k, v
    and the transposed views of a packed (B, L, 3, H, D) projection; timed
    beside the plain version and SDPA.  Then the trainable entry
    `multi_head_attention(impl='pallas')` (kernel forward + plain recompute
    backward) at U-ViT-L/2: its forward against `attention_plain` < 5e-3 and
    its gradient against the all-plain one (autograd through
    `attention_plain`): dq, dk, dv < 2e-2; the kernel's counter is zeroed
    just before and read just after."""
    rows = []
    for b, h, l, d in MHA_SHAPES:
        packed = (torch.randn((b, l, 3, h, d), generator=gen, device="cuda") * 0.5
                  ).to(torch.bfloat16)
        views = packed.permute(2, 0, 3, 1, 4)  # q, k, v (B, H, L, D), strided
        q, k, v = (t.contiguous() for t in views)
        scale = d ** -0.5
        ref = fa.attention_plain(q, k, v, scale)
        outs = {"contiguous": fa.fused_attention(q, k, v, scale),
                "strided": fa.fused_attention(*views, scale)}
        torch.cuda.synchronize()
        rels = {name: rel_dev(o, ref) for name, o in outs.items()}
        max_abs = max(float((o.float() - ref.float()).abs().max()) for o in outs.values())
        row = dict(shape=[b, h, l, d], loop=fqa.attention_loop(d, fa.NAME),
                   max_rel_dev=max(rels.values()), max_abs_err=max_abs,
                   **alternate(lambda: fa.fused_attention(q, k, v, scale),
                               lambda: F.scaled_dot_product_attention(q, k, v, scale=scale)),
                   plain_ms=cuda_ms(lambda: fa.attention_plain(q, k, v, scale), iters=5))
        row["bound_ms"], row["bound_by"] = bound(8 * b * h * l * d, 4 * b * h * l * l * d)
        print(f"[3d] B{b} H{h} L{l} D{d} ({row['loop']} loop): rel contiguous "
              f"{rels['contiguous']:.2e} strided {rels['strided']:.2e} max|err| {max_abs:.2e} | "
              f"kernel {row['ms']:.4f} ms {fmt_spread(row['ms_spread'])}, plain "
              f"{row['plain_ms']:.4f} ms, sdpa {row['library_ms']:.4f} ms "
              f"{fmt_spread(row['library_ms_spread'])} (kernel/sdpa "
              f"{row['ms'] / row['library_ms']:.2f}), bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']})")
        assert all(torch.isfinite(o.float()).all() for o in outs.values()), (b, h, l, d)
        assert max(rels.values()) < 5e-3, (b, h, l, d, rels)
        rows.append(row)

    b, h, l, d = MHA_SHAPES[0]
    q, k, v = ((torch.randn((b, h, l, d), generator=gen, device="cuda") * 0.5)
               .to(torch.bfloat16).requires_grad_() for _ in range(3))
    g = torch.randn((b, h, l, d), generator=gen, device="cuda").to(torch.bfloat16)
    zero_counts()
    out = multi_head_attention(q, k, v, impl="pallas")
    grads = torch.autograd.grad(out, (q, k, v), g)
    torch.cuda.synchronize()
    launches = read_counts()["fused_attention"]
    assert launches == 1, launches
    ref = torch.autograd.grad(fa.attention_plain(q, k, v, d ** -0.5), (q, k, v), g)
    grad_rels = [rel_dev(a, r) for a, r in zip(grads, ref)]
    with torch.no_grad():
        fwd_rel = rel_dev(out, fa.attention_plain(q, k, v, d ** -0.5))
    print(f"[3d] multi_head_attention(impl='pallas') B{b} H{h} L{l} D{d}: forward rel "
          f"{fwd_rel:.2e} (bar 5e-3), gradient vs all-plain "
          f"dq {grad_rels[0]:.2e} dk {grad_rels[1]:.2e} dv {grad_rels[2]:.2e} (bar 2e-2), "
          f"{launches} kernel launch")
    assert torch.isfinite(out.float()).all() and fwd_rel < 5e-3, fwd_rel
    assert all(torch.isfinite(t.float()).all() for t in grads) and max(grad_rels) < 2e-2, \
        grad_rels
    return rows, launches


def gemm_device_split(x2d, gamma, beta, w, calls: int = 10) -> dict:
    """Device ms a call of the two kernels of `ln_qkv_gemm`, from
    torch.profiler over `calls` calls (the statistics pass alone is too short
    for host-clocked CUDA events: the wrapper's host time hides it)."""
    from torch.profiler import ProfilerActivity, profile

    fl.ln_qkv_gemm(x2d, gamma, beta, w)
    torch.cuda.synchronize()
    # The profiler has come back without one of the two kernels' events
    # (GEMM 0 ms at (2, 37, 256, 4) once, NVIDIA H100 80GB HBM3): profile
    # again, up to three times, and fail if a kernel is still missing.
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fl.ln_qkv_gemm(x2d, gamma, beta, w)
            torch.cuda.synchronize()
        split = {"stats": 0.0, "gemm": 0.0}
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                for key, name in (("stats", "ln_row_stats_kernel"),
                                  ("gemm", "ln_qkv_gemm_kernel")):
                    if name in e.key:
                        split[key] += e.self_device_time_total / 1e3 / calls
        if split["stats"] > 0 and split["gemm"] > 0:
            return split
    raise AssertionError(f"the profiler saw no device time of a kernel of ln_qkv_gemm: {split}")


def phase_ln_qkv(gen):
    """Kernel 5, `fused_ln_qkv_attention`, against its plain version in bf16
    (relative deviation < 5e-3) at the chain's two batches, L = 1024 and a
    ragged small L; timed in turns with the three library calls
    F.layer_norm + torch.matmul + SDPA on the same inputs, and beside the
    plain version.  Then its GEMM half alone, `ln_qkv_gemm` (the statistics
    and GEMM kernels), against `ln_qkv_gemm_plain` (< 5e-3) and timed in
    turns with F.layer_norm + torch.matmul, beside its operations bound
    2*M*C*3C; the profiler splits its device time between the two kernels."""
    rows = []
    for b, l, c, h in LN_SHAPES:
        x = (torch.randn((b, l, c), generator=gen, device="cuda") * 0.5).to(torch.bfloat16)
        gamma = 1 + 0.1 * torch.randn((c,), generator=gen, device="cuda")
        beta = 0.1 * torch.randn((c,), generator=gen, device="cuda")
        w = (torch.randn((c, 3 * c), generator=gen, device="cuda") * 0.02).to(torch.bfloat16)
        scale = (c // h) ** -0.5
        out = fl.fused_ln_qkv_attention(x, gamma, beta, w, h, scale)
        ref = fl.fused_ln_qkv_attention_plain(x, gamma, beta, w, h, scale)
        x2d = x.view(b * l, c)
        qkv = fl.ln_qkv_gemm(x2d, gamma, beta, w)
        qkv_ref = fl.ln_qkv_gemm_plain(x2d, gamma, beta, w)
        torch.cuda.synchronize()
        rel = rel_dev(out, ref)
        max_abs = float((out.float() - ref.float()).abs().max())
        gemm_rel = rel_dev(qkv, qkv_ref)

        def ln_matmul():
            return torch.matmul(F.layer_norm(x.float(), (c,), gamma, beta, 1e-5).to(
                torch.bfloat16), w)

        def library():
            q, k, v = ln_matmul().view(b, l, 3, h, c // h).permute(2, 0, 3, 1, 4)
            return F.scaled_dot_product_attention(q, k, v, scale=scale)

        row = dict(shape=[b, l, c, h], max_rel_dev=rel, max_abs_err=max_abs,
                   **alternate(lambda: fl.fused_ln_qkv_attention(x, gamma, beta, w, h, scale),
                               library),
                   plain_ms=cuda_ms(lambda: fl.fused_ln_qkv_attention_plain(
                       x, gamma, beta, w, h, scale), iters=5),
                   library="F.layer_norm + torch.matmul + scaled_dot_product_attention")
        row["bound_ms"], row["bound_by"] = bound(
            2 * (2 * b * l * c + 3 * c * c) + 8 * c, 2 * b * l * c * 3 * c + 4 * b * l * l * c)
        gemm = dict(max_rel_dev=gemm_rel,
                    **alternate(lambda: fl.ln_qkv_gemm(x2d, gamma, beta, w), ln_matmul),
                    library="F.layer_norm + torch.matmul", **gemm_device_split(x2d, gamma, beta, w))
        gemm["bound_ms"], gemm["bound_by"] = bound(
            2 * (b * l * c + 3 * c * c + 3 * b * l * c) + 8 * c, 2 * b * l * c * 3 * c)
        gemm["tflops"] = 2 * b * l * c * 3 * c / gemm["gemm"] / 1e9
        gemm["stats_share"] = gemm["stats"] / (gemm["stats"] + gemm["gemm"])
        row["gemm_half"] = gemm
        print(f"[3e] B{b} L{l} C{c} H{h}: rel {rel:.2e} max|err| {max_abs:.2e} | kernels "
              f"{row['ms']:.4f} ms {fmt_spread(row['ms_spread'])}, plain {row['plain_ms']:.4f} "
              f"ms, layer_norm+matmul+sdpa {row['library_ms']:.4f} ms "
              f"{fmt_spread(row['library_ms_spread'])} (kernels/library "
              f"{row['ms'] / row['library_ms']:.2f}), bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']})")
        print(f"[3e]   GEMM half ln_qkv_gemm: rel {gemm_rel:.2e} | {gemm['ms']:.4f} ms "
              f"{fmt_spread(gemm['ms_spread'])}, layer_norm+matmul {gemm['library_ms']:.4f} ms "
              f"{fmt_spread(gemm['library_ms_spread'])} (ratio "
              f"{gemm['ms'] / gemm['library_ms']:.2f}), bound {gemm['bound_ms']:.4f} ms "
              f"({gemm['bound_by']}); device: statistics {gemm['stats']:.4f} ms + GEMM "
              f"{gemm['gemm']:.4f} ms ({gemm['tflops']:.0f} TFLOP/s), statistics "
              f"{gemm['stats_share']:.1%} of the two")
        assert torch.isfinite(out.float()).all() and rel < 5e-3, (b, l, c, h, rel)
        assert torch.isfinite(qkv.float()).all() and gemm_rel < 5e-3, (b, l, c, h, gemm_rel)
        rows.append(row)
    return rows


def phase_chain():
    """The full-width A/B chain (U-ViT-L/2 blocks, 20 deep) through
    `bench_fused_ln.main` at B = 32 and 64: fused vs shipped < 2e-2, and
    exactly one kernel-5 launch per block of every fused forward and one
    kernel-1 launch per block of every shipped forward."""
    zero_counts()
    results = bench_fused_ln.main([str(b) for b in CHAIN_BATCHES])
    torch.cuda.synchronize()
    counts = read_counts()
    forwards = sum(r["forwards"] for r in results.values())
    want = {"fused_ln_qkv_attention": bench_fused_ln.DEPTH * forwards,
            "ln_qkv_gemm": bench_fused_ln.DEPTH * forwards,
            "fused_attention_qkv": bench_fused_ln.DEPTH * forwards}
    assert counts == {k: want.get(k, 0) for k in counts}, (counts, want)
    for b, r in results.items():
        print(f"[3f] chain B={b}: shipped {r['shipped_ms']:.2f} ms/fwd, fused "
              f"{r['fused_ms']:.2f} ms/fwd, fused vs shipped rel {r['rel']:.2e} (bar 2e-2), "
              f"{r['forwards']} forwards an arm, {bench_fused_ln.DEPTH} launches each")
        assert np.isfinite(r["rel"]) and r["rel"] < 2e-2, (b, r)
    return results, counts


def set_attn_impl(model: torch.nn.Module, impl: str) -> None:
    for m in model.modules():
        if isinstance(m, Attention):
            m.attn_impl = impl


def set_sp(model: torch.nn.Module, sp) -> None:
    """The sequence-parallel context of the model and its attentions."""
    for m in [model, *(a for a in model.modules() if isinstance(a, Attention))]:
        m.sp = sp


def open_zero_convs(model: torch.nn.Module) -> None:
    """Make the zero-initialised coupling gates non-zero, so that the mask
    stream feeds the image stream."""
    with torch.no_grad():
        for zc in model.zero_convs.values():
            zc.conv.weight.normal_(0, 0.02)
            zc.conv.bias.normal_(0, 0.02)


def phase_forward(gen):
    kw = dict(get_config("mscoco_uvit_small").nnet)
    torch.manual_seed(1)
    model = get_nnet(kw.pop("name"), **kw)
    open_zero_convs(model)
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


def phase_ring_forward(gen):
    """The 512-res UViTT2I (mscoco_uvit_small_512, full width and depth) at
    B=8: sp=2 in-process through the ring and its hop kernel against the same
    weights at sp=1 through the forward kernel (L = 1102 and 2126)."""
    kw = dict(get_config("mscoco_uvit_small_512").nnet)
    torch.manual_seed(3)
    model = get_nnet(kw.pop("name"), **kw)
    open_zero_convs(model)
    model = model.to("cuda", torch.bfloat16).eval()
    x = torch.randn((SP_BATCH, 4, 64, 64), generator=gen, device="cuda")
    t = torch.rand((SP_BATCH,), generator=gen, device="cuda") * 1000
    ctx = torch.randn((SP_BATCH, 77, 768), generator=gen, device="cuda")
    m = torch.randn((SP_BATCH, 8, 128, 128), generator=gen, device="cuda")
    with torch.no_grad():
        set_attn_impl(model, "kernel")
        full = model(x, t, ctx, mask_token=m)
        set_sp(model, InProcessSP(SP))
        set_attn_impl(model, "ring")
        hops = ring_hop.launches
        ring = model(x, t, ctx, mask_token=m)
        hops = ring_hop.launches - hops
    torch.cuda.synchronize()
    assert hops == HOP_LAUNCHES_PER_STEP, hops
    for i, name in enumerate(("noise", "mask")):
        rel = rel_dev(ring[i], full[i])
        print(f"[4b] 512-res UViTT2I forward B={SP_BATCH}, {name}: sp={SP} ring (hop kernel) vs "
              f"sp=1 (forward kernel) rel {rel:.2e} (bar 2e-2), {hops} hop launches")
        assert torch.isfinite(ring[i]).all() and rel < 2e-2, (name, rel)


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

    zero_counts()
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
    # Host cost of the wgmma loop's per-launch tensor-map encode at the
    # request's two shapes (650 launches each).
    encode = [fqa.encode_us(torch.empty((b, l, 3 * h * d), dtype=torch.bfloat16, device="cuda"),
                            h) for b, l, h, d in MAIN_PATH_SHAPES]
    encode_ms = sum(encode) * LAUNCHES_PER_REQUEST / 2 / 1e3
    print(f"[5] tensor-map encode: {encode[0]:.3f} / {encode[1]:.3f} us a launch at L = "
          f"{MAIN_PATH_SHAPES[0][1]} / {MAIN_PATH_SHAPES[1][1]}, {encode_ms:.3f} ms a request "
          f"({encode_ms / (latency * 1e3):.2%} of its {latency * 1e3:.1f} ms)")
    result = dict(requests=REQUESTS, images_per_request=PER_REQUEST, steps=STEPS,
                  launches=launches, total_s=total, per_request_s=total / REQUESTS,
                  yields_s=done, single_request_latency_s=latency,
                  tensor_map_encode_ms_per_request=encode_ms,
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


def phase_imagenet():
    """Class-conditional serving of imagenet256_uvit_large: seeded random
    weights, bf16 network, f32 VAE decode to 256x256.  A 6-step request of 32
    labels through the kernel against the same request through the plain
    attention (images < 2e-2); then 1 warm-up and 3 timed requests of 32
    labels at 50 steps, CFG 0.4, with every launch counter zeroed just before
    and read just after: exactly 1050 kernel-1 launches a request and none
    of the other kernels."""
    pipe = GenerationPipeline.from_config("imagenet256_uvit_large", seed=0)
    assert pipe.class_cond and float(pipe.config.sample.scale) == 0.4
    labels = np.random.default_rng(0).integers(0, 1000, size=(REQUESTS + 1, IMAGENET_LABELS))
    pipe.generate(labels=labels[0], steps=3)  # warm-up, not counted

    z, _ = pipe._draw(IMAGENET_LABELS, torch.Generator(device="cuda").manual_seed(7))
    y = torch.as_tensor(labels[0], device="cuda")
    outs = {}
    for impl in ("kernel", "plain"):
        set_attn_impl(pipe.nnet, impl)
        outs[impl] = pipe.sample(z, None, y, steps=6)[0]
    set_attn_impl(pipe.nnet, "infer")
    rel = rel_dev(outs["kernel"], outs["plain"])
    print(f"[6b] ImageNet-256 6-step request of {IMAGENET_LABELS} labels, images: kernel vs "
          f"plain rel {rel:.2e} (bar 2e-2)")
    assert outs["kernel"].shape == (IMAGENET_LABELS, 3, 256, 256), outs["kernel"].shape
    assert torch.isfinite(outs["kernel"]).all() and rel < 2e-2, rel

    pipe.generate(labels=labels[0], steps=STEPS, seed=99)  # warm-up at 50 steps
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    latencies = []
    for i in range(REQUESTS):
        t0 = time.perf_counter()
        images = pipe.generate(labels=labels[i + 1], steps=STEPS, seed=i)
        latencies.append(time.perf_counter() - t0)
        assert fqa.launches == (i + 1) * IMAGENET_LAUNCHES, (i, fqa.launches)
        assert images.shape == (IMAGENET_LABELS, 256, 256, 3), images.shape
        assert np.isfinite(images).all() and images.min() >= 0 and images.max() <= 1
    counts = read_counts()
    want = {"fused_attention_qkv": REQUESTS * IMAGENET_LAUNCHES}
    assert counts == {k: want.get(k, 0) for k in counts}, counts
    result = dict(requests=REQUESTS, labels_per_request=IMAGENET_LABELS, steps=STEPS,
                  cfg_scale=0.4, launches=counts["fused_attention_qkv"],
                  latency_s=latencies, mean_latency_s=float(np.mean(latencies)),
                  images_per_s=REQUESTS * IMAGENET_LABELS / sum(latencies),
                  max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)
    print(f"[6b] ImageNet-256 serving: {json.dumps(result)}")
    device_profile(lambda: pipe.generate(labels=labels[0], steps=STEPS, seed=9), "6c",
                   f"ImageNet-256 request ({IMAGENET_LABELS} labels)", min(latencies))
    return pipe, counts["fused_attention_qkv"], result


def phase_panoptic_speed_modes(pipe, contexts):
    """The panoptic pipeline with accel 0.2 and the guidance interval (0.5,
    1.0) with the mask-guidance hold: a 20-step request through the kernel
    against the plain attention, then a counted 50-step request with the
    batch shapes each attention saw."""
    pipe.config.sample.update(PANOPTIC_KNOBS)
    ctx = torch.as_tensor(contexts, device="cuda")
    z, m0 = pipe._draw(PER_REQUEST, torch.Generator(device="cuda").manual_seed(11))
    outs = {}
    for impl in ("kernel", "plain"):
        set_attn_impl(pipe.nnet, impl)
        outs[impl] = pipe.sample(z, m0, ctx, steps=PANOPTIC_COMPARE_STEPS)
        assert pipe.last_real_evals < PANOPTIC_COMPARE_STEPS, pipe.last_real_evals
    set_attn_impl(pipe.nnet, "infer")
    for i, (name, bar) in enumerate((("images", 2e-2), ("mask", 5e-2))):
        rel = rel_dev(outs["kernel"][i], outs["plain"][i])
        print(f"[6a] panoptic speed modes {PANOPTIC_KNOBS}, {PANOPTIC_COMPARE_STEPS}-step "
              f"request ({pipe.last_real_evals} real evals), {name}: kernel vs plain rel "
              f"{rel:.2e} (bar {bar:.0e})")
        assert torch.isfinite(outs["kernel"][i]).all() and rel < bar, (name, rel)

    # the (B, L) of every packed qkv the attentions hand to kernel 1
    seen = set()
    attns = [m for m in pipe.nnet.modules() if isinstance(m, Attention)]
    for m in attns:
        m.attend = (lambda f: lambda qkv: seen.add(tuple(qkv.shape[:2])) or f(qkv))(m.attend)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    images, ids = pipe.generate(contexts=contexts, steps=STEPS, seed=3)
    latency = time.perf_counter() - t0
    counts = read_counts()
    for m in attns:
        del m.attend
    evals = pipe.last_real_evals
    assert 0 < evals < STEPS, evals
    want = {"fused_attention_qkv": evals * UVIT_T2I_BLOCKS}
    assert counts == {k: want.get(k, 0) for k in counts}, (counts, evals)
    assert {b for b, _ in seen} == {2 * PER_REQUEST, PER_REQUEST}, seen
    assert np.isfinite(images).all() and ids.shape == (PER_REQUEST, 64, 64, 1)
    print(f"[6a] panoptic 50-step speed-mode request: {evals} real evals of {STEPS}, "
          f"{counts['fused_attention_qkv']} kernel-1 launches ({evals} x {UVIT_T2I_BLOCKS}), "
          f"(B, L) kernel 1 saw: guided {sorted(x for x in seen if x[0] == 2 * PER_REQUEST)}, "
          f"cond-only {sorted(x for x in seen if x[0] == PER_REQUEST)}; latency {latency:.3f} s")
    pipe.config.sample.update(accel=0.0, cfg_interval=())
    return counts["fused_attention_qkv"]


def phase_imagenet_recommended(pipe, exact):
    """The recommended ImageNet-256 mode on phase 6b's pipeline: tanh GELU on
    the same weights and accel 0.2; 50-step requests of 32 labels."""
    pipe.config.sample.accel = bench.RECOMMENDED_KNOBS["accel"]
    pipe.config.nnet.gelu_approx = True
    pipe.nnet = with_gelu(pipe.nnet, True)
    labels = np.random.default_rng(1).integers(0, 1000, size=(REQUESTS + 1, IMAGENET_LABELS))
    z, _ = pipe._draw(IMAGENET_LABELS, torch.Generator(device="cuda").manual_seed(13))
    y = torch.as_tensor(labels[0], device="cuda")
    outs = {}
    for impl in ("kernel", "plain"):
        set_attn_impl(pipe.nnet, impl)
        zero_counts()
        outs[impl] = pipe.sample(z, None, y, steps=STEPS)[0]
        assert pipe.last_real_evals == RECOMMENDED_EVALS, pipe.last_real_evals
        assert fqa.launches == (RECOMMENDED_EVALS * UVIT_L_BLOCKS if impl == "kernel" else 0)
    set_attn_impl(pipe.nnet, "infer")
    rel = rel_dev(outs["kernel"], outs["plain"])
    print(f"[6d] recommended mode ({bench.RECOMMENDED_MODE_NAME}), 50-step request of "
          f"{IMAGENET_LABELS} labels, images: kernel vs plain rel {rel:.2e} (bar 2e-2), "
          f"{RECOMMENDED_EVALS} real evals")
    assert torch.isfinite(outs["kernel"]).all() and rel < 2e-2, rel

    pipe.generate(labels=labels[0], steps=STEPS, seed=98)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    latencies = []
    for i in range(REQUESTS):
        t0 = time.perf_counter()
        images = pipe.generate(labels=labels[i + 1], steps=STEPS, seed=i)
        latencies.append(time.perf_counter() - t0)
        assert pipe.last_real_evals == RECOMMENDED_EVALS
        assert images.shape == (IMAGENET_LABELS, 256, 256, 3) and np.isfinite(images).all()
    counts = read_counts()
    want = {"fused_attention_qkv": REQUESTS * RECOMMENDED_EVALS * UVIT_L_BLOCKS}
    assert counts == {k: want.get(k, 0) for k in counts}, counts
    result = dict(mode=bench.RECOMMENDED_MODE_NAME, requests=REQUESTS,
                  labels_per_request=IMAGENET_LABELS, steps=STEPS,
                  real_evals=RECOMMENDED_EVALS, launches=counts["fused_attention_qkv"],
                  latency_s=latencies, mean_latency_s=float(np.mean(latencies)),
                  images_per_s=REQUESTS * IMAGENET_LABELS / sum(latencies),
                  max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)
    print(f"[6d] recommended mode: {json.dumps(result)}")
    print(f"[6d] recommended vs exact (phase 6b): mean latency {result['mean_latency_s']:.3f} "
          f"vs {exact['mean_latency_s']:.3f} s, {result['images_per_s']:.2f} vs "
          f"{exact['images_per_s']:.2f} images/s, peak {result['max_memory_allocated_gb']:.2f} "
          f"vs {exact['max_memory_allocated_gb']:.2f} GB")
    return counts["fused_attention_qkv"]


def phase_bench():
    """The port's bench through its `main` at batch 32, 3 repetitions."""
    os.environ.update(BENCH_ENV)
    zero_counts()
    t0 = time.perf_counter()
    record = bench.main()
    wall = time.perf_counter() - t0
    counts = read_counts()
    want = {"fused_attention_qkv": BENCH_LAUNCHES}
    assert counts == {k: want.get(k, 0) for k in counts}, counts
    assert record["value"] > 0 and record["recommended_value"] > 0, record
    print(f"[6e] port bench (bf16 VAE decode): {counts['fused_attention_qkv']} kernel-1 launches, "
          f"{wall:.1f} s including the build of its components")
    return record, counts["fused_attention_qkv"]


def phase_imagenet64():
    """Class-conditional pixel-space serving of imagenet64_uvit_mid (U-ViT-M/4,
    17 blocks, 12 heads, L = 258), the config's own protocol: the continuous
    DPM-Solver (fast_upstream, noise prediction, the linear schedule, 50 evals
    [3] x 16 + [2]), no CFG, bf16 network, f32 solver, no VAE.  A 10-step
    request of 64 labels through the kernel against the plain attention
    (images < 2e-2); then 1 warm-up and 3 timed requests of 64 labels at 50
    steps with every launch counter zeroed just before and read just after:
    exactly 850 kernel-1 launches a request and none of the other kernels;
    one request under the profiler."""
    pipe = GenerationPipeline.from_config("imagenet64_uvit_mid", seed=0)
    sample = pipe.config.sample
    assert pipe.continuous and pipe.class_cond and pipe.vae is None
    assert sample.algorithm == "dpm_solver" and not sample.cfg and sample.sample_steps == STEPS
    labels = np.random.default_rng(2).integers(0, 1000, size=(REQUESTS + 1, IMAGENET64_LABELS))
    pipe.generate(labels=labels[0], steps=3)  # warm-up, not counted

    z, _ = pipe._draw(IMAGENET64_LABELS, torch.Generator(device="cuda").manual_seed(17))
    y = torch.as_tensor(labels[0], device="cuda")
    outs = {}
    for impl in ("kernel", "plain"):
        set_attn_impl(pipe.nnet, impl)
        outs[impl] = pipe.sample(z, None, y, steps=IMAGENET64_COMPARE_STEPS)[0]
    set_attn_impl(pipe.nnet, "infer")
    rel = rel_dev(outs["kernel"], outs["plain"])
    print(f"[6f] ImageNet-64 M/4 {IMAGENET64_COMPARE_STEPS}-step request of "
          f"{IMAGENET64_LABELS} labels, images: kernel vs plain rel {rel:.2e} (bar 2e-2)")
    assert outs["kernel"].shape == (IMAGENET64_LABELS, 3, 64, 64), outs["kernel"].shape
    assert torch.isfinite(outs["kernel"]).all() and rel < 2e-2, rel

    pipe.generate(labels=labels[0], steps=STEPS, seed=99)  # warm-up at 50 steps
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    latencies = []
    per_request = IMAGENET64_BLOCKS * STEPS
    for i in range(REQUESTS):
        t0 = time.perf_counter()
        images = pipe.generate(labels=labels[i + 1], steps=STEPS, seed=i)
        latencies.append(time.perf_counter() - t0)
        assert pipe.last_real_evals == STEPS, pipe.last_real_evals
        assert fqa.launches == (i + 1) * per_request, (i, fqa.launches)
        assert images.shape == (IMAGENET64_LABELS, 64, 64, 3), images.shape
        assert np.isfinite(images).all() and images.min() >= 0 and images.max() <= 1
    counts = read_counts()
    want = {"fused_attention_qkv": REQUESTS * per_request}
    assert counts == {k: want.get(k, 0) for k in counts}, counts
    result = dict(requests=REQUESTS, labels_per_request=IMAGENET64_LABELS, steps=STEPS,
                  evals=STEPS, launches=counts["fused_attention_qkv"], latency_s=latencies,
                  mean_latency_s=float(np.mean(latencies)),
                  images_per_s=REQUESTS * IMAGENET64_LABELS / sum(latencies),
                  max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)
    print(f"[6f] ImageNet-64 M/4 serving: {json.dumps(result)}")
    busy = device_profile(lambda: pipe.generate(labels=labels[0], steps=STEPS, seed=9), "6f",
                          f"ImageNet-64 request ({IMAGENET64_LABELS} labels)", min(latencies))
    result["device_busy_ms"] = busy
    return counts["fused_attention_qkv"], result


def phase_cifar_serving():
    """Unconditional pixel-space serving of cifar10_uvit_small (U-ViT-S/2, 13
    blocks, 8 heads, L = 257), the config's own protocol: 1000
    Euler-Maruyama steps of the reverse SDE, bf16 network, f32 state.  A
    20-step request of 32 through the kernel against the plain attention on
    the same draws and the same step-noise generator (images < 2e-2); then,
    after a 10-step warm-up, one timed request of 32 at 1000 steps with the
    counters zeroed just before and read just after: exactly 13,000 kernel-1
    launches and none of the other kernels; the device's idle share from a
    100-step request under the profiler beside the same request without it."""
    pipe = GenerationPipeline.from_config("cifar10_uvit_small", seed=0)
    assert pipe.continuous and not pipe.class_cond and pipe.vae is None
    assert pipe.config.sample.algorithm == "euler_maruyama_sde"
    assert pipe.config.sample.sample_steps == CIFAR_STEPS
    z, _ = pipe._draw(CIFAR_IMAGES, torch.Generator(device="cuda").manual_seed(19))
    outs = {}
    for impl in ("kernel", "plain"):
        set_attn_impl(pipe.nnet, impl)
        outs[impl] = pipe.sample(z, None, None, steps=CIFAR_COMPARE_STEPS,
                                 generator=torch.Generator(device="cuda").manual_seed(23))[0]
    set_attn_impl(pipe.nnet, "infer")
    rel = rel_dev(outs["kernel"], outs["plain"])
    print(f"[6g] CIFAR-10 S/2 {CIFAR_COMPARE_STEPS}-step Euler-Maruyama request of "
          f"{CIFAR_IMAGES}, images: kernel vs plain rel {rel:.2e} (bar 2e-2)")
    assert outs["kernel"].shape == (CIFAR_IMAGES, 3, 32, 32), outs["kernel"].shape
    assert torch.isfinite(outs["kernel"]).all() and rel < 2e-2, rel

    pipe.generate(n=CIFAR_IMAGES, steps=CIFAR_WARMUP_STEPS, seed=98)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    images = pipe.generate(n=CIFAR_IMAGES, steps=CIFAR_STEPS, seed=0)
    latency = time.perf_counter() - t0
    counts = read_counts()
    want = {"fused_attention_qkv": CIFAR_BLOCKS * CIFAR_STEPS}
    assert counts == {k: want.get(k, 0) for k in counts}, counts
    assert images.shape == (CIFAR_IMAGES, 32, 32, 3), images.shape
    assert np.isfinite(images).all() and images.min() >= 0 and images.max() <= 1
    peak = torch.cuda.max_memory_allocated() / 1e9
    t0 = time.perf_counter()
    pipe.generate(n=CIFAR_IMAGES, steps=CIFAR_PROFILE_STEPS, seed=1)
    short = time.perf_counter() - t0
    busy = device_profile(lambda: pipe.generate(n=CIFAR_IMAGES, steps=CIFAR_PROFILE_STEPS,
                                                seed=2),
                          "6g", f"CIFAR-10 {CIFAR_PROFILE_STEPS}-step request", short)
    result = dict(images=CIFAR_IMAGES, steps=CIFAR_STEPS, launches=counts["fused_attention_qkv"],
                  latency_s=latency, images_per_s=CIFAR_IMAGES / latency,
                  ms_per_step=latency / CIFAR_STEPS * 1e3, max_memory_allocated_gb=peak,
                  profile_steps=CIFAR_PROFILE_STEPS, profile_unprofiled_s=short,
                  device_busy_ms=busy, device_idle_share=1 - busy / (short * 1e3))
    print(f"[6g] CIFAR-10 S/2 serving: {json.dumps(result)}")
    return counts["fused_attention_qkv"], result


def write_pretrained(path: str, config) -> None:
    """A reference-format .pth from a seeded model, zero convs opened so the
    mask stream feeds the image stream."""
    kw = dict(config.nnet)
    torch.manual_seed(2)
    model = get_nnet(kw.pop("name"), **kw)
    open_zero_convs(model)
    torch.save(model.state_dict(), path)


def grads_vector(trainer) -> torch.Tensor:
    return torch.cat([p.grad.flatten().float() for p in trainer.state.params.values()])


def train_loss(metrics) -> float:
    return float(metrics["loss"] + metrics.get("loss_mask", 0.0))


def phase_train_parity(trainer, batch_size, impls, tag):
    """One step through the kernels (impls[0]) and through the plain
    attention (impls[1]), same weights, batch and draws."""
    rng = np.random.default_rng(0)
    batch = tuple(np.stack(f) for f in zip(*(
        trainer.dataset.train[i] for i in range(batch_size))))
    h, w, c2 = batch[0].shape[1:]
    if trainer.task == "pixel_sde":  # continuous times and the image noise
        noise = {"t": rng.uniform(size=batch_size).astype(np.float32),
                 "eps": rng.standard_normal(batch[0].shape).astype(np.float32)}
    else:
        noise = {"z": rng.standard_normal((batch_size, h, w, c2 // 2)).astype(np.float32),
                 "n": rng.integers(1, 1001, batch_size),
                 "eps": rng.standard_normal((batch_size, h, w, c2 // 2)).astype(np.float32)}
    if trainer.task == "t2i_discrete":
        m = trainer.config.nnet.mask_size
        noise["eps_m"] = 2.0 * rng.standard_normal(
            (batch_size, m, m, trainer.config.nnet.mask_bits)).astype(np.float32)
    out = {}
    for impl in impls:
        set_attn_impl(trainer.nnet, impl)
        metrics = trainer.loss_and_grads(batch, noise)
        out[impl] = (train_loss(metrics), grads_vector(trainer))
    set_attn_impl(trainer.nnet, impls[0])
    for p in trainer.state.params.values():
        p.grad = None
    (ker_loss, ker_grad), (ref_loss, ref_grad) = out[impls[0]], out[impls[1]]
    loss_rel = abs(ker_loss - ref_loss) / abs(ref_loss)
    grad_rel = rel_dev(ker_grad, ref_grad)
    print(f"[{tag}] train step B={batch_size}, attn_impl {impls[0]!r} vs {impls[1]!r}: loss "
          f"{ker_loss:.6f} vs {ref_loss:.6f} (rel {loss_rel:.2e}, bar 5e-3), "
          f"whole gradient rel {grad_rel:.2e} (bar 2e-2)")
    assert np.isfinite(ker_loss) and loss_rel < 5e-3, loss_rel
    assert torch.isfinite(ker_grad).all() and grad_rel < 2e-2, grad_rel


def phase_train(trainer, tag, per_step):
    """Trainer.fit: warm-up, then the timed steps with every launch counter
    zeroed just before and read just after; `per_step` is the launches each
    kernel must make a step (the others must make none)."""
    bsz = trainer.config.train.batch_size
    frozen = {n: trainer.state.params[n].detach().clone() for n in sorted(trainer.state.frozen)}
    assert frozen or not trainer.config.pretrained, "fine-tune mode froze nothing"
    trainer.fit(max_steps=WARMUP_STEPS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    history = trainer.fit(max_steps=WARMUP_STEPS + TIMED_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    assert trainer.state.step == WARMUP_STEPS + TIMED_STEPS, trainer.state.step
    assert counts == {k: per_step.get(k, 0) * TIMED_STEPS for k in counts}, counts
    losses = [train_loss(m) for m in history]
    assert losses and np.isfinite(losses).all(), losses
    assert all(torch.isfinite(p).all() for p in trainer.state.params.values())
    assert all(torch.equal(trainer.state.params[n], p) for n, p in frozen.items())
    result = dict(batch=bsz, steps=TIMED_STEPS, wall_s=wall, steps_per_s=TIMED_STEPS / wall,
                  images_per_s=TIMED_STEPS * bsz / wall, step_ms=wall / TIMED_STEPS * 1e3,
                  max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
                  launches=counts, logged_losses=losses,
                  frozen_params=len(trainer.state.frozen),
                  params=sum(p.numel() for p in trainer.state.params.values()))
    print(f"[{tag}] training: {json.dumps(result)}")
    return counts, wall / TIMED_STEPS


def phase_train_profile(trainer, step_s, tag):
    stream = trainer.data_stream(start_step=trainer.state.step)
    batch = next(stream)
    device_profile(lambda: trainer.train_step(batch), tag,
                   f"train step (batch {trainer.config.train.batch_size})", step_s)


def make_trainer(name, tmp, mesh=None):
    """`Trainer` for a zoo config at full width and depth in fine-tune mode (a
    seeded reference-format .pth, so the image stream is frozen) on synthetic
    coco data at the config's shapes."""
    config = get_config(name)
    h, w, c = config.z_shape
    m = config.nnet.mask_size
    config.dataset = d(name="synthetic", n=128, z_shape=(h, w, 2 * c),
                       clip_shape=(config.nnet.num_clip_token, config.nnet.clip_dim),
                       mask_size=m)
    config.train.log_interval = 5
    config.num_workers = 4
    config.mesh.update(mesh or {})
    config.pretrained = os.path.join(tmp, f"{name}.pth")
    write_pretrained(config.pretrained, config)
    return Trainer(config, os.path.join(tmp, f"run_{name}"), device="cuda")


def make_latent_trainer(tmp):
    """`Trainer` for imagenet256_uvit_large (latent_discrete, U-ViT-L/2 at
    full width and depth, from the seeded initialisation) at batch 64 on
    synthetic latent moments (32, 32, 8) with labels in [0, 1000): the null
    class 1000 replaces a label at p_uncond 0.15, as the config's dataset
    does."""
    config = get_config("imagenet256_uvit_large")
    h, w, c = config.z_shape
    config.dataset = d(name="synthetic", style="imagenet", n=4 * LATENT_BATCH,
                       z_shape=(h, w, 2 * c), num_classes=1000)
    config.train.batch_size = LATENT_BATCH
    config.train.log_interval = 5
    config.num_workers = 4
    trainer = Trainer(config, os.path.join(tmp, "run_imagenet256_uvit_large"), device="cuda")
    trainer.dataset.train = CFGLabelDataset(trainer.dataset.train, P_UNCOND, 1000)
    assert trainer.config.nnet.use_checkpoint and trainer.config.nnet.remat_policy == "save_attn"
    return trainer


def make_pixel_trainer(tmp):
    """`Trainer` for cifar10_uvit_small (pixel_sde, unconditional, U-ViT-S/2 at
    full width and depth from the seeded initialisation, bf16 autocast over
    f32 master weights, AdamW + EMA) at the config's batch of 128 on
    synthetic pixels (32, 32, 3) from a numpy seed: only the dataset is cut."""
    config = get_config("cifar10_uvit_small")
    config.dataset = d(name="synthetic", style="pixels", n=4 * CIFAR_BATCH,
                       z_shape=(32, 32, 3), num_classes=10)
    config.train.log_interval = 5
    config.num_workers = 4
    trainer = Trainer(config, os.path.join(tmp, "run_cifar10_uvit_small"), device="cuda")
    assert trainer.task == "pixel_sde" and config.train.mode == "uncond"
    assert config.train.batch_size == CIFAR_BATCH and not config.nnet.use_checkpoint
    return trainer


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
    hop_rows = phase_hop(gen)
    mha_rows, mha_launches = phase_mha(gen)
    ln_rows = phase_ln_qkv(gen)
    chain, chain_counts = phase_chain()
    phase_forward(gen)
    phase_ring_forward(gen)
    pipe, contexts, launches, latency = phase_serving()
    phase_profile(pipe, contexts, latency)
    panoptic_speed_launches = phase_panoptic_speed_modes(pipe, contexts)
    del pipe
    pipe, imagenet_launches, imagenet_result = phase_imagenet()
    recommended_launches = phase_imagenet_recommended(pipe, imagenet_result)
    del pipe
    torch.cuda.empty_cache()
    bench_record, bench_launches = phase_bench()
    torch.cuda.empty_cache()
    imagenet64_launches, _ = phase_imagenet64()
    torch.cuda.empty_cache()
    cifar_launches, _ = phase_cifar_serving()
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        trainer = make_trainer("mscoco_uvit_small", tmp)
        phase_train_parity(trainer, PARITY_BATCH, ("auto", "plain"), "7")
        train_counts, step_s = phase_train(
            trainer, "8", {"fused_attention_qkv": LAUNCHES_PER_STEP,
                           "fused_attention_qkv_vjp": LAUNCHES_PER_STEP})
        phase_train_profile(trainer, step_s, "9")
        del trainer
        torch.cuda.empty_cache()

        sp_trainer = make_trainer("mscoco_uvit_small_512", tmp,
                                  mesh=dict(sp=SP, sp_mode="in_process"))
        assert sp_trainer.config.train.batch_size == SP_BATCH
        phase_train_parity(sp_trainer, SP_BATCH, ("ring", "ring_plain"), "11")
        sp_counts, sp_step_s = phase_train(sp_trainer, "12",
                                           {"attention_hop": HOP_LAUNCHES_PER_STEP})
        phase_train_profile(sp_trainer, sp_step_s, "13")
        del sp_trainer
        torch.cuda.empty_cache()

        latent_trainer = make_latent_trainer(tmp)
        phase_train_parity(latent_trainer, PARITY_BATCH, ("auto", "plain"), "14")
        latent_counts, latent_step_s = phase_train(
            latent_trainer, "15", {"fused_attention_qkv": UVIT_L_BLOCKS,
                                   "fused_attention_qkv_vjp": UVIT_L_BLOCKS})
        phase_train_profile(latent_trainer, latent_step_s, "16")
        del latent_trainer
        torch.cuda.empty_cache()

        pixel_trainer = make_pixel_trainer(tmp)
        phase_train_parity(pixel_trainer, CIFAR_BATCH, ("auto", "plain"), "17")
        pixel_counts, pixel_step_s = phase_train(
            pixel_trainer, "18", {"fused_attention_qkv": CIFAR_BLOCKS,
                                  "fused_attention_qkv_vjp": CIFAR_BLOCKS})
        phase_train_profile(pixel_trainer, pixel_step_s, "19")
        del pixel_trainer

    fwd_train, bwd_train = train_counts["fused_attention_qkv"], \
        train_counts["fused_attention_qkv_vjp"]
    main_rows = [r for r in rows if tuple(r["shape"]) in MAIN_PATH_SHAPES]
    per_pair = {k: sum(r[k] for r in main_rows) for k in ("ms", "plain_ms", "bound_ms",
                                                          "library_ms")}
    kernel = dict(
        name="fused_attention_qkv", route="cuda",
        source="panopticdiffusionmodels_torch/ops/kernels/csrc/fused_qkv_attention.cu",
        replaces="panopticdiffusionmodels_tpu/ops/pallas/fused_qkv_attention.py:302",
        launches=launches,
        launches_by_path={"serving (3 requests)": launches,
                          f"training ({TIMED_STEPS} steps)": fwd_train,
                          f"sp training ({TIMED_STEPS} steps)": sp_counts["fused_attention_qkv"],
                          "ImageNet-256 serving (3 requests)": imagenet_launches,
                          "ImageNet-256 recommended mode (3 requests)": recommended_launches,
                          "panoptic speed-mode request (50 steps)": panoptic_speed_launches,
                          f"U-ViT-L/2 latent_discrete training ({TIMED_STEPS} steps)":
                              latent_counts["fused_attention_qkv"],
                          "port bench (exact and recommended, 4 runs each)": bench_launches,
                          "ImageNet-64 M/4 serving (3 requests)": imagenet64_launches,
                          "CIFAR-10 S/2 Euler-Maruyama serving (1 request of 1000 steps)":
                              cifar_launches,
                          f"CIFAR-10 S/2 pixel_sde training ({TIMED_STEPS} steps)":
                              pixel_counts["fused_attention_qkv"],
                          "A/B chain, shipped and fused arms (B=32, 64)":
                              chain_counts["fused_attention_qkv"]},
        max_abs_err=max(r["max_abs_err"] for r in rows),
        max_rel_dev=max(r["max_rel_dev"] for r in rows),
        kernel_ms=per_pair["ms"], **per_pair,
        bound_by="bytes" if all(r["bound_by"] == "bytes" for r in main_rows) else "operations",
        per="one launch at L=334 plus one at L=590 (B=8, H=8, D=64), the pair each "
            "dual-stream layer runs per NFE; the ImageNet-256 serving shape is the row "
            f"{list(IMAGENET_SHAPE)}, the pixel-space shapes the rows "
            f"{[list(x) for x in PIXEL_SHAPES]}; the fused arm of the A/B chain launches "
            "this kernel inside fused_ln_qkv_attention, which counts it there",
        shapes=rows)
    train_rows = [r for r in bwd_rows if tuple(r["shape"]) in TRAIN_SHAPES]
    per_step = {k: sum(r[k] for r in train_rows) for k in ("ms", "plain_ms", "bound_ms",
                                                           "library_ms")}
    backward = dict(
        name="fused_attention_qkv_vjp", route="cuda",
        source="panopticdiffusionmodels_torch/ops/kernels/csrc/fused_qkv_attention_bwd.cu",
        replaces="panopticdiffusionmodels_tpu/ops/pallas/fused_qkv_attention.py:226",
        launches=bwd_train,
        launches_by_path={f"training ({TIMED_STEPS} steps)": bwd_train,
                          f"U-ViT-L/2 latent_discrete training ({TIMED_STEPS} steps)":
                              latent_counts["fused_attention_qkv_vjp"],
                          f"CIFAR-10 S/2 pixel_sde training ({TIMED_STEPS} steps)":
                              pixel_counts["fused_attention_qkv_vjp"]},
        max_abs_err=max(r["max_abs_err"] for r in bwd_rows),
        max_rel_dev=max(r["max_rel_dev"] for r in bwd_rows),
        kernel_ms=per_step["ms"], **per_step,
        bound_by="bytes" if all(r["bound_by"] == "bytes" for r in train_rows) else "operations",
        per="one call at L=334 plus one at L=590 (B=64, H=8, D=64), the pair each "
            "dual-stream layer runs per train step; one call is two CUDA kernels; the "
            f"U-ViT-L/2 training shape is the row {list(LATENT_TRAIN_SHAPE)}, the CIFAR-10 "
            f"one {list(CIFAR_TRAIN_SHAPE)}",
        shapes=bwd_rows)
    hop_main = [r for r in hop_rows if tuple(r["shape"][:3]) in HOP_MAIN_SHAPES]
    per_hop_pair = {k: sum(r[k] for r in hop_main) for k in ("ms", "plain_ms", "bound_ms",
                                                             "library_ms")}
    hop = dict(
        name="attention_hop", route="cuda",
        source="panopticdiffusionmodels_torch/ops/kernels/csrc/ring_hop.cu",
        replaces="panopticdiffusionmodels_tpu/ops/pallas/ring_hop.py:103",
        launches=sp_counts["attention_hop"],
        launches_by_path={f"sp training ({TIMED_STEPS} steps)": sp_counts["attention_hop"]},
        max_abs_err=max(r["max_abs_err"] for r in hop_rows),
        max_rel_dev=max(r["max_rel_dev"] for r in hop_rows),
        kernel_ms=per_hop_pair["ms"], **per_hop_pair,
        bound_by=max(hop_main, key=lambda r: r["bound_ms"])["bound_by"],
        per="one hop at Lq=Lk=1063 plus one at Lq=Lk=551 (B=16 folded, H=8, D=64, "
            "nvalid=Lk), the pair each sp=2 dual-stream layer runs twice per train step; "
            "library_ms is flash SDPA (out, lse) on the same q, k, v",
        shapes=hop_rows)
    mha_main = mha_rows[0]
    mha = dict(
        name="fused_attention", route="cuda",
        source="panopticdiffusionmodels_torch/ops/kernels/csrc/fused_attention.cu",
        replaces="panopticdiffusionmodels_tpu/ops/pallas/fused_attention.py:63",
        launches=mha_launches,
        launches_by_path={"multi_head_attention(impl='pallas') forward + backward at "
                          "U-ViT-L/2": mha_launches},
        max_abs_err=max(r["max_abs_err"] for r in mha_rows),
        max_rel_dev=max(r["max_rel_dev"] for r in mha_rows),
        kernel_ms=mha_main["ms"], **{k: mha_main[k] for k in ("ms", "plain_ms", "bound_ms",
                                                              "bound_by", "library_ms")},
        per=f"one launch at (B, H, L, D) = {tuple(mha_main['shape'])}; library_ms is "
            "scaled_dot_product_attention on the same q, k, v",
        shapes=mha_rows)
    ln_main = ln_rows[0]
    ln = dict(
        name="fused_ln_qkv_attention", route="cuda",
        source="panopticdiffusionmodels_torch/ops/kernels/csrc/fused_ln_qkv_attention.cu",
        replaces="panopticdiffusionmodels_tpu/ops/pallas/fused_ln_qkv_attention.py:57",
        launches=chain_counts["fused_ln_qkv_attention"],
        launches_by_path={"A/B chain, fused arm (B=32, 64)":
                          chain_counts["fused_ln_qkv_attention"]},
        max_abs_err=max(r["max_abs_err"] for r in ln_rows),
        max_rel_dev=max(r["max_rel_dev"] for r in ln_rows),
        kernel_ms=ln_main["ms"], **{k: ln_main[k] for k in ("ms", "plain_ms", "bound_ms",
                                                            "bound_by", "library_ms")},
        per=f"one call at (B, L, C, heads) = {tuple(ln_main['shape'])}: the LN-prologue qkv "
            "GEMM launch plus the packed-qkv attention launch (fused_qkv_attention.cu); "
            "library_ms is F.layer_norm + torch.matmul + scaled_dot_product_attention, "
            "three calls",
        gemm_half=ln_main["gemm_half"],
        chain={str(b): r for b, r in chain.items()},
        shapes=ln_rows)
    print(json.dumps(bench_record))
    print(card_line())
    print(json.dumps({"kernels": [kernel, backward, hop, mha, ln]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
