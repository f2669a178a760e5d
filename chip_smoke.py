#!/usr/bin/env python3
"""Drive the PyTorch port's serving (panoptic and ImageNet-256
class-conditional, exact and with the sampling speed modes; pixel-space
ImageNet-64 class-conditional and CIFAR-10 unconditional; the UNet family
with PNDM; the rest of the config zoo, U-ViT-H among it), its bench,
training (panoptic U-ViT and UNet, U-ViT-L/2 latent_discrete and CIFAR-10
pixel_sde), sequence-parallel training, (B, H, L, D) attention and
fused-LayerNorm A/B paths, evaluation (sampling, FID, the CLIP encoders) on
one NVIDIA H100 and check their kernels; then data-parallel training over
processes, every remat policy, `pallas_recompute`, image-only t2i training,
Adam, sequence-parallel U-ViT training and asynchronous checkpoints; then the
data pipeline (MS-COCO feature extraction, training through the native C++
loader, checkpoint conversion) and fully sharded data parallelism.

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
     (128, 257, 8, 64)) and U-ViT-H/2 serving at (64, 258, 16, 72)
     (relative deviation < 5e-3, and where L is not a
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
     shapes (panoptic, U-ViT-L/2 at batch 64, U-ViT-S/2 at (128, 257, 8,
     64) and U-ViT-H/2 at (32, 258, 16, 72)), U-ViT-L/2 / U-ViT-H and two
     ragged short L (relative deviation
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
 20. evaluation: `cli.main(["eval", <config file>, "--workdir=...",
     "--inception=..."])` in process, mscoco_uvit_small at full width and
     depth (seeded reference-format .pth and VAE, synthetic coco data with
     panoptic maps), 64 samples in 2 mini-batches of 32, 50 steps, CFG 1.0,
     a seeded pt_inception-format file and reference stats made by
     `dir_statistics` from 64 seeded PNGs: exactly 2600 kernel-1 launches
     and none of the others, 64 images and 64 mask PNGs under the
     contract's names, finite eval_loss_mask, eval_cnt_mask_diff and fid, an
     eval.log line; seconds of sampling (CUDA events), of mask decode and of
     PNG writes, of Inception (images/s) and of `sqrtm`, peak memory; a
     6-step mini-batch of `Trainer.build_sample_fn` through kernel 1 against
     the plain attention (images < 2e-2, mask < 5e-2); one mini-batch under
     torch.profiler (the busy share of the sampling);
 21. the Inception extractor: 16 images 256 -> 299 on the card against the
     CPU, f32 with TF32 off (< 1e-3 relative); images/s at batch 50;
 22. prompts: a seeded FrozenCLIPEmbedder at CLIP-L/14's shape on the card
     against the CPU (< 1e-3 relative); GenerationPipeline.from_config(
     "mscoco_uvit_small", clip_path=...) answers generate(prompts=[4
     prompts]) with exactly 1300 kernel-1 launches, its latency beside a
     contexts= request and phase 5's;
 23. CLIP score: a seeded CLIP-ViT-B/32 scores phase 20's 64 images against
     64 caption files, card against CPU (< 1e-3 relative);
 25. the UNet: mscoco_unet's UNet2DCondition at full width (860.6 M
     parameters, seeded, mask gate opened) on the card in f32 with TF32 off
     against the CPU in f32 at B = 2 (< 1e-3 relative on noise and mask);
     bf16 against f32 on the card at B = 8 (printed); the operations of one
     bf16 forward at B = 8 (`FlopCounterMode`);
 26. UNet serving: GenerationPipeline.from_config("mscoco_unet") (bf16
     network, f32 VAE, PNDM, CFG 1.0): 1 warm-up and 3 requests of 4 CLIP
     contexts at 50 steps, exactly 51 network calls of batch 8 a request and
     no launch of the five kernels (the UNet's attention is the plain one,
     as in JAX); latency, images/s, peak memory beside the operations bound
     of 51 forwards; one request under torch.profiler;
 27. UNet training: `Trainer` for mscoco_unet at full width from the seeded
     initialisation on synthetic SD-feature coco data: 3 warm-up and 20
     timed steps at batch 8, no kernel launch, finite losses; AdamW + EMA's
     device time (CUDA events) beside its bytes bound; a profiled step;
 28. mscoco_unet_512: one request of 1 context at 30 steps (31 calls of
     batch 2, L = 4096 at the first level), then 3 warm-up and 5 timed
     steps at batch 1: latency, step time, peak memory;
 29. the rest of the zoo on kernel 1: a 6-step request of each of
     mscoco_stable_diffusion, mscoco_uvit_mid, mscoco_uvit_large (4
     contexts), imagenet256_uvit_huge (32 labels), imagenet512_uvit_large
     and imagenet512_uvit_huge (8 labels) through the kernel against the
     plain attention (images < 2e-2, masks < 5e-2), exactly blocks x 6
     kernel-1 launches (26, 17, 42, 29, 21, 29 blocks);
 30. U-ViT-H/2: 1 warm-up and 3 requests of 32 labels at 50 steps, CFG 0.4,
     exactly 1450 kernel-1 launches a request at (64, 258, 16, 72) on the
     mma.sync loop; one latent_discrete step at batch 32 through kernels 1
     and 2 against the plain attention (loss < 5e-3, whole gradient < 2e-2)
     with exactly 29 forward and 29 backward kernel calls;
 31. data parallelism on the one card: (a) mscoco_uvit_small at batch 64,
     fine-tune mode, through DistributedDataParallel over NCCL at world 1 in
     a child process, one step against the same trainer without the
     wrapper on the same batch and draws (loss < 5e-3, whole gradient
     < 2e-2) with 26 + 26 kernel calls, then 20 steps of each timed in
     turns; (b) two processes on the one card over gloo (NCCL refuses two
     ranks on one card), synthetic_tiny with one head of 64 at a global
     batch of 16 through `fit` with a checkpoint every step: the ranks'
     parameters bit-identical after 3 steps, their update against one
     process at batch 16 < 2e-2, only rank 0 wrote, 10 + 10 kernel calls a
     step in each rank; step times beside one process's;
 32. every remat policy (None, 'nothing', 'everything', 'dots',
     'dots_no_batch', 'save_attn') and use_checkpoint=False on
     mscoco_uvit_small at batch 64, fine-tune mode: one step each on the
     same weights, batch and draws (gradient against use_checkpoint=False
     < 2e-2), exactly 26 kernel-1 launches under 'save_attn' / 'everything'
     and 52 under the others (the attention replayed), 26 kernel-2 calls
     under each; step time and peak memory of each over 5 steps;
 33. attn_impl='pallas_recompute' on the same trainer: 26 kernel-1 launches
     a step and no kernel-2 call, the gradient against 'auto' < 2e-2; the
     two timed in turns;
 34. image-only t2i: mscoco_uvit_mid (U-ViT-M/2, 17 blocks, L = 334) from
     the seeded initialisation at batch 32: 3 + 20 steps through `fit` with
     exactly 17 + 17 kernel calls a step, the step against the plain
     attention (loss < 5e-3, whole gradient < 2e-2), one Adam step;
 35. (a) U-ViT-L/2 latent_discrete at batch 64, mesh.sp = 2 in process:
     one step through the hop kernel against sp = 1 through kernels 1 and 2
     (loss < 5e-3, whole gradient < 2e-2), then 3 + 10 steps with exactly
     42 hop launches a step (21 blocks x 2 hops, no relaunch under
     save_attn); (b) one checkpoint of mscoco_uvit_small's train state
     (params, EMA and two AdamW moments) with block=True and one with
     block=False while training goes on: the loop's stall, the write's
     duration, both files read back equal to the state at the call;
 36. the data pipeline: (a) a synthetic COCO tree (128 JPEGs of 640 x 480,
     5 captions each, panoptic PNGs of 6 segments, categories up to 200)
     through `python -m panopticdiffusionmodels_torch.scripts.
     extract_mscoco_feature --size 256` on the card with a seeded
     full-width SD KL-VAE and a CLIP-L/14-shaped text encoder, then the
     empty-context and prompt scripts: images/s and the VAE / CLIP / host
     split, 2 images' moments and contexts against the CPU's (relative
     deviation < 1e-3) and their seg maps equal; (b) mscoco_uvit_small at
     batch 64, fine-tune mode, save_attn, from those features through the
     native loader (input_pipeline 'native'), 3 + 20 steps with exactly
     26 + 26 kernel calls a step, then blocks of 5 steps in turns with the
     Python Loader, and the host's time to assemble a batch with each; (c)
     a seeded reference-format .pth through `scripts/convert_checkpoint.py`:
     `Trainer` resumes its `0.ckpt` strictly, parameters and EMA equal the
     .pth bit for bit, one step through kernels 1 and 2;
 37. FSDP: two processes on the one card over gloo at mesh.fsdp = 2:
     synthetic_tiny in f32, the ranks' gathered parameters and EMA after 3
     steps against one process at the global batch of 16 (max absolute
     difference < 1e-5); mscoco_uvit_small at the global batch of 64, 26 +
     26 kernel calls a step in each rank, each rank's bytes of parameters,
     gradients, moments and EMA against one process's (< 0.55), its step
     time (gloo copies through the host; not judged);
 38. prints the bench's JSON line, the card line, the `kernels` JSON line
     (all five kernels) and, last, the ok line.
"""
from __future__ import annotations

import contextlib
import json
import os
import re
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from panopticdiffusionmodels_torch import cli
from panopticdiffusionmodels_torch.configs import get_config
from panopticdiffusionmodels_torch.configs.base import d
from panopticdiffusionmodels_torch.data import Loader
from panopticdiffusionmodels_torch.data.datasets import CFGLabelDataset
from panopticdiffusionmodels_torch.data.mscoco import MSCOCODatabase
from panopticdiffusionmodels_torch.data.native_loader import NativeFeatureLoader
from panopticdiffusionmodels_torch.evaluation import clip_score, fid, inception, runner, sampler_io
from panopticdiffusionmodels_torch.evaluation.inception import no_tf32
from panopticdiffusionmodels_torch.models import clip
from panopticdiffusionmodels_torch.models import get_nnet
from panopticdiffusionmodels_torch.models.layers import Attention, Block, with_gelu
from panopticdiffusionmodels_torch.models.vae import get_model as get_vae
from panopticdiffusionmodels_torch.ops.attention import attention_qkv, multi_head_attention
from panopticdiffusionmodels_torch.ops.kernels import build
from panopticdiffusionmodels_torch.ops.kernels import fused_attention as fa
from panopticdiffusionmodels_torch.ops.kernels import fused_ln_qkv_attention as fl
from panopticdiffusionmodels_torch.ops.kernels import fused_qkv_attention as fqa
from panopticdiffusionmodels_torch.ops.kernels import ring_hop
from panopticdiffusionmodels_torch.parallel.mesh import InProcessSP
from panopticdiffusionmodels_torch.parallel.sharding import full, local
from panopticdiffusionmodels_torch.scripts import (
    bench,
    bench_fused_ln,
    convert_checkpoint,
    extract_empty_feature,
    extract_mscoco_feature,
    extract_test_prompt_feature,
)
from panopticdiffusionmodels_torch.serving import GenerationPipeline
from panopticdiffusionmodels_torch.train import checkpoint as ckpt_lib
from panopticdiffusionmodels_torch.train.state import TrainState, make_lr_schedule
from panopticdiffusionmodels_torch.train.trainer import Trainer
from panopticdiffusionmodels_torch.utils.weights import (
    load_torch_state_dict,
    reference_nnet_state_dict,
)

# H100 SXM dense peaks (NVIDIA data sheet): bf16 tensor cores, HBM3 bandwidth.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# (B, L, H, D): the serving path's two lengths at batch 2x4, U-ViT-L/2 and U-ViT-H,
# the training path's two lengths at batch 64, and ImageNet-256 serving
# (U-ViT-L/2, CFG 2x32).
# The pixel-space slice: U-ViT-M/4 ImageNet-64 serving (64 labels, 12 heads,
# L = 2 + 256), U-ViT-S/2 CIFAR-10 serving (32 images, L = 1 + 256, one row
# past 4 x 64) and its training at batch 128 (with lse).
# The UNet-family slice: U-ViT-H/2 serving at ImageNet-256 (CFG 2x32, 16
# heads of 72) on the mma.sync loop.
KERNEL_SHAPES = [(8, 334, 8, 64), (8, 590, 8, 64), (32, 258, 16, 64), (8, 258, 16, 72),
                 (64, 334, 8, 64), (64, 590, 8, 64), (64, 258, 16, 64),
                 (64, 258, 12, 64), (32, 257, 8, 64), (128, 257, 8, 64), (64, 258, 16, 72),
                 (32, 334, 12, 64)]
MAIN_PATH_SHAPES = KERNEL_SHAPES[:2]
TRAIN_SHAPES = KERNEL_SHAPES[4:6]
IMAGENET_SHAPE = KERNEL_SHAPES[6]
PIXEL_SHAPES = KERNEL_SHAPES[7:10]
HUGE_SHAPE = KERNEL_SHAPES[10]
MID_TRAIN_SHAPE = KERNEL_SHAPES[11]  # mscoco_uvit_mid training at batch 32, with lse
# Backward: the training shapes, U-ViT-L/2 and U-ViT-H, and two ragged short
# L (one partial tile; one row past a tile).
BWD_SHAPES = [(64, 334, 8, 64), (64, 590, 8, 64), (32, 258, 16, 64), (8, 258, 16, 72),
              (2, 37, 8, 64), (2, 65, 8, 64), (64, 258, 16, 64), (128, 257, 8, 64),
              (32, 258, 16, 72), (32, 334, 12, 64)]
# U-ViT-L/2 latent_discrete training at batch 64: the lse forward (phase 3's
# row IMAGENET_SHAPE) and the backward at this shape; CIFAR-10 pixel_sde
# training at batch 128 (phase 3's last row with lse, and the backward).
LATENT_TRAIN_SHAPE = BWD_SHAPES[6]
CIFAR_TRAIN_SHAPE = BWD_SHAPES[7]
HUGE_TRAIN_SHAPE = BWD_SHAPES[8]  # U-ViT-H/2's latent_discrete step at batch 32
MID_BWD_SHAPE = BWD_SHAPES[9]  # mscoco_uvit_mid's image-only step at batch 32
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
# Last, sp U-ViT-L/2 training's hop (phase 35): batch 64 folded to 128 rows,
# 258 / 2 = 129 tokens a shard, 16 heads (B, Lq, Lk, H).
HOP_SHAPES = [(16, 1063, 1063), (16, 551, 551), (16, 295, 295), (16, 167, 167),
              (2, 1063, 1063), (2, 1064, 1064), (2, 258, 258), (2, 295, 167),
              (128, 129, 129, 16)]
HOP_MAIN_SHAPES = HOP_SHAPES[:2]
SP_UVIT_HOP_SHAPE = HOP_SHAPES[8]
HOP_TIMED_SHAPES = HOP_MAIN_SHAPES + [SP_UVIT_HOP_SHAPE]
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
# Evaluation (`python -m panopticdiffusionmodels_torch eval`) of mscoco_uvit_small at
# full width and depth: 64 samples in the config's mini-batches of 32, 50 steps, CFG
# 1.0 (26 kernel-1 launches an NFE, the 2x batch one launch); a seeded Inception and
# reference stats of 64 seeded PNGs; the kernel-vs-plain pair at 6 steps.
EVAL_SAMPLES, EVAL_BATCH, EVAL_COMPARE_STEPS = 64, 32, 6
EVAL_LAUNCHES = EVAL_SAMPLES // EVAL_BATCH * LAUNCHES_PER_REQUEST
INCEPTION_IMAGES, INCEPTION_BATCH = 16, 50
# CLIP-L/14's text encoder (the t2i models' context) and CLIP-ViT-B/32 (the score),
# seeded random weights at the published shapes, with a byte-level vocabulary.
CLIP_L_TEXT = dict(vocab_size=49408, hidden_size=768, intermediate_size=3072,
                   num_hidden_layers=12, num_attention_heads=12, max_position_embeddings=77,
                   hidden_act="quick_gelu", layer_norm_eps=1e-5, eos_token_id=2)
CLIP_B32 = dict(text_config=dict(CLIP_L_TEXT, hidden_size=512, intermediate_size=2048,
                                 num_attention_heads=8),
                vision_config=dict(hidden_size=768, intermediate_size=3072, num_hidden_layers=12,
                                   num_attention_heads=12, image_size=224, patch_size=32,
                                   hidden_act="quick_gelu", layer_norm_eps=1e-5),
                projection_dim=512, logit_scale_init_value=2.6592)
PROMPTS = ["a red bus driving down a city street", "two cats sleeping on a sofa",
           "a plate of food with broccoli and rice", "a man riding a wave on a surfboard"]
CAPTION_CORPUS = " ".join(PROMPTS) + " a dog a train a kitchen with a table and chairs"
EVAL_CONFIG = '''"""mscoco_uvit_small at full width and depth on synthetic coco data, for
chip_smoke.py phase 20 (seeded weights, reference stats of seeded PNGs)."""
from panopticdiffusionmodels_torch.configs import get_config as zoo
from panopticdiffusionmodels_torch.configs.base import d


def get_config():
    config = zoo("mscoco_uvit_small")
    config.dataset = d(name="synthetic", n=128, z_shape=(32, 32, 8), clip_shape=(77, 768),
                       mask_size=64, fid_stat={stats!r})
    config.sample.update(n_samples={n}, mini_batch_size={bs}, sample_steps={steps})
    config.pretrained = ""
    config.nnet_path = {nnet!r}
    config.autoencoder.pretrained_path = {vae!r}
    config.num_workers = 4
    return config
'''


# The UNet family (PNDM, plain attention, no hand-written kernel): mscoco_unet
# requests of 4 CLIP contexts at 50 steps, 51 network calls of the 2x4 CFG batch;
# training at the config's batch of 8; mscoco_unet_512 one request of 1 context at
# the config's 30 steps (31 calls) and 3 + 5 steps at its batch of 1.
UNET_CONTEXTS, UNET_STEPS, UNET_CALLS = 4, 50, 51
UNET_512_STEPS, UNET_512_CALLS, UNET_512_TIMED = 30, 31, 5
# H100 SXM HBM bandwidth per AdamW + EMA parameter: p, g, m, v, ema read and p,
# m, v, ema written, f32.
OPT_BYTES_PER_PARAM = 36
# The rest of the zoo: a 6-step request through kernel 1 against the plain
# attention (config, requests' batch, kernel-1 launches an NFE).
ZOO_STEPS = 6
ZOO = [("mscoco_stable_diffusion", 4, 26), ("mscoco_uvit_mid", 4, 17),
       ("mscoco_uvit_large", 4, 42), ("imagenet256_uvit_huge", 32, 29),
       ("imagenet512_uvit_large", 8, 21), ("imagenet512_uvit_huge", 8, 29)]
# U-ViT-H/2 (imagenet256_uvit_huge): requests of 32 labels, 29 blocks x 50 NFE
# kernel-1 launches at HUGE_SHAPE; one latent_discrete step at batch 32.
HUGE_BLOCKS, HUGE_LABELS, HUGE_BATCH = 29, 32, 32
# Data-parallel training (phase 31): mscoco_uvit_small at batch 64 through
# DistributedDataParallel over NCCL at world 1, 20 steps of each arm timed in
# turns (blocks of DDP_BLOCK steps); synthetic_tiny over two gloo processes on
# the one card (NCCL refuses two ranks on one card) at a global batch of 16, 3
# steps, with one head of 64 so that its attention takes the kernels' tested
# wgmma loops: 5 blocks x 2 streams, one forward and one backward call each.
DDP_BATCH, DDP_TIMED, DDP_BLOCK = 64, 20, 5
TINY_WORLD, TINY_BATCH, TINY_STEPS, TINY_CALLS = 2, 16, 3, 10
# Remat policies (phase 32) on mscoco_uvit_small at batch 64, and the timed
# steps of each; the policies that replay the attention launch kernel 1 twice.
REMAT_POLICIES = [None, "nothing", "everything", "dots", "dots_no_batch", "save_attn"]
REMAT_KEEPS_ATTENTION = ("everything", "save_attn")
REMAT_TIMED = 5
# Image-only t2i (phase 34): mscoco_uvit_mid (U-ViT-M/2, 17 blocks, 12 heads of
# 64, L = 1 + 77 + 256 = 334) at the config's batch of 32.
MID_BLOCKS, MID_BATCH = 17, 32
# Sequence-parallel U-ViT-L/2 training (phase 35): latent_discrete at batch 64,
# mesh.sp = 2 in process, 21 ring attentions of 2 hops a step; 10 timed steps.
SP_UVIT_HOPS, SP_UVIT_TIMED = 2 * UVIT_L_BLOCKS, 10
# The data pipeline (phases 36a-c): a synthetic COCO tree of 128 JPEGs of 640 x
# 480 (and a val split of 8), 5 captions each and panoptic PNGs of 6 segments
# on an 80-pixel grid;
# COCO_CHECK images' features held card vs CPU; mscoco_uvit_small's steps on
# the native loader and the Python Loader in turns (COCO_ROUNDS x 2 blocks of
# COCO_BLOCK steps each), and the host's assembly of COCO_HOST_BATCHES batches.
COCO_IMAGES, COCO_W, COCO_H, COCO_SEGMENTS, COCO_CHECK = 128, 640, 480, 6, 2
COCO_VAL_IMAGES = 8
COCO_BLOCK, COCO_ROUNDS, COCO_HOST_BATCHES = 5, 2, 20
# FSDP over two gloo processes on the one card (phase 37): synthetic_tiny as
# phase 31b's, in f32, then mscoco_uvit_small at the global batch of 64 for 2 +
# FSDP_TIMED steps.
FSDP_WORLD, FSDP_TIMED = 2, 5


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
    try:  # the evaluation slice writes and reads PNGs through PIL, as the JAX package
        import PIL
        pil = f"PIL {PIL.__version__}"
    except ImportError:
        pil = "PIL absent"
    print(f"[1] card: {card_line()} | torch {torch.__version__} | CUDA {torch.version.cuda}"
          f" | nvcc: {nvcc} | devices {torch.cuda.device_count()} | {pil}")


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
    d = HOP_DIM
    scale = d ** -0.5
    for shape in HOP_SHAPES:
        b, lq, lk, h = (*shape, HOP_HEADS)[:4]
        c = h * d
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
        if shape in HOP_TIMED_SHAPES:
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
    # kernels only: operator rows carry the device time of the kernels they
    # launch, and a user annotation's device row (AdamW's `Optimizer.step#...`)
    # spans kernels that have rows of their own
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)
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


def parity_batch(trainer, batch_size):
    """The first `batch_size` samples of the trainer's dataset and numpy
    draws for them (seed 0)."""
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
    return batch, noise


def compare_steps(a, b, tag, what):
    """(loss, whole gradient) of two arms of one step: loss relative
    deviation < 5e-3 and whole-gradient relative deviation < 2e-2."""
    (ker_loss, ker_grad), (ref_loss, ref_grad) = a, b
    loss_rel = abs(ker_loss - ref_loss) / abs(ref_loss)
    grad_rel = rel_dev(ker_grad, ref_grad)
    print(f"[{tag}] {what}: loss {ker_loss:.6f} vs {ref_loss:.6f} (rel {loss_rel:.2e}, bar "
          f"5e-3), whole gradient rel {grad_rel:.2e} (bar 2e-2)")
    assert np.isfinite(ker_loss) and loss_rel < 5e-3, loss_rel
    assert torch.isfinite(ker_grad).all() and grad_rel < 2e-2, grad_rel
    return dict(loss_rel=loss_rel, grad_rel=grad_rel)


def phase_train_parity(trainer, batch_size, impls, tag):
    """One step through the kernels (impls[0]) and through the plain
    attention (impls[1]), same weights, batch and draws."""
    batch, noise = parity_batch(trainer, batch_size)
    out = {}
    for impl in impls:
        set_attn_impl(trainer.nnet, impl)
        metrics = trainer.loss_and_grads(batch, noise)
        out[impl] = (train_loss(metrics), grads_vector(trainer))
    set_attn_impl(trainer.nnet, impls[0])
    for p in trainer.state.params.values():
        p.grad = None
    compare_steps(out[impls[0]], out[impls[1]], tag,
                  f"train step B={batch_size}, attn_impl {impls[0]!r} vs {impls[1]!r}")


def phase_train(trainer, tag, per_step, warmup=WARMUP_STEPS, timed=TIMED_STEPS):
    """Trainer.fit: warm-up, then the timed steps with every launch counter
    zeroed just before and read just after; `per_step` is the launches each
    kernel must make a step (the others must make none)."""
    bsz = trainer.config.train.batch_size
    frozen = {n: trainer.state.params[n].detach().clone() for n in sorted(trainer.state.frozen)}
    assert frozen or not trainer.config.pretrained, "fine-tune mode froze nothing"
    trainer.fit(max_steps=warmup)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    history = trainer.fit(max_steps=warmup + timed)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    assert trainer.state.step == warmup + timed, trainer.state.step
    assert counts == {k: per_step.get(k, 0) * timed for k in counts}, counts
    losses = [train_loss(m) for m in history]
    assert losses and np.isfinite(losses).all(), losses
    assert all(torch.isfinite(p).all() for p in trainer.state.params.values())
    assert all(torch.equal(trainer.state.params[n], p) for n, p in frozen.items())
    result = dict(batch=bsz, steps=timed, wall_s=wall, steps_per_s=timed / wall,
                  images_per_s=timed * bsz / wall, step_ms=wall / timed * 1e3,
                  max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
                  launches=counts, logged_losses=losses,
                  frozen_params=len(trainer.state.frozen),
                  params=sum(p.numel() for p in trainer.state.params.values()))
    print(f"[{tag}] training: {json.dumps(result)}")
    return counts, wall / timed


def phase_train_profile(trainer, step_s, tag):
    stream = trainer.data_stream(start_step=trainer.state.step)
    batch = next(stream)
    device_profile(lambda: trainer.train_step(batch), tag,
                   f"train step (batch {trainer.config.train.batch_size})", step_s)


def make_trainer(name, tmp, mesh=None, pretrained=True, features=None):
    """`Trainer` for a zoo config at full width and depth in fine-tune mode (a
    seeded reference-format .pth, so the image stream is frozen), or from the
    seeded initialisation, on synthetic coco data at the config's shapes, or
    on the config's own dataset read from the feature root `features`."""
    config = get_config(name)
    h, w, c = config.z_shape
    m = config.nnet.mask_size
    if features:
        config.dataset.path = features
    else:
        config.dataset = d(name="synthetic", n=128, z_shape=(h, w, 2 * c),
                           clip_shape=(config.nnet.num_clip_token, config.nnet.clip_dim),
                           mask_size=m)
    config.train.log_interval = 5
    config.num_workers = 4
    config.mesh.update(mesh or {})
    config.pretrained = os.path.join(tmp, f"{name}.pth") if pretrained else ""
    if pretrained:
        os.makedirs(tmp, exist_ok=True)
        write_pretrained(config.pretrained, config)
    return Trainer(config, os.path.join(tmp, f"run_{name}"), device="cuda")


def make_latent_trainer(tmp, mesh=None):
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
    config.mesh.update(mesh or {})
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


class timed_calls:
    """Replace `attr` of each (owner, attr, key) by a wrapper that adds its
    host seconds to `self.s[key]` and its calls to `self.n[key]`; restored on
    exit."""

    def __init__(self, *targets):
        self.targets, self.s, self.n, self.saved = targets, {}, {}, []

    def __enter__(self):
        for owner, attr, key in self.targets:
            fn = getattr(owner, attr)
            self.saved.append((owner, attr, fn))
            self.s.setdefault(key, 0.0)
            self.n.setdefault(key, 0)

            def wrapper(*a, _fn=fn, _key=key, **k):
                t0 = time.perf_counter()
                try:
                    return _fn(*a, **k)
                finally:
                    self.s[_key] += time.perf_counter() - t0
                    self.n[_key] += 1

            setattr(owner, attr, wrapper)
        return self

    def __exit__(self, *exc):
        for owner, attr, fn in reversed(self.saved):
            setattr(owner, attr, fn)


def write_seeded_pngs(path: str, n: int, seed: int, hw: int = 256) -> None:
    """n smooth random RGB images (noise upsampled 16x) as PNGs, named 0..n-1."""
    os.makedirs(path, exist_ok=True)
    rng = np.random.default_rng(seed)
    low = torch.from_numpy(rng.uniform(size=(n, 3, hw // 16, hw // 16)).astype(np.float32))
    images = F.interpolate(low, size=(hw, hw), mode="bilinear").permute(0, 2, 3, 1).numpy()
    for i, img in enumerate(images):
        sampler_io.save_png(img, os.path.join(path, f"{i}.png"))


def write_eval_assets(tmp: str) -> dict:
    """Seeded files of phase 20: the network as a reference-format .pth, the
    VAE, a pt_inception-format state dict (with the `fc.*` head the loader
    drops) and reference stats from 64 seeded PNGs through that Inception."""
    config = get_config("mscoco_uvit_small")
    paths = {k: os.path.join(tmp, f) for k, f in (
        ("nnet", "nnet_ema.pth"), ("vae", "autoencoder_kl.pth"),
        ("inception", "pt_inception-2015-12-05.pth"), ("stats", "fid_stats_ref.npz"),
        ("config", "mscoco_uvit_small_eval.py"))}
    write_pretrained(paths["nnet"], config)
    torch.manual_seed(3)
    torch.save(get_vae(scale_factor=config.autoencoder.scale_factor).state_dict(), paths["vae"])
    sd = {k: torch.from_numpy(v) for k, v in inception.random_state_dict(0).items()}
    sd.update({"fc.weight": torch.zeros(1008, 2048), "fc.bias": torch.zeros(1008)})
    torch.save(sd, paths["inception"])
    write_seeded_pngs(os.path.join(tmp, "reference"), EVAL_SAMPLES, seed=11)
    extractor = inception.make_extractor(inception.load_inception_weights(paths["inception"]))
    fid.save_stats(paths["stats"], *fid.dir_statistics(os.path.join(tmp, "reference"),
                                                        extractor))
    with open(paths["config"], "w") as f:
        f.write(EVAL_CONFIG.format(stats=paths["stats"], n=EVAL_SAMPLES, bs=EVAL_BATCH,
                                   steps=STEPS, nnet=paths["nnet"], vae=paths["vae"]))
    return paths


def phase_eval(tmp: str):
    """`cli.main(["eval", ...])` in process on mscoco_uvit_small at full width
    and depth: 64 samples in 2 mini-batches of 32, 50 steps, CFG 1.0, the
    trainer's sampler through kernel 1, the seeded VAE decode, sample2dir,
    Inception on the card and FID against the seeded stats.  The launch
    counters are zeroed just before and read just after: exactly 2600
    kernel-1 launches and none of the others.  Then a 6-step mini-batch of
    `build_sample_fn` through kernel 1 against the plain attention on the
    same draws (images < 2e-2, mask < 5e-2), and one mini-batch under the
    profiler."""
    paths = write_eval_assets(tmp)
    wd = os.path.join(tmp, "eval")
    spans, captured = [], {}
    build = Trainer.build_sample_fn

    def timed_build(self, *a, **k):  # CUDA events around each sampler call
        fn = build(self, *a, **k)
        captured["trainer"] = self

        def sample_fn(*fa, **fk):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*fa, **fk)
            end.record()
            spans.append((start, end))
            return out

        return sample_fn

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    Trainer.build_sample_fn = timed_build
    try:
        with timed_calls((Trainer, "__init__", "trainer"),
                         (runner, "_load_weights", "load_weights"),
                         (inception, "load_inception_weights", "inception_load"),
                         (inception, "make_extractor", "inception_load"),
                         (sampler_io, "save_uint8_png", "write"),
                         (sampler_io, "mask_ids", "decode"),
                         (sampler_io, "color_map", "decode"),
                         (sampler_io, "eval_mask_cnt", "decode"),
                         (fid, "dir_statistics", "inception"),
                         (fid.linalg, "sqrtm", "sqrtm")) as t:
            zero_counts()
            t0 = time.perf_counter()
            metrics = cli.main(["eval", f"--config={paths['config']}", f"--workdir={wd}",
                                f"--inception={paths['inception']}"])
            wall = time.perf_counter() - t0
            counts = read_counts()
    finally:
        Trainer.build_sample_fn = build
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 1e9
    assert counts == {k: EVAL_LAUNCHES if k == "fused_attention_qkv" else 0
                      for k in counts}, counts
    assert set(metrics) == {"eval_loss_mask", "eval_cnt_mask_diff", "fid"}, metrics
    assert all(np.isfinite(v) for v in metrics.values()), metrics
    names = {f"{i}.png" for i in range(EVAL_SAMPLES)}
    for sub in ("samples", "mask"):
        assert set(os.listdir(os.path.join(wd, sub))) == names, sub
    with open(os.path.join(wd, "eval.log")) as f:
        log = f.read()
    assert f"fid{EVAL_SAMPLES}=" in log, log
    sampling_s = sum(a.elapsed_time(b) for a, b in spans) / 1e3
    result = dict(samples=EVAL_SAMPLES, mini_batch=EVAL_BATCH, steps=STEPS, metrics=metrics,
                  launches=counts["fused_attention_qkv"], wall_s=wall,
                  sampling_device_s=sampling_s, sampler_calls=len(spans),
                  mask_decode_s=t.s["decode"], png_write_s=t.s["write"],
                  inception_s=t.s["inception"],
                  inception_images_per_s=EVAL_SAMPLES / t.s["inception"],
                  sqrtm_s=t.s["sqrtm"], sqrtm_calls=t.n["sqrtm"],
                  trainer_init_s=t.s["trainer"], load_weights_s=t.s["load_weights"],
                  inception_load_s=t.s["inception_load"],
                  # host seconds inside none of the timed calls: enqueueing the
                  # sampler, the context stream, the logs and whatever else
                  untimed_host_s=wall - sum(t.s.values()),
                  max_memory_allocated_gb=peak)
    print(f"[20] evaluation: {json.dumps(result)}")

    trainer = captured["trainer"]
    pipe = trainer.sample_pipeline()
    ctx = np.stack([trainer.dataset.test[i][1] for i in range(EVAL_BATCH)])
    z, m0 = runner._draw(trainer, EVAL_BATCH, torch.Generator(device="cuda").manual_seed(29))
    fn = trainer.build_sample_fn(EVAL_COMPARE_STEPS)
    outs = {}
    for impl in ("kernel", "plain"):
        set_attn_impl(pipe.nnet, impl)
        outs[impl] = fn(ctx, z, m0)
    set_attn_impl(pipe.nnet, "infer")
    for i, (name, bar) in enumerate((("images", 2e-2), ("mask", 5e-2))):
        a, b = outs["kernel"][i], outs["plain"][i]
        rel = rel_dev(a, b)
        print(f"[20] {EVAL_COMPARE_STEPS}-step evaluation mini-batch of {EVAL_BATCH}, {name}: "
              f"kernel vs plain rel {rel:.2e} (bar {bar:.0e})")
        assert torch.isfinite(a).all() and rel < bar, (name, rel)
    assert outs["kernel"][0].shape == (EVAL_BATCH, 256, 256, 3), outs["kernel"][0].shape
    fn = trainer.build_sample_fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(ctx, z, m0)
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t0
    busy = device_profile(lambda: fn(ctx, z, m0), "20", f"evaluation mini-batch of {EVAL_BATCH}",
                          batch_s)
    result.update(unprofiled_batch_s=batch_s, device_busy_ms=busy,
                  device_busy_share=busy / (batch_s * 1e3))
    print(f"[20] sampling busy share: {busy / (batch_s * 1e3):.1%} of {batch_s:.3f} s")
    del trainer, pipe, captured
    torch.cuda.empty_cache()
    return paths, os.path.join(wd, "samples"), result


def phase_inception(paths):
    """The Inception extractor on the card against the same module on the CPU,
    f32 with TF32 off: 16 images 256 -> 299 (relative deviation < 1e-3);
    images/s at batch 50 (CUDA events)."""
    x = np.random.default_rng(31).uniform(size=(INCEPTION_IMAGES, 256, 256, 3))
    x = x.astype(np.float32)
    card = inception.make_extractor(inception.load_inception_weights(paths["inception"]))
    cpu = inception.make_extractor(inception.load_inception_weights(paths["inception"]), "cpu")
    a, b = card(x), cpu(x)
    rel = rel_dev(a.cpu(), b)
    print(f"[21] Inception pool3 of {INCEPTION_IMAGES} images 256 -> 299, card vs CPU: rel "
          f"{rel:.2e} (bar 1e-3)")
    assert a.shape == (INCEPTION_IMAGES, 2048) and torch.isfinite(a).all() and rel < 1e-3, rel
    batch = torch.rand((INCEPTION_BATCH, 256, 256, 3), device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(37))
    ms = cuda_ms(lambda: card(batch), iters=10, warmup=2)
    rate = INCEPTION_BATCH / ms * 1e3
    print(f"[21] Inception at batch {INCEPTION_BATCH} (256 -> 299, f32, TF32 off): {ms:.2f} ms "
          f"a batch, {rate:.0f} images/s")
    return dict(rel=rel, batch_ms=ms, images_per_s=rate)


def write_clip_dir(path: str, config: dict, seed: int, text_only: bool) -> None:
    """A local CLIP directory: byte-level vocab.json / merges.txt, config.json
    and seeded random pytorch_model.bin (a text tower, or a whole CLIPModel)."""
    n = clip.write_synthetic_vocab(path, CAPTION_CORPUS, 256)
    assert n < 49408, n
    torch.manual_seed(seed)
    if text_only:
        sd = {f"text_model.{k}": v for k, v in clip.CLIPTextTransformer(config).state_dict().items()}
    else:
        sd = clip.CLIPModel(config).state_dict()
    torch.save(sd, os.path.join(path, "pytorch_model.bin"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f)


def phase_prompts(tmp: str, contexts_latency: float):
    """A FrozenCLIPEmbedder at CLIP-L/14's shape (12 layers, width 768, 12
    heads, vocabulary 49,408, 77 positions) on the card against the CPU
    (last_hidden_state < 1e-3 relative); then
    GenerationPipeline.from_config("mscoco_uvit_small", clip_path=...)
    answers generate(prompts=[4 prompts]) at 50 steps with the counters zeroed
    just before and read just after: exactly 1300 kernel-1 launches."""
    path = os.path.join(tmp, "clip-vit-large-patch14")
    write_clip_dir(path, CLIP_L_TEXT, seed=41, text_only=True)
    a = clip.FrozenCLIPEmbedder(path).encode(PROMPTS)
    b = clip.FrozenCLIPEmbedder(path, device="cpu").encode(PROMPTS)
    rel = rel_dev(a.cpu(), b)
    print(f"[22] CLIP-L/14 text encoder, {len(PROMPTS)} prompts: card vs CPU rel {rel:.2e} "
          "(bar 1e-3)")
    assert a.shape == (len(PROMPTS), 77, 768) and torch.isfinite(a).all() and rel < 1e-3, rel
    pipe = GenerationPipeline.from_config("mscoco_uvit_small", seed=0, clip_path=path)
    pipe.generate(prompts=PROMPTS, steps=3)  # warm-up
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    images, ids = pipe.generate(prompts=PROMPTS, steps=STEPS, seed=3)
    latency = time.perf_counter() - t0
    counts = read_counts()
    assert counts == {k: LAUNCHES_PER_REQUEST if k == "fused_attention_qkv" else 0
                      for k in counts}, counts
    assert images.shape == (len(PROMPTS), 256, 256, 3) and np.isfinite(images).all()
    assert ids.shape == (len(PROMPTS), 64, 64, 1)
    ctx = pipe.encode_prompts(PROMPTS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe.generate(contexts=ctx, steps=STEPS, seed=3)
    same_pipe = time.perf_counter() - t0
    encode = cuda_ms(lambda: pipe.encode_prompts(PROMPTS), iters=5, warmup=1)
    result = dict(prompts=len(PROMPTS), steps=STEPS, launches=counts["fused_attention_qkv"],
                  prompts_latency_s=latency, contexts_latency_same_pipeline_s=same_pipe,
                  phase5_contexts_latency_s=contexts_latency, encode_ms=encode, rel=rel)
    print(f"[22] prompts request: {json.dumps(result)}")
    return counts["fused_attention_qkv"], result


def phase_clip_score(tmp: str, sample_dir: str):
    """A random CLIP-ViT-B/32 (vision 12 layers of 768, patch 32 at 224; text
    12 layers of 512; projection 512) scores phase 20's 64 images against 64
    caption files (`{i}_0_text.txt`): a finite score, card vs CPU < 1e-3
    relative."""
    path = os.path.join(tmp, "clip-vit-base-patch32")
    write_clip_dir(path, CLIP_B32, seed=43, text_only=False)
    captions = os.path.join(tmp, "captions")
    os.makedirs(captions)
    words = CAPTION_CORPUS.split()
    rng = np.random.default_rng(47)
    for i in range(EVAL_SAMPLES):
        with open(os.path.join(captions, f"{i}_0_text.txt"), "w") as f:
            f.write(" ".join(rng.choice(words, size=8)) + "\n")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = clip_score.clip_score_from_dirs(sample_dir, captions, version=path)
    card_s = time.perf_counter() - t0
    cpu = clip_score.clip_score_from_dirs(sample_dir, captions, version=path, device="cpu")
    rel = abs(card - cpu) / abs(cpu)
    print(f"[23] CLIP score (ViT-B/32, random) of {EVAL_SAMPLES} samples: card {card:.6f}, "
          f"CPU {cpu:.6f}, rel {rel:.2e} (bar 1e-3), {card_s:.2f} s on the card with the load")
    assert np.isfinite(card) and rel < 1e-3, (card, cpu)
    return dict(score=card, cpu_score=cpu, rel=rel, card_s=card_s)


def open_mask_gate(model: torch.nn.Module, seed: int) -> None:
    """Seeded non-zero values in the UNet's zero-initialised mask gate, so the
    mask encoder reaches the image path."""
    g = torch.Generator().manual_seed(seed)
    gate = model.mask_zero_gate
    with torch.no_grad():
        gate.weight.copy_(torch.randn(gate.weight.shape, generator=g) * 0.02)
        gate.bias.copy_(torch.randn(gate.bias.shape, generator=g) * 0.02)


class call_counter:
    """Counts the forward calls of `module` and the batch size of each."""

    def __init__(self, module: torch.nn.Module):
        self.batches = []
        self.handle = module.register_forward_hook(
            lambda mod, args, out: self.batches.append(args[0].shape[0]))

    def close(self) -> None:
        self.handle.remove()


def unet_inputs(b: int, sample: int, mask: int, gen, device):
    x = torch.randn((b, 4, sample, sample), generator=gen, device=device)
    t = torch.rand((b,), generator=gen, device=device) * 1000
    ctx = torch.randn((b, 77, 768), generator=gen, device=device)
    m = torch.randn((b, 8, mask, mask), generator=gen, device=device)
    return x, t, ctx, m


def phase_unet_forward():
    """mscoco_unet's UNet2DCondition at full width (860.6 M parameters) with
    seeded weights and an open mask gate: the card in f32 with TF32 off
    against the CPU in f32 at B = 2 (relative deviation < 1e-3 on noise and
    mask); the bf16 network against f32 on the card at B = 8 (printed); the
    GEMM / conv / attention operations of one bf16 forward at B = 8 (the
    serving batch) by `FlopCounterMode`, for phase 26's bound."""
    from torch.utils.flop_counter import FlopCounterMode

    kw = dict(get_config("mscoco_unet").nnet)
    torch.manual_seed(4)
    model = get_nnet(kw.pop("name"), **kw).eval()
    open_mask_gate(model, 5)
    n_params = sum(p.numel() for p in model.parameters())
    card = card_line()
    x, t, ctx, m = unet_inputs(2, 32, 64, torch.Generator().manual_seed(11), "cpu")
    t0 = time.perf_counter()
    with torch.no_grad():
        ref = model(x, t, ctx, mask_token=m)
    cpu_s = time.perf_counter() - t0
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        model.to("cuda")
        with torch.no_grad():
            out = model(x.cuda(), t.cuda(), ctx.cuda(), mask_token=m.cuda())
            torch.cuda.synchronize()
            for name, a, b in zip(("noise", "mask"), out, ref):
                rel = rel_dev(a.cpu(), b)
                print(f"[25] UNet2DCondition ({n_params} parameters) forward B=2, {name}: card "
                      f"f32 (TF32 off) vs CPU f32 rel {rel:.2e} (bar 1e-3); CPU {cpu_s:.2f} s "
                      f"({card})")
                assert torch.isfinite(a).all() and rel < 1e-3, (name, rel)
            gen = torch.Generator(device="cuda").manual_seed(12)
            x8, t8, ctx8, m8 = unet_inputs(2 * UNET_CONTEXTS, 32, 64, gen, "cuda")
            f32 = model(x8, t8, ctx8, mask_token=m8)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    model.to(torch.bfloat16)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        bf16 = model(x8, t8, ctx8, mask_token=m8)
    flops = counter.get_total_flops()
    for name, a, b in zip(("noise", "mask"), bf16, f32):
        print(f"[25] UNet forward B={2 * UNET_CONTEXTS}, {name}: bf16 vs f32 on the card rel "
              f"{rel_dev(a, b):.2e} ({card})")
        assert torch.isfinite(a).all()
    print(f"[25] one bf16 forward at B={2 * UNET_CONTEXTS}: {flops / 1e12:.3f} TFLOP of GEMMs, "
          f"convolutions and attention (FlopCounterMode), {flops / 8 / 1e9:.1f} GFLOP an image")
    return flops, n_params


def phase_unet_serving(flops_b8: float):
    """GenerationPipeline.from_config("mscoco_unet"): seeded weights, bf16
    network, f32 VAE, PNDM with CFG 1.0 as one 2x batch.  1 warm-up, then 3
    requests of 4 CLIP contexts at 50 steps with every launch counter zeroed
    just before and read just after: exactly 51 network calls of batch 8 a
    request and no launch of the five kernels (the UNet's attention is the
    plain one, as in JAX); latency, images/s and peak memory beside the
    operations bound of 51 forwards; one request under the profiler."""
    t0 = time.perf_counter()
    pipe = GenerationPipeline.from_config("mscoco_unet", seed=0)
    build_s = time.perf_counter() - t0
    assert pipe.pndm and pipe.panoptic and pipe.dtype == torch.bfloat16
    assert next(pipe.vae.parameters()).dtype == torch.float32
    rng = np.random.default_rng(3)
    contexts = [rng.standard_normal((UNET_CONTEXTS, 77, 768)).astype(np.float32)
                for _ in range(REQUESTS + 1)]
    t0 = time.perf_counter()
    pipe.generate(contexts=contexts[0], steps=UNET_STEPS, seed=99)  # warm-up
    warmup_s = time.perf_counter() - t0
    calls = call_counter(pipe.nnet)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    latencies = []
    for i in range(REQUESTS):
        n0 = len(calls.batches)
        t0 = time.perf_counter()
        images, ids = pipe.generate(contexts=contexts[i + 1], steps=UNET_STEPS, seed=i)
        latencies.append(time.perf_counter() - t0)
        assert calls.batches[n0:] == [2 * UNET_CONTEXTS] * UNET_CALLS, calls.batches[n0:]
        assert pipe.last_real_evals == UNET_CALLS, pipe.last_real_evals
        assert images.shape == (UNET_CONTEXTS, 256, 256, 3), images.shape
        assert np.isfinite(images).all() and images.min() >= 0 and images.max() <= 1
        assert ids.shape == (UNET_CONTEXTS, 64, 64, 1) and ids.min() >= 0 and ids.max() < 256
    counts = read_counts()
    calls.close()
    assert not any(counts.values()), counts
    bound_ms = bound(0, flops_b8 * UNET_CALLS)[0]
    result = dict(requests=REQUESTS, contexts_per_request=UNET_CONTEXTS, steps=UNET_STEPS,
                  network_calls_per_request=UNET_CALLS, launches=counts, latency_s=latencies,
                  mean_latency_s=float(np.mean(latencies)),
                  images_per_s=REQUESTS * UNET_CONTEXTS / sum(latencies),
                  max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
                  network_bound_ms=bound_ms, network_tflop=flops_b8 * UNET_CALLS / 1e12,
                  from_config_s=build_s, warmup_request_s=warmup_s, card=card_line())
    print(f"[26] mscoco_unet serving (PNDM): {json.dumps(result)}")
    busy = device_profile(lambda: pipe.generate(contexts=contexts[0], steps=UNET_STEPS, seed=9),
                          "26", f"mscoco_unet request ({UNET_CONTEXTS} contexts)",
                          min(latencies))
    print(f"[26] device busy {busy:.1f} ms against the network's operations bound "
          f"{bound_ms:.1f} ms ({bound_ms / busy:.1%} of the busy time)")
    return result


def make_unet_trainer(tmp, name, n):
    """`Trainer` for a UNet config at full width from the seeded
    initialisation (an LDM checkpoint of this model is 3.4 GB in f32; its
    load is held on the CPU) on `n` synthetic SD-feature coco samples."""
    config = get_config(name)
    h, w, c = config.z_shape
    config.dataset = d(name="synthetic", n=n, z_shape=(h, w, 2 * c),
                       clip_shape=(config.nnet.num_clip_token, config.nnet.clip_dim),
                       mask_size=config.nnet.mask_size)
    config.train.log_interval = 5
    config.num_workers = 4
    trainer = Trainer(config, os.path.join(tmp, f"run_{name}"), device="cuda")
    assert trainer.is_unet and not trainer.state.frozen and not config.pretrained
    return trainer


def phase_unet_train(tmp):
    """mscoco_unet training at the config's batch of 8 (bf16 autocast over f32
    master weights, AdamW + EMA): 3 warm-up and 20 timed steps with no kernel
    launch, finite losses; the device time of AdamW + EMA alone (CUDA events
    around `apply_gradients`) beside its bytes bound; one step under the
    profiler."""
    trainer = make_unet_trainer(tmp, "mscoco_unet", 64)
    counts, step_s = phase_train(trainer, "27", {})
    n_params = sum(p.numel() for p in trainer.state.params.values())
    batch = next(trainer.data_stream(start_step=trainer.state.step))
    opt_ms = []
    for _ in range(3):
        trainer.loss_and_grads(batch)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        trainer.state.apply_gradients(ema_rate=trainer.config.get("ema_rate", 0.9999))
        end.record()
        torch.cuda.synchronize()
        opt_ms.append(start.elapsed_time(end))
    opt_bound = bound(OPT_BYTES_PER_PARAM * n_params, 0)[0]
    print(f"[27] AdamW + EMA over {n_params} f32 parameters: {float(np.median(opt_ms)):.2f} ms "
          f"of device time (median of {opt_ms}), {float(np.median(opt_ms)) / (step_s * 1e3):.1%} "
          f"of the {step_s * 1e3:.1f} ms step; bytes bound {opt_bound:.2f} ms ({card_line()})")
    busy = device_profile(lambda: trainer.train_step(batch), "27",
                          f"mscoco_unet train step (batch {trainer.config.train.batch_size})",
                          step_s)
    print(f"[27] AdamW + EMA {float(np.median(opt_ms)) / busy:.1%} of the profiled step's "
          f"device time {busy:.1f} ms")
    return dict(step_ms=step_s * 1e3, opt_ms=float(np.median(opt_ms)), opt_bound_ms=opt_bound)


def phase_unet_512(tmp):
    """mscoco_unet_512 (64^2 latents, L = 4096 at the first level, plain
    attention): one request of 1 context at the config's 30 steps (31 calls of
    the 2x1 batch, no kernel launch), then 3 warm-up and 5 timed steps at the
    config's batch of 1: latency, step time, peak memory."""
    pipe = GenerationPipeline.from_config("mscoco_unet_512", seed=0)
    assert pipe.config.sample.sample_steps == UNET_512_STEPS
    context = np.random.default_rng(4).standard_normal((1, 77, 768)).astype(np.float32)
    pipe.generate(contexts=context, steps=2, seed=98)  # warm-up
    calls = call_counter(pipe.nnet)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    images, ids = pipe.generate(contexts=context, steps=UNET_512_STEPS, seed=0)
    latency = time.perf_counter() - t0
    counts = read_counts()
    calls.close()
    assert calls.batches == [2] * UNET_512_CALLS, calls.batches
    assert not any(counts.values()), counts
    assert images.shape == (1, 512, 512, 3) and np.isfinite(images).all(), images.shape
    assert ids.shape == (1, 128, 128, 1), ids.shape
    print(f"[28] mscoco_unet_512 request of 1 context at {UNET_512_STEPS} steps "
          f"({UNET_512_CALLS} calls): {latency:.3f} s, peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB, kernel launches {counts} "
          f"({card_line()})")
    del pipe
    torch.cuda.empty_cache()
    trainer = make_unet_trainer(tmp, "mscoco_unet_512", 16)
    phase_train(trainer, "28", {}, timed=UNET_512_TIMED)
    return latency


def phase_zoo():
    """The rest of the zoo on kernel 1: for each config a 6-step request of
    its batch through the kernel against the same request through the plain
    attention on the same draws (images < 2e-2, masks < 5e-2), with every
    launch counter zeroed just before and read just after each: exactly
    blocks x 6 kernel-1 launches through the kernel, none through the plain
    attention.  Returns the imagenet256_uvit_huge pipeline for phase 30."""
    huge = None
    launches = {}
    for name, n, blocks in ZOO:
        pipe = GenerationPipeline.from_config(name, seed=0)
        gen = torch.Generator(device="cuda").manual_seed(13)
        if pipe.is_t2i:
            cond = torch.randn((n, 77, 768), generator=gen, device="cuda")
        else:
            cond = torch.randint(0, 1000, (n,), generator=gen, device="cuda")
        z, m0 = pipe._draw(n, gen)
        outs, counts = {}, {}
        for impl in ("kernel", "plain"):
            set_attn_impl(pipe.nnet, impl)
            torch.cuda.synchronize()
            zero_counts()
            outs[impl] = pipe.sample(z, m0, cond, steps=ZOO_STEPS)
            torch.cuda.synchronize()
            counts[impl] = read_counts()
        set_attn_impl(pipe.nnet, "infer")
        want = {"fused_attention_qkv": blocks * ZOO_STEPS}
        assert counts["kernel"] == {k: want.get(k, 0) for k in counts["kernel"]}, counts
        assert not any(counts["plain"].values()), counts
        hw = 8 * pipe.z_shape[0]
        assert outs["kernel"][0].shape == (n, 3, hw, hw), outs["kernel"][0].shape
        rels = []
        for i, (what, bar) in enumerate((("images", 2e-2), ("mask", 5e-2))):
            if outs["kernel"][i] is None:
                continue
            rel = rel_dev(outs["kernel"][i], outs["plain"][i])
            rels.append(f"{what} {rel:.2e} (bar {bar:.0e})")
            assert torch.isfinite(outs["kernel"][i]).all() and rel < bar, (name, what, rel)
        launches[name] = counts["kernel"]["fused_attention_qkv"]
        print(f"[29] {name}: {ZOO_STEPS}-step request of {n} at {hw}x{hw}, kernel vs plain "
              f"{', '.join(rels)}; {launches[name]} kernel-1 launches ({blocks} x {ZOO_STEPS}) "
              f"({card_line()})")
        if name == "imagenet256_uvit_huge":
            huge = pipe
        del pipe
        torch.cuda.empty_cache()
    return huge, launches


def phase_uvit_huge(pipe, tmp):
    """U-ViT-H/2 (imagenet256_uvit_huge, 16 heads of 72): 1 warm-up and 3
    requests of 32 labels at 50 steps, CFG 0.4, with every launch counter
    zeroed just before and read just after: exactly 1450 kernel-1 launches a
    request, each at (64, 258, 16, 72); then one latent_discrete step at batch
    32 through kernels 1 and 2 against the plain attention (loss < 5e-3,
    whole gradient < 2e-2) with exactly 29 forward and 29 backward kernel
    calls."""
    assert pipe.class_cond and float(pipe.config.sample.scale) == 0.4
    labels = np.random.default_rng(5).integers(0, 1000, size=(REQUESTS + 1, HUGE_LABELS))
    seen = set()
    attns = [m for m in pipe.nnet.modules() if isinstance(m, Attention)]
    for m in attns:
        m.attend = (lambda f: lambda qkv: seen.add(tuple(qkv.shape[:2])) or f(qkv))(m.attend)
    pipe.generate(labels=labels[0], steps=STEPS, seed=99)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    latencies = []
    per_request = HUGE_BLOCKS * STEPS
    for i in range(REQUESTS):
        t0 = time.perf_counter()
        images = pipe.generate(labels=labels[i + 1], steps=STEPS, seed=i)
        latencies.append(time.perf_counter() - t0)
        assert fqa.launches == (i + 1) * per_request, (i, fqa.launches)
        assert images.shape == (HUGE_LABELS, 256, 256, 3), images.shape
        assert np.isfinite(images).all() and images.min() >= 0 and images.max() <= 1
    counts = read_counts()
    for m in attns:
        del m.attend
    want = {"fused_attention_qkv": REQUESTS * per_request}
    assert counts == {k: want.get(k, 0) for k in counts}, counts
    b, l, h, dh = HUGE_SHAPE
    assert seen == {(b, l)} and attns[0].num_heads == h, (seen, attns[0].num_heads)
    result = dict(requests=REQUESTS, labels_per_request=HUGE_LABELS, steps=STEPS, cfg_scale=0.4,
                  launches=counts["fused_attention_qkv"], kernel_shape=list(HUGE_SHAPE),
                  latency_s=latencies, mean_latency_s=float(np.mean(latencies)),
                  images_per_s=REQUESTS * HUGE_LABELS / sum(latencies),
                  max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
                  card=card_line())
    print(f"[30] U-ViT-H/2 ImageNet-256 serving: {json.dumps(result)}")

    config = get_config("imagenet256_uvit_huge")
    h_, w_, c_ = config.z_shape
    config.dataset = d(name="synthetic", style="imagenet", n=2 * HUGE_BATCH,
                       z_shape=(h_, w_, 2 * c_), num_classes=1000)
    config.train.batch_size = HUGE_BATCH
    config.num_workers = 0
    trainer = Trainer(config, os.path.join(tmp, "run_imagenet256_uvit_huge"), device="cuda")
    torch.cuda.synchronize()
    zero_counts()
    phase_train_parity(trainer, HUGE_BATCH, ("auto", "plain"), "30")
    torch.cuda.synchronize()
    train_counts = read_counts()
    want = {"fused_attention_qkv": HUGE_BLOCKS, "fused_attention_qkv_vjp": HUGE_BLOCKS}
    assert train_counts == {k: want.get(k, 0) for k in train_counts}, train_counts
    print(f"[30] U-ViT-H/2 latent_discrete step B={HUGE_BATCH}: {train_counts} ({card_line()})")
    return counts["fused_attention_qkv"], train_counts



def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def run_children(calls, timeout: int = 300) -> list:
    """Run each `chip_smoke.<call>` in a child process of its own, all at
    once, from this file's directory; returns their stdouts, raising with
    every log if one failed."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [here, os.environ.get("PYTHONPATH", "")])))
    procs = [subprocess.Popen([sys.executable, "-c", f"import chip_smoke as c; c.{call}"],
                              cwd=here, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for call in calls]
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    return logs


@contextlib.contextmanager
def attn_impl(model: torch.nn.Module, impl: str):
    set_attn_impl(model, impl)
    yield


@contextlib.contextmanager
def single_process(trainer):
    """The trainer's step without its data-parallel wrapper (the reducer
    ignores a backward whose forward did not go through it)."""
    saved = trainer.model, trainer.dp
    trainer.model, trainer.dp = trainer.nnet, None
    try:
        yield
    finally:
        trainer.model, trainer.dp = saved


def step_blocks(trainer, arms: dict, order: str, steps: int) -> dict:
    """Time `steps`-step blocks of `trainer.train_step` on the trainer's own
    stream under each arm's context, in the given order of arm letters;
    returns the median ms a step of each arm and the spread."""
    stream = trainer.data_stream(start_step=trainer.state.step)
    times = {k: [] for k in arms}
    for arm in order:
        with arms[arm]():
            trainer.train_step(next(stream))  # the arm's first step is not timed
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                trainer.train_step(next(stream))
            torch.cuda.synchronize()
        times[arm].append((time.perf_counter() - t0) / steps * 1e3)
    return {k: dict(step_ms=float(np.median(v)), spread=[min(v), max(v)])
            for k, v in times.items()}


def ddp_world1_child(tmp: str, port: int, out: str) -> None:
    """Phase 31a in a child process: mscoco_uvit_small at batch 64, fine-tune
    mode, through DistributedDataParallel over NCCL at world 1, against the
    same trainer without the wrapper on the same batch and draws; then 20
    steps of each, timed in turns.  Writes the result as JSON to `out`."""
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=1,
                            rank=0, device_id=torch.device("cuda", 0))
    try:
        trainer = make_trainer("mscoco_uvit_small", tmp)
        assert trainer.dp is not None and trainer.dp.world_size == 1
        assert isinstance(trainer.model, torch.nn.parallel.DistributedDataParallel)
        batch, noise = parity_batch(trainer, DDP_BATCH)
        arms = {}
        for arm, ctx in (("ddp", contextlib.nullcontext), ("single", single_process)):
            with ctx(trainer):
                zero_counts()
                metrics = trainer.loss_and_grads(batch, noise)
                torch.cuda.synchronize()
                arms[arm] = (train_loss(metrics), grads_vector(trainer), read_counts())
        for k, n in arms["ddp"][2].items():
            want = LAUNCHES_PER_STEP if k in ("fused_attention_qkv",
                                              "fused_attention_qkv_vjp") else 0
            assert n == want, arms["ddp"][2]
        parity = compare_steps(arms["ddp"][:2], arms["single"][:2], "31a",
                               f"DDP (NCCL, world 1) vs one process, B={DDP_BATCH}")
        timing = step_blocks(trainer, {"D": contextlib.nullcontext,
                                       "S": lambda: single_process(trainer)},
                             "DSSD" * (DDP_TIMED // DDP_BLOCK // 2), DDP_BLOCK)
        with open(out, "w") as f:
            json.dump(dict(parity, launches=arms["ddp"][2], ddp=timing["D"],
                           single=timing["S"]), f)
    finally:
        dist.destroy_process_group()


def tiny_cuda_config():
    """synthetic_tiny on the card: bf16 autocast (the kernels take bf16), one
    head of 64, a checkpoint and a log line every step."""
    config = get_config("synthetic_tiny")
    config.compute_dtype = "bfloat16"
    config.nnet.update(embed_dim=64, num_heads=1)
    config.num_workers = 0
    config.train.update(batch_size=TINY_BATCH, n_steps=TINY_STEPS, save_interval=1,
                        log_interval=1)
    return config


def ddp_gloo_child(rank: int, port: int, tmp: str) -> None:
    """Phase 31b: one of two processes on the one card over gloo, training
    synthetic_tiny through `fit` in its own workdir `tmp/wd{rank}`; writes
    its parameters, launch counts and step time to `tmp/rank{rank}.pt`."""
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=TINY_WORLD, rank=rank)
    try:
        trainer = Trainer(tiny_cuda_config(), os.path.join(tmp, f"wd{rank}"), device="cuda:0")
        assert trainer.dp.world_size == TINY_WORLD and trainer.is_main == (rank == 0)
        zero_counts()
        t0 = time.perf_counter()
        trainer.fit()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        torch.save(dict(params={n: p.detach().cpu() for n, p in trainer.state.params.items()},
                        launches=read_counts(), step_ms=wall / TINY_STEPS * 1e3,
                        step=trainer.state.step), os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def phase_ddp(tmp: str):
    """31a: DDP at world 1 over NCCL against one process (a child process,
    so that no process group outlives it here); 31b: two gloo processes on
    the one card against one process at their global batch."""
    out = os.path.join(tmp, "ddp_world1.json")
    run_children([f"ddp_world1_child({tmp!r}, {free_port()}, {out!r})"], timeout=600)
    with open(out) as f:
        a = json.load(f)
    print(f"[31a] DDP over NCCL at world 1, mscoco_uvit_small B={DDP_BATCH}: step "
          f"{a['ddp']['step_ms']:.2f} ms {fmt_spread(a['ddp']['spread'])} vs one process "
          f"{a['single']['step_ms']:.2f} ms {fmt_spread(a['single']['spread'])} "
          f"(x{a['ddp']['step_ms'] / a['single']['step_ms']:.3f}); loss rel {a['loss_rel']:.2e}, "
          f"gradient rel {a['grad_rel']:.2e}; launches a step {a['launches']} ({card_line()})")

    port = free_port()
    run_children([f"ddp_gloo_child({r}, {port}, {tmp!r})" for r in range(TINY_WORLD)])
    ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=True)
             for r in range(TINY_WORLD)]
    single = Trainer(tiny_cuda_config(), os.path.join(tmp, "wd_single"), device="cuda")
    start = torch.cat([p.detach().flatten().float().cpu() for p in single.state.params.values()])
    t0 = time.perf_counter()
    single.fit()
    torch.cuda.synchronize()
    single_ms = (time.perf_counter() - t0) / TINY_STEPS * 1e3
    names = list(single.state.params)
    for name in names:
        assert torch.equal(ranks[1]["params"][name], ranks[0]["params"][name]), name
    moved = torch.cat([ranks[0]["params"][n].flatten().float() for n in names]) - start
    want = torch.cat([single.state.params[n].detach().flatten().float().cpu()
                      for n in names]) - start
    update_rel = rel_dev(moved, want)
    per_step = {k: (TINY_STEPS * TINY_CALLS if k in ("fused_attention_qkv",
                                                     "fused_attention_qkv_vjp") else 0)
                for k in read_counts()}
    for r in ranks:
        assert r["step"] == TINY_STEPS and r["launches"] == per_step, r["launches"]
    ckpts = sorted(os.listdir(os.path.join(tmp, "wd0", "ckpts")))
    assert ckpts == [f"{s}.ckpt" for s in range(1, TINY_STEPS + 1)], ckpts
    with open(os.path.join(tmp, "wd0", "metrics.jsonl")) as f:
        assert len(f.read().splitlines()) == TINY_STEPS
    assert not os.path.exists(os.path.join(tmp, "wd1")), os.listdir(os.path.join(tmp, "wd1"))
    print(f"[31b] two gloo processes on one card, synthetic_tiny global B={TINY_BATCH}: ranks' "
          f"parameters bit-identical after {TINY_STEPS} steps, update vs one process at "
          f"B={TINY_BATCH} rel {update_rel:.2e} (bar 2e-2), only rank 0 wrote; step "
          f"{ranks[0]['step_ms']:.1f} / {ranks[1]['step_ms']:.1f} ms (ranks, checkpoint every "
          f"step included) vs one process {single_ms:.1f} ms; launches {ranks[0]['launches']}")
    assert update_rel < 2e-2, update_rel
    return a


def set_remat(model: torch.nn.Module, use_checkpoint: bool, policy) -> None:
    for m in model.modules():
        if isinstance(m, Block):
            m.use_checkpoint, m.remat_policy = use_checkpoint, policy


def phase_remat(trainer):
    """32: each remat policy (and use_checkpoint=False) on the same weights,
    batch and draws: the gradient against use_checkpoint=False, kernel
    launches a step; then each timed over REMAT_TIMED steps with its peak
    memory."""
    batch, noise = parity_batch(trainer, DDP_BATCH)
    arms = [(False, "save_attn")] + [(True, p) for p in REMAT_POLICIES]
    grads, results = {}, {}
    for use, policy in arms:
        key = str(policy) if use else "use_checkpoint=False"
        set_remat(trainer.nnet, use, policy)
        zero_counts()
        metrics = trainer.loss_and_grads(batch, noise)
        torch.cuda.synchronize()
        counts = read_counts()
        grads[key] = (train_loss(metrics), grads_vector(trainer))
        fwd = LAUNCHES_PER_STEP * (1 if not use or policy in REMAT_KEEPS_ATTENTION else 2)
        want = {k: {"fused_attention_qkv": fwd,
                    "fused_attention_qkv_vjp": LAUNCHES_PER_STEP}.get(k, 0) for k in counts}
        assert counts == want, (key, counts)
        results[key] = dict(launches=counts)
        if use:
            results[key].update(compare_steps(grads[key], grads["use_checkpoint=False"], "32",
                                              f"remat_policy={policy!r} vs no checkpoint"))
    stream = trainer.data_stream(start_step=trainer.state.step)
    for use, policy in arms:
        key = str(policy) if use else "use_checkpoint=False"
        set_remat(trainer.nnet, use, policy)
        trainer.train_step(next(stream))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(REMAT_TIMED):
            trainer.train_step(next(stream))
        torch.cuda.synchronize()
        results[key].update(step_ms=(time.perf_counter() - t0) / REMAT_TIMED * 1e3,
                            max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)
        print(f"[32] {key}: step {results[key]['step_ms']:.2f} ms, peak "
              f"{results[key]['max_memory_allocated_gb']:.2f} GB, launches a step "
              f"{results[key]['launches']}")
    set_remat(trainer.nnet, True, trainer.config.nnet.remat_policy)
    print(f"[32] remat policies, mscoco_uvit_small B={DDP_BATCH}: {json.dumps(results)} "
          f"({card_line()})")
    return results


def phase_pallas_recompute(trainer):
    """33: attn_impl='pallas_recompute' (kernel 1 without lse, the plain f32
    recompute backward) against 'auto' on the same weights, batch and draws;
    launches a step; both timed in turns."""
    batch, noise = parity_batch(trainer, DDP_BATCH)
    out = {}
    for impl in ("auto", "pallas_recompute"):
        set_attn_impl(trainer.nnet, impl)
        zero_counts()
        metrics = trainer.loss_and_grads(batch, noise)
        torch.cuda.synchronize()
        out[impl] = (train_loss(metrics), grads_vector(trainer), read_counts())
    counts = out["pallas_recompute"][2]
    assert counts == {k: LAUNCHES_PER_STEP if k == "fused_attention_qkv" else 0
                      for k in counts}, counts
    parity = compare_steps(out["pallas_recompute"][:2], out["auto"][:2], "33",
                           f"pallas_recompute vs auto, B={DDP_BATCH}")

    timing = step_blocks(trainer, {"A": lambda: attn_impl(trainer.nnet, "auto"),
                                   "R": lambda: attn_impl(trainer.nnet, "pallas_recompute")},
                         "ARRA", 3)
    set_attn_impl(trainer.nnet, "auto")
    print(f"[33] pallas_recompute step {timing['R']['step_ms']:.2f} ms "
          f"{fmt_spread(timing['R']['spread'])} vs auto {timing['A']['step_ms']:.2f} ms "
          f"{fmt_spread(timing['A']['spread'])} (x{timing['R']['step_ms'] / timing['A']['step_ms']:.2f});"
          f" launches a step {counts} ({card_line()})")
    return dict(parity, launches=counts, recompute=timing["R"], auto=timing["A"])


def phase_image_only(tmp: str):
    """34: mscoco_uvit_mid (image-only t2i) from the seeded initialisation at
    batch 32: 3 + 20 steps through `fit` with 17 + 17 kernel calls a step,
    the parity step against the plain attention, then one Adam step."""
    trainer = make_trainer("mscoco_uvit_mid", tmp, pretrained=False)
    assert not trainer.config.nnet.enable_panoptic
    assert trainer.config.train.batch_size == MID_BATCH
    counts, step_s = phase_train(trainer, "34", {"fused_attention_qkv": MID_BLOCKS,
                                                 "fused_attention_qkv_vjp": MID_BLOCKS})
    phase_train_parity(trainer, MID_BATCH, ("auto", "plain"), "34")
    config = trainer.config
    trainer.state = TrainState(
        trainer.nnet, make_lr_schedule(config.optimizer.lr, "customized"),
        betas=config.optimizer.betas, optimizer="adam")
    before = grads_vector_params(trainer)
    stream = trainer.data_stream(start_step=0)
    metrics = trainer.train_step(next(stream))
    loss = float(metrics["loss"])
    moved = float(torch.linalg.vector_norm(grads_vector_params(trainer) - before))
    assert isinstance(trainer.state.optimizer, torch.optim.Adam)
    assert np.isfinite(loss) and moved > 0, (loss, moved)
    print(f"[34] one Adam step: loss {loss:.5f}, parameters moved by {moved:.3e} "
          f"({card_line()})")
    return counts, step_s


def grads_vector_params(trainer) -> torch.Tensor:
    return torch.cat([p.detach().flatten().float() for p in trainer.state.params.values()])


def phase_sp_uvit(tmp: str):
    """35a: U-ViT-L/2 latent_discrete at batch 64, mesh.sp = 2 in process:
    one step through the ring's hop kernel against sp = 1 through kernels 1
    and 2 (same weights, batch and draws), then 3 + 10 steps with exactly 42
    hop launches a step and none of the other kernels."""
    trainer = make_latent_trainer(tmp, mesh=dict(sp=SP, sp_mode="in_process"))
    assert trainer.nnet.sp is trainer.sp and trainer.config.train.batch_size == LATENT_BATCH
    batch, noise = parity_batch(trainer, LATENT_BATCH)
    out = {}
    for arm, sp, impl in (("sp2", trainer.sp, "ring"), ("sp1", None, "auto")):
        set_sp(trainer.nnet, sp)
        set_attn_impl(trainer.nnet, impl)
        zero_counts()
        metrics = trainer.loss_and_grads(batch, noise)
        torch.cuda.synchronize()
        out[arm] = (train_loss(metrics), grads_vector(trainer), read_counts())
    set_sp(trainer.nnet, trainer.sp)
    set_attn_impl(trainer.nnet, "ring")
    assert out["sp2"][2] == {k: SP_UVIT_HOPS if k == "attention_hop" else 0
                             for k in out["sp2"][2]}, out["sp2"][2]
    compare_steps(out["sp2"][:2], out["sp1"][:2], "35a",
                  f"U-ViT-L/2 sp=2 (ring, hop kernel) vs sp=1 (kernels 1 and 2), "
                  f"B={LATENT_BATCH}")
    counts, step_s = phase_train(trainer, "35a", {"attention_hop": SP_UVIT_HOPS},
                                 timed=SP_UVIT_TIMED)
    print(f"[35a] sp U-ViT-L/2 step {step_s * 1e3:.1f} ms ({card_line()})")
    return counts, step_s


def phase_async_checkpoint(trainer, tmp: str):
    """35b: one save of the mscoco_uvit_small train state with block=True and
    one with block=False (training goes on while it writes): the loop's
    stall, the write's duration; both files read back equal the state at
    the call."""
    state = trainer.state
    stream = trainer.data_stream(start_step=state.step)
    trainer.train_step(next(stream))
    root = os.path.join(tmp, "ckpt_timing")
    result = {}
    for block in (True, False):
        torch.cuda.synchronize()
        want = {n: p.detach().cpu().clone() for n, p in state.params.items()}
        step = state.step
        t0 = time.perf_counter()
        path = ckpt_lib.save_checkpoint(root, state, block=block)
        stall = time.perf_counter() - t0
        steps_meanwhile = 0
        if not block:
            while ckpt_lib.writing():
                trainer.train_step(next(stream))
                torch.cuda.synchronize()
                steps_meanwhile += 1
        ckpt_lib.wait_for_saves()
        write = time.perf_counter() - t0
        payload = ckpt_lib.load_checkpoint(path)
        assert payload["step"] == step
        assert all(torch.equal(payload["params"][n], p) for n, p in want.items())
        result["block" if block else "async"] = dict(
            stall_s=stall, write_s=write, steps_during_write=steps_meanwhile,
            file_gb=os.path.getsize(path) / 1e9)
    print(f"[35b] checkpoint of mscoco_uvit_small's train state: {json.dumps(result)}; "
          f"files read back equal the state at the call ({card_line()})")
    return result


def write_coco(root: str, split: str, n: int, seed: int) -> None:
    """A synthetic MS-COCO split under `root`: n JPEGs of COCO_W x COCO_H
    (smooth seeded colour fields) in `{split}/`, captions_{split}.json with
    5 captions each, panoptic_{split}.json (categories 1..200) and
    RGB-encoded panoptic PNGs of COCO_SEGMENTS segments each."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    words = CAPTION_CORPUS.split()
    img_dir, ann = os.path.join(root, split), os.path.join(root, "annotations")
    pan_dir = os.path.join(ann, f"panoptic_{split}")
    os.makedirs(img_dir)
    os.makedirs(pan_dir)
    images, captions, panoptic = [], [], []
    for i in range(n):
        image_id, name = 1000 + 7 * i, f"{1000 + 7 * i:012d}"
        low = rng.integers(0, 256, (COCO_H // 32, COCO_W // 32, 3), dtype=np.uint8)
        Image.fromarray(low).resize((COCO_W, COCO_H), Image.BICUBIC).save(
            os.path.join(img_dir, name + ".jpg"), quality=90)
        images.append(dict(id=image_id, file_name=name + ".jpg", width=COCO_W, height=COCO_H))
        captions += [dict(image_id=image_id, id=10 * image_id + k,
                          caption=" ".join(rng.choice(words, 8))) for k in range(5)]
        seg_ids = rng.choice(1 << 24, COCO_SEGMENTS, replace=False)
        cells = rng.integers(0, COCO_SEGMENTS, (COCO_H // 80, COCO_W // 80))
        ids = np.kron(seg_ids[cells], np.ones((80, 80), dtype=np.int64))
        rgb = np.stack([ids % 256, ids // 256 % 256, ids // 65536], -1).astype(np.uint8)
        Image.fromarray(rgb).save(os.path.join(pan_dir, name + ".png"))
        panoptic.append(dict(image_id=image_id, file_name=name + ".png", segments_info=[
            dict(id=int(s), category_id=int(rng.integers(1, 201))) for s in seg_ids]))
    with open(os.path.join(ann, f"captions_{split}.json"), "w") as f:
        json.dump(dict(images=images, annotations=captions), f)
    with open(os.path.join(ann, f"panoptic_{split}.json"), "w") as f:
        json.dump(dict(annotations=panoptic, categories=[dict(id=c, name=f"c{c}")
                                                         for c in range(1, 201)]), f)


def phase_extract(tmp: str):
    """36a: the synthetic COCO tree through `python -m
    panopticdiffusionmodels_torch.scripts.extract_mscoco_feature --size 256`
    on the card (a seeded full-width SD KL-VAE .pth, a CLIP-L/14-shaped text
    encoder), then in this process the val split of COCO_VAL_IMAGES, the
    empty-context and the prompt scripts; every file is
    there, and COCO_CHECK images' moments and contexts against the CPU's
    (f32, relative deviation < 1e-3), their seg maps equal.  Returns the
    feature root and the script's report."""
    coco = os.path.join(tmp, "coco")
    write_coco(coco, "train2017", COCO_IMAGES, 0)
    write_coco(coco, "val2017", COCO_VAL_IMAGES, 1)
    ae = os.path.join(tmp, "autoencoder_kl.pth")
    torch.manual_seed(7)
    torch.save(get_vae().state_dict(), ae)
    clip_dir = os.path.join(tmp, "clip_l14")
    write_clip_dir(clip_dir, CLIP_L_TEXT, 11, text_only=True)
    out = os.path.join(tmp, "coco256_features")
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "panopticdiffusionmodels_torch.scripts.extract_mscoco_feature",
         "--split", "train2017", "--datadir", coco, "--outdir", out, "--size", "256",
         "--autoencoder", ae, "--clip", clip_dir, "--batch", "8"],
        cwd=here, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    assert proc.returncode == 0, proc.stdout + proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["images"] == COCO_IMAGES and report["device"].startswith("cuda"), report
    extract_mscoco_feature.main(["--split", "val2017", "--datadir", coco, "--outdir", out,
                                 "--size", "256", "--autoencoder", ae, "--clip", clip_dir])
    extract_empty_feature.main(["--outdir", out, "--clip", clip_dir])
    extract_test_prompt_feature.main(["--outdir", out, "--clip", clip_dir])
    train = os.path.join(out, "train")
    names = set(os.listdir(train))
    for i in range(COCO_IMAGES):
        assert {f"{i}.npy", f"{i}_seg.npy", f"{i}_text.txt"} <= names, i
        assert {f"{i}_{k}.npy" for k in range(5)} <= names, i
    assert len(os.listdir(os.path.join(out, "run_vis"))) == 12
    db = MSCOCODatabase(os.path.join(coco, "train2017"),
                        os.path.join(coco, "annotations", "captions_train2017.json"),
                        os.path.join(coco, "annotations", "panoptic_train2017.json"),
                        os.path.join(coco, "annotations", "panoptic_train2017"), size=256)
    vae_cpu = extract_mscoco_feature.load_vae(ae, "cpu")
    clip_cpu = clip.FrozenCLIPEmbedder(clip_dir, device="cpu")
    worst = dict(moments=0.0, contexts=0.0)
    for i in range(COCO_CHECK):
        img, caps, seg = db[i]
        card = torch.from_numpy(np.load(os.path.join(train, f"{i}.npy")))
        cpu = torch.from_numpy(extract_mscoco_feature.encode_moments(vae_cpu, img, "cpu"))
        worst["moments"] = max(worst["moments"], rel_dev(card, cpu))
        card = torch.from_numpy(np.stack([np.load(os.path.join(train, f"{i}_{k}.npy"))
                                          for k in range(5)]))
        worst["contexts"] = max(worst["contexts"], rel_dev(card, clip_cpu.encode(caps)))
        assert np.array_equal(np.load(os.path.join(train, f"{i}_seg.npy")), seg)
        assert len(np.unique(seg)) > 1
    print(f"[36a] extraction of {COCO_IMAGES} COCO images of {COCO_W}x{COCO_H} at 256: "
          f"{report['images_per_s']:.2f} images/s ({report['seconds']:.2f} s in the script: "
          f"VAE {report['vae_s']:.2f} s, CLIP {report['clip_s']:.2f} s, host "
          f"{report['host_s']:.2f} s; {wall:.1f} s with the process's start); card vs CPU on "
          f"{COCO_CHECK} images: moments rel {worst['moments']:.2e}, contexts rel "
          f"{worst['contexts']:.2e} (bar 1e-3); seg maps equal ({card_line()})")
    assert worst["moments"] < 1e-3 and worst["contexts"] < 1e-3, worst
    return out, report


def batch_ms(batches, n: int = COCO_HOST_BATCHES, drain: int = 6) -> float:
    """ms a batch when `batches` is read back to back, after `drain` reads
    (the native loader's queue holds 4 finished batches)."""
    for _ in range(drain):
        next(batches)
    t0 = time.perf_counter()
    for _ in range(n):
        next(batches)
    return (time.perf_counter() - t0) / n * 1e3


def phase_native_train(tmp: str, features: str):
    """36b: mscoco_uvit_small at batch 64, fine-tune mode, save_attn, from
    36a's features through the native loader: 3 + 20 steps through `fit` with
    26 + 26 kernel calls a step; then blocks of COCO_BLOCK steps in turns
    with the same trainer on the Python Loader; and the host's time to
    assemble one batch with each."""
    trainer = make_trainer("mscoco_uvit_small", tmp, features=features)
    assert trainer.config.nnet.remat_policy == "save_attn" and trainer.config.nnet.use_checkpoint
    counts, step_s = phase_train(trainer, "36b", {"fused_attention_qkv": LAUNCHES_PER_STEP,
                                                  "fused_attention_qkv_vjp": LAUNCHES_PER_STEP})
    assert trainer.input_pipeline == "native", trainer.input_pipeline
    times = {"native": [], "python": []}
    for arm in ("native", "python", "python", "native") * COCO_ROUNDS:
        trainer.config.native_loader = arm == "native"
        stream = trainer.data_stream(start_step=trainer.state.step)
        assert trainer.input_pipeline == arm
        trainer.train_step(next(stream))  # the block's first step is not timed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(COCO_BLOCK):
            trainer.train_step(next(stream))
        torch.cuda.synchronize()
        times[arm].append((time.perf_counter() - t0) / COCO_BLOCK * 1e3)
    trainer.config.native_loader = True
    workers = trainer.config.num_workers
    native = NativeFeatureLoader(os.path.join(features, "train"), batch_size=64,
                                 moments_shape=(8, 32, 32), context_shape=(77, 768), seg_in=256,
                                 mask_size=64, num_threads=workers)
    host = dict(native=batch_ms(iter(native)))
    native.close()
    python = Loader(trainer.dataset.get_split("train", labeled=True), batch_size=64,
                    num_workers=workers)
    host["python"] = batch_ms(iter(python))
    result = {arm: dict(step_ms=float(np.median(v)), spread=[min(v), max(v)])
              for arm, v in times.items()}
    print(f"[36b] mscoco_uvit_small B=64 from extracted features: input_pipeline 'native', "
          f"{TIMED_STEPS} steps at {step_s * 1e3:.1f} ms through fit, launches {counts}; in "
          f"turns ({COCO_ROUNDS * 2} blocks of {COCO_BLOCK} each): native "
          f"{result['native']['step_ms']:.1f} ms {fmt_spread(result['native']['spread'])}, "
          f"Python Loader {result['python']['step_ms']:.1f} ms "
          f"{fmt_spread(result['python']['spread'])} a step; host assembly of one batch of 64 "
          f"at {workers} threads: native {host['native']:.2f} ms, Python {host['python']:.2f} "
          f"ms ({card_line()})")
    del trainer
    return counts, dict(result, host_ms=host)


CONVERT_CONFIG = '''"""mscoco_uvit_small in fine-tune mode on synthetic coco data, for
chip_smoke.py phase 36c."""
from panopticdiffusionmodels_torch.configs import get_config as zoo
from panopticdiffusionmodels_torch.configs.base import d


def get_config():
    config = zoo("mscoco_uvit_small")
    config.dataset = d(name="synthetic", n=128, z_shape=(32, 32, 8), clip_shape=(77, 768),
                       mask_size=64)
    config.pretrained = {pth!r}
    config.num_workers = 4
    return config
'''


def phase_convert(tmp: str):
    """36c: a seeded reference-format .pth of mscoco_uvit_small through
    `scripts/convert_checkpoint.py` on the card into `0.ckpt`; `Trainer`
    resumes it strictly at step 0, its parameters and EMA equal the .pth
    bit for bit, and it trains one step through kernels 1 and 2."""
    pth = os.path.join(tmp, "convert_reference.pth")
    write_pretrained(pth, get_config("mscoco_uvit_small"))
    cfg = os.path.join(tmp, "convert_config.py")
    with open(cfg, "w") as f:
        f.write(CONVERT_CONFIG.format(pth=pth))
    workdir = os.path.join(tmp, "converted")
    t0 = time.perf_counter()
    path = convert_checkpoint.main(["--config", cfg, "--nnet", pth,
                                    "--out", os.path.join(workdir, "ckpts")])
    convert_s = time.perf_counter() - t0
    trainer = Trainer(cli.load_config(cfg), workdir, device="cuda")
    assert trainer.resume() and trainer.state.step == 0
    want = reference_nnet_state_dict(load_torch_state_dict(pth))
    assert sorted(want) == sorted(trainer.state.params)
    for name, p in trainer.state.params.items():
        assert torch.equal(p.detach().cpu(), want[name]), name
        assert torch.equal(trainer.state.ema[name].cpu(), want[name]), name
    zero_counts()
    metrics = trainer.train_step(next(trainer.data_stream()))
    torch.cuda.synchronize()
    counts = read_counts()
    assert np.isfinite(train_loss(metrics)) and counts["fused_attention_qkv"] == \
        counts["fused_attention_qkv_vjp"] == LAUNCHES_PER_STEP, counts
    print(f"[36c] convert_checkpoint: {os.path.basename(path)} "
          f"({os.path.getsize(path) / 1e6:.1f} MB) in {convert_s:.2f} s; Trainer resumed it "
          f"strictly at step 0 with {len(trainer.state.frozen)} frozen parameters, parameters "
          f"and EMA equal to the .pth bit for bit; one step, loss {train_loss(metrics):.4f}")
    del trainer


def state_bytes(trainer) -> dict:
    """Bytes this process holds of the train state's f32 parameters,
    gradients (every parameter's, frozen ones too: the gradient norm reads
    them), AdamW moments (the trainable ones') and EMA, its shards under
    FSDP; their total; and `one_process`, the same tensors whole."""
    state = trainer.state
    out = dict(params=0, grads=0, moments=0, ema=0)
    one = 0
    for name, p in state.params.items():
        parts = dict(params=[p], ema=[state.ema[name]],
                     grads=[p.grad] if p.grad is not None else [],
                     moments=[state.optimizer.state[p][k] for k in ("exp_avg", "exp_avg_sq")]
                     if p in state.optimizer.state else [])
        for key, tensors in parts.items():
            out[key] += sum(local(t).numel() * 4 for t in tensors)
            one += sum(t.numel() * 4 for t in tensors)
    out["total"] = sum(out.values())
    out["one_process"] = one
    return out


def tiny_f32_config():
    """Phase 31b's synthetic_tiny in f32 with the plain attention (the
    kernels take bf16): FSDP against one process to 1e-5."""
    config = tiny_cuda_config()
    config.compute_dtype = "float32"
    config.nnet.attn_impl = "plain"
    return config


def fsdp_child(rank: int, port: int, tmp: str) -> None:
    """Phase 37: one of two processes on the one card over gloo at
    mesh.fsdp = 2: (a) synthetic_tiny in f32, 3 steps through `fit`, the
    gathered parameters and EMA written to `tmp/fsdp_tiny{rank}.pt`; (b)
    mscoco_uvit_small at the global batch of 64 (32 a rank), fine-tune
    mode, 2 + FSDP_TIMED steps through `fit` with the launches counted, and
    the bytes it holds of the train state, to `tmp/fsdp_small{rank}.json`."""
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=FSDP_WORLD, rank=rank)
    try:
        config = tiny_f32_config()
        config.mesh.fsdp = FSDP_WORLD
        with no_tf32():
            tiny = Trainer(config, os.path.join(tmp, f"fsdp_tiny_wd{rank}"), device="cuda:0")
            assert tiny.fsdp is not None and tiny.is_main == (rank == 0)
            tiny.fit()
        torch.save(dict(params=full({n: p.detach() for n, p in tiny.state.params.items()}),
                        ema=full(dict(tiny.state.ema)), step=tiny.state.step),
                   os.path.join(tmp, f"fsdp_tiny{rank}.pt"))
        del tiny
        small = make_trainer("mscoco_uvit_small", os.path.join(tmp, f"fsdp_small{rank}"),
                             mesh=dict(fsdp=FSDP_WORLD))
        small.fit(max_steps=2)
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        history = small.fit(max_steps=2 + FSDP_TIMED)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with open(os.path.join(tmp, f"fsdp_small{rank}.json"), "w") as f:
            json.dump(dict(launches=read_counts(), step_ms=wall / FSDP_TIMED * 1e3,
                           losses=[train_loss(m) for m in history], held=state_bytes(small),
                           max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9), f)
    finally:
        dist.destroy_process_group()


def phase_fsdp(tmp: str) -> dict:
    """37: two gloo processes on the one card at mesh.fsdp = 2 (NCCL refuses
    two ranks on one card): synthetic_tiny's gathered parameters and EMA
    after 3 steps against one process at the global batch (f32 with TF32
    off, max absolute difference < 1e-5); mscoco_uvit_small's launches a
    step (26 + 26 in each rank), the bytes of the train state each rank
    holds against what one process holds (about half), and its step time,
    which gloo's copies through the host dominate (recorded, not judged)."""
    port = free_port()
    run_children([f"fsdp_child({r}, {port}, {tmp!r})" for r in range(FSDP_WORLD)], timeout=600)
    with no_tf32():
        single = Trainer(tiny_f32_config(), os.path.join(tmp, "fsdp_tiny_single"),
                         device="cuda")
        single.fit()
    worst = 0.0
    for r in range(FSDP_WORLD):
        got = torch.load(os.path.join(tmp, f"fsdp_tiny{r}.pt"), weights_only=True)
        assert got["step"] == TINY_STEPS
        for name, p in single.state.params.items():
            worst = max(worst, float((got["params"][name].cpu() - p.detach().cpu()).abs().max()),
                        float((got["ema"][name].cpu() - single.state.ema[name].cpu()).abs().max()))
    smalls = []
    for r in range(FSDP_WORLD):
        with open(os.path.join(tmp, f"fsdp_small{r}.json")) as f:
            smalls.append(json.load(f))
    per_step = {k: FSDP_TIMED * (LAUNCHES_PER_STEP if k in ("fused_attention_qkv",
                                                            "fused_attention_qkv_vjp") else 0)
                for k in read_counts()}
    for r in smalls:
        assert r["launches"] == per_step, r["launches"]
        assert np.isfinite(r["losses"]).all(), r["losses"]
    shares = [r["held"]["total"] / r["held"]["one_process"] for r in smalls]
    print(f"[37] FSDP over two gloo processes on one card: synthetic_tiny (f32) parameters and "
          f"EMA after {TINY_STEPS} steps vs one process at B={TINY_BATCH}: max abs diff "
          f"{worst:.2e} (bar 1e-5); mscoco_uvit_small B=64 (32 a rank): launches a step "
          f"{smalls[0]['launches']} / {FSDP_TIMED}, step {smalls[0]['step_ms']:.1f} / "
          f"{smalls[1]['step_ms']:.1f} ms (gloo through the host, not judged), train state "
          f"held a rank {[r['held'] for r in smalls]}, share of one process's "
          f"{[round(x, 4) for x in shares]}, peak allocated "
          f"{[round(r['max_memory_allocated_gb'], 3) for r in smalls]} GB ({card_line()})")
    assert worst < 1e-5, worst
    assert all(x < 0.55 for x in shares), shares
    return dict(tiny_max_abs=worst, small=smalls)


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
        torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        eval_paths, sample_dir, eval_result = phase_eval(tmp)
        phase_inception(eval_paths)
        prompt_launches, _ = phase_prompts(tmp, latency)
        torch.cuda.empty_cache()
        phase_clip_score(tmp, sample_dir)
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        ddp = phase_ddp(tmp)
        torch.cuda.empty_cache()
        small = make_trainer("mscoco_uvit_small", tmp)
        remat = phase_remat(small)
        recompute = phase_pallas_recompute(small)
        mid_counts, _ = phase_image_only(tmp)
        torch.cuda.empty_cache()
        sp_uvit_counts, _ = phase_sp_uvit(tmp)
        torch.cuda.empty_cache()
        phase_async_checkpoint(small, tmp)
        del small
        torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        unet_flops, _ = phase_unet_forward()
        torch.cuda.empty_cache()
        phase_unet_serving(unet_flops)
        torch.cuda.empty_cache()
        phase_unet_train(tmp)
        torch.cuda.empty_cache()
        phase_unet_512(tmp)
        torch.cuda.empty_cache()
        huge_pipe, zoo_launches = phase_zoo()
        huge_launches, huge_train_counts = phase_uvit_huge(huge_pipe, tmp)
        del huge_pipe
        torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        features, _ = phase_extract(tmp)
        torch.cuda.empty_cache()
        native_counts, _ = phase_native_train(tmp, features)
        torch.cuda.empty_cache()
        phase_convert(tmp)
        torch.cuda.empty_cache()
        fsdp = phase_fsdp(tmp)

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
                              chain_counts["fused_attention_qkv"],
                          f"evaluation ({EVAL_SAMPLES} samples, mini-batches of {EVAL_BATCH})":
                              eval_result["launches"],
                          f"prompts request ({len(PROMPTS)} prompts)": prompt_launches,
                          **{f"{name} {ZOO_STEPS}-step request": n
                             for name, n in zoo_launches.items()},
                          "U-ViT-H/2 ImageNet-256 serving (3 requests)": huge_launches,
                          "U-ViT-H/2 latent_discrete step (batch 32)":
                              huge_train_counts["fused_attention_qkv"],
                          "DDP step at world 1 (child process, batch 64)":
                              ddp["launches"]["fused_attention_qkv"],
                          "remat policies (one counted step of each of 7 arms)":
                              sum(r["launches"]["fused_attention_qkv"] for r in remat.values()),
                          "pallas_recompute step (batch 64)":
                              recompute["launches"]["fused_attention_qkv"],
                          f"mscoco_uvit_mid image-only training ({TIMED_STEPS} steps)":
                              mid_counts["fused_attention_qkv"],
                          f"native-loader training from extracted features ({TIMED_STEPS} "
                          "steps)": native_counts["fused_attention_qkv"],
                          f"FSDP rank 0, mscoco_uvit_small ({FSDP_TIMED} steps)":
                              fsdp["small"][0]["launches"]["fused_attention_qkv"]},
        max_abs_err=max(r["max_abs_err"] for r in rows),
        max_rel_dev=max(r["max_rel_dev"] for r in rows),
        kernel_ms=per_pair["ms"], **per_pair,
        bound_by="bytes" if all(r["bound_by"] == "bytes" for r in main_rows) else "operations",
        per="one launch at L=334 plus one at L=590 (B=8, H=8, D=64), the pair each "
            "dual-stream layer runs per NFE; the ImageNet-256 serving shape is the row "
            f"{list(IMAGENET_SHAPE)}, the pixel-space shapes the rows "
            f"{[list(x) for x in PIXEL_SHAPES]}, U-ViT-H/2 serving the row "
            f"{list(HUGE_SHAPE)}, mscoco_uvit_mid training (with lse) the row "
            f"{list(MID_TRAIN_SHAPE)}; the fused arm of the A/B chain launches "
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
                              pixel_counts["fused_attention_qkv_vjp"],
                          "U-ViT-H/2 latent_discrete step (batch 32)":
                              huge_train_counts["fused_attention_qkv_vjp"],
                          "DDP step at world 1 (child process, batch 64)":
                              ddp["launches"]["fused_attention_qkv_vjp"],
                          "remat policies (one counted step of each of 7 arms)":
                              sum(r["launches"]["fused_attention_qkv_vjp"]
                                  for r in remat.values()),
                          f"mscoco_uvit_mid image-only training ({TIMED_STEPS} steps)":
                              mid_counts["fused_attention_qkv_vjp"],
                          f"native-loader training from extracted features ({TIMED_STEPS} "
                          "steps)": native_counts["fused_attention_qkv_vjp"],
                          f"FSDP rank 0, mscoco_uvit_small ({FSDP_TIMED} steps)":
                              fsdp["small"][0]["launches"]["fused_attention_qkv_vjp"]},
        max_abs_err=max(r["max_abs_err"] for r in bwd_rows),
        max_rel_dev=max(r["max_rel_dev"] for r in bwd_rows),
        kernel_ms=per_step["ms"], **per_step,
        bound_by="bytes" if all(r["bound_by"] == "bytes" for r in train_rows) else "operations",
        per="one call at L=334 plus one at L=590 (B=64, H=8, D=64), the pair each "
            "dual-stream layer runs per train step; one call is two CUDA kernels; the "
            f"U-ViT-L/2 training shape is the row {list(LATENT_TRAIN_SHAPE)}, the CIFAR-10 "
            f"one {list(CIFAR_TRAIN_SHAPE)}, the U-ViT-H/2 one {list(HUGE_TRAIN_SHAPE)}, the "
            f"mscoco_uvit_mid one {list(MID_BWD_SHAPE)}",
        shapes=bwd_rows)
    hop_main = [r for r in hop_rows if tuple(r["shape"][:3]) in HOP_MAIN_SHAPES]
    per_hop_pair = {k: sum(r[k] for r in hop_main) for k in ("ms", "plain_ms", "bound_ms",
                                                             "library_ms")}
    hop = dict(
        name="attention_hop", route="cuda",
        source="panopticdiffusionmodels_torch/ops/kernels/csrc/ring_hop.cu",
        replaces="panopticdiffusionmodels_tpu/ops/pallas/ring_hop.py:103",
        launches=sp_counts["attention_hop"],
        launches_by_path={f"sp training ({TIMED_STEPS} steps)": sp_counts["attention_hop"],
                          f"sp U-ViT-L/2 latent_discrete training ({SP_UVIT_TIMED} steps)":
                              sp_uvit_counts["attention_hop"]},
        max_abs_err=max(r["max_abs_err"] for r in hop_rows),
        max_rel_dev=max(r["max_rel_dev"] for r in hop_rows),
        kernel_ms=per_hop_pair["ms"], **per_hop_pair,
        bound_by=max(hop_main, key=lambda r: r["bound_ms"])["bound_by"],
        per="one hop at Lq=Lk=1063 plus one at Lq=Lk=551 (B=16 folded, H=8, D=64, "
            "nvalid=Lk), the pair each sp=2 dual-stream layer runs twice per train step; "
            f"sp U-ViT-L/2 training's hop is the row {list(SP_UVIT_HOP_SHAPE)} (B, Lq, Lk, "
            "H); library_ms is flash SDPA (out, lse) on the same q, k, v",
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
