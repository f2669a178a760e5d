"""The secondary class-conditional sampling protocols on the card:
ImageNet-512 U-ViT-L/4, ImageNet-256 U-ViT-H/2 and ImageNet-512 U-ViT-H/4.

    python -m panopticdiffusionmodels_torch.scripts.bench_protocols [512L|256H|512H]

Port of `scripts/bench_protocols.py`.  The headline (`bench.py`) is
ImageNet-256 U-ViT-L/2; the reference publishes FID protocols for three
more latent pipelines with the same 50-NFE order-3 DPM-Solver-fast, CFG and
KL-VAE decode and another transformer, latent size or CFG scale:

    protocol   latents     model                  CFG   decode
    512L       64x64x4     L/4  (1024 x 20, d64)  0.7   512^2
    256H       32x32x4     H/2  (1152 x 28, d72)  0.4   256^2
    512H       64x64x4     H/4  (1152 x 28, d72)  0.7   512^2

Each is the port's zoo config (`imagenet512_uvit_large`,
`imagenet256_uvit_huge`, `imagenet512_uvit_huge`) served by
`serving.GenerationPipeline` as `scripts/bench.py` serves the headline
(`bench.build_components` / `build_pipeline`: seeded bf16 U-ViT with the
packed-qkv attention kernel, bf16 VAE decode, the null class 1000 as one
2x-batch CFG forward).  Before timing, kernel 1 is held against its plain
version at the protocol's attention shape (2 x batch rows for CFG, L =
258, its heads and head dim; 72 for the H models), relative deviation
< 5e-3.  Images/s is the best of BENCH_REPS (3) requests after a warm-up.
Env as the JAX script: BENCH_BATCH (16), BENCH_ACCEL, BENCH_CFG_INTERVAL,
BENCH_GELU.  `--device=cpu` runs on the CPU.
"""
from __future__ import annotations

import os
import sys

import torch

from ..ops.attention import attention_qkv
from . import bench
from .measure import finish, read_counts, rel_dev, require_device, split_device, zero_counts

PROTOCOLS = {
    # img_size, patch, embed_dim, depth, heads, cfg_scale, default batch
    "512L": dict(img_size=64, patch_size=4, embed_dim=1024, depth=20,
                 num_heads=16, cfg_scale=0.7, batch=16),
    "256H": dict(img_size=32, patch_size=2, embed_dim=1152, depth=28,
                 num_heads=16, cfg_scale=0.4, batch=16),
    "512H": dict(img_size=64, patch_size=4, embed_dim=1152, depth=28,
                 num_heads=16, cfg_scale=0.7, batch=16),
}
CONFIGS = {"512L": "imagenet512_uvit_large", "256H": "imagenet256_uvit_huge",
           "512H": "imagenet512_uvit_huge"}
PARITY_BAR = 5e-3


def attention_shape(name: str, batch: int):
    """(B, L, H, D) of the protocol's attention: 2 x batch rows (CFG), the
    patches plus the time and label tokens."""
    p = PROTOCOLS[name]
    g = p["img_size"] // p["patch_size"]
    return 2 * batch, g * g + 2, p["num_heads"], p["embed_dim"] // p["num_heads"]


def kernel_parity(b: int, l: int, heads: int, d: int, device="cuda") -> float:
    """Relative deviation of kernel 1 (`attention_qkv(impl='infer')`) from
    its plain version on seeded bf16 qkv of (b, l, 3 heads d)."""
    gen = torch.Generator(device=device).manual_seed(0)
    qkv = (torch.randn((b, l, 3 * heads * d), generator=gen, device=device) * 0.5
           ).to(torch.bfloat16)
    with torch.no_grad():
        plain = attention_qkv(qkv, heads, impl="plain")
        kernel = attention_qkv(qkv, heads, impl="infer")
    return rel_dev(kernel, plain)


def main(argv=None, device="cuda", dims=None) -> dict:
    """Time one protocol; `dims` (`bench.build_components`' size arguments)
    cuts it to a tiny size for the CPU."""
    argv = sys.argv[1:] if argv is None else list(argv)
    device, rest = split_device(argv, device)
    device = require_device(device, "bench_protocols")
    name = rest[0] if rest else "512L"
    proto = PROTOCOLS[name]
    batch = int(os.environ.get("BENCH_BATCH", str(proto["batch"])))
    reps = int(os.environ.get("BENCH_REPS", "3"))

    shape = attention_shape(name, batch)
    zero_counts()
    rel = kernel_parity(*shape, device=device)
    parity_launches = read_counts()["fused_attention_qkv"]
    print(f"{name}: kernel parity at B={shape[0]} L={shape[1]} H={shape[2]} D={shape[3]}: "
          f"rel dev {rel:.2e}")
    assert rel < PARITY_BAR, (name, shape, rel)

    components = bench.build_components(device, config_name=CONFIGS[name], **(dims or {}))
    config = components[0]
    want = {k: proto[k] for k in ("img_size", "patch_size", "embed_dim", "depth", "num_heads")}
    got = {k: config.nnet[k] for k in want}
    assert dims or got == want, (name, got, want)
    assert config.sample.scale == proto["cfg_scale"], (name, config.sample.scale)
    pipe = bench.build_pipeline(components)
    zero_counts()
    ips = bench.time_pipeline(pipe, batch, reps)
    launches = read_counts()["fused_attention_qkv"]
    res = config.nnet.img_size * 8
    print(f"imagenet{res} uvit-{name[-1]}/{config.nnet.patch_size} 50-NFE CFG "
          f"{proto['cfg_scale']} + {res}-decode, batch {batch}: {ips:.2f} img/s")
    return finish("bench_protocols", dict(
        protocol=name, config=CONFIGS[name], batch=batch, reps=reps, images_per_s=ips,
        kernel_parity=dict(shape=list(shape), rel_dev=rel, bar=PARITY_BAR,
                           kernel_launches=parity_launches),
        requests=reps + 1, kernel_launches=launches,
        real_evals_per_request=pipe.last_real_evals), device)


if __name__ == "__main__":
    main()
