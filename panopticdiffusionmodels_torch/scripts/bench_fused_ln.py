"""In-situ A/B of the U-ViT-L/2 attention boundary on the card: the shipped
packed-qkv boundary against the fused LayerNorm + qkv + attention kernels,
on a 20-block chain with the flagship block structure.

Port of `scripts/bench_fused_ln.py`.  Both arms run the same weights and the
same block (pre-norm attention with residual, pre-norm erf-GELU MLP with
residual, bf16, L = 258, C = 1024, 16 heads, 20 blocks); only the attention
boundary differs:

  shipped: the port's f32-stat LayerNorm -> torch.matmul qkv GEMM ->
           the packed-qkv attention kernel (`fused_attention_qkv`)
  fused:   the LN-prologue qkv GEMM kernel + the attention kernel
           (`fused_ln_qkv_attention`)

Prints ms per forward for each arm at the requested batches (host clock
around a synchronised forward, best of 5 after one warm-up) and the relative
deviation of the fused output from the shipped one.

    python -m panopticdiffusionmodels_torch.scripts.bench_fused_ln [batches...]   # default 32 64

Weights come from a numpy seed in the JAX script's layout (`w_qkv` is
(DEPTH, C, 3C), head-major); LayerNorm parameters are f32, the rest bf16.
"""
from __future__ import annotations

import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.kernels.fused_ln_qkv_attention import fused_ln_qkv_attention
from ..ops.kernels.fused_qkv_attention import fused_attention_qkv

L, C, HEADS, DEPTH = 258, 1024, 16, 20
F32_KEYS = ("ln1_s", "ln1_b", "ln2_s", "ln2_b")
VARIANTS = ("shipped", "fused")
TIMED = 5


def make_weights(seed: int = 0, depth: int = DEPTH, c: int = C) -> Dict[str, np.ndarray]:
    """The JAX script's `make_weights` as float32 numpy arrays (matrices
    N(0, 0.02), LayerNorms at identity, zero biases), drawn from `seed`."""
    rng = np.random.default_rng(seed)
    s = 0.02

    def normal(*shape):
        return (s * rng.standard_normal(shape)).astype(np.float32)

    return dict(
        ln1_s=np.ones((depth, c), np.float32), ln1_b=np.zeros((depth, c), np.float32),
        w_qkv=normal(depth, c, 3 * c), w_proj=normal(depth, c, c),
        b_proj=np.zeros((depth, c), np.float32),
        ln2_s=np.ones((depth, c), np.float32), ln2_b=np.zeros((depth, c), np.float32),
        w1=normal(depth, c, 4 * c), b1=np.zeros((depth, 4 * c), np.float32),
        w2=normal(depth, 4 * c, c), b2=np.zeros((depth, c), np.float32))


def load_weights(weights: Dict[str, np.ndarray], device="cuda") -> List[Dict[str, torch.Tensor]]:
    """Per-block tensors in the JAX layout (Dense kernels (in, out)): the
    LayerNorm parameters in f32, the rest in bf16."""
    depth = next(iter(weights.values())).shape[0]
    return [{k: torch.as_tensor(v[i], device=device).to(
                torch.float32 if k in F32_KEYS else torch.bfloat16).contiguous()
             for k, v in weights.items()} for i in range(depth)]


def layernorm(x: torch.Tensor, s: torch.Tensor, b: torch.Tensor, eps: float = 1e-5):
    """The port's LayerNorm: statistics and affine map in f32, out in x's dtype."""
    return F.layer_norm(x.float(), x.shape[-1:], s.float(), b.float(), eps).to(x.dtype)


def block(x: torch.Tensor, w: Dict[str, torch.Tensor], variant: str, heads: int):
    scale = (x.shape[-1] // heads) ** -0.5
    if variant == "fused":
        a = fused_ln_qkv_attention(x, w["ln1_s"], w["ln1_b"], w["w_qkv"], heads, scale)
    else:
        a = fused_attention_qkv(torch.matmul(layernorm(x, w["ln1_s"], w["ln1_b"]), w["w_qkv"]),
                                heads, scale)
    x = x + torch.matmul(a, w["w_proj"]) + w["b_proj"]
    h = layernorm(x, w["ln2_s"], w["ln2_b"])
    h = F.gelu(torch.matmul(h, w["w1"]) + w["b1"], approximate="none")
    return x + torch.matmul(h, w["w2"]) + w["b2"]


@torch.no_grad()
def chain(blocks: List[Dict[str, torch.Tensor]], x: torch.Tensor, variant: str,
          heads: int = HEADS) -> torch.Tensor:
    """One forward of the chain: every block in order, one attention-boundary
    launch of the variant's kernel per block."""
    assert variant in VARIANTS, variant
    for w in blocks:
        x = block(x, w, variant, heads)
    return x


def main(argv: Optional[List[str]] = None) -> Dict[int, dict]:
    """Both arms at each batch; returns {batch: {'<arm>_ms', 'rel', 'forwards'}},
    where `forwards` is the number of chain forwards each arm ran."""
    batches = [int(a) for a in (sys.argv[1:] if argv is None else argv)] or [32, 64]
    blocks = load_weights(make_weights(0))
    results = {}
    for b in batches:
        x = torch.as_tensor((0.5 * np.random.default_rng(1).standard_normal((b, L, C)))
                            .astype(np.float32), device="cuda").to(torch.bfloat16)
        outs, row = {}, {"forwards": TIMED + 1}
        for variant in VARIANTS:
            outs[variant] = chain(blocks, x, variant)  # warm-up, and the compared output
            times = []
            for _ in range(TIMED):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                chain(blocks, x, variant)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            row[f"{variant}_ms"] = 1e3 * min(times)
            print(f"B={b} {variant:8s}: {row[f'{variant}_ms']:7.2f} ms/fwd")
        ref, new = outs["shipped"].float(), outs["fused"].float()
        row["rel"] = float(torch.linalg.vector_norm(new - ref) / torch.linalg.vector_norm(ref))
        print(f"B={b} rel deviation fused vs shipped: {100 * row['rel']:.3f}%")
        results[b] = row
    return results


if __name__ == "__main__":
    main()
