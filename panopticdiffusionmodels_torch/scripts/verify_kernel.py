"""The card's evidence that the hand-written attention kernels compute what
their plain PyTorch versions compute, at the shapes the port ships.

    python -m panopticdiffusionmodels_torch.scripts.verify_kernel

Port of `scripts/verify_kernel_tpu.py`, its seven checks and bars:
  1. dispatch: `attention_qkv(impl='infer')` on a CUDA tensor launches
     kernel 1 (its launch counter moves by one); on a CPU tensor it takes
     the plain version (the counter stays);
  2. kernel 1 against its plain version at six shapes (258 = ImageNet-256 /
     512 U-ViT-L tokens, 590 = the dual stream, head dim 32, U-ViT-H's head
     dim 72, the 512-res stream of 2126): relative deviation < 5e-3;
  3. a full U-ViT-L/2 forward (bf16, batch 8) with `attn_impl='infer'`
     against `'plain'` on the same weights: < 2e-2;
  4. the training path: the loss sum(out^2) and its gradient through
     `pallas_vjp` (kernels 1 and 2), `pallas_recompute` (kernel 1 and the
     plain f32 backward) and `auto`, against `'plain'`, at (8, 258, 8, 64)
     and (2, 2126, 8, 64): each < 5e-3;
  5. the pipelined apply (`parallel/pipeline.py::Pipelined` over one stage,
     `LocalExchange(1)`, 2 micro-batches) of the dual-stream S/2 with kernel
     1 inside, against its plain (unpipelined) forward: < 1e-3;
  6. the U-ViT's gradient (depth 4, 512 wide, 8 heads, `attn_impl='auto'`,
     bf16 autocast) under the remat policies None, 'save_attn' and
     'dots_no_batch', against no remat: < 5e-3;
  7. kernel 3 (`ring_hop.attention_hop`) against `attention_hop_plain` at
     (Lq, Lk, nvalid) = (1063, 1063, 1063), (1064, 1064, 1000) and (258,
     258, 258), B = 2, 8 heads of 64: o, m and den each < 5e-3.
On the card checks 4-6 also hold the kernel launches their routes make:
kernels 1 and 2 once each for `pallas_vjp` and `auto`, kernel 1 alone for
`pallas_recompute`; kernel 1 once an attention a micro-batch in the
pipelined apply; kernel 2 once an attention under every remat policy, and
kernel 1 once more for each attention the policy replays (all but
'save_attn').  Any check past its bar or count fails the script.  `--device=cpu` runs on the CPU,
where every kernel route is its plain version.
"""
from __future__ import annotations

import sys
from typing import Optional

import torch

from ..configs import get_config
from ..models import get_nnet
from ..models.layers import Attention, Block
from ..ops.attention import attention_qkv
from ..ops.kernels.ring_hop import attention_hop, attention_hop_plain
from ..parallel.pipeline import LocalExchange, Pipelined
from .measure import (
    finish,
    read_counts,
    rel_dev,
    require_device,
    set_attn_impl,
    split_device,
    zero_counts,
)

KERNEL_SHAPES = [(32, 258, 16, 64), (8, 590, 8, 64), (4, 130, 4, 32), (64, 258, 16, 64),
                 (8, 258, 16, 72), (2, 2126, 8, 64)]
TRAIN_SHAPES = [(8, 258, 8, 64), (2, 2126, 8, 64)]
TRAIN_IMPLS = ("pallas_vjp", "pallas_recompute", "auto")
HOP_SHAPES = [(1063, 1063, 1063), (1064, 1064, 1000), (258, 258, 258)]
HOP_BATCH, HOP_HEADS, HOP_DIM = 2, 8, 64
REMAT_POLICIES = (None, "save_attn", "dots_no_batch")
# Launches of (kernel 1, kernel 2) on the card: a train route's for one
# attention, a remat policy's for each attention of the model.
TRAIN_LAUNCHES = {"pallas_vjp": (1, 1), "pallas_recompute": (1, 0), "auto": (1, 1)}
REMAT_LAUNCHES = {None: (2, 1), "save_attn": (1, 1), "dots_no_batch": (2, 1)}
BARS = dict(dispatch=None, kernel=5e-3, uvit_forward=2e-2, train=5e-3, pipeline=1e-3,
            remat=5e-3, hop=5e-3)
# The U-ViT-L/2 of check 3, the U-ViT of check 6 and the dual-stream S/2 of
# check 5, as nnet fields over their zoo configs.
UVIT_L = dict(get_config("imagenet256_uvit_large").nnet)
REMAT_UVIT = dict(UVIT_L, embed_dim=512, depth=4, num_heads=8, num_classes=11)
S2 = dict(get_config("mscoco_uvit_small").nnet)


def kernel_launches(device, per_call, calls: int = 1) -> dict:
    """The (kernel 1, kernel 2) launches `calls` calls of a route make: the
    counts `per_call` times `calls` on the card, none elsewhere."""
    n = calls if device.type == "cuda" else 0
    return {"fused_attention_qkv": per_call[0] * n, "fused_attention_qkv_vjp": per_call[1] * n}


def attentions(model: torch.nn.Module) -> int:
    return sum(isinstance(m, Attention) for m in model.modules())


def autocast(device):
    return torch.autocast(device.type, dtype=torch.bfloat16)


def seeded(kw: dict, seed: int, **extra):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        kw = dict(kw, **extra)
        return get_nnet(kw.pop("name"), **kw)


def qkv_of(shape, seed: int, device) -> torch.Tensor:
    b, l, heads, d = shape
    gen = torch.Generator(device=device).manual_seed(seed)
    return (torch.randn((b, l, 3 * heads * d), generator=gen, device=device) * 0.5
            ).to(torch.bfloat16)


def check_dispatch(device) -> dict:
    qkv = torch.zeros((2, 258, 3 * 1024), dtype=torch.bfloat16, device=device)
    zero_counts()
    with torch.no_grad():
        attention_qkv(qkv, 16, impl="infer")
    launched = read_counts()["fused_attention_qkv"]
    print(f"infer dispatch on {device.type} launches kernel 1: {bool(launched)}")
    assert launched == (1 if device.type == "cuda" else 0), (
        "impl='infer' did not take the kernel on the card: the headline would run the plain "
        "attention" if device.type == "cuda" else "a CPU tensor reached a kernel")
    return dict(launches=launched)


def check_kernel(device, shapes) -> list:
    rows = []
    for b, l, heads, d in shapes:
        qkv = qkv_of((b, l, heads, d), l, device)
        with torch.no_grad():
            r = rel_dev(attention_qkv(qkv, heads, impl="infer"),
                        attention_qkv(qkv, heads, impl="plain"))
        print(f"kernel parity B{b} L{l} H{heads} D{d}: rel dev {r:.2e}")
        assert r < BARS["kernel"], (b, l, heads, d, r)
        rows.append(dict(shape=[b, l, heads, d], rel_dev=r))
    return rows


def check_uvit_forward(device, uvit: dict, batch: int) -> dict:
    model = seeded(uvit, 1, attn_impl="plain").to(device, torch.bfloat16).eval()
    size, chans = uvit["img_size"], uvit["in_chans"]
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randn((batch, chans, size, size), generator=gen, device=device)
    t = torch.full((batch,), 500.0, device=device)
    y = torch.zeros((batch,), dtype=torch.int64, device=device)
    with torch.no_grad():
        out_plain = model(x, t, y)
        set_attn_impl(model, "infer")
        out_kernel = model(x, t, y)
    r = rel_dev(out_kernel, out_plain)
    print(f"U-ViT forward infer vs plain: rel dev {r:.2e}")
    assert r < BARS["uvit_forward"], r  # bf16 noise compounds over the blocks
    return dict(rel_dev=r, batch=batch, depth=uvit["depth"], embed_dim=uvit["embed_dim"])


def check_train(device, shapes) -> list:
    def loss_grad(qkv, impl, heads):
        x = qkv.detach().requires_grad_()
        loss = attention_qkv(x, heads, impl=impl).float().square().sum()
        (g,) = torch.autograd.grad(loss, x)
        return float(loss.detach()), g

    rows = []
    for b, l, heads, d in shapes:
        qkv = qkv_of((b, l, heads, d), 9, device)
        lx, gx = loss_grad(qkv, "plain", heads)
        for impl in TRAIN_IMPLS:
            zero_counts()
            lp, gp = loss_grad(qkv, impl, heads)
            fdev, gdev = abs(lp - lx) / abs(lx), rel_dev(gp, gx)
            print(f"train path L{l} {impl}: fwd rel dev {fdev:.2e}, grad rel dev {gdev:.2e}")
            assert fdev < BARS["train"], (l, impl, fdev)
            assert gdev < BARS["train"], (l, impl, gdev)
            launches = read_counts()
            want = kernel_launches(device, TRAIN_LAUNCHES[impl])
            assert {k: launches[k] for k in want} == want, (l, impl, launches)
            rows.append(dict(shape=[b, l, heads, d], impl=impl, loss_rel_dev=fdev,
                             grad_rel_dev=gdev, launches=launches))
    return rows


def check_pipeline(device, s2: dict, batch: int = 4, num_micro: int = 2) -> dict:
    model = seeded(s2, 0, attn_impl="infer").to(device, torch.bfloat16).eval()
    size, mask = s2["img_size"], s2["mask_size"]
    gen = torch.Generator(device=device).manual_seed(1)
    x = torch.zeros((batch, s2["in_chans"], size, size), device=device)
    t = torch.full((batch,), 500.0, device=device)
    ctx = torch.randn((batch, s2["num_clip_token"], s2["clip_dim"]), generator=gen,
                      device=device) * 0.1
    m = torch.randn((batch, s2["mask_bits"], mask, mask), generator=gen, device=device) * 0.1
    with torch.no_grad():
        plain = model(x, t, ctx, mask_token=m)
        zero_counts()
        piped = Pipelined(model, LocalExchange(1), num_micro=num_micro)(x, t, ctx,
                                                                         mask_token=m)
    launches = read_counts()["fused_attention_qkv"]
    want = kernel_launches(device, (1, 0), num_micro * attentions(model))["fused_attention_qkv"]
    pdev = max(rel_dev(a, b) for a, b in zip(piped, plain))
    print(f"pipelined apply (kernel inside, pp = 1, 2 micro-batches) vs plain: rel dev "
          f"{pdev:.2e}")
    assert pdev < BARS["pipeline"], pdev
    assert launches == want, (launches, want)
    return dict(rel_dev=pdev, kernel_launches=launches)


def check_remat(device, uvit: dict, batch: int = 8) -> list:
    model = seeded(uvit, 4, attn_impl="auto", use_checkpoint=False).to(device)
    size, chans = uvit["img_size"], uvit["in_chans"]
    gen = torch.Generator(device=device).manual_seed(3)
    xb = torch.randn((batch, chans, size, size), generator=gen, device=device)
    tb = torch.full((batch,), 500.0, device=device)
    yb = torch.zeros((batch,), dtype=torch.int64, device=device)
    params = list(model.parameters())

    def grads():
        with autocast(device):
            loss = model(xb, tb, yb).float().square().mean()
        return torch.autograd.grad(loss, params)

    g0 = grads()
    rows = []
    for policy in REMAT_POLICIES:
        for blk in model.modules():
            if isinstance(blk, Block):
                blk.use_checkpoint, blk.remat_policy = True, policy
        zero_counts()
        g1 = grads()
        gdev = max(rel_dev(b, a) for a, b in zip(g0, g1))
        print(f"remat_policy={policy!r} grad vs no-remat: rel dev {gdev:.2e}")
        assert gdev < BARS["remat"], (policy, gdev)
        launches = read_counts()
        want = kernel_launches(device, REMAT_LAUNCHES[policy], attentions(model))
        assert {k: launches[k] for k in want} == want, (policy, launches)
        rows.append(dict(policy=policy, grad_rel_dev=gdev, launches=launches))
    return rows


def check_hop(device, shapes, b: int = HOP_BATCH, heads: int = HOP_HEADS,
              d: int = HOP_DIM) -> list:
    c = heads * d
    rows = []
    for lq, lk, nvalid in shapes:
        gq = torch.Generator(device=device).manual_seed(5)
        gk = torch.Generator(device=device).manual_seed(6)
        q = (torch.randn((b, lq, c), generator=gq, device=device) * 0.5).to(torch.bfloat16)
        kv = (torch.randn((b, lk, 2 * c), generator=gk, device=device) * 0.5
              ).to(torch.bfloat16)
        with torch.no_grad():
            got = attention_hop(q, kv, heads, d ** -0.5, nvalid)
            want = attention_hop_plain(q, kv, heads, d ** -0.5, nvalid)
        rs = [rel_dev(a, w) for a, w in zip(got, want)]
        print(f"ring hop Lq{lq} Lk{lk} nvalid{nvalid}: o/m/den rel dev "
              f"{rs[0]:.2e}/{rs[1]:.2e}/{rs[2]:.2e}")
        assert max(rs) < BARS["hop"], (lq, lk, nvalid, rs)
        rows.append(dict(lq=lq, lk=lk, nvalid=nvalid, o=rs[0], m=rs[1], den=rs[2]))
    return rows


def main(argv=None, device="cuda", tiny: Optional[dict] = None) -> dict:
    """The seven checks; `tiny` overrides the shapes and model fields
    (kernel_shapes, train_shapes, hop_shapes, hop (b, heads, d), uvit,
    remat_uvit, s2, batch) to run them at a tiny size on the CPU."""
    argv = sys.argv[1:] if argv is None else list(argv)
    device, _ = split_device(argv, device)
    device = require_device(device, "verify_kernel")
    tiny = tiny or {}
    print(f"device: {device}" + (f" ({torch.cuda.get_device_name(device)})"
                                 if device.type == "cuda" else ""))
    checks = dict(
        dispatch=check_dispatch(device),
        kernel=check_kernel(device, tiny.get("kernel_shapes", KERNEL_SHAPES)),
        uvit_forward=check_uvit_forward(device, tiny.get("uvit", UVIT_L),
                                        tiny.get("batch", 8)),
        train=check_train(device, tiny.get("train_shapes", TRAIN_SHAPES)),
        pipeline=check_pipeline(device, tiny.get("s2", S2)),
        remat=check_remat(device, tiny.get("remat_uvit", REMAT_UVIT)),
        hop=check_hop(device, tiny.get("hop_shapes", HOP_SHAPES),
                      *tiny.get("hop", (HOP_BATCH, HOP_HEADS, HOP_DIM))))
    print("kernel verification OK")
    return finish("verify_kernel", dict(checks=checks, bars=BARS, ok=True), device)


if __name__ == "__main__":
    main()
