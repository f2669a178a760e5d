"""Two checkouts of the repository against each other on one card, in turns.

Each turn is a fresh process of one tree that runs, for each part asked for
(`--parts`), that tree's own code:

- `attention`: its `chip_smoke.py` phases 3 (kernel 1 against its plain
  version, timed in turns with SDPA) and 3b (kernel 2, timed in turns with
  SDPA's backward) at the rows given, and phase 30 (U-ViT-H/2 serving: 3
  requests of 32 labels at 50 steps, and the kernel-vs-plain parity step);
  then a U-ViT-H/2 `latent_discrete` training step at batch 32 timed
  through that tree's `Trainer.fit` (`phase_train`: 3 warm-up and 20 timed
  steps, 29 + 29 kernel calls a step) and its device time under the
  profiler (`device_profile` over 3 steps: the kernels' busy ms a step,
  which the host-bound step's wall time can hide);
- `hop`: its `ring_hop.attention_hop` at U-ViT-H/2's two hops at head dim 72
  and at the head-dim-64 control row (against its plain version, timed in
  turns with flash SDPA's (out, lse)); then the same U-ViT-H/2 step at
  mesh.sp = 2 in process through that tree's `Trainer` (3 + 20 steps, 58
  hop launches a step) and its device time under the profiler over 3
  steps: busy ms a step and the hop kernel's ms a step.

Trees run in the order A, B, B, A for every round, so that both share the
card's state.

    python3 panopticdiffusionmodels_torch/scripts/ab_trees.py build/parent . --rounds 1 \
        --parts hop

A tree is a directory holding `chip_smoke.py` and the port's package (for
example the parent commit unpacked by `git archive` into a directory that
`.gitignore` lists); each builds its own kernels into its own `build/`.  Every
turn writes its JSON to `chiprun_out/ab_trees/` and prints it; the end prints
the medians per tree.  The card only.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

KERNEL_ROWS = [(64, 258, 16, 72), (8, 258, 16, 72), (64, 258, 16, 64)]
BWD_ROWS = [(32, 258, 16, 72), (8, 258, 16, 72), (32, 258, 16, 64)]
# (B, Lq, Lk, H, D): U-ViT-H/2's hops at sp = 2 and 4 (batch 32 folded), and
# U-ViT-L/2's at sp = 2 (batch 64 folded), the control row at head dim 64.
HOP_ROWS = [(64, 129, 129, 16, 72), (128, 65, 65, 16, 72), (128, 129, 129, 16, 64)]
HUGE = "imagenet256_uvit_huge"
HUGE_BLOCKS, HUGE_BATCH = 29, 32
SP_HUGE_HOPS = 2 * HUGE_BLOCKS
STEP_WARMUP, STEP_TIMED, STEP_PROFILED = 3, 20, 3
PARTS = ("attention", "hop")
# The hop kernel's device rows in the profiler: the wgmma loop's hop
# instances or the mma.sync kernel.
HOP_KERNELS = ("attention_tma_kernel<3, true", "ring_hop_kernel")
OUT = Path("chiprun_out") / "ab_trees"


def huge_trainer(c, tmp: str, mesh=None):
    """The tree's `Trainer` for U-ViT-H/2 latent_discrete at batch 32 on
    synthetic latent moments."""
    config = c.get_config(HUGE)
    h, w, ch = config.z_shape
    config.dataset = c.d(name="synthetic", style="imagenet", n=4 * HUGE_BATCH,
                         z_shape=(h, w, 2 * ch), num_classes=1000)
    config.train.batch_size = HUGE_BATCH
    config.num_workers = 0
    config.mesh.update(mesh or {})
    return c.Trainer(config, os.path.join(tmp, "run"), device="cuda")


def hop_part(c, torch) -> dict:
    """The tree's hop at HOP_ROWS against its plain version (max relative
    deviation of o, m and den, q a view of a packed qkv) and timed in turns
    with flash SDPA; then the sp = 2 U-ViT-H/2 step, timed and profiled."""
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for b, lq, lk, h, d in HOP_ROWS:
        c_ = h * d
        scale = d ** -0.5
        qkv = (torch.randn((b, lq, 3 * c_), generator=gen, device="cuda") * 0.5).to(
            torch.bfloat16)
        q = qkv[..., :c_]
        kv = (torch.randn((b, lk, 2 * c_), generator=gen, device="cuda") * 0.5).to(
            torch.bfloat16)
        full = torch.full((b,), lk, dtype=torch.int32, device="cuda")
        got = c.ring_hop.attention_hop(q, kv, h, scale, full)
        ref = c.ring_hop.attention_hop_plain(q, kv, h, scale, full)
        rel = max(c.rel_dev(a, r) for a, r in zip(got, ref))
        assert rel < 5e-3, (b, lq, lk, h, d, rel)
        qh, kh, vh = (t.reshape(b, -1, h, d).transpose(1, 2).contiguous()
                      for t in (q, kv[..., :c_], kv[..., c_:]))
        flash = torch.ops.aten._scaled_dot_product_flash_attention
        row = dict(shape=[b, lq, lk, h, d], loop=c.ring_hop.hop_loop(d), max_rel_dev=rel,
                   **c.alternate(lambda: c.ring_hop.attention_hop(q, kv, h, scale, full),
                                 lambda: flash(qh, kh, vh, 0.0, False, False, scale=scale)))
        row["bound_ms"] = c.hop_bound(b, lq, lk, c_, h)[0]
        print(f"[ab] hop {tuple(row['shape'])} {row['loop']}: {row['ms']:.4f} ms, flash "
              f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms, rel {rel:.2e}",
              flush=True)
        rows.append(row)
    with tempfile.TemporaryDirectory() as tmp:
        trainer = huge_trainer(c, tmp, mesh=dict(sp=2, sp_mode="in_process"))
        _, step_s = c.phase_train(trainer, "ab", {"attention_hop": SP_HUGE_HOPS},
                                  warmup=STEP_WARMUP, timed=STEP_TIMED)
        batch = next(trainer.data_stream(start_step=trainer.state.step))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(STEP_PROFILED):
                trainer.train_step(batch)
            torch.cuda.synchronize()
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False) and e.self_device_time_total > 0]
    hop = [(ms, n) for name, ms, n in kernels if any(k in name for k in HOP_KERNELS)]
    assert sum(n for _, n in hop) == SP_HUGE_HOPS * STEP_PROFILED, hop
    return dict(hop_rows=rows, sp_step_ms=step_s * 1e3,
                sp_step_device_busy_ms=sum(ms for _, ms, _ in kernels) / STEP_PROFILED,
                sp_step_hop_ms=sum(ms for ms, _ in hop) / STEP_PROFILED,
                sp_hop_kernel=[name for name, _, _ in kernels
                               if any(k in name for k in HOP_KERNELS)][0][:80])


def child(tree: str, tag: str, parts) -> dict:
    """One turn in this process: `tree`'s own code for each of `parts`."""
    tree = str(Path(tree).resolve())
    sys.path[0] = tree  # in place of this script's directory
    os.chdir(tree)
    import torch

    import chip_smoke as c
    assert Path(c.__file__).resolve().parent == Path(tree), c.__file__
    t0 = time.perf_counter()
    c.phase_build()
    result = dict(tree=tree, tag=tag, card=c.card_line())
    if "hop" in parts:
        result.update(hop_part(c, torch))
        torch.cuda.empty_cache()
    if "attention" in parts:
        result.update(attention_part(c, torch))
    result["seconds"] = time.perf_counter() - t0
    return result


def attention_part(c, torch) -> dict:
    """The tree's chip_smoke phases 3, 3b and 30 and the timed U-ViT-H/2
    step."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    c.KERNEL_SHAPES, c.BWD_SHAPES = list(KERNEL_ROWS), list(BWD_ROWS)
    keep = ("shape", "loop", "ms", "ms_spread", "lse_ms", "library_ms", "library_ms_spread",
            "cold_ms", "library_cold_ms", "bound_ms", "max_rel_dev")
    fwd = [{k: r.get(k) for k in keep} for r in c.phase_kernel(gen)]
    bwd = [{k: r.get(k) for k in keep} for r in c.phase_backward(gen)]
    pipe = c.GenerationPipeline.from_config(HUGE, seed=0)
    c.set_attn_impl(pipe.nnet, "infer")
    printed = io.StringIO()

    class Tee(io.TextIOBase):
        def write(self, s):
            sys.__stdout__.write(s)
            return printed.write(s)

    with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stdout(Tee()):
        c.phase_uvit_huge(pipe, tmp)
    serving = next(json.loads(line.split(": ", 1)[1]) for line in printed.getvalue().splitlines()
                   if line.startswith("[30] U-ViT-H/2 ImageNet-256 serving: "))
    del pipe
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        trainer = huge_trainer(c, tmp)
        per_step = {"fused_attention_qkv": HUGE_BLOCKS, "fused_attention_qkv_vjp": HUGE_BLOCKS}
        _, step_s = c.phase_train(trainer, "ab", per_step, warmup=STEP_WARMUP, timed=STEP_TIMED)
        batch = next(trainer.data_stream(start_step=trainer.state.step))
        busy_ms = c.device_profile(
            lambda: [trainer.train_step(batch) for _ in range(STEP_PROFILED)], "ab",
            f"{STEP_PROFILED} train steps (batch {HUGE_BATCH})", step_s * STEP_PROFILED)
    return dict(kernel_rows=fwd, bwd_rows=bwd, request_latency_s=serving["latency_s"],
                mean_request_latency_s=serving["mean_latency_s"],
                step_ms=step_s * 1e3, step_device_busy_ms=busy_ms / STEP_PROFILED)


def summary(results: list) -> dict:
    """Medians per tree over its turns."""
    out = {}
    for tree in dict.fromkeys(r["tree"] for r in results):
        mine = [r for r in results if r["tree"] == tree]
        row = dict(turns=len(mine))
        for key in ("mean_request_latency_s", "step_ms", "step_device_busy_ms", "sp_step_ms",
                    "sp_step_device_busy_ms", "sp_step_hop_ms"):
            if key in mine[0]:
                row[key] = float(np.median([r[key] for r in mine]))
        for key, prefix in (("kernel_rows", "k1"), ("bwd_rows", "k2"), ("hop_rows", "hop")):
            for i, first in enumerate(mine[0].get(key, [])):
                fields = ("ms", "library_ms") + (("cold_ms", "library_cold_ms")
                                                 if key == "bwd_rows" else ())
                row[f"{prefix} {tuple(first['shape'])}"] = {
                    f: float(np.median([r[key][i][f] for r in mine])) for f in fields}
        out[tree] = row
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("tree_a")
    p.add_argument("tree_b")
    p.add_argument("--rounds", type=int, default=1)
    p.add_argument("--parts", nargs="+", choices=PARTS, default=list(PARTS))
    p.add_argument("--child", nargs=2, metavar=("TREE", "TAG"), help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.child:
        result = child(*args.child, args.parts)
        print("AB_RESULT " + json.dumps(result), flush=True)
        return 0
    OUT.mkdir(parents=True, exist_ok=True)
    results = []
    turn = 0
    for _ in range(args.rounds):
        for tree in (args.tree_a, args.tree_b, args.tree_b, args.tree_a):
            turn += 1
            tag = f"{turn:02d}-{Path(tree).resolve().name}"
            proc = subprocess.run(
                [sys.executable, str(Path(__file__).resolve()), args.tree_a, args.tree_b,
                 "--parts", *args.parts, "--child", tree, tag], capture_output=True, text=True)
            (OUT / f"{tag}.log").write_text(proc.stdout + proc.stderr)
            if proc.returncode:
                print(proc.stdout[-4000:] + proc.stderr[-4000:], file=sys.stderr)
                raise RuntimeError(f"turn {tag} failed with exit code {proc.returncode}")
            line = next(x for x in proc.stdout.splitlines() if x.startswith("AB_RESULT "))
            result = json.loads(line[len("AB_RESULT "):])
            (OUT / f"{tag}.json").write_text(json.dumps(result, indent=1))
            print(f"[ab] {tag}: {json.dumps(result)}", flush=True)
            results.append(result)
    print("[ab] medians per tree: " + json.dumps(summary(results), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
