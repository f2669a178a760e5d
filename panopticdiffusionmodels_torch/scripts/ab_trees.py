"""Two checkouts of the repository against each other on one card, in turns.

Each turn is a fresh process of one tree that runs that tree's own
`chip_smoke.py` phases: phase 3 (kernel 1 against its plain version, timed in
turns with SDPA) and phase 3b (kernel 2, timed in turns with SDPA's backward)
at the rows given, and phase 30 (U-ViT-H/2 serving: 3 requests of 32 labels
at 50 steps, and the kernel-vs-plain parity step); then a U-ViT-H/2
`latent_discrete` training step at batch 32 timed through that tree's
`Trainer.fit` (`phase_train`: 3 warm-up and 20 timed steps, 29 + 29 kernel
calls a step) and its device time under the profiler (`device_profile` over
3 steps: the kernels' busy ms a step, which the host-bound step's wall time
can hide).  Trees run in the order A, B, B, A for every round, so that both
share the card's state.

    python3 panopticdiffusionmodels_torch/scripts/ab_trees.py build/parent . --rounds 1

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
HUGE = "imagenet256_uvit_huge"
HUGE_BLOCKS, HUGE_BATCH = 29, 32
STEP_WARMUP, STEP_TIMED, STEP_PROFILED = 3, 20, 3
OUT = Path("chiprun_out") / "ab_trees"


def child(tree: str, tag: str) -> dict:
    """One turn in this process: `tree`'s chip_smoke phases 3, 3b and 30 and
    the timed U-ViT-H/2 step."""
    tree = str(Path(tree).resolve())
    sys.path[0] = tree  # in place of this script's directory
    os.chdir(tree)
    import torch

    import chip_smoke as c
    assert Path(c.__file__).resolve().parent == Path(tree), c.__file__
    t0 = time.perf_counter()
    c.phase_build()
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
    config = c.get_config(HUGE)
    h, w, ch = config.z_shape
    config.dataset = c.d(name="synthetic", style="imagenet", n=4 * HUGE_BATCH,
                         z_shape=(h, w, 2 * ch), num_classes=1000)
    config.train.batch_size = HUGE_BATCH
    config.num_workers = 0
    with tempfile.TemporaryDirectory() as tmp:
        trainer = c.Trainer(config, os.path.join(tmp, "run"), device="cuda")
        per_step = {"fused_attention_qkv": HUGE_BLOCKS, "fused_attention_qkv_vjp": HUGE_BLOCKS}
        _, step_s = c.phase_train(trainer, "ab", per_step, warmup=STEP_WARMUP, timed=STEP_TIMED)
        batch = next(trainer.data_stream(start_step=trainer.state.step))
        busy_ms = c.device_profile(
            lambda: [trainer.train_step(batch) for _ in range(STEP_PROFILED)], "ab",
            f"{STEP_PROFILED} train steps (batch {HUGE_BATCH})", step_s * STEP_PROFILED)
    result = dict(tree=tree, tag=tag, card=c.card_line(), kernel_rows=fwd, bwd_rows=bwd,
                  request_latency_s=serving["latency_s"],
                  mean_request_latency_s=serving["mean_latency_s"],
                  step_ms=step_s * 1e3, step_device_busy_ms=busy_ms / STEP_PROFILED,
                  seconds=time.perf_counter() - t0)
    return result


def summary(results: list) -> dict:
    """Medians per tree over its turns."""
    out = {}
    for tree in dict.fromkeys(r["tree"] for r in results):
        mine = [r for r in results if r["tree"] == tree]
        row = dict(turns=len(mine),
                   mean_request_latency_s=float(np.median(
                       [r["mean_request_latency_s"] for r in mine])),
                   step_ms=float(np.median([r["step_ms"] for r in mine])),
                   step_device_busy_ms=float(np.median(
                       [r["step_device_busy_ms"] for r in mine])))
        for key in ("kernel_rows", "bwd_rows"):
            for i, first in enumerate(mine[0][key]):
                name = f"{'k1' if key == 'kernel_rows' else 'k2'} {tuple(first['shape'])}"
                row[name] = {f: float(np.median([r[key][i][f] for r in mine]))
                             for f in ("ms", "library_ms") + (("cold_ms", "library_cold_ms")
                                                             if key == "bwd_rows" else ())}
        out[tree] = row
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("tree_a")
    p.add_argument("tree_b")
    p.add_argument("--rounds", type=int, default=1)
    p.add_argument("--child", nargs=2, metavar=("TREE", "TAG"), help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.child:
        result = child(*args.child)
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
                 "--child", tree, tag], capture_output=True, text=True)
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
