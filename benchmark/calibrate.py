"""The readings that a cell's limits are set from, in one process: the
program's compared numbers on many seeds (each a whole run with a short
window), and the control's on a few: the plain reference computed in fp8
(every product's operands rounded to float8 e4m3 and the gradients that
reach them to e5m2, each at a per-tensor scale: the step below the
configuration's bf16) put in the program's place.

    python3 -m benchmark.calibrate --workload <cell> --seeds 1,2,3 \
        --control-seeds 4,5,6 [--seconds 2] [--out chiprun_out/calibrate.jsonl]
    python3 -m benchmark.calibrate --workload <cell> --seeds 1,2,3 --fault half_batch

Prints one JSON line per run and a summary: each number's largest program
reading (the lower end of its limit) and smallest control reading (the
upper end).  With --fault the program's runs carry that planted fault
(`FAULTS`), whose readings can set an upper end too.  Runs on the card;
the benchmark's own runs never run it.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import tempfile
import time

import torch

from . import harness


class _Fp8(torch.autograd.Function):
    """Forward: t rounded to float8 e4m3; backward: the incoming gradient
    rounded to float8 e5m2; each at a per-tensor scale that maps its
    largest magnitude to the format's largest finite value."""

    @staticmethod
    def forward(ctx, t):
        return _round(t, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, 57344.0)


def _round(t, dtype, top):
    scale = t.abs().amax().clamp_min(1e-30) / top
    return (t / scale).to(dtype).to(t.dtype) * scale


def fp8(t):
    """The control's rounding of every product's operand (the fp8 training
    recipe: e4m3 values, e5m2 gradients)."""
    return _Fp8.apply(t)


def _solver_step_keeps_state():
    from panopticdiffusionmodels_torch.samplers.dpm_solver import DPMSolver

    def keep(orig):
        def kept(self, x, c, mask_t, *a, **k):
            _, pm, _, fc = orig(self, x, c, mask_t, *a, **k)
            return x, pm, mask_t, fc
        return kept

    return [(DPMSolver, n, keep) for n in ("_first_update", "_second_update", "_third_update")]


def _answer_altered():
    from panopticdiffusionmodels_torch.serving import GenerationPipeline

    def alter(orig):
        def altered(self, images, pred_mask):
            out = orig(self, images, pred_mask)
            first = out[0] if isinstance(out, tuple) else out
            first[:, :4, :4] = 1.0 - first[:, :4, :4]
            if isinstance(out, tuple):
                out[1][:, 0] += 1
            return out
        return altered

    return [(GenerationPipeline, "_postprocess", alter)]


def _update_skipped():
    from panopticdiffusionmodels_torch.train.state import TrainState

    def skip(orig):
        def skipped(self, ema_rate=0.9999):
            self.step += 1
        return skipped

    return [(TrainState, "apply_gradients", skip)]


def _ema_skipped():
    from panopticdiffusionmodels_torch.train.state import TrainState

    def skip(orig):
        def skipped(self, ema_rate=0.9999):
            orig(self, 1.0)  # the optimizer's step; the EMA left as it was
        return skipped

    return [(TrainState, "apply_gradients", skip)]


def _half_batch():
    from panopticdiffusionmodels_torch.train.trainer import Trainer

    def halve(orig):
        def half(self, batch, noise):
            n = batch[0].shape[0] // 2
            return orig(self, tuple(x[:n] for x in batch), {k: v[:n] for k, v in noise.items()})
        return half

    return [(Trainer, "_loss", halve)]


def _leaf_altered():
    from panopticdiffusionmodels_torch.train.state import TrainState

    def alter(orig):
        def altered(self, ema_rate=0.9999):
            orig(self, ema_rate)
            with torch.no_grad():
                next(p for n, p in self.params.items() if n not in self.frozen).add_(1e-6)
        return altered

    return [(TrainState, "apply_gradients", alter)]


# The faults a cell's check must catch, planted in the program: a sampler
# step, an optimizer step or the EMA's update that returns its state
# unchanged, an answer altered where it is produced (a corner of every
# image, a column of ids; a parameter leaf after the update), the loss's
# mean taken over half the batch.
FAULTS = {"generate": {"solver_step_keeps_state": _solver_step_keeps_state,
                       "answer_altered": _answer_altered},
          "train": {"update_skipped": _update_skipped, "ema_skipped": _ema_skipped,
                    "half_batch": _half_batch, "leaf_altered": _leaf_altered}}


@contextlib.contextmanager
def planted(driver, name):
    """The program with fault `name` of a `driver`'s cells planted."""
    patches = FAULTS[driver][name]()
    saved = [(cls, attr, cls.__dict__[attr]) for cls, attr, _ in patches]
    try:
        for cls, attr, make in patches:
            setattr(cls, attr, make(getattr(cls, attr)))
        yield
    finally:
        for cls, attr, orig in saved:
            setattr(cls, attr, orig)


def program_run(cell, seed, seconds, device="cuda", shrink=None):
    ctx = harness.make_context(cell, seed, seconds, 0, device, shrink)
    ctx.t_start = time.perf_counter()
    harness.module("drivers", ctx.traffic["driver"]).run(ctx)
    return ctx


def control_run(cell, seed, seconds, device="cuda", shrink=None):
    """The control: the cell's set-up and window as a run makes them, then
    its check with the fp8 reference in the program's place."""
    ctx = harness.make_context(cell, seed, seconds, 0, device, shrink)
    ctx.t_start = time.perf_counter()
    driver = harness.module("drivers", ctx.traffic["driver"])
    c = driver.Cell(ctx)
    if ctx.traffic["driver"] == "generate":
        c.build()
        outs, _ = c.window()
        c.check(outs, control_quant=fp8)
    else:
        with tempfile.TemporaryDirectory() as tmp:
            c.build(tmp)
            c.fit(c.check_steps)
            c.trainer = c.last = None
        c.check(control_quant=fp8)
    return ctx


def summary(rows):
    out = {}
    for kind in ("program", "control"):
        for r in rows:
            if r["kind"] != kind:
                continue
            for name, v in r["checks"].items():
                slot = out.setdefault(name, {})
                key = "program_max" if kind == "program" else "control_min"
                pick = max if kind == "program" else min
                slot[key] = v if key not in slot else pick(slot[key], v)
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--fault", default="", help="plant this fault in the program's runs")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    from .run import cache_dirs

    cache_dirs(str(harness.ROOT))
    rows = []
    plan = [("program", int(s)) for s in args.seeds.split(",") if s] + \
        [("control", int(s)) for s in args.control_seeds.split(",") if s]
    for kind, seed in plan:
        t0 = time.perf_counter()
        run = program_run if kind == "program" else control_run
        driver = harness.load_json("traffic", harness.cell(args.workload)["traffic"])["driver"]
        with (planted(driver, args.fault) if args.fault and kind == "program"
              else contextlib.nullcontext()):
            ctx = run(args.workload, seed, args.seconds)
        label = args.fault if kind == "program" and args.fault else kind
        row = {"kind": label, "workload": args.workload, "seed": seed,
               "seconds": time.perf_counter() - t0, "correct": ctx.correct,
               "checks": {n: v for n, v, _ in ctx.checks}, "details": ctx.details}
        rows.append(row)
        print(json.dumps(row), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
        torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload, "summary": summary(rows)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
