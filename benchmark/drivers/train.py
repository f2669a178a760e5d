"""Training through `Trainer.fit`: feature files written from the seed in the
config dataset's format feed the config's own loader; the seeded weights
reach the trainer through `TrainState.load_state_dict` at step 0 (a
fine-tune also reads the config's pretrained file, written from them, which
turns its frozen image stream on).  The EMA starts from a seeded draw of its
own, away from the parameters, so that its update moves it by far more than
f32 rounding in a few steps.

Set-up drives the one trainer through its first `check_steps` steps by
`fit` (the window's own call and feed), keeping what the check needs: the
rows each step was fed, each step's loss parts, the first moment after step
1 (the first gradient as the optimizer got it), and the parameters and
their EMA after the last of them.  The window is `fit` again on the same
trainer until `seconds` have passed; the feed then waits for the device and
ends it (with --trace 1 after `profile_steps` more steps of that same `fit`
under the profiler).  The reference follows the checked steps from the same
weights, on the fed rows (checked exact against the written files) and its
own draws.
"""
from __future__ import annotations

import gc
import json
import os
import statistics
import tempfile
import time

import torch

from .. import harness, weights
from ..harness import note
from ..reference import train as ref_train
from ..reference import uvit as ref_uvit
from .generate import free, reference_precision, sync


class WindowClosed(Exception):
    pass


class Cell:
    def __init__(self, ctx):
        self.ctx = ctx
        self.config = harness.port_config(ctx.cfg, ctx.shrink)
        self.family = harness.module("families", ctx.cfg["family"])
        self.dataset = harness.module("datasets", self.config.dataset.name)
        self.sizes = dict(self.config.nnet)
        self.batch = self.config.train.batch_size
        self.fine_tune = bool(ctx.cfg["fine_tune"])
        self.check_steps = ctx.traffic["check_steps"]
        self.fed, self.losses, self.streams = [], [], []
        self.deadline = self.t_end = self.trace = self.profiler = None
        self.last = None

    # --- the trainer ---------------------------------------------------------

    def build(self, tmp):
        from panopticdiffusionmodels_torch.models import get_nnet
        from panopticdiffusionmodels_torch.train.trainer import Trainer

        ctx, dev, config = self.ctx, self.ctx.device, self.config
        config.seed = weights.derive(ctx.seed, 10) % 2 ** 31
        config.workdir = os.path.join(tmp, "work")
        config.dataset.path = os.path.join(tmp, "data")
        rows = ctx.traffic["epoch_batches"] * self.batch
        g = torch.Generator(device=dev).manual_seed(weights.derive(ctx.seed, 11))
        self.data = self.dataset.write(config.dataset.path, rows, config, g, dev)
        note(ctx, f"features: {rows} rows")
        kwargs = dict(config.nnet)
        with torch.device("meta"):
            shapes = weights.shapes_of(get_nnet(kwargs.pop("name"), **kwargs))
        self.w0 = weights.seeded(shapes, weights.derive(ctx.seed, 1), dev)
        config.pretrained = ""
        if self.fine_tune:
            config.pretrained = os.path.join(tmp, "pretrained.pth")
            torch.save({k: v.cpu() for k, v in self.w0.items()}, config.pretrained)
        note(ctx, "weights")
        trainer = Trainer(config, workdir=config.workdir, device=dev)
        e0 = weights.seeded(shapes, weights.derive(ctx.seed, 2), dev)
        self.e0 = {n: e0[n] for n in trainer.state.ema}
        trainer.state.load_state_dict({
            "step": 0, "params": {n: self.w0[n] for n in trainer.state.params},
            "ema_params": self.e0, "opt_state": trainer.state.optimizer.state_dict()})
        step, stream = trainer.train_step, trainer.data_stream

        def train_step(batch, noise=None):
            self.last = step(batch, noise)
            if len(self.losses) < self.check_steps:
                self.losses.append([self.last[k].detach().clone()
                                    for k in ("loss", "loss_mask") if k in self.last])
            return self.last

        def data_stream(start_step=0):
            inner = stream(start_step)
            self.streams.append(inner)
            for batch in inner:
                if len(self.fed) < self.check_steps:
                    fields = batch if isinstance(batch, tuple) else (batch,)
                    self.fed.append(tuple(t.clone() for t in fields))
                self.before_step()
                yield batch

        trainer.train_step, trainer.data_stream = train_step, data_stream
        self.trainer = trainer

    def fit(self, max_steps=None):
        try:
            self.trainer.fit(max_steps=max_steps)
        except WindowClosed:
            pass
        finally:
            for s in self.streams:
                s.close()
            self.streams.clear()

    def before_step(self):
        """Called as each step takes its batch.  At the deadline: wait for the
        device and end the window; with --trace 1, then let `fit` run
        `profile_steps` more steps under the profiler, from and to an idle
        device, before it ends."""
        if self.deadline is None:
            return
        if self.profiler is not None:
            self.profile_left -= 1
            if self.profile_left > 0:
                return
            self.trace = self.profiler.stop()
            raise WindowClosed
        if time.perf_counter() < self.deadline:
            return
        sync(self.ctx.device)
        self.t_end = time.perf_counter()
        self.steps_done = self.trainer.state.step - self.start_step
        float(self.last["loss"])  # the last step's loss on the host ends the window
        self.peak = torch.cuda.max_memory_allocated() if self.ctx.device == "cuda" else 0
        if not self.ctx.trace:
            raise WindowClosed
        self.profiler = harness.Profiler(self.ctx.device)
        self.profiler.start()
        self.profile_left = self.ctx.traffic["profile_steps"]

    def step_rates(self):
        """fit's own steps/s of the log intervals inside the window, the
        first (which holds fit's start) left out unless it is the only one."""
        path = os.path.join(self.config.workdir, "metrics.jsonl")
        if not os.path.exists(path):
            return []
        with open(path) as f:
            lines = [json.loads(x) for x in f if x.strip()]
        end = self.start_step + self.steps_done
        rates = [m["steps_per_sec"] for m in lines if self.start_step < m["step"] <= end]
        return rates[1:] or rates

    # --- the run ---------------------------------------------------------------

    def run(self):
        ctx = self.ctx
        with tempfile.TemporaryDirectory() as tmp:
            self.build(tmp)
            note(ctx, "built")
            opt = self.trainer.state.optimizer
            self.fit(1)
            beta1 = opt.param_groups[0]["betas"][0]
            self.g1 = {n: opt.state[p]["exp_avg"] / (1.0 - beta1)
                       for n, p in self.trainer.state.params.items() if p in opt.state}
            self.fit(self.check_steps)
            self.p3 = {n: p.detach().clone() for n, p in self.trainer.state.params.items()}
            self.e3 = {n: e.detach().clone() for n, e in self.trainer.state.ema.items()}
            self.losses = [[float(x) for x in parts] for parts in self.losses]
            sync(ctx.device)
            setup_s = time.perf_counter() - ctx.t_start
            note(ctx, f"{self.check_steps} steps")
            self.start_step = self.trainer.state.step
            if ctx.device == "cuda":
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            self.deadline = t0 + ctx.seconds
            self.fit()
            window_s = self.t_end - t0
            images = self.steps_done * self.batch
            record = dict(
                attempted=self.steps_done, failed=0, peak_bytes=self.peak, window_s=window_s,
                flops=self.steps_done * self.family.train_flops(self.sizes, self.batch,
                                                                self.fine_tune),
                steps_per_sec=self.step_rates(),
                end_to_end={"train_images_per_s": images / window_s, "setup_s": setup_s})
            if self.trace is not None:
                n = ctx.traffic["profile_steps"]
                record.update(trace=self.trace, trace_units=n, trace_attention=[
                    (b, l, h, d, c * n)
                    for b, l, h, d, c in self.family.attention_calls(self.sizes, self.batch)])
            note(ctx, f"window: {self.steps_done} steps")
            self.trainer = self.last = None
            free(ctx.device)
        self.check()
        note(ctx, "checked")
        return record

    # --- the check -------------------------------------------------------------

    def reference_steps(self, quant=ref_uvit.identity):
        """The reference's checked steps from the seeded weights and EMA:
        (loss parts of each step, the first step's gradients, the parameters
        and the EMA after the last step, the trained names)."""
        config, dev = self.config, self.ctx.device
        h, w, c = config.z_shape
        mask = ((self.sizes["mask_size"], self.sizes["mask_bits"])
                if self.family.REFERENCE == "uvit_t2i" else None)
        weights_now = {k: v.clone() for k, v in self.w0.items()}
        ema = {k: v.clone() for k, v in self.e0.items()}
        trained = [n for n in ema if n not in ref_train.frozen(ema, self.fine_tune)]
        opt = ref_train.AdamW(trained, config.optimizer.lr,
                              config.lr_scheduler.get("warmup_steps", -1),
                              config.optimizer.betas, config.optimizer.weight_decay)
        rows = (self.ctx.shrink or {}).get("reference_rows", 16)
        losses, g1 = [], None
        for k in range(1, self.check_steps + 1):
            d = ref_train.draws(config.seed, k, self.batch, (h, w, 2 * c), mask,
                                ref_train.solver.N_TRAIN, dev)
            parts, grads = ref_train.loss_and_grads(
                self.family.REFERENCE, weights_now, self.sizes, self.fed[k - 1], d,
                config.autoencoder.scale_factor, trained, rows, quant)
            losses.append(parts)
            g1 = grads if g1 is None else g1
            opt.step(weights_now, grads)
            ref_train.ema_update(ema, weights_now, config.ema_rate)
        return losses, g1, weights_now, ema, trained

    def compare(self, losses, g1, p3, e3, ref):
        """Set the compared numbers of a run (the program's, or the control's)
        against the reference's."""
        ctx = self.ctx
        r_losses, r_g1, r_p3, r_e3, trained = ref
        ctx.check("trained_leaves_differ", len(set(trained) ^ set(g1)), 0)
        names = [n for n in trained if n in g1]
        if not names:  # the optimizer took no step: nothing to compare is a failure
            ctx.check("grad_gap", float("inf"))
            ctx.check("update_gap", float("inf"))
            ctx.check("ema_gap", float("inf"))
            return
        gp = {n: float(g1[n].norm()) for n in names}
        gr = {n: float(r_g1[n].norm()) for n in names}
        med = statistics.median(gr.values())
        grad = {n: abs(gp[n] - gr[n]) / max(gr[n], med) for n in names}
        ctx.check("grad_gap", max(grad.values()))
        moved = [n for n in names if gr[n] >= 1e-3 * med]
        update = self.change_gaps(p3, r_p3, self.w0, moved)
        ctx.check("update_gap", max(update.values()))
        ema = self.change_gaps(e3, r_e3, self.e0, list(r_e3))
        ctx.check("ema_gap", max(ema.values()))
        for key, gaps in (("grad", grad), ("update", update), ("ema", ema)):
            worst = sorted(gaps, key=gaps.get)[-3:]
            ctx.details[key] = {
                "median": statistics.median(gaps.values()),
                "p90": statistics.quantiles(gaps.values(), n=10)[-1],
                "worst": [[n, gaps[n], self.w0[n].numel()] for n in worst]}
        # The loss parts are reported, not compared: the mean of squares
        # hides a lower precision's rounding (fp8 moved it less than bf16
        # on some seeds), so no limit separates the two.
        ctx.details["loss_gap"] = max(abs(a - b) / abs(b) for pa, pb in zip(losses, r_losses)
                                      for a, b in zip(pa, pb))
        ctx.details["loss"] = [[list(a), list(b)] for a, b in zip(losses, r_losses)]

    @staticmethod
    def change_gaps(got, ref, start, names):
        """Each leaf's gap between the norms of its change from `start`, the
        program's and the reference's, over the larger of the reference's
        norm and the median leaf's."""
        dp = {n: float((got[n] - start[n]).norm()) for n in names}
        dr = {n: float((ref[n] - start[n]).norm()) for n in names}
        med = statistics.median(dr.values())
        return {n: abs(dp[n] - dr[n]) / max(dr[n], med) for n in names}

    def check(self, control_quant=None):
        self.ctx.check("rows_unmatched", sum(self.dataset.check(self.data, b) for b in self.fed), 0)
        with reference_precision():
            ref = self.reference_steps()
            if control_quant is None:
                self.compare(self.losses, self.g1, self.p3, self.e3, ref)
            else:
                self.compare(*self.reference_steps(control_quant)[:4], ref)
        gc.collect()


def run(ctx):
    return Cell(ctx).run()
