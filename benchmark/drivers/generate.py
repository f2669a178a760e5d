"""Closed-loop generation: one client sends requests of a fixed number of
images through `GenerationPipeline.generate_batches` (dispatched one deep)
until the window closes, then a sample of the finished images, drawn from
the seed, is generated again by the plain reference and compared.

The traffic file gives `request_images` (images a request) and
`check_images` (images the reference regenerates).  A request's
conditioning is drawn from (seed, request); its noise is the pipeline's own
draw, which the reference takes again from the seed the pipeline states for
batch i of a call, numpy's SeedSequence([seed, i]).
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from .. import harness, weights, work
from ..harness import note
from ..reference import serve
from ..reference import uvit as ref_uvit

WARMUP, WINDOW, SLICE = 0, 1, 2  # which generate_batches call a noise seed is for


def batch_seed(seed, i):
    return int(np.random.SeedSequence([seed, i]).generate_state(1)[0])


class Cell:
    def __init__(self, ctx):
        self.ctx = ctx
        self.config = harness.port_config(ctx.cfg, ctx.shrink)
        self.family = harness.module("families", ctx.cfg["family"])
        self.sizes = dict(self.config.nnet)
        self.n = (ctx.shrink or {}).get("request_images", ctx.traffic["request_images"])
        self.steps = self.config.sample.sample_steps
        self.scale = float(self.config.sample.scale) if self.config.sample.cfg else 0.0

    def noise_seed(self, call):
        return weights.derive(self.ctx.seed, 5, call)

    def cond(self, i):
        g = torch.Generator(device=self.ctx.device).manual_seed(weights.derive(self.ctx.seed, 4, i))
        return self.family.draw_cond(self.sizes, self.n, g, self.ctx.device)

    def build(self):
        from panopticdiffusionmodels_torch.models import get_nnet
        from panopticdiffusionmodels_torch.models.vae import AutoencoderKL
        from panopticdiffusionmodels_torch.serving import GenerationPipeline

        ctx, dev = self.ctx, self.ctx.device
        kwargs = dict(self.config.nnet)
        name = kwargs.pop("name")
        with torch.device("meta"):
            nnet = get_nnet(name, **kwargs)
            vae = AutoencoderKL(scale_factor=self.config.autoencoder.scale_factor,
                                **{k: tuple(v) if isinstance(v, list) else v
                                   for k, v in ctx.geometry.items()})
        dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[self.config.compute_dtype]
        self.w_net = weights.seeded(weights.shapes_of(nnet), weights.derive(ctx.seed, 1), dev,
                                    dtype)
        self.w_vae = weights.seeded(weights.shapes_of(vae), weights.derive(ctx.seed, 2), dev)
        nnet = nnet.to_empty(device=dev)
        nnet.load_state_dict(self.w_net)
        vae = vae.to_empty(device=dev)
        vae.load_state_dict(self.w_vae)
        note(ctx, "weights")
        g = torch.Generator(device=dev).manual_seed(weights.derive(ctx.seed, 3))
        self.uncond = self.family.uncond(self.sizes, g, dev)
        empty = self.uncond.cpu().numpy() if torch.is_tensor(self.uncond) else None
        self.pipe = GenerationPipeline(self.config, nnet, vae, empty, device=dev)

    def request(self, i):
        return self.family.request(self.cond(i))

    def run_requests(self, call, indices, on_result=None):
        outs = []
        for out in self.pipe.generate_batches((self.request(i) for i in indices),
                                              seed=self.noise_seed(call)):
            outs.append(out if isinstance(out, tuple) else (out,))
            if on_result is not None:
                on_result(outs[-1])
        return outs

    def window(self):
        """The timed window: requests until `seconds` have passed, the last
        dispatched one drained."""
        ctx = self.ctx
        sync(ctx.device)
        torch.cuda.reset_peak_memory_stats() if ctx.device == "cuda" else None
        t0 = time.perf_counter()
        deadline = t0 + ctx.seconds
        stamps, nfe = [], []

        def feed():
            i = 0
            while time.perf_counter() < deadline:
                yield i
                i += 1

        def done(_):
            stamps.append(time.perf_counter())
            nfe.append(self.pipe.last_real_evals)

        outs = self.run_requests(WINDOW, feed(), done)
        sync(ctx.device)
        t1 = time.perf_counter()
        return outs, dict(t0=t0, t1=t1, stamps=stamps, nfe=nfe)

    def work_per_request(self):
        cfg_batch = 2 * self.n if self.scale else self.n
        h, w, _ = self.config.z_shape
        return (self.steps * self.family.forward_flops(self.sizes, cfg_batch)
                + self.n * work.vae_decoder(self.ctx.geometry, h, w))

    def traced_slice(self):
        """One request under the profiler, after the window."""
        return harness.profiled(lambda: (self.run_requests(SLICE, [10 ** 6]),
                                         sync(self.ctx.device)), self.ctx.device)

    # --- the check -----------------------------------------------------------

    def noise(self, i):
        """Window request i's noise (z, m0), drawn as the pipeline states."""
        h, w, c = self.config.z_shape
        g = torch.Generator(device=self.ctx.device).manual_seed(
            batch_seed(self.noise_seed(WINDOW), i))
        z = torch.randn((self.n, c, h, w), generator=g, device=self.ctx.device)
        if self.family.REFERENCE != "uvit_t2i":
            return z, None
        ms, bits = self.sizes["mask_size"], self.sizes["mask_bits"]
        return z, torch.randn((self.n, bits, ms, ms), generator=g, device=self.ctx.device)

    def reference(self, picked, quant=ref_uvit.identity):
        """The reference's images (and ids) of the picked window images,
        flat indices request * n + row, in one batch."""
        conds, zs, ms = [], [], []
        for p in picked:
            i, r = divmod(p, self.n)
            z, m0 = self.noise(i)
            conds.append(self.cond(i)[r:r + 1])
            zs.append(z[r:r + 1])
            ms.append(None if m0 is None else m0[r:r + 1])
        w_net = {k: v.float() for k, v in self.w_net.items()}
        return serve.generate(self.family.REFERENCE, w_net, self.w_vae, self.sizes,
                              torch.cat(conds), torch.cat(zs),
                              None if ms[0] is None else torch.cat(ms), self.scale,
                              self.uncond, self.config.autoencoder.scale_factor, self.steps,
                              self.ctx.geometry, quant)

    def pick(self, requests):
        ctx = self.ctx
        total = requests * self.n
        k = min((ctx.shrink or {}).get("check_images", ctx.traffic["check_images"]), total)
        rng = np.random.default_rng(weights.derive(ctx.seed, 8))
        return sorted(rng.choice(total, size=k, replace=False).tolist())

    def check(self, outs, control_quant=None):
        """Compare a sample of the finished images, drawn from the seed, with
        the reference's: the worst image's relative L2 gap and, for a
        panoptic model, the worst image's share of mask ids that differ.
        With `control_quant` the reference in that precision stands in the
        program's place."""
        ctx = self.ctx
        picked = self.pick(len(outs))
        ctx.check("images_missing", len(outs) * self.n - sum(o[0].shape[0] for o in outs), 0)
        with reference_precision():
            ref = self.reference(picked)
            if control_quant is not None:
                got = self.reference(picked, control_quant)
            else:
                got = tuple(torch.stack([torch.as_tensor(outs[p // self.n][f][p % self.n])
                                         for p in picked]).to(ctx.device)
                            for f in range(len(outs[0])))
        diff = (got[0].float() - ref[0]).flatten(1).norm(dim=1) / ref[0].flatten(1).norm(dim=1)
        ctx.check("image_rel_l2", float(diff.max()))
        if ref[1] is not None:
            wrong = (got[1].long() != ref[1]).flatten(1).float().mean(1)
            ctx.check("ids_mismatch", float(wrong.max()))
        return picked

    # --- the run -------------------------------------------------------------

    def run(self):
        ctx = self.ctx
        self.build()
        note(ctx, "built")
        self.run_requests(WARMUP, [2 ** 30])
        sync(ctx.device)
        setup_s = time.perf_counter() - ctx.t_start
        note(ctx, "warm")
        outs, win = self.window()
        note(ctx, f"window: {len(outs)} requests")
        peak = torch.cuda.max_memory_allocated() if ctx.device == "cuda" else 0
        window_s = win["t1"] - win["t0"]
        images = len(outs) * self.n
        record = dict(
            attempted=len(outs), failed=0, peak_bytes=peak, window_s=window_s,
            request_s=list(np.diff([win["t0"]] + win["stamps"])), nfe=win["nfe"],
            flops=len(outs) * self.work_per_request(),
            end_to_end={"gen_images_per_s": images / window_s, "setup_s": setup_s})
        if ctx.trace:
            cfg_batch = 2 * self.n if self.scale else self.n
            record.update(trace=self.traced_slice(), trace_units=1, trace_attention=[
                (b, l, h, d, n * self.steps)
                for b, l, h, d, n in self.family.attention_calls(self.sizes, cfg_batch)])
        note(ctx, "traced" if ctx.trace else "window read")
        self.pipe = None
        free(ctx.device)
        self.check(outs)
        note(ctx, "checked")
        return record


def sync(device):
    if device == "cuda":
        torch.cuda.synchronize()


def free(device):
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()


class reference_precision:
    """f32 matmuls and convolutions without TF32, for the reference's run."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved


def run(ctx):
    return Cell(ctx).run()
