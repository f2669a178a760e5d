"""The plain reference against the program at tiny sizes on the CPU: each
forward, the decoder, the solver, and every cell's whole run (its check
must read the two as equal to f32 rounding)."""
import time

import pytest
import torch

from benchmark import harness, weights
from benchmark.reference import serve, solver, uvit, vae
from benchmark.tests.tiny import SHRINK, shrink_of


def tiny_config(name):
    return harness.port_config(harness.load_json("configs", name), SHRINK[name])


def seeded_net(name, seed=3):
    from panopticdiffusionmodels_torch.models import get_nnet

    kwargs = dict(tiny_config(name).nnet)
    net = get_nnet(kwargs.pop("name"), **{**kwargs, "attn_impl": "plain"})
    w = weights.seeded(weights.shapes_of(net), seed, "cpu")
    net.load_state_dict(w)
    return net.eval(), w, dict(tiny_config(name).nnet)


def test_uvit_forward():
    net, w, s = seeded_net("imagenet256_uvit_large")
    g = torch.Generator().manual_seed(0)
    x = torch.randn((3, 4, 8, 8), generator=g)
    t = torch.tensor([3.0, 500.0, 999.0])
    y = torch.tensor([0, 7, 1000])
    with torch.no_grad():
        got = net(x, t, y)
    ref = uvit.uvit(w, s, x, t, y)
    assert torch.allclose(got, ref, rtol=0, atol=1e-5 * ref.abs().max())


def test_uvit_t2i_forward():
    net, w, s = seeded_net("mscoco_uvit_small")
    g = torch.Generator().manual_seed(1)
    x = torch.randn((2, 4, 8, 8), generator=g)
    ctx = torch.randn((2, 7, 16), generator=g)
    m = torch.randn((2, 8, 16, 16), generator=g)
    t = torch.tensor([10.0, 900.0])
    with torch.no_grad():
        noise, mask = net(x, t, ctx, mask_token=m)
    r_noise, r_mask = uvit.uvit_t2i(w, s, x, t, ctx, m)
    assert torch.allclose(noise, r_noise, rtol=0, atol=1e-5 * r_noise.abs().max())
    assert torch.allclose(mask, r_mask, rtol=0, atol=1e-5)


def test_vae_decoder():
    from panopticdiffusionmodels_torch.models.vae import AutoencoderKL

    geo = SHRINK["mscoco_uvit_small"]["vae_geometry"]
    model = AutoencoderKL(geo["ch"], tuple(geo["ch_mult"]), geo["num_res_blocks"],
                          scale_factor=0.2301)
    w = weights.seeded(weights.shapes_of(model), 5, "cpu")
    model.load_state_dict(w)
    z = torch.randn((2, 4, 8, 8), generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        got = model.decode(z)
    ref = vae.decode(w, z, 0.2301, geo)
    assert torch.allclose(got, ref, rtol=0, atol=1e-5 * ref.abs().max())


def test_solver_with_mask():
    from panopticdiffusionmodels_torch.diffusion.schedule import stable_diffusion_beta_schedule
    from panopticdiffusionmodels_torch.samplers.dpm_solver import DPMSolver
    from panopticdiffusionmodels_torch.samplers.noise_schedule import NoiseScheduleVP

    g = torch.Generator().manual_seed(4)
    a, b = torch.randn((4, 1, 1), generator=g), torch.randn((8, 1, 1), generator=g)

    def model(x, t, mask):  # a smooth toy network of (x, t, mask)
        tt = t[:, None, None, None] / 1000.0
        return (torch.tanh(x * a + tt) + 0.1 * mask.mean(1, keepdim=True)[:, :, ::2, ::2],
                torch.tanh(mask * b - tt + x.mean(1, keepdim=True).repeat_interleave(2, -1)
                           .repeat_interleave(2, -2)))

    x = torch.randn((2, 4, 8, 8), generator=g)
    m = torch.randn((2, 8, 16, 16), generator=g)
    ns = NoiseScheduleVP("discrete", betas=stable_diffusion_beta_schedule())
    port = DPMSolver(lambda xx, tt, mask_token=None: model(xx, tt * 1000, mask_token), ns)
    for steps in (4, 6, 50):  # plans ending in order 2, 1 and 3 + 2
        got_x, got_m = port.sample(x, steps=steps, eps=1e-3, T=1.0, order=3, method="fast",
                                   mask_token=m)
        ref_x, ref_m = solver.sample(model, solver.DiscreteVP(solver.sd_betas()), x, m, steps)
        assert torch.allclose(got_x, ref_x, rtol=0, atol=2e-5 * ref_x.abs().max()), steps
        assert torch.allclose(got_m, ref_m, rtol=0, atol=2e-5), steps


def test_bits_to_ids():
    mask = torch.tensor([1.0, -1.0, 0.5, -0.2, 0.0, 3.0, -3.0, 0.1]).reshape(1, 8, 1, 1)
    assert serve.bits_to_ids(mask, 8).item() == 0b10100101


# Cells held out of BENCHMARK.json whose files stay for a later benchmark to
# name again: (configuration, traffic mix); their limits are limits/<cell>.json.
HELD_OUT = {"uvitL256_train_b128": ("imagenet256_uvit_large", "fit")}
TRAFFIC = {w["name"]: w["traffic"] for w in harness.spec()["workloads"]}
TRAFFIC.update({c: traffic for c, (_, traffic) in HELD_OUT.items()})
CELLS = list(TRAFFIC)
TRAIN_CELLS = [c for c in CELLS if harness.load_json("traffic", TRAFFIC[c])["driver"] == "train"]


def context(cell, seed, trace):
    """A cell's context at tiny sizes on the CPU, held-out cells too."""
    if cell not in HELD_OUT:
        return harness.make_context(cell, seed, 0.3, trace, "cpu", shrink_of(cell))
    config, traffic = HELD_OUT[cell]
    return harness.Context(cell=cell, cfg=harness.load_json("configs", config),
                           traffic=harness.load_json("traffic", traffic),
                           limits=harness.load_json("limits", cell), seed=seed, seconds=0.3,
                           trace=bool(trace), device="cpu", shrink=SHRINK[config])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_run_agrees_with_the_reference(cell):
    ctx = context(cell, 2 ** 31 + 12345, 0)
    ctx.t_start = time.perf_counter()
    record = harness.module("drivers", ctx.traffic["driver"]).run(ctx)
    assert ctx.correct, ctx.checks
    assert record["attempted"] >= 1 and record["failed"] == 0
    gaps = {n: v for n, v, _ in ctx.checks}
    for name in ("image_rel_l2", "grad_gap", "ema_gap"):
        if name in gaps:
            assert gaps[name] < 1e-5, (name, gaps[name])


@pytest.mark.parametrize("cell", TRAIN_CELLS)
def test_traced_training_profiles_steps_of_fit(cell):
    """--trace 1: `profile_steps` more steps of the window's own `fit` run
    under the profiler after the window closes; the check and the
    per-layer metrics read as in an untraced run."""
    ctx = context(cell, 2 ** 31 + 54321, 1)
    ctx.t_start = time.perf_counter()
    cell_run = harness.module("drivers", ctx.traffic["driver"]).Cell(ctx)
    steps = []
    original = cell_run.before_step

    def before_step():
        steps.append(cell_run.profiler is not None)
        original()

    cell_run.before_step = before_step
    record = cell_run.run()
    assert ctx.correct, ctx.checks
    assert steps.count(True) == ctx.traffic["profile_steps"]
    assert record["trace_units"] == ctx.traffic["profile_steps"]
    assert 0 < record["trace"]["window_s"]
    wanted = {"idle_share.train", "mfu.train", "peak_mem_gib.train"}
    if cell in HELD_OUT:  # no metric of BENCHMARK.json names it: read its readers
        metrics = {n for n in wanted if harness.metric_reader(n)(record) is not None}
    else:
        metrics = set(harness.result(ctx, record)["metrics"])
    assert wanted <= metrics
