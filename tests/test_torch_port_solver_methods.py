"""Every DPM-Solver method and option of the port against the JAX `DPMSolver`.

Both solvers drive the same random-weight model from the same numpy noise:
a per-pixel network, 0.8 x plus a tanh layer with numpy-seeded weights (cheap to
compile, so every method and option runs), and for both forms of both
schedules on the serving plan the tiny U-ViT of
`torch_port_pixel_common.py` at depth 2.  The model is the continuous score
model's noise prediction on the linear schedule (the `pixel_sde` serving
path) or the network on the discrete Stable Diffusion betas.  Trajectories
must match at f32 rtol 1e-4 / atol 1e-5 (elementwise arithmetic and small
matrix products, summed in another order), and the port's `real_evals` must
equal the number of evals the JAX solver makes (its model counts its calls;
multistep is unrolled and adaptive is a host loop, so each call is one
eval).  The mask options run a closed-form masked model, the
`update_mask=False` path of the panoptic model.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panopticdiffusionmodels_tpu.diffusion import sde as jsde
from panopticdiffusionmodels_tpu.samplers import dpm_solver as jdpm
from panopticdiffusionmodels_tpu.samplers.noise_schedule import NoiseScheduleVP as JaxNS
from panopticdiffusionmodels_torch.diffusion import sde
from panopticdiffusionmodels_torch.diffusion.schedule import stable_diffusion_beta_schedule
from panopticdiffusionmodels_torch.samplers import dpm_solver as dpm
from panopticdiffusionmodels_torch.samplers.noise_schedule import NoiseScheduleVP
from torch_port_pixel_common import close, jax_apply, models, nhwc

BETAS = stable_diffusion_beta_schedule()
DEPTH = 2


def schedules(kind):
    if kind == "linear":
        return NoiseScheduleVP("linear"), JaxNS("linear")
    return NoiseScheduleVP("discrete", betas=BETAS), JaxNS("discrete", betas=BETAS)


_rng = np.random.default_rng(0)
W1 = (_rng.standard_normal((3, 16)) * 0.5).astype(np.float32)
W2 = (_rng.standard_normal((16, 3)) * 0.5).astype(np.float32)


def mlp_port(x, t):
    """The per-pixel network on NCHW tensors, t the network's time: most of
    x (a noise prediction that keeps the trajectory bounded) and a random
    tanh layer."""
    h = torch.tanh(x.permute(0, 2, 3, 1) @ torch.from_numpy(W1) + 1e-3 * t[:, None, None, None])
    return 0.8 * x + 0.2 * (h @ torch.from_numpy(W2)).permute(0, 3, 1, 2)


def mlp_jax(x, t):
    """The same network on NHWC arrays."""
    return 0.8 * x + 0.2 * (jnp.tanh(x @ W1 + 1e-3 * t[:, None, None, None]) @ W2)


def model_fns(kind, net="mlp"):
    """(port model_fn on NCHW, JAX model_fn on NHWC, JAX eval counter)."""
    count = [0]
    if net == "uvit":
        port_net, jax_net = (lambda x, t: models(-1, DEPTH)[0](x, t)), jax_apply(-1, DEPTH)
    else:
        port_net, jax_net = mlp_port, mlp_jax
    if kind == "linear":
        port = sde.ScoreModel(port_net, "noise_pred", sde.VPSDE())
        ref = jsde.ScoreModel(jax_net, "noise_pred", jsde.VPSDE())

        def jfn(x, t, mask_token=None):
            count[0] += 1
            return ref.noise_pred(x, t)

        return (lambda x, t, mask_token=None: port.noise_pred(x, t)), jfn, count

    def jfn(x, t, mask_token=None):
        count[0] += 1
        return jax_net(x, t * 1000)

    return (lambda x, t, mask_token=None: port_net(x, t * 1000)), jfn, count


def run_pair(kind, solver_kw, sample_kw, net="mlp", atol_scale=False):
    """Sample with both solvers; `atol_scale` makes atol 1e-5 of the largest
    |value| of the JAX result instead of 1e-5 (for updates whose terms are
    several times larger than their sum)."""
    ns, jns = schedules(kind)
    port_fn, jax_fn, count = model_fns(kind, net)
    x = nhwc(10)
    solver = dpm.DPMSolver(port_fn, ns, **solver_kw)
    with torch.no_grad():
        ours = solver.sample(torch.from_numpy(x).permute(0, 3, 1, 2), **sample_kw)
    jsolver = jdpm.DPMSolver(jax_fn, jns, **solver_kw)
    run = lambda xx: jsolver.sample(xx, **sample_kw)  # noqa: E731
    # multistep is unrolled and adaptive a host loop: both run eagerly
    eager = sample_kw.get("method") in ("multistep", "adaptive")
    ref = (run if eager else jax.jit(run))(jnp.asarray(x))
    atol = 1e-5 * max(1.0, float(jnp.abs(ref).max())) if atol_scale else 1e-5
    close(ours.permute(0, 2, 3, 1), ref, atol=atol)
    assert torch.isfinite(ours).all()
    return solver.real_evals, count[0]


CONT = dict(eps=1e-4, T=1.0, skip_type="logSNR")
DISC = dict(eps=1e-3, T=1.0, skip_type="time_uniform")


CASES = [
    # (schedule, predict_x0, method, order, steps): both forms of both
    # schedules on the upstream plan and on singlestep at order 3 with a
    # remainder (7 = 3 + 3 + 1), 'fast' in the eps form, the lower orders
    ("linear", False, "fast_upstream", 3, 8), ("linear", True, "fast_upstream", 3, 8),
    ("discrete", False, "fast_upstream", 3, 8), ("discrete", True, "fast_upstream", 3, 8),
    ("linear", False, "singlestep", 3, 7), ("linear", True, "singlestep", 3, 7),
    ("discrete", False, "singlestep", 3, 7), ("discrete", True, "singlestep", 3, 7),
    ("linear", False, "fast", 3, 8), ("discrete", False, "fast", 3, 8),
    ("linear", False, "singlestep", 1, 4), ("linear", True, "singlestep", 1, 4),
    ("linear", False, "singlestep", 2, 5), ("linear", True, "singlestep", 2, 5),
    ("linear", True, "fast_upstream", 2, 7),
]


@pytest.mark.parametrize("kind,predict_x0,method,order,steps", CASES,
                         ids=["-".join(map(str, c)) for c in CASES])
def test_methods_match_jax(kind, predict_x0, method, order, steps):
    run_pair(kind, dict(predict_x0=predict_x0),
             dict(steps=steps, order=order, method=method, **(CONT if kind == "linear" else DISC)))


@pytest.mark.parametrize("kind,predict_x0", CASES_UVIT := [c[:2] for c in CASES[:4]],
                         ids=["-".join(map(str, c)) for c in CASES_UVIT])
def test_uvit_forms_match_jax(kind, predict_x0):
    run_pair(kind, dict(predict_x0=predict_x0),
             dict(steps=8, order=3, method="fast_upstream",
                  **(CONT if kind == "linear" else DISC)), net="uvit")


@pytest.mark.parametrize("predict_x0", [False, True], ids=["eps", "x0"])
@pytest.mark.parametrize("order", [2, 3])
def test_multistep_matches_jax_with_the_same_nfe(predict_x0, order):
    evals, jevals = run_pair("linear", dict(predict_x0=predict_x0),
                             dict(steps=6, order=order, method="multistep", **CONT))
    assert evals == jevals == 6


@pytest.mark.parametrize("predict_x0", [False, True], ids=["eps", "x0"])
@pytest.mark.parametrize("order", [2, 3])
def test_adaptive_matches_jax_with_the_same_nfe(predict_x0, order):
    """The lower and higher candidates share their evals: `order` evals an
    iteration on both sides."""
    evals, jevals = run_pair("linear", dict(predict_x0=predict_x0),
                             dict(order=order, method="adaptive", eps=1e-2, T=1.0))
    assert evals == jevals and evals % order == 0 and evals > 0


@pytest.mark.parametrize("skip_type", ["t2", "time_quadratic"])
def test_time_grids_match_jax(skip_type):
    ns, jns = schedules("discrete")
    np.testing.assert_array_equal(dpm.get_time_steps(ns, skip_type, 1.0, 1e-3, 9),
                                  jdpm.get_time_steps(jns, skip_type, 1.0, 1e-3, 9))
    run_pair("discrete", dict(), dict(steps=6, order=3, method="singlestep", eps=1e-3, T=1.0,
                                      skip_type=skip_type))


def test_unknown_grid_raises():
    with pytest.raises(ValueError, match="skip_type"):
        dpm.get_time_steps(schedules("linear")[0], "cubic", 1.0, 1e-3, 4)


@pytest.mark.parametrize("kind,predict_x0", [("linear", False), ("discrete", True)])
def test_taylor_matches_jax(kind, predict_x0):
    """The order-3 Taylor step divides its divided differences by r2 - r1
    and sums four terms: its f32 rounding is held at 1e-5 of the sample's
    scale (up to about 6 here), not 1e-5 absolute."""
    run_pair(kind, dict(predict_x0=predict_x0, solver_type="taylor"),
             dict(steps=8, order=3, method="fast", **(CONT if kind == "linear" else DISC)),
             atol_scale=True)


@pytest.mark.parametrize("max_val", [0.5])
def test_thresholding_matches_jax(max_val):
    run_pair("linear", dict(thresholding=True, max_val=max_val),
             dict(steps=8, order=3, method="fast_upstream", **CONT))


def test_quantile_matches_jnp_quantile_past_torch_quantile_limit():
    """jnp.quantile's linear interpolation on small rows, and the same rule
    (numpy's default) on (2, 2**23 + 5) rows: 2**24 + 10 elements, which
    `torch.quantile` refuses."""
    a = np.random.default_rng(0).standard_normal((2, 2 ** 23 + 5)).astype(np.float32)
    close(dpm.quantile_rows(torch.from_numpy(a), 0.995),
          np.quantile(a, 0.995, axis=1).astype(np.float32), rtol=1e-6, atol=0)
    small = a[:, :1001]
    close(dpm.quantile_rows(torch.from_numpy(small), 0.995),
          jnp.quantile(jnp.asarray(small), 0.995, axis=1), rtol=1e-6, atol=0)


@pytest.mark.parametrize("predict_x0", [False, True], ids=["eps", "x0"])
def test_denoise_matches_jax(predict_x0):
    evals, _ = run_pair("linear", dict(predict_x0=predict_x0),
                        dict(steps=6, order=3, method="fast_upstream", denoise=True, **CONT))
    assert evals == 7  # six solver evals and the final projection


def _masked(lib):
    def fn(x, t, mask_token=None):
        noise = lib.sin(x) * 0.5 + 0.1 * t[:, None, None, None]
        if mask_token is None:
            return noise
        return noise, lib.tanh(mask_token * 0.8 + 0.05 * t[:, None, None, None])

    return fn


@pytest.mark.parametrize("update_mask", [False, True])
@pytest.mark.parametrize("method", ["fast", "singlestep"])
@pytest.mark.parametrize("predict_x0", [False, True], ids=["eps", "x0"])
def test_mask_options_match_jax(update_mask, method, predict_x0):
    ns, jns = schedules("discrete")
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 4, 6, 6)).astype(np.float32)
    m = rng.standard_normal((2, 3, 6, 6)).astype(np.float32)
    kw = dict(steps=7, order=3, method=method, update_mask=update_mask, denoise=True, **DISC)
    ours = dpm.DPMSolver(_masked(torch), ns, predict_x0=predict_x0).sample(
        torch.from_numpy(x), mask_token=torch.from_numpy(m), **kw)
    ref = jax.jit(lambda xx, mm: jdpm.DPMSolver(_masked(jnp), jns, predict_x0=predict_x0)
                  .sample(xx, mask_token=mm, **kw))(jnp.asarray(x), jnp.asarray(m))
    assert len(ours) == len(ref) == 2
    for o, r in zip(ours, ref):
        close(o, r)


@pytest.mark.parametrize("method", ["multistep", "adaptive"])
@pytest.mark.parametrize("knob,value,match", [
    ("accel_tau", 0.2, "accel_tau"), ("cfg_interval", (0.0, 0.5), "cfg_interval")])
def test_multistep_and_adaptive_refuse_the_speed_modes(method, knob, value, match):
    ns, jns = schedules("linear")
    for mod, sched, x in ((dpm, ns, torch.zeros((1, 3, 2, 2))),
                          (jdpm, jns, jnp.zeros((1, 2, 2, 3)))):
        with pytest.raises(ValueError, match=match):
            mod.DPMSolver(lambda xx, tt, **k: xx, sched, **{knob: value}).sample(
                x, steps=4, method=method)


def test_other_refusals_match_jax():
    ns = schedules("linear")[0]
    with pytest.raises(ValueError, match="solver_type"):
        dpm.DPMSolver(lambda x, t: x, ns, solver_type="heun")
    with pytest.raises(ValueError, match="order must be 2 or 3"):
        dpm.DPMSolver(lambda x, t: x, ns).sample(torch.zeros((1, 3, 2, 2)), order=1,
                                                 method="adaptive")
    with pytest.raises(ValueError):
        dpm.DPMSolver(lambda x, t: x, ns).sample(torch.zeros((1, 3, 2, 2)), method="heun")


def test_singlestep_remainder_keeps_the_nfe_budget():
    """steps % order evals are kept in a lower-order last step: 7 steps at
    order 3 are steps of order [3, 3, 1], the JAX plan's."""
    ns, jns = schedules("discrete")
    plan = dpm.DPMSolver(None, ns).build_plan(7, 3, "time_uniform", 1e-3, 1.0,
                                              method="singlestep")
    groups = jdpm.DPMSolver(None, jns)._build_plan(7, 3, "singlestep", "time_uniform",
                                                   1e-3, 1.0)
    assert [o for o, _ in plan] == [o for o, _, _, n in groups for _ in range(n)] == [3, 3, 1]
    flat = [{k: np.asarray(v)[i] for k, v in c.items()} for _, _, c, n in groups
            for i in range(n)]
    for (_, c), jc in zip(plan, flat):
        assert set(c) == set(jc)
        for k in c:
            assert c[k] == jc[k], k
