"""The port's sampling speed modes against the JAX package: the CFG wrappers'
`cfg_on` / `want_mask_delta`, DPM-Solver++ with forecast-skip (`accel_tau`),
the guidance interval (`cfg_interval`) in both orientations and the
mask-guidance hold, and `check_speed_modes`.

Both solvers integrate one closed-form network behind each package's own CFG
wrapper, from the same numpy noise; trajectories must match at f32 rtol 1e-4
/ atol 1e-5 (elementwise arithmetic, summed in another order).  The count of
real network evals must equal the JAX plan's: the JAX model counts its evals
with `jax.debug.callback`, which runs only in the branch `lax.cond` takes.
At 50 steps, order 3, eps 1e-3, accel 0.2 leaves 20 real evals and 0.1
leaves 32 (computed from the plan).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panopticdiffusionmodels_tpu.diffusion.cfg import make_cfg_class_cond as jax_cfg_class
from panopticdiffusionmodels_tpu.diffusion.cfg import make_cfg_t2i as jax_cfg_t2i
from panopticdiffusionmodels_tpu.samplers import speed_budget as jax_budget
from panopticdiffusionmodels_tpu.samplers.dpm_solver import DPMSolver as JaxDPMSolver
from panopticdiffusionmodels_tpu.samplers.noise_schedule import NoiseScheduleVP as JaxNS
from panopticdiffusionmodels_torch.configs.base import d
from panopticdiffusionmodels_torch.diffusion.cfg import make_cfg_class_cond, make_cfg_t2i
from panopticdiffusionmodels_torch.diffusion.schedule import stable_diffusion_beta_schedule
from panopticdiffusionmodels_torch.samplers import speed_budget
from panopticdiffusionmodels_torch.samplers.dpm_solver import DPMSolver
from panopticdiffusionmodels_torch.samplers.noise_schedule import NoiseScheduleVP

torch.set_num_threads(1)

BETAS = stable_diffusion_beta_schedule()
N = 1000
SCALE = 0.7


def _apply(lib):
    """apply(x, t, ctx, mask_token=None): a smooth closed-form 'network' whose
    output depends on the context, so guidance changes it."""

    def fn(x, t, ctx, mask_token=None):
        c = lib.mean(ctx, axis=(1, 2)) if lib is jnp else ctx.mean(dim=(1, 2))
        noise = lib.sin(x) * 0.5 + 1e-4 * t[:, None, None, None] + 0.3 * c[:, None, None, None]
        if mask_token is None:
            return noise
        return noise, lib.tanh(mask_token * 0.8 + 5e-5 * t[:, None, None, None]
                               + 0.2 * c[:, None, None, None])

    return fn


def _pair(steps_kw, masked, seed=0, **solver_kw):
    """(port output, JAX output, port real evals, JAX real evals) of one
    sample() through each package's CFG wrapper around `_apply`."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 4, 6, 6)).astype(np.float32)
    m = rng.standard_normal((2, 3, 6, 6)).astype(np.float32) if masked else None
    ctx = rng.standard_normal((2, 3, 5)).astype(np.float32)
    empty = rng.standard_normal((3, 5)).astype(np.float32)

    cfg = make_cfg_t2i(_apply(torch), torch.from_numpy(empty), SCALE)
    solver = DPMSolver(lambda xx, tt, mask_token=None, **kw: cfg(
        xx, tt * N, torch.from_numpy(ctx), mask_token=mask_token, **kw),
        NoiseScheduleVP("discrete", betas=BETAS), **solver_kw)
    ours = solver.sample(torch.from_numpy(x), mask_token=None if m is None
                         else torch.from_numpy(m), **steps_kw)

    count = [0]

    def bump():
        count[0] += 1

    jcfg = jax_cfg_t2i(_apply(jnp), jnp.asarray(empty), SCALE)

    def jmodel(xx, tt, mask_token=None, **kw):
        jax.debug.callback(bump)
        return jcfg(xx, tt * N, jnp.asarray(ctx), mask_token=mask_token, **kw)

    jsolver = JaxDPMSolver(jmodel, JaxNS("discrete", betas=BETAS), **solver_kw)
    ref = jax.jit(lambda xx, mm: jsolver.sample(xx, mask_token=mm, **steps_kw))(
        jnp.asarray(x), None if m is None else jnp.asarray(m))
    jax.effects_barrier()
    return ours, ref, solver.real_evals, count[0]


def _assert_close(ours, ref):
    ours = ours if isinstance(ours, tuple) else (ours,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    assert len(ours) == len(ref)
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-4, atol=1e-5)


FAST = dict(eps=1.0 / N, T=1.0, order=3, method="fast")


@pytest.mark.parametrize("case", [
    dict(steps=20, masked=True, accel_tau=0.2),
    dict(steps=40, masked=False, accel_tau=0.1),
    dict(steps=9, masked=True, cfg_interval=(0.5, 1.0)),
    dict(steps=9, masked=True, cfg_interval=(0.0, 0.5)),
    dict(steps=9, masked=False, cfg_interval=(0.0, 0.5)),
    dict(steps=9, masked=True, cfg_interval=(0.5, 1.0), mask_guidance_hold=True),
    dict(steps=9, masked=True, cfg_interval=(0.0, 0.5), mask_guidance_hold=True),
    dict(steps=20, masked=True, accel_tau=0.2, cfg_interval=(0.5, 1.0),
         mask_guidance_hold=True),
    dict(steps=20, masked=False, accel_tau=0.2, cfg_interval=(0.0, 0.5)),
], ids=lambda c: "-".join(f"{k}={v}" for k, v in c.items()))
def test_speed_mode_trajectory_matches_jax(case):
    case = dict(case)
    steps, masked = case.pop("steps"), case.pop("masked")
    ours, ref, evals, jevals = _pair(dict(steps=steps, **FAST), masked, seed=steps, **case)
    _assert_close(ours, ref)
    assert evals == jevals
    if case.get("accel_tau"):
        assert evals < steps  # forecasts replaced some evals


@pytest.mark.parametrize("tau,want", [(0.2, 20), (0.1, 32), (0.0, 50)])
def test_real_evals_at_50_steps_match_jax_plan(tau, want):
    ours, ref, evals, jevals = _pair(dict(steps=50, eps=1e-3, T=1.0, order=3, method="fast"),
                                     masked=False, accel_tau=tau)
    assert evals == jevals == want
    _assert_close(ours, ref)


def test_hold_is_a_no_op_for_guide_late_interval():
    """(0.0, 0.5): the unguided steps come first, before any delta is cached,
    so the hold leaves the outputs as the plain interval gives them."""
    a = _pair(dict(steps=9, **FAST), True, cfg_interval=(0.0, 0.5))[0]
    b = _pair(dict(steps=9, **FAST), True, cfg_interval=(0.0, 0.5), mask_guidance_hold=True)[0]
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    c = _pair(dict(steps=9, **FAST), True, cfg_interval=(0.5, 1.0))[0]
    h = _pair(dict(steps=9, **FAST), True, cfg_interval=(0.5, 1.0), mask_guidance_hold=True)[0]
    assert not torch.equal(c[1], h[1])  # guide-early: the held delta changes the mask


@pytest.mark.parametrize("kwargs,err", [
    (dict(cfg_interval=(0.6, 0.5)), "lo must be <= hi"),
    (dict(cfg_interval=(0.1, 0.2, 0.3)), r"\(lo, hi\)"),
    (dict(mask_guidance_hold=True), "requires cfg_interval"),
])
def test_speed_mode_checks_match_jax(kwargs, err):
    for cls, ns in ((DPMSolver, NoiseScheduleVP), (JaxDPMSolver, JaxNS)):
        with pytest.raises(ValueError, match=err):
            cls(None, ns("discrete", betas=BETAS), **kwargs)


@pytest.mark.parametrize("cfg_on,want_delta,masked", [
    (True, False, True), (False, False, True), (True, True, True), (True, False, False),
    (False, False, False)])
def test_cfg_t2i_modes_match_jax(cfg_on, want_delta, masked):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 4, 5, 5)).astype(np.float32)
    t = np.array([3.0, 500.0, 999.0], np.float32)
    ctx = rng.standard_normal((3, 3, 5)).astype(np.float32)
    empty = rng.standard_normal((3, 5)).astype(np.float32)
    m = rng.standard_normal((3, 2, 5, 5)).astype(np.float32) if masked else None
    kw = dict(cfg_on=cfg_on, want_mask_delta=want_delta)
    ours = make_cfg_t2i(_apply(torch), torch.from_numpy(empty), SCALE)(
        torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx),
        mask_token=None if m is None else torch.from_numpy(m), **kw)
    ref = jax_cfg_t2i(_apply(jnp), jnp.asarray(empty), SCALE)(
        jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx),
        mask_token=None if m is None else jnp.asarray(m), **kw)
    if want_delta:
        assert len(ours) == 3
    _assert_close(ours, ref)


@pytest.mark.parametrize("cfg_on", [True, False])
def test_cfg_class_cond_cfg_on_matches_jax(cfg_on):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 6)).astype(np.float32)
    t = np.array([3.0, 500.0, 999.0], np.float32)
    y = np.array([1, 0, 6])
    table = rng.standard_normal((7, 6)).astype(np.float32)
    calls = []

    def port_apply(xx, tt, yy):
        calls.append(xx.shape[0])
        return xx * (1 + tt / 1000)[:, None] + torch.from_numpy(table)[yy]

    out = make_cfg_class_cond(port_apply, 6, 0.4)(torch.from_numpy(x), torch.from_numpy(t),
                                                  torch.from_numpy(y), cfg_on=cfg_on)
    ref = jax_cfg_class(lambda xx, tt, yy: xx * (1 + tt / 1000)[:, None] + jnp.asarray(table)[yy],
                        6, 0.4)(jnp.asarray(x), jnp.asarray(t), jnp.asarray(y), cfg_on=cfg_on)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    assert calls == [6 if cfg_on else 3]  # cond-only: one forward at batch B


def _config(key, accel=0.0, interval=(), gelu=False):
    family, embed_dim, depth, panoptic, img_size = key
    nnet = d(name=family, embed_dim=embed_dim, depth=depth, img_size=img_size,
             gelu_approx=gelu)
    if family == "uvit_t2i":
        nnet.enable_panoptic = panoptic
    return d(nnet=nnet, sample=d(accel=accel, cfg_interval=interval))


MODES = [dict(accel=0.2), dict(accel=0.1), dict(accel=0.3), dict(interval=(0.0, 0.5)),
         dict(gelu=True), dict(accel=0.2, gelu=True), dict()]


@pytest.mark.parametrize("key", sorted(jax_budget._VALIDATED) + [("uvit", 768, 12, False, 32)],
                         ids=str)
def test_check_speed_modes_matches_jax(key):
    assert speed_budget._VALIDATED == jax_budget._VALIDATED
    for mode in MODES:
        cfg = _config(key, **mode)
        assert speed_budget._geometry_key(cfg) == jax_budget._geometry_key(cfg) == key
        ours = speed_budget.check_speed_modes(cfg, log=False)
        ref = jax_budget.check_speed_modes(cfg, log=False)
        assert len(ours) == len(ref), (mode, ours, ref)
        for o, r in zip(ours, ref):
            assert o.split(" ")[0] == r.split(" ")[0], (o, r)
        if key not in jax_budget._VALIDATED and mode:
            assert "NO measured deviation entry" in ours[0]
