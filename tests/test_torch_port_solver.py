"""The port's mask-aware DPM-Solver++ ('fast', order 3) against the JAX solver.

Both solvers integrate the same closed-form elementwise model, and the tiny
UViTT2I under CFG, from the same numpy noise; trajectories must match at f32
rtol 1e-4 / atol 1e-5.  steps=6 gives the plan [3, 2, 1], so every update
order runs.  The coefficient tables must equal the JAX plan's float32 tables.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panopticdiffusionmodels_tpu.diffusion.cfg import make_cfg_t2i as jax_make_cfg_t2i
from panopticdiffusionmodels_tpu.diffusion.schedule import Schedule as JaxSchedule
from panopticdiffusionmodels_tpu.diffusion.schedule import (
    stable_diffusion_beta_schedule as jax_betas,
)
from panopticdiffusionmodels_tpu.models import UViTT2I as JaxUViTT2I
from panopticdiffusionmodels_tpu.samplers.dpm_solver import DPMSolver as JaxDPMSolver
from panopticdiffusionmodels_tpu.samplers.dpm_solver import get_orders_for_fast as jax_orders
from panopticdiffusionmodels_tpu.samplers.noise_schedule import NoiseScheduleVP as JaxNS
from panopticdiffusionmodels_tpu.utils.torch_bridge import convert_uvit_t2i
from panopticdiffusionmodels_torch.diffusion.cfg import make_cfg_t2i
from panopticdiffusionmodels_torch.diffusion.schedule import Schedule, stable_diffusion_beta_schedule
from panopticdiffusionmodels_torch.models import UViTT2I
from panopticdiffusionmodels_torch.samplers.dpm_solver import DPMSolver, get_orders_for_fast
from panopticdiffusionmodels_torch.samplers.noise_schedule import NoiseScheduleVP

torch.set_num_threads(1)

BETAS = stable_diffusion_beta_schedule()
N = 1000


def test_schedule_matches_jax():
    np.testing.assert_array_equal(BETAS, jax_betas())
    assert Schedule(BETAS).N == JaxSchedule(BETAS).N == N
    ns, jns = NoiseScheduleVP("discrete", betas=BETAS), JaxNS("discrete", betas=BETAS)
    t = np.linspace(1e-3, 1.0, 97)
    for fn in ("marginal_log_mean_coeff", "marginal_std", "marginal_lambda"):
        np.testing.assert_array_equal(getattr(ns, fn)(t), getattr(jns, fn)(t))
    lam = jns.marginal_lambda(t)
    np.testing.assert_array_equal(ns.inverse_lambda(lam), jns.inverse_lambda(lam))


@pytest.mark.parametrize("steps", [3, 6, 7, 8, 50, 51])
def test_fast_plan_matches_jax(steps):
    assert get_orders_for_fast(steps, 3) == jax_orders(steps, 3)
    solver = DPMSolver(None, NoiseScheduleVP("discrete", betas=BETAS))
    jsolver = JaxDPMSolver(None, JaxNS("discrete", betas=BETAS))
    plan = solver.build_plan(steps, 3, "time_uniform", 1.0 / N, 1.0)
    groups = jsolver._build_plan(steps, 3, "fast", "time_uniform", 1.0 / N, 1.0)
    flat = [(o, {k: np.asarray(v)[i] for k, v in c.items()})
            for o, _, c, n in groups for i in range(n)]
    assert [o for o, _ in plan] == [o for o, _ in flat]
    for (_, c), (_, jc) in zip(plan, flat):
        for k in c:
            assert c[k] == jc[k], k


def _port_model(x, t, mask_token=None):
    noise = torch.sin(x) * 0.5 + 0.1 * t[:, None, None, None]
    if mask_token is None:
        return noise
    return noise, torch.tanh(mask_token * 0.8 + 0.05 * t[:, None, None, None])


def _jax_model(x, t, mask_token=None):
    noise = jnp.sin(x) * 0.5 + 0.1 * t[:, None, None, None]
    if mask_token is None:
        return noise
    return noise, jnp.tanh(mask_token * 0.8 + 0.05 * t[:, None, None, None])


@pytest.mark.parametrize("steps,masked", [(6, True), (7, True), (8, True), (6, False)])
def test_closed_form_trajectory_matches_jax(steps, masked):
    rng = np.random.default_rng(steps)
    x = rng.standard_normal((2, 4, 6, 6)).astype(np.float32)
    m = rng.standard_normal((2, 3, 6, 6)).astype(np.float32) if masked else None
    kw = dict(steps=steps, eps=1.0 / N, T=1.0, order=3, method="fast")
    ours = DPMSolver(_port_model, NoiseScheduleVP("discrete", betas=BETAS)).sample(
        torch.from_numpy(x), mask_token=None if m is None else torch.from_numpy(m), **kw)
    ref = JaxDPMSolver(_jax_model, JaxNS("discrete", betas=BETAS)).sample(
        jnp.asarray(x), mask_token=None if m is None else jnp.asarray(m), **kw)
    ours = ours if masked else (ours,)
    ref = ref if masked else (ref,)
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-4, atol=1e-5)


def test_uvit_t2i_cfg_trajectory_matches_jax():
    geom = dict(img_size=8, patch_size=2, in_chans=4, embed_dim=32, depth=4, num_heads=4,
                mlp_ratio=2, clip_dim=16, num_clip_token=7, mask_bits=8, mask_size=16)
    torch.manual_seed(0)
    model = UViTT2I(**geom).eval()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.startswith("zero_convs"):
                p.normal_(0, 0.02)
    params = convert_uvit_t2i({k: v.numpy() for k, v in model.state_dict().items()}, depth=4)
    jmodel = JaxUViTT2I(**geom, attn_impl="xla")
    rng = np.random.default_rng(1)
    z = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    m0 = rng.standard_normal((2, 16, 16, 8)).astype(np.float32)
    ctx = rng.standard_normal((2, 7, 16)).astype(np.float32)
    empty = rng.standard_normal((7, 16)).astype(np.float32)
    kw = dict(steps=6, eps=1.0 / N, T=1.0, order=3, method="fast")

    apply = jax.jit(lambda xx, tt, cc, mm: jmodel.apply(params, xx, tt, cc, mask_token=mm))
    jcfg = jax_make_cfg_t2i(lambda xx, tt, cc, mask_token=None: apply(xx, tt, cc, mask_token),
                            jnp.asarray(empty), scale=1.0)
    jsolver = JaxDPMSolver(lambda xx, tt, mask_token=None: jcfg(
        xx, tt * N, jnp.asarray(ctx), mask_token=mask_token), JaxNS("discrete", betas=BETAS))
    rz, rm = jsolver.sample(jnp.asarray(z), mask_token=jnp.asarray(m0), **kw)

    cfg = make_cfg_t2i(lambda xx, tt, cc, mask_token=None: model(xx, tt, cc, mask_token=mask_token),
                       torch.from_numpy(empty), scale=1.0)
    solver = DPMSolver(lambda xx, tt, mask_token=None: cfg(
        xx, tt * N, torch.from_numpy(ctx), mask_token=mask_token),
        NoiseScheduleVP("discrete", betas=BETAS))
    with torch.no_grad():
        oz, om = solver.sample(torch.from_numpy(z).permute(0, 3, 1, 2),
                               mask_token=torch.from_numpy(m0).permute(0, 3, 1, 2), **kw)
    np.testing.assert_allclose(oz.permute(0, 2, 3, 1).numpy(), np.asarray(rz),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(om.permute(0, 2, 3, 1).numpy(), np.asarray(rm),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("kwargs", [dict(method="singlestep"), dict(method="multistep"),
                                    dict(predict_x0=False)])
def test_later_slice_modes_raise(kwargs):
    kwargs = dict(kwargs)
    method = kwargs.pop("method", "fast")
    with pytest.raises(NotImplementedError, match="slice"):
        DPMSolver(lambda x, t: x, NoiseScheduleVP("discrete", betas=BETAS), **kwargs).sample(
            torch.zeros((1, 4, 2, 2)), steps=3, method=method)
