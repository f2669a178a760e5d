"""The port's continuous-time core against the JAX package: the linear and
cosine `NoiseScheduleVP`, `VPSDE` / `VPSDECosine`, `ScoreModel` in both
`pred` modes, the continuous `l_simple`, and Euler-Maruyama.

The schedules are host float64 on both sides and must agree to 1e-12
relative (the same closed forms, numpy both sides).  Everything else is f32
at rtol 1e-4 / atol 1e-5: the tiny U-ViT of `torch_port_pixel_common.py`
(four f32 blocks, summed in another order) or elementwise arithmetic.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panopticdiffusionmodels_tpu.diffusion import sde as jsde
from panopticdiffusionmodels_tpu.samplers.euler_maruyama import euler_maruyama as jax_em
from panopticdiffusionmodels_tpu.samplers.noise_schedule import NoiseScheduleVP as JaxNS
from panopticdiffusionmodels_torch.diffusion import sde
from panopticdiffusionmodels_torch.samplers.euler_maruyama import em_step, euler_maruyama
from panopticdiffusionmodels_torch.samplers.noise_schedule import NoiseScheduleVP
from torch_port_pixel_common import close, jax_apply, nhwc, port_apply

T_GRID = np.linspace(1e-4, 1.0, 57)


@pytest.mark.parametrize("schedule", ["linear", "cosine"])
def test_continuous_noise_schedules_match_jax(schedule):
    ns, jns = NoiseScheduleVP(schedule), JaxNS(schedule)
    assert ns.T == jns.T and ns.T == (0.9946 if schedule == "cosine" else 1.0)
    t = T_GRID * ns.T
    for fn in ("marginal_log_mean_coeff", "marginal_alpha", "marginal_std", "marginal_lambda"):
        np.testing.assert_allclose(getattr(ns, fn)(t), getattr(jns, fn)(t), rtol=1e-12,
                                   atol=0, err_msg=fn)
    lam = jns.marginal_lambda(t)
    np.testing.assert_allclose(ns.inverse_lambda(lam), jns.inverse_lambda(lam), rtol=1e-12)
    # the inverse is the inverse: back to t at float64 precision
    np.testing.assert_allclose(ns.inverse_lambda(ns.marginal_lambda(t)), t, rtol=1e-6)
    if schedule == "cosine":
        assert ns.cosine_t_max == jns.cosine_t_max
        assert ns.cosine_log_alpha_0 == jns.cosine_log_alpha_0


def test_get_sde_and_its_refusal():
    assert isinstance(sde.get_sde("vpsde"), sde.VPSDE)
    assert isinstance(sde.get_sde("vpsde_cosine", s=0.01), sde.VPSDECosine)
    with pytest.raises(NotImplementedError):
        sde.get_sde("vesde")


@pytest.mark.parametrize("name", ["vpsde", "vpsde_cosine"])
def test_sde_coefficients_match_jax(name):
    ours, ref = sde.get_sde(name), jsde.get_sde(name)
    t = np.linspace(1e-3, 0.99, 11).astype(np.float32)
    tt, jt = torch.from_numpy(t), jnp.asarray(t)
    for fn in ("diffusion", "cum_alpha", "cum_beta", "snr", "nsr"):
        close(getattr(ours, fn)(tt), getattr(ref, fn)(jt), msg=fn)
    x = nhwc(0, batch=11)
    close(ours.drift(torch.from_numpy(x), tt), ref.drift(jnp.asarray(x), jt))
    mean, std = ours.marginal_prob(torch.from_numpy(x), tt)
    jmean, jstd = ref.marginal_prob(jnp.asarray(x), jt)
    close(mean, jmean)
    close(std, jstd)
    # a scalar time, as Euler-Maruyama passes it
    close(ours.drift(torch.from_numpy(x), tt[3]), ref.drift(jnp.asarray(x), jt[3]))


@pytest.mark.parametrize("pred", ["noise_pred", "x0_pred"])
@pytest.mark.parametrize("num_classes", [-1, 11])
def test_score_model_matches_jax(pred, num_classes):
    x = nhwc(1)
    t = np.array([0.02, 0.5, 0.97], np.float32)
    kw = {} if num_classes < 0 else {"y": np.array([0, 4, 10])}
    ours = sde.ScoreModel(port_apply(num_classes), pred, sde.VPSDE())
    ref = jsde.ScoreModel(jax_apply(num_classes), pred, jsde.VPSDE())
    pkw = {k: torch.from_numpy(v) for k, v in kw.items()}
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    for fn in ("predict", "noise_pred", "x0_pred", "score"):
        close(getattr(ours, fn)(torch.from_numpy(x), torch.from_numpy(t), **pkw),
              getattr(ref, fn)(jnp.asarray(x), jnp.asarray(t), **jkw), msg=fn)
    # a scalar time goes to every batch element
    close(ours.noise_pred(torch.from_numpy(x), torch.tensor(0.3), **pkw),
          ref.noise_pred(jnp.asarray(x), jnp.float32(0.3), **jkw))


@pytest.mark.parametrize("pred", ["noise_pred", "x0_pred"])
def test_l_simple_matches_jax_with_numpy_draws(pred):
    x0 = nhwc(2)
    rng = np.random.default_rng(3)
    t = rng.uniform(size=3).astype(np.float32)
    eps = rng.standard_normal(x0.shape).astype(np.float32)
    ours = sde.l_simple(sde.ScoreModel(port_apply(), pred, sde.VPSDE()),
                        torch.from_numpy(x0), pred, t=torch.from_numpy(t),
                        eps=torch.from_numpy(eps))

    class Fixed(jsde.VPSDE):  # the JAX SDE handing back the numpy draws
        def sample(self, key, x0, t_init=0.0):
            mean, std = self.marginal_prob(x0, jnp.asarray(t))
            return jnp.asarray(t), jnp.asarray(eps), mean + jsde.stp(std, jnp.asarray(eps))

    ref = jsde.l_simple(jax.random.PRNGKey(0), jsde.ScoreModel(jax_apply(), pred, Fixed()),
                        jnp.asarray(x0), pred)
    assert ours.shape == (3,)
    close(ours, ref)


def test_sde_sample_draws_from_the_generator():
    x0 = torch.from_numpy(nhwc(4, batch=64))
    g = torch.Generator().manual_seed(0)
    t, eps, xt = sde.VPSDE().sample(x0, t_init=0.25, generator=g)
    assert t.shape == (64,) and float(t.min()) >= 0.25 and float(t.max()) <= 1.0
    g2 = torch.Generator().manual_seed(0)
    t2, eps2, xt2 = sde.VPSDE().sample(x0, t_init=0.25, generator=g2)
    assert torch.equal(t, t2) and torch.equal(eps, eps2) and torch.equal(xt, xt2)


def test_euler_maruyama_ode_matches_jax():
    x = nhwc(5)
    ours = euler_maruyama(sde.ODE(sde.ScoreModel(port_apply(), "noise_pred", sde.VPSDE())),
                          torch.from_numpy(x), 12)
    ref = jax_em(jax.random.PRNGKey(1),
                 jsde.ODE(jsde.ScoreModel(jax_apply(), "noise_pred", jsde.VPSDE())),
                 jnp.asarray(x), 12)
    close(ours, ref)


def test_euler_maruyama_sde_step_matches_jax():
    x = nhwc(6)
    noise = np.random.default_rng(7).standard_normal(x.shape).astype(np.float32)
    s, t = np.float32(0.4), np.float32(0.45)
    rsde = sde.ReverseSDE(sde.ScoreModel(port_apply(11), "noise_pred", sde.VPSDE()))
    y = torch.tensor([1, 2, 3])
    ours = em_step(rsde, torch.from_numpy(x), torch.tensor(s), torch.tensor(t),
                   torch.from_numpy(noise), y=y)
    jrsde = jsde.ReverseSDE(jsde.ScoreModel(jax_apply(11), "noise_pred", jsde.VPSDE()))
    jx, jt = jnp.asarray(x), jnp.float32(t)
    drift = jrsde.drift(jx, jt, y=jnp.asarray(y.numpy()))
    dt = jnp.float32(s) - jt
    ref = jx + drift * dt + jrsde.diffusion(jt) * jnp.sqrt(-dt) * jnp.asarray(noise)
    close(ours, ref)


def test_euler_maruyama_sde_loop_matches_jax_on_the_same_draws():
    """The whole loop, its descending grid and its mean-only last step: the
    JAX integrator restated step by step on the draws the port's generator
    makes (one normal a step, none on the last)."""
    steps, x = 5, nhwc(8)
    rsde = sde.ReverseSDE(sde.ScoreModel(port_apply(), "x0_pred", sde.VPSDE()))
    ours = euler_maruyama(rsde, torch.from_numpy(x), steps,
                          generator=torch.Generator().manual_seed(9))
    g = torch.Generator().manual_seed(9)
    draws = [torch.randn(x.shape, generator=g).numpy() for _ in range(steps - 1)] + [None]
    jrsde = jsde.ReverseSDE(jsde.ScoreModel(jax_apply(), "x0_pred", jsde.VPSDE()))
    grid = np.append(0.0, np.linspace(1e-3, 1.0, steps))
    jx = jnp.asarray(x)
    for s, t, n in zip(grid[:-1][::-1], grid[1:][::-1], draws):
        s, t = jnp.float32(s), jnp.float32(t)
        mean = jx + jrsde.drift(jx, t) * (s - t)
        jx = mean if n is None else mean + jrsde.diffusion(t) * jnp.sqrt(t - s) * n
    close(ours, jx)
    assert torch.isfinite(ours).all()
