"""The port's training-side diffusion core against the JAX package's.

`Schedule.sample`, `l_simple`, `l_simple_panoptic` (default,
`use_ground_truth`, `use_twophases`) and `sample_from_moments` on the tiny
dual-stream UViTT2I, with JAX parameters carried by `utils/weights.py` and
the draws (timesteps, eps, mask noise, VAE noise) taken from the JAX keys and
handed to the port: f32 rtol 1e-5 (with atol 1e-6 where single elements
near zero are compared).  Inputs are channel-last on both sides.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panopticdiffusionmodels_tpu.diffusion.analog_bits import ints_to_analog as jax_analog
from panopticdiffusionmodels_tpu.diffusion.schedule import MASK_NOISE_SCALE
from panopticdiffusionmodels_tpu.diffusion.schedule import Schedule as JaxSchedule
from panopticdiffusionmodels_tpu.diffusion.schedule import l_simple as jax_l_simple
from panopticdiffusionmodels_tpu.diffusion.schedule import l_simple_panoptic as jax_l_panoptic
from panopticdiffusionmodels_tpu.models import UViTT2I as JaxUViTT2I
from panopticdiffusionmodels_tpu.models.vae import sample_from_moments as jax_sfm
from panopticdiffusionmodels_tpu.utils.torch_bridge import convert_uvit_t2i
from panopticdiffusionmodels_torch.diffusion.analog_bits import ints_to_analog
from panopticdiffusionmodels_torch.diffusion.schedule import (
    Schedule,
    l_simple,
    l_simple_panoptic,
    stable_diffusion_beta_schedule,
)
from panopticdiffusionmodels_torch.models import UViTT2I
from panopticdiffusionmodels_torch.models.vae import sample_from_moments
from panopticdiffusionmodels_torch.utils.weights import to_tensors, uvit_t2i_state_dict

torch.set_num_threads(1)

GEOM = dict(img_size=8, patch_size=2, in_chans=4, embed_dim=32, depth=4, num_heads=4,
            clip_dim=16, num_clip_token=7, mask_bits=8, mask_size=16)
BETAS = stable_diffusion_beta_schedule()


@pytest.fixture(scope="module")
def models():
    torch.manual_seed(3)
    port = UViTT2I(**GEOM)
    with torch.no_grad():
        for zc in port.zero_convs.values():
            zc.conv.weight.normal_(0, 0.02)
            zc.conv.bias.normal_(0, 0.02)
    params = convert_uvit_t2i({k: v.numpy() for k, v in port.state_dict().items()}, depth=4,
                              scan_blocks=False)
    port.load_state_dict(to_tensors(uvit_t2i_state_dict(params, patch_size=2,
                                                        mask_patch_size=4)), strict=True)
    return JaxUViTT2I(**GEOM, attn_impl="xla"), params, port


def _data(seed=0):
    rng = np.random.default_rng(seed)
    x0 = rng.standard_normal((4, 8, 8, 4)).astype(np.float32)
    ctx = rng.standard_normal((4, 7, 16)).astype(np.float32)
    ids = rng.integers(0, 201, (4, 16, 16, 1)).astype(np.int32)
    return x0, ctx, ids


def _draws(key, x0_shape, mask_shape):
    """What JAX `Schedule.sample(key, ...)` draws."""
    key_n, key_eps, key_eps_m = jax.random.split(key, 3)
    n = jax.random.randint(key_n, (x0_shape[0],), 1, 1001)
    eps = jax.random.normal(key_eps, x0_shape)
    eps_m = MASK_NOISE_SCALE * jax.random.normal(key_eps_m, mask_shape)
    return {k: torch.from_numpy(np.array(v)) for k, v in dict(n=n, eps=eps, eps_m=eps_m).items()}


def _port_fn(port, ctx):
    def fn(xx, tt, mask_token=None, use_ground_truth=False):
        nchw = dict(mask_token=mask_token.permute(0, 3, 1, 2)) if mask_token is not None else {}
        out = port(xx.permute(0, 3, 1, 2), tt, torch.from_numpy(ctx),
                   use_ground_truth=use_ground_truth, **nchw)
        if mask_token is None:
            return out.permute(0, 2, 3, 1)
        return out[0].permute(0, 2, 3, 1), out[1].permute(0, 2, 3, 1)
    return fn


def test_schedule_tables_match_jax():
    ours, ref = Schedule(BETAS), JaxSchedule(BETAS)
    assert ours.N == ref.N == 1000
    np.testing.assert_array_equal(ours.cum_alphas, ref.cum_alphas)
    np.testing.assert_allclose(ours.cum_betas, ref.cum_betas, rtol=1e-14)


@pytest.mark.parametrize("with_mask", [False, True])
def test_sample_matches_jax(with_mask):
    x0, _, ids = _data()
    mask = jax_analog(jnp.asarray(ids), n=8)
    key = jax.random.PRNGKey(7)
    ref = JaxSchedule(BETAS).sample(key, jnp.asarray(x0), mask if with_mask else None)
    d = _draws(key, x0.shape, mask.shape)
    ours = Schedule(BETAS).sample(torch.from_numpy(x0),
                                  torch.from_numpy(np.array(mask)) if with_mask else None,
                                  n=d["n"], eps=d["eps"], eps_m=d["eps_m"] if with_mask else None)
    assert len(ours) == len(ref) == (5 if with_mask else 3)
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mode", ["default", "use_ground_truth", "use_twophases"])
def test_l_simple_panoptic_matches_jax(models, mode):
    jmodel, params, port = models
    x0, ctx, ids = _data(seed=1)
    flags = dict(use_ground_truth=mode == "use_ground_truth",
                 use_twophases=mode == "use_twophases")
    key = jax.random.PRNGKey(11)

    def jfn(xx, tt, mask_token=None, use_ground_truth=False):
        return jmodel.apply(params, xx, tt, jnp.asarray(ctx), mask_token=mask_token,
                            use_ground_truth=use_ground_truth)

    ref = jax_l_panoptic(key, jnp.asarray(x0), jfn, JaxSchedule(BETAS), jnp.asarray(ids),
                         mask_bits=8, **flags)
    d = _draws(key, x0.shape, (4, 16, 16, 8))
    with torch.no_grad():
        ours = l_simple_panoptic(torch.from_numpy(x0), _port_fn(port, ctx), Schedule(BETAS),
                                 torch.from_numpy(ids), mask_bits=8, **flags, **d)
    for o, r in zip(ours, ref):
        assert o.shape == (4,)
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-5, atol=0)


def test_l_simple_matches_jax(models):
    jmodel, params, port = models
    x0, ctx, _ = _data(seed=2)
    key = jax.random.PRNGKey(5)
    ref = jax_l_simple(key, jnp.asarray(x0),
                       lambda xx, tt: jmodel.apply(params, xx, tt, jnp.asarray(ctx)),
                       JaxSchedule(BETAS))
    d = _draws(key, x0.shape, (4, 16, 16, 8))
    with torch.no_grad():
        ours = l_simple(torch.from_numpy(x0), _port_fn(port, ctx), Schedule(BETAS),
                        n=d["n"], eps=d["eps"])
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5, atol=0)


def test_sample_from_moments_matches_jax():
    rng = np.random.default_rng(4)
    moments = rng.standard_normal((3, 8, 8, 8)).astype(np.float32)
    moments[..., 4:] *= 30.0  # reach both sides of the logvar clip
    key = jax.random.PRNGKey(9)
    ref = jax_sfm(key, jnp.asarray(moments), 0.23010)
    noise = torch.from_numpy(np.array(jax.random.normal(key, (3, 8, 8, 4))))
    ours = sample_from_moments(torch.from_numpy(moments), 0.23010, noise=noise)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_draws_from_generator_are_seeded_and_in_range():
    x0, _, ids = _data()
    mask = ints_to_analog(torch.from_numpy(ids))
    outs = [Schedule(BETAS).sample(torch.from_numpy(x0), mask,
                                   generator=torch.Generator().manual_seed(1)) for _ in range(2)]
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    n, eps, _, eps_m, _ = outs[0]
    assert n.min() >= 1 and n.max() <= 1000 and eps.shape == x0.shape
    assert 1.5 < float(eps_m.std()) < 2.5  # x MASK_NOISE_SCALE
    z = sample_from_moments(torch.zeros(2, 4, 4, 8), 0.5, generator=torch.Generator())
    assert z.shape == (2, 4, 4, 4)
