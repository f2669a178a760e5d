"""The serving branches of the pixel-space slice against the JAX package's
pipeline: an unconditional `uvit` under the discrete schedule (with and
without forecast-skip), `pixel_sde` with the continuous DPM-Solver
(class-conditional), `pixel_sde` with the probability-flow ODE
(unconditional), and `latent_sde` with a small VAE.

Tiny configs (synthetic_tiny_pixel: 8x8x3 images, width 32, depth 4, f32;
11 classes where class-conditional; 8x8x4 latents and the VAE of the
class-conditional serving test for latent_sde): the JAX
`GenerationPipeline._pipeline` and the port's `GenerationPipeline.sample`
run the same weights on the same JAX-drawn noise.  Images must match at atol
1e-4, the bar of the other serving tests (a solver of several steps, four
f32 blocks an eval and the decode, summed in another order).
"""
import jax
import jax.numpy as jnp
import ml_collections
import numpy as np
import pytest
import torch

from panopticdiffusionmodels_tpu.configs import get_config as jax_get_config
from panopticdiffusionmodels_tpu.models.vae import AutoencoderKL as JaxAutoencoderKL
from panopticdiffusionmodels_tpu.serving import GenerationPipeline as JaxPipeline
from panopticdiffusionmodels_tpu.utils.torch_bridge import convert_autoencoder_kl, convert_uvit
from panopticdiffusionmodels_torch.configs import get_config
from panopticdiffusionmodels_torch.configs.base import autoencoder_block
from panopticdiffusionmodels_torch.models import get_nnet
from panopticdiffusionmodels_torch.models.vae import AutoencoderKL
from panopticdiffusionmodels_torch.serving import GenerationPipeline

VAE_GEOM = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, scale_factor=0.18215)


def configs(task="pixel_sde", algorithm="euler_maruyama_ode", num_classes=-1, latent=False,
            accel=0.0):
    """(port config, JAX config): synthetic_tiny_pixel's fields on both."""
    config = get_config("synthetic_tiny_pixel")
    config.task = task
    config.sample.algorithm = algorithm
    config.sample.accel = accel
    config.nnet.num_classes = num_classes
    if latent:
        config.nnet.in_chans = 4
        config.z_shape = (8, 8, 4)
        config.autoencoder = autoencoder_block()
    jconfig = jax_get_config("cifar10_uvit_small")
    for key, value in config.items():
        if key in ("config_name", "mesh"):
            continue
        if isinstance(value, dict):
            value = ml_collections.ConfigDict(dict(value))
        jconfig[key] = value
    return config, jconfig


def pair(config, jconfig, n, steps, cond=None, seed=5):
    """(port images, JAX images), both [0, 1] NHWC numpy."""
    torch.manual_seed(0)
    kw = dict(config.nnet)
    nnet = get_nnet(kw.pop("name"), **kw)
    params = convert_uvit({k: v.numpy() for k, v in nnet.state_dict().items()},
                          depth=config.nnet.depth, num_classes=config.nnet.num_classes,
                          scan_blocks=config.nnet.scan_blocks)
    vae = vae_params = None
    if "autoencoder" in config:
        vae = AutoencoderKL(**VAE_GEOM)
        vae_params = convert_autoencoder_kl(
            {k: v.numpy() for k, v in vae.state_dict().items()},
            ch_mult=VAE_GEOM["ch_mult"], num_res_blocks=1)
    jpipe = JaxPipeline(jconfig, params, vae_params)
    if vae is not None:
        jpipe.vae = JaxAutoencoderKL(**VAE_GEOM)
    key = jax.random.PRNGKey(seed)
    jcond = None if cond is None else jnp.asarray(cond)
    jimages = jpipe._postprocess(jpipe._pipeline(n, steps)(params, vae_params, key, jcond))
    if config.task in ("pixel_sde", "latent_sde"):
        key = jax.random.split(key)[0]  # the continuous branch draws x from k1
    z = np.array(jax.random.normal(key, (n, *jpipe_z_shape(jconfig))))
    pipe = GenerationPipeline(config, nnet, vae, device="cpu")
    ycond = None if cond is None else torch.from_numpy(np.asarray(cond)).long()
    images, mask = pipe.sample(torch.from_numpy(z).permute(0, 3, 1, 2), None, ycond,
                               steps=steps)
    assert mask is None
    return pipe, pipe._postprocess(images, None), jimages


def jpipe_z_shape(jconfig):
    hw = jconfig.nnet.img_size
    return tuple(jconfig.get("z_shape", (hw, hw, jconfig.nnet.in_chans)))


@pytest.mark.parametrize("accel,evals", [(0.0, 17), (0.2, 15)])
def test_unconditional_discrete_matches_jax(accel, evals):
    """The JAX `else` branch: no CFG wrapper, forecast-skip applies (17
    steps at accel 0.2 make 15 real evals)."""
    config, jconfig = configs(task="", algorithm="dpm_solver", accel=accel)
    pipe, ours, ref = pair(config, jconfig, 3, 17)
    assert ours.shape == ref.shape == (3, 8, 8, 3)
    np.testing.assert_allclose(ours, ref, atol=1e-4)
    assert pipe.last_real_evals == evals


def test_pixel_sde_continuous_dpm_solver_class_conditional_matches_jax():
    config, jconfig = configs(algorithm="dpm_solver", num_classes=11)
    pipe, ours, ref = pair(config, jconfig, 3, 11, cond=np.array([0, 5, 10], np.int32))
    assert ours.shape == ref.shape == (3, 8, 8, 3)
    np.testing.assert_allclose(ours, ref, atol=1e-4)
    assert pipe.last_real_evals == 11  # fast_upstream: orders [3, 3, 3, 2]


def test_pixel_sde_euler_maruyama_ode_unconditional_matches_jax():
    config, jconfig = configs(algorithm="euler_maruyama_ode")
    pipe, ours, ref = pair(config, jconfig, 3, 12)
    np.testing.assert_allclose(ours, ref, atol=1e-4)
    assert pipe.last_real_evals == 12


def test_latent_sde_with_a_vae_matches_jax():
    config, jconfig = configs(task="latent_sde", algorithm="dpm_solver", num_classes=11,
                              latent=True)
    _, ours, ref = pair(config, jconfig, 2, 8, cond=np.array([3, 7], np.int32))
    assert ours.shape == ref.shape == (2, 16, 16, 3)
    np.testing.assert_allclose(ours, ref, atol=1e-4)


def test_generate_unconditional_and_euler_maruyama_sde():
    """generate(n=) on an unconditional model (labels and contexts refused);
    the SDE sampler draws its step noise from the request's generator, so a
    seed reproduces a request; a pixel config builds no VAE."""
    config, _ = configs(algorithm="euler_maruyama_sde")
    pipe = GenerationPipeline.from_config(config, device="cpu")
    assert pipe.vae is None
    a = pipe.generate(n=2, steps=6, seed=1)
    assert a.shape == (2, 8, 8, 3) and np.isfinite(a).all()
    np.testing.assert_array_equal(a, pipe.generate(n=2, steps=6, seed=1))
    assert not np.array_equal(a, pipe.generate(n=2, steps=6, seed=2))
    outs = list(pipe.generate_batches([{"n": 1}, {"n": 3}], steps=3))
    assert [o.shape[0] for o in outs] == [1, 3]
    for bad in (dict(labels=[1]), dict(contexts=np.zeros((1, 7, 16), np.float32)), dict()):
        with pytest.raises(ValueError):
            pipe.generate(steps=2, **bad)


@pytest.mark.parametrize("name", ["cifar10_uvit_small", "celeba64_uvit_small",
                                  "imagenet64_uvit_mid", "imagenet64_uvit_large"])
def test_pixel_zoo_configs_serve(name):
    """Each pixel config with its own task, sampler and image shape, its
    network cut to width 32 and depth 2 (full size is for the card): no
    VAE, images of the config's size from its sampler."""
    config = get_config(name)
    config.nnet.update(embed_dim=32, depth=2, num_heads=4)
    config.compute_dtype = "float32"
    pipe = GenerationPipeline.from_config(config, device="cpu")
    assert pipe.vae is None and pipe.continuous
    kw = dict(labels=[1, 999]) if config.nnet.num_classes > 0 else dict(n=2)
    images = pipe.generate(steps=3, **kw)
    size = config.nnet.img_size
    assert images.shape == (2, size, size, 3) and np.isfinite(images).all()
    assert pipe.last_real_evals == 3
