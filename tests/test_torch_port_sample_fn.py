"""`Trainer.build_sample_fn` of the port against the JAX package's, on the
same EMA weights (the port trainer's EMA, perturbed so the zero convs are
open, carried by the JAX package's `torch_bridge`) and on the draws the JAX
sample_fn makes from its key: panoptic t2i (synthetic_tiny, CFG, 6 steps),
the ground-truth-conditioned mode (`nnet.use_ground_truth` with the true
maps), PNDM on the same panoptic model (the UNet family's sampler, 5
steps), class-conditional latent_discrete (synthetic_tiny_cond) and the
continuous pixel_sde branch (synthetic_tiny_pixel with the probability-flow
ODE: Euler-Maruyama's SDE draws its step noise inside, which the two
packages draw differently).  The speed modes and the continuous DPM-Solver
run through the same `GenerationPipeline.sample`, held to JAX in
test_torch_port_speed_serving.py and test_torch_port_pixel_serving.py.  No
VAE file exists, so both sides return latents.  The JAX sampler runs
eagerly around a jitted network apply: a jit of the whole sampler costs more
than the run, and an eager network's first run more than its jit.  Depth 2,
f32 on the CPU; outputs match at atol 1e-4 (the serving tests' bar for a
chained solver)."""
import jax
import jax.numpy as jnp
import ml_collections
import numpy as np
import pytest
import torch

from panopticdiffusionmodels_tpu.configs import get_config as jax_get_config
from panopticdiffusionmodels_tpu.data.datasets import get_dataset as jax_get_dataset
from panopticdiffusionmodels_tpu.diffusion.schedule import Schedule, stable_diffusion_beta_schedule
from panopticdiffusionmodels_tpu.diffusion.sde import VPSDE
from panopticdiffusionmodels_tpu.models import get_nnet as jax_get_nnet
from panopticdiffusionmodels_tpu.samplers.noise_schedule import NoiseScheduleVP
from panopticdiffusionmodels_tpu.train.trainer import Trainer as JaxTrainer
from panopticdiffusionmodels_tpu.utils.torch_bridge import convert_uvit, convert_uvit_t2i
from panopticdiffusionmodels_torch.configs import get_config
from panopticdiffusionmodels_torch.train.trainer import Trainer

ATOL = 1e-4
N = 3
DEPTH = 2  # the JAX sampler's compile time grows with depth


def configure(config, overrides):
    config.num_workers = 0
    config.nnet.depth = DEPTH
    for field, value in overrides.items():
        node, key = field.split(".")
        config[node][key] = value
    return config


# the JAX zoo config of each tiny config's task, whose fields the port's replace
JAX_BASE = {"synthetic_tiny": "synthetic_tiny", "synthetic_tiny_cond": "imagenet256_uvit_large",
            "synthetic_tiny_pixel": "cifar10_uvit_small"}


def jax_config(name, config):
    """The JAX package's ConfigDict with the port config's fields."""
    jconfig = jax_get_config(JAX_BASE[name])
    for key, value in config.items():
        if key not in ("config_name", "mesh"):
            jconfig[key] = ml_collections.ConfigDict(dict(value)) if isinstance(value, dict) \
                else value
    return jconfig


class JittedNet:
    """The network the JAX `build_sample_fn` samples with (the `infer`
    clone of an `auto` model, as it makes), with its `apply` jitted: run
    eagerly, the network's first pass dispatches op by op for ~15 s."""

    attn_impl = "infer"

    def __init__(self, nnet):
        if getattr(nnet, "attn_impl", None) == "auto":
            nnet = nnet.clone(attn_impl="infer")
        self.apply = jax.jit(nnet.apply, static_argnames=("use_ground_truth",))


def jax_trainer(jconfig):
    """A JAX `Trainer` with only what `build_sample_fn` reads (config, task,
    dataset, network, schedule, no VAE), built as its `__init__` builds them:
    the full constructor initialises the network op by op, ~20 s on a CPU."""
    jt = JaxTrainer.__new__(JaxTrainer)
    jt.config, jt.task = jconfig, jconfig.task
    ds = dict(jconfig.dataset)
    jt.dataset = jax_get_dataset(ds.pop("name"), **ds)
    kwargs = dict(jconfig.nnet)
    kwargs.pop("use_ground_truth", None)
    jt.nnet = JittedNet(jax_get_nnet(kwargs.pop("name"), dtype=jnp.float32, **kwargs))
    jt.vae = jt.vae_params = jt._pipe_apply = None
    if jt.task in ("pixel_sde", "latent_sde"):
        jt.sde = VPSDE()
    else:
        betas = stable_diffusion_beta_schedule()
        jt.schedule = Schedule(betas)
        jt.noise_schedule = NoiseScheduleVP("discrete", betas=betas)
    return jt


def pair(tmp_path, name, overrides=None):
    """(JAX trainer, JAX params, port trainer): the port trainer's EMA,
    perturbed so the zero convs are open, in both."""
    overrides = overrides or {}
    config = configure(get_config(name), overrides)
    pt = Trainer(config, str(tmp_path / "port"), device="cpu")
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for e in pt.state.ema.values():
            e.add_(torch.from_numpy(rng.normal(0, 0.02, tuple(e.shape)).astype(np.float32)))
    sd = {k: v.numpy() for k, v in pt.state.ema.items()}
    kw = dict(depth=DEPTH, mlp_time_embed=config.nnet.mlp_time_embed)
    if config.nnet.name == "uvit_t2i":
        params = convert_uvit_t2i(sd, **kw)
    else:
        params = convert_uvit(sd, num_classes=config.nnet.num_classes, **kw)
    return jax_trainer(jax_config(name, config)), params, pt


def check(ours, ref):
    ours = ours if isinstance(ours, tuple) else (ours,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)


T2I_CASES = {"exact": ({}, 6), "ground-truth": ({"nnet.use_ground_truth": True}, 6)}


@pytest.mark.parametrize("case", list(T2I_CASES))
def test_t2i_matches_jax(tmp_path, case):
    overrides, steps = T2I_CASES[case]
    jt, params, pt = pair(tmp_path, "synthetic_tiny", overrides)
    rng = np.random.default_rng(1)
    context = rng.standard_normal((N, 7, 16)).astype(np.float32)
    panoptic = rng.integers(0, 201, (N, 16, 16, 1)).astype(np.int32)
    key = jax.random.PRNGKey(4)
    k1, k2 = jax.random.split(key)
    z = np.asarray(jax.random.normal(k1, (N, 8, 8, 4)))
    m0 = np.asarray(jax.random.normal(k2, (N, 16, 16, 8)))
    gt = panoptic if case == "ground-truth" else None
    ref = jt.build_sample_fn(steps)(params, None, key, context, gt)
    ours = pt.build_sample_fn(steps)(context, z, m0, panoptic=gt)
    check(ours, ref)
    if case == "ground-truth":  # the mask is held, not integrated
        bits = np.unpackbits(panoptic.astype(np.uint8), axis=-1) * 2.0 - 1.0
        np.testing.assert_array_equal(ours[1].numpy(), bits)


def test_latent_discrete_matches_jax(tmp_path):
    jt, params, pt = pair(tmp_path, "synthetic_tiny_cond")
    y = np.array([0, 4, 9])
    key = jax.random.PRNGKey(5)
    z = np.asarray(jax.random.normal(key, (N, 8, 8, 4)))
    ref = jt.build_sample_fn(6)(params, None, key, y)
    check(pt.build_sample_fn(6)(y, z), ref)


@pytest.mark.parametrize("algorithm", ["euler_maruyama_ode"])
def test_pixel_sde_matches_jax(tmp_path, algorithm):
    jt, params, pt = pair(tmp_path, "synthetic_tiny_pixel", {"sample.algorithm": algorithm})
    key = jax.random.PRNGKey(6)
    z = np.asarray(jax.random.normal(jax.random.split(key)[0], (N, 8, 8, 3)))
    ref = jt.build_sample_fn(8)(params, None, key, None, n=N)
    check(pt.build_sample_fn(8)(None, z), ref)


def test_sampler_takes_the_ema_of_the_moment(tmp_path):
    """The sampling copy reads the trainer's EMA at every call."""
    pt = Trainer(configure(get_config("synthetic_tiny_cond"), {}), str(tmp_path), device="cpu")
    fn = pt.build_sample_fn(3)
    y, z = np.array([1, 2]), np.random.default_rng(2).standard_normal((2, 8, 8, 4))
    before = fn(y, z)
    with torch.no_grad():
        for e in pt.state.ema.values():
            e.mul_(1.5)
    after = fn(y, z)
    assert not torch.allclose(before, after)
    assert pt.sample_weights()[0] is pt.state.ema and pt.sample_weights()[1] is None


def test_pndm_matches_jax(tmp_path):
    """PNDM on the panoptic U-ViT (JAX samples any t2i model with it): the
    mask token fixed, the last mask prediction returned."""
    jt, params, pt = pair(tmp_path, "synthetic_tiny", {"sample.algorithm": "pndm"})
    rng = np.random.default_rng(3)
    context = rng.standard_normal((N, 7, 16)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    k1, k2 = jax.random.split(key)
    z = np.asarray(jax.random.normal(k1, (N, 8, 8, 4)))
    m0 = np.asarray(jax.random.normal(k2, (N, 16, 16, 8)))
    ref = jt.build_sample_fn(5)(params, None, key, context)
    check(pt.build_sample_fn(5)(context, z, m0), ref)
