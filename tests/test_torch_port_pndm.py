"""PNDM (PLMS) of the port against the JAX package's.

`make_pndm_plan` must equal JAX's table for table at 50, 30, 10 and 1
steps.  `pndm_sample` runs against JAX's on a per-pixel random-weight net
(f32, 10 steps), with and without a mask token, at rtol 1e-4 / atol 1e-5.
The tiny UNet of `tests/torch_port_unet_common.py` (gate open) then goes
through both pipelines with `sample.algorithm='pndm'` and CFG 1.0 on the
noise JAX draws from its key: the port's `GenerationPipeline.sample` against
the JAX `GenerationPipeline._pipeline` (7 network calls for 6 steps, CFG as
one 2x batch), and the ground-truth mode through both trainers'
`build_sample_fn` (the mask input is the true map's analog bits, echoed).
Outputs match at atol 1e-4, the serving tests' bar for a chained sampler.
"""
import jax
import jax.numpy as jnp
import ml_collections
import numpy as np
import pytest
import torch

from panopticdiffusionmodels_tpu.configs import get_config as jax_get_config
from panopticdiffusionmodels_tpu.data.datasets import get_dataset as jax_get_dataset
from panopticdiffusionmodels_tpu.diffusion.schedule import Schedule as JaxSchedule
from panopticdiffusionmodels_tpu.diffusion.schedule import stable_diffusion_beta_schedule
from panopticdiffusionmodels_tpu.models import get_nnet as jax_get_nnet
from panopticdiffusionmodels_tpu.samplers.noise_schedule import NoiseScheduleVP
from panopticdiffusionmodels_tpu.samplers.pndm import make_pndm_plan as jax_plan
from panopticdiffusionmodels_tpu.samplers.pndm import pndm_sample as jax_pndm
from panopticdiffusionmodels_tpu.serving import GenerationPipeline as JaxPipeline
from panopticdiffusionmodels_tpu.train.trainer import Trainer as JaxTrainer
from panopticdiffusionmodels_torch.configs import get_config
from panopticdiffusionmodels_torch.configs.base import d
from panopticdiffusionmodels_torch.diffusion.schedule import Schedule
from panopticdiffusionmodels_torch.samplers.pndm import make_pndm_plan, pndm_sample
from panopticdiffusionmodels_torch.serving import GenerationPipeline
from panopticdiffusionmodels_torch.train.trainer import Trainer
from torch_port_unet_common import to_jax, tiny_pair, unet_fields

torch.set_num_threads(4)

N = 2


@pytest.mark.parametrize("steps", [50, 30, 10, 1])
def test_plan_equals_jax(steps):
    ours, ref = make_pndm_plan(steps), jax_plan(steps)
    for name, a, b in zip(ours._fields, ours, ref):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert len(ours.timesteps) == (steps + 1 if steps > 1 else 1)


A = np.random.default_rng(0).normal(0, 1, 4).astype(np.float32)
C = np.random.default_rng(1).normal(0, 1, 8).astype(np.float32)


def jax_net(x, t, mask_token=None):
    eps = jnp.tanh(x * A + (t / 1000.0)[:, None, None, None])
    if mask_token is None:
        return eps
    return eps, jnp.tanh(mask_token * C - (t / 1000.0)[:, None, None, None])


def port_net(x, t, mask_token=None):
    eps = torch.tanh(x * torch.from_numpy(A)[:, None, None] + (t / 1000.0)[:, None, None, None])
    if mask_token is None:
        return eps
    return eps, torch.tanh(mask_token * torch.from_numpy(C)[:, None, None]
                           - (t / 1000.0)[:, None, None, None])


@pytest.mark.parametrize("panoptic", [False, True], ids=["image", "mask_token"])
def test_pndm_sample_matches_jax_on_a_per_pixel_net(panoptic):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((N, 8, 8, 4)).astype(np.float32)
    m = rng.standard_normal((N, 16, 16, 8)).astype(np.float32) if panoptic else None
    acp = JaxSchedule(stable_diffusion_beta_schedule()).cum_alphas[1:]
    np.testing.assert_array_equal(Schedule(stable_diffusion_beta_schedule()).cum_alphas[1:], acp)
    ref = jax_pndm(jax_net, jnp.asarray(x), 10, acp, mask_token=None if m is None else
                   jnp.asarray(m))
    ours = pndm_sample(port_net, torch.from_numpy(x).permute(0, 3, 1, 2), 10, acp,
                       mask_token=None if m is None else torch.from_numpy(m).permute(0, 3, 1, 2))
    ref, ours = (ref, ours) if panoptic else ((ref,), (ours,))
    for a, b in zip(ours, ref):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.permute(0, 2, 3, 1).numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-5)


def configs(**nnet_overrides):
    """(port config, JAX config): synthetic_tiny with the tiny UNet, PNDM, CFG 1.0."""
    config = get_config("synthetic_tiny")
    config.nnet = d(**unet_fields(**nnet_overrides))
    config.sample.algorithm = "pndm"
    config.use_unet = True
    config.num_workers = 0
    jconfig = jax_get_config("synthetic_tiny")
    for key, value in config.items():
        if key not in ("config_name", "mesh"):
            jconfig[key] = ml_collections.ConfigDict(dict(value)) if isinstance(value, dict) \
                else value
    return config, jconfig


def draws(key, n):
    k1, k2 = jax.random.split(key)
    z = np.array(jax.random.normal(k1, (n, 8, 8, 4)))
    m0 = np.array(jax.random.normal(k2, (n, 16, 16, 8)))
    return z, m0


def test_unet_pipeline_with_cfg_matches_jax():
    config, jconfig = configs()
    _, params, net = tiny_pair(seed=3)
    empty = np.random.default_rng(4).standard_normal((7, 16)).astype(np.float32)
    context = np.random.default_rng(5).standard_normal((N, 7, 16)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    ref = JaxPipeline(jconfig, params, None, empty)._pipeline(N, 6)(params, None, key, context)
    pipe = GenerationPipeline(config, net, None, empty, device="cpu")
    calls = []
    pipe.nnet.register_forward_hook(lambda mod, args, out: calls.append(args[0].shape[0]))
    z, m0 = draws(key, N)
    out = pipe.sample(torch.from_numpy(z).permute(0, 3, 1, 2),
                      torch.from_numpy(m0).permute(0, 3, 1, 2), torch.from_numpy(context), 6)
    assert calls == [2 * N] * 7 and pipe.last_real_evals == 7
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.permute(0, 2, 3, 1).numpy(), np.asarray(b), atol=1e-4)
    images, ids = pipe.generate(contexts=context, steps=3)  # the request path, on the CPU
    assert images.shape == (N, 8, 8, 4) and ids.shape == (N, 16, 16, 1)


def jax_trainer(jconfig):
    """A JAX `Trainer` with what its t2i `build_sample_fn` reads, built by
    `__new__`: the full constructor initialises the UNet op by op."""
    jt = JaxTrainer.__new__(JaxTrainer)
    jt.config, jt.task = jconfig, jconfig.task
    ds = dict(jconfig.dataset)
    jt.dataset = jax_get_dataset(ds.pop("name"), **ds)
    kwargs = dict(jconfig.nnet)
    kwargs.pop("use_ground_truth", None)
    jt.nnet = jax_get_nnet(kwargs.pop("name"), dtype=jnp.float32, **kwargs)
    jt.vae = jt.vae_params = jt._pipe_apply = None
    betas = stable_diffusion_beta_schedule()
    jt.schedule = JaxSchedule(betas)
    jt.noise_schedule = NoiseScheduleVP("discrete", betas=betas)
    return jt


def test_ground_truth_mode_through_build_sample_fn_matches_jax(tmp_path):
    config, jconfig = configs(use_ground_truth=True)
    pt = Trainer(config, str(tmp_path), device="cpu")
    assert pt.state.frozen == set()
    rng = np.random.default_rng(0)
    with torch.no_grad():  # open the gate and move every EMA weight off its init
        for e in pt.state.ema.values():
            e.add_(torch.from_numpy(rng.normal(0, 0.02, tuple(e.shape)).astype(np.float32)))
    params = to_jax(pt.state.ema)
    context = rng.standard_normal((N, 7, 16)).astype(np.float32)
    panoptic = rng.integers(0, 201, (N, 16, 16, 1)).astype(np.int32)
    key = jax.random.PRNGKey(8)
    ref = jax_trainer(jconfig).build_sample_fn(4)(params, None, key, context, panoptic)
    z, _ = draws(key, N)
    ours = pt.build_sample_fn(4)(context, z, None, panoptic=panoptic)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)
    bits = np.unpackbits(panoptic.astype(np.uint8), axis=-1) * 2.0 - 1.0
    np.testing.assert_allclose(ours[1].numpy(), bits, atol=1e-6)  # the true map, held
