"""Three `pixel_sde` AdamW + EMA train steps of the port, unconditional and
class-conditional, and three `latent_sde` steps, against the JAX `Trainer`.

synthetic_tiny_pixel (cifar10_uvit_small's task cut to a U-ViT of width 32
on 8x8x3 images; f32) at depth 2, which keeps the JAX side's compiles of
the loss gradient and the train step short, with the same fields on both
sides; 11 classes in 'cond' mode; `latent_sde` on (8, 8, 8) moments with a VAE scale
factor.  From the JAX trainer's own initial parameters, on the same batches
and the JAX trainer's random draws (the VAE noise, the continuous times t
and eps): loss, grad_norm, every gradient, the updated parameters and the
EMA must match at rtol 1e-4 / atol 1e-6 after each step, the tolerance of
the other train-step tests (f32; the sides differ in summation order only).
"""
import functools

import jax
import jax.numpy as jnp
import ml_collections
import numpy as np
import pytest
import torch

from panopticdiffusionmodels_tpu.configs import get_config as jax_get_config
from panopticdiffusionmodels_torch.configs import get_config
from panopticdiffusionmodels_torch.configs.base import autoencoder_block, d
from panopticdiffusionmodels_torch.train.trainer import Trainer
from panopticdiffusionmodels_torch.utils.weights import uvit_state_dict
from torch_port_train_common import assert_step_matches, jax_trainer, port_step

STEPS, BATCH = 3, 16
KINDS = ["pixel_uncond", "pixel_cond", "latent_sde"]


def configs(kind):
    """(port config, JAX config) of one kind, the same fields on both."""
    config = get_config("synthetic_tiny_pixel")
    config.nnet.depth = 2
    if kind != "pixel_uncond":
        config.train.mode = "cond"
        config.nnet.num_classes = 11
        config.dataset = d(name="synthetic", style="pixels", n=64, z_shape=(8, 8, 3),
                           num_classes=11)
    if kind == "latent_sde":
        config.task = "latent_sde"
        config.z_shape = (8, 8, 4)
        config.nnet.in_chans = 4
        config.autoencoder = autoencoder_block(scale_factor=0.5)
        config.dataset = d(name="synthetic", style="imagenet", n=64, z_shape=(8, 8, 8),
                           num_classes=11)
    jconfig = jax_get_config("cifar10_uvit_small")
    for key, value in config.items():
        if key in ("config_name", "mesh"):
            continue
        if isinstance(value, dict):
            value = ml_collections.ConfigDict(dict(value))
        jconfig[key] = value
    return config, jconfig


def batches(kind, n):
    rng = np.random.default_rng(1)
    c = 8 if kind == "latent_sde" else 3
    return [(rng.normal(size=(BATCH, 8, 8, c)).astype(np.float32),
             rng.integers(0, 11, size=(BATCH,)).astype(np.int32)) for _ in range(n)]


def to_port(tree):
    return uvit_state_dict(jax.tree.map(np.asarray, tree), patch_size=2)


def jax_draws(kind, key, batch):
    """The draws of `Trainer._loss`'s pixel_sde / latent_sde branch from `key`
    (`diffusion/sde.py::SDE.sample`: t ~ U(0, 1), then eps), as one jitted
    program."""
    return {k: np.array(v) for k, v in _draws(key, jnp.asarray(batch[0]), kind=kind).items()}


@functools.partial(jax.jit, static_argnames="kind")
def _draws(key, x, kind):
    draws = {}
    if kind == "latent_sde":
        k1, key = jax.random.split(key)
        draws["z"] = jax.random.normal(k1, x[..., :4].shape, dtype=x.dtype)
        x = x[..., :4]
    key_t, key_eps = jax.random.split(key)
    draws["t"] = jax.random.uniform(key_t, (x.shape[0],), dtype=x.dtype)
    draws["eps"] = jax.random.normal(key_eps, x.shape, dtype=x.dtype)
    return draws


@pytest.fixture(scope="module", params=KINDS)
def ref(request, tmp_path_factory):
    """(kind, initial params, per step dict(grads, metrics, params, ema,
    draws)) of the JAX trainer."""
    kind = request.param
    _, jconfig = configs(kind)
    trainer = jax_trainer(jconfig, tmp_path_factory.mktemp("jax"))
    state = trainer.state
    init = to_port(state.params)
    grad_fn = jax.jit(jax.grad(trainer._loss, has_aux=True))
    out = []
    for i, batch in enumerate(batches(kind, STEPS)):
        key = jax.random.fold_in(trainer.rng, i + 1)
        jb = tuple(jnp.asarray(x) for x in batch)
        grads = to_port(grad_fn(state.params, jb, key)[0])
        state, metrics = trainer._train_step(state, jb, key)
        out.append(dict(grads=grads, metrics={k: float(v) for k, v in metrics.items()},
                        params=to_port(state.params), ema=to_port(state.ema_params),
                        draws=jax_draws(kind, key, batch)))
    return kind, init, out


def test_three_sde_steps_match_jax_trainer(ref, tmp_path):
    kind, init, steps = ref
    config, _ = configs(kind)
    trainer = Trainer(config, str(tmp_path), device="cpu")
    trainer.nnet.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in init.items()},
                                 strict=True)
    for name, p in trainer.state.params.items():
        trainer.state.ema[name].copy_(p.detach())
    for batch, want in zip(batches(kind, STEPS), steps):
        got = port_step(trainer, batch, want["draws"])
        assert_step_matches(got, want, keys=("loss", "grad_norm"))
    assert trainer.state.step == STEPS


@pytest.mark.parametrize("kind", KINDS)
def test_fit_draws_its_own_noise_and_feeds_the_task(kind, tmp_path):
    """`fit` from the loader and the trainer's (seed, step) generator: a
    finite loss; the same seed gives the same losses."""
    config, _ = configs(kind)
    config.num_workers = 0
    runs = [Trainer(config, str(tmp_path / f"run{i}"), device="cpu").fit(max_steps=5)
            for i in range(2)]
    assert [m["loss"] for m in runs[0]] == [m["loss"] for m in runs[1]]
    assert np.isfinite([m["loss"] for m in runs[0]]).all()


@pytest.mark.parametrize("name", ["cifar10_uvit_small", "celeba64_uvit_small",
                                  "imagenet64_uvit_mid", "imagenet64_uvit_large"])
def test_pixel_zoo_configs_train(name, tmp_path):
    """Each pixel config with its own task and mode, its network cut to
    width 32 and depth 2 and its dataset to synthetic pixels of its image
    shape (the datasets are not in the repository): two steps."""
    config = get_config(name)
    config.nnet.update(embed_dim=32, depth=2, num_heads=4)
    config.compute_dtype = "float32"
    size = config.nnet.img_size
    config.dataset = d(name="synthetic", style="pixels", n=8, z_shape=(size, size, 3),
                       num_classes=1000)
    config.train.batch_size = 4
    config.num_workers = 0
    history = Trainer(config, str(tmp_path), device="cpu").fit(max_steps=2)
    assert np.isfinite(history[-1]["loss"]) if history else True


def test_mode_and_classes_must_agree(tmp_path):
    config, _ = configs("pixel_uncond")
    config.train.mode = "cond"
    with pytest.raises(ValueError, match="class-conditional"):
        Trainer(config, str(tmp_path), device="cpu")
