"""Three `latent_discrete` AdamW + EMA train steps of the port against the JAX
`Trainer`.

synthetic_tiny_cond (imagenet256_uvit_large's task cut to a U-ViT of width
32, depth 4, 11 classes, on 8x8 latents; f32) with the same fields on both
sides, from the JAX trainer's own initial parameters, on the same batches of
(moments, label) and the JAX trainer's random draws (the VAE noise, the
timesteps and eps): loss, grad_norm, every gradient, the updated parameters
and the EMA must match at rtol 1e-4 / atol 1e-6 after each step, the
tolerance of the t2i train-step tests (f32; the sides differ in summation
order only).  Then the same with `use_checkpoint` (remat 'save_attn') on,
and a fine-tune load of a reference-format `.pth`, which freezes nothing for
a class-conditional model.
"""
import jax
import jax.numpy as jnp
import ml_collections
import numpy as np
import pytest
import torch

from panopticdiffusionmodels_tpu.configs import get_config as jax_get_config
from panopticdiffusionmodels_tpu.train.trainer import Trainer as JaxTrainer
from panopticdiffusionmodels_torch.configs import get_config
from panopticdiffusionmodels_torch.train.trainer import Trainer
from panopticdiffusionmodels_torch.utils.weights import uvit_state_dict
from torch_port_train_common import assert_step_matches, port_step

torch.set_num_threads(1)

STEPS, BATCH = 3, 16


def configs(use_checkpoint=False):
    """(port config, JAX config) with synthetic_tiny_cond's fields."""
    config = get_config("synthetic_tiny_cond")
    config.nnet.use_checkpoint = use_checkpoint
    jconfig = jax_get_config("imagenet256_uvit_large")
    for key, value in config.items():
        if key in ("config_name", "mesh"):
            continue
        if isinstance(value, dict):
            value = ml_collections.ConfigDict(dict(value))
        jconfig[key] = value
    return config, jconfig


def batches(n):
    rng = np.random.default_rng(0)
    return [(rng.normal(size=(BATCH, 8, 8, 8)).astype(np.float32),
             rng.integers(0, 11, size=(BATCH,)).astype(np.int32)) for _ in range(n)]


def to_port(tree):
    return uvit_state_dict(jax.tree.map(np.asarray, tree), patch_size=2)


def jax_draws(key, batch, n_timesteps=1000):
    """The draws of `Trainer._loss`'s latent_discrete branch from `key`."""
    k1, k2 = jax.random.split(key)
    moments = jnp.asarray(batch[0])
    z = jax.random.normal(k1, moments[..., :4].shape, dtype=moments.dtype)
    key_n, key_eps, _ = jax.random.split(k2, 3)
    n = jax.random.randint(key_n, (moments.shape[0],), 1, n_timesteps + 1)
    eps = jax.random.normal(key_eps, moments[..., :4].shape, dtype=moments.dtype)
    return {k: np.array(v) for k, v in dict(z=z, n=n, eps=eps).items()}


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "use_checkpoint"])
def ref(request, tmp_path_factory):
    """(use_checkpoint, initial params, per step dict(grads, metrics, params,
    ema, draws)) of the JAX trainer."""
    _, jconfig = configs(request.param)
    trainer = JaxTrainer(jconfig, str(tmp_path_factory.mktemp("jax")))
    state = trainer.state
    init = to_port(state.params)
    grad_fn = jax.jit(jax.grad(trainer._loss, has_aux=True))
    out = []
    for i, batch in enumerate(batches(STEPS)):
        key = jax.random.fold_in(trainer.rng, i + 1)
        jb = tuple(jnp.asarray(x) for x in batch)
        grads = to_port(grad_fn(state.params, jb, key)[0])
        state, metrics = trainer._train_step(state, jb, key)
        out.append(dict(grads=grads, metrics={k: float(v) for k, v in metrics.items()},
                        params=to_port(state.params), ema=to_port(state.ema_params),
                        draws=jax_draws(key, batch)))
    return request.param, init, out


def test_three_latent_discrete_steps_match_jax_trainer(ref, tmp_path):
    use_checkpoint, init, steps = ref
    config, _ = configs(use_checkpoint)
    trainer = Trainer(config, str(tmp_path), device="cpu")
    trainer.nnet.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in init.items()},
                                 strict=True)
    for name, p in trainer.state.params.items():
        trainer.state.ema[name].copy_(p.detach())
    for batch, want in zip(batches(STEPS), steps):
        got = port_step(trainer, batch, want["draws"])
        assert_step_matches(got, want, keys=("loss", "grad_norm"))
    assert trainer.state.step == STEPS


def test_fine_tune_freezes_nothing_and_the_stream_feeds_labels(tmp_path):
    config, _ = configs()
    seed = Trainer(config, str(tmp_path / "seed"), device="cpu")
    path = tmp_path / "nnet.pth"
    torch.save(seed.nnet.state_dict(), path)
    config.pretrained = str(path)
    trainer = Trainer(config, str(tmp_path / "run"), device="cpu")
    assert trainer.state.frozen == set()
    for k, v in seed.nnet.state_dict().items():
        torch.testing.assert_close(trainer.nnet.state_dict()[k], v, rtol=0, atol=0)
    moments, labels = next(trainer.data_stream())
    assert moments.dtype == torch.float32 and moments.shape == (BATCH, 8, 8, 8)
    assert labels.dtype == torch.int64 and labels.shape == (BATCH,)
    history = trainer.fit(max_steps=5)
    assert trainer.state.step == 5 and np.isfinite(history[-1]["loss"])
