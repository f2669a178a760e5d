"""Image-only t2i training (`enable_panoptic=False`) of the port against the
JAX `Trainer`: `l_simple` on the CLIP context, no mask stream (JAX
`train/trainer.py:400-406`), as `mscoco_uvit_mid` trains.

Three AdamW + EMA steps, f32, on the same (moments, context) batches and the
JAX trainer's random draws (the VAE noise, the timesteps and eps): loss,
grad_norm, the updated parameters and the EMA must match at rtol 1e-4 / atol
1e-6 after each step, the tolerance of the panoptic train-step tests.

  * a tiny `uvit_t2i` (synthetic_tiny's geometry) from the JAX trainer's own
    initial parameters;
  * the tiny two-level UNet of `test_torch_port_train_unet.py` from the
    port trainer's initial parameters, with the JAX trainer built by
    `__new__` (its constructor initialises the UNet op by op for ~20 s).
"""
import jax
import jax.numpy as jnp
import ml_collections
import numpy as np
import torch

from panopticdiffusionmodels_tpu.configs import get_config as jax_get_config
from panopticdiffusionmodels_tpu.train.trainer import Trainer as JaxTrainer
from panopticdiffusionmodels_torch.configs import get_config
from panopticdiffusionmodels_torch.train.trainer import Trainer
from panopticdiffusionmodels_torch.utils.weights import unet_state_dict, uvit_t2i_state_dict
from torch_port_train_common import assert_step_matches, batches, port_step
from torch_port_unet_common import to_jax, train_configs, train_jax_trainer

torch.set_num_threads(2)

STEPS = 3


def image_batches():
    return [b[:2] for b in batches(STEPS)]


def jax_draws(key, batch, n_timesteps: int = 1000) -> dict:
    """The draws of `Trainer._loss`'s image-only t2i branch from `key`."""
    k1, k2 = jax.random.split(key)
    moments = jnp.asarray(batch[0])
    z = jax.random.normal(k1, moments[..., :4].shape, dtype=moments.dtype)
    key_n, key_eps, _ = jax.random.split(k2, 3)
    n = jax.random.randint(key_n, (moments.shape[0],), 1, n_timesteps + 1)
    eps = jax.random.normal(key_eps, moments[..., :4].shape, dtype=moments.dtype)
    return {k: np.array(v) for k, v in dict(z=z, n=n, eps=eps).items()}


def run(trainer, jt, state, to_port):
    for i, batch in enumerate(image_batches()):
        key = jax.random.fold_in(jt.rng, i + 1)
        state, metrics = jt._train_step(state, tuple(jnp.asarray(x) for x in batch), key)
        want = dict(metrics={k: float(v) for k, v in metrics.items()},
                    params=to_port(state.params), ema=to_port(state.ema_params))
        assert sorted(want["metrics"]) == ["grad_norm", "loss"]
        got = port_step(trainer, batch, jax_draws(key, batch))
        assert_step_matches(got, want, keys=("loss", "grad_norm"))
    assert trainer.state.step == STEPS


def test_three_image_only_uvit_t2i_steps_match_jax_trainer(tmp_path):
    jconfig = jax_get_config("synthetic_tiny")
    jconfig.nnet.enable_panoptic = False
    jt = JaxTrainer(jconfig, str(tmp_path / "jax"))

    def to_port(tree):
        return uvit_t2i_state_dict(jax.tree.map(np.asarray, tree), patch_size=2)

    config = get_config("synthetic_tiny")
    config.nnet.enable_panoptic = False
    trainer = Trainer(config, str(tmp_path / "port"), device="cpu")
    assert not any("mask" in n for n in trainer.state.params)
    trainer.nnet.load_state_dict({k: torch.from_numpy(np.array(v))
                                  for k, v in to_port(jt.state.params).items()}, strict=True)
    for name, p in trainer.state.params.items():
        trainer.state.ema[name].copy_(p.detach())
    run(trainer, jt, jt.state, to_port)


def test_three_image_only_unet_steps_match_jax_trainer(tmp_path):
    config, jconfig = train_configs()
    config.nnet.enable_panoptic = False
    jconfig.nnet = ml_collections.ConfigDict(dict(config.nnet))
    trainer = Trainer(config, str(tmp_path), device="cpu")
    assert not any("mask" in n for n in trainer.state.params)
    jt = train_jax_trainer(jconfig, to_jax(trainer.nnet.state_dict()))
    run(trainer, jt, jt.state, lambda tree: unet_state_dict(jax.tree.map(np.asarray, tree)))


def test_image_only_fit_reads_moments_and_context(tmp_path):
    config = get_config("synthetic_tiny")
    config.nnet.enable_panoptic = False
    config.num_workers = 0
    trainer = Trainer(config, str(tmp_path), device="cpu")
    history = trainer.fit(max_steps=5)
    assert trainer.state.step == 5 and np.isfinite(history[-1]["loss"])
    assert "loss_mask" not in history[-1]
