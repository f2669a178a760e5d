"""Shared harness of the port's training-parity tests (not collected itself).

`jax_reference` runs the JAX package's own `Trainer` (synthetic_tiny, f32)
for a few steps and records, per step, its gradients (`jax.grad` of
`Trainer._loss`), the metrics of `Trainer._train_step` and the parameters
and EMA after it, all carried to the port's parameter names by the port's
numpy-only `utils/weights.py` (a pure relayout, so it maps gradients too).
`port_run` runs the port's `Trainer` on CPU from the same parameters on the
same batches, handing it the JAX trainer's random draws (the VAE noise, the
timesteps, eps and the mask noise) as `noise`.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from panopticdiffusionmodels_tpu.configs import get_config as jax_get_config
from panopticdiffusionmodels_tpu.diffusion.analog_bits import ints_to_analog
from panopticdiffusionmodels_tpu.diffusion.schedule import MASK_NOISE_SCALE
from panopticdiffusionmodels_tpu.train.trainer import Trainer as JaxTrainer
from panopticdiffusionmodels_torch.configs import get_config
from panopticdiffusionmodels_torch.train.trainer import Trainer
from panopticdiffusionmodels_torch.utils.weights import uvit_t2i_state_dict

BATCH = 16
MASK_PATCH = 4  # synthetic_tiny: patch 2 x mask_size 16 / img_size 8


def batches(n: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(BATCH, 8, 8, 8)).astype(np.float32),
             rng.normal(size=(BATCH, 7, 16)).astype(np.float32),
             rng.integers(0, 201, size=(BATCH, 16, 16, 1)).astype(np.int32))
            for _ in range(n)]


def to_port(tree) -> dict:
    tree = jax.tree.map(np.asarray, tree)
    return uvit_t2i_state_dict(tree, patch_size=2, mask_patch_size=MASK_PATCH)


def jax_draws(key, batch, n_timesteps: int = 1000) -> dict:
    """The draws `Trainer._loss` makes from `key` (t2i_discrete branch)."""
    k1, k2 = jax.random.split(key)
    moments = jnp.asarray(batch[0])
    z = jax.random.normal(k1, moments[..., :4].shape, dtype=moments.dtype)
    key_n, key_eps, key_eps_m = jax.random.split(k2, 3)
    b = moments.shape[0]
    n = jax.random.randint(key_n, (b,), 1, n_timesteps + 1)
    eps = jax.random.normal(key_eps, moments[..., :4].shape, dtype=moments.dtype)
    mask = ints_to_analog(jnp.asarray(batch[2]), n=8, dtype=moments.dtype)
    eps_m = MASK_NOISE_SCALE * jax.random.normal(key_eps_m, mask.shape, dtype=mask.dtype)
    return {k: np.array(v) for k, v in dict(z=z, n=n, eps=eps, eps_m=eps_m).items()}


def configure(config, use_checkpoint: bool, pretrained: str, mesh=None, nnet=None):
    config.nnet.use_checkpoint = use_checkpoint
    config.nnet.update(nnet or {})
    config.pretrained = pretrained
    config.mesh.update(mesh or {})
    return config


def jax_reference(workdir, steps, use_checkpoint=False, pretrained="", mesh=None,
                  with_grads=True, nnet=None):
    """(initial params, [per-step dict(grads, metrics, params, ema, draws)]);
    `mesh` and `nnet` override the config's mesh and network fields, and
    `with_grads=False` skips the separate gradient pass (no 'grads' entry)."""
    trainer = JaxTrainer(configure(jax_get_config("synthetic_tiny"), use_checkpoint,
                                   pretrained, mesh, nnet), str(workdir))
    state = trainer.state
    init = to_port(state.params)
    grad_fn = jax.jit(jax.grad(trainer._loss, has_aux=True))
    out = []
    for i, batch in enumerate(steps):
        key = jax.random.fold_in(trainer.rng, i + 1)
        jb = tuple(jnp.asarray(x) for x in batch)
        step = {}
        if with_grads:
            step["grads"] = to_port(grad_fn(state.params, jb, key)[0])
        state, metrics = trainer._train_step(state, jb, key)
        out.append(dict(step, metrics={k: float(v) for k, v in metrics.items()},
                        params=to_port(state.params), ema=to_port(state.ema_params),
                        draws=jax_draws(key, batch)))
    return init, out


def port_trainer(workdir, use_checkpoint=False, pretrained="", init=None, mesh=None) -> Trainer:
    trainer = Trainer(configure(get_config("synthetic_tiny"), use_checkpoint, pretrained, mesh),
                      str(workdir), device="cpu")
    if init is not None:
        trainer.nnet.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in init.items()},
                                     strict=True)
        for name, p in trainer.state.params.items():
            trainer.state.ema[name].copy_(p.detach())
    return trainer


def port_step(trainer: Trainer, batch, draws) -> dict:
    metrics = trainer.loss_and_grads(batch, draws)
    grads = {n: p.grad.detach().clone() for n, p in trainer.state.params.items()}
    trainer.state.apply_gradients(ema_rate=trainer.config.get("ema_rate", 0.9999))
    return dict(grads=grads, metrics={k: float(v) for k, v in metrics.items()},
                params={n: p.detach().clone() for n, p in trainer.state.params.items()},
                ema={n: e.clone() for n, e in trainer.state.ema.items()})


def assert_step_matches(ours: dict, ref: dict, rtol=1e-4, atol=1e-6,
                        keys=("loss", "loss_mask", "grad_norm")):
    for k in keys:
        np.testing.assert_allclose(ours["metrics"][k], ref["metrics"][k], rtol=rtol, atol=atol,
                                   err_msg=k)
    for part in ("grads", "params", "ema") if "grads" in ref else ("params", "ema"):
        assert sorted(ours[part]) == sorted(ref[part]), part
        for name, want in ref[part].items():
            np.testing.assert_allclose(ours[part][name].numpy(), want, rtol=rtol, atol=atol,
                                       err_msg=f"{part}: {name}")
