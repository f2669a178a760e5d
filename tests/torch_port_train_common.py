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

import functools

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

# The port's tests run one intra-op thread: the test processes share the
# host's cores.  Every process that collects the port's tests imports this.
torch.set_num_threads(1)

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


@functools.partial(jax.jit, static_argnames="n_timesteps")
def _draws(key, moments, ints, n_timesteps):
    k1, k2 = jax.random.split(key)
    z = jax.random.normal(k1, moments[..., :4].shape, dtype=moments.dtype)
    key_n, key_eps, key_eps_m = jax.random.split(k2, 3)
    n = jax.random.randint(key_n, (moments.shape[0],), 1, n_timesteps + 1)
    eps = jax.random.normal(key_eps, moments[..., :4].shape, dtype=moments.dtype)
    mask = ints_to_analog(ints, n=8, dtype=moments.dtype)
    eps_m = MASK_NOISE_SCALE * jax.random.normal(key_eps_m, mask.shape, dtype=mask.dtype)
    return dict(z=z, n=n, eps=eps, eps_m=eps_m)


def jax_draws(key, batch, n_timesteps: int = 1000) -> dict:
    """The draws `Trainer._loss` makes from `key` (t2i_discrete branch), as
    one jitted program: eagerly each draw compiles on its own."""
    draws = _draws(key, jnp.asarray(batch[0]), jnp.asarray(batch[2]), n_timesteps=n_timesteps)
    return {k: np.array(v) for k, v in draws.items()}


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
    trainer = jax_trainer(configure(jax_get_config("synthetic_tiny"), use_checkpoint,
                                    pretrained, mesh, nnet), workdir)
    state = trainer.state
    init = to_port(state.params)
    grad_fn = jax.jit(jax.grad(trainer._loss, has_aux=True))
    placement = jax_placement(state)
    out = []
    for i, batch in enumerate(steps):
        key = jax.random.fold_in(trainer.rng, i + 1)
        jb = tuple(jnp.asarray(x) for x in batch)
        state = jax.device_put(state, placement)
        step = {}
        if with_grads:
            step["grads"] = to_port(grad_fn(state.params, jb, key)[0])
        state, metrics = trainer._train_step(state, jb, key)
        out.append(dict(step, metrics={k: float(v) for k, v in metrics.items()},
                        params=to_port(state.params), ema=to_port(state.ema_params),
                        draws=jax_draws(key, batch)))
    return init, out


def jax_trainer(config, workdir, params=None):
    """The JAX `Trainer` of `config`, its parameter init one jitted program,
    or starting from `params` (a host copy of another trainer's).  Eagerly,
    every draw of the init compiles on its own (the values are the same),
    and the token sharding of a stream that does not divide sp lands on a
    pjit output, which JAX refuses; under jit it is an intermediate that
    GSPMD pads, as in the jitted train step."""
    init_params = JaxTrainer._init_params
    try:
        JaxTrainer._init_params = (
            (lambda self: jax.jit(lambda: init_params(self))()) if params is None
            else (lambda self: jax.tree.map(jnp.asarray, params)))
        return JaxTrainer(config, str(workdir))
    finally:
        JaxTrainer._init_params = init_params


def jax_mesh_trainer(workdir, mesh, nnet=None, train=None, clip_tokens: int = 7, params=None):
    """The JAX `Trainer` of synthetic_tiny (f32) at `mesh`, `nnet` / `train`
    fields overridden, `clip_tokens` context tokens, from `params` if given."""
    config = configure(jax_get_config("synthetic_tiny"), False, "", mesh,
                       dict(nnet or {}, num_clip_token=clip_tokens))
    config.dataset.clip_shape = (clip_tokens, 16)
    config.train.update(train or {})
    return jax_trainer(config, workdir, params)


def jax_mesh_draws(trainer, raw, accum: int = 1) -> list:
    """[(batch, draws)]: the numpy batches `raw` with the draws the JAX
    trainer's step i + 1 makes on each.  Under `train.grad_accum=accum` the
    JAX step splits its key over the micro-batches (contiguous rows): the
    draws of each, concatenated."""
    out = []
    for i, batch in enumerate(raw):
        key = jax.random.fold_in(trainer.rng, i + 1)
        if accum == 1:
            out.append((batch, jax_draws(key, batch)))
            continue
        micro = [tuple(x.reshape(accum, -1, *x.shape[1:])[j] for x in batch)
                 for j in range(accum)]
        parts = [jax_draws(k, b) for k, b in zip(jax.random.split(key, accum), micro)]
        out.append((batch, {n: np.concatenate([p[n] for p in parts]) for n in parts[0]}))
    return out


def jax_placement(state):
    """The shardings of the JAX trainer's initial state.  Its step returns
    some leaves placed otherwise (a tp-split bias comes back replicated),
    and a step given those would compile a second time: every step starts
    from this placement (the values are unchanged)."""
    return jax.tree.map(lambda x: x.sharding, state)


def jax_mesh_steps(trainer, raw) -> tuple:
    """The JAX trainer's steps on the numpy batches `raw`: ([metrics],
    dict(params, ema) after them by the port's names, as tensors)."""
    state, metrics = trainer.state, []
    placement = jax_placement(state)
    for i, batch in enumerate(raw):
        state, m = trainer._train_step(jax.device_put(state, placement),
                                       tuple(jnp.asarray(x) for x in batch),
                                       jax.random.fold_in(trainer.rng, i + 1))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, {k: {n: torch.from_numpy(np.array(v)) for n, v in to_port(t).items()}
                     for k, t in (("params", state.params), ("ema", state.ema_params))}


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
