"""Sequence-parallel training of the class-conditional U-ViT against the JAX
`Trainer`.

Three `latent_discrete` AdamW + EMA steps of synthetic_tiny_cond (the
imagenet256_uvit_large task at width 32, depth 4: 2 + 16 = 18 tokens, 9 a
shard) at mesh.sp = 2 in process (both shards on the CPU, folded into the
batch, every attention on the ring), against the JAX `Trainer` with
mesh.sp = 2 on the 8-device CPU mesh, whose U-ViT constrains its tokens at
every block boundary and whose attention takes the ring
(`models/uvit.py:130-190`, `train/trainer.py:130-150`), from the JAX
trainer's own initial parameters, on the same batches and the JAX trainer's
random draws: loss, grad_norm, the updated parameters and the EMA at rtol
1e-4 / atol 1e-5, the tolerance of the JAX package's own sp-against-dp test
and of `test_torch_port_train_sp.py`; the port with `use_checkpoint`
('save_attn', whose replay keeps the ring's output) too, against the same
JAX steps (a remat changes no value).  A stream that does not divide
sp (the unconditional pixel U-ViT's 17 tokens, as CIFAR-10's 257) is
padded: its step equals the unsharded one.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panopticdiffusionmodels_torch.configs import get_config
from panopticdiffusionmodels_torch.parallel.mesh import InProcessSP
from panopticdiffusionmodels_torch.train.trainer import Trainer
from test_torch_port_train_latent import batches, configs, jax_draws, to_port
from torch_port_train_common import assert_step_matches, jax_placement, jax_trainer, port_step

STEPS = 3


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    _, jconfig = configs()
    jconfig.mesh.sp = 2
    trainer = jax_trainer(jconfig, tmp_path_factory.mktemp("jax_sp"))
    assert trainer.mesh.shape["sp"] == 2
    state = trainer.state
    init = to_port(state.params)
    placement = jax_placement(state)
    out = []
    for i, batch in enumerate(batches(STEPS)):
        key = jax.random.fold_in(trainer.rng, i + 1)
        state, metrics = trainer._train_step(jax.device_put(state, placement),
                                             tuple(jnp.asarray(x) for x in batch), key)
        out.append(dict(metrics={k: float(v) for k, v in metrics.items()},
                        params=to_port(state.params), ema=to_port(state.ema_params),
                        draws=jax_draws(key, batch)))
    return init, out


@pytest.mark.parametrize("use_checkpoint", [False, True], ids=["plain", "use_checkpoint"])
def test_three_sp_uvit_steps_match_jax_sp_trainer(ref, tmp_path, use_checkpoint):
    init, steps = ref
    config, _ = configs(use_checkpoint)
    config.mesh.update(sp=2, sp_mode="in_process")
    trainer = Trainer(config, str(tmp_path), device="cpu")
    assert isinstance(trainer.sp, InProcessSP) and trainer.nnet.sp is trainer.sp
    attns = [m for m in trainer.nnet.modules() if hasattr(m, "attn_impl")]
    assert attns and all(m.attn_impl == "ring" and m.sp is trainer.sp for m in attns)
    trainer.nnet.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in init.items()},
                                 strict=True)
    for name, p in trainer.state.params.items():
        trainer.state.ema[name].copy_(p.detach())
    for batch, want in zip(batches(STEPS), steps):
        assert_step_matches(port_step(trainer, batch, want["draws"]), want, rtol=1e-4,
                            atol=1e-5, keys=("loss", "grad_norm"))
    assert trainer.state.step == STEPS


def test_a_stream_that_does_not_divide_sp_raises(tmp_path):
    """17 tokens at sp = 2 pad to 18: one step of the sharded trainer (the
    pad key masked in every hop, the pad row dropped at the gather) equals
    the unsharded trainer's on the same batch and draws."""
    out = []
    for sp in (1, 2):
        config = get_config("synthetic_tiny_pixel")
        config.mesh.update(sp=sp, sp_mode="in_process")
        config.num_workers = 0
        trainer = Trainer(config, str(tmp_path / str(sp)), device="cpu")
        assert (trainer.sp is None) == (sp == 1)
        batch = next(iter(trainer.data_stream()))
        metrics = trainer.loss_and_grads(batch)
        out.append((metrics, {n: p.grad.clone() for n, p in trainer.state.params.items()}))
    for k, v in out[0][0].items():
        np.testing.assert_allclose(float(out[1][0][k]), float(v), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    for name, g in out[0][1].items():
        np.testing.assert_allclose(out[1][1][name].numpy(), g.numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=name)
