"""`infer_task` and `optimizer.name='adam'` of the port against the JAX package.

  * With `task` removed, every zoo config must infer the task JAX's
    `infer_task` infers (`train/trainer.py:73-87`), or be refused as JAX
    refuses it: a latent config is ambiguous between latent_discrete and
    latent_sde.  The port's `Trainer` falls back to it.
  * Three Adam + EMA steps (JAX `train/state.py:62-89`: `optax.adam`, no
    weight decay, with the frozen mask of a fine-tune) of synthetic_tiny
    fine-tuned from a reference-format `.pth` (the image stream frozen on
    both sides), f32, on the same batches and the JAX trainer's draws: loss,
    loss_mask, grad_norm, the updated parameters and the EMA at rtol 1e-4 /
    atol 1e-6, the tolerance of the AdamW train-step tests; the frozen
    parameters do not move.  The JAX trainer is built by `__new__` with what
    its step reads.
"""
import jax
import jax.numpy as jnp
import ml_collections
import numpy as np
import pytest
import torch

from panopticdiffusionmodels_tpu.configs import CONFIG_NAMES as JAX_NAMES
from panopticdiffusionmodels_tpu.configs import get_config as jax_get_config
from panopticdiffusionmodels_tpu.train.state import panoptic_image_stream_mask
from panopticdiffusionmodels_tpu.train.trainer import infer_task as jax_infer_task
from panopticdiffusionmodels_tpu.utils.torch_bridge import convert_uvit_t2i
from panopticdiffusionmodels_torch.configs import CONFIG_NAMES, get_config
from panopticdiffusionmodels_torch.train.trainer import Trainer, infer_task
from torch_port_train_common import assert_step_matches, batches, jax_draws, port_step, to_port
from torch_port_unet_common import train_jax_trainer

STEPS = 3


def _outcome(fn, config):
    try:
        return fn(config)
    except ValueError as e:
        return f"ValueError: {e}"


@pytest.mark.parametrize("name", sorted(set(CONFIG_NAMES) & set(JAX_NAMES)))
def test_infer_task_matches_jax(name):
    config, jconfig = get_config(name), jax_get_config(name)
    del config["task"]
    del jconfig["task"]
    got, want = _outcome(infer_task, config), _outcome(jax_infer_task, jconfig)
    assert got == want
    assert got.startswith("ValueError: ambiguous latent config") == (
        "autoencoder" in config and config.nnet.name == "uvit")


def test_trainer_falls_back_to_infer_task(tmp_path):
    config = get_config("synthetic_tiny")
    del config["task"]
    assert Trainer(config, str(tmp_path / "t2i"), device="cpu").task == "t2i_discrete"
    config = get_config("synthetic_tiny_cond")
    del config["task"]
    with pytest.raises(ValueError, match="ambiguous latent config"):
        Trainer(config, str(tmp_path / "latent"), device="cpu")


def test_three_adam_steps_with_the_frozen_mask_match_jax(tmp_path):
    config = get_config("synthetic_tiny")
    config.optimizer.name = "adam"
    config.num_workers = 0
    seed = Trainer(config, str(tmp_path / "seed"), device="cpu")
    sd = {k: v.detach().clone() for k, v in seed.nnet.state_dict().items()}
    with torch.no_grad():  # open the zero convs, so the coupling carries a gradient
        g = torch.Generator().manual_seed(3)
        for k, v in sd.items():
            if k.startswith("zero_convs"):
                v.copy_(0.02 * torch.randn(v.shape, generator=g))
    path = tmp_path / "nnet.pth"
    torch.save(sd, path)
    config.pretrained = str(path)
    trainer = Trainer(config, str(tmp_path / "run"), device="cpu")
    assert isinstance(trainer.state.optimizer, torch.optim.Adam)
    assert trainer.state.frozen and all(n.split(".")[0] in ("patch_embed", "context_embed",
                                                            "time_embed", "mid_block",
                                                            "in_blocks", "out_blocks")
                                        for n in trainer.state.frozen)

    jconfig = jax_get_config("synthetic_tiny")
    for key, value in config.items():
        if key not in ("config_name", "mesh", "pretrained"):
            jconfig[key] = ml_collections.ConfigDict(dict(value)) if isinstance(value, dict) \
                else value
    params = convert_uvit_t2i({k: v.numpy() for k, v in sd.items()}, depth=config.nnet.depth,
                              scan_blocks=False)
    mask = panoptic_image_stream_mask(params["params"])
    assert sum(map(bool, jax.tree.leaves(mask))) == len(trainer.state.frozen)
    jt = train_jax_trainer(jconfig, params, optimizer="adam", frozen_mask={"params": mask})
    state = jt.state
    for i, batch in enumerate(batches(STEPS)):
        key = jax.random.fold_in(jt.rng, i + 1)
        state, metrics = jt._train_step(state, tuple(jnp.asarray(x) for x in batch), key)
        want = dict(metrics={k: float(v) for k, v in metrics.items()},
                    params=to_port(state.params), ema=to_port(state.ema_params))
        assert_step_matches(port_step(trainer, batch, jax_draws(key, batch)), want)
    for name in trainer.state.frozen:
        torch.testing.assert_close(trainer.state.params[name].detach(), sd[name], rtol=0, atol=0)
