"""Three AdamW + EMA train steps of the panoptic UNet against the JAX `Trainer`.

synthetic_tiny's task and data with the tiny UNet of
`tests/torch_port_unet_common.py` cut to two levels of 64 channels (f32), from the port trainer's initial
parameters with the mask gate opened (so the mask encoder's gradient flows
through the image path), on the batches of `tests/torch_port_train_common.py`
and the JAX trainer's random draws: loss, loss_mask, grad_norm, the updated
parameters and the EMA must match at rtol 1e-4 / atol 1e-6 after each step,
the tolerance of the U-ViT train-step tests (step 1 runs at lr 0, so steps
2 and 3 hold every gradient through AdamW).  The JAX trainer is built by
`__new__` with what its step reads (its constructor initialises the UNet op
by op for ~20 s), and its gradients are not taken separately: a second
compile of the UNet's backward costs ~9 s on a CPU.  Then: a fine-tune from an LDM
checkpoint (a `.pth` in tmp_path) loads the image stream and freezes what the
JAX mask freezes, nothing of the UNet; `mesh.sp = 2` raises as in JAX.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panopticdiffusionmodels_tpu.train.state import panoptic_image_stream_mask
from panopticdiffusionmodels_torch.train.trainer import Trainer
from panopticdiffusionmodels_torch.utils.ldm_bridge import convert_ldm_unet
from panopticdiffusionmodels_torch.utils.weights import unet_state_dict
from torch_port_train_common import assert_step_matches, batches, jax_draws, port_step
from torch_port_unet_common import ldm_state_dict, open_gate, to_jax
from torch_port_unet_common import train_configs as configs
from torch_port_unet_common import train_jax_trainer as jax_trainer

torch.set_num_threads(4)

STEPS = 3


def to_port(tree):
    return unet_state_dict(jax.tree.map(np.asarray, tree))


def test_three_unet_steps_match_jax_trainer(tmp_path):
    config, jconfig = configs()
    trainer = Trainer(config, str(tmp_path), device="cpu")
    open_gate(trainer.nnet, seed=4)
    for name, p in trainer.state.params.items():
        trainer.state.ema[name].copy_(p.detach())
    jt = jax_trainer(jconfig, to_jax(trainer.nnet.state_dict()))
    state = jt.state
    for i, batch in enumerate(batches(STEPS)):
        key = jax.random.fold_in(jt.rng, i + 1)
        state, metrics = jt._train_step(state, tuple(jnp.asarray(x) for x in batch), key)
        want = dict(metrics={k: float(v) for k, v in metrics.items()},
                    params=to_port(state.params), ema=to_port(state.ema_params))
        got = port_step(trainer, batch, jax_draws(key, batch))
        assert_step_matches(got, want)
    assert trainer.state.step == STEPS
    assert float(trainer.nnet.mask_zero_gate.weight.detach().abs().max()) > 0


def test_fine_tune_from_an_ldm_checkpoint_freezes_what_jax_freezes(tmp_path):
    sd = ldm_state_dict(32, (2, 2), 1)
    path = tmp_path / "ldm.pth"
    torch.save({"state_dict": {"model.diffusion_model." + k: torch.from_numpy(v)
                               for k, v in sd.items()}}, path)
    config, _ = configs(pretrained=str(path))
    trainer = Trainer(config, str(tmp_path / "run"), device="cpu")
    image = convert_ldm_unet(sd, channel_mult=(2, 2), num_res_blocks=1)
    for k, v in trainer.nnet.state_dict().items():
        if k in image:
            torch.testing.assert_close(v, image[k], rtol=0, atol=0)
        else:
            assert k.startswith("mask_"), k
    jmask = panoptic_image_stream_mask(to_jax(trainer.nnet.state_dict())["params"])
    jax_frozen = sum(bool(x) for x in jax.tree.leaves(jmask))
    assert jax_frozen == 0 and trainer.state.frozen == set()
    history = trainer.fit(max_steps=5)
    assert trainer.state.step == 5 and np.isfinite(history[-1]["loss"])
    assert np.isfinite(history[-1]["loss_mask"])


def test_sequence_parallel_unet_raises_as_in_jax(tmp_path):
    config, _ = configs()
    config.mesh.sp = 2
    with pytest.raises(ValueError, match="mesh.sp>1 is not supported for nnet 'unet_t2i'"):
        Trainer(config, str(tmp_path), device="cpu")
