"""Fine-tuning train steps of the port, with `use_checkpoint=True`, against
the JAX `Trainer` with the same flag (remat_policy 'save_attn').

Both trainers start from one reference-format `.pth` (a seeded port model
with its zero convs opened, so the mask stream feeds the image stream), so
the image stream is frozen on both sides (`panoptic_image_stream_mask`).
Three AdamW + EMA steps on the same batches and the JAX trainer's draws
must match at rtol 1e-4 / atol 1e-6, frozen parameters must stay put while
their gradients count in grad_norm, and the checkpointed port step must
equal the unchecked one.
"""
import jax
import numpy as np
import pytest
import torch

from panopticdiffusionmodels_tpu.train.state import panoptic_image_stream_mask
from panopticdiffusionmodels_tpu.utils.torch_bridge import convert_uvit_t2i
from panopticdiffusionmodels_torch.configs import get_config
from panopticdiffusionmodels_torch.models import get_nnet
from panopticdiffusionmodels_torch.train.state import panoptic_image_stream_frozen
from torch_port_train_common import (
    assert_step_matches,
    batches,
    jax_reference,
    port_step,
    port_trainer,
    to_port,
)

torch.set_num_threads(1)

STEPS = 3


def write_pth(path) -> str:
    kw = dict(get_config("synthetic_tiny").nnet)
    torch.manual_seed(11)
    model = get_nnet(kw.pop("name"), **kw)
    with torch.no_grad():
        for zc in model.zero_convs.values():
            zc.conv.weight.normal_(0, 0.02)
            zc.conv.bias.normal_(0, 0.02)
    torch.save(model.state_dict(), path)
    return str(path)


@pytest.fixture(scope="module")
def pth(tmp_path_factory):
    return write_pth(tmp_path_factory.mktemp("pre") / "nnet.pth")


@pytest.fixture(scope="module")
def ref(tmp_path_factory, pth):
    return jax_reference(tmp_path_factory.mktemp("jax"), batches(STEPS, seed=1),
                         use_checkpoint=True, pretrained=pth)


def test_finetune_checkpointed_steps_match_jax(ref, pth, tmp_path):
    init, steps = ref
    trainer = port_trainer(tmp_path, use_checkpoint=True, pretrained=pth)
    assert all(b.use_checkpoint for b in trainer.nnet.in_blocks_mask)
    for name, p in trainer.state.params.items():
        np.testing.assert_array_equal(p.detach().numpy(), init[name], err_msg=name)
    frozen = trainer.state.frozen
    assert frozen
    for batch, want in zip(batches(STEPS, seed=1), steps):
        got = port_step(trainer, batch, want["draws"])
        assert_step_matches(got, want)
        for name in frozen:
            np.testing.assert_array_equal(got["params"][name].numpy(), init[name])
            assert float(got["grads"][name].abs().max()) > 0, name


def test_checkpointed_step_equals_unchecked(pth, tmp_path):
    draws = {"n": np.array([3, 990, 400, 17] * 4)}
    outs = []
    for flag in (True, False):
        trainer = port_trainer(tmp_path / str(flag), use_checkpoint=flag, pretrained=pth)
        gen = torch.Generator().manual_seed(5)  # the same remaining draws on both
        trainer.generator = gen
        outs.append(port_step(trainer, batches(1, seed=2)[0], draws))
    for part in ("grads", "params", "ema"):
        for name, a in outs[0][part].items():
            torch.testing.assert_close(a, outs[1][part][name], rtol=1e-6, atol=1e-7,
                                       msg=f"{part}: {name}")
    assert outs[0]["metrics"] == pytest.approx(outs[1]["metrics"], rel=1e-6)


def test_frozen_set_is_the_jax_mask(pth):
    sd = torch.load(pth, weights_only=True)
    for scan in (False, True):
        params = convert_uvit_t2i({k: v.numpy() for k, v in sd.items()}, depth=4,
                                  scan_blocks=scan)["params"]
        mask = panoptic_image_stream_mask(params)
        filled = jax.tree.map(lambda p, f: np.full(np.shape(p), f), params, mask)
        want = {k for k, v in to_port(filled).items() if v.all()}
        assert want == panoptic_image_stream_frozen(sd), scan
    assert {"pos_embed", "pos_embed_mask", "zero_convs.1.conv.weight",
            "mid_block_mask.attn.qkv.weight"}.isdisjoint(want)
