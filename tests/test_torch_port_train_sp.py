"""Sequence-parallel training of the port against the JAX `Trainer`.

Three AdamW + EMA steps of the port's `Trainer` at mesh.sp = 2, in-process
(both shards on the CPU, folded into the batch, every attention on the
ring), against the JAX `Trainer` with mesh.sp = 2 on the 8-device CPU mesh
(ring attention over shard_map), synthetic_tiny in f32, from the JAX
trainer's own initial parameters, on the same batches and the JAX trainer's
random draws.  Losses, grad_norm, the updated parameters and the EMA must
match at rtol 1e-4 / atol 1e-5, the tolerance of the JAX package's own
`test_trainer_sp_ring_matches_dp1` (`tests/test_ring_attention.py:215-221`).
"""
import pytest

from panopticdiffusionmodels_torch.parallel.mesh import InProcessSP
from torch_port_train_common import (
    assert_step_matches,
    batches,
    jax_reference,
    port_step,
    port_trainer,
)

STEPS = 3


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return jax_reference(tmp_path_factory.mktemp("jax_sp"), batches(STEPS), mesh=dict(sp=2),
                         with_grads=False)


def test_three_sp_steps_match_jax_sp_trainer(ref, tmp_path):
    init, steps = ref
    trainer = port_trainer(tmp_path, init=init, mesh=dict(sp=2, sp_mode="in_process"))
    assert isinstance(trainer.sp, InProcessSP)
    attns = [m for m in trainer.nnet.modules() if hasattr(m, "attn_impl")]
    assert attns and all(m.attn_impl == "ring" and m.sp is trainer.sp for m in attns)
    for batch, want in zip(batches(STEPS), steps):
        assert_step_matches(port_step(trainer, batch, want["draws"]), want, rtol=1e-4,
                            atol=1e-5)
    assert trainer.state.step == STEPS
