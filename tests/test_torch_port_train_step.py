"""Three AdamW + EMA train steps of the port against the JAX `Trainer`.

synthetic_tiny in f32, from the JAX trainer's own initial parameters, on the
same batches and the JAX trainer's random draws: loss, loss_mask, grad_norm,
every gradient, the updated parameters and the EMA must match at rtol 1e-4 /
atol 1e-6 after each step (f32 throughout; the sides differ in summation
order only).  Step 1 is the warm-up trap: optax evaluates the schedule at
count 0, so its lr is 0.
"""
import numpy as np
import pytest

from panopticdiffusionmodels_tpu.train.state import make_lr_schedule as jax_lr_schedule
from panopticdiffusionmodels_torch.train.state import make_lr_schedule
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
    return jax_reference(tmp_path_factory.mktemp("jax"), batches(STEPS))


def test_three_steps_match_jax_trainer(ref, tmp_path):
    init, steps = ref
    trainer = port_trainer(tmp_path, init=init)
    for i, (batch, want) in enumerate(zip(batches(STEPS), steps)):
        got = port_step(trainer, batch, want["draws"])
        assert_step_matches(got, want)
        if i == 0:  # lr(count 0) = 0: the first update leaves the parameters as they were
            for name, p in got["params"].items():
                np.testing.assert_array_equal(p.numpy(), init[name], err_msg=name)
    assert trainer.state.step == STEPS


@pytest.mark.parametrize("name,kw", [("customized", dict(warmup_steps=10)),
                                     ("customized", {}),
                                     ("cosine", dict(total_steps=40))])
def test_lr_schedule_matches_jax(name, kw):
    sched = make_lr_schedule(2e-4, name, **kw)
    ref = jax_lr_schedule(2e-4, name, **kw)
    counts = [0, 1, 5, 10, 39, 40, 100]
    np.testing.assert_allclose([sched(k) for k in counts], [float(ref(k)) for k in counts],
                               rtol=1e-6, atol=0)
    if kw.get("warmup_steps"):
        assert sched(0) == 0.0
