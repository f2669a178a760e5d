"""Asynchronous checkpoint saves of the port (JAX `train/checkpoint.py:27-75`,
orbax with `block=False`).

The write of a `save_checkpoint(..., block=False)` is held back on its
thread until the test lets it go, so a train step certainly runs before it
ends: the file must still hold the state at the call (AdamW and the EMA
update the parameters and moments in place, so a write that read the live
tensors would save the later state).  A second save waits for the first, so
both land, in order; `latest_step` waits for the pending write; an error of
the write comes back from `wait_for_saves`; `fit` saves asynchronously and
returns with every write on disk.
"""
import threading

import pytest
import torch

from panopticdiffusionmodels_torch.configs import get_config
from panopticdiffusionmodels_torch.train import checkpoint as ckpt_lib
from panopticdiffusionmodels_torch.train.trainer import Trainer
from torch_port_train_common import batches


@pytest.fixture
def trainer(tmp_path):
    config = get_config("synthetic_tiny")
    config.num_workers = 0
    config.lr_scheduler.warmup_steps = 1  # every step moves the parameters
    return Trainer(config, str(tmp_path), device="cpu")


@pytest.fixture
def gate(monkeypatch):
    """Holds every background write until `gate.set()`; records the paths."""
    release, order = threading.Event(), []
    write = ckpt_lib._write

    def held(payload, path):
        assert release.wait(30)
        order.append(path)
        write(payload, path)

    monkeypatch.setattr(ckpt_lib, "_write", held)
    release.order = order
    yield release
    release.set()
    ckpt_lib.wait_for_saves()


def snapshot(state):
    return ({n: p.detach().clone() for n, p in state.params.items()},
            {n: e.clone() for n, e in state.ema.items()},
            {k: v.clone() for k, v in state.optimizer.state[next(iter(
                state.optimizer.state))].items()})


def assert_payload(payload, step, snap):
    params, ema, moments = snap
    assert payload["step"] == step
    for name, p in params.items():
        assert torch.equal(payload["params"][name], p), name
        assert torch.equal(payload["ema_params"][name], ema[name]), name
    first = payload["opt_state"]["state"][0]
    for k, v in moments.items():
        assert torch.equal(first[k], v), k


def test_async_save_holds_the_state_at_the_call(trainer, gate):
    batch = batches(3)
    trainer.train_step(batch[0])
    trainer.train_step(batch[1])
    before = snapshot(trainer.state)
    path = ckpt_lib.save_checkpoint(trainer.ckpt_root, trainer.state, block=False)
    trainer.train_step(batch[2])  # in place: parameters, EMA and moments move on
    after = snapshot(trainer.state)
    assert not torch.equal(next(iter(after[0].values())), next(iter(before[0].values())))
    assert gate.order == []  # the write has not run yet
    gate.set()
    ckpt_lib.wait_for_saves()
    assert_payload(ckpt_lib.load_checkpoint(path), 2, before)


def test_a_second_save_waits_for_the_first_and_both_land(trainer, gate):
    batch = batches(2)
    trainer.train_step(batch[0])
    first = snapshot(trainer.state)
    ckpt_lib.save_checkpoint(trainer.ckpt_root, trainer.state, block=False)
    trainer.train_step(batch[1])
    second = snapshot(trainer.state)
    done = threading.Event()

    def save_again():
        ckpt_lib.save_checkpoint(trainer.ckpt_root, trainer.state, block=False)
        done.set()

    thread = threading.Thread(target=save_again)
    thread.start()
    assert not done.wait(0.5)  # blocked behind the pending write
    gate.set()
    thread.join(30)
    assert done.is_set()
    assert ckpt_lib.latest_step(trainer.ckpt_root) == 2  # waits for the second write
    assert [p.rsplit("/", 1)[1] for p in gate.order] == ["1.ckpt", "2.ckpt"]
    assert_payload(ckpt_lib.load_checkpoint(ckpt_lib.ckpt_path(trainer.ckpt_root, 1)), 1, first)
    assert_payload(ckpt_lib.load_checkpoint(ckpt_lib.ckpt_path(trainer.ckpt_root, 2)), 2,
                   second)


def test_latest_step_waits_for_the_pending_write(trainer, gate):
    trainer.train_step(batches(1)[0])
    ckpt_lib.save_checkpoint(trainer.ckpt_root, trainer.state, block=False)
    threading.Timer(0.3, gate.set).start()
    assert ckpt_lib.latest_step(trainer.ckpt_root) == 1


def test_a_failed_write_is_raised_by_wait_for_saves(trainer, monkeypatch):
    def broken(payload, path):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt_lib, "_write", broken)
    ckpt_lib.save_checkpoint(trainer.ckpt_root, trainer.state, block=False)
    with pytest.raises(RuntimeError, match="asynchronous checkpoint write failed"):
        ckpt_lib.wait_for_saves()
    ckpt_lib.wait_for_saves()  # reported once


def test_fit_returns_with_its_async_saves_on_disk(trainer, monkeypatch):
    calls = []
    save = ckpt_lib.save_checkpoint

    def recorded(root, state, step=None, block=True):
        calls.append(block)
        return save(root, state, step, block)

    monkeypatch.setattr(ckpt_lib, "save_checkpoint", recorded)
    trainer.config.train.save_interval = 2
    trainer.fit(max_steps=4)
    assert calls == [False, False] and ckpt_lib._pending is None
    assert ckpt_lib.load_checkpoint(ckpt_lib.ckpt_path(trainer.ckpt_root, 4))["step"] == 4
