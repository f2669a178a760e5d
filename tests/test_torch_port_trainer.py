"""The port's `Trainer` loop on CPU: fit, logging, checkpoints and resume, the
data stream, gradient accumulation, fine-tuning guards and the CLI.

Mirrors `tests/test_trainer.py` for the JAX package (fit smoke, the tiny
overfit whose loss must fall, `data_stream(start_step)`); the step itself is
held to the JAX trainer in `test_torch_port_train_step.py`.
"""
import json

import numpy as np
import pytest
import torch

from panopticdiffusionmodels_torch import cli
from panopticdiffusionmodels_torch.configs import get_config
from panopticdiffusionmodels_torch.train import checkpoint as ckpt_lib
from panopticdiffusionmodels_torch.train.trainer import Trainer

torch.set_num_threads(1)


def tiny(**train):
    config = get_config("synthetic_tiny")
    config.num_workers = 2
    config.train.update(train)
    return config


def test_fit_smoke_logs_finite_metrics(tmp_path):
    trainer = Trainer(tiny(), str(tmp_path), device="cpu")
    history = trainer.fit(max_steps=10)
    assert trainer.state.step == 10 and [m["step"] for m in history] == [5, 10]
    for m in history:
        for k in ("loss", "loss_mask", "grad_norm", "steps_per_sec", "images_per_sec"):
            assert np.isfinite(m[k]), k
    lines = (tmp_path / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(line)["step"] for line in lines] == [5, 10]


def test_loss_decreases_on_tiny_overfit(tmp_path):
    config = tiny(batch_size=16, log_interval=1)
    config.dataset.n = 16
    config.optimizer.lr = 1e-3
    config.lr_scheduler.warmup_steps = 1
    history = Trainer(config, str(tmp_path), device="cpu").fit(max_steps=40)
    first = np.mean([m["loss"] + m["loss_mask"] for m in history[:3]])
    last = np.mean([m["loss"] + m["loss_mask"] for m in history[-3:]])
    assert last < first, f"loss did not decrease: {first} -> {last}"


def test_checkpoint_resume_continues_the_uninterrupted_run(tmp_path):
    whole = Trainer(tiny(save_interval=4), str(tmp_path / "whole"), device="cpu")
    whole.fit(max_steps=6)
    first = Trainer(tiny(save_interval=4), str(tmp_path / "split"), device="cpu")
    first.fit(max_steps=4)
    assert ckpt_lib.latest_step(first.ckpt_root) == 4
    payload = ckpt_lib.load_checkpoint(ckpt_lib.ckpt_path(first.ckpt_root, 4))
    assert sorted(payload) == ["ema_params", "opt_state", "params", "step"]
    assert payload["step"] == 4
    second = Trainer(tiny(save_interval=4), str(tmp_path / "split"), device="cpu")
    second.fit(max_steps=6)  # resumes at step 4, then takes the batches of steps 5 and 6
    assert second.state.step == 6
    for name, p in whole.state.params.items():
        torch.testing.assert_close(second.state.params[name], p, rtol=1e-6, atol=1e-7)
        torch.testing.assert_close(second.state.ema[name], whole.state.ema[name],
                                   rtol=1e-6, atol=1e-7)


def test_resume_falls_back_to_best(tmp_path):
    trainer = Trainer(tiny(), str(tmp_path), device="cpu")
    trainer.state.step = 7
    ckpt_lib.save_checkpoint(trainer.ckpt_root, trainer.state, step="best")
    fresh = Trainer(tiny(), str(tmp_path), device="cpu")
    assert fresh.resume() and fresh.state.step == 7


def test_data_stream_resumes_at_step(tmp_path):
    trainer = Trainer(tiny(), str(tmp_path), device="cpu")
    s0 = trainer.data_stream()
    want = [next(s0) for _ in range(5)]
    got = next(trainer.data_stream(start_step=3))
    for a, b in zip(got, want[3]):
        assert torch.equal(a, b)
    assert got[2].dtype == torch.uint8  # panoptic ids ship as uint8 by default


def test_bf16_transfer_and_int32_opt_out(tmp_path):
    trainer = Trainer(tiny(transfer_dtype="bfloat16", transfer_mask_uint8=False),
                      str(tmp_path), device="cpu")
    moments, context, ids = next(trainer.data_stream())
    assert moments.dtype == context.dtype == torch.bfloat16 and ids.dtype == torch.int32
    assert np.isfinite(float(trainer.train_step((moments, context, ids))["loss"]))


def test_grad_accum_equals_the_full_batch(tmp_path):
    rng = np.random.default_rng(0)
    batch = (rng.normal(size=(16, 8, 8, 8)).astype(np.float32),
             rng.normal(size=(16, 7, 16)).astype(np.float32),
             rng.integers(0, 201, (16, 16, 16, 1)).astype(np.int32))
    noise = {"z": rng.normal(size=(16, 8, 8, 4)).astype(np.float32),
             "n": rng.integers(1, 1001, 16),
             "eps": rng.normal(size=(16, 8, 8, 4)).astype(np.float32),
             "eps_m": 2.0 * rng.normal(size=(16, 16, 16, 8)).astype(np.float32)}
    out = []
    for accum in (1, 2):
        trainer = Trainer(tiny(grad_accum=accum), str(tmp_path / str(accum)), device="cpu")
        metrics = trainer.loss_and_grads(batch, noise)
        out.append((metrics, {n: p.grad.clone() for n, p in trainer.state.params.items()}))
    for k in ("loss", "loss_mask", "grad_norm"):
        torch.testing.assert_close(out[1][0][k], out[0][0][k], rtol=1e-5, atol=1e-7)
    for name, g in out[0][1].items():
        torch.testing.assert_close(out[1][1][name], g, rtol=1e-4, atol=1e-7)


def test_missing_pretrained_raises(tmp_path):
    config = tiny()
    config.pretrained = str(tmp_path / "absent.pth")
    with pytest.raises(FileNotFoundError, match="absent.pth"):
        Trainer(config, str(tmp_path), device="cpu")


@pytest.mark.parametrize("field,value,match", [
    ("task", "pixel_sde", "slice"),
    ("mesh.tp", 2, "distributed"),
    ("mesh.pp", 2, "distributed"),
    ("mesh.fsdp", 2, "Queue 1 entry 4"),
    ("optimizer.name", "lamb", "adamw"),
])
def test_later_slices_raise(tmp_path, field, value, match):
    config = tiny()
    config.nnet.use_checkpoint = True
    node, *path = field.split(".")
    if path:
        config[node][path[0]] = value
    else:
        config[node] = value
    if field == "mesh.fsdp":  # ported since; one process cannot hold fsdp = 2
        with pytest.raises(ValueError, match="fsdp = 2 needs 2 processes"):
            Trainer(config, str(tmp_path), device="cpu")
        return
    with pytest.raises(NotImplementedError, match=match):
        Trainer(config, str(tmp_path), device="cpu")


def test_cli_trains_and_logs(tmp_path):
    wd = tmp_path / "run"
    history = cli.main(["train", "--config=synthetic_tiny", f"--workdir={wd}", "--device=cpu",
                        "--config.train.n_steps=4", "--config.train.log_interval=2",
                        "--config.num_workers=0"])
    assert [m["step"] for m in history] == [2, 4]
    assert (wd / "metrics.jsonl").exists()
    assert "workdir" in (wd / "output.log").read_text()
    with pytest.raises(SystemExit):
        cli.main(["sample"])


def test_trainer_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(tiny(), str(tmp_path))
