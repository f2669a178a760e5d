"""The port's evaluation runner (evaluation/runner.py), its CLI commands and
`Trainer.fit`'s callbacks, on the CPU at synthetic_tiny's size: `evaluate`
end to end with a seeded Inception file and reference stats (the metric keys
of the JAX `evaluate`, the sample2dir names, the mask PNGs and eval.log), the
FID-gated callback (best-only checkpoints), the sample-grid callback, weight
loading, the context stream's threads and `eval` / `sample` through
`cli.main`.  The JAX `evaluate` is not run here (~60 s on a CPU); its parts
are held to the JAX package in test_torch_port_sample_fn.py,
test_torch_port_sampler_io.py and test_torch_port_fid.py.  The FID of 2048
pool3 features takes a 2048 x 2048 `sqrtm` (~20 s on a CPU, more beside
other test workers), so the end-to-end test reads the first 64 features
of the seeded Inception, against 64-d reference stats, as
test_torch_port_fid.py does; the full width runs on the card
(chip_smoke.py phase 20)."""
import os
import threading

import numpy as np
import pytest
import torch

from panopticdiffusionmodels_torch import cli
from panopticdiffusionmodels_torch.configs import get_config
from panopticdiffusionmodels_torch.evaluation import fid, inception, runner
from panopticdiffusionmodels_torch.parallel.mesh import DataParallel
from panopticdiffusionmodels_torch.train import checkpoint as ckpt_lib
from panopticdiffusionmodels_torch.train.trainer import Trainer

JAX_METRIC_KEYS = {"eval_loss_mask", "eval_cnt_mask_diff", "fid"}


def tiny(n_samples=8, batch=4, steps=3, fid_stat=None, **train):
    config = get_config("synthetic_tiny")
    config.sample.update(n_samples=n_samples, mini_batch_size=batch, sample_steps=steps)
    config.train.update(train)
    config.dataset.fid_stat = fid_stat
    config.num_workers = 0
    return config


FEATURES = 64  # see the module docstring


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """A seeded pt_inception-format file and reference stats of 64-d noise."""
    tmp = tmp_path_factory.mktemp("assets")
    path = str(tmp / "pt_inception-2015-12-05.pth")
    sd = {k: torch.from_numpy(v) for k, v in inception.random_state_dict(0).items()}
    sd["fc.weight"] = torch.zeros(1008, 2048)
    torch.save(sd, path)
    acts = np.random.default_rng(0).standard_normal((64, FEATURES))
    stats = str(tmp / "ref.npz")
    fid.save_stats(stats, acts.mean(0), np.cov(acts, rowvar=False))
    return path, stats


def test_evaluate_end_to_end(tmp_path, assets, monkeypatch):
    full = inception.make_extractor
    monkeypatch.setattr(inception, "make_extractor",
                        lambda *a, **k: (lambda x, _f=full(*a, **k): _f(x)[:, :FEATURES]))
    wd = str(tmp_path / "wd")
    metrics = runner.evaluate(tiny(fid_stat=assets[1]), wd, inception_path=assets[0],
                              device="cpu")
    assert set(metrics) == JAX_METRIC_KEYS
    assert all(np.isfinite(v) for v in metrics.values())
    names = {f"{i}.png" for i in range(8)}  # i + 10000 * (written // 4992)
    assert set(os.listdir(os.path.join(wd, "samples"))) == names
    assert set(os.listdir(os.path.join(wd, "mask"))) == names
    log = open(os.path.join(wd, "eval.log")).read()
    assert log.startswith("fid8=") and "eval_loss_mask" in log


def test_unloadable_inception_file_raises(tmp_path, assets):
    bad = tmp_path / "broken.pth"
    torch.save({"Conv2d_1a_3x3.conv.weight": torch.zeros(1)}, bad)
    with pytest.raises(RuntimeError):
        runner.evaluate(tiny(n_samples=4, fid_stat=assets[1]), str(tmp_path / "wd"),
                        inception_path=str(bad), device="cpu")


def test_fid_gated_callback_keeps_only_improving(tmp_path, assets, monkeypatch):
    """The FID values are scripted (a 2048-d `sqrtm` costs seconds a round);
    the sampling, writing and Inception run."""
    fids = iter([5.0, 7.0, 3.0])
    monkeypatch.setattr(runner, "fid_given_paths", lambda *a, **k: next(fids))
    trainer = Trainer(tiny(n_samples=4, steps=2, fid_stat=assets[1]), str(tmp_path / "wd"),
                      device="cpu")
    cb = runner.make_fid_gated_callback(inception_path=assets[0])
    for step in (1, 2, 3):
        trainer.state.step = step
        metrics = cb(trainer, step)
        assert metrics["fid"] == [5.0, 7.0, 3.0][step - 1]
    assert sorted(os.listdir(trainer.ckpt_root)) == ["1.ckpt", "3.ckpt"]


def test_fid_gated_callback_without_assets_saves_every_time(tmp_path):
    trainer = Trainer(tiny(), str(tmp_path / "wd"), device="cpu")
    trainer.state.step = 1
    assert runner.make_fid_gated_callback()(trainer, 1) == {}
    assert os.listdir(trainer.ckpt_root) == ["1.ckpt"]


@pytest.mark.parametrize("name", ["synthetic_tiny", "synthetic_tiny_cond"])
def test_vis_callback_writes_grids(tmp_path, name):
    config = get_config(name)
    config.num_workers = 0
    trainer = Trainer(config, str(tmp_path / "wd"), device="cpu")
    runner.make_vis_callback(n_images=4, sample_steps=2)(trainer, 7)
    written = sorted(os.listdir(os.path.join(trainer.workdir, "train_samples")))
    assert written == (["7.png", "7_mask.png"] if name == "synthetic_tiny" else ["7.png"])


def test_ranks_past_0_sample_nothing_under_plain_data_parallelism(tmp_path, assets,
                                                                  monkeypatch):
    """Under plain data parallelism the sampler has no collectives, so rank
    1 of two builds no sampler in either callback and writes nothing; it
    still takes rank 0's FID (None here) and enters the checkpoint."""
    trainer = Trainer(tiny(fid_stat=assets[1]), str(tmp_path / "wd"), device="cpu")
    trainer.dp, trainer.is_main = DataParallel(2, 1), False
    monkeypatch.setattr(runner, "_agree", lambda t, value: value)
    monkeypatch.setattr(trainer, "build_sample_fn", lambda *a, **k: pytest.fail("sampled"))
    monkeypatch.setattr(runner, "make_eval_sample_fn", lambda *a, **k: pytest.fail("sampled"))
    saved = []
    monkeypatch.setattr(trainer, "save_checkpoint", lambda: saved.append(True))
    trainer.state.step = 1
    runner.make_vis_callback(n_images=4, sample_steps=2)(trainer, 1)
    assert runner.make_fid_gated_callback(inception_path=assets[0])(trainer, 1) == {}
    assert saved == [True]
    assert not (tmp_path / "wd" / "train_samples").exists()
    assert not (tmp_path / "wd" / "samples").exists()


def test_fit_runs_the_callbacks_at_their_intervals(tmp_path):
    trainer = Trainer(tiny(n_steps=4, log_interval=2, eval_interval=2, save_interval=3),
                      str(tmp_path / "wd"), device="cpu")
    calls = []
    trainer.fit(eval_callback=lambda t, s: calls.append(("eval", s)),
                vis_callback=lambda t, s: calls.append(("vis", s)))
    assert calls == [("vis", 2), ("eval", 3), ("vis", 4)]
    assert not os.listdir(trainer.ckpt_root)  # the eval callback owns the checkpoint


def test_eval_sample_fn_labels_and_indices(tmp_path):
    config = get_config("synthetic_tiny_cond")
    config.num_workers = 0
    trainer = Trainer(config, str(tmp_path / "wd"), device="cpu")
    sample_fn, panoptic = runner.make_eval_sample_fn(trainer, 2, 4)
    assert not panoptic and runner._n_real_classes(config) == 10
    idx, samples = sample_fn(4)
    idx2, _ = sample_fn(4)
    np.testing.assert_array_equal(idx, np.arange(4))
    np.testing.assert_array_equal(idx2, np.arange(4, 8))
    assert samples.shape == (4, 8, 8, 4) and torch.isfinite(samples).all()


def test_context_stream_is_cyclic_and_closes_its_threads(tmp_path):
    trainer = Trainer(tiny(), str(tmp_path / "wd"), device="cpu")
    before = threading.active_count()
    stream = runner._context_stream(trainer, 40)  # the test split holds 64
    first, second = next(stream), next(stream)
    assert first[0].shape[0] == second[0].shape[0] == 40
    np.testing.assert_array_equal(second[1][24:], first[1][:16])  # wrapped around
    stream.close()
    for _ in range(50):
        if threading.active_count() <= before:
            break
        threading.Event().wait(0.05)
    assert threading.active_count() <= before


def test_load_weights(tmp_path):
    config = tiny()
    trainer = Trainer(config, str(tmp_path / "wd"), device="cpu")
    sd = {k: torch.full_like(v, 0.5) for k, v in trainer.nnet.state_dict().items()}
    sd["zero_convs.0.conv.weight"] = torch.zeros(1)  # an even zero conv the port drops
    torch.save(sd, tmp_path / "nnet_ema.pth")
    config.nnet_path = str(tmp_path / "nnet_ema.pth")
    runner._load_weights(trainer, config)
    assert all(torch.equal(e, torch.full_like(e, 0.5)) for e in trainer.state.ema.values())
    torch.save({"unrelated.weight": torch.zeros(3)}, tmp_path / "other.pth")
    config.nnet_path = str(tmp_path / "other.pth")
    with pytest.raises(ValueError, match="ZERO"):
        runner._load_weights(trainer, config)
    trainer.state.step = 2
    ckpt_lib.save_checkpoint(str(tmp_path / "ck"), trainer.state)
    fresh = Trainer(config, str(tmp_path / "wd2"), device="cpu")
    config.nnet_path = str(tmp_path / "ck" / "2.ckpt")
    runner._load_weights(fresh, config)
    assert fresh.state.step == 2


def test_cli_eval_and_sample(tmp_path):
    """`eval` / `sample` through cli.main; no FID assets at the default paths,
    so the metrics carry no `fid` (the JAX rule)."""
    common = ["--config=synthetic_tiny", "--device=cpu", "--config.num_workers=0",
              "--config.sample.sample_steps=2", "--config.sample.mini_batch_size=3"]
    metrics = cli.main(["eval", f"--workdir={tmp_path / 'e'}", "--config.sample.n_samples=5",
                        *common])
    assert set(metrics) == {"eval_loss_mask", "eval_cnt_mask_diff"}
    assert len(os.listdir(tmp_path / "e" / "samples")) == 5
    assert "workdir" in (tmp_path / "e" / "output.log").read_text()
    cli.main(["sample", f"--workdir={tmp_path / 's'}", *common])
    assert sorted(os.listdir(tmp_path / "s" / "samples")) == ["0.png", "1.png", "2.png"]


def test_cli_train_under_sp_checkpoints_without_sampling(tmp_path):
    """`train` at mesh.sp = 2 in process samples under sp: its vis
    callback writes a grid every eval_interval, and the FID-gated callback
    (FID assets missing) checkpoints at every save_interval."""
    wd = tmp_path / "sp"
    history = cli.main(["train", "--config=synthetic_tiny", "--device=cpu", f"--workdir={wd}",
                        "--config.num_workers=0", "--config.mesh.sp=2",
                        "--config.mesh.sp_mode=in_process", "--config.train.n_steps=2",
                        "--config.train.log_interval=1", "--config.train.eval_interval=1",
                        "--config.train.save_interval=1"])
    assert [m["step"] for m in history] == [1, 2]
    assert sorted(os.listdir(wd / "ckpts")) == ["1.ckpt", "2.ckpt"]
    assert sorted(os.listdir(wd / "train_samples")) == ["1.png", "1_mask.png", "2.png",
                                                         "2_mask.png"]


def test_entry_points_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        runner.evaluate(tiny(), str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        runner.sample_only(tiny(), str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["eval", "--config=synthetic_tiny", f"--workdir={tmp_path}"])
