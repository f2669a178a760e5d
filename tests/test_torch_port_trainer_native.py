"""The trainer's native input pipeline (`Trainer._native_stream`) against the
JAX package's (JAX `train/trainer.py:708-777`), as tests/test_trainer_native.py
drives JAX's:

  * on an MS-COCO feature directory the trainer takes the native path
    (`input_pipeline == 'native'`) and trains 3 steps; a second trainer
    resumes from the checkpoint and trains a 4th on the native path (the
    C++ loader cannot fast-forward: the resume folds the step into its
    seed and reads a fresh shuffle);
  * `native_loader=False` takes the Python `Loader`;
  * with one worker thread the stream equals JAX `_native_stream`'s batch
    for batch, bit for bit, at start steps 0 and 5: the loader's seed
    (seed + rank + 1_000_003 * step) and the p_uncond drop to the empty
    context, drawn from `np.random.default_rng(seed + rank + step)`;
  * where several processes load one batch shard (they differ in pp, sp
    or tp alone) the first of them reads it, on the native path, and the
    others read nothing; over four gloo processes at dp = 2 x tp = 2 with
    two loader threads, the tp peers' first three batches are equal, both
    shards' differ, and every rank reports the native pipeline."""
import numpy as np
import pytest
import torch
import torch.distributed as dist

from panopticdiffusionmodels_tpu.configs import get_config as jax_get_config
from panopticdiffusionmodels_tpu.data.datasets import MSCOCO256Features as JaxFeatures
from panopticdiffusionmodels_tpu.train.trainer import Trainer as JaxTrainer
from panopticdiffusionmodels_torch.configs import get_config
from panopticdiffusionmodels_torch.parallel.mesh import DataParallel
from panopticdiffusionmodels_torch.train.trainer import Trainer
import torch_port_mesh_common as mc
from torch_port_coco_common import write_feature_dir


@pytest.fixture(scope="module")
def coco_features(tmp_path_factory):
    root = tmp_path_factory.mktemp("coco_feat")
    for split in ("train", "val"):
        write_feature_dir(root / split, n=16, moments=(8, 8, 8), context=(7, 16), seg=64)
    np.save(root / "empty_context.npy", np.full((7, 16), 0.25, np.float32))
    return str(root)


def configure(config, path, p_uncond=0.5, workers=2):
    config.dataset = type(config.dataset)(dict(name="mscoco256_features", path=path, cfg=True,
                                               p_uncond=p_uncond, mask_size=16))
    config.nnet.mask_size = 16
    config.train.update(batch_size=8, log_interval=1, save_interval=3)
    config.num_workers = workers
    return config


def test_trainer_takes_the_native_path_trains_and_resumes(coco_features, tmp_path):
    config = configure(get_config("synthetic_tiny"), coco_features)
    trainer = Trainer(config, str(tmp_path / "wd"), device="cpu")
    history = trainer.fit(max_steps=3)
    assert trainer.input_pipeline == "native"
    assert trainer.state.step == 3 and all(np.isfinite(m["loss"]) for m in history)
    resumed = Trainer(configure(get_config("synthetic_tiny"), coco_features),
                      str(tmp_path / "wd"), device="cpu")
    more = resumed.fit(max_steps=4)
    assert resumed.input_pipeline == "native" and resumed.state.step == 4
    assert [m["step"] for m in more] == [4] and np.isfinite(more[0]["loss"])


def test_native_loader_false_takes_the_python_loader(coco_features, tmp_path):
    config = configure(get_config("synthetic_tiny"), coco_features)
    config.native_loader = False
    trainer = Trainer(config, str(tmp_path), device="cpu")
    assert trainer._native_stream() is None
    next(trainer.data_stream())
    assert trainer.input_pipeline == "python"


def jax_trainer(path) -> JaxTrainer:
    """A JAX Trainer with only what `_native_stream` reads: the JAX
    constructor initialises the model op by op for ~20 s."""
    jt = JaxTrainer.__new__(JaxTrainer)
    jt.config = configure(jax_get_config("synthetic_tiny"), path, workers=1)
    jt.task = "t2i_discrete"
    jt.dataset = JaxFeatures(path, cfg=True, p_uncond=0.5, mask_size=16)
    return jt


@pytest.mark.parametrize("start_step", [0, 5])
def test_stream_equals_jax_native_stream(coco_features, tmp_path, start_step):
    trainer = Trainer(configure(get_config("synthetic_tiny"), coco_features, workers=1),
                      str(tmp_path), device="cpu")
    ours = trainer._native_stream(start_step)
    ref = jax_trainer(coco_features)._native_stream(start_step=start_step)
    empty = np.full((7, 16), 0.25, np.float32)
    dropped = 0
    for _ in range(5):  # 2 batches an epoch
        got, want = next(ours), next(ref)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        dropped += sum(np.array_equal(c, empty) for c in got[1])
    assert 0 < dropped < 40  # p_uncond 0.5 of 40 rows


def test_sequence_parallel_process_group_takes_the_python_loader(coco_features, tmp_path,
                                                                 monkeypatch):
    """Under 'process_group' sp the peers of a batch shard take what the
    first of them reads: rank 3 of dp = 2 x sp = 2 opens no loader and
    takes rank 2's batch, and the pipeline it came from, over the data
    peers' group."""
    trainer = Trainer(configure(get_config("synthetic_tiny"), coco_features), str(tmp_path),
                      device="cpu")
    trainer.dp = DataParallel(4, 3, dict(dp=2, sp=2))
    assert trainer.dp.data_peers() == [2, 3]
    monkeypatch.setattr(trainer.dp, "group", lambda axis: f"group {axis}")
    monkeypatch.setattr(trainer, "_read_stream", lambda start: pytest.fail("read"))
    sent = ("native", True, [((4, 8, 8, 8), torch.float32), ((4, 16, 16, 1), torch.uint8)])
    calls = []

    def broadcast_object_list(box, src, group):
        calls.append((src, group))
        box[0] = sent

    monkeypatch.setattr(dist, "broadcast_object_list", broadcast_object_list)
    monkeypatch.setattr(dist, "broadcast", lambda t, src, group: calls.append((src, group)))
    batch = next(trainer.data_stream())
    assert [(tuple(t.shape), t.dtype) for t in batch] == [(tuple(s), d) for s, d in sent[2]]
    assert trainer.input_pipeline == "native"
    assert calls == [(2, "group data")] * 3


def test_peers_of_a_batch_shard_train_on_the_same_rows(coco_features, tmp_path):
    spec = dict(config=dict(
        dataset=dict(name="mscoco256_features", path=coco_features, cfg=True, p_uncond=0.5,
                     mask_size=16),
        nnet=dict(mask_size=16), train=dict(batch_size=8), num_workers=2,
        mesh=dict(dp=2, tp=2)), steps=[], stream=3)
    got = mc.finish(tmp_path, "peers", mc.start(tmp_path, "peers", 4, spec))
    assert [g["input_pipeline"] for g in got] == ["native"] * 4
    for a, b in ((0, 1), (2, 3)):  # tp peers: the same rows
        for x, y in zip(got[a]["stream"], got[b]["stream"]):
            assert all(torch.equal(u, v) for u, v in zip(x, y))
    assert not torch.equal(got[0]["stream"][0][0], got[2]["stream"][0][0])
