"""The port's datasets and loader against the JAX package's.

Same seed, same arrays: `Synthetic` (numpy `default_rng`), the
`MSCOCOFeatureDataset` file contract over a directory this test writes, and
the `Loader`'s shuffled batches, also after an index-only `skip(3)`.  The
device feed keeps values and applies the uint8 / bf16 transfer casts.
"""
import random

import numpy as np
import pytest
import torch

from panopticdiffusionmodels_tpu.data.datasets import MSCOCO256Features as JaxCOCO
from panopticdiffusionmodels_tpu.data.datasets import MSCOCOFeatureDataset as JaxFeatures
from panopticdiffusionmodels_tpu.data.datasets import Synthetic as JaxSynthetic
from panopticdiffusionmodels_tpu.data.loader import Loader as JaxLoader
from panopticdiffusionmodels_torch.data import Loader, get_dataset, prefetch_to_device
from panopticdiffusionmodels_torch.data.datasets import (
    MSCOCO256Features,
    MSCOCOFeatureDataset,
    Synthetic,
    min_pool_2d,
)

SYN = dict(n=24, z_shape=(4, 4, 8), clip_shape=(5, 6), mask_size=8, seed=3)


def _assert_batches_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
        assert np.asarray(x).dtype == np.asarray(y).dtype


def test_synthetic_equals_jax():
    ours, ref = Synthetic(**SYN), JaxSynthetic(**SYN)
    for i in (0, 7, 23):
        _assert_batches_equal(ours.get_split("train", labeled=True)[i],
                              ref.get_split("train", labeled=True)[i])
    np.testing.assert_array_equal(ours.empty_context, ref.empty_context)


@pytest.mark.parametrize("skip", [0, 3])
def test_loader_yields_the_jax_batches(skip):
    ds = Synthetic(**SYN).get_split("train", labeled=True)
    ours, ref = Loader(ds, 5, num_workers=2, seed=9), JaxLoader(ds, 5, num_workers=2, seed=9)
    if skip:
        ours.skip(skip)
        ref.skip(skip)
    it_o, it_r = iter(ours), iter(ref)
    for _ in range(9):  # 4 batches per epoch (drop_last): crosses two epoch boundaries
        _assert_batches_equal(next(it_o), next(it_r))


def _write_features(root, n=6, seg=16):
    rng = np.random.default_rng(0)
    for split in ("train", "val"):
        d = root / split
        d.mkdir(parents=True)
        for i in range(n):
            np.save(d / f"{i}.npy", rng.standard_normal((8, 4, 4)).astype(np.float32))
            for k in range(5):
                np.save(d / f"{i}_{k}.npy", rng.standard_normal((7, 16)).astype(np.float32))
            np.save(d / f"{i}_seg.npy", rng.integers(0, 200, (seg, seg)).astype(np.int64))
    np.save(root / "empty_context.npy", np.zeros((7, 16), np.float32))


@pytest.mark.parametrize("deterministic", [True, False])
def test_feature_dataset_equals_jax(tmp_path, deterministic):
    _write_features(tmp_path)
    kw = dict(mask_size=4, deterministic=deterministic)
    ours = MSCOCOFeatureDataset(str(tmp_path / "train"), **kw)
    ref = JaxFeatures(str(tmp_path / "train"), **kw)
    assert ours.indices == ref.indices and ours.has_seg
    for i in range(len(ref)):
        random.seed(i)  # the caption draw uses the random module's state
        a = ours[i]
        random.seed(i)
        _assert_batches_equal(a, ref[i])
    moments, ctx, seg = ours[0]
    assert moments.shape == (4, 4, 8) and ctx.shape == (7, 16) and seg.shape == (4, 4, 1)
    np.testing.assert_array_equal(seg[..., 0], min_pool_2d(
        np.load(tmp_path / "train" / "0_seg.npy"), 4).astype(np.int32))


def test_coco_factory_equals_jax(tmp_path):
    _write_features(tmp_path)
    kw = dict(path=str(tmp_path), cfg=True, p_uncond=1.0, mask_size=4)
    ours, ref = get_dataset("mscoco256_features", **kw), JaxCOCO(**kw)
    assert isinstance(ours, MSCOCO256Features)
    _assert_batches_equal(ours.get_split("train", labeled=True)[2],
                          ref.get_split("train", labeled=True)[2])  # p_uncond=1: empty context
    _assert_batches_equal(ours.get_split("test", labeled=True)[1],
                          ref.get_split("test", labeled=True)[1])


def test_other_datasets_name_their_slice():
    # cifar10, celeba and imagenet are ported (test_torch_port_pixel_data.py);
    # a name neither package has is refused by name, as JAX refuses it.
    with pytest.raises(NotImplementedError, match="mscoco256"):
        get_dataset("mscoco256", path="x")


def test_loader_refuses_a_dataset_smaller_than_a_batch():
    with pytest.raises(ValueError, match="smaller than one batch"):
        Loader(Synthetic(**SYN).get_split("train", labeled=True), 25)


def test_device_feed_casts_and_checks():
    batches = [(np.ones((2, 3), np.float32), np.array([[0, 255]], np.int32))]
    (f, ids), = list(prefetch_to_device(iter(batches), "cpu", cast_f32=torch.bfloat16,
                                        cast_int=np.uint8))
    assert f.dtype == torch.bfloat16 and ids.dtype == torch.uint8
    assert ids.tolist() == [[0, 255]]
    (f, ids), = list(prefetch_to_device(iter(batches), "cpu"))
    assert f.dtype == torch.float32 and ids.dtype == torch.int32
    bad = [(np.array([[256]], np.int32),)]
    with pytest.raises(ValueError, match="exceeds"):
        list(prefetch_to_device(iter(bad), "cpu", cast_int=np.uint8))
