"""The pixel-space datasets of the port (CIFAR-10, CelebA, raw ImageNet)
against the JAX package's classes on fake trees in tmp_path: python-pickle
CIFAR batches of 5 x 10,000 training and 1,000 test images, and JPEG trees
written with PIL.  Items must be equal exactly (the same numpy and PIL
operations on both sides), flips included when both draw from the same
state of the `random` module."""
import pickle
import random

import numpy as np
import pytest
from PIL import Image

from panopticdiffusionmodels_tpu.data import datasets as jds
from panopticdiffusionmodels_torch.data import Loader, get_dataset
from panopticdiffusionmodels_torch.data import datasets as ds


@pytest.fixture(scope="module")
def cifar_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("cifar")
    batches = root / "cifar-10-batches-py"
    batches.mkdir()
    rng = np.random.default_rng(0)
    for name, n in [(f"data_batch_{i}", 10000) for i in range(1, 6)] + [("test_batch", 1000)]:
        data = {b"data": rng.integers(0, 256, (n, 3072), dtype=np.int64).astype(np.uint8),
                b"labels": rng.integers(0, 10, n).tolist()}
        with open(batches / name, "wb") as f:
            pickle.dump(data, f)
    return str(root)


def _same(a, b):
    if isinstance(b, tuple):
        assert isinstance(a, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
        return
    assert type(a) is type(b) or (isinstance(a, np.ndarray) and isinstance(b, np.ndarray))
    if isinstance(b, np.ndarray):
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _same_items(ours, ref, items, flip_seed=None):
    for i in items:
        if flip_seed is not None:
            random.seed(flip_seed + i)
        a = ours[i]
        if flip_seed is not None:
            random.seed(flip_seed + i)
        _same(a, ref[i])


def test_cifar10_matches_jax(cifar_root):
    ours, ref = get_dataset("cifar10", path=cifar_root), jds.CIFAR10(cifar_root)
    assert isinstance(ours, ds.CIFAR10) and len(ours.train) == 50000 and len(ours.test) == 1000
    _same_items(ours.get_split("train", labeled=True), ref.get_split("train", labeled=True),
                [0, 9999, 49999])
    _same_items(ours.get_split("test", labeled=True), ref.get_split("test", labeled=True), [0, 999])
    _same_items(ours.get_split("train"), ref.get_split("train"), [3])  # both default to bare images
    img = ours.train[0][0]
    assert img.shape == (32, 32, 3) and -1.0 <= img.min() and img.max() <= 1.0
    np.testing.assert_array_equal(ours.unpreprocess(img), ref.unpreprocess(img))
    assert ours.has_label and ref.has_label


def test_cifar10_flip_and_cfg_match_jax(cifar_root):
    ours = get_dataset("cifar10", path=cifar_root, random_flip=True)
    ref = jds.CIFAR10(cifar_root, random_flip=True)
    _same_items(ours.train, ref.train, range(8), flip_seed=100)
    flipped = [not np.array_equal(ours.train.images[i].astype(np.float32) / 127.5 - 1.0,
                                  (random.seed(100 + i), ours.train[i][0])[1]) for i in range(8)]
    assert any(flipped) and not all(flipped)
    # cfg: every label becomes the null class 10 at p_uncond 1, none at 0
    for p, want in ((1.0, {10}), (0.0, None)):
        cfg = get_dataset("cifar10", path=cifar_root, cfg=True, p_uncond=p)
        jcfg = jds.CIFAR10(cifar_root, cfg=True, p_uncond=p)
        labels = {cfg.train[i][1] for i in range(20)}
        assert labels == (want or {jcfg.train[i][1] for i in range(20)})
    with pytest.raises(ValueError, match="p_uncond"):
        get_dataset("cifar10", path=cifar_root, cfg=True)


def _jpeg_tree(root, names_sizes):
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(len(names_sizes))
    for name, (w, h) in names_sizes:
        arr = rng.integers(0, 256, (h, w, 3), dtype=np.int64).astype(np.uint8)
        Image.fromarray(arr).save(root / name, quality=90)


def test_celeba_matches_jax(tmp_path):
    _jpeg_tree(tmp_path / "img_align_celeba",
               [(f"{i:06d}.jpg", (178, 218)) for i in range(1, 7)] + [("000007.png", (70, 64))])
    ours, ref = get_dataset("celeba", path=str(tmp_path)), jds.CelebA(str(tmp_path))
    assert not ours.has_label and not ref.has_label
    assert len(ours.train) == len(ref.train) == 7
    _same_items(ours.train, ref.train, range(7), flip_seed=7)
    _same_items(ours.test, ref.test, range(7))
    assert ours.get_split("train") is ours.train  # nothing to strip
    assert ours.train[0].shape == (64, 64, 3)


def test_imagenet_raw_matches_jax(tmp_path):
    for c, cls in enumerate(["n01440764", "n01443537", "n01484850"]):
        _jpeg_tree(tmp_path / "imagenet" / "train" / cls,
                   [(f"{cls}_{j}.JPEG", (80 + 10 * j, 70 + c)) for j in range(3)])
    path = str(tmp_path / "imagenet")
    ours = get_dataset("imagenet", path=path, resolution=32)
    ref = jds.ImageNetRaw(path, resolution=32)
    assert ours.class_to_idx == ref.class_to_idx and len(ours.train) == 9
    _same_items(ours.train, ref.train, range(9), flip_seed=3)
    _same_items(ours.test, ref.test, range(9))
    assert [ours.train[i][1] for i in range(9)] == [0, 0, 0, 1, 1, 1, 2, 2, 2]
    assert ours.train[0][0].shape == (32, 32, 3)
    null = get_dataset("imagenet", path=path, resolution=32, cfg=True, p_uncond=1.0)
    assert {null.train[i][1] for i in range(9)} == {3}  # the null class: the class count


def test_pixel_batches_through_the_loader(cifar_root):
    """The loader stacks (image, label) items to NHWC f32 and int64 batches."""
    train = get_dataset("cifar10", path=cifar_root).get_split("train", labeled=True)
    x, y = next(iter(Loader(train, batch_size=4, num_workers=0, seed=0)))
    assert x.shape == (4, 32, 32, 3) and x.dtype == np.float32 and y.shape == (4,)
