"""The port's ImageNet feature datasets and labelled synthetic data against the
JAX package's.

`FeatureDataset` reads `.npy` files this test writes in the reference's
format (each a pickled (moments CHW f32, label) pair); both packages must
return the same (moments HWC, label).  `CFGLabelDataset` keeps the JAX rule
(the label becomes the null class 1000 where a uniform draw is < p_uncond)
but draws from a `random.Random` seeded by (loader seed, epoch, item) instead
of the global `random` module, so the two packages are made to agree at
p_uncond 0 and 1, where the rule does not depend on the draw; at 0.15 the
port's dropout must be reproducible from the loader's seed (whatever the
thread count, and after a resume's `skip`) and drop about 15 %.
`Synthetic(style='imagenet' | 'pixels')` must give the JAX arrays for the
same seed.
"""
import numpy as np
import pytest

from panopticdiffusionmodels_tpu.data.datasets import FeatureDataset as JaxFeatureDataset
from panopticdiffusionmodels_tpu.data.datasets import ImageNetFeatures as JaxImageNetFeatures
from panopticdiffusionmodels_tpu.data.datasets import Synthetic as JaxSynthetic
from panopticdiffusionmodels_torch.data import Loader, get_dataset
from panopticdiffusionmodels_torch.data.datasets import (
    CFGLabelDataset,
    FeatureDataset,
    ImageNetFeatures,
    Synthetic,
    SyntheticLabeled,
)

N_FILES = 6


def _write(path, n=N_FILES, hw=4):
    rng = np.random.default_rng(0)
    for i in range(n):
        z = rng.standard_normal((8, hw, hw)).astype(np.float32)
        pair = np.empty(2, dtype=object)
        pair[0], pair[1] = z, int(rng.integers(0, 1000))
        np.save(path / f"{i}.npy", pair, allow_pickle=True)
    return path


def _assert_items_equal(a, b):
    assert len(a) == len(b) == 2
    np.testing.assert_array_equal(a[0], b[0])
    assert a[0].dtype == b[0].dtype == np.float32 and a[0].flags.c_contiguous
    assert a[1] == b[1] and isinstance(a[1], int)


def test_feature_dataset_equals_jax(tmp_path):
    _write(tmp_path)
    ours, ref = FeatureDataset(str(tmp_path)), JaxFeatureDataset(str(tmp_path))
    assert len(ours) == len(ref) == N_FILES
    for i in range(N_FILES):
        _assert_items_equal(ours[i], ref[i])
    z, label = ours[2]
    want = np.load(tmp_path / "2.npy", allow_pickle=True)
    np.testing.assert_array_equal(z, want[0].transpose(1, 2, 0))
    assert z.shape == (4, 4, 8) and label == want[1]


@pytest.mark.parametrize("name,res", [("imagenet256_features", 256),
                                      ("imagenet512_features", 512)])
@pytest.mark.parametrize("p_uncond", [0.0, 1.0])
def test_imagenet_factory_equals_jax(tmp_path, name, res, p_uncond):
    _write(tmp_path)
    ours = get_dataset(name, path=str(tmp_path), cfg=True, p_uncond=p_uncond)
    ref = JaxImageNetFeatures(str(tmp_path), cfg=True, p_uncond=p_uncond, resolution=res)
    assert isinstance(ours, ImageNetFeatures) and ours.resolution == ref.resolution == res
    train = ours.get_split("train")
    assert isinstance(train, CFGLabelDataset) and train.null_label == 1000
    for i in range(N_FILES):
        _assert_items_equal(train[i], ref.get_split("train", labeled=True)[i])
        _assert_items_equal(ours.get_split("test")[i], ref.get_split("test", labeled=True)[i])
    if p_uncond == 1.0:
        assert {train[i][1] for i in range(N_FILES)} == {1000}


def test_imagenet_cfg_needs_p_uncond(tmp_path):
    _write(tmp_path)
    with pytest.raises(ValueError, match="p_uncond"):
        get_dataset("imagenet256_features", path=str(tmp_path), cfg=True)
    plain = get_dataset("imagenet256_features", path=str(tmp_path))
    assert isinstance(plain.get_split("train"), FeatureDataset)


def _labels(loader, n_batches):
    it = iter(loader)
    return [next(it)[1].tolist() for _ in range(n_batches)]


def test_label_dropout_is_reproducible_from_the_loader_seed():
    base = SyntheticLabeled((2, 2, 2), n=400, num_classes=1000, seed=1)
    ds = CFGLabelDataset(base, 0.15, 1000)
    runs = {}
    for workers in (0, 4):
        runs[workers] = _labels(Loader(ds, 40, num_workers=workers, seed=7), 25)
    assert runs[0] == runs[4]  # 25 batches of 40 = 2.5 epochs, any thread order
    dropped = np.mean(np.array(runs[0]) == 1000)
    assert 0.12 < dropped < 0.18, dropped
    other = _labels(Loader(ds, 40, num_workers=0, seed=8), 25)
    assert other != runs[0]
    resumed = Loader(ds, 40, num_workers=2, seed=7)
    resumed.skip(13)  # into the second epoch, as a resume at step 13
    assert _labels(resumed, 12) == runs[0][13:]
    # the rule is JAX's: a uniform draw below p_uncond drops the label
    for p, want in ((0.0, base.y), (1.0, np.full(400, 1000))):
        labels = [CFGLabelDataset(base, p, 1000)[i][1] for i in range(400)]
        np.testing.assert_array_equal(labels, want)


@pytest.mark.parametrize("style", ["imagenet", "pixels"])
def test_labeled_synthetic_equals_jax(style):
    kw = dict(n=12, z_shape=(4, 4, 8), seed=5, style=style, num_classes=11)
    ours, ref = Synthetic(**kw), JaxSynthetic(**kw)
    for i in (0, 5, 11):
        _assert_items_equal(ours.get_split("train")[i], ref.get_split("train", labeled=True)[i])
        assert 0 <= ours.get_split("test")[i][1] < 11
    with pytest.raises(ValueError):
        Synthetic(style="video")
    ds = get_dataset("synthetic", **kw)
    assert isinstance(ds.get_split("train"), SyntheticLabeled) and len(ds.get_split("train")) == 12
