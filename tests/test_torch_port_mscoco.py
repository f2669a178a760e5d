"""The port's raw MS-COCO database (`data/mscoco.py`) against the JAX
package's, exactly, on a tiny COCO tree written by the test (PNG images of
mixed sizes, panoptic PNGs with several segments, an image with six
captions, one with two, one with none, one without a panoptic annotation);
and `MSCOCO256Features.contexts`, read from `run_vis/`, against JAX's."""
import os

import numpy as np
import pytest
from PIL import Image

from panopticdiffusionmodels_tpu.data import datasets as jax_datasets
from panopticdiffusionmodels_tpu.data import mscoco as jax_mscoco
from panopticdiffusionmodels_torch.data import datasets, mscoco
from torch_port_coco_common import IMAGE_IDS, write_coco_tree, write_feature_dir


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    return write_coco_tree(tmp_path_factory.mktemp("coco"))


def databases(root, split="train2017", size=16):
    ann = os.path.join(root, "annotations")
    kw = dict(root=os.path.join(root, split), ann_file=os.path.join(ann, f"captions_{split}.json"),
              panoptic_ann_file=os.path.join(ann, f"panoptic_{split}.json"),
              panoptic_root=os.path.join(ann, f"panoptic_{split}"), size=size)
    return mscoco.MSCOCODatabase(**kw), jax_mscoco.MSCOCODatabase(**kw)


def test_rgb2id_matches_jax():
    color = np.random.default_rng(0).integers(0, 256, (5, 7, 3), dtype=np.uint8)
    got, want = mscoco.rgb2id(color), jax_mscoco.rgb2id(color)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert got[0, 0] == int(color[0, 0, 0]) + 256 * int(color[0, 0, 1]) + 65536 * int(color[0, 0, 2])


@pytest.mark.parametrize("nearest", [False, True])
@pytest.mark.parametrize("wh", [(40, 30), (24, 36), (17, 17)])
def test_center_crop_resize_matches_jax(wh, nearest):
    img = Image.fromarray(np.random.default_rng(1).integers(0, 256, (wh[1], wh[0], 3),
                                                           dtype=np.uint8))
    got = np.asarray(mscoco.center_crop_resize(img, 12, nearest=nearest))
    assert got.shape == (12, 12, 3)
    assert np.array_equal(got, np.asarray(jax_mscoco.center_crop_resize(img, 12, nearest=nearest)))


@pytest.mark.parametrize("size", [16, 24])
def test_every_item_matches_jax(coco, size):
    ours, ref = databases(coco, size=size)
    assert len(ours) == len(ref) == len(IMAGE_IDS)
    assert [ours.image_id(i) for i in range(len(ours))] == sorted(IMAGE_IDS)
    n_seg = 0
    for i in range(len(ours)):
        (img, caps, seg), (jimg, jcaps, jseg) = ours[i], ref[i]
        assert img.dtype == jimg.dtype == np.float32 and img.shape == (size, size, 3)
        assert np.array_equal(img, jimg)
        assert caps == jcaps and len(caps) == 5
        assert (seg is None) == (jseg is None)
        if seg is not None:
            n_seg += 1
            assert seg.dtype == jseg.dtype == np.int32 and np.array_equal(seg, jseg)
            assert len(np.unique(seg)) >= 3, "several segments survive the resize"
    assert n_seg == len(IMAGE_IDS) - 1
    assert ours[ours.keys.index(25)][1][2:] == [ours[ours.keys.index(25)][1][1]] * 3
    assert ours[ours.keys.index(14)][1] == [""] * 5


def test_without_panoptic_files_the_map_is_none(coco, tmp_path):
    ann = os.path.join(coco, "annotations")
    kw = dict(root=os.path.join(coco, "train2017"),
              ann_file=os.path.join(ann, "captions_train2017.json"), size=8)
    ours, ref = mscoco.MSCOCODatabase(**kw), jax_mscoco.MSCOCODatabase(**kw)
    for i in range(len(ours)):
        assert ours[i][2] is None and ref[i][2] is None
        assert np.array_equal(ours[i][0], ref[i][0])


@pytest.mark.parametrize("with_vis", [True, False], ids=["run_vis", "no_run_vis"])
def test_mscoco256_features_reads_run_vis_as_jax(tmp_path, with_vis):
    for split in ("train", "val"):
        write_feature_dir(tmp_path / split, n=2, seg=64)
    np.save(tmp_path / "empty_context.npy", np.zeros((7, 12), np.float32))
    if with_vis:
        (tmp_path / "run_vis").mkdir()
        rng = np.random.default_rng(3)
        for i in (0, 1, 2, 10, 11):  # name order: 0, 1, 10, 11, 2
            np.save(tmp_path / "run_vis" / f"{i}.npy", rng.normal(size=(7, 12)).astype(np.float32))
    ours = datasets.MSCOCO256Features(str(tmp_path), mask_size=16)
    ref = jax_datasets.MSCOCO256Features(str(tmp_path), mask_size=16)
    if with_vis:
        assert ours.contexts.shape == (5, 7, 12)
        assert np.array_equal(ours.contexts, ref.contexts)
        assert np.array_equal(ours.contexts[2], np.load(tmp_path / "run_vis" / "10.npy"))
    else:
        assert ours.contexts is None and ref.contexts is None
