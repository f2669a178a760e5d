"""The port's sample writer (evaluation/sampler_io.py) against the JAX
package's: the same sample_fn outputs through both `sample2dir`s give the
same file names, the same pixels (PNG files compared byte for byte after
decoding) and the same metrics dict, with the overlap on and off; outputs
may be tensors (the port's sampler hands over tensors on its device)."""
import os

import numpy as np
import pytest
import torch
from PIL import Image

from panopticdiffusionmodels_tpu.evaluation import sampler_io as jax_io
from panopticdiffusionmodels_torch.evaluation import sampler_io

BATCH, BITS, HW = 4, 8, 8


def outputs(seed):
    """Three batches of (indices, images in [-1, 1], analog-bit masks, loss,
    panoptic); the last batch has no ground truth (NaN loss, no panoptic)."""
    rng = np.random.default_rng(seed)
    out = []
    for b in range(3):
        idx = np.arange(b * BATCH, (b + 1) * BATCH)
        images = rng.uniform(-1.2, 1.2, (BATCH, HW, HW, 3)).astype(np.float32)
        bits = rng.standard_normal((BATCH, HW, HW, BITS)).astype(np.float32)
        panoptic = rng.integers(0, 201, (BATCH, HW, HW, 1)).astype(np.int32)
        loss = np.float32(rng.uniform())
        if b == 2:
            loss, panoptic = np.nan, None
        out.append((idx, images, bits, loss, panoptic))
    return out


def replay(batches, as_tensors=False):
    it = iter(batches)

    def sample_fn(n):
        assert n == BATCH
        idx, images, bits, loss, panoptic = next(it)
        if as_tensors:
            images, bits = torch.from_numpy(images), torch.from_numpy(bits)
        return idx, images, bits, loss, panoptic

    return sample_fn


def read_dir(path):
    return {n: np.asarray(Image.open(os.path.join(path, n))) for n in sorted(os.listdir(path))}


def run(io, tmp, tag, batches, **kw):
    path, mask = os.path.join(tmp, tag, "samples"), os.path.join(tmp, tag, "mask")
    metrics = io.sample2dir(path, 10, BATCH, replay(batches, kw.pop("as_tensors", False)),
                            unpreprocess_fn=lambda v: np.clip(0.5 * (v + 1.0), 0.0, 1.0),
                            use_panoptic=True, mask_path=mask, mask_bits=BITS, **kw)
    return metrics, read_dir(path), read_dir(mask)


@pytest.mark.parametrize("overlap", [True, False])
def test_sample2dir_matches_jax(tmp_path, monkeypatch, overlap):
    monkeypatch.chdir(tmp_path)  # both packages persist colormap.npy here
    batches = outputs(0)
    ref = run(jax_io, str(tmp_path), "jax", batches, overlap=True)
    ours = run(sampler_io, str(tmp_path), "port", batches, overlap=overlap,
               as_tensors=overlap)
    assert ours[0] == ref[0] and set(ref[0]) == {"eval_loss_mask", "eval_cnt_mask_diff"}
    for got, want in zip(ours[1:], ref[1:]):
        assert list(got) == list(want) == [f"{i}.png" for i in sorted(range(10), key=str)]
        for name in want:
            np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_names_advance_by_bucket(tmp_path):
    """Past 4992 written samples the names move to the next 10000 block:
    `idx + 10000 * (written // 4992)` (1 x 1 images, no masks)."""
    counter = {"n": 0}

    def sample_fn(n):
        idx = np.arange(counter["n"], counter["n"] + n) % 4992
        counter["n"] += n
        return idx, np.zeros((n, 1, 1, 3), np.float32)

    sampler_io.sample2dir(str(tmp_path), 5000, 2500, sample_fn)
    names = set(os.listdir(tmp_path))
    assert names == {f"{i}.png" for i in range(4992)} | {f"{10000 + i}.png" for i in range(8)}


def test_grid_matches_jax(tmp_path):
    images = np.random.default_rng(1).uniform(size=(5, 6, 6, 3)).astype(np.float32)
    np.testing.assert_array_equal(sampler_io.make_grid(images, ncol=2),
                                  jax_io.make_grid(images, ncol=2))
    sampler_io.save_grid(images, str(tmp_path / "port.png"), ncol=3)
    jax_io.save_grid(images, str(tmp_path / "jax.png"), ncol=3)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "port.png")),
                                  np.asarray(Image.open(tmp_path / "jax.png")))
