"""FID, KID and the mask metrics of the port (evaluation/fid.py, kid.py,
mask_metrics.py) against the JAX package's on the same numpy inputs.

Pure numpy / scipy functions are held to rtol 1e-10 (the same float64
operations in the same order); `dir_statistics` overlapped against
`workers=0` exactly; `fid_given_paths` with the port's extractor against
JAX's on carried weights at rtol 1e-4 (f32 features).  The FID of two image
directories takes a 2048 x 2048 `sqrtm` per side (over ten seconds each on
a CPU), so that comparison reads the first 64 pool3 features through each
package's extractor; the full features are held in
test_torch_port_inception.py."""
import importlib

import numpy as np
import pytest
from PIL import Image

from panopticdiffusionmodels_tpu.evaluation import fid as jax_fid
from panopticdiffusionmodels_tpu.evaluation import inception as jax_inception
from panopticdiffusionmodels_tpu.evaluation import mask_metrics as jax_mm
from panopticdiffusionmodels_torch.evaluation import fid, inception, kid, mask_metrics
from panopticdiffusionmodels_torch.utils.misc import amortize

# the JAX package's evaluation/__init__ exports the function `kid` over its module
jax_kid = importlib.import_module("panopticdiffusionmodels_tpu.evaluation.kid")

EXACT = 1e-10


def stats(seed, n=40, d=16):
    acts = np.random.default_rng(seed).standard_normal((n, d))
    return fid.compute_statistics(acts)


def test_compute_statistics_and_frechet_distance():
    acts = np.random.default_rng(0).standard_normal((40, 16))
    for a, b in zip(fid.compute_statistics(acts), jax_fid.compute_statistics(acts)):
        np.testing.assert_allclose(a, b, rtol=EXACT)
    (m1, s1), (m2, s2) = stats(1), stats(2)
    np.testing.assert_allclose(fid.frechet_distance(m1, s1, m2, s2),
                               jax_fid.frechet_distance(m1, s1, m2, s2), rtol=EXACT)
    assert fid.frechet_distance(m1, s1, m1, s1) == pytest.approx(0.0, abs=1e-6)
    # singular covariances (fewer samples than dimensions): the eps retry
    (m3, s3), (m4, s4) = stats(3, n=5), stats(4, n=5)
    np.testing.assert_allclose(fid.frechet_distance(m3, s3, m4, s4),
                               jax_fid.frechet_distance(m3, s3, m4, s4), rtol=1e-8)
    with pytest.raises(ValueError, match="shape"):
        fid.frechet_distance(m1, s1, m1[:8], s1[:8, :8])


def test_stats_files_round_trip_between_packages(tmp_path):
    mu, sigma = stats(5)
    fid.save_stats(str(tmp_path / "port.npz"), mu, sigma)
    jax_fid.save_stats(str(tmp_path / "jax.npz"), mu, sigma)
    for ours, theirs in ((fid.load_stats(str(tmp_path / "jax.npz")), (mu, sigma)),
                         (jax_fid.load_stats(str(tmp_path / "port.npz")), (mu, sigma))):
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a, b)
    other = stats(6)
    np.testing.assert_allclose(fid.fid_from_stats(str(tmp_path / "jax.npz"), other),
                               jax_fid.fid_from_stats(str(tmp_path / "port.npz"), other),
                               rtol=EXACT)


@pytest.mark.parametrize("exclude_matched", [False, True])
def test_kid_matches_jax(exclude_matched):
    rng = np.random.default_rng(7)
    a, b = rng.standard_normal((30, 24)), rng.standard_normal((30, 24)) + 0.1
    k = kid.polynomial_kernel(a, b)
    np.testing.assert_allclose(k, jax_kid.polynomial_kernel(a, b), rtol=EXACT)
    kxx, kyy = kid.polynomial_kernel(a, a), kid.polynomial_kernel(b, b)
    np.testing.assert_allclose(
        kid.mmd2_unbiased(kxx, kyy, k, exclude_matched=exclude_matched),
        jax_kid.mmd2_unbiased(kxx, kyy, k, exclude_matched=exclude_matched), rtol=EXACT)
    ours = kid.kid(a, b, subset_size=10, n_subsets=20, seed=3, exclude_matched=exclude_matched)
    ref = jax_kid.kid(a, b, subset_size=10, n_subsets=20, seed=3,
                      exclude_matched=exclude_matched)
    np.testing.assert_allclose(ours, ref, rtol=EXACT)


def test_kid_checks():
    a = np.zeros((4, 3))
    with pytest.raises(ValueError, match="subset_size"):
        kid.kid(a, a, subset_size=1)
    with pytest.raises(ValueError, match="equally sized"):
        kid.kid(a, np.zeros((5, 3)), exclude_matched=True)
    with pytest.raises(ValueError, match="equally sized"):
        kid.mmd2_unbiased(np.eye(2), np.eye(2), np.ones((2, 3)), exclude_matched=True)


def test_mask_metrics_match_jax(tmp_path, monkeypatch):
    rng = np.random.default_rng(8)
    pred = rng.integers(-2, 260, size=(3, 16, 16, 1))
    gt = rng.integers(0, 201, size=(3, 16, 16, 1))
    assert mask_metrics.eval_mask_cnt(pred, gt) == jax_mm.eval_mask_cnt(pred, gt)
    monkeypatch.chdir(tmp_path)  # get_colormap persists colormap.npy in the working directory
    cmap = mask_metrics.get_colormap()
    np.testing.assert_array_equal(cmap, jax_mm.get_colormap(force=True))
    np.testing.assert_array_equal(mask_metrics.color_map(pred, cmap),
                                  jax_mm.color_map(pred, cmap))
    ids = pred[0, ..., 0]
    np.testing.assert_array_equal(mask_metrics.category2rgb(ids, "missing.json"),
                                  jax_mm.category2rgb(ids, "missing.json"))
    assert amortize(10, 4) == [4, 4, 2] and amortize(8, 4) == [4, 4]


@pytest.fixture(scope="module")
def extractors():
    params = jax_inception.random_params(0)
    model = inception.from_state_dict(inception.inception_state_dict(params))
    ours = inception.make_extractor(model, device="cpu")
    theirs = jax_inception.make_extractor(params)
    return ours, theirs


def write_pngs(path, seed, n, hw=24):
    path.mkdir()
    imgs = np.random.default_rng(seed).integers(0, 256, size=(n, hw, hw, 3), dtype=np.uint8)
    for i, img in enumerate(imgs):
        Image.fromarray(img).save(path / f"{i}.png")
    return str(path)


def test_dir_statistics_overlap_is_exact(tmp_path, extractors):
    ours, _ = extractors
    d = write_pngs(tmp_path / "a", 9, 7)
    calls = []

    def counted(x):
        calls.append(len(x))
        return ours(x)

    seq = fid.dir_statistics(d, counted, batch_size=3, workers=0)
    over = fid.dir_statistics(d, counted, batch_size=3, workers=4)
    assert calls == [3, 3, 1, 3, 3, 1]
    for a, b in zip(seq, over):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="no images"):
        fid.dir_statistics(str(tmp_path), ours)


def test_fid_given_paths_matches_jax(tmp_path, extractors):
    ours, theirs = extractors
    a, b = write_pngs(tmp_path / "a", 10, 6), write_pngs(tmp_path / "b", 11, 5)
    first = 64  # see the module docstring
    port = fid.fid_given_paths(a, b, lambda x: ours(x)[:, :first], batch_size=4)
    ref = jax_fid.fid_given_paths(a, b, lambda x: np.asarray(theirs(x))[:, :first],
                                  batch_size=4)
    np.testing.assert_allclose(port, ref, rtol=1e-4)
    mu, sigma = fid.dir_statistics(a, lambda x: ours(x)[:, :first])
    fid.save_stats(str(tmp_path / "a.npz"), mu, sigma)
    np.testing.assert_allclose(
        fid.fid_given_paths(str(tmp_path / "a.npz"), b, lambda x: ours(x)[:, :first]), port,
        rtol=1e-10)
    samples = np.stack([np.asarray(Image.open(f"{b}/{i}.png"), np.float32) / 255.0
                        for i in range(5)])
    np.testing.assert_allclose(
        fid.fid_given_samples(samples, str(tmp_path / "a.npz"), lambda x: ours(x)[:, :first],
                              batch_size=2), port, rtol=1e-6)
