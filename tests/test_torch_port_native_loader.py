"""The port's native feature loader (`data/native_loader.py` on its own copy
of the C++ source, built into build/torch_native/) against the JAX
package's (`data/native_loader.py` on `native/libfastloader.so`):

  * one worker thread: the same batches, bit for bit, for several batches
    across epoch boundaries, with and without shuffle, with and without seg;
  * several threads: every row is one source sample after the CHW -> HWC
    transpose and the min-pool (as tests/test_native_loader.py checks);
  * two processes' subsets are disjoint and each takes half the batch;
  * a corrupt .npy raises; close() from another thread ends the stream;
  * the library lands under build/torch_native/ and native/ is untouched."""
import os
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from panopticdiffusionmodels_tpu.data import native_loader as jax_native
from panopticdiffusionmodels_torch.data import native_loader
from panopticdiffusionmodels_torch.data.datasets import min_pool_2d
from panopticdiffusionmodels_torch.ops.kernels import build
from torch_port_coco_common import write_feature_dir

ROOT = Path(__file__).resolve().parents[1]
SHAPES = dict(moments_shape=(8, 4, 4), context_shape=(7, 12), seg_in=16)


@pytest.fixture(scope="module")
def feature_dir(tmp_path_factory):
    return write_feature_dir(tmp_path_factory.mktemp("feat"), n=10)


def test_library_builds_under_build_and_leaves_native_untouched():
    before = {p.name: p.stat().st_mtime_ns for p in (ROOT / "native").iterdir()}
    assert native_loader.available()
    lib = build.HOST_BUILD_DIR / "libfastloader.so"
    assert lib.exists() and lib.parent == ROOT / "build" / "torch_native"
    assert native_loader.SOURCE == ROOT / "panopticdiffusionmodels_torch" / "data" / "csrc" \
        / "fastloader.cpp"
    assert build.build_host_library(native_loader.SOURCE) == lib  # built once
    after = {p.name: p.stat().st_mtime_ns for p in (ROOT / "native").iterdir()}
    assert after == before


@pytest.mark.parametrize("mask_size", [8, None], ids=["seg", "no_seg"])
@pytest.mark.parametrize("shuffle", [True, False], ids=["shuffle", "ordered"])
def test_one_thread_matches_jax_bit_for_bit(feature_dir, shuffle, mask_size):
    kw = dict(SHAPES, batch_size=4, mask_size=mask_size, shuffle=shuffle, num_threads=1,
              seed=7)
    ours = native_loader.NativeFeatureLoader(feature_dir, **kw)
    ref = jax_native.NativeFeatureLoader(feature_dir, **kw)
    try:
        for _ in range(7):  # 2 batches an epoch: three epoch boundaries
            got, want = ours.next(), ref.next()
            assert len(got) == len(want) == (3 if mask_size else 2)
            for a, b in zip(got, want):
                assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
    finally:
        ours.close()
        ref.close()


def test_several_threads_rows_are_source_samples(feature_dir):
    loader = native_loader.NativeFeatureLoader(feature_dir, **SHAPES, batch_size=4,
                                               mask_size=8, num_threads=3, seed=1)
    moments = [np.load(f"{feature_dir}/{i}.npy").transpose(1, 2, 0) for i in range(10)]
    segs = [min_pool_2d(np.load(f"{feature_dir}/{i}_seg.npy"), 2) for i in range(10)]
    contexts = [[np.load(f"{feature_dir}/{i}_{k}.npy") for k in range(5)] for i in range(10)]
    try:
        for _ in range(6):
            m, c, s = loader.next()
            assert m.shape == (4, 4, 4, 8) and c.shape == (4, 7, 12) and s.shape == (4, 8, 8, 1)
            for b in range(4):
                i = next(i for i in range(10) if np.array_equal(m[b], moments[i]))
                assert np.array_equal(s[b, ..., 0], segs[i])
                assert any(np.array_equal(c[b], ctx) for ctx in contexts[i])
    finally:
        loader.close()


def test_processes_take_disjoint_subsets(feature_dir):
    seen = []
    for rank in range(2):
        loader = native_loader.NativeFeatureLoader(
            feature_dir, **SHAPES, batch_size=4, mask_size=None, num_threads=1, seed=rank,
            process_index=rank, process_count=2)
        assert loader.batch_size == 2
        rows = set()
        for _ in range(5):
            m, _ = loader.next()
            rows |= {next(i for i in range(10) if np.array_equal(
                m[b], np.load(f"{feature_dir}/{i}.npy").transpose(1, 2, 0))) for b in range(2)}
        loader.close()
        assert rows <= set(range(rank, 10, 2))
        seen.append(rows)
    assert not seen[0] & seen[1]


def test_a_corrupt_file_raises(tmp_path):
    d = write_feature_dir(tmp_path / "bad", n=4)
    (tmp_path / "bad" / "2.npy").write_bytes(b"not an npy file")
    loader = native_loader.NativeFeatureLoader(d, **SHAPES, batch_size=4, mask_size=8,
                                               num_threads=1)
    with pytest.raises(RuntimeError, match="bad or missing"):
        loader.next()
    loader.close()


def test_close_from_another_thread_ends_the_stream_quietly(feature_dir):
    loader = native_loader.NativeFeatureLoader(feature_dir, **SHAPES, batch_size=4,
                                               mask_size=8, num_threads=2)
    out, errors = [], []

    def consume():
        try:
            for batch in loader:
                out.append(batch[0].shape)
                time.sleep(0.01)
        except BaseException as e:  # noqa: BLE001 - the test reads it
            errors.append(e)

    t = threading.Thread(target=consume)
    t.start()
    time.sleep(0.2)
    loader.close()
    t.join(10)
    assert not t.is_alive() and not errors and out
    assert loader.next() is None
    loader.close()  # a second close is a no-op


def test_too_few_samples_and_uneven_processes_raise(feature_dir):
    with pytest.raises(ValueError, match="fewer than one batch"):
        native_loader.NativeFeatureLoader(feature_dir, **SHAPES, batch_size=12)
    with pytest.raises(ValueError, match="not divisible"):
        native_loader.NativeFeatureLoader(feature_dir, **SHAPES, batch_size=5,
                                          process_count=2)
