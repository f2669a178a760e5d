"""The port's multi-process `Loader` against the JAX package's, row for row.

`batch_size` is the GLOBAL batch: every process draws the same shuffle from
the same seed and loads only its rows, the contiguous `batch_size /
process_count` slice by default (JAX `data/loader.py:30-140`).  On a tiny
in-memory dataset with no random draws of its own (a `CFGDataset` or a
caption choice would draw from the global `random` module per process, in
both packages), process 0 and 1 of 2 must yield exactly the JAX loader's
rows across an epoch boundary and after the index-only `skip()`, and the
two processes' rows together must be one process's batch.  A batch that
does not divide the process count is refused, as JAX refuses it.
"""
import numpy as np
import pytest

from panopticdiffusionmodels_tpu.data.loader import Loader as JaxLoader
from panopticdiffusionmodels_torch.data.loader import Loader

N, BATCH, STEPS = 10, 4, 5  # two batches an epoch: steps 3-5 cross two epoch boundaries


class Rows:
    """Sample i is (i, 2i) as arrays: its rows say which indices were read."""

    def __len__(self):
        return N

    def __getitem__(self, i):
        return np.array([i], np.int64), np.full((2,), 2 * i, np.float32)


def take(loader, n):
    it = iter(loader)
    return [next(it) for _ in range(n)]


def assert_same(ours, want):
    assert len(ours) == len(want)
    for a, b in zip(ours, want):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("skip", [0, 3])
@pytest.mark.parametrize("rank", [0, 1])
def test_rows_match_jax_loader(rank, skip):
    kw = dict(seed=7, num_workers=0, process_index=rank, process_count=2)
    ours, want = Loader(Rows(), BATCH, **kw), JaxLoader(Rows(), BATCH, **kw)
    if skip:
        ours.skip(skip)
        want.skip(skip)
    got = take(ours, STEPS)
    assert_same(got, take(want, STEPS))
    assert all(b[0].shape == (BATCH // 2, 1) for b in got)


def test_processes_together_are_one_global_batch():
    single = take(Loader(Rows(), BATCH, seed=7, num_workers=2), STEPS)
    parts = [take(Loader(Rows(), BATCH, seed=7, num_workers=2, process_index=r,
                         process_count=2), STEPS) for r in range(2)]
    for step, whole in enumerate(single):
        for i, field in enumerate(whole):
            np.testing.assert_array_equal(
                np.concatenate([parts[0][step][i], parts[1][step][i]]), field)


def test_local_rows_override_the_default_slice():
    rows = slice(1, 3)
    ours = take(Loader(Rows(), BATCH, seed=3, num_workers=0, local_rows=rows), 3)
    want = take(JaxLoader(Rows(), BATCH, seed=3, num_workers=0, local_rows=rows), 3)
    assert_same(ours, want)


def test_a_batch_that_does_not_divide_the_processes_is_refused():
    with pytest.raises(AssertionError, match="not divisible by 3"):
        JaxLoader(Rows(), BATCH, process_count=3)
    with pytest.raises(ValueError, match="not divisible by 3"):
        Loader(Rows(), BATCH, process_count=3)
