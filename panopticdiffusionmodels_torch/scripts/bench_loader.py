"""Host data-feed throughput: the native C++ loader against the Python
`Loader`.

    python -m panopticdiffusionmodels_torch.scripts.bench_loader [n_samples] [batch]

Port of `scripts/bench_loader.py`.  It writes a synthetic MS-COCO feature
directory at the real geometry (moments (8, 32, 32) f32, five CLIP contexts
(77, 768) f32, seg (256, 256) i64: the `{i}.npy` / `{i}_{k}.npy` /
`{i}_seg.npy` contract, reference `datasets.py:564-613`) of n_samples (256)
samples, then times 40 batches of `batch` (64) after one untimed batch
from `data/native_loader.py` (8 threads) and from `data/loader.py` over
`MSCOCOFeatureDataset` (8 workers): .npy parse, CHW -> HWC, a random
caption, the 4x4 seg min-pool.  A host benchmark: it uses no device and
refuses none, and it says so.  The number to beat is the training step's
appetite (`bench_train`'s images/s).
"""
from __future__ import annotations

import os
import sys
import tempfile
import time

import numpy as np

from ..data import native_loader
from ..data.datasets import MSCOCOFeatureDataset
from ..data.loader import Loader
from .measure import finish

N_BATCHES = 40
MOMENTS, CONTEXT, SEG, CAPTIONS = (8, 32, 32), (77, 768), (256, 256), 5


def build_dir(d: str, n: int) -> None:
    """n samples of seeded random features in `d`, the JAX script's layout."""
    rng = np.random.default_rng(0)
    for i in range(n):
        np.save(os.path.join(d, f"{i}.npy"), rng.normal(size=MOMENTS).astype(np.float32))
        for k in range(CAPTIONS):
            np.save(os.path.join(d, f"{i}_{k}.npy"), rng.normal(size=CONTEXT).astype(np.float32))
        np.save(os.path.join(d, f"{i}_seg.npy"), rng.integers(0, 201, SEG).astype(np.int64))


def rate(it, batch: int) -> dict:
    """Samples a second over N_BATCHES batches of `it` after one untimed."""
    next(it)
    t0 = time.perf_counter()
    for _ in range(N_BATCHES):
        next(it)
    dt = time.perf_counter() - t0
    return dict(samples_per_s=N_BATCHES * batch / dt, ms_per_batch=1e3 * dt / N_BATCHES)


def main(argv=None, device=None) -> dict:
    """`device` is taken and ignored, as `--device=` is: a host benchmark."""
    argv = sys.argv[1:] if argv is None else list(argv)
    argv = [a for a in argv if not a.startswith("--device=")]
    n = int(argv[0]) if len(argv) > 0 else 256
    batch = int(argv[1]) if len(argv) > 1 else 64
    print("bench_loader: a host benchmark; it uses no device and needs no card")
    out = {}
    with tempfile.TemporaryDirectory() as d:
        build_dir(d, n)
        if native_loader.available():
            nat = native_loader.NativeFeatureLoader(
                d, batch_size=batch, moments_shape=MOMENTS, context_shape=CONTEXT,
                seg_in=SEG[0], mask_size=64, num_captions=CAPTIONS, num_threads=8, seed=0)
            try:
                out["native"] = rate(iter(nat), batch)
            finally:
                nat.close()
            print(f"native fastloader: {out['native']['samples_per_s']:8.1f} samples/s "
                  f"({out['native']['ms_per_batch']:.1f} ms/batch of {batch})")
        else:
            out["native"] = None
            print("native fastloader unavailable")
        loader = Loader(MSCOCOFeatureDataset(d, mask_size=64), batch_size=batch, num_workers=8,
                        seed=0)
        out["python"] = rate(iter(loader), batch)
        print(f"python Loader:     {out['python']['samples_per_s']:8.1f} samples/s "
              f"({out['python']['ms_per_batch']:.1f} ms/batch of {batch})")
    return finish("bench_loader", dict(n_samples=n, batch=batch, batches=N_BATCHES,
                                       **out), "host")


if __name__ == "__main__":
    main()
