"""Small host-side helpers of the serving and evaluation paths (the port's
copy of `panopticdiffusionmodels_tpu/utils/misc.py::amortize` and
`::one_deep`, and `to_numpy`)."""
from __future__ import annotations

import numpy as np
import torch


def amortize(n_samples: int, batch_size: int):
    """Split n_samples into full batches plus a remainder
    (reference `utils.py:452-455`)."""
    k, r = divmod(n_samples, batch_size)
    return k * [batch_size] if r == 0 else k * [batch_size] + [r]


def one_deep(items, dispatch):
    """Yield (item, dispatch(item)) one step behind the dispatch calls.

    CUDA launches return before the card finishes, so calling
    `dispatch(item_{i+1})` before the consumer copies item_i's outputs back
    keeps the card busy while the host works on item_i: the overlap of
    `serving.generate_batches`, `sampler_io.sample2dir` and
    `fid.dir_statistics`.  Order is kept; the tail is flushed."""
    pending = None
    for item in items:
        out = dispatch(item)
        if pending is not None:
            yield pending
        pending = (item, out)
    if pending is not None:
        yield pending


def to_numpy(x) -> np.ndarray:
    """A tensor (on any device) or array -> numpy; copying a card tensor back
    waits for the work that makes it."""
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
