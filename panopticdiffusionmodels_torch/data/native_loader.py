"""ctypes bindings for the native C++ feature-batch loader.

Port of `panopticdiffusionmodels_tpu/data/native_loader.py`, on the port's
own copy of the C++ source (`data/csrc/fastloader.cpp`), which
`ops/kernels/build.py::build_host_library` compiles with g++ at first use
into `build/torch_native/libfastloader.so`.  `NativeFeatureLoader` reads an
MS-COCO feature directory (`{i}.npy` moments (2C, h, w), `{i}_{k}.npy`
contexts, `{i}_seg.npy` seg maps, reference `datasets.py:564-613`) and
assembles batches in a C++ thread pool: .npy parsing, the CHW -> HWC
transpose, the random caption and the seg map's min-pool all run off the
GIL.  Callers fall back to the Python `Loader` when `available()` is False.
"""
from __future__ import annotations

import ctypes
import logging
import threading
from pathlib import Path
from typing import Iterator, Optional

import numpy as np

from .datasets import MSCOCOFeatureDataset

SOURCE = Path(__file__).resolve().parent / "csrc" / "fastloader.cpp"

log = logging.getLogger(__name__)
_lib = None
_lock = threading.Lock()


def _load_lib():
    """The loaded library, building it first; None when it cannot be built."""
    global _lib
    with _lock:
        if _lib is None:
            from ..ops.kernels.build import build_host_library

            try:
                path = build_host_library(SOURCE)
            except (RuntimeError, OSError) as e:
                log.warning("native fastloader unavailable: %s", e)
                return None
            lib = ctypes.CDLL(str(path))
            lib.fl_open.restype = ctypes.c_void_p
            lib.fl_open.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
                ctypes.c_int, ctypes.c_int,  # batch, captions
                ctypes.c_int, ctypes.c_int, ctypes.c_int,  # moments c, h, w
                ctypes.c_int, ctypes.c_int,  # context tokens, width
                ctypes.c_int, ctypes.c_int,  # seg in, seg out
                ctypes.c_int, ctypes.c_uint64, ctypes.c_int,  # shuffle, seed, threads
            ]
            lib.fl_next.restype = ctypes.c_int
            lib.fl_next.argtypes = [ctypes.c_void_p] * 4
            lib.fl_stop.argtypes = [ctypes.c_void_p]
            lib.fl_close.argtypes = [ctypes.c_void_p]
            _lib = lib
        return _lib


def available() -> bool:
    """Whether the library is built (building it now if needed) and loaded."""
    return _load_lib() is not None


class NativeFeatureLoader:
    """Infinite batch iterator over a pre-encoded feature directory: each
    batch is (moments (B, h, w, 2C) f32, context (B, T, D) f32, seg (B, m,
    m, 1) int32 min-pooled from (seg_in, seg_in)), without seg when
    `mask_size` is None.

    `batch_size` is the GLOBAL batch.  Under `process_count > 1` each
    process takes the strided subset `indices[process_index::process_count]`
    of the files and `batch_size / process_count` rows a batch, so a
    per-process `seed` is safe: no sample is read by two processes."""

    def __init__(self, path: str, batch_size: int, moments_shape=(8, 32, 32),
                 context_shape=(77, 768), seg_in: int = 256, mask_size: Optional[int] = 64,
                 num_captions: int = 5, shuffle: bool = True, num_threads: int = 4,
                 seed: int = 0, process_index: int = 0, process_count: int = 1):
        lib = _load_lib()
        if lib is None:
            raise RuntimeError("native fastloader unavailable (the g++ build failed; see "
                               "the log)")
        # those with a _seg.npy when there are any, else every {i}.npy
        indices = MSCOCOFeatureDataset(path).indices
        if not indices:
            raise ValueError(f"no feature files in {path}")
        if batch_size % process_count:
            raise ValueError(f"global batch {batch_size} not divisible by {process_count} "
                             "processes")
        if process_count > 1:
            indices = indices[process_index::process_count]
            batch_size //= process_count
        if len(indices) < batch_size:
            raise ValueError(f"{len(indices)} samples in {path} are fewer than one batch "
                             f"({batch_size})")
        self.batch_size = batch_size
        mc, mh, mw = moments_shape
        ct, cd = context_shape
        self._mshape = (batch_size, mh, mw, mc)
        self._cshape = (batch_size, ct, cd)
        self._sshape = (batch_size, mask_size, mask_size, 1) if mask_size else None
        idx = np.asarray(indices, dtype=np.int64)
        self._lib = lib
        self._next_lock = threading.Lock()  # held by next() around fl_next
        self._close_lock = threading.Lock()
        self._stopping = False
        self._handle = lib.fl_open(
            path.encode(), idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(idx),
            batch_size, num_captions, mc, mh, mw, ct, cd, seg_in, mask_size or 0,
            1 if shuffle else 0, seed, num_threads)
        if not self._handle:
            raise RuntimeError("fl_open failed")

    def __iter__(self) -> Iterator:
        while True:
            batch = self.next()
            if batch is None:  # close(): end quietly (PEP 479: no StopIteration here)
                return
            yield batch

    def next(self):
        """One batch; None once `close()` has begun; raises on a bad or
        missing feature file (the C side prints its path to stderr)."""
        moments = np.empty(self._mshape, dtype=np.float32)
        context = np.empty(self._cshape, dtype=np.float32)
        seg = np.empty(self._sshape, dtype=np.int32) if self._sshape else None
        with self._next_lock:
            if self._stopping or not self._handle:
                return None
            ok = self._lib.fl_next(self._handle, moments.ctypes.data, context.ctypes.data,
                                   None if seg is None else seg.ctypes.data)
        if not ok:
            if self._stopping:
                return None
            raise RuntimeError("native fastloader failed (bad or missing feature file; "
                               "see stderr for the path)")
        return (moments, context) if seg is None else (moments, context, seg)

    def close(self) -> None:
        """End the stream, also from another thread: a `next()` blocked there
        returns None, and the loader is freed once it has."""
        with self._close_lock:
            if not getattr(self, "_handle", None):
                return
            self._stopping = True
            self._lib.fl_stop(self._handle)
            with self._next_lock:
                self._lib.fl_close(self._handle)
                self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 - interpreter shutdown
            pass
