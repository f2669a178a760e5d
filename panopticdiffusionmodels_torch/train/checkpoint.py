"""Checkpoints: one `{root}/{step}.ckpt` per save, resume from the highest step
or else `best.ckpt`; saves can be asynchronous.

Port of `panopticdiffusionmodels_tpu/train/checkpoint.py` (reference
`utils.py:367-405`).  The payload is the train state's {step, params,
ema_params, opt_state}, written with `torch.save` to a temporary file and
renamed into place, so a reader never sees half a file; it is read back with
`torch.load(weights_only=True)`.

`save_checkpoint(..., block=False)` is JAX's orbax save with `block=False`:
it copies the payload off the device into host memory before it returns
(into pinned staging buffers kept across saves, one device-to-host copy per
tensor and one synchronisation), then writes the file on a background
thread while training goes on.  The copy is what makes it safe: AdamW and
the EMA update the parameters and moments in place, so a thread that read
them after the next step had begun would save a later state.  At most one
write is pending: a save first waits for the one before.  `wait_for_saves`
waits for it and re-raises its error; `latest_step`, `load_checkpoint` and
`resume` call it first, and so does an `atexit` hook.

A train state under a process mesh (fsdp shards, tp slices, a pipeline
stage's blocks) gathers whole tensors and merges the stages in
`state_dict()`, a collective: every rank calls `save_checkpoint`, the
gather runs on each at the call, and only the rank that passes
`write=True` (rank 0) stages and writes the file, the same file one
process writes.  Every rank reads it back whole and keeps its part
(`TrainState.load_state_dict`), so a file written under one layout
resumes under another.
"""
from __future__ import annotations

import atexit
import os
import re
import threading
from typing import List, Optional

import torch

# The one pending write, the error it met, and the pinned host buffers reused
# save after save; `_lock` serialises saves and waits from several threads.
_pending: Optional[threading.Thread] = None
_failure: List[Exception] = []
_staging: List[torch.Tensor] = []
_lock = threading.RLock()


def ckpt_path(root: str, step) -> str:
    return os.path.join(os.path.abspath(root), f"{step}.ckpt")


def wait_for_saves() -> None:
    """Block until the pending asynchronous write, if any, is on disk;
    raises the error it met."""
    global _pending
    with _lock:
        if _pending is not None:
            _pending.join()
            _pending = None
        if _failure:
            raise RuntimeError("asynchronous checkpoint write failed") from _failure.pop()


atexit.register(wait_for_saves)


def writing() -> bool:
    """Whether an asynchronous write is still running."""
    return _pending is not None and _pending.is_alive()


def _stage(obj, slots: List[int]):
    """obj with every tensor copied to host memory that nothing else holds:
    device tensors into pinned buffers (reused from the last save when the
    shapes agree), host tensors cloned."""
    if isinstance(obj, dict):
        return {k: _stage(v, slots) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_stage(v, slots) for v in obj)
    if not torch.is_tensor(obj):
        return obj
    t = obj.detach()
    if t.device.type == "cpu":
        return t.clone()
    i = slots[0]
    slots[0] += 1
    if i == len(_staging):
        _staging.append(None)
    buf = _staging[i]
    if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
        buf = _staging[i] = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return buf.copy_(t, non_blocking=True)


def _write(payload: dict, path: str) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def _write_in_background(payload: dict, path: str) -> None:
    try:
        _write(payload, path)
    except Exception as e:  # noqa: BLE001 - re-raised by wait_for_saves
        _failure.append(e)


def save_checkpoint(root: str, state, step: Optional[int] = None, block: bool = True,
                    write: bool = True) -> str:
    """Write the state's payload under {root}/{step}.ckpt (default: its
    step).  `block=False` returns once the payload is in host memory and
    writes the file on a background thread; either way the file holds the
    state as it was at the call.  `write=False` only takes part in the
    gather of a sharded state (the ranks that do not write)."""
    global _pending
    with _lock:
        wait_for_saves()
        path = ckpt_path(root, state.step if step is None else step)
        state_dict = state.state_dict()
        if not write:
            return path
        os.makedirs(root, exist_ok=True)
        slots = [0]
        payload = _stage(state_dict, slots)
        if slots[0]:
            torch.cuda.synchronize()  # the non_blocking copies into the staging buffers
        if block:
            _write(payload, path)
        else:
            _pending = threading.Thread(target=_write_in_background, args=(payload, path),
                                        name="checkpoint-write")
            _pending.start()
    return path


def load_checkpoint(path: str) -> dict:
    wait_for_saves()
    return torch.load(path, map_location="cpu", weights_only=True)


def latest_step(root: str) -> Optional[int]:
    """The highest `{step}.ckpt` in root, or None."""
    wait_for_saves()
    if not os.path.isdir(root):
        return None
    steps = [int(m.group(1)) for m in (re.fullmatch(r"(\d+)\.ckpt", n) for n in os.listdir(root))
             if m]
    return max(steps) if steps else None


def resume(root: str, state, step: Optional[int] = None) -> bool:
    """Load into `state` the given step, else the latest, else `best.ckpt`;
    returns whether anything was loaded."""
    wait_for_saves()
    if step is None:
        step = latest_step(root)
    path = ckpt_path(root, "best" if step is None else step)
    if not os.path.exists(path):
        return False
    state.load_state_dict(load_checkpoint(path))
    return True
