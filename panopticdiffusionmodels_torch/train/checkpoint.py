"""Checkpoints: one `{root}/{step}.ckpt` per save, resume from the highest step
or else `best.ckpt`.

Port of the directory contract of `panopticdiffusionmodels_tpu/train/checkpoint.py`
(reference `utils.py:367-405`).  The payload is the train state's
{step, params, ema_params, opt_state}, written with `torch.save` to a
temporary file and renamed into place, so a reader never sees half a file;
it is read back with `torch.load(weights_only=True)`.
"""
from __future__ import annotations

import os
import re
from typing import Optional

import torch


def ckpt_path(root: str, step) -> str:
    return os.path.join(os.path.abspath(root), f"{step}.ckpt")


def save_checkpoint(root: str, state, step: Optional[int] = None) -> str:
    """Write the state's payload under {root}/{step}.ckpt (default: its step)."""
    os.makedirs(root, exist_ok=True)
    path = ckpt_path(root, state.step if step is None else step)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(state.state_dict(), tmp)
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)


def latest_step(root: str) -> Optional[int]:
    """The highest `{step}.ckpt` in root, or None."""
    if not os.path.isdir(root):
        return None
    steps = [int(m.group(1)) for m in (re.fullmatch(r"(\d+)\.ckpt", n) for n in os.listdir(root))
             if m]
    return max(steps) if steps else None


def resume(root: str, state, step: Optional[int] = None) -> bool:
    """Load into `state` the given step, else the latest, else `best.ckpt`;
    returns whether anything was loaded."""
    if step is None:
        step = latest_step(root)
    path = ckpt_path(root, "best" if step is None else step)
    if not os.path.exists(path):
        return False
    state.load_state_dict(load_checkpoint(path))
    return True
