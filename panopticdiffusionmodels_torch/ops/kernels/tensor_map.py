"""What a TMA tensor map of the Hopper kernels can take, checked in Python.

The wgmma loop of `csrc/attention_fwd.cuh` reads q, k and v through TMA
tensor maps (`cuTensorMapEncodeTiled`), which need the base address and every
stride in bytes to be multiples of 16 and the innermost dimension (the head
dim) of unit stride.  The wrappers check this before they launch, so that a
view the kernel cannot take raises in Python instead of failing to encode.
"""
from __future__ import annotations

import torch

ALIGN = 16  # bytes: TMA's alignment of the base address and of each stride


def tma_eligible(t: torch.Tensor) -> bool:
    """True if `t` can be described by a TMA tensor map as it lies: unit
    stride along its last dim, base and every other stride 16-byte aligned.
    Reads only the storage offset and strides: a CPU or meta tensor answers
    as a CUDA tensor with the same layout would (the base of a fresh
    allocation is aligned on every device)."""
    size = t.element_size()
    if t.dim() == 0 or t.stride(-1) != 1:
        return False
    if t.device.type != "meta" and t.data_ptr() % ALIGN:
        return False
    if (t.storage_offset() * size) % ALIGN:
        return False
    return all((s * size) % ALIGN == 0 for s in t.stride()[:-1])
