"""Seeded weights, made on the device in one draw.

One standard-normal draw of every parameter's elements together, from a
generator on the device, is cut into the named tensors and scaled by a rule
of the tensor's shape: a matrix or kernel by fan_in ** -0.5 (activations
keep their size through the network), a position table by 0.02, a 1-d
scale (LayerNorm, GroupNorm) as 1 + 0.02 n, a 1-d bias as 0.02 n.  Every
coupling (the zero-initialised convolutions of the panoptic model too) gets
random weights, so that each path of the network carries signal.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def scale_rule(name, shape):
    """(mean, std) of the parameter `name` of `shape`."""
    if len(shape) == 1:
        return (1.0, 0.02) if name.endswith("weight") else (0.0, 0.02)
    if "pos_embed" in name:
        return 0.0, 0.02
    return 0.0, math.prod(shape[1:]) ** -0.5


def seeded(shapes, seed, device, dtype=torch.float32):
    """{name: tensor of `shape`} from one draw seeded by `seed`, in `dtype`
    (values rounded to it once)."""
    g = torch.Generator(device=device).manual_seed(seed)
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.randn(total, generator=g, device=device, dtype=torch.float32)
    out, offset = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        mean, std = scale_rule(name, shape)
        out[name] = (flat[offset:offset + n].view(shape) * std + mean).to(dtype)
        offset += n
    return out


def shapes_of(module):
    return {n: tuple(p.shape) for n, p in module.state_dict().items()}


def derive(seed, *parts):
    """A 63-bit seed of its own for each use of the run's seed."""
    parts = [p % 2 ** 63 for p in (seed, *parts)]
    return int(np.random.SeedSequence(parts).generate_state(2, np.uint64)[0]
               >> np.uint64(1))
