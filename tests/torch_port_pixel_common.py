"""Shared harness of the port's pixel-space parity tests (not collected
itself): a tiny U-ViT (8x8x3 images, patch 2, width 32, depth 4, 4 heads,
mlp ratio 2, f32) with seeded random weights, as a port module and as the
JAX module with the same parameters (`convert_uvit`), each wrapped as a
channel-last apply function `(x NHWC, t, y=None) -> NHWC`."""
from __future__ import annotations

import functools

import jax
import numpy as np
import torch

from panopticdiffusionmodels_tpu.models import UViT as JaxUViT
from panopticdiffusionmodels_tpu.utils.torch_bridge import convert_uvit
from panopticdiffusionmodels_torch.models import UViT

GEOM = dict(img_size=8, patch_size=2, in_chans=3, embed_dim=32, depth=4, num_heads=4,
            mlp_ratio=2)


@functools.lru_cache(maxsize=None)
def models(num_classes: int = -1, depth: int = GEOM["depth"], seed: int = 3):
    """(port UViT in eval mode, JAX UViT, JAX params): the same weights."""
    geom = dict(GEOM, depth=depth)
    torch.manual_seed(seed)
    model = UViT(**geom, num_classes=num_classes).eval()
    params = convert_uvit({k: v.numpy() for k, v in model.state_dict().items()},
                          depth=depth, num_classes=num_classes, scan_blocks=True)
    return model, JaxUViT(**geom, num_classes=num_classes, scan_blocks=True,
                          attn_impl="xla"), params


def port_apply(num_classes: int = -1, depth: int = GEOM["depth"]):
    model = models(num_classes, depth)[0]

    def fn(x, t, y=None):
        with torch.no_grad():
            out = model(x.permute(0, 3, 1, 2), t, y)
        return out.permute(0, 2, 3, 1)

    return fn


def jax_apply(num_classes: int = -1, depth: int = GEOM["depth"]):
    _, jmodel, params = models(num_classes, depth)
    apply = jax.jit(lambda x, t, y: jmodel.apply(params, x, t, y))
    apply_uncond = jax.jit(lambda x, t: jmodel.apply(params, x, t))

    def fn(x, t, y=None):
        return apply_uncond(x, t) if y is None else apply(x, t, y)

    return fn


def nhwc(seed: int, batch: int = 3, hw: int = 8, c: int = 3) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((batch, hw, hw, c)).astype(np.float32)


def close(ours, ref, rtol=1e-4, atol=1e-5, msg=""):
    ours = ours.detach().numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    np.testing.assert_allclose(ours, np.asarray(ref), rtol=rtol, atol=atol, err_msg=msg)
