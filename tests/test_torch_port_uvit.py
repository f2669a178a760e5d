"""The port's UViT and its weight carry against the JAX package's.

JAX parameters (a seeded random port model brought into the JAX layout,
scanned or unrolled, by the JAX package's own `convert_uvit`) are carried
with the port's numpy-only `uvit_state_dict`, which must give exactly what
the JAX package's `export_uvit` gives and load with strict=True.  Forward
outputs, unconditional (num_classes = -1) and class-conditional (5 classes,
the label token before the time token), with and without the time-embedding
MLP, must match at f32 rtol 1e-4 / atol 1e-5 (same math, another summation
order over four blocks), inputs transposed NHWC <-> NCHW at the boundary.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panopticdiffusionmodels_tpu.models import UViT as JaxUViT
from panopticdiffusionmodels_tpu.utils.torch_bridge import (
    convert_uvit,
    export_uvit,
    save_torch_state_dict,
)
from panopticdiffusionmodels_torch.models import UViT, get_nnet
from panopticdiffusionmodels_torch.utils.weights import (
    load_torch_state_dict,
    to_tensors,
    uvit_state_dict,
)

GEOM = dict(img_size=8, patch_size=2, in_chans=4, embed_dim=32, depth=4, num_heads=4)
CASES = [(-1, False), (-1, True), (5, False), (5, True)]


@functools.lru_cache(maxsize=None)
def jax_model_and_params(num_classes, mlp_time_embed, scan):
    model = JaxUViT(**GEOM, num_classes=num_classes, mlp_time_embed=mlp_time_embed,
                    scan_blocks=scan, attn_impl="xla")
    torch.manual_seed(11)
    seed_model = UViT(**GEOM, num_classes=num_classes, mlp_time_embed=mlp_time_embed)
    sd = {k: v.numpy() for k, v in seed_model.state_dict().items()}
    params = convert_uvit(sd, depth=GEOM["depth"], mlp_time_embed=mlp_time_embed,
                          num_classes=num_classes, scan_blocks=scan)
    return model, params


def port_model(num_classes, mlp_time_embed, params):
    model = UViT(**GEOM, num_classes=num_classes, mlp_time_embed=mlp_time_embed).eval()
    model.load_state_dict(to_tensors(uvit_state_dict(params, patch_size=2)), strict=True)
    return model


@pytest.mark.parametrize("num_classes,mlp_time_embed", CASES)
def test_forward_matches_jax(num_classes, mlp_time_embed):
    jmodel, params = jax_model_and_params(num_classes, mlp_time_embed, True)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 8, 8, 4)).astype(np.float32)
    t = np.array([5.0, 400.0, 990.0], np.float32)
    y = np.array([0, 4, 2], np.int32) if num_classes > 0 else None
    jargs = (jnp.asarray(x), jnp.asarray(t)) + ((jnp.asarray(y),) if y is not None else ())
    ref = jax.jit(jmodel.apply)(params, *jargs)
    model = port_model(num_classes, mlp_time_embed, params)
    assert model.extras == (2 if num_classes > 0 else 1)
    with torch.no_grad():
        out = model(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(t),
                    None if y is None else torch.from_numpy(y).long())
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), np.asarray(ref),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("scan", [False, True])
@pytest.mark.parametrize("num_classes,mlp_time_embed", CASES)
def test_carry_equals_jax_export(num_classes, mlp_time_embed, scan):
    _, params = jax_model_and_params(num_classes, mlp_time_embed, scan)
    ours = uvit_state_dict(params, patch_size=2)
    ref = export_uvit(params, patch_size=2)
    assert sorted(ours) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k], np.asarray(ref[k]), err_msg=k)
    model = port_model(num_classes, mlp_time_embed, params)  # strict=True load
    assert sorted(model.state_dict()) == sorted(ref)


def test_reference_pth_loads_strictly(tmp_path):
    _, params = jax_model_and_params(5, True, False)
    path = tmp_path / "nnet_ema.pth"
    save_torch_state_dict(export_uvit(params, patch_size=2), str(path))
    model = get_nnet("uvit", **GEOM, num_classes=5, mlp_time_embed=True, scan_blocks=True)
    model.load_state_dict(load_torch_state_dict(str(path)), strict=True)
    with pytest.raises(ValueError, match="labels"):
        model(torch.zeros((1, 4, 8, 8)), torch.zeros((1,)))
