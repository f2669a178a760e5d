"""The port's UViTT2I and its weight carry against the JAX package's.

JAX parameters (a seeded random model, zero convs made non-zero so the
coupling runs, brought into the JAX layout, scanned or unrolled, by the JAX
package's own `convert_uvit_t2i`) are carried with the port's numpy-only `uvit_t2i_state_dict`, which must give
exactly what the JAX package's `export_uvit_t2i` gives, and load with
strict=True.  Forward outputs must match at f32 rtol 1e-4 / atol 1e-5, with
inputs transposed NHWC <-> NCHW at the boundary.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panopticdiffusionmodels_tpu.models import UViTT2I as JaxUViTT2I
from panopticdiffusionmodels_tpu.utils.torch_bridge import convert_uvit_t2i, export_uvit_t2i
from panopticdiffusionmodels_torch.models import UViTT2I
from panopticdiffusionmodels_torch.utils.weights import to_tensors, uvit_t2i_state_dict

torch.set_num_threads(1)

GEOM = dict(img_size=8, patch_size=2, in_chans=4, embed_dim=32, depth=4, num_heads=4,
            clip_dim=16, num_clip_token=7, mask_bits=8, mask_size=16)
MODES = {  # name -> (model flags, feed a mask token, use_ground_truth)
    "dual": (dict(enable_panoptic=True, separate=True), True, False),
    "dual_gt": (dict(enable_panoptic=True, separate=True), True, True),
    "joint": (dict(enable_panoptic=True, separate=False), True, False),
    "image_only": (dict(enable_panoptic=False), False, False),
}
CASES = [("dual", False), ("dual", True), ("dual_gt", False), ("joint", False),
         ("joint", True), ("image_only", False)]


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    t = np.array([10.0, 900.0], np.float32)
    ctx = rng.standard_normal((2, 7, 16)).astype(np.float32)
    m = rng.standard_normal((2, 16, 16, 8)).astype(np.float32)
    return x, t, ctx, m


@functools.lru_cache(maxsize=None)
def jax_model_and_params(mode, scan):
    flags, _, _ = MODES[mode]
    model = JaxUViTT2I(**GEOM, **flags, scan_blocks=scan, attn_impl="xla")
    torch.manual_seed(7)
    seed_model = UViTT2I(**GEOM, **flags)
    with torch.no_grad():
        for name, p in seed_model.named_parameters():
            if name.startswith("zero_convs"):
                p.normal_(0, 0.02)
    sd = {k: v.numpy() for k, v in seed_model.state_dict().items()}
    params = convert_uvit_t2i(sd, depth=GEOM["depth"], scan_blocks=scan,
                              enable_panoptic=flags["enable_panoptic"],
                              separate=flags.get("separate", True))
    return model, params


def port_model(mode, params):
    flags, _, _ = MODES[mode]
    model = UViTT2I(**GEOM, **flags).eval()
    sd = uvit_t2i_state_dict(params, patch_size=2, mask_patch_size=model.mask_patch_size)
    model.load_state_dict(to_tensors(sd), strict=True)
    return model


@pytest.mark.parametrize("mode,scan", CASES)
def test_forward_matches_jax(mode, scan):
    _, feed_mask, gt = MODES[mode]
    jmodel, params = jax_model_and_params(mode, scan)
    x, t, ctx, m = _inputs(seed=1)
    kw = dict(mask_token=jnp.asarray(m)) if feed_mask else {}
    if gt:
        kw["use_ground_truth"] = True
    apply = jax.jit(jmodel.apply, static_argnames=("use_ground_truth",))
    ref = apply(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx), **kw)
    model = port_model(mode, params)
    pkw = dict(mask_token=torch.from_numpy(m).permute(0, 3, 1, 2)) if feed_mask else {}
    with torch.no_grad():
        out = model(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(t),
                    torch.from_numpy(ctx), use_ground_truth=gt, **pkw)
    refs = ref if feed_mask else (ref,)
    outs = out if feed_mask else (out,)
    for o, r in zip(outs, refs):
        np.testing.assert_allclose(o.permute(0, 2, 3, 1).numpy(), np.asarray(r),
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("mode,scan", CASES)
def test_carry_equals_jax_export(mode, scan):
    _, params = jax_model_and_params(mode, scan)
    mps = 2 * GEOM["mask_size"] // GEOM["img_size"]
    ours = uvit_t2i_state_dict(params, patch_size=2, mask_patch_size=mps)
    ref = export_uvit_t2i(params, patch_size=2, mask_patch_size=mps)
    assert sorted(ours) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k], np.asarray(ref[k]), err_msg=k)
    model = port_model(mode, params)  # strict=True load
    assert sorted(model.state_dict()) == sorted(ref)


def test_zero_conv_names_are_the_reference_odd_indices():
    model = UViTT2I(**GEOM)
    names = sorted({k.split(".")[1] for k in model.state_dict() if k.startswith("zero_convs")},
                   key=int)
    assert names == [str(2 * i + 1) for i in range(GEOM["depth"] + 1)]
    assert model.mask_patch_size == 4
