"""The port's `UNet2DCondition` against the JAX package's, on the same weights.

The tiny UNet of `tests/torch_port_unet_common.py` (three levels, 4 heads,
its mask gate opened with seeded non-zero values so the mask encoder reaches
the image path), carried to JAX leaf for leaf.  Both forwards run in f32 on
the CPU on the same numpy inputs and must agree at rtol 1e-4 / atol 1e-5:
panoptic (mask 16 = 2 x sample: one stride-2 mask_down and one mask_up) with
the input gradients of a scalar loss against `jax.grad`, mask_size ==
sample_size, a context width != clip_dim (context_proj), no mask token (and
the image-only module on the same image weights), and use_ground_truth.  The
stride-2 "SAME" padding of the downsamplers is held on its own against
flax's conv.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panopticdiffusionmodels_torch.configs import get_config
from panopticdiffusionmodels_torch.models import get_nnet
from panopticdiffusionmodels_torch.models.unet import UNet2DCondition, conv_same_stride2
from panopticdiffusionmodels_torch.utils.weights import to_tensors, unet_state_dict
from torch_port_unet_common import TINY, tiny_pair

torch.set_num_threads(4)

RTOL, ATOL = 1e-4, 1e-5
B = 2


@functools.lru_cache(maxsize=None)
def pair(mask_size=16, context_dim=16):
    return tiny_pair(mask_size=mask_size, context_dim=context_dim)


def inputs(mask_size=16, context_dim=16, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, 8, 8, 4)).astype(np.float32),
            np.array([3.0, 871.0], np.float32),
            rng.standard_normal((B, 5, context_dim)).astype(np.float32),
            rng.standard_normal((B, mask_size, mask_size, 8)).astype(np.float32))


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def close(ours, ref, atol=ATOL):
    np.testing.assert_allclose(ours, np.asarray(ref), rtol=RTOL, atol=atol)


WN = np.random.default_rng(5).standard_normal((B, 8, 8, 4)).astype(np.float32)
WM = np.random.default_rng(6).standard_normal((B, 16, 16, 8)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def jax_refs():
    """One jit of the panoptic forward with the input gradients of
    sum(noise * WN) + sum(mask * WM), the forward without a mask token and
    the ground-truth mode: one compile instead of three."""
    jnet, params, _ = pair()
    x, t, ctx, m = inputs()

    def jloss(xx, cc, mm):
        noise, mask = jnet.apply(params, xx, t, cc, mask_token=mm)
        return jnp.sum(noise * WN) + jnp.sum(mask * WM), (noise, mask)

    def refs(xx, cc, mm):
        (_, outs), grads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(xx, cc, mm)
        return dict(panoptic=outs, grads=grads, no_mask=jnet.apply(params, xx, t, cc),
                    ground_truth=jnet.apply(params, xx, t, cc, mask_token=mm,
                                            use_ground_truth=True))

    return jax.jit(refs)(x, ctx, m)


def test_panoptic_forward_and_input_gradients_match_jax():
    _, _, net = pair()
    x, t, ctx, m = inputs()
    ref = jax_refs()
    xt, ct, mt = nchw(x).requires_grad_(), torch.from_numpy(ctx).requires_grad_(), \
        nchw(m).requires_grad_()
    noise, mask = net(xt, torch.from_numpy(t), ct, mask_token=mt)
    assert noise.shape == (B, 4, 8, 8) and mask.shape == (B, 8, 16, 16)
    close(nhwc(noise), ref["panoptic"][0])
    close(nhwc(mask), ref["panoptic"][1])
    ((noise * nchw(WN)).sum() + (mask * nchw(WM)).sum()).backward()
    for ours, want in zip((nhwc(xt.grad), ct.grad.numpy(), nhwc(mt.grad)), ref["grads"]):
        close(ours, want, atol=ATOL * float(np.abs(want).max()))


@pytest.mark.parametrize("case", ["mask_size_eq_sample", "context_proj"])
def test_panoptic_forward_variants_match_jax(case):
    kw = dict(mask_size=8) if case == "mask_size_eq_sample" else dict(context_dim=12)
    jnet, params, net = pair(**kw)
    assert ("context_proj" in params["params"]) == (case == "context_proj")
    assert ("mask_down_0" in params["params"]) == (case != "mask_size_eq_sample")
    x, t, ctx, m = inputs(**kw)
    ref_noise, ref_mask = jax.jit(lambda p: jnet.apply(p, x, t, ctx, mask_token=m))(params)
    with torch.no_grad():
        noise, mask = net(nchw(x), torch.from_numpy(t), torch.from_numpy(ctx),
                          mask_token=nchw(m))
    close(nhwc(noise), ref_noise)
    close(nhwc(mask), ref_mask)


def test_gate_reaches_the_image_path():
    """With the gate open the mask token changes the noise prediction."""
    _, _, net = pair()
    x, t, ctx, m = inputs()
    with torch.no_grad():
        a = net(nchw(x), torch.from_numpy(t), torch.from_numpy(ctx), mask_token=nchw(m))[0]
        b = net(nchw(x), torch.from_numpy(t), torch.from_numpy(ctx), mask_token=nchw(-m))[0]
    assert float((a - b).abs().max()) > 1e-3


def test_no_mask_token_matches_jax_and_the_image_only_module():
    _, _, net = pair()
    x, t, ctx, _ = inputs()
    ref = jax_refs()["no_mask"]
    image_only = UNet2DCondition(**TINY, enable_panoptic=False)
    image_only.load_state_dict({k: v for k, v in net.state_dict().items()
                                if not k.startswith("mask_")}, strict=True)
    with torch.no_grad():
        close(nhwc(net(nchw(x), torch.from_numpy(t), torch.from_numpy(ctx))), ref)
        close(nhwc(image_only(nchw(x), torch.from_numpy(t), torch.from_numpy(ctx))), ref)
    with pytest.raises(ValueError, match="enable_panoptic"):
        image_only(nchw(x), torch.from_numpy(t), torch.from_numpy(ctx),
                   mask_token=nchw(inputs()[3]))


def test_ground_truth_mode_matches_jax():
    _, _, net = pair()
    x, t, ctx, m = inputs()
    ref_noise, ref_mask = jax_refs()["ground_truth"]
    with torch.no_grad():
        noise, mask = net(nchw(x), torch.from_numpy(t), torch.from_numpy(ctx),
                          mask_token=nchw(m), use_ground_truth=True)
    close(nhwc(noise), ref_noise)
    np.testing.assert_array_equal(nhwc(mask), np.asarray(ref_mask))  # echoed unchanged
    np.testing.assert_array_equal(nhwc(mask), m)


@pytest.mark.parametrize("size", [8, 7])
def test_stride2_same_padding_matches_flax(size):
    """flax "SAME" at stride 2 pads (0, 1) on an even size, (1, 1) on an odd one."""
    import flax.linen as fnn

    rng = np.random.default_rng(size)
    x = rng.standard_normal((1, size, size, 3)).astype(np.float32)
    conv = fnn.Conv(5, (3, 3), strides=(2, 2), padding="SAME")
    p = jax.tree.map(np.asarray, conv.init(jax.random.PRNGKey(0), x))
    ref = conv.apply(p, x)
    ours = torch.nn.Conv2d(3, 5, 3, stride=2)
    sd = to_tensors(unet_state_dict({"c": p["params"]}))
    ours.load_state_dict({k.removeprefix("c."): v for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        close(nhwc(conv_same_stride2(ours, nchw(x))), ref)
        symmetric = torch.nn.functional.conv2d(nchw(x), ours.weight, ours.bias, stride=2,
                                               padding=1)
    if size % 2 == 0:  # padding=1 is a different function on an even size
        assert float(np.abs(nhwc(symmetric) - np.asarray(ref)).max()) > 1e-2


def test_get_nnet_builds_the_unet_from_the_zoo_fields():
    kw = dict(get_config("mscoco_unet").nnet)
    kw.update(model_channels=32, channel_mult=[1, 2], num_heads=2, sample_size=8, mask_size=16)
    net = get_nnet(kw.pop("name"), **kw)
    assert isinstance(net, UNet2DCondition)
    names = set(net.state_dict())
    for key in ("time_fc1.weight", "down_0_res_0.conv1.weight",
                "down_0_attn_0.block_0.attn1.to_q.weight", "mask_zero_gate.weight",
                "mask_down_0.weight", "mask_up_0.weight", "up_1_upsample.weight"):
        assert key in names, key
    assert "down_1_attn_0.norm.weight" not in names  # no attention at the deepest level
    assert float(net.mask_zero_gate.weight.detach().abs().max()) == 0.0
