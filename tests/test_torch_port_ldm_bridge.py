"""`utils/ldm_bridge.py` against the JAX package's converter.

A CompVis-LDM UNet state dict is generated from the LDM key layout,
restated in `tests/torch_port_unet_common.py::ldm_state_dict` (time_embed,
input_blocks / middle_block / output_blocks with in_layers / emb_layers /
out_layers / skip_connection, transformer_blocks.0 with ff.net.0.proj, the
downsamplers' `.op` and the upsamplers' `.conv` at module 1 of the deepest
level and module 2 elsewhere, out.{0,2}), with seeded values.  Both
converters read it, with and without the `model.diffusion_model.` prefix:
the port's output must be the JAX output carried by `unet_state_dict`,
value for value; at the tiny UNet's
shape both forwards on the converted weights must agree at rtol 1e-4 /
atol 1e-5 in f32 (with the same mask stream, gate open).  A missing key
raises; a load is strict on the image stream and leaves exactly the mask
stream missing.
"""
import jax
import numpy as np
import pytest
import torch

from panopticdiffusionmodels_tpu.utils.ldm_bridge import convert_ldm_unet as jax_convert
from panopticdiffusionmodels_torch.models.unet import UNet2DCondition
from panopticdiffusionmodels_torch.utils.ldm_bridge import (
    PREFIX,
    convert_ldm_unet,
    load_ldm_unet,
)
from panopticdiffusionmodels_torch.utils.weights import unet_state_dict
from torch_port_unet_common import TINY, ldm_state_dict, tiny_pair


def port_convert(sd, mult, nrb):
    return {k: v.numpy() for k, v in
            convert_ldm_unet(sd, channel_mult=mult, num_res_blocks=nrb).items()}


@pytest.mark.parametrize("prefixed", [False, True], ids=["bare", "prefixed"])
@pytest.mark.parametrize("shape", [(32, (1, 2, 2), 1), (32, (1, 2, 4, 4), 2)],
                         ids=["tiny", "sd_layout"])
def test_converter_matches_jax(shape, prefixed):
    ch0, mult, nrb = shape
    sd = ldm_state_dict(ch0, mult, nrb)
    if prefixed:
        sd = {PREFIX + k: v for k, v in sd.items()}
        sd["first_stage_model.decoder.conv_in.weight"] = np.zeros((1,), np.float32)  # ignored
    want = unet_state_dict(jax_convert(sd, channel_mult=mult, num_res_blocks=nrb))
    got = port_convert(sd, mult, nrb)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_forwards_on_converted_weights_match_jax():
    sd = ldm_state_dict(32, (1, 2, 2), 1)
    jnet, params, net = tiny_pair(seed=1)
    missing = load_ldm_unet(net, sd, channel_mult=(1, 2, 2), num_res_blocks=1)
    assert missing and all(k.startswith("mask_") for k in missing)
    assert sorted(missing) == sorted(k for k in net.state_dict() if k.startswith("mask_"))
    jparams = jax.tree.map(np.asarray, jax_convert(sd, channel_mult=(1, 2, 2), num_res_blocks=1))
    merged = dict(params["params"])
    for k in merged:
        if not k.startswith("mask_"):
            merged[k] = jparams["params"][k]  # the image stream from the JAX converter
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    t = np.array([10.0, 500.0], np.float32)
    ctx = rng.standard_normal((2, 5, 16)).astype(np.float32)
    m = rng.standard_normal((2, 16, 16, 8)).astype(np.float32)
    ref = jax.jit(lambda p: jnet.apply(p, x, t, ctx, mask_token=m))({"params": merged})
    with torch.no_grad():
        ours = net(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(t),
                   torch.from_numpy(ctx), mask_token=torch.from_numpy(m).permute(0, 3, 1, 2))
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.permute(0, 2, 3, 1).numpy(), np.asarray(b),
                                   rtol=1e-4, atol=1e-5)


def test_missing_key_raises():
    sd = ldm_state_dict(32, (1, 2, 2), 1)
    del sd["output_blocks.3.2.conv.weight"]  # the level-1 upsampler
    with pytest.raises(KeyError, match="output_blocks.3.2.conv.weight"):
        convert_ldm_unet(sd, channel_mult=(1, 2, 2), num_res_blocks=1)
    with pytest.raises(KeyError):
        jax_convert(sd, channel_mult=(1, 2, 2), num_res_blocks=1)


def test_load_is_strict_on_the_image_stream():
    """Converted weights of another shape, or a UNet with a layer the
    checkpoint lacks (context_proj), refuse to load."""
    sd = ldm_state_dict(32, (1, 2, 2), 1)
    net = UNet2DCondition(**TINY, enable_panoptic=True, mask_size=16, context_dim=12)
    with pytest.raises(ValueError, match="context_proj"):
        load_ldm_unet(net, sd, channel_mult=(1, 2, 2), num_res_blocks=1)
    wide = UNet2DCondition(**dict(TINY, channel_mult=(1, 2, 2, 2)), enable_panoptic=False)
    with pytest.raises(ValueError, match="unexpected|missing"):
        load_ldm_unet(wide, sd, channel_mult=(1, 2, 2), num_res_blocks=1)
    image_only = UNet2DCondition(**TINY, enable_panoptic=False)
    assert load_ldm_unet(image_only, sd, channel_mult=(1, 2, 2), num_res_blocks=1) == []


def test_from_config_reads_an_ldm_checkpoint(tmp_path):
    """`GenerationPipeline.from_config(nnet_path=)` of a `unet_t2i` loads an
    LDM checkpoint (prefixed, under `state_dict`) into the image stream."""
    from panopticdiffusionmodels_torch.configs import get_config
    from panopticdiffusionmodels_torch.configs.base import d
    from panopticdiffusionmodels_torch.serving import GenerationPipeline
    from torch_port_unet_common import unet_fields

    sd = ldm_state_dict(32, (1, 2, 2), 1)
    path = tmp_path / "ldm.ckpt"
    torch.save({"state_dict": {PREFIX + k: torch.from_numpy(v) for k, v in sd.items()}}, path)
    config = get_config("synthetic_tiny")
    config.nnet = d(**unet_fields())
    config.sample.algorithm = "pndm"
    pipe = GenerationPipeline.from_config(config, nnet_path=str(path), device="cpu")
    image = convert_ldm_unet(sd, channel_mult=(1, 2, 2), num_res_blocks=1)
    got = pipe.nnet.state_dict()
    for k, v in image.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0)
