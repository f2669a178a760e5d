"""Class-conditional CFG and the class-conditional serving slice against the
JAX package.

`make_cfg_class_cond` must equal the JAX one on the same apply function and
inputs (f32 rtol 1e-6 / atol 1e-6: elementwise arithmetic only).  A tiny
class-conditional config (imagenet256_uvit_large cut to width 32, depth 4,
11 classes, latent 8x8x4, f32) with a small VAE runs through the JAX
`GenerationPipeline._pipeline` and through the port's
`GenerationPipeline.sample` on the same weights, labels and JAX-drawn z;
the images must match at atol 1e-4 (the t2i serving test's bar: a 6-step
solver, four f32 blocks per NFE and the VAE decode, summed in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panopticdiffusionmodels_tpu.configs import get_config as jax_get_config
from panopticdiffusionmodels_tpu.diffusion.cfg import make_cfg_class_cond as jax_cfg
from panopticdiffusionmodels_tpu.models.vae import AutoencoderKL as JaxAutoencoderKL
from panopticdiffusionmodels_tpu.serving import GenerationPipeline as JaxPipeline
from panopticdiffusionmodels_tpu.utils.torch_bridge import (
    convert_autoencoder_kl,
    convert_uvit,
    export_uvit,
    save_torch_state_dict,
)
from panopticdiffusionmodels_torch.configs import get_config
from panopticdiffusionmodels_torch.diffusion.cfg import make_cfg_class_cond
from panopticdiffusionmodels_torch.models import get_nnet
from panopticdiffusionmodels_torch.models.vae import AutoencoderKL
from panopticdiffusionmodels_torch.serving import GenerationPipeline

torch.set_num_threads(1)

VAE_GEOM = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, scale_factor=0.18215)
NNET = dict(img_size=8, embed_dim=32, depth=4, num_heads=4, num_classes=11)


@pytest.mark.parametrize("scale,enabled", [(0.4, True), (0.0, True), (0.4, False)])
def test_cfg_matches_jax(scale, enabled):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 6)).astype(np.float32)
    t = np.array([3.0, 500.0, 999.0], np.float32)
    y = np.array([1, 0, 6])
    table = rng.standard_normal((7, 6)).astype(np.float32)

    def jax_apply(xx, tt, yy):
        return xx * (1 + tt / 1000)[:, None] + jnp.asarray(table)[yy]

    def port_apply(xx, tt, yy):
        return xx * (1 + tt / 1000)[:, None] + torch.from_numpy(table)[yy]

    ref = jax_cfg(jax_apply, 6, scale, enabled)(jnp.asarray(x), jnp.asarray(t), jnp.asarray(y))
    out = make_cfg_class_cond(port_apply, 6, scale, enabled)(
        torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(y))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


def _configs():
    config = get_config("imagenet256_uvit_large")
    jconfig = jax_get_config("imagenet256_uvit_large")
    for c in (config, jconfig):
        c.nnet.update(NNET)
        c.z_shape = (8, 8, 4)
        c.compute_dtype = "float32"
    return config, jconfig


def _port_parts(config):
    torch.manual_seed(0)
    kw = dict(config.nnet)
    return get_nnet(kw.pop("name"), **kw), AutoencoderKL(**VAE_GEOM)


def test_whole_slice_matches_jax_pipeline():
    config, jconfig = _configs()
    nnet, vae = _port_parts(config)
    params = convert_uvit({k: v.numpy() for k, v in nnet.state_dict().items()}, depth=4,
                          num_classes=11, scan_blocks=True)
    vae_params = convert_autoencoder_kl({k: v.numpy() for k, v in vae.state_dict().items()},
                                        ch_mult=VAE_GEOM["ch_mult"], num_res_blocks=1)
    jpipe = JaxPipeline(jconfig, params, vae_params)
    jpipe.vae = JaxAutoencoderKL(**VAE_GEOM)
    labels = np.array([3, 10, 0], np.int32)
    key = jax.random.PRNGKey(5)
    jimages = jpipe._postprocess(jpipe._pipeline(3, 6)(params, vae_params, key,
                                                       jnp.asarray(labels)))
    z = np.array(jax.random.normal(key, (3, 8, 8, 4)))  # the JAX class-cond draw

    pipe = GenerationPipeline(config, nnet, vae, device="cpu")
    images, mask = pipe.sample(torch.from_numpy(z).permute(0, 3, 1, 2), None,
                               torch.from_numpy(labels).long(), steps=6)
    assert mask is None
    images01 = pipe._postprocess(images, None)
    assert images01.shape == jimages.shape == (3, 16, 16, 3)
    np.testing.assert_allclose(images01, jimages, atol=1e-4)


def test_generate_labels_and_n(tmp_path):
    config, _ = _configs()
    del config["autoencoder"]
    nnet, _ = _port_parts(config)
    path = tmp_path / "nnet_ema.pth"
    params = convert_uvit({k: v.numpy() for k, v in nnet.state_dict().items()}, depth=4,
                          num_classes=11)
    save_torch_state_dict(export_uvit(params, patch_size=2), str(path))
    pipe = GenerationPipeline.from_config(config, nnet_path=str(path), device="cpu")
    for k, v in pipe.nnet.state_dict().items():
        torch.testing.assert_close(v, nnet.state_dict()[k], rtol=0, atol=0)
    latents = pipe.generate(labels=[1, 2], steps=3, seed=1)
    assert latents.shape == (2, 8, 8, 4) and np.isfinite(latents).all()
    np.testing.assert_array_equal(latents, pipe.generate(labels=[1, 2], steps=3, seed=1))
    # n= alone: samples of the null class num_classes - 1
    np.testing.assert_array_equal(pipe.generate(n=2, steps=3, seed=1),
                                  pipe.generate(labels=[10, 10], steps=3, seed=1))
    outs = list(pipe.generate_batches([{"labels": [4]}, {"n": 3}], steps=2))
    assert [o.shape[0] for o in outs] == [1, 3]
    with pytest.raises(ValueError, match="labels"):
        pipe.generate(contexts=np.zeros((1, 77, 768), np.float32), steps=2)
    t2i = GenerationPipeline(get_config("synthetic_tiny"), get_nnet(
        **dict(get_config("synthetic_tiny").nnet)), device="cpu")
    with pytest.raises(ValueError, match="class-conditional"):
        t2i.generate(labels=[1], steps=2)
