"""The serving slice with the speed modes on, against the JAX package's pipeline.

Tiny configs (imagenet256_uvit_large cut to width 32, depth 4, 11 classes,
latent 8x8x4; synthetic_tiny for the panoptic model), f32, a small VAE: the
JAX `GenerationPipeline._pipeline` and the port's `GenerationPipeline.sample`
run the same weights on the same JAX-drawn noise with `sample.accel`,
`sample.cfg_interval` and (panoptic) the mask-guidance hold.  Images must
match at atol 1e-4 and panoptic ids wherever the mask prediction is clear of
the threshold (|pred_mask| > 1e-3), the bars of the exact-protocol serving
tests.  `check_speed_modes` runs once per distinct set of knobs.
"""
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panopticdiffusionmodels_tpu.configs import get_config as jax_get_config
from panopticdiffusionmodels_tpu.models.vae import AutoencoderKL as JaxAutoencoderKL
from panopticdiffusionmodels_tpu.serving import GenerationPipeline as JaxPipeline
from panopticdiffusionmodels_tpu.utils.torch_bridge import (
    convert_autoencoder_kl,
    convert_uvit,
    convert_uvit_t2i,
)
from panopticdiffusionmodels_torch.configs import get_config
from panopticdiffusionmodels_torch.models import get_nnet
from panopticdiffusionmodels_torch.models.vae import AutoencoderKL
from panopticdiffusionmodels_torch.serving import GenerationPipeline

VAE_GEOM = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, scale_factor=0.18215)
NNET = dict(img_size=8, embed_dim=32, depth=4, num_heads=4, num_classes=11)
STEPS = 17  # the first step count at which accel 0.2 skips (15 real evals)


def _vae_params(vae):
    return convert_autoencoder_kl({k: v.numpy() for k, v in vae.state_dict().items()},
                                  ch_mult=VAE_GEOM["ch_mult"], num_res_blocks=1)


def _knobs(configs, accel, interval):
    for c in configs:
        c.sample.accel = accel
        c.sample.cfg_interval = interval


@pytest.mark.parametrize("accel,interval", [(0.2, ()), (0.2, (0.5, 1.0))])
def test_class_cond_speed_modes_match_jax(accel, interval):
    config, jconfig = get_config("imagenet256_uvit_large"), jax_get_config("imagenet256_uvit_large")
    for c in (config, jconfig):
        c.nnet.update(NNET)
        c.z_shape = (8, 8, 4)
        c.compute_dtype = "float32"
    _knobs((config, jconfig), accel, interval)
    torch.manual_seed(0)
    kw = dict(config.nnet)
    nnet, vae = get_nnet(kw.pop("name"), **kw), AutoencoderKL(**VAE_GEOM)
    params = convert_uvit({k: v.numpy() for k, v in nnet.state_dict().items()}, depth=4,
                          num_classes=11, scan_blocks=True)
    vae_params = _vae_params(vae)
    jpipe = JaxPipeline(jconfig, params, vae_params)
    jpipe.vae = JaxAutoencoderKL(**VAE_GEOM)
    labels = np.array([3, 10, 0], np.int32)
    key = jax.random.PRNGKey(5)
    jimages = jpipe._postprocess(jpipe._pipeline(3, STEPS)(params, vae_params, key,
                                                           jnp.asarray(labels)))
    z = np.array(jax.random.normal(key, (3, 8, 8, 4)))

    pipe = GenerationPipeline(config, nnet, vae, device="cpu")
    images, _ = pipe.sample(torch.from_numpy(z).permute(0, 3, 1, 2), None,
                            torch.from_numpy(labels).long(), steps=STEPS)
    np.testing.assert_allclose(pipe._postprocess(images, None), jimages, atol=1e-4)
    assert pipe.last_real_evals < STEPS


@pytest.mark.parametrize("accel,interval,hold", [
    (0.2, (0.5, 1.0), True), (0.0, (0.0, 0.5), True)])
def test_panoptic_speed_modes_match_jax(accel, interval, hold, caplog):
    config, jconfig = get_config("synthetic_tiny"), jax_get_config("synthetic_tiny")
    _knobs((config, jconfig), accel, interval)
    for c in (config, jconfig):
        c.sample.cfg_interval_mask_hold = hold
    torch.manual_seed(0)
    kw = dict(config.nnet)
    nnet = get_nnet(kw.pop("name"), **kw)
    with torch.no_grad():
        for name, p in nnet.named_parameters():
            if name.startswith("zero_convs"):
                p.normal_(0, 0.02)
    vae = AutoencoderKL(**dict(VAE_GEOM, scale_factor=0.2301))
    rng = np.random.default_rng(4)
    ctx = rng.standard_normal((2, 7, 16)).astype(np.float32)
    empty = rng.standard_normal((7, 16)).astype(np.float32)
    params = convert_uvit_t2i({k: v.numpy() for k, v in nnet.state_dict().items()},
                              depth=config.nnet.depth)
    vae_params = _vae_params(vae)
    jpipe = JaxPipeline(jconfig, params, vae_params, empty)
    jpipe.vae = JaxAutoencoderKL(**dict(VAE_GEOM, scale_factor=0.2301))
    key = jax.random.PRNGKey(3)
    jimages, jmask = jpipe._pipeline(2, STEPS)(params, vae_params, key, jnp.asarray(ctx))
    jimages01, jids = jpipe._postprocess((jimages, jmask))
    k1, k2 = jax.random.split(key)
    z = np.array(jax.random.normal(k1, (2, 8, 8, 4)))
    m0 = np.array(jax.random.normal(k2, (2, 16, 16, 8)))

    pipe = GenerationPipeline(config, nnet, vae, empty, device="cpu")
    with caplog.at_level(logging.WARNING, logger="panopticdiffusionmodels_torch"):
        for _ in range(2):  # the second request with the same knobs: no new warning
            images, pred_mask = pipe.sample(torch.from_numpy(z).permute(0, 3, 1, 2),
                                            torch.from_numpy(m0).permute(0, 3, 1, 2),
                                            torch.from_numpy(ctx), steps=STEPS)
    warned = [r for r in caplog.records if r.name.startswith("panopticdiffusionmodels_torch")
              and "NO measured deviation entry" in r.getMessage()]
    assert len(warned) == 1
    images01, ids = pipe._postprocess(images, pred_mask)
    np.testing.assert_allclose(images01, jimages01, atol=1e-4)
    clear = np.all(np.abs(np.asarray(jmask)) > 1e-3, axis=-1, keepdims=True)
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(ids[clear], np.asarray(jids)[clear])
