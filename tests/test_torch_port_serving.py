"""The port's whole serving slice against the JAX package's pipeline.

A tiny config (synthetic_tiny: UViT-T2I width 32, depth 4; CFG 1.0) with a
small VAE runs through the JAX `GenerationPipeline._pipeline` and through the
port's `GenerationPipeline.sample` on the same weights and the same JAX-drawn
(z, m0).  Images must match at atol 1e-4, and panoptic ids wherever the mask
prediction is clear of the threshold (|pred_mask| > 1e-3).
"""
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
    convert_uvit_t2i,
    export_uvit_t2i,
    save_torch_state_dict,
)
from panopticdiffusionmodels_torch.configs import get_config
from panopticdiffusionmodels_torch.models import get_nnet
from panopticdiffusionmodels_torch.models.vae import AutoencoderKL
from panopticdiffusionmodels_torch.serving import GenerationPipeline

VAE_GEOM = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, scale_factor=0.2301)


def _port_parts(config):
    torch.manual_seed(0)
    kw = dict(config.nnet)
    nnet = get_nnet(kw.pop("name"), **kw)
    with torch.no_grad():
        for name, p in nnet.named_parameters():
            if name.startswith("zero_convs"):
                p.normal_(0, 0.02)
    return nnet, AutoencoderKL(**VAE_GEOM)


def test_whole_slice_matches_jax_pipeline():
    config = get_config("synthetic_tiny")
    nnet, vae = _port_parts(config)
    rng = np.random.default_rng(4)
    ctx = rng.standard_normal((2, 7, 16)).astype(np.float32)
    empty = rng.standard_normal((7, 16)).astype(np.float32)

    jconfig = jax_get_config("synthetic_tiny")
    params = convert_uvit_t2i({k: v.numpy() for k, v in nnet.state_dict().items()},
                              depth=config.nnet.depth)
    vae_params = convert_autoencoder_kl({k: v.numpy() for k, v in vae.state_dict().items()},
                                        ch_mult=VAE_GEOM["ch_mult"], num_res_blocks=1)
    jpipe = JaxPipeline(jconfig, params, vae_params, empty)
    jpipe.vae = JaxAutoencoderKL(**VAE_GEOM)
    key = jax.random.PRNGKey(3)
    jimages, jmask = jpipe._pipeline(2, 6)(params, vae_params, key, jnp.asarray(ctx))
    jimages01, jids = jpipe._postprocess((jimages, jmask))

    # the JAX pipeline's own draws (serving.py: split, z from k1, m0 from k2)
    k1, k2 = jax.random.split(key)
    z = np.array(jax.random.normal(k1, (2, 8, 8, 4)))
    m0 = np.array(jax.random.normal(k2, (2, 16, 16, 8)))

    pipe = GenerationPipeline(config, nnet, vae, empty, device="cpu")
    images, pred_mask = pipe.sample(torch.from_numpy(z).permute(0, 3, 1, 2),
                                    torch.from_numpy(m0).permute(0, 3, 1, 2),
                                    torch.from_numpy(ctx), steps=6)
    images01, ids = pipe._postprocess(images, pred_mask)
    assert images01.shape == jimages01.shape == (2, 16, 16, 3)
    np.testing.assert_allclose(images01, jimages01, atol=1e-4)
    assert ids.shape == jids.shape == (2, 16, 16, 1) and ids.dtype == np.int32
    clear = np.all(np.abs(np.asarray(jmask)) > 1e-3, axis=-1, keepdims=True)
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(ids[clear], np.asarray(jids)[clear])


def test_generate_and_batches_on_cpu():
    config = get_config("synthetic_tiny")
    nnet, vae = _port_parts(config)
    pipe = GenerationPipeline(config, nnet, vae, device="cpu")
    ctxs = [np.random.default_rng(i).standard_normal((2, 7, 16)).astype(np.float32)
            for i in range(2)]
    images, ids = pipe.generate(contexts=ctxs[0], steps=3, seed=1)
    assert images.shape == (2, 16, 16, 3) and ids.shape == (2, 16, 16, 1)
    assert np.isfinite(images).all() and images.min() >= 0 and images.max() <= 1
    again, _ = pipe.generate(contexts=ctxs[0], steps=3, seed=1)
    np.testing.assert_array_equal(images, again)
    outs = list(pipe.generate_batches([{"contexts": c} for c in ctxs], steps=3, seed=1))
    assert len(outs) == 2 and not np.array_equal(outs[0][0], images)
    with pytest.raises(ValueError, match="clip_path"):
        pipe.generate(prompts=["a bus"], steps=3)


def test_from_config_loads_reference_pth(tmp_path):
    """A reference-format .pth (JAX export plus the reference's unused
    even-index zero convs) loads strictly through from_config(nnet_path=)."""
    config = get_config("synthetic_tiny")
    del config["autoencoder"]
    nnet, _ = _port_parts(config)
    params = convert_uvit_t2i({k: v.numpy() for k, v in nnet.state_dict().items()}, depth=4)
    sd = export_uvit_t2i(params, patch_size=2, mask_patch_size=4)
    sd.update({f"zero_convs.{2 * i}.conv.{n}": np.zeros(s, np.float32)
               for i in range(5) for n, s in (("weight", (32, 32, 1)), ("bias", (32,)))})
    path = tmp_path / "nnet_ema.pth"
    save_torch_state_dict(sd, str(path))
    pipe = GenerationPipeline.from_config(config, nnet_path=str(path), device="cpu")
    loaded = pipe.nnet.state_dict()
    assert len(loaded) == len(sd) - 10
    for k, v in loaded.items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)
    with pytest.raises(FileNotFoundError, match="nnet_path"):
        GenerationPipeline.from_config(config, nnet_path=str(tmp_path / "nope.pth"),
                                       device="cpu")


def test_entry_points_default_to_the_card():
    import inspect

    for fn in (GenerationPipeline.__init__, GenerationPipeline.from_config):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
