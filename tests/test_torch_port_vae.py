"""The port's AutoencoderKL and its weight carry against the JAX package's.

A small seeded VAE (ch 32, ch_mult (1, 2), one res block) is brought into the
JAX layout by the JAX package's `convert_autoencoder_kl`; the port's carry must
reproduce those params through the same converter, and `decode` /
`encode_moments` must match at f32 rtol 1e-4 / atol 1e-5 (NHWC <-> NCHW at
the boundary).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panopticdiffusionmodels_tpu.models.vae import AutoencoderKL as JaxAutoencoderKL
from panopticdiffusionmodels_tpu.utils.torch_bridge import convert_autoencoder_kl
from panopticdiffusionmodels_torch.models.vae import AutoencoderKL
from panopticdiffusionmodels_torch.utils.weights import autoencoder_kl_state_dict, to_tensors

torch.set_num_threads(1)

GEOM = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=4, embed_dim=4, out_ch=3,
            scale_factor=0.2301)


@functools.lru_cache(maxsize=None)
def models():
    torch.manual_seed(3)
    seed_vae = AutoencoderKL(**GEOM)
    with torch.no_grad():  # non-trivial GroupNorm affines
        for name, p in seed_vae.named_parameters():
            if "norm" in name:
                p.add_(torch.randn_like(p) * 0.1)
    sd = {k: v.numpy() for k, v in seed_vae.state_dict().items()}
    params = convert_autoencoder_kl(sd, ch_mult=GEOM["ch_mult"],
                                    num_res_blocks=GEOM["num_res_blocks"])
    vae = AutoencoderKL(**GEOM).eval()
    vae.load_state_dict(to_tensors(autoencoder_kl_state_dict(
        params, ch_mult=GEOM["ch_mult"], num_res_blocks=GEOM["num_res_blocks"])), strict=True)
    return JaxAutoencoderKL(**GEOM), params, vae


@pytest.mark.parametrize("method", ["decode", "encode_moments"])
def test_vae_matches_jax(method):
    jvae, params, vae = models()
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 8, 8, 4) if method == "decode" else (2, 16, 16, 3))
    x = x.astype(np.float32)
    ref = jax.jit(functools.partial(jvae.apply, method=method))(params, jnp.asarray(x))
    with torch.no_grad():
        out = getattr(vae, method)(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), np.asarray(ref),
                               rtol=1e-4, atol=1e-5)


def test_vae_carry_round_trips_through_jax_converter():
    _, params, _ = models()
    carried = autoencoder_kl_state_dict(params, ch_mult=GEOM["ch_mult"],
                                        num_res_blocks=GEOM["num_res_blocks"])
    back = convert_autoencoder_kl(carried, ch_mult=GEOM["ch_mult"],
                                  num_res_blocks=GEOM["num_res_blocks"])
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), np.asarray(a), err_msg=str(path))


def test_full_vae_names_match_the_jax_converter():
    """Every key the JAX converter reads from an SD autoencoder_kl.pth is a
    parameter of the port's full-size VAE, and nothing else is."""
    sd = {k: v.numpy() for k, v in AutoencoderKL().state_dict().items()}
    read = set()

    class Spy(dict):
        def __getitem__(self, k):
            read.add(k)
            return dict.__getitem__(self, k)

    convert_autoencoder_kl(Spy(sd))
    assert read == set(sd)
