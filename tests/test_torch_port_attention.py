"""The port's packed-qkv attention against the JAX package's.

The port's plain version (what the Hopper kernel is held to on the card) must
equal the Pallas kernel run in interpret mode and the XLA path, on the same
numpy inputs, at small head dims and at the wgmma loop's 64 and 72 (U-ViT-H).
Tolerances: f32 rtol 1e-5 / atol 1e-6 (same math, different summation
order); bf16 relative deviation < 1e-2 (both sides round operands and P to
bf16, at different places).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panopticdiffusionmodels_tpu.ops.attention import _xla_attention_qkv
from panopticdiffusionmodels_tpu.ops.pallas.fused_qkv_attention import fused_attention_qkv
from panopticdiffusionmodels_torch.ops import attention as port_attention
from panopticdiffusionmodels_torch.ops.kernels import build
from panopticdiffusionmodels_torch.ops.kernels import fused_qkv_attention as port_kernel

# The wgmma loop's head dims on the card, U-ViT-H's 72 and 64, at ragged L.
WGMMA_SHAPES = [(2, l, 2, d) for l in (37, 65) for d in (64, 72)]
SHAPES = [(2, l, h, d) for l in (18, 37) for h in (2, 4) for d in (8, 16)] + WGMMA_SHAPES


def _qkv(b, l, h, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, l, 3 * h * d)) * 0.7).astype(np.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("b,l,h,d", SHAPES)
def test_plain_matches_jax_f32(b, l, h, d):
    x = _qkv(b, l, h, d, seed=l * 10 + h + d)
    scale = d ** -0.5
    ours = port_attention.attention_qkv(torch.from_numpy(x), h, impl="plain").numpy()
    pallas = np.asarray(fused_attention_qkv(jnp.asarray(x), h, scale, interpret=True))
    xla = np.asarray(_xla_attention_qkv(jnp.asarray(x), h, scale))
    np.testing.assert_allclose(ours, pallas, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ours, xla, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("b,l,h,d", SHAPES)
def test_plain_matches_jax_bf16(b, l, h, d):
    x = _qkv(b, l, h, d, seed=l * 7 + h + d)
    scale = d ** -0.5
    xt = torch.from_numpy(x).to(torch.bfloat16)
    ours = port_attention.attention_qkv(xt, h, impl="plain")
    assert ours.dtype == torch.bfloat16
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    pallas = fused_attention_qkv(xj, h, scale, interpret=True).astype(jnp.float32)
    xla = _xla_attention_qkv(xj, h, scale).astype(jnp.float32)
    assert _rel(ours.float().numpy(), pallas) < 1e-2
    assert _rel(ours.float().numpy(), xla) < 1e-2


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
@pytest.mark.parametrize("b,l,h,d", WGMMA_SHAPES)
def test_plain_with_lse_matches_jax(b, l, h, d, dtype):
    """The forward with its lse output (what kernel 2 reads): out against
    the Pallas kernel in interpret mode, lse against JAX's logsumexp of the
    scaled scores, at the file's bars (bf16: relative deviation < 1e-2)."""
    x = _qkv(b, l, h, d, seed=l * 5 + h + d)
    scale = d ** -0.5
    xj = jnp.asarray(x).astype(dtype)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
        torch.float32 if dtype == np.float32 else torch.bfloat16)
    out, lse = port_kernel.attention_qkv_plain(xt, h, scale, with_lse=True)
    assert lse.shape == (b, h, l) and lse.dtype == torch.float32
    pallas = np.asarray(fused_attention_qkv(xj, h, scale, interpret=True).astype(jnp.float32))
    q, k = (xj.astype(jnp.float32).reshape(b, l, 3, h, d)[:, :, i] for i in (0, 1))
    scores = jnp.einsum("bqhd,bkhd->bhqk", q, k, precision="highest") * scale
    lse_jax = np.asarray(jax.nn.logsumexp(scores, axis=-1))
    if dtype == np.float32:
        np.testing.assert_allclose(out.numpy(), pallas, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(lse.numpy(), lse_jax, rtol=1e-5, atol=1e-6)
    else:
        assert _rel(out.float().numpy(), pallas) < 1e-2
        assert _rel(lse.numpy(), lse_jax) < 1e-2


def test_wrapper_takes_plain_path_on_cpu():
    x = torch.from_numpy(_qkv(2, 37, 4, 16, seed=3)).to(torch.bfloat16)
    port_kernel.launches = 0
    for impl in ("infer", "kernel"):
        out = port_attention.attention_qkv(x, 4, impl=impl)
        ref = port_kernel.attention_qkv_plain(x, 4, 16 ** -0.5)
        assert torch.equal(out, ref)
    assert port_kernel.launches == 0


def test_wrapper_refuses_other_devices():
    x = torch.empty((2, 18, 48), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        port_kernel.fused_attention_qkv(x, 2, 0.25)


def test_build_command_targets_hopper():
    flags = " ".join(build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "-shared" in flags
    lib = build.library_path(port_kernel.NAME)
    assert lib.parent == build.BUILD_DIR and lib.name.startswith("libfused_qkv_attention-")
    assert (build.CSRC / f"{port_kernel.NAME}.cu").exists()
