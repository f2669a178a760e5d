"""The port's LayerNorm + qkv + attention and its A/B chain against the JAX
package's.

`fused_ln_qkv_attention_plain` (what the Hopper kernels are held to on the
card) must equal the JAX Pallas kernel run with interpret=True, at the JAX
test's size (B2, L16, C64, H4) and at a ragged L = 37, on the same numpy
inputs: f32 rtol 1e-5 / atol 1e-6 (same arithmetic, another summation
order); bf16 relative deviation < 1e-3 (the same rounding points, xn and
qkv in bf16, P in bf16 for PV, but a value next to a bf16 rounding boundary
may round either way after another summation order; measured 0).

The port's A/B chain (`scripts/bench_fused_ln.py` of the port, both arms,
DEPTH = 2, L = 18, C = 64, H = 4, bf16) must equal the JAX chain, restated
here from the JAX package's own kernels (interpret mode), on the same numpy
weights: relative deviation < 5e-3 (two bf16 blocks with residuals, erf-GELU
and three more bf16 GEMMs each, where both frameworks round at the same
places but may land on neighbouring bf16 values; measured 1.2e-3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panopticdiffusionmodels_tpu.ops.pallas.fused_ln_qkv_attention import (
    fused_ln_qkv_attention as jax_fused_ln,
)
from panopticdiffusionmodels_tpu.ops.pallas.fused_qkv_attention import fused_attention_qkv
from panopticdiffusionmodels_torch.ops.kernels import build
from panopticdiffusionmodels_torch.ops.kernels import fused_ln_qkv_attention as port_kernel
from panopticdiffusionmodels_torch.scripts import bench_fused_ln as port_chain

torch.set_num_threads(1)


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _inputs(b, l, c, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, c)).astype(np.float32)
    s = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    w = (0.1 * rng.standard_normal((c, 3 * c))).astype(np.float32)
    return x, s, bias, w


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,l,c,h", [(2, 16, 64, 4), (2, 37, 64, 4)])
def test_plain_matches_jax_kernel(b, l, c, h, dtype):
    x, s, bias, w = _inputs(b, l, c, seed=l)
    scale = (c // h) ** -0.5
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = jax_fused_ln(jnp.asarray(x).astype(jdt), jnp.asarray(s), jnp.asarray(bias),
                       jnp.asarray(w).astype(jdt), h, scale, interpret=True)
    for fn in (port_kernel.fused_ln_qkv_attention, port_kernel.fused_ln_qkv_attention_plain):
        out = fn(torch.from_numpy(x).to(tdt), torch.from_numpy(s), torch.from_numpy(bias),
                 torch.from_numpy(w).to(tdt), h, scale)
        assert out.dtype == tdt and out.shape == (b, l, c)
        ref32 = np.asarray(ref.astype(jnp.float32))
        if dtype == "float32":
            np.testing.assert_allclose(out.numpy(), ref32, rtol=1e-5, atol=1e-6)
        else:
            assert _rel(out.float().numpy(), ref32) < 1e-3


def test_wrapper_refuses_what_the_kernel_does_not_take():
    x, s, bias, w = (torch.from_numpy(a) for a in _inputs(1, 1025, 32, seed=0))
    with pytest.raises(ValueError, match="L=1025"):
        port_kernel.fused_ln_qkv_attention(x, s, bias, w, 4, 0.35)
    x = x[:, :16]
    with pytest.raises(NotImplementedError, match="qkv bias"):
        port_kernel.fused_ln_qkv_attention(x, s, bias, w, 4, 0.35, qkv_bias=torch.zeros(96))
    meta = x.to("meta").requires_grad_()
    with pytest.raises(RuntimeError, match="inference only"):
        port_kernel.fused_ln_qkv_attention(meta, s, bias, w.to("meta"), 4, 0.35)
    with torch.no_grad(), pytest.raises(ValueError, match="no kernel"):
        port_kernel.fused_ln_qkv_attention(meta, s, bias, w.to("meta"), 4, 0.35)
    port_kernel.launches = 0
    port_kernel.fused_ln_qkv_attention(x, s, bias, w, 4, 0.35)
    assert port_kernel.launches == 0
    assert port_kernel.NAME in build.KERNELS and (build.CSRC / f"{port_kernel.NAME}.cu").exists()


def _jax_layernorm(x, s, b, eps=1e-5):
    xf = x.astype(jnp.float32)
    mu = jnp.mean(xf, axis=-1, keepdims=True)
    var = jnp.mean(jnp.square(xf - mu), axis=-1, keepdims=True)
    return ((xf - mu) * jax.lax.rsqrt(var + eps) * s + b).astype(x.dtype)


def _jax_chain(weights, x, variant, heads):
    """The block of `scripts/bench_fused_ln.py` (its `chain`), unrolled."""
    scale = (x.shape[-1] // heads) ** -0.5
    for i in range(weights["w_qkv"].shape[0]):
        w = {k: v[i] for k, v in weights.items()}
        if variant == "fused":
            a = jax_fused_ln(x, w["ln1_s"], w["ln1_b"], w["w_qkv"], heads, scale,
                             interpret=True)
        else:
            xn = _jax_layernorm(x, w["ln1_s"], w["ln1_b"])
            a = fused_attention_qkv(xn @ w["w_qkv"], heads, scale, interpret=True)
        x = x + a @ w["w_proj"] + w["b_proj"]
        h = _jax_layernorm(x, w["ln2_s"], w["ln2_b"])
        h = jax.nn.gelu(h @ w["w1"] + w["b1"], approximate=False)
        x = x + h @ w["w2"] + w["b2"]
    return x


def test_chain_matches_jax_chain():
    depth, l, c, h = 2, 18, 64, 4
    weights = port_chain.make_weights(3, depth=depth, c=c)
    blocks = port_chain.load_weights(weights, device="cpu")
    jweights = {k: jnp.asarray(v).astype(jnp.float32 if k in port_chain.F32_KEYS
                                          else jnp.bfloat16) for k, v in weights.items()}
    x = (0.5 * np.random.default_rng(1).standard_normal((2, l, c))).astype(np.float32)
    outs = {}
    for variant in port_chain.VARIANTS:
        ref = _jax_chain(jweights, jnp.asarray(x).astype(jnp.bfloat16), variant, h)
        out = port_chain.chain(blocks, torch.from_numpy(x).to(torch.bfloat16), variant, h)
        assert out.dtype == torch.bfloat16 and out.shape == (2, l, c)
        outs[variant] = out.float().numpy()
        assert _rel(outs[variant], ref.astype(jnp.float32)) < 5e-3, variant
    assert _rel(outs["fused"], outs["shipped"]) < 5e-3
