"""The port's (B, H, L, D) attention against the JAX package's.

`attention_plain` (what the Hopper `fused_attention` kernel is held to on the
card) and `multi_head_attention` under every impl key must equal the JAX
`fused_attention` (its Pallas kernel run in TPU interpret mode) and the JAX
`multi_head_attention`, on the same numpy inputs, at L = 37, 258 and one L
past MAX_FULL_SEQ (where both take the XLA-style path), D = 40, 64, 72.
Tolerances: f32 rtol 1e-5 / atol 1e-6 (same math, another summation order);
bf16 relative deviation < 1e-3 (the same f32 arithmetic and bf16 rounding
points on both sides, but an output next to a bf16 rounding boundary may
round either way after another summation order; measured <= 6e-5).  The
gradient of the trainable kernel route (f32 recompute VJP) against
`jax.grad` of `fused_attention`: f32 rtol 1e-4 / atol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from panopticdiffusionmodels_tpu.ops.attention import multi_head_attention as jax_mha
from panopticdiffusionmodels_tpu.ops.pallas.fused_attention import fused_attention as jax_fused
from panopticdiffusionmodels_torch.ops import attention as port_attention
from panopticdiffusionmodels_torch.ops.kernels import build
from panopticdiffusionmodels_torch.ops.kernels import fused_attention as port_kernel

torch.set_num_threads(1)

SHAPES = [(1, 2, l, d) for l in (37, 258) for d in (40, 64, 72)] + [(1, 2, 1030, 8)]
# port impl key -> the JAX impl key it must equal
IMPLS = {"auto": "auto", "infer": "infer", "xla": "xla", "plain": "xla",
         "pallas": "pallas", "kernel": "pallas"}


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(shape) * 0.7).astype(np.float32) for _ in range(3)]


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _jax(fn, *args):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(jnp.asarray(fn(*args), jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_every_impl_matches_jax(shape, dtype):
    q, k, v = _qkv(shape, seed=shape[2] + shape[3])
    scale = shape[-1] ** -0.5
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in (q, k, v))
    refs = {"fused": _jax(jax_fused, jq, jk, jv, scale)}
    refs.update({key: _jax(lambda *a, key=key: jax_mha(*a, impl=key), jq, jk, jv)
                 for key in ("auto", "infer", "xla", "pallas")})
    outs = {"fused": port_kernel.attention_plain(tq, tk, tv, scale)}
    outs.update({key: port_attention.multi_head_attention(tq, tk, tv, impl=key)
                 for key in IMPLS})
    for key, out in outs.items():
        assert out.dtype == tdt and out.shape == shape, key
        ref = refs[IMPLS.get(key, key)]
        if dtype == "float32":
            np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-6, err_msg=key)
        else:
            assert _rel(out.float().numpy(), ref) < 1e-3, key


@pytest.mark.parametrize("shape", [(2, 2, 37, 40), (1, 2, 258, 64)])
def test_kernel_route_gradient_matches_jax_grad(shape):
    q, k, v = _qkv(shape, seed=5)
    g = np.random.default_rng(6).standard_normal(shape).astype(np.float32)
    scale = shape[-1] ** -0.5

    def loss(a, b, c):
        return jnp.sum(jax_fused(a, b, c, scale) * g)

    with pltpu.force_tpu_interpret_mode():
        ref = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    for impl in ("pallas", "kernel"):
        out = port_attention.multi_head_attention(tq, tk, tv, impl=impl)
        grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
        for name, a, r in zip("qkv", grads, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=1e-4, atol=1e-5,
                                       err_msg=f"{impl} d{name}")


def test_wrapper_takes_plain_path_on_cpu_and_refuses_others():
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkv((2, 2, 19, 16), seed=1))
    port_kernel.launches = 0
    assert torch.equal(port_kernel.fused_attention(q, k, v, 0.25),
                       port_kernel.attention_plain(q, k, v, 0.25))
    assert port_kernel.launches == 0
    meta = torch.empty((2, 2, 19, 16), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        port_kernel.fused_attention(meta, meta, meta, 0.25)
    needs_grad = meta.clone().requires_grad_()
    with pytest.raises(RuntimeError, match="impl='pallas'"):
        port_kernel.fused_attention(needs_grad, meta, meta, 0.25)
    with pytest.raises(ValueError, match="unknown attention impl"):
        port_attention.multi_head_attention(q, k, v, impl="flash")


def test_build_lists_the_kernel():
    assert port_kernel.NAME in build.KERNELS
    assert (build.CSRC / f"{port_kernel.NAME}.cu").exists()
    assert port_kernel.MAX_FULL_SEQ == 1024
