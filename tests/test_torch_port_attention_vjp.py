"""The port's attention backward against the JAX package's.

`attention_qkv_vjp_plain` (what the Hopper backward kernel is held to on the
card) must equal the Pallas `fused_attention_qkv_vjp` run in interpret mode
and `jax.vjp` of the XLA path, on the same numpy qkv and cotangent: f32 at
rtol / atol 3e-5 (the bar of `tests/test_attention.py` for the JAX kernel),
bf16 at relative deviation < 1e-2.  The trainable dispatch
(`impl='auto'` / `'pallas_vjp'`, a `torch.autograd.Function`) runs the plain
forward and backward on CPU tensors, so its wiring is checked here; the
forward-only kernel route refuses a tensor that needs a gradient.
"""
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panopticdiffusionmodels_tpu.ops.attention import _xla_attention_qkv
from panopticdiffusionmodels_tpu.ops.pallas.fused_qkv_attention import fused_attention_qkv_vjp
from panopticdiffusionmodels_torch.ops import attention as port_attention
from panopticdiffusionmodels_torch.ops.kernels import build
from panopticdiffusionmodels_torch.ops.kernels import fused_qkv_attention as port_kernel

# Small head dims, then the wgmma kernels' head dims on the card, U-ViT-H's
# 72 and 64, at ragged L.
SHAPES = [(2, l, h, d) for l in (18, 37) for h in (2, 4) for d in (8, 16)] + [
    (2, l, 2, d) for l in (37, 65) for d in (64, 72)]


def _inputs(b, l, h, d, seed):
    rng = np.random.default_rng(seed)
    qkv = (rng.standard_normal((b, l, 3 * h * d)) * 0.7).astype(np.float32)
    g = rng.standard_normal((b, l, h * d)).astype(np.float32)
    return qkv, g


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@functools.partial(jax.jit, static_argnums=(2, 3))
def _jax_refs(qkv, g, h, scale):
    pallas = fused_attention_qkv_vjp(qkv, g, h, scale, interpret=True)
    _, vjp = jax.vjp(lambda x: _xla_attention_qkv(x, h, scale), qkv)
    return pallas, vjp(g)[0]


@pytest.mark.parametrize("b,l,h,d", SHAPES)
def test_vjp_plain_matches_jax_f32(b, l, h, d):
    qkv, g = _inputs(b, l, h, d, seed=l * 11 + h + d)
    scale = d ** -0.5
    ours = port_kernel.attention_qkv_vjp_plain(torch.from_numpy(qkv), torch.from_numpy(g), h,
                                               scale).numpy()
    for ref in _jax_refs(jnp.asarray(qkv), jnp.asarray(g), h, scale):
        np.testing.assert_allclose(ours, np.asarray(ref), rtol=3e-5, atol=3e-5)


@pytest.mark.parametrize("b,l,h,d", SHAPES)
def test_vjp_plain_matches_jax_bf16(b, l, h, d):
    qkv, g = _inputs(b, l, h, d, seed=l * 13 + h + d)
    scale = d ** -0.5
    ours = port_kernel.attention_qkv_vjp_plain(torch.from_numpy(qkv).to(torch.bfloat16),
                                               torch.from_numpy(g).to(torch.bfloat16), h, scale)
    assert ours.dtype == torch.bfloat16
    refs = _jax_refs(jnp.asarray(qkv).astype(jnp.bfloat16), jnp.asarray(g).astype(jnp.bfloat16),
                     h, scale)
    for ref in refs:
        assert _rel(ours.float().numpy(), ref.astype(jnp.float32)) < 1e-2


def _lse_plain(qkv, g, h, scale):
    """`attention_qkv_vjp_lse_plain` on the plain forward's out and lse."""
    qkv, g = torch.from_numpy(qkv), torch.from_numpy(g)
    return qkv, g, port_kernel.attention_qkv_plain(qkv, h, scale, with_lse=True)


@pytest.mark.parametrize("b,l,h,d", SHAPES)
def test_vjp_lse_plain_matches_jax_f32(b, l, h, d):
    """The backward kernel's own decomposition (P from lse, delta from out)
    equals the JAX kernel and `attention_qkv_vjp_plain` at the f32 bar."""
    qkv, g = _inputs(b, l, h, d, seed=l * 17 + h + d)
    scale = d ** -0.5
    x, gt, (out, lse) = _lse_plain(qkv, g, h, scale)
    ours = port_kernel.attention_qkv_vjp_lse_plain(x, gt, out, lse, h, scale).numpy()
    refs = (*_jax_refs(jnp.asarray(qkv), jnp.asarray(g), h, scale),
            port_kernel.attention_qkv_vjp_plain(x, gt, h, scale).numpy())
    for ref in refs:
        np.testing.assert_allclose(ours, np.asarray(ref), rtol=3e-5, atol=3e-5)


@pytest.mark.parametrize("b,l,h,d", SHAPES)
def test_vjp_lse_plain_matches_jax_bf16(b, l, h, d):
    qkv, g = _inputs(b, l, h, d, seed=l * 19 + h + d)
    scale = d ** -0.5
    x, gt = (torch.from_numpy(t).to(torch.bfloat16) for t in (qkv, g))
    out, lse = port_kernel.attention_qkv_plain(x, h, scale, with_lse=True)
    assert out.dtype == torch.bfloat16  # delta is taken from the stored bf16 out
    ours = port_kernel.attention_qkv_vjp_lse_plain(x, gt, out, lse, h, scale)
    assert ours.dtype == torch.bfloat16
    refs = (*_jax_refs(jnp.asarray(qkv).astype(jnp.bfloat16),
                       jnp.asarray(g).astype(jnp.bfloat16), h, scale),
            port_kernel.attention_qkv_vjp_plain(x, gt, h, scale).float().numpy())
    for ref in refs:
        assert _rel(ours.float().numpy(), np.asarray(ref, np.float32)) < 1e-2


def test_function_gradcheck_float64():
    x = torch.from_numpy(_inputs(2, 9, 2, 4, seed=1)[0].astype(np.float64)).requires_grad_()
    assert torch.autograd.gradcheck(lambda t: port_attention.attention_qkv(t, 2, impl="auto"),
                                    (x,))


def test_plain_lse_is_logsumexp():
    x = torch.from_numpy(_inputs(2, 37, 4, 16, seed=2)[0])
    scale = 16 ** -0.5
    out, lse = port_kernel.attention_qkv_plain(x, 4, scale, with_lse=True)
    q, k, _ = x.reshape(2, 37, 3, 4, 16).permute(2, 0, 3, 1, 4)
    ref = torch.logsumexp(q @ k.transpose(-1, -2) * scale, dim=-1)
    assert lse.shape == (2, 4, 37) and lse.dtype == torch.float32
    torch.testing.assert_close(lse, ref, rtol=1e-6, atol=1e-6)
    assert torch.equal(out, port_kernel.attention_qkv_plain(x, 4, scale))


@pytest.mark.parametrize("impl", ["auto", "pallas_vjp"])
def test_trainable_impls_run_the_function_on_cpu(impl):
    qkv, g = _inputs(2, 37, 4, 16, seed=3)
    x = torch.from_numpy(qkv).requires_grad_()
    port_kernel.launches = port_kernel.bwd_launches = 0
    out = port_attention.attention_qkv(x, 4, impl=impl)
    assert out.grad_fn is not None and "QKVAttention" in type(out.grad_fn).__name__
    out.backward(torch.from_numpy(g))
    ref = port_kernel.attention_qkv_vjp_plain(x.detach(), torch.from_numpy(g), 4, 0.25)
    torch.testing.assert_close(x.grad, ref, rtol=0, atol=0)
    torch.testing.assert_close(out.detach(), port_attention.attention_qkv(x.detach(), 4,
                                                                          impl="plain"))
    assert port_kernel.launches == port_kernel.bwd_launches == 0  # plain versions on CPU


def test_xla_is_plain_and_autograd_matches_the_vjp():
    qkv, g = _inputs(2, 18, 2, 8, seed=4)
    x = torch.from_numpy(qkv).requires_grad_()
    port_attention.attention_qkv(x, 2, impl="xla").backward(torch.from_numpy(g))
    ref = port_kernel.attention_qkv_vjp_plain(x.detach(), torch.from_numpy(g), 2, 8 ** -0.5)
    torch.testing.assert_close(x.grad, ref, rtol=1e-5, atol=1e-6)


def test_forward_kernel_refuses_a_tensor_that_needs_grad():
    x = torch.empty((2, 18, 48), dtype=torch.bfloat16, device="meta", requires_grad=True)
    with pytest.raises(RuntimeError, match="impl='auto'"):
        port_attention.attention_qkv(x, 2, impl="infer")
    with pytest.raises(RuntimeError, match="impl='auto'"):
        port_kernel.fused_attention_qkv(x, 2, 0.25)
    with torch.no_grad(), pytest.raises(ValueError, match="no kernel"):
        port_attention.attention_qkv(x, 2, impl="kernel")


def test_vjp_wrapper_refuses_other_devices():
    x = torch.empty((2, 18, 48), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        port_kernel.fused_attention_qkv_vjp(x, x[..., :16], 2, 0.25)


def _with_headers(src: str) -> str:
    """A source with the csrc/ headers it includes, recursively, appended."""
    seen, todo, text = set(), [src], src
    while todo:
        for name in re.findall(r'#include "([^"]+)"', todo.pop()):
            if name not in seen:
                seen.add(name)
                header = (build.CSRC / name).read_text()
                todo.append(header)
                text += header
    return text


def test_backward_build_targets_hopper():
    lib = build.library_path(port_kernel.BWD_NAME)
    assert lib.parent == build.BUILD_DIR and lib.name.startswith("libfused_qkv_attention_bwd-")
    src = (build.CSRC / f"{port_kernel.BWD_NAME}.cu").read_text()
    assert 'extern "C" int pdm_fused_qkv_attention_bwd' in src and "mma.sync" in src
    # head dim 64: TMA-fed wgmma kernels, with the products named in the source
    assert 'extern "C" int pdm_attention_bwd_path' in src
    for product in ("wgmma_m64n64k16_ss", "wgmma_m64n64k16_rs_tnsp_b", "tma_load_3d",
                    "setmaxnreg_inc"):
        assert product in src, product
    assert "wgmma.mma_async" in _with_headers(src) and "atomicAdd" not in src
    assert "scaled_dot_product" not in src and "cublas" not in src.lower()
