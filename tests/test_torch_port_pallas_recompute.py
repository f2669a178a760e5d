"""`attention_qkv(impl='pallas_recompute')` against the JAX package's pair.

JAX's `_qkv_attn_trainable` with bwd='xla_recompute' (`ops/attention.py:55-99`)
runs the Pallas forward (here in interpret mode, as the JAX package's own
tests run it on the CPU) and re-differentiates the XLA attention for the
VJP; its public `attention_qkv(impl='pallas_recompute')` takes the XLA path
off the TPU.  The port's `QKVAttentionRecompute` (the forward kernel without
lse, saving only qkv; a plain f32 recompute backward) must give both
sides' output and gradient on the same numpy qkv and cotangent at rtol /
atol 3e-5 (the bar of the attention backward tests), call the forward
wrapper once without lse and never `fused_attention_qkv_vjp`; a bf16 qkv
gets a bf16 gradient taken in f32.  A trainer with
`nnet.attn_impl='pallas_recompute'` takes the same step as one on 'auto'.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panopticdiffusionmodels_tpu.ops.attention import _qkv_attn_trainable
from panopticdiffusionmodels_tpu.ops.attention import attention_qkv as jax_attention_qkv
from panopticdiffusionmodels_torch.configs import get_config
from panopticdiffusionmodels_torch.ops import attention as port_attention
from panopticdiffusionmodels_torch.ops.kernels import fused_qkv_attention as port_kernel
from panopticdiffusionmodels_torch.train.trainer import Trainer
from torch_port_train_common import batches

torch.set_num_threads(1)


@functools.partial(jax.jit, static_argnums=(2, 3))
def _jax_refs(qkv, g, heads, scale):
    out = []
    for fn in (lambda x: _qkv_attn_trainable(x, heads, scale, True, "xla_recompute"),
               lambda x: jax_attention_qkv(x, heads, scale=scale, impl="pallas_recompute")):
        y, vjp = jax.vjp(fn, qkv)
        out.append((y, vjp(g)[0]))
    return out


@pytest.fixture
def counted(monkeypatch):
    """Records the forward wrapper's `with_lse`; the backward kernel raises."""
    calls = []
    fwd = port_attention.fused_attention_qkv

    def forward(qkv, heads, scale, with_lse=False):
        calls.append(with_lse)
        return fwd(qkv, heads, scale, with_lse=with_lse)

    def backward(*args, **kwargs):
        raise AssertionError("pallas_recompute called fused_attention_qkv_vjp")

    monkeypatch.setattr(port_attention, "fused_attention_qkv", forward)
    monkeypatch.setattr(port_attention, "fused_attention_qkv_vjp", backward)
    return calls


@pytest.mark.parametrize("b,l,h,d", [(2, 18, 2, 16), (2, 37, 4, 8)])
def test_pallas_recompute_matches_jax(counted, b, l, h, d):
    rng = np.random.default_rng(l + h)
    qkv = (rng.standard_normal((b, l, 3 * h * d)) * 0.7).astype(np.float32)
    g = rng.standard_normal((b, l, h * d)).astype(np.float32)
    scale = d ** -0.5
    x = torch.from_numpy(qkv).requires_grad_()
    out = port_attention.attention_qkv(x, h, scale=scale, impl="pallas_recompute")
    out.backward(torch.from_numpy(g))
    assert counted == [False]
    for y, dqkv in _jax_refs(jnp.asarray(qkv), jnp.asarray(g), h, scale):
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(y), rtol=3e-5, atol=3e-5)
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(dqkv), rtol=3e-5, atol=3e-5)


def test_bf16_gradient_is_taken_in_f32(counted):
    rng = np.random.default_rng(3)
    qkv = torch.from_numpy((rng.standard_normal((2, 18, 96)) * 0.7).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((2, 18, 32)).astype(np.float32))
    x = qkv.bfloat16().requires_grad_()
    port_attention.attention_qkv(x, 2, impl="pallas_recompute").backward(g.bfloat16())
    want = port_kernel.attention_qkv_vjp_plain(qkv.bfloat16().float(), g.bfloat16().float(), 2,
                                               16 ** -0.5)
    assert x.grad.dtype == torch.bfloat16
    torch.testing.assert_close(x.grad, want.bfloat16(), rtol=0, atol=0)


def test_trainer_step_on_pallas_recompute_equals_auto(tmp_path):
    batch = batches(1)[0]
    steps = {}
    for impl in ("auto", "pallas_recompute"):
        config = get_config("synthetic_tiny")
        config.nnet.attn_impl = impl
        trainer = Trainer(config, str(tmp_path / impl), device="cpu")
        assert {m.attn_impl for m in trainer.nnet.modules() if hasattr(m, "attn_impl")} == {impl}
        metrics = trainer.loss_and_grads(batch)
        steps[impl] = (metrics, {n: p.grad.clone() for n, p in trainer.state.params.items()})
    for k, v in steps["auto"][0].items():
        torch.testing.assert_close(steps["pallas_recompute"][0][k], v, rtol=1e-5, atol=1e-6)
    for name, g in steps["auto"][1].items():
        torch.testing.assert_close(steps["pallas_recompute"][1][name], g, rtol=1e-4, atol=1e-6)
