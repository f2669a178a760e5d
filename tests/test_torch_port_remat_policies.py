"""Every remat policy of the port's blocks against JAX's `jax.grad`.

A tiny dual-stream `UViTT2I` (synthetic_tiny's geometry: 5 image and 5 mask
blocks, 4 of them with a skip projection), with `use_checkpoint=True` and
each `remat_policy` of JAX `models/scan_stack.py:30-58` (None, 'nothing',
'everything', 'dots', 'dots_no_batch', 'save_attn'), must give the gradient
of a fixed linear functional of its two outputs that the JAX `UViTT2I` with
the same policy gives under `jax.grad`, at rtol 1e-4 / atol 1e-5, from the
same parameters (the zero convs made non-zero so the coupling carries a
gradient).

What each policy keeps is proven by counting, during the backward alone,
the calls of the attention's plain forward (the CPU side of kernel 1) and
the aten matmuls run, against the 'everything' backward (which replays
nothing): a replayed Dense is one mm / addmm, a replayed plain attention
two bmm.  Non-reentrant checkpointing stops a replay once the last tensor
the backward needs is rebuilt, so no fc2 (whose output no backward reads)
is replayed, nor, under 'save_attn', the qkv GEMM at the end of its region.
Per step of this model, under the trainer's `attn_impl='auto'`:

  policy           attention replays   Dense replays   bmm replays
  everything       0                   0               0
  save_attn        0                   20              0
  dots             10                  0               0 (kept)
  dots_no_batch    10                  0               20
  nothing / None   10                  34              20

(`save_attn` replays proj and fc1 of each of the 10 blocks and keeps the
attention; the recompute-all policies replay qkv, proj and fc1 of each
block and the 4 skip projections.)
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from panopticdiffusionmodels_tpu.models import UViTT2I as JaxUViTT2I
from panopticdiffusionmodels_tpu.utils.torch_bridge import convert_uvit_t2i
from panopticdiffusionmodels_torch.models import UViTT2I
from panopticdiffusionmodels_torch.models.layers import REMAT_SAVES
from panopticdiffusionmodels_torch.ops.kernels import fused_qkv_attention as port_kernel
from panopticdiffusionmodels_torch.utils.weights import to_tensors, uvit_t2i_state_dict

torch.set_num_threads(1)

GEOM = dict(img_size=8, patch_size=2, in_chans=4, embed_dim=32, depth=4, num_heads=4,
            clip_dim=16, num_clip_token=7, mask_bits=8, mask_size=16, enable_panoptic=True,
            separate=True)
POLICIES = [None, "nothing", "everything", "dots", "dots_no_batch", "save_attn"]
# policy -> (attention forward replays, Dense replays, bmm replays) a backward
REPLAYS = {None: (10, 34, 20), "nothing": (10, 34, 20), "everything": (0, 0, 0),
           "dots": (10, 0, 0), "dots_no_batch": (10, 0, 20), "save_attn": (0, 20, 0)}
_aten = torch.ops.aten
DENSE = {_aten.mm.default, _aten.addmm.default}
BMM = {_aten.bmm.default, _aten.baddbmm.default}


def _inputs():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    t = np.array([10.0, 900.0], np.float32)
    ctx = rng.standard_normal((2, 7, 16)).astype(np.float32)
    m = rng.standard_normal((2, 16, 16, 8)).astype(np.float32)
    w_eps = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    w_mask = rng.standard_normal((2, 16, 16, 8)).astype(np.float32)
    return x, t, ctx, m, w_eps, w_mask


@functools.lru_cache(maxsize=1)
def _params():
    torch.manual_seed(7)
    seed_model = UViTT2I(**GEOM)
    with torch.no_grad():
        for name, p in seed_model.named_parameters():
            if name.startswith("zero_convs"):
                p.normal_(0, 0.02)
    sd = {k: v.numpy() for k, v in seed_model.state_dict().items()}
    return convert_uvit_t2i(sd, depth=GEOM["depth"], scan_blocks=False)


def jax_grads(policy):
    model = JaxUViTT2I(**GEOM, scan_blocks=False, attn_impl="xla", use_checkpoint=True,
                       remat_policy=policy)
    x, t, ctx, m, w_eps, w_mask = map(jnp.asarray, _inputs())

    def loss(params):
        eps, mask = model.apply(params, x, t, ctx, mask_token=m)
        return jnp.sum(eps * w_eps) + jnp.sum(mask * w_mask)

    grads = jax.jit(jax.grad(loss))(_params())
    return uvit_t2i_state_dict(jax.tree.map(np.asarray, grads), patch_size=2,
                               mask_patch_size=4)


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.dense = self.bmm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.dense += func in DENSE
        self.bmm += func in BMM
        return func(*args, **(kwargs or {}))


def port_backward(policy, monkeypatch):
    """(gradients by port name, attention forward calls, dense ops, bmm ops),
    the last three counted during the backward."""
    model = UViTT2I(**GEOM, attn_impl="auto", use_checkpoint=True, remat_policy=policy)
    model.load_state_dict(to_tensors(uvit_t2i_state_dict(_params(), patch_size=2,
                                                         mask_patch_size=4)), strict=True)
    calls = [0]
    plain = port_kernel.attention_qkv_plain

    def counted(*args, **kwargs):
        calls[0] += 1
        return plain(*args, **kwargs)

    monkeypatch.setattr(port_kernel, "attention_qkv_plain", counted)
    x, t, ctx, m, w_eps, w_mask = map(torch.from_numpy, _inputs())
    nchw = lambda a: a.permute(0, 3, 1, 2)  # noqa: E731
    eps, mask = model(nchw(x), t, ctx, mask_token=nchw(m))
    loss = (eps * nchw(w_eps)).sum() + (mask * nchw(w_mask)).sum()
    assert calls[0] == 10  # one attention a block in the forward
    calls[0] = 0
    with _Count() as count:
        loss.backward()
    return ({n: p.grad for n, p in model.named_parameters()}, calls[0], count.dense,
            count.bmm)


@pytest.fixture(scope="module")
def baseline():
    with pytest.MonkeyPatch.context() as mp:
        return port_backward("everything", mp)


def test_every_jax_policy_is_ported():
    assert set(POLICIES) | {""} == set(REMAT_SAVES)


@pytest.mark.parametrize("policy", POLICIES)
def test_policy_gradient_matches_jax_and_replays_what_it_does_not_keep(policy, baseline,
                                                                       monkeypatch):
    grads, attn, dense, bmm = port_backward(policy, monkeypatch)
    want = jax_grads(policy)
    assert sorted(grads) == sorted(want)
    for name, g in want.items():
        np.testing.assert_allclose(grads[name].numpy(), g, rtol=1e-4, atol=1e-5, err_msg=name)
    assert (attn, dense - baseline[2], bmm - baseline[3]) == REPLAYS[policy]


def test_unknown_policy_raises_as_in_jax():
    with pytest.raises(ValueError, match="unknown remat_policy 'dots_everywhere'"):
        UViTT2I(**GEOM, use_checkpoint=True, remat_policy="dots_everywhere")
