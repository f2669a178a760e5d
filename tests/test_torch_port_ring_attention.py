"""The port's ring attention, sequence-parallel context and sharded UViTT2I
against the JAX package's.

In-process ring attention (`InProcessSP`: the sp shards folded into the
batch, the rotation a `torch.roll`) must equal JAX `ring_attention_qkv` on a
CPU mesh `make_mesh(dp=1, sp=sp)` (conftest gives 8 devices), forward at
rtol / atol 1e-5 and gradient at rtol 1e-4 / atol 1e-5, the JAX tests' own
(`tests/test_ring_attention.py:33-104`), for sp = 2, 4, 8 and the padded
(L, sp) = (18, 4), (21, 4), (10, 8), and (21, 2) at 16 heads of 72
(U-ViT-H's head dim).  The tiny UViTT2I at sp = 2 must equal
the JAX model on the sp = 2 ring at rtol 1e-4 / atol 1e-5.
"""
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panopticdiffusionmodels_tpu.models import UViTT2I as JaxUViTT2I
from panopticdiffusionmodels_tpu.ops.ring_attention import ring_attention_qkv as jax_ring
from panopticdiffusionmodels_tpu.parallel.mesh import make_mesh, token_sharding
from panopticdiffusionmodels_tpu.utils.torch_bridge import convert_uvit_t2i
from panopticdiffusionmodels_torch.models import UViTT2I
from panopticdiffusionmodels_torch.ops import attention as port_attention
from panopticdiffusionmodels_torch.ops.ring_attention import ring_attention_qkv
from panopticdiffusionmodels_torch.parallel.mesh import InProcessSP, from_mesh
from panopticdiffusionmodels_torch.utils.weights import to_tensors, uvit_t2i_state_dict

HEADS, C = 4, 32
SCALE = (C // HEADS) ** -0.5


def _qkv(b, l, seed, c=C):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(b, l, 3 * c)).astype(np.float32)


# (l, sp) at 4 heads of 8; one case at U-ViT-H's 16 heads of 72 with 21
# tokens over 2 shards (the second holds 10 real keys of 11).
@pytest.mark.parametrize("l,sp,heads,d", [
    *(pytest.param(l, sp, HEADS, C // HEADS, id=f"{l}-{sp}")
      for l, sp in [(16, 2), (16, 4), (16, 8), (18, 4), (21, 4), (10, 8)]),
    pytest.param(21, 2, 16, 72, id="21-2-d72")])
def test_ring_matches_jax_ring(l, sp, heads, d):
    scale = d ** -0.5
    x = _qkv(2, l, seed=l + sp, c=heads * d)
    ts = token_sharding(make_mesh(dp=1, sp=sp))

    def jax_loss(t):
        out = jax_ring(t, heads, scale, ts)
        return jnp.sum(out ** 2), out

    (_, want), want_grad = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    out = ring_attention_qkv(xt, heads, scale, InProcessSP(sp))
    (out ** 2).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_grad), rtol=1e-4, atol=1e-5)


def test_in_process_layout_round_trips():
    sp = InProcessSP(4)
    x = torch.arange(2 * 8 * 3.0).reshape(2, 8, 3)
    local = sp.shard(x)
    assert local.shape == (8, 2, 3)
    assert torch.equal(local[1 * 2 + 0], x[0, 2:4])  # shard 1 of batch row 0
    assert torch.equal(sp.gather(local), x)
    rolled = sp.rotate(local)
    assert torch.equal(rolled[2 * 2 + 1], local[1 * 2 + 1])  # shard 2 now holds shard 1's
    # after one hop, shard s holds shard s-1's keys; at L=7 padded to 8 the
    # last shard has one real token
    assert sp.sources(1) == [3, 0, 1, 2]
    assert sp.nvalid(1, sp.contiguous_counts(7), 8, torch.device("cpu")).tolist() == [
        1, 1, 2, 2, 2, 2, 2, 2]


def test_ring_plain_equals_ring_on_cpu():
    x = torch.from_numpy(_qkv(2, 16, seed=1))
    sp = InProcessSP(2)
    local = sp.shard(x)
    a = port_attention.attention_qkv(local, HEADS, impl="ring", sp=sp)
    b = port_attention.attention_qkv(local, HEADS, impl="ring_plain", sp=sp)
    assert torch.equal(a, b)


def test_ring_without_context_warns_and_takes_the_unsharded_path(caplog):
    x = torch.from_numpy(_qkv(2, 16, seed=2))
    with caplog.at_level(logging.WARNING):
        out = port_attention.attention_qkv(x, HEADS, impl="ring")
        assert "without a sequence-parallel context" in caplog.text
        caplog.clear()
        port_attention.attention_qkv(x[:1], HEADS, impl="ring")  # batch 1 stays quiet
        assert not caplog.text
    assert torch.equal(out, port_attention.attention_qkv(x, HEADS, impl="auto"))


@pytest.mark.parametrize("mesh,error,match", [
    # dp or tp beside sp run over processes; one process cannot hold them
    (dict(sp=2, dp=2, sp_mode="in_process"), ValueError, "not the world of 1 processes"),
    (dict(sp=2, tp=2, sp_mode="in_process"), ValueError, "tp = 2 needs 2 processes"),
    (dict(sp=2, sp_mode="ring"), ValueError, "sp_mode"),
    (dict(sp=2, sp_mode="process_group"), RuntimeError, "torchrun"),
])
def test_sp_context_refuses_what_it_does_not_run(mesh, error, match):
    with pytest.raises(error, match=match):
        from_mesh(mesh)


def test_sp_context_is_explicit():
    assert from_mesh(dict(sp=1)) is None
    sp = from_mesh(dict(sp=2, sp_mode="in_process"))
    assert isinstance(sp, InProcessSP) and sp.sp == 2 and sp.world_size == 1


GEOM = dict(img_size=8, patch_size=2, in_chans=4, embed_dim=32, depth=4, num_heads=4,
            clip_dim=16, num_clip_token=7, mask_bits=8, mask_size=16)


def test_sharded_uvit_t2i_matches_jax_ring_model():
    """Dual stream at sp = 2: image stream 24 tokens, mask stream 16 + 24."""
    torch.manual_seed(3)
    seed_model = UViTT2I(**GEOM)
    with torch.no_grad():
        for zc in seed_model.zero_convs.values():
            zc.conv.weight.normal_(0, 0.05)
    params = convert_uvit_t2i({k: v.numpy() for k, v in seed_model.state_dict().items()},
                              depth=GEOM["depth"], scan_blocks=False)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    t = np.array([10.0, 900.0], np.float32)
    ctx = rng.standard_normal((2, 7, 16)).astype(np.float32)
    m = rng.standard_normal((2, 16, 16, 8)).astype(np.float32)
    jmodel = JaxUViTT2I(**GEOM, attn_impl="ring",
                        token_sharding=token_sharding(make_mesh(dp=1, sp=2)))
    noise, mask = jax.jit(jmodel.apply)(params, jnp.asarray(x), jnp.asarray(t),
                                        jnp.asarray(ctx), mask_token=jnp.asarray(m))
    model = UViTT2I(**GEOM, attn_impl="ring", sp=InProcessSP(2)).eval()
    model.load_state_dict(to_tensors(uvit_t2i_state_dict(
        jax.tree.map(np.asarray, params), patch_size=2, mask_patch_size=model.mask_patch_size)),
        strict=True)
    with torch.no_grad():
        ours = model(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(t),
                     torch.from_numpy(ctx), mask_token=torch.from_numpy(m).permute(0, 3, 1, 2))
    np.testing.assert_allclose(ours[0].permute(0, 2, 3, 1).numpy(), np.asarray(noise),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ours[1].permute(0, 2, 3, 1).numpy(), np.asarray(mask),
                               rtol=1e-4, atol=1e-5)


def test_sharded_uvit_t2i_refuses_a_stream_that_does_not_divide():
    """Streams that do not divide sp are padded at their end, the pad keys
    masked and the pad rows dropped: the sharded model equals the unsharded
    one, forward and gradient.  sp = 3: the mask stream's 16 tokens pad to
    18; num_clip_token = 6 at sp = 2 and 4: the image stream's 23 tokens
    pad, so a mask-stream shard holds x pad rows before real m rows and is
    reordered for the ring."""
    rng = np.random.default_rng(5)
    for clip_tokens, sp in ((7, 3), (6, 2), (6, 4)):
        geom = dict(GEOM, num_clip_token=clip_tokens)
        torch.manual_seed(6)
        plain = UViTT2I(**geom)
        with torch.no_grad():
            for zc in plain.zero_convs.values():
                zc.conv.weight.normal_(0, 0.05)
        sharded = UViTT2I(**geom, attn_impl="ring", sp=InProcessSP(sp))
        sharded.load_state_dict(plain.state_dict())
        args = (torch.from_numpy(rng.standard_normal((2, 4, 8, 8)).astype(np.float32)),
                torch.tensor([10.0, 900.0]),
                torch.from_numpy(rng.standard_normal((2, clip_tokens, 16)).astype(np.float32)))
        mask = torch.from_numpy(rng.standard_normal((2, 8, 16, 16)).astype(np.float32))
        outs = []
        for model in (plain, sharded):
            noise, pred = model(*args, mask_token=mask)
            ((noise ** 2).sum() + (pred ** 2).sum()).backward()
            outs.append((noise.detach(), pred.detach(),
                         {n: p.grad.clone() for n, p in model.named_parameters()}))
        for a, b in zip(outs[0][:2], outs[1][:2]):
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5, atol=1e-5)
        for name, g in outs[0][2].items():
            np.testing.assert_allclose(outs[1][2][name].numpy(), g.numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=f"{clip_tokens}, {sp}: {name}")
