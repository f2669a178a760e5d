"""The port's ring hop (`ops/kernels/ring_hop.py`) against the JAX package's.

`attention_hop_plain` (what the Hopper kernel is held to on the card) must
equal the JAX XLA hop `_hop_xla` and the Pallas kernel `attention_hop` run in
interpret mode (its (B, groups, Lq, 128) stats mapped through `_stats`), on
the same numpy inputs, with nvalid = Lk, Lk - 3 and 0 (an all-padding hop):
rtol / atol 1e-5, the JAX tests' own (`tests/test_ring_attention.py:107-132`).
The hop Function's gradient, with cotangents into o, m and den, must equal
`jax.grad` through `_hop_xla` at rtol 1e-4 / atol 1e-5 (l.135-171).  Both at
head dim 64 (4 heads) and at U-ViT-H's 72 (16 heads: 16 x 72 = 9 x 128 is
the JAX kernel's smallest lane-aligned head group there).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panopticdiffusionmodels_tpu.ops.pallas.ring_hop import attention_hop as jax_attention_hop
from panopticdiffusionmodels_tpu.ops.ring_attention import _hop_xla, _stats
from panopticdiffusionmodels_torch.ops.kernels import build, ring_hop
from panopticdiffusionmodels_torch.ops.ring_attention import RingHop

B, LQ, LK, HEADS, D = 2, 8, 16, 4, 64  # d = 64: a lane-aligned head group for Pallas
C = HEADS * D
SCALE = D ** -0.5
NVALIDS = (LK, LK - 3, 0)
# (heads, head dim) of each case; the head dim 64 cases keep their bare ids.
GEOMETRIES = {64: (HEADS, D), 72: (16, 72)}
BY_DIM = [pytest.param(nv, dim, id=str(nv) if dim == 64 else f"{nv}-d{dim}")
          for dim in GEOMETRIES for nv in NVALIDS]


def _inputs(seed, dim=64):
    heads, d = GEOMETRIES[dim]
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(B, LQ, heads * d)) * 0.5).astype(np.float32)
    kv = (rng.normal(size=(B, LK, 2 * heads * d)) * 0.5).astype(np.float32)
    return q, kv


def _port(q, kv, nvalid, heads=HEADS):
    scale = (q.shape[-1] // heads) ** -0.5
    return [t.numpy() for t in ring_hop.attention_hop_plain(
        torch.from_numpy(q), torch.from_numpy(kv), heads, scale, nvalid)]


@pytest.mark.parametrize("nvalid,dim", BY_DIM)
def test_plain_matches_jax_hop(nvalid, dim):
    heads, d = GEOMETRIES[dim]
    scale = d ** -0.5
    q, kv = _inputs(5, dim)
    o, m, den = _port(q, kv, nvalid, heads)
    o_x, m_x, den_x = (np.asarray(t) for t in _hop_xla(jnp.asarray(q), jnp.asarray(kv), heads,
                                                       scale, nvalid))
    o_k, m_k, den_k = jax_attention_hop(jnp.asarray(q), jnp.asarray(kv), heads, scale, nvalid,
                                        interpret=True)
    for want_m, want_den, want_o in ((m_x, den_x, o_x),
                                     (_stats(m_k, heads), _stats(den_k, heads), o_k)):
        np.testing.assert_allclose(m, np.asarray(want_m)[..., 0], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(den, np.asarray(want_den)[..., 0], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(o, np.asarray(want_o), rtol=1e-5, atol=1e-5)
    if nvalid == 0:  # all padding: finite -1e30 max, p = 1 on every column
        assert (m == np.float32(-1e30)).all() and (den == LK).all()


def test_plain_takes_strided_q_and_per_row_nvalid():
    """q as a view of a packed (B, L, 3C) qkv, as the ring passes it, and one
    nvalid per batch row (the folded in-process layout) equal the per-row
    calls with a scalar."""
    q, kv = _inputs(6)
    qkv = torch.zeros((B, LQ, 3 * C))
    qkv[..., :C] = torch.from_numpy(q)
    nv = torch.tensor([LK - 3, 0], dtype=torch.int32)
    got = ring_hop.attention_hop_plain(qkv[..., :C], torch.from_numpy(kv), HEADS, SCALE, nv)
    for row in range(B):
        want = _port(q[row:row + 1], kv[row:row + 1], int(nv[row]))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[row:row + 1].numpy(), w)


@pytest.mark.parametrize("nvalid,dim", BY_DIM)
def test_hop_function_grad_matches_jax(nvalid, dim):
    heads, d = GEOMETRIES[dim]
    scale = d ** -0.5
    q, kv = _inputs(7, dim)
    rng = np.random.default_rng(8)
    wm = rng.normal(size=(B, LQ, heads)).astype(np.float32) * 1e-2

    def jax_loss(q_, kv_):
        o, m, den = _hop_xla(q_, kv_, heads, scale, jnp.int32(nvalid))
        return jnp.sum(o ** 2) + jnp.sum(m[..., 0] * wm) + jnp.sum(jnp.log(den))

    want = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(q), jnp.asarray(kv))
    qt = torch.from_numpy(q).requires_grad_()
    kvt = torch.from_numpy(kv).requires_grad_()
    o, m, den = RingHop.apply(qt, kvt, torch.tensor(nvalid, dtype=torch.int32), heads, scale)
    ((o ** 2).sum() + (m * torch.from_numpy(wm)).sum() + torch.log(den).sum()).backward()
    for got, w in zip((qt.grad, kvt.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5)


def test_wrapper_takes_plain_path_on_cpu():
    q, kv = (torch.from_numpy(t).to(torch.bfloat16) for t in _inputs(9))
    ring_hop.launches = 0
    got = ring_hop.attention_hop(q, kv, HEADS, SCALE, LK - 3)
    want = ring_hop.attention_hop_plain(q, kv, HEADS, SCALE, LK - 3)
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.float32
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert ring_hop.launches == 0


def test_wrapper_refuses_other_devices():
    q = torch.empty((B, LQ, C), dtype=torch.bfloat16, device="meta")
    kv = torch.empty((B, LK, 2 * C), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ring_hop.attention_hop(q, kv, HEADS, SCALE, LK)


def test_hop_build_targets_hopper():
    assert sorted(build.KERNELS) == sorted(p.stem for p in build.CSRC.glob("*.cu"))
    lib = build.library_path(ring_hop.NAME)
    assert lib.parent == build.BUILD_DIR and lib.name.startswith("libring_hop-")
    assert "arch=compute_90a,code=sm_90a" in " ".join(build.NVCC_FLAGS)
    src = (build.CSRC / f"{ring_hop.NAME}.cu").read_text()
    assert 'extern "C" int pdm_ring_hop' in src and "mma.sync" in src
    assert "scaled_dot_product" not in src and "cublas" not in src.lower()
    # head dims 64 and 72: the shared wgmma loop of attention_fwd.cuh in its hop mode
    assert '#include "attention_fwd.cuh"' in src
    assert "launch_attention_tma<3, true, 64>" in src and "launch_attention_tma<3, true, 72>" in src
    assert "inline bool hop_uses_tma(int D) { return D == 64 || D == 72; }" in src
    loop = (build.CSRC / "attention_fwd.cuh").read_text()
    assert "wgmma_m64n64k16_ss" in loop and "wgmma_m64n64k16_rs_tnsp_b" in loop
    assert "wgmma.mma_async" in (build.CSRC / "hopper.cuh").read_text()
    assert "if constexpr (kHop)" in loop
