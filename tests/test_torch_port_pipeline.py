"""The pipeline engine (`parallel/pipeline.py`) in one process, against the
JAX package's, and what JAX refuses under pp.

The port's boomerang schedule with every stage in this process
(`LocalExchange`) must equal JAX's `pipeline_blocks` on the 8-device CPU
mesh (`tests/test_pipeline.py:65-170` are the cases mirrored): on JAX's toy
trunk (tanh layers) at P = 2 and 4 with 2, 4 and 8 microbatches, forward
and gradient, at rtol / atol 1e-5 and the gradient at rtol 1e-4 (JAX's
own); and `Pipelined` U-ViTs against `make_pipelined_apply` of the scanned
JAX models (`scan_blocks=True`, the JAX pipeline's requirement; the weights
carried by `uvit_state_dict` / `uvit_t2i_state_dict`, which take stacked
parameters, and jittered so the zero convs and every head are live) at P =
2 and 4 for the single (class-conditional U-ViT), dual and joint streams,
and the ground-truth mode, at 1e-5.

Every layout JAX's `Trainer` refuses under pp (pp beside sp or tp, pp or sp
for the UNet, depth/2 or the batch not dividing) the port's refuses with
the same `ValueError` message, the world faked at JAX's 8 devices; pp
beside fsdp, which JAX runs, the port lays out and accepts too.
"""
import functools

import jax
import jax.numpy as jnp
import ml_collections
import numpy as np
import pytest
import torch
import torch.distributed as dist

from panopticdiffusionmodels_tpu.configs import get_config as jax_get_config
from panopticdiffusionmodels_tpu.models import UViT as JaxUViT
from panopticdiffusionmodels_tpu.models import UViTT2I as JaxUViTT2I
from panopticdiffusionmodels_tpu.parallel.mesh import make_mesh
from panopticdiffusionmodels_tpu.parallel.pipeline import make_pipelined_apply, pipeline_blocks
from panopticdiffusionmodels_tpu.train.trainer import Trainer as JaxTrainer
from panopticdiffusionmodels_torch.configs import get_config
from panopticdiffusionmodels_torch.configs.base import d
from panopticdiffusionmodels_torch.models import UViT, UViTT2I
from panopticdiffusionmodels_torch.parallel.pipeline import LocalExchange, Pipelined, run_trunk
from panopticdiffusionmodels_torch.train.trainer import Trainer
from panopticdiffusionmodels_torch.utils.weights import to_tensors, uvit_state_dict, uvit_t2i_state_dict
from torch_port_unet_common import unet_fields

H, B, L, C = 4, 16, 6, 5


def _toy():
    rng = np.random.default_rng(0)
    return (rng.normal(size=(B, L, C)).astype(np.float32),
            (0.3 * rng.normal(size=(H, C, C))).astype(np.float32),
            (0.3 * rng.normal(size=(H, 2 * C, C))).astype(np.float32),
            (0.3 * rng.normal(size=(C, C))).astype(np.float32))


def _jax_toy(x, w_in, w_out, w_mid, pp, micro):
    def down(p, c):
        c = jnp.tanh(c @ p)
        return c, c

    def loss(ws, x):
        o = pipeline_blocks(x, *ws, mesh=make_mesh(dp=2, fsdp=1, pp=pp), num_micro=micro,
                            down_fn=down, up_fn=lambda p, c, s: jnp.tanh(
                                jnp.concatenate([c, s], -1) @ p),
                            mid_fn=lambda p, c: jnp.tanh(c @ p))
        return jnp.sum(o ** 2), o

    (_, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))((w_in, w_out, w_mid), x)
    return np.asarray(out), [np.asarray(g) for g in grads]


class _ToyLayers:
    def __init__(self, w_in, w_out, w_mid):
        self.w_in, self.w_out, self.w_mid = w_in, w_out, w_mid

    def in_layer(self, i, carry):
        c = torch.tanh(carry[0] @ self.w_in[i])
        return (c,), c

    def mid_layer(self, carry):
        return (torch.tanh(carry[0] @ self.w_mid),)

    def out_layer(self, o, carry, skip):
        return (torch.tanh(torch.cat([carry[0], skip], -1) @ self.w_out[o]),)


@pytest.mark.parametrize("pp,micro", [(2, 2), (2, 4), (4, 8), (4, 4)])
def test_engine_matches_jax_pipeline_blocks(pp, micro):
    x, *ws = _toy()
    want, want_grads = _jax_toy(x, *ws, pp, micro)
    ts = [torch.from_numpy(w).requires_grad_() for w in ws]
    feed = [(c,) for c in torch.from_numpy(x).chunk(micro)]
    _, outs = run_trunk(feed, LocalExchange(pp), _ToyLayers(*ts), H, pp)
    out = torch.cat([o[0] for o in outs])
    (out ** 2).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=1e-5, atol=1e-5)
    for t, g in zip(ts, want_grads):
        np.testing.assert_allclose(t.grad.numpy(), g, rtol=1e-4, atol=1e-5)


def _jitter(params, seed=0):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(
        np.float32), params)


@functools.lru_cache(maxsize=None)
def _models(kind):
    """(JAX module, its jittered params, the port module on the same weights,
    JAX args, port args) of a depth-8 model, built once a stream kind."""
    rng = np.random.default_rng(1)
    b = 8
    if kind == "single":
        kw = dict(img_size=8, patch_size=2, in_chans=3, embed_dim=16, depth=8, num_heads=4,
                  num_classes=10)
        jm = JaxUViT(**kw, scan_blocks=True)
        args = (rng.normal(size=(b, 8, 8, 3)).astype(np.float32),
                np.full((b,), 10.0, np.float32), np.arange(b) % 10)
        params = _jitter(jax.jit(jm.init)(jax.random.PRNGKey(0), *args))
        port = UViT(**kw)
        port.load_state_dict(to_tensors(uvit_state_dict(params, patch_size=2)), strict=True)
        targs = (torch.from_numpy(args[0]).permute(0, 3, 1, 2), torch.from_numpy(args[1]),
                 torch.from_numpy(args[2]))
        return jm, params, port, args, targs, None
    kw = dict(img_size=8, patch_size=2, in_chans=4, embed_dim=16, depth=8, num_heads=4,
              clip_dim=12, num_clip_token=7, mask_bits=8, mask_size=16,
              separate=kind == "dual")
    jm = JaxUViTT2I(**kw, scan_blocks=True)
    x = rng.normal(size=(b, 8, 8, 4)).astype(np.float32)
    t = np.full((b,), 10.0, np.float32)
    ctx = rng.normal(size=(b, 7, 12)).astype(np.float32)
    m = rng.normal(size=(b, 16, 16, 8)).astype(np.float32)
    args = (x, t, ctx)
    params = _jitter(jax.jit(lambda k, *a: jm.init(k, *a, mask_token=m))(
        jax.random.PRNGKey(0), *args))
    port = UViTT2I(**kw)
    port.load_state_dict(to_tensors(uvit_t2i_state_dict(
        params, patch_size=2, mask_patch_size=port.mask_patch_size)), strict=True)
    targs = (torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(t), torch.from_numpy(ctx))
    return jm, params, port, args, targs, m


@pytest.mark.parametrize("kind,pp", [("single", 2), ("single", 4), ("dual", 2), ("dual", 4),
                                     ("joint", 2), ("joint", 4), ("ground_truth", 2)])
def test_pipelined_model_matches_jax_pipelined_apply(kind, pp):
    jm, params, port, args, targs, m = _models("dual" if kind == "ground_truth" else kind)
    kwargs, tkw = {}, {}
    if m is not None:
        kwargs = dict(mask_token=m, use_ground_truth=kind == "ground_truth")
        tkw = dict(mask_token=torch.from_numpy(m).permute(0, 3, 1, 2),
                   use_ground_truth=kwargs["use_ground_truth"])
    fn = make_pipelined_apply(jm, make_mesh(dp=2, fsdp=1, pp=pp), num_micro=pp)
    want = jax.jit(lambda p, *a: fn(p, *a, **kwargs))(params, *args)
    with torch.no_grad():
        got = Pipelined(port, LocalExchange(pp), pp)(*targs, **tkw)
        plain = port(*targs, **tkw)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    plain = plain if isinstance(plain, tuple) else (plain,)
    for w, g, p in zip(want, got, plain):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-5)
        assert torch.equal(g, p)  # microbatching changes no number on the CPU


def _jax_reason(jconfig, tmp_path) -> str:
    with pytest.raises(ValueError) as e:
        JaxTrainer(jconfig, str(tmp_path / "jax"))
    return str(e.value)


@pytest.mark.parametrize("case", ["pp_sp", "pp_tp", "unet_pp", "unet_sp", "depth", "batch"])
def test_what_jax_refuses_under_pp_the_port_refuses_with_its_reason(case, tmp_path,
                                                                       monkeypatch):
    mesh = dict(pp_sp=dict(pp=2, sp=2), pp_tp=dict(pp=2, tp=2), unet_pp=dict(pp=2),
                unet_sp=dict(sp=2), depth=dict(pp=4), batch=dict(pp=2))[case]
    config = get_config("synthetic_tiny")
    config.num_workers = 0
    config.mesh.update(mesh)
    config.nnet.scan_blocks = True
    if case.startswith("unet"):
        config.nnet = d(**unet_fields(channel_mult=[2, 2]))
    if case == "batch":
        config.train.pp_microbatches = 3
    jconfig = jax_get_config("synthetic_tiny")
    for key in ("nnet", "mesh", "train"):
        jconfig[key] = ml_collections.ConfigDict(dict(config[key]))
    reason = _jax_reason(jconfig, tmp_path)
    # the world of JAX's 8 CPU devices, as processes
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda *a, **k: 8)
    monkeypatch.setattr(dist, "get_rank", lambda *a, **k: 0)
    with pytest.raises(ValueError) as e:
        Trainer(config, str(tmp_path / "port"), device="cpu")
    assert str(e.value) == reason


def test_pp_beside_fsdp_builds_its_layout(monkeypatch):
    """JAX runs pp beside fsdp, and so does the port: over JAX's 8 devices as
    processes the layout is (pp, dp, fsdp) = (2, 2, 2), row-major with pp
    outermost, each stage's fsdp peers loading their own rows, and the
    trainer's layout check accepts it (the run itself:
    `test_torch_port_pp_fsdp_gloo.py`)."""
    from panopticdiffusionmodels_torch.parallel.mesh import FullyShardedDataParallel, from_mesh

    config = get_config("synthetic_tiny")
    config.mesh.update(pp=2, fsdp=2)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda *a, **k: 8)
    for rank in range(8):
        monkeypatch.setattr(dist, "get_rank", lambda *a, r=rank, **k: r)
        layout = from_mesh(config.mesh)
        assert isinstance(layout, FullyShardedDataParallel)
        assert (layout.pp, layout.dp, layout.fsdp) == (2, 2, 2)
        assert layout.coords == dict(pp=rank // 4, dp=rank // 2 % 2, fsdp=rank % 2, sp=0, tp=0)
        assert layout.peers("fsdp") == [rank - rank % 2, rank - rank % 2 + 1]
        assert layout.peers("pp") == [rank % 4, rank % 4 + 4]
        assert layout.data_rank == rank % 4 and layout.data_peers() == [rank % 4, rank % 4 + 4]
        trainer = Trainer.__new__(Trainer)
        trainer.dp, trainer.fsdp, trainer.pp = layout, layout, layout.pp
        trainer._check_layout(config)
        assert trainer.num_micro == 2
