"""Shared tiny UNet of the port's UNet-family tests (not collected itself).

`TINY` is a UNet2DCondition of sample 8, 32 channels and channel_mult
(1, 2, 2): three levels, so the no-attention rule of the deepest level and
two upsamplers run; 4 heads; clip_dim 16.  `tiny_pair` builds the port's
module from a torch seed, opens its zero-initialised mask gate with seeded
values (so the mask encoder reaches the image path) and hands the same
weights to the JAX module as a flax tree (`to_jax`, the inverse of
`unet_state_dict`), checked leaf for leaf against the tree `jax.eval_shape`
of JAX's own `init` gives: a jitted JAX init of the UNet costs ~17 s on a
CPU, its jitted apply ~4 s.  `ldm_state_dict` writes seeded weights in the
CompVis-LDM UNet's key layout, restated here independently of both
converters.  `train_configs` / `train_jax_trainer` are the UNet training
tests' (port config, JAX config) pair and a JAX `Trainer` built by
`__new__` with what its step reads.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import ml_collections
import numpy as np
import torch

from panopticdiffusionmodels_tpu.configs import get_config as jax_get_config
from panopticdiffusionmodels_tpu.diffusion.schedule import Schedule as JaxSchedule
from panopticdiffusionmodels_tpu.diffusion.schedule import stable_diffusion_beta_schedule
from panopticdiffusionmodels_tpu.models import get_nnet as jax_get_nnet
from panopticdiffusionmodels_tpu.models.unet import UNet2DCondition as JaxUNet
from panopticdiffusionmodels_tpu.train.state import create_train_state, make_optimizer
from panopticdiffusionmodels_tpu.train.state import make_lr_schedule as jax_lr_schedule
from panopticdiffusionmodels_tpu.train.trainer import Trainer as JaxTrainer
from panopticdiffusionmodels_torch.configs import get_config
from panopticdiffusionmodels_torch.configs.base import d
from panopticdiffusionmodels_torch.models.unet import UNet2DCondition
from panopticdiffusionmodels_torch.utils.weights import unet_state_dict

TINY = dict(sample_size=8, in_chans=4, out_chans=4, model_channels=32, channel_mult=(1, 2, 2),
            num_res_blocks=1, num_heads=4, clip_dim=16, num_clip_token=5, mask_bits=8)


def to_jax(sd) -> dict:
    """The port's UNet state dict -> a flax params tree (Linear -> Dense
    kernel (in, out), Conv2d OIHW -> HWIO, norm weight -> scale)."""
    tree: dict = {}
    for key, value in sd.items():
        value = value.detach().numpy() if torch.is_tensor(value) else np.asarray(value)
        *path, leaf = key.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        if leaf == "bias":
            node["bias"] = value
        elif value.ndim == 1:
            node["scale"] = value
        elif value.ndim == 2:
            node["kernel"] = np.ascontiguousarray(value.T)
        else:
            node["kernel"] = np.ascontiguousarray(value.transpose(2, 3, 1, 0))
    return {"params": tree}


def jax_unet(**overrides):
    return JaxUNet(**dict(TINY, **overrides))


def open_gate(net, seed: int = 0) -> None:
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        net.mask_zero_gate.weight.copy_(torch.randn(net.mask_zero_gate.weight.shape,
                                                    generator=g) * 0.1)
        net.mask_zero_gate.bias.copy_(torch.randn(net.mask_zero_gate.bias.shape,
                                                  generator=g) * 0.1)


def tiny_pair(seed: int = 0, context_dim: int = 16, **overrides):
    """(JAX module, its params, port module in eval mode) on the same weights."""
    kw = dict(TINY, **dict(dict(enable_panoptic=True, mask_size=16), **overrides))
    torch.manual_seed(seed)
    net = UNet2DCondition(**kw, context_dim=context_dim).eval()
    if kw["enable_panoptic"]:
        open_gate(net, seed)
    params = to_jax(net.state_dict())
    jnet = JaxUNet(**kw)
    ss, ms = kw["sample_size"], kw["mask_size"]
    shapes = jax.eval_shape(
        lambda k: jnet.init(k, np.zeros((1, ss, ss, kw["in_chans"]), np.float32),
                            np.zeros((1,), np.float32),
                            np.zeros((1, kw["num_clip_token"], context_dim), np.float32),
                            mask_token=(np.zeros((1, ms, ms, kw["mask_bits"]), np.float32)
                                        if kw["enable_panoptic"] else None)),
        jax.random.PRNGKey(0))
    want = dict(jax.tree_util.tree_flatten_with_path(shapes)[0])
    got = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    assert set(got) == set(want), set(got) ^ set(want)
    for path, leaf in want.items():
        assert got[path].shape == leaf.shape, (path, got[path].shape, leaf.shape)
    back = unet_state_dict(params)  # the carrier the other tests load JAX weights with
    assert sorted(back) == sorted(net.state_dict())
    for k, v in net.state_dict().items():
        np.testing.assert_array_equal(back[k], v.numpy(), err_msg=k)
    return jnet, params, net


def unet_fields(**overrides) -> dict:
    """The tiny UNet as a config's `nnet` fields (synthetic_tiny's 7 x 16
    context, 16 x 16 panoptic maps)."""
    fields = dict(TINY, channel_mult=list(TINY["channel_mult"]), num_clip_token=7,
                  enable_panoptic=True, mask_size=16)
    return dict(fields, name="unet_t2i", **overrides)


def ldm_state_dict(ch0, mult, nrb, in_ch=4, out_ch=4, ctx=16, seed=0):
    """Seeded LDM UNet weights in LDM's names and (torch) layouts."""
    rng = np.random.default_rng(seed)
    sd = {}

    def put(name, *shape):
        sd[name] = (0.1 * rng.standard_normal(shape)).astype(np.float32)

    def conv(name, i, o, k):
        put(f"{name}.weight", o, i, k, k)
        put(f"{name}.bias", o)

    def norm(name, c):
        put(f"{name}.weight", c)
        put(f"{name}.bias", c)

    def lin(name, i, o, bias=True):
        put(f"{name}.weight", o, i)
        if bias:
            put(f"{name}.bias", o)

    def res(name, i, o):
        norm(f"{name}.in_layers.0", i)
        conv(f"{name}.in_layers.2", i, o, 3)
        lin(f"{name}.emb_layers.1", 4 * ch0, o)
        norm(f"{name}.out_layers.0", o)
        conv(f"{name}.out_layers.3", o, o, 3)
        if i != o:
            conv(f"{name}.skip_connection", i, o, 1)

    def attn(name, c):
        norm(f"{name}.norm", c)
        conv(f"{name}.proj_in", c, c, 1)
        conv(f"{name}.proj_out", c, c, 1)
        tb = f"{name}.transformer_blocks.0"
        for n in ("norm1", "norm2", "norm3"):
            norm(f"{tb}.{n}", c)
        for a, src in (("attn1", c), ("attn2", ctx)):
            lin(f"{tb}.{a}.to_q", c, c, bias=False)
            lin(f"{tb}.{a}.to_k", src, c, bias=False)
            lin(f"{tb}.{a}.to_v", src, c, bias=False)
            lin(f"{tb}.{a}.to_out.0", c, c)
        lin(f"{tb}.ff.net.0.proj", c, 8 * c)
        lin(f"{tb}.ff.net.2", 4 * c, c)

    lin("time_embed.0", ch0, 4 * ch0)
    lin("time_embed.2", 4 * ch0, 4 * ch0)
    conv("input_blocks.0.0", in_ch, ch0, 3)
    levels, n, c, skips = len(mult), 1, ch0, [ch0]
    for i, m in enumerate(mult):
        for _ in range(nrb):
            res(f"input_blocks.{n}.0", c, ch0 * m)
            c = ch0 * m
            if i < levels - 1:
                attn(f"input_blocks.{n}.1", c)
            skips.append(c)
            n += 1
        if i < levels - 1:
            conv(f"input_blocks.{n}.0.op", c, c, 3)
            skips.append(c)
            n += 1
    res("middle_block.0", c, c)
    attn("middle_block.1", c)
    res("middle_block.2", c, c)
    n = 0
    for i in reversed(range(levels)):
        for j in range(nrb + 1):
            res(f"output_blocks.{n}.0", c + skips.pop(), ch0 * mult[i])
            c = ch0 * mult[i]
            if i < levels - 1:
                attn(f"output_blocks.{n}.1", c)
            if i > 0 and j == nrb:
                conv(f"output_blocks.{n}.{1 if i == levels - 1 else 2}.conv", c, c, 3)
            n += 1
    norm("out.0", c)
    conv("out.2", c, out_ch, 3)
    return sd


def train_configs(**extra):
    """(port config, JAX config): synthetic_tiny with the tiny panoptic UNet."""
    config = get_config("synthetic_tiny")
    # channel_mult (2, 2): 64 channels at both levels.  GroupNorm-32 over 32
    # channels is one channel a group, which cancels a conv bias exactly and
    # leaves AdamW normalising rounding noise; two levels halve JAX's compile.
    config.nnet = d(**unet_fields(channel_mult=[2, 2]))
    config.sample.algorithm = "pndm"
    config.use_unet = True
    config.num_workers = 0
    config.update(extra)
    jconfig = jax_get_config("synthetic_tiny")
    for key, value in config.items():
        if key not in ("config_name", "mesh"):
            jconfig[key] = ml_collections.ConfigDict(dict(value)) if isinstance(value, dict) \
                else value
    return config, jconfig


def train_jax_trainer(jconfig, params, optimizer: str = "adamw", frozen_mask=None):
    """A JAX `Trainer` with what `_loss` / `_train_step_impl` read, its state
    made from `params` as `__init__` makes it (no pretrained, no mesh)."""
    jt = JaxTrainer.__new__(JaxTrainer)
    jt.config, jt.task = jconfig, jconfig.task
    kwargs = dict(jconfig.nnet)
    kwargs.pop("use_ground_truth", None)
    jt.nnet = jax_get_nnet(kwargs.pop("name"), dtype=jnp.float32, **kwargs)
    jt._pipe_apply = None
    jt.schedule = JaxSchedule(stable_diffusion_beta_schedule())
    jt.rng = jax.random.PRNGKey(jconfig.seed)
    lr = jax_lr_schedule(jconfig.optimizer.lr, jconfig.lr_scheduler.name,
                         warmup_steps=jconfig.lr_scheduler.get("warmup_steps", -1),
                         total_steps=jconfig.train.n_steps)
    tx = make_optimizer(optimizer, lr_schedule=lr, weight_decay=jconfig.optimizer.weight_decay,
                        betas=tuple(jconfig.optimizer.betas), frozen_mask=frozen_mask)
    jt.state = create_train_state(params, tx)
    jt._train_step = jax.jit(jt._train_step_impl)
    return jt
