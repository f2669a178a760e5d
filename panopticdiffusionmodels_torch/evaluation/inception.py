"""The FID InceptionV3 pool3 feature extractor (inference only).

Port of `panopticdiffusionmodels_tpu/evaluation/inception.py`, which is the
pytorch-fid network (reference `tools/inception.py:16-328`): torchvision's
InceptionV3 with the FID patches,

  * the average pools of FIDInceptionA/C/E leave the padding out of the count
    (`count_include_pad=False`),
  * the second InceptionE (Mixed_7c) takes a MAX pool in its pool branch
    (reference `tools/inception.py:310-328`),
  * inputs in [0, 1] are resized to 299 x 299 like `jax.image.resize(...,
    "bilinear")` (half-pixel centres; antialiased when a side shrinks) and
    mapped to [-1, 1];
  * every convolution has no bias and a frozen BatchNorm with eps 1e-3.

The module is NCHW and its parameter names are pytorch-fid's and
torchvision's (`Conv2d_1a_3x3.conv.weight`, `Mixed_5b.branch_pool.bn.running_var`),
so `load_inception_weights` reads a `pt_inception-2015-12-05.pth` as it is.
The convolutions are cuDNN calls: the JAX package computes them with XLA,
not with a kernel of its own.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-3
SIZE = 299
# Keys of a torchvision / pytorch-fid state dict that pool3 does not use: the
# classifier heads and BatchNorm's step counter.
UNUSED_PREFIXES = ("fc.", "AuxLogits.")
UNUSED_SUFFIX = ".num_batches_tracked"


class FrozenBatchNorm2d(nn.Module):
    """BatchNorm2d in eval mode with eps 1e-3: weight, bias and the running
    statistics, and no step counter."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            training=False, eps=BN_EPS)


class BasicConv2d(nn.Module):
    """conv (no bias) -> frozen BN -> relu (torchvision's BasicConv2d)."""

    def __init__(self, cin: int, cout: int, kernel, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride, padding=padding, bias=False)
        self.bn = FrozenBatchNorm2d(cout)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _avg_pool(x):
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3, self.branch_pool(_avg_pool(x))], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, F.max_pool2d(x, 3, stride=2)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for conv in (self.branch7x7dbl_2, self.branch7x7dbl_3, self.branch7x7dbl_4,
                     self.branch7x7dbl_5):
            bd = conv(bd)
        return torch.cat([self.branch1x1(x), b7, bd, self.branch_pool(_avg_pool(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for conv in (self.branch7x7x3_2, self.branch7x7x3_3, self.branch7x7x3_4):
            b7 = conv(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, stride=2)], 1)


class InceptionE(nn.Module):
    """FIDInceptionE_1 (`max_pool=False`) or FIDInceptionE_2 (`max_pool=True`)."""

    def __init__(self, cin: int, max_pool: bool):
        super().__init__()
        self.max_pool = max_pool
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        bp = (F.max_pool2d(x, 3, stride=1, padding=1) if self.max_pool else _avg_pool(x))
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(bp)], 1)


class FIDInceptionV3(nn.Module):
    """pool3 of the FID InceptionV3: forward(x) takes NCHW images in [0, 1]
    of any size and returns (N, 2048)."""

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, max_pool=False)
        self.Mixed_7c = InceptionE(2048, max_pool=True)

    def forward(self, x, resize: bool = True, normalize: bool = True):
        if resize:
            x = resize_299(x)
        if normalize:
            x = 2.0 * x - 1.0
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, stride=2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, stride=2)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b", "Mixed_6c",
                     "Mixed_6d", "Mixed_6e", "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3))  # adaptive average pool -> (N, 2048)


def resize_299(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> (N, C, 299, 299) as `jax.image.resize(..., "bilinear")`: a
    triangle filter at half-pixel centres, widened by the scale (antialiased)
    along a side that shrinks.  torch's antialiased bilinear is that filter; on
    a side that grows it reduces to plain bilinear with align_corners=False."""
    h, w = x.shape[-2:]
    if (h, w) == (SIZE, SIZE):
        return x
    return F.interpolate(x, size=(SIZE, SIZE), mode="bilinear", align_corners=False,
                         antialias=h > SIZE or w > SIZE)


def _convs(model: nn.Module):
    """(name, BasicConv2d) in registration order: the order of the JAX
    `random_params` draws."""
    return [(n, m) for n, m in model.named_modules() if isinstance(m, BasicConv2d)]


def random_state_dict(seed: int = 0) -> Dict[str, np.ndarray]:
    """Random weights with the network's shapes (tests and smoke runs): the
    values of JAX `random_params(seed)` in this module's layout."""
    rng = np.random.default_rng(seed)
    with torch.device("meta"):
        model = FIDInceptionV3()
    out = {}
    for name, m in _convs(model):
        o, i, kh, kw = m.conv.weight.shape
        kernel = rng.normal(0, 0.05, (kh, kw, i, o)).astype(np.float32)
        out[f"{name}.conv.weight"] = np.ascontiguousarray(kernel.transpose(3, 2, 0, 1))
        out[f"{name}.bn.weight"] = np.ones(o, np.float32)
        out[f"{name}.bn.bias"] = np.zeros(o, np.float32)
        out[f"{name}.bn.running_mean"] = np.zeros(o, np.float32)
        out[f"{name}.bn.running_var"] = np.ones(o, np.float32)
    return out


def inception_state_dict(params: Mapping) -> Dict[str, np.ndarray]:
    """JAX Inception params (nested dicts of numpy arrays: HWIO kernels and
    bn_scale / bn_bias / bn_mean / bn_var) -> this module's state dict; the
    inverse of JAX `convert_torch_inception`."""
    out = {}
    with torch.device("meta"):
        model = FIDInceptionV3()
    for name, _ in _convs(model):
        p = params
        for part in name.split("."):
            p = p[part]
        out[f"{name}.conv.weight"] = np.ascontiguousarray(
            np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
        for ours, theirs in (("weight", "bn_scale"), ("bias", "bn_bias"),
                             ("running_mean", "bn_mean"), ("running_var", "bn_var")):
            out[f"{name}.bn.{ours}"] = np.asarray(p[theirs])
    return out


def load_inception_weights(path: str) -> FIDInceptionV3:
    """A FIDInceptionV3 with the weights of a pytorch-fid / torchvision state
    dict file (`pt_inception-2015-12-05.pth`), loaded strictly: the keys that
    pool3 does not use (`fc.*`, `AuxLogits.*`, `*.num_batches_tracked`) are
    dropped, and any other missing or unexpected key raises."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(sd, Mapping):
        raise ValueError(f"{path!r} holds a {type(sd).__name__}, not a state dict")
    sd = {k: v for k, v in sd.items()
          if not k.startswith(UNUSED_PREFIXES) and not k.endswith(UNUSED_SUFFIX)}
    model = FIDInceptionV3()
    model.load_state_dict(sd, strict=True)
    return model


def from_state_dict(sd: Mapping) -> FIDInceptionV3:
    """A FIDInceptionV3 holding the numpy / tensor state dict `sd`, strictly."""
    model = FIDInceptionV3()
    model.load_state_dict({k: torch.as_tensor(np.asarray(v)) for k, v in sd.items()},
                          strict=True)
    return model


@contextlib.contextmanager
def no_tf32():
    """cuDNN convolutions in full f32 inside the block (Hopper's default for
    them is TF32); the previous setting comes back on exit."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def make_extractor(model: FIDInceptionV3, device="cuda"):
    """[0, 1] NHWC images (numpy or tensor) -> (N, 2048) f32 features, a tensor
    on `device` (returned before the card finishes, so a caller can enqueue
    the next batch before it copies this one back).

    Computes in f32 like the JAX extractor: each call turns TF32 off for
    cuDNN's convolutions in a scoped context (`no_tf32`), not by a global
    flag.  Runs on the card unless the caller passes device="cpu"; it never
    moves to the CPU on its own."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_extractor(device='cuda'): no CUDA device; pass device='cpu'")
    model = model.to(device, torch.float32).eval()

    @torch.no_grad()
    def extract(images):
        x = torch.as_tensor(np.asarray(images) if not torch.is_tensor(images) else images)
        x = x.to(device, torch.float32, non_blocking=True).permute(0, 3, 1, 2)
        with no_tf32():
            return model(x)

    return extract
