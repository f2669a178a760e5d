"""LDM / miniSD UNet checkpoint -> the port's `UNet2DCondition` state dict.

Port of `panopticdiffusionmodels_tpu/utils/ldm_bridge.py::convert_ldm_unet`
(the role of the reference's LDM -> diffusers renaming, `utils.py:149-271`,
on its use_unet path).  Both the source (CompVis LDM, keys under
`model.diffusion_model.`) and the port are PyTorch layouts, so the
conversion is a renaming of module prefixes; the tables are JAX's:

  time_embed.{0,2}                         -> time_fc1 / time_fc2
  input_blocks.0.0                          -> conv_in
  input_blocks.{n}.0  (ResBlock)            -> down_{i}_res_{j}
  input_blocks.{n}.1  (SpatialTransformer)  -> down_{i}_attn_{j}
  input_blocks.{n}.0.op (Downsample)        -> down_{i}_downsample
  middle_block.{0,1,2}                      -> mid_res_1 / mid_attn / mid_res_2
  output_blocks.{n}.{0,1,2}                 -> up_{i}_res_{j} / up_{i}_attn_{j} /
                                               up_{i}_upsample
  out.{0,2}                                 -> norm_out / conv_out

It assumes the SD-1.x shape (attention at every level but the deepest, 1x1
conv proj_in / proj_out).  The output covers the image stream only; the mask
stream keeps its own initialisation, zero-gated, so the loaded model's image
behaviour is the checkpoint's.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Sequence

import numpy as np
import torch

PREFIX = "model.diffusion_model."
MASK_STREAM = "mask_"  # the first word of every mask-stream module name


def _copy(sd, src: str, dst: str, out: dict, bias: str = "required") -> None:
    """`src`.weight (and .bias: 'required', 'optional' or 'none') -> `dst`."""
    out[f"{dst}.weight"] = sd[f"{src}.weight"]
    if bias == "required" or (bias == "optional" and f"{src}.bias" in sd):
        out[f"{dst}.bias"] = sd[f"{src}.bias"]


def _resblock(sd, src: str, dst: str, out: dict) -> None:
    for a, b in (("in_layers.0", "norm1"), ("in_layers.2", "conv1"),
                 ("out_layers.0", "norm2"), ("out_layers.3", "conv2")):
        _copy(sd, f"{src}.{a}", f"{dst}.{b}", out)
    _copy(sd, f"{src}.emb_layers.1", f"{dst}.time_emb_proj", out, bias="optional")
    if f"{src}.skip_connection.weight" in sd:
        _copy(sd, f"{src}.skip_connection", f"{dst}.shortcut", out)


def _transformer(sd, src: str, dst: str, out: dict) -> None:
    for name in ("norm", "proj_in", "proj_out"):
        _copy(sd, f"{src}.{name}", f"{dst}.{name}", out)
    tb, block = f"{src}.transformer_blocks.0", f"{dst}.block_0"
    for name in ("norm1", "norm2", "norm3"):
        _copy(sd, f"{tb}.{name}", f"{block}.{name}", out)
    for attn in ("attn1", "attn2"):
        for name in ("to_q", "to_k", "to_v"):
            _copy(sd, f"{tb}.{attn}.{name}", f"{block}.{attn}.{name}", out, bias="none")
        _copy(sd, f"{tb}.{attn}.to_out.0", f"{block}.{attn}.to_out", out, bias="optional")
    _copy(sd, f"{tb}.ff.net.0.proj", f"{block}.ff_proj", out, bias="optional")
    _copy(sd, f"{tb}.ff.net.2", f"{block}.ff_out", out, bias="optional")


def convert_ldm_unet(state_dict: Mapping, *, channel_mult: Sequence[int] = (1, 2, 4, 4),
                     num_res_blocks: int = 2) -> Dict[str, torch.Tensor]:
    """LDM state dict (optionally `model.diffusion_model.`-prefixed; other
    keys, e.g. a full checkpoint's VAE and text encoder, are ignored) -> the
    port's image-stream state dict.  A key the tables need and the checkpoint
    lacks raises KeyError."""
    sd = {}
    for k, v in state_dict.items():
        if k.startswith(PREFIX):
            k = k[len(PREFIX):]
        sd[k] = v if torch.is_tensor(v) else torch.from_numpy(np.array(v))

    out: Dict[str, torch.Tensor] = {}
    _copy(sd, "time_embed.0", "time_fc1", out, bias="optional")
    _copy(sd, "time_embed.2", "time_fc2", out, bias="optional")
    _copy(sd, "input_blocks.0.0", "conv_in", out)
    _copy(sd, "out.0", "norm_out", out)
    _copy(sd, "out.2", "conv_out", out)
    _resblock(sd, "middle_block.0", "mid_res_1", out)
    _transformer(sd, "middle_block.1", "mid_attn", out)
    _resblock(sd, "middle_block.2", "mid_res_2", out)

    levels = len(channel_mult)
    n = 1
    for i in range(levels):
        for j in range(num_res_blocks):
            _resblock(sd, f"input_blocks.{n}.0", f"down_{i}_res_{j}", out)
            if i < levels - 1:
                _transformer(sd, f"input_blocks.{n}.1", f"down_{i}_attn_{j}", out)
            n += 1
        if i < levels - 1:
            _copy(sd, f"input_blocks.{n}.0.op", f"down_{i}_downsample", out)
            n += 1

    n = 0
    for i in reversed(range(levels)):
        for j in range(num_res_blocks + 1):
            _resblock(sd, f"output_blocks.{n}.0", f"up_{i}_res_{j}", out)
            if i < levels - 1:
                _transformer(sd, f"output_blocks.{n}.1", f"up_{i}_attn_{j}", out)
            if i > 0 and j == num_res_blocks:
                # the deepest level has no attention, so its upsampler is module 1
                up_idx = 2 if i < levels - 1 else 1
                _copy(sd, f"output_blocks.{n}.{up_idx}.conv", f"up_{i}_upsample", out)
            n += 1
    return out


def load_ldm_unet(model: torch.nn.Module, state_dict: Mapping, *,
                  channel_mult: Sequence[int], num_res_blocks: int) -> List[str]:
    """Convert an LDM checkpoint and load it into `model`, strictly on the
    image stream: every converted key must be the model's and every model key
    outside the mask stream must be loaded, else ValueError.  Returns the
    missing keys, the mask stream's."""
    converted = convert_ldm_unet(state_dict, channel_mult=channel_mult,
                                 num_res_blocks=num_res_blocks)
    result = model.load_state_dict(converted, strict=False)
    image_missing = [k for k in result.missing_keys if not k.startswith(MASK_STREAM)]
    if result.unexpected_keys or image_missing:
        raise ValueError(f"LDM checkpoint does not fit the UNet's image stream: unexpected "
                         f"{result.unexpected_keys[:8]}, missing {image_missing[:8]}")
    return result.missing_keys
