"""Carry the JAX package's parameters into the port's state dicts.

Both directions of the weight story end in the reference's state-dict names
(`libs/uvit.py`, `libs/uvit_t2i.py`, `libs/autoencoder.py`), which are the port modules' own
names.  Inputs are nested mappings of numpy arrays (a flax `params` tree after
`jax.tree.map(np.asarray, ...)`); this module uses numpy only.

The UNet's names are the JAX package's own (`models/unet.py`), since the
reference's UNet module was never published.

Layouts: flax Dense (in, out) -> Linear (out, in); flax Conv (H, W, I, O) ->
Conv2d (O, I, H, W); the patch-embedding Dense (p*p*C, D), whose per-patch
vector is ordered (p1, p2, C), -> Conv2d (D, C, p, p); the zero-conv Dense
(I, O) -> Conv1d (O, I, 1); LayerNorm/GroupNorm scale -> weight.
"""
from __future__ import annotations

from typing import Dict, List, Mapping

import numpy as np
import torch

from .ldm_bridge import load_ldm_unet


def _tree_map(fn, tree):
    if isinstance(tree, Mapping):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _first_leaf(tree):
    while isinstance(tree, Mapping):
        tree = next(iter(tree.values()))
    return tree


def _unstack(tree) -> List[dict]:
    """Split a scanned (stacked on axis 0) parameter tree into per-layer trees."""
    n = np.asarray(_first_leaf(tree)).shape[0]
    return [_tree_map(lambda a, i=i: np.asarray(a)[i], tree) for i in range(n)]


def _linear(t, prefix, out):
    out[f"{prefix}.weight"] = np.ascontiguousarray(np.asarray(t["kernel"]).T)
    if "bias" in t:
        out[f"{prefix}.bias"] = np.asarray(t["bias"])


def _conv2d(t, prefix, out):
    out[f"{prefix}.weight"] = np.ascontiguousarray(np.asarray(t["kernel"]).transpose(3, 2, 0, 1))
    out[f"{prefix}.bias"] = np.asarray(t["bias"])


def _conv1d(t, prefix, out):
    out[f"{prefix}.weight"] = np.ascontiguousarray(np.asarray(t["kernel"]).T)[:, :, None]
    out[f"{prefix}.bias"] = np.asarray(t["bias"])


def _patch_embed(t, prefix, out, patch_size):
    k = np.asarray(t["proj"]["kernel"])  # (p*p*C, D)
    p = patch_size
    w = k.reshape(p, p, k.shape[0] // (p * p), k.shape[1]).transpose(3, 2, 0, 1)
    out[f"{prefix}.weight"] = np.ascontiguousarray(w)
    out[f"{prefix}.bias"] = np.asarray(t["proj"]["bias"])


def _norm(t, prefix, out):
    out[f"{prefix}.weight"] = np.asarray(t["scale"])
    out[f"{prefix}.bias"] = np.asarray(t["bias"])


def _block(t, prefix, out):
    _norm(t["norm1"], f"{prefix}.norm1", out)
    _linear(t["attn"]["qkv"], f"{prefix}.attn.qkv", out)
    _linear(t["attn"]["proj"], f"{prefix}.attn.proj", out)
    _norm(t["norm2"], f"{prefix}.norm2", out)
    _linear(t["mlp"]["fc1"], f"{prefix}.mlp.fc1", out)
    _linear(t["mlp"]["fc2"], f"{prefix}.mlp.fc2", out)
    if "skip_linear" in t:
        _linear(t["skip_linear"], f"{prefix}.skip_linear", out)


def uvit_state_dict(params: Mapping, *, patch_size: int) -> Dict[str, np.ndarray]:
    """JAX `UViT` params (scanned or unrolled) -> the port's state dict, key
    for key the JAX package's `export_uvit`."""
    p = params["params"] if "params" in params else params
    out: Dict[str, np.ndarray] = {}
    _patch_embed(p["patch_embed"], "patch_embed.proj", out, patch_size)
    if "time_embed" in p:
        _linear(p["time_embed"]["fc1"], "time_embed.0", out)
        _linear(p["time_embed"]["fc2"], "time_embed.2", out)
    if "label_emb" in p:
        out["label_emb.weight"] = np.asarray(p["label_emb"]["embedding"])
    out["pos_embed"] = np.asarray(p["pos_embed"])
    if "in_blocks" in p:  # scanned
        ins, outs = _unstack(p["in_blocks"]["block"]), _unstack(p["out_blocks"]["block"])
    else:
        n = len([k for k in p if k.startswith("in_blocks_")])
        ins = [p[f"in_blocks_{i}"] for i in range(n)]
        outs = [p[f"out_blocks_{i}"] for i in range(n)]
    for i, t in enumerate(ins):
        _block(t, f"in_blocks.{i}", out)
    _block(p["mid_block"], "mid_block", out)
    for i, t in enumerate(outs):
        _block(t, f"out_blocks.{i}", out)
    _norm(p["norm"], "norm", out)
    _linear(p["decoder_pred"], "decoder_pred", out)
    if "final_layer" in p:
        _conv2d(p["final_layer"]["conv"], "final_layer", out)
    return out


def uvit_t2i_state_dict(params: Mapping, *, patch_size: int,
                        mask_patch_size: int = None) -> Dict[str, np.ndarray]:
    """JAX `UViTT2I` params (scanned or unrolled) -> the port's state dict."""
    p = params["params"] if "params" in params else params
    out: Dict[str, np.ndarray] = {}
    _patch_embed(p["patch_embed"], "patch_embed.proj", out, patch_size)
    if "time_embed" in p:
        _linear(p["time_embed"]["fc1"], "time_embed.0", out)
        _linear(p["time_embed"]["fc2"], "time_embed.2", out)
    _linear(p["context_embed"], "context_embed", out)
    out["pos_embed"] = np.asarray(p["pos_embed"])
    _norm(p["norm"], "norm", out)
    _linear(p["decoder_pred"], "decoder_pred", out)
    if "final_layer" in p:
        _conv2d(p["final_layer"]["conv"], "final_layer", out)

    ins_m = outs_m = zin = zout = []
    if "in_blocks_dual" in p:  # scanned dual stream
        ind, outd = p["in_blocks_dual"], p["out_blocks_dual"]
        ins, outs = _unstack(ind["block"]), _unstack(outd["block"])
        if "block_mask" in ind:
            ins_m, outs_m = _unstack(ind["block_mask"]), _unstack(outd["block_mask"])
            zin, zout = _unstack(ind["zero_conv"]), _unstack(outd["zero_conv"])
    elif "in_blocks" in p:  # scanned single stream
        ins, outs = _unstack(p["in_blocks"]["block"]), _unstack(p["out_blocks"]["block"])
    else:
        n = len([k for k in p if k.startswith("in_blocks_") and "mask" not in k])
        ins = [p[f"in_blocks_{i}"] for i in range(n)]
        outs = [p[f"out_blocks_{i}"] for i in range(n)]
        if "in_blocks_mask_0" in p:
            ins_m = [p[f"in_blocks_mask_{i}"] for i in range(n)]
            outs_m = [p[f"out_blocks_mask_{i}"] for i in range(n)]
            zin = [p[f"zero_convs_in_{i}"] for i in range(n)]
            zout = [p[f"zero_convs_out_{i}"] for i in range(n)]
    half = len(ins)
    for i, t in enumerate(ins):
        _block(t, f"in_blocks.{i}", out)
    _block(p["mid_block"], "mid_block", out)
    for i, t in enumerate(outs):
        _block(t, f"out_blocks.{i}", out)

    if "mask_embed" in p:
        _patch_embed(p["mask_embed"], "mask_embed.proj", out, mask_patch_size or patch_size)
        _linear(p["decoder_pred_mask"], "decoder_pred_mask", out)
        if "final_layer_mask" in p:
            _conv2d(p["final_layer_mask"]["conv"], "final_layer_mask", out)
        if "pos_embed_mask" in p:
            out["pos_embed_mask"] = np.asarray(p["pos_embed_mask"])
        if "mid_block_mask" in p:
            _block(p["mid_block_mask"], "mid_block_mask", out)
            _conv1d(p["zero_convs_mid"]["conv"], f"zero_convs.{2 * half + 1}.conv", out)
        for i, t in enumerate(ins_m):
            _block(t, f"in_blocks_mask.{i}", out)
        for i, t in enumerate(outs_m):
            _block(t, f"out_blocks_mask.{i}", out)
        for i, t in enumerate(zin):
            _conv1d(t["conv"], f"zero_convs.{2 * i + 1}.conv", out)
        for i, t in enumerate(zout):
            _conv1d(t["conv"], f"zero_convs.{2 * (half + 1 + i) + 1}.conv", out)
    return out


def unet_state_dict(params: Mapping) -> Dict[str, np.ndarray]:
    """JAX `UNet2DCondition` params -> the port's state dict.  The port's
    module names are JAX's, so every path maps as it is: Dense -> Linear,
    Conv HWIO -> OIHW, norm `scale` -> `weight`."""
    p = params["params"] if "params" in params else params
    out: Dict[str, np.ndarray] = {}

    def walk(tree, prefix):
        if "scale" in tree:
            _norm(tree, prefix, out)
        elif "kernel" in tree:
            (_linear if np.ndim(tree["kernel"]) == 2 else _conv2d)(tree, prefix, out)
        else:
            for name, sub in tree.items():
                walk(sub, f"{prefix}.{name}" if prefix else name)

    walk(p, "")
    return out


def _resnet(t, prefix, out):
    _norm(t["norm1"], f"{prefix}.norm1", out)
    _conv2d(t["conv1"], f"{prefix}.conv1", out)
    _norm(t["norm2"], f"{prefix}.norm2", out)
    _conv2d(t["conv2"], f"{prefix}.conv2", out)
    if "nin_shortcut" in t:
        _conv2d(t["nin_shortcut"], f"{prefix}.nin_shortcut", out)


def _attn(t, prefix, out):
    _norm(t["norm"], f"{prefix}.norm", out)
    for name in ("q", "k", "v", "proj_out"):
        _conv2d(t[name], f"{prefix}.{name}", out)


def autoencoder_kl_state_dict(params: Mapping, *, ch_mult=(1, 2, 4, 4),
                              num_res_blocks: int = 2) -> Dict[str, np.ndarray]:
    """JAX `AutoencoderKL` params -> the port's (reference-format) state dict;
    the inverse of the JAX package's `convert_autoencoder_kl`."""
    p = params["params"] if "params" in params else params
    enc, dec = p["encoder"], p["decoder"]
    out: Dict[str, np.ndarray] = {}
    _conv2d(enc["conv_in"], "encoder.conv_in", out)
    for i in range(len(ch_mult)):
        for j in range(num_res_blocks):
            _resnet(enc[f"down_{i}_block_{j}"], f"encoder.down.{i}.block.{j}", out)
        if i != len(ch_mult) - 1:
            _conv2d(enc[f"down_{i}_downsample"]["conv"], f"encoder.down.{i}.downsample.conv", out)
    for side, tree in (("encoder", enc), ("decoder", dec)):
        _resnet(tree["mid_block_1"], f"{side}.mid.block_1", out)
        _attn(tree["mid_attn_1"], f"{side}.mid.attn_1", out)
        _resnet(tree["mid_block_2"], f"{side}.mid.block_2", out)
        _norm(tree["norm_out"], f"{side}.norm_out", out)
        _conv2d(tree["conv_out"], f"{side}.conv_out", out)
    _conv2d(dec["conv_in"], "decoder.conv_in", out)
    for i in range(len(ch_mult)):
        for j in range(num_res_blocks + 1):
            _resnet(dec[f"up_{i}_block_{j}"], f"decoder.up.{i}.block.{j}", out)
        if i != 0:
            _conv2d(dec[f"up_{i}_upsample"]["conv"], f"decoder.up.{i}.upsample.conv", out)
    _conv2d(p["quant_conv"], "quant_conv", out)
    _conv2d(p["post_quant_conv"], "post_quant_conv", out)
    return out


def reference_nnet_state_dict(sd: Mapping) -> Dict[str, torch.Tensor]:
    """A reference U-ViT-T2I checkpoint's state dict as the port's module takes
    it: the reference allocates 2*depth+2 zero convs but its forward uses only
    the odd indices, so the unused even-index ones are dropped."""
    out = {}
    for k, v in sd.items():
        parts = k.split(".")
        if parts[0] == "zero_convs" and int(parts[1]) % 2 == 0:
            continue
        out[k] = torch.as_tensor(np.asarray(v)) if not torch.is_tensor(v) else v
    return out


def load_nnet_state_dict(nnet: torch.nn.Module, sd: Mapping, nnet_config) -> None:
    """A checkpoint into the network of a config's `nnet` fields, strictly: an
    LDM / miniSD UNet checkpoint into a `unet_t2i`'s image stream
    (`utils/ldm_bridge.py`), else a reference-format state dict."""
    if nnet_config.name == "unet_t2i":
        load_ldm_unet(nnet, sd, channel_mult=tuple(nnet_config.channel_mult),
                      num_res_blocks=nnet_config.num_res_blocks)
    else:
        nnet.load_state_dict(reference_nnet_state_dict(sd), strict=True)


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return sd["state_dict"] if "state_dict" in sd else sd


def to_tensors(sd: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


_SAFETENSORS_DTYPES = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
                       "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
                       "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
                       "BOOL": torch.bool}


def load_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A `.safetensors` file -> CPU tensors: an 8-byte little-endian header
    length, a JSON header of {name: {dtype, shape, data_offsets}}, then the
    raw little-endian tensor bytes (offsets count from the end of the header)."""
    import json
    import struct

    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = bytearray(f.read())
    out = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        begin, end = meta["data_offsets"]
        dtype = _SAFETENSORS_DTYPES[meta["dtype"]]
        flat = (torch.frombuffer(data, dtype=dtype, offset=begin,
                                 count=(end - begin) // dtype.itemsize)
                if end > begin else torch.empty(0, dtype=dtype))
        out[name] = flat.reshape(meta["shape"]).clone()
    return out
