"""Tiny sizes of each configuration for the CPU tests: every width cut, the
depth at one in-block, one mid, one out-block, f32 compute, few steps."""
from __future__ import annotations

VAE = {"ch": 32, "ch_mult": [1, 2], "num_res_blocks": 1}

SHRINK = {
    "mscoco_uvit_small": {
        "config": {"z_shape": [8, 8, 4], "compute_dtype": "float32",
                   "nnet": {"img_size": 8, "embed_dim": 32, "depth": 2, "num_heads": 2,
                            "mask_size": 16, "clip_dim": 16, "num_clip_token": 7},
                   "sample": {"sample_steps": 4}, "train": {"batch_size": 4}},
        "vae_geometry": VAE, "request_images": 3, "check_images": 4, "reference_rows": 2},
    "imagenet256_uvit_large": {
        "config": {"z_shape": [8, 8, 4], "compute_dtype": "float32",
                   "nnet": {"img_size": 8, "embed_dim": 32, "depth": 2, "num_heads": 2},
                   "sample": {"sample_steps": 4}, "train": {"batch_size": 4}},
        "vae_geometry": VAE, "request_images": 3, "check_images": 4, "reference_rows": 2},
}


def shrink_of(cell):
    from benchmark import harness

    return SHRINK[harness.cell(cell)["config"]]
