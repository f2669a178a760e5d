"""Config builders, as plain dicts with attribute access.

Same field names and values as `panopticdiffusionmodels_tpu/configs/base.py`
(channel-last `z_shape`, `nnet.name`, `mask_bits` / `mask_size`,
`compute_dtype`), for the configs this port serves.  `mesh.sp_mode` is the
port's own: how `mesh.sp > 1` is laid out (`parallel/mesh.py`), one process
per sp rank ('process_group', under torchrun) or every shard in one process
on one device ('in_process').
"""
from __future__ import annotations


class ConfigDict(dict):
    """dict with attribute access: the part of ml_collections' ConfigDict the
    port uses."""

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __setattr__(self, key, value):
        self[key] = value

    def __delattr__(self, key):
        del self[key]


def d(**kwargs) -> ConfigDict:
    return ConfigDict(kwargs)


def base_config(seed: int = 1234) -> ConfigDict:
    return d(seed=seed, task="", pred="noise_pred", compute_dtype="bfloat16",
             ema_rate=0.9999, workdir="", pretrained="", mask_channel=1,
             mesh=d(dp=-1, fsdp=1, sp=1, tp=1, pp=1, sp_mode="process_group"))


def adamw(lr=2e-4, weight_decay=0.03, betas=(0.99, 0.999)):
    return d(name="adamw", lr=lr, weight_decay=weight_decay, betas=list(betas))


def warmup(steps):
    return d(name="customized", warmup_steps=steps)


def train_block(n_steps, batch_size, mode=None, log_interval=10, eval_interval=5000,
                save_interval=50000):
    cfg = d(n_steps=n_steps, batch_size=batch_size, log_interval=log_interval,
            eval_interval=eval_interval, save_interval=save_interval)
    if mode is not None:
        cfg.mode = mode
    return cfg


def autoencoder_block(pretrained_path="assets/stable-diffusion/autoencoder_kl.pth",
                      scale_factor=0.18215):
    return d(pretrained_path=pretrained_path, scale_factor=scale_factor)


def uvit(img_size, patch_size, embed_dim, depth, num_heads, in_chans=3, num_classes=-1,
         mlp_ratio=4, qkv_bias=False, mlp_time_embed=False, use_checkpoint=False, conv=True,
         scan_blocks=False, remat_policy="save_attn", gelu_approx=False):
    return d(name="uvit", remat_policy=remat_policy, gelu_approx=gelu_approx,
             img_size=img_size, patch_size=patch_size, in_chans=in_chans,
             embed_dim=embed_dim, depth=depth, num_heads=num_heads, mlp_ratio=mlp_ratio,
             qkv_bias=qkv_bias, mlp_time_embed=mlp_time_embed, num_classes=num_classes,
             use_checkpoint=use_checkpoint, conv=conv, scan_blocks=scan_blocks)


def uvit_t2i(img_size, patch_size, embed_dim, depth, num_heads, in_chans=4,
             mlp_ratio=4, qkv_bias=False, mlp_time_embed=False, clip_dim=768,
             num_clip_token=77, enable_panoptic=True, separate=True,
             use_ground_truth=False, mask_bits=8, mask_size=None,
             use_checkpoint=False, conv=True, scan_blocks=False,
             remat_policy="save_attn", gelu_approx=False):
    return d(name="uvit_t2i", remat_policy=remat_policy, gelu_approx=gelu_approx,
             img_size=img_size, patch_size=patch_size, in_chans=in_chans,
             embed_dim=embed_dim, depth=depth, num_heads=num_heads, mlp_ratio=mlp_ratio,
             qkv_bias=qkv_bias, mlp_time_embed=mlp_time_embed, clip_dim=clip_dim,
             num_clip_token=num_clip_token, enable_panoptic=enable_panoptic,
             separate=separate, use_ground_truth=use_ground_truth, mask_bits=mask_bits,
             mask_size=mask_size if mask_size is not None else 2 * img_size,
             use_checkpoint=use_checkpoint, conv=conv, scan_blocks=scan_blocks)


def sample_block(sample_steps, n_samples, mini_batch_size, algorithm="dpm_solver",
                 cfg=False, scale=0.0, path="", accel=0.0, cfg_interval=(),
                 cfg_interval_mask_hold=True):
    return d(sample_steps=sample_steps, n_samples=n_samples,
             mini_batch_size=mini_batch_size, algorithm=algorithm, cfg=cfg, scale=scale,
             path=path, accel=accel, cfg_interval=tuple(cfg_interval),
             cfg_interval_mask_hold=cfg_interval_mask_hold)
