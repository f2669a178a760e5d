"""Tiny synthetic panoptic config for CPU tests (no reference analogue)."""
from .base import adamw, autoencoder_block, base_config, d, sample_block, train_block, uvit_t2i, warmup


def get_config():
    config = base_config()
    config.task = "t2i_discrete"
    config.z_shape = (8, 8, 4)
    config.compute_dtype = "float32"
    config.autoencoder = autoencoder_block(scale_factor=0.23010)
    config.train = train_block(20, 16, log_interval=5, eval_interval=1000, save_interval=1000)
    config.optimizer = adamw(2e-4, 0.03, (0.9, 0.9))
    config.lr_scheduler = warmup(10)
    config.nnet = uvit_t2i(img_size=8, patch_size=2, embed_dim=32, depth=4, num_heads=4,
                           mlp_ratio=2, clip_dim=16, num_clip_token=7,
                           enable_panoptic=True, separate=True, mask_size=16)
    config.dataset = d(name="synthetic", n=64, z_shape=(8, 8, 8), clip_shape=(7, 16),
                       mask_size=16)
    config.sample = sample_block(9, 16, 8, algorithm="dpm_solver", cfg=True, scale=1.0)
    return config
