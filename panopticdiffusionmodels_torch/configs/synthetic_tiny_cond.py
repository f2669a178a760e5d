"""Tiny synthetic class-conditional latent config for CPU tests (no reference
analogue): imagenet256_uvit_large's task and structure cut to width 32, depth
4 and 11 classes on 8x8x4 latents, in f32."""
from .base import adamw, autoencoder_block, base_config, d, sample_block, train_block, uvit, warmup


def get_config():
    config = base_config()
    config.task = "latent_discrete"
    config.z_shape = (8, 8, 4)
    config.compute_dtype = "float32"
    config.autoencoder = autoencoder_block()
    config.train = train_block(20, 16, mode="cond", log_interval=5, eval_interval=1000,
                               save_interval=1000)
    config.optimizer = adamw(2e-4, 0.03, (0.9, 0.9))
    config.lr_scheduler = warmup(10)
    config.nnet = uvit(img_size=8, patch_size=2, in_chans=4, embed_dim=32, depth=4,
                       num_heads=4, mlp_ratio=2, num_classes=11)
    config.dataset = d(name="synthetic", style="imagenet", n=64, z_shape=(8, 8, 8),
                       num_classes=11)
    config.sample = sample_block(9, 16, 8, algorithm="dpm_solver", cfg=True, scale=0.4)
    return config
