"""Tiny synthetic pixel-space config for CPU runs (no reference analogue):
cifar10_uvit_small's task and structure (pixel_sde, unconditional, the
continuous VP SDE, Euler-Maruyama) cut to width 32, depth 4 on 8x8x3
images, in f32."""
from .base import adamw, base_config, d, sample_block, train_block, uvit, warmup


def get_config():
    config = base_config()
    config.task = "pixel_sde"
    config.compute_dtype = "float32"
    config.train = train_block(20, 16, mode="uncond", log_interval=5, eval_interval=1000,
                               save_interval=1000)
    config.optimizer = adamw(2e-4, 0.03, (0.9, 0.9))
    config.lr_scheduler = warmup(10)
    config.nnet = uvit(img_size=8, patch_size=2, embed_dim=32, depth=4, num_heads=4,
                       mlp_ratio=2)
    config.dataset = d(name="synthetic", style="pixels", n=64, z_shape=(8, 8, 3))
    config.sample = sample_block(10, 16, 8, algorithm="euler_maruyama_sde")
    return config
