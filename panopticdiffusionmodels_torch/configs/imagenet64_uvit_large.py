"""ImageNet-64 U-ViT-L/4, class-conditional in pixel space, the continuous VP
SDE sampled by 50-step DPM-Solver (reference configs/imagenet64_uvit_large.py)."""
from .base import adamw, base_config, d, sample_block, train_block, uvit, warmup


def get_config():
    config = base_config()
    config.task = "pixel_sde"
    config.train = train_block(300000, 1024, mode="cond")
    config.optimizer = adamw(3e-4, 0.03, (0.99, 0.99))
    config.lr_scheduler = warmup(5000)
    config.nnet = uvit(img_size=64, patch_size=4, embed_dim=1024, depth=20, num_heads=16,
                       num_classes=1000, use_checkpoint=True, scan_blocks=True)
    config.dataset = d(name="imagenet", path="assets/datasets/imagenet")
    config.sample = sample_block(50, 50000, 200, algorithm="dpm_solver")
    return config
