"""CelebA-64 U-ViT-S/4, unconditional in pixel space, the continuous VP SDE
(reference configs/celeba64_uvit_small.py)."""
from .base import adamw, base_config, d, sample_block, train_block, uvit, warmup


def get_config():
    config = base_config()
    config.task = "pixel_sde"
    config.train = train_block(500000, 128, mode="uncond")
    config.optimizer = adamw(2e-4, 0.03, (0.99, 0.999))
    config.lr_scheduler = warmup(2500)
    config.nnet = uvit(img_size=64, patch_size=4, embed_dim=512, depth=12, num_heads=8)
    config.dataset = d(name="celeba", path="assets/datasets/celeba")
    config.sample = sample_block(1000, 50000, 500, algorithm="euler_maruyama_sde")
    return config
