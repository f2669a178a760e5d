"""ImageNet-512 U-ViT-L/4 latent-space config (reference configs/imagenet512_uvit_large.py)."""
from .base import adamw, autoencoder_block, base_config, d, sample_block, train_block, uvit, warmup


def get_config():
    config = base_config()
    config.task = "latent_discrete"
    config.z_shape = (64, 64, 4)
    config.autoencoder = autoencoder_block()
    config.train = train_block(500000, 1024, mode="cond")
    config.optimizer = adamw(2e-4, 0.03, (0.99, 0.99))
    config.lr_scheduler = warmup(5000)
    config.nnet = uvit(img_size=64, patch_size=4, in_chans=4, embed_dim=1024, depth=20,
                       num_heads=16, num_classes=1001, use_checkpoint=True, scan_blocks=True)
    config.dataset = d(name="imagenet512_features", path="assets/datasets/imagenet512_features",
                       cfg=True, p_uncond=0.15)
    config.sample = sample_block(50, 50000, 50, algorithm="dpm_solver", cfg=True, scale=0.7)
    return config
