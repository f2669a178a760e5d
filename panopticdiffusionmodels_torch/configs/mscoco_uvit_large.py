"""MS-COCO U-ViT-L/2 panoptic (reference configs/mscoco_uvit_large.py)."""
from .base import adamw, autoencoder_block, base_config, d, sample_block, train_block, uvit_t2i, warmup


def get_config():
    config = base_config()
    config.task = "t2i_discrete"
    config.z_shape = (32, 32, 4)
    config.autoencoder = autoencoder_block(scale_factor=0.23010)
    config.train = train_block(1000000, 64, log_interval=20)
    config.optimizer = adamw(2e-4, 0.03, (0.9, 0.9))
    config.lr_scheduler = warmup(5000)
    config.nnet = uvit_t2i(img_size=32, patch_size=2, embed_dim=1024, depth=20, num_heads=16,
                           scan_blocks=True, enable_panoptic=True, separate=True,
                           use_checkpoint=True, mask_size=64)
    config.dataset = d(name="mscoco256_features", path="assets/datasets/coco256_features",
                       cfg=True, p_uncond=0.1)
    config.sample = sample_block(50, 30000, 32, algorithm="dpm_solver", cfg=True, scale=1.0)
    return config
