"""MS-COCO 512 U-ViT-S/2 panoptic co-generation (reference
configs/mscoco_uvit_small_512.py): latent 64x64x4, mask 128x128 in 8 analog
bits (mask_patch_size 4, 1024 mask tokens), image stream L = 1102, mask
stream [x ; m] L = 2126, the geometry sequence parallelism (`mesh.sp`) is
for."""
from .base import adamw, autoencoder_block, base_config, d, sample_block, train_block, uvit_t2i, warmup


def get_config():
    config = base_config()
    config.task = "t2i_discrete"
    config.z_shape = (64, 64, 4)
    config.autoencoder = autoencoder_block(scale_factor=0.23010)
    config.train = train_block(2000000, 8, log_interval=20)
    config.optimizer = adamw(2e-4, 0.03, (0.9, 0.9))
    config.lr_scheduler = warmup(5000)
    config.nnet = uvit_t2i(img_size=64, patch_size=2, embed_dim=512, depth=12, num_heads=8,
                           enable_panoptic=True, separate=True, use_checkpoint=True,
                           scan_blocks=True, mask_size=128)
    config.dataset = d(name="mscoco256_features", path="assets/datasets/coco512_features",
                       cfg=True, p_uncond=0.1)
    config.sample = sample_block(50, 30000, 10, algorithm="dpm_solver", cfg=True, scale=1.0)
    return config
