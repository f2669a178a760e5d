"""MS-COCO panoptic with an SD-style UNet backbone (reference configs/mscoco_unet.py).

The reference's `use_unet=True` depends on a privately patched diffusers
(`unet.add_mask_stream()` is not public); this config runs the package's own
UNet2DCondition with its zero-gated mask stream (models/unet.py), faithful to
the SD-1.x architecture the reference loads, sampled with PNDM."""
from .base import adamw, autoencoder_block, base_config, d, sample_block, train_block, warmup


def get_config():
    config = base_config()
    config.task = "t2i_discrete"
    config.z_shape = (32, 32, 4)
    config.autoencoder = autoencoder_block(scale_factor=0.18215)
    config.train = train_block(1000000, 8, log_interval=20)
    config.optimizer = adamw(2e-4, 0.03, (0.9, 0.9))
    config.lr_scheduler = warmup(5000)
    config.nnet = d(name="unet_t2i", sample_size=32, in_chans=4, out_chans=4, model_channels=320,
                    channel_mult=[1, 2, 4, 4], num_res_blocks=2, num_heads=8, clip_dim=768,
                    num_clip_token=77, enable_panoptic=True, mask_bits=8, mask_size=64)
    config.dataset = d(name="mscoco256_features", path="assets/datasets/coco256_sd_features",
                       cfg=True, p_uncond=0.1)
    config.sample = sample_block(50, 30000, 4, algorithm="pndm", cfg=True, scale=1.0)
    config.use_unet = True
    return config
