"""Config zoo of the port: the JAX zoo's 16 names and the port's CPU configs."""
import importlib

CONFIG_NAMES = ["cifar10_uvit_small", "celeba64_uvit_small", "imagenet64_uvit_mid",
                "imagenet64_uvit_large", "imagenet256_uvit_large", "imagenet256_uvit_huge",
                "imagenet512_uvit_large", "imagenet512_uvit_huge", "mscoco_uvit_small",
                "mscoco_uvit_mid", "mscoco_uvit_large", "mscoco_uvit_small_512",
                "mscoco_stable_diffusion", "mscoco_unet", "mscoco_unet_512", "synthetic_tiny",
                "synthetic_tiny_cond", "synthetic_tiny_pixel"]


def get_config(name: str):
    if name not in CONFIG_NAMES:
        raise KeyError(f"unknown config {name!r}; available: {CONFIG_NAMES}")
    config = importlib.import_module(f"{__name__}.{name}").get_config()
    config.config_name = name
    return config
