"""Config zoo of the port: the configs it serves so far."""
import importlib

CONFIG_NAMES = ["imagenet256_uvit_large", "mscoco_uvit_small", "mscoco_uvit_small_512",
                "synthetic_tiny", "synthetic_tiny_cond"]


def get_config(name: str):
    if name not in CONFIG_NAMES:
        raise KeyError(f"unknown config {name!r}; available: {CONFIG_NAMES}")
    config = importlib.import_module(f"{__name__}.{name}").get_config()
    config.config_name = name
    return config
