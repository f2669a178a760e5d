"""Config zoo of the port: the configs it serves so far."""
import importlib

CONFIG_NAMES = ["mscoco_uvit_small", "synthetic_tiny"]


def get_config(name: str):
    if name not in CONFIG_NAMES:
        raise KeyError(f"unknown config {name!r}; available: {CONFIG_NAMES}")
    config = importlib.import_module(f"{__name__}.{name}").get_config()
    config.config_name = name
    return config
