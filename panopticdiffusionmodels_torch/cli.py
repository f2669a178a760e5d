"""Command-line entry point of the port:

    python -m panopticdiffusionmodels_torch train --config=<zoo name|file.py>
        [--workdir=DIR] [--config.a.b=value ...] [--device=cuda|cpu]

Port of `panopticdiffusionmodels_tpu/cli.py::main_train` (reference
`train.py:211-263`): a config from the port's zoo or a python file with
`get_config()`, `--config.` overrides (python literals, else strings), and a
workdir derived from the config name and the overridden fields.  Evaluation
and sample-grid callbacks come with the evaluation slice.

Sequence-parallel training on several cards, one process per sp rank:

    torchrun --nproc_per_node=2 -m panopticdiffusionmodels_torch train \
        --config=mscoco_uvit_small_512 --config.mesh.sp=2

Under torchrun (WORLD_SIZE set) the command joins the process group first:
NCCL with each process on `cuda:LOCAL_RANK`, or gloo with `--device=cpu`.
On one card, `--config.mesh.sp_mode=in_process` runs every shard in one
process instead.
"""
from __future__ import annotations

import ast
import importlib.util
import logging
import os
import sys
from typing import List, Optional

from .configs import CONFIG_NAMES, get_config


def load_config(spec: str):
    """Zoo name or path to a python file defining get_config()."""
    if spec in CONFIG_NAMES:
        return get_config(spec)
    if os.path.exists(spec):
        mod_spec = importlib.util.spec_from_file_location("user_config", spec)
        mod = importlib.util.module_from_spec(mod_spec)
        mod_spec.loader.exec_module(mod)
        config = mod.get_config()
        config.config_name = os.path.splitext(os.path.basename(spec))[0]
        return config
    raise SystemExit(f"unknown config {spec!r}; zoo: {CONFIG_NAMES}")


def apply_overrides(config, argv: List[str]) -> List[str]:
    """Apply `--config.a.b=v` flags; returns the hparam strings for the workdir."""
    hparams = []
    for arg in argv:
        if not arg.startswith("--config."):
            continue
        key, _, raw = arg[len("--config."):].partition("=")
        try:
            value = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            value = raw
        node = config
        parts = key.split(".")
        for p in parts[:-1]:
            node = node[p]
        node[parts[-1]] = value
        if not key.endswith("path"):
            hparams.append(f"{parts[-1]}={raw}")
    return hparams


def _parse(argv):
    opts = {"config": None, "workdir": None, "device": "cuda"}
    rest = []
    it = iter(argv)
    for arg in it:
        name = arg[2:].split("=", 1)[0] if arg.startswith("--") else None
        if name in opts:
            opts[name] = arg.split("=", 1)[1] if "=" in arg else next(it, None)
        else:
            rest.append(arg)
    if opts["config"] is None:
        raise SystemExit("usage: python -m panopticdiffusionmodels_torch train "
                         "--config=<zoo name|file.py> [--workdir=...] [--config.k=v ...] "
                         "[--device=cuda|cpu]")
    return opts, rest


def init_distributed(device: str) -> str:
    """Join the torchrun process group (nccl on cuda:LOCAL_RANK, gloo on the
    CPU) when WORLD_SIZE says there is one; returns the device to train on."""
    import torch
    import torch.distributed as dist

    if int(os.environ.get("WORLD_SIZE", "1")) <= 1 or dist.is_initialized():
        return device
    if device == "cpu":
        dist.init_process_group("gloo")
        return device
    local = int(os.environ.get("LOCAL_RANK", "0"))
    torch.cuda.set_device(local)
    dist.init_process_group("nccl", device_id=torch.device("cuda", local))
    return f"cuda:{local}"


def main_train(argv: List[str]):
    opts, rest = _parse(argv)
    device = init_distributed(opts["device"])
    config = load_config(opts["config"])
    hparams = apply_overrides(config, rest)
    config.hparams = "-".join(hparams) if hparams else "default"
    wd = opts["workdir"] or os.path.join("results", config.get("config_name", "run"),
                                         config.hparams)
    config.workdir = wd
    os.makedirs(wd, exist_ok=True)
    fmt = "%(asctime)s %(message)s"
    logging.basicConfig(level=logging.INFO, format=fmt)  # the console, once per process
    root = logging.getLogger()
    root.setLevel(logging.INFO)
    log_file = logging.FileHandler(os.path.join(wd, "output.log"))
    log_file.setFormatter(logging.Formatter(fmt))
    root.addHandler(log_file)
    try:
        logging.info(f"workdir: {wd}")
        from .train.trainer import Trainer

        return Trainer(config, wd, device=device).fit()
    finally:
        root.removeHandler(log_file)
        log_file.close()


COMMANDS = {"train": main_train}


def main(argv: Optional[List[str]] = None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] not in COMMANDS:
        raise SystemExit(f"usage: python -m panopticdiffusionmodels_torch "
                         f"{{{'|'.join(COMMANDS)}}} ...")
    return COMMANDS[argv[0]](argv[1:])
