"""Command-line entry point of the port:

    python -m panopticdiffusionmodels_torch train|eval|sample --config=<zoo name|file.py>
        [--workdir=DIR] [--config.a.b=value ...] [--device=cuda|cpu]

Port of `panopticdiffusionmodels_tpu/cli.py` (reference `train.py:211-263`):
a config from the port's zoo or a python file with `get_config()`,
`--config.` overrides (python literals, else strings), and a workdir
derived from the config name and the overridden fields.  `train` runs
`Trainer.fit` with the FID-gated checkpoint callback and the sample-grid
callback (neither runs under `mesh.sp > 1`, which cannot sample yet: it
checkpoints at every save_interval); `eval` samples `config.sample.n_samples` into workdir/samples (and
workdir/mask) and takes FID when the stats file and the Inception weights
(`--inception`, by default `evaluation/fid.py::INCEPTION_WEIGHTS`) exist;
`sample` writes one mini-batch.  Weights to evaluate: `--config.nnet_path=<reference .pth or a
checkpoint in a ckpts directory>`, else the workdir's own checkpoints.

Data-parallel training on N cards, one process per card (the default mesh,
dp = -1, takes every process; `train.batch_size` is the global batch):

    torchrun --nproc_per_node=N -m panopticdiffusionmodels_torch train --config=...

Fully sharded training (parameters, gradients, moments and EMA sharded over
mesh.fsdp processes; with dp = -1 the other processes are replicas, HSDP):

    torchrun --nproc_per_node=4 -m panopticdiffusionmodels_torch train \
        --config=mscoco_uvit_small --config.mesh.fsdp=2

Sequence-parallel training on several cards, one process per sp rank:

    torchrun --nproc_per_node=2 -m panopticdiffusionmodels_torch train \
        --config=mscoco_uvit_small_512 --config.mesh.sp=2

Under torchrun (WORLD_SIZE set) the command joins the process group first:
NCCL with each process on `cuda:LOCAL_RANK`, or gloo with `--device=cpu`.
On one card, `--config.mesh.sp_mode=in_process` runs every shard in one
process instead.  Only rank 0 makes the workdir and writes `output.log`;
the other ranks log to the console with their rank in each line.
"""
from __future__ import annotations

import ast
import datetime
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
    opts = {"config": None, "workdir": None, "device": "cuda", "inception": None}
    rest = []
    it = iter(argv)
    for arg in it:
        name = arg[2:].split("=", 1)[0] if arg.startswith("--") else None
        if name in opts:
            opts[name] = arg.split("=", 1)[1] if "=" in arg else next(it, None)
        else:
            rest.append(arg)
    if opts["config"] is None:
        raise SystemExit("usage: python -m panopticdiffusionmodels_torch train|eval|sample "
                         "--config=<zoo name|file.py> [--workdir=...] [--config.k=v ...] "
                         "[--device=cuda|cpu] [--inception=<pt_inception .pth>]")
    return opts, rest


# How long a collective may wait: the other ranks of a data-parallel run wait
# at a barrier while rank 0 runs a FID evaluation (tens of thousands of
# samples), far past torch's default of 10 minutes.
DIST_TIMEOUT = datetime.timedelta(hours=6)


def init_distributed(device: str) -> str:
    """Join the torchrun process group (nccl on cuda:LOCAL_RANK, gloo on the
    CPU, both with `DIST_TIMEOUT`) when WORLD_SIZE says there is one;
    returns the device to train on."""
    import torch
    import torch.distributed as dist

    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return device
    if device == "cpu":
        if not dist.is_initialized():
            dist.init_process_group("gloo", timeout=DIST_TIMEOUT)
        return device
    local = int(os.environ.get("LOCAL_RANK", "0"))
    torch.cuda.set_device(local)
    if not dist.is_initialized():
        dist.init_process_group("nccl", device_id=torch.device("cuda", local),
                                timeout=DIST_TIMEOUT)
    return f"cuda:{local}"


def _run(argv: List[str], action, hparams: Optional[str] = None):
    """Parse, configure, log to the console and workdir/output.log, and return
    action(config, workdir, device, inception).  The run is named `hparams`,
    or by default after the overridden fields."""
    opts, rest = _parse(argv)
    config = load_config(opts["config"])
    overrides = apply_overrides(config, rest)
    config.hparams = hparams or ("-".join(overrides) if overrides else "default")
    wd = opts["workdir"] or os.path.join("results", config.get("config_name", "run"),
                                         config.hparams)
    config.workdir = wd
    rank = int(os.environ.get("RANK", "0"))  # torchrun's; 0 without it
    fmt = "%(asctime)s %(message)s" if rank == 0 else f"%(asctime)s [rank {rank}] %(message)s"
    logging.basicConfig(level=logging.INFO, format=fmt)  # the console, once per process
    root = logging.getLogger()
    root.setLevel(logging.INFO)
    log_file = None
    if rank == 0:
        os.makedirs(wd, exist_ok=True)
        log_file = logging.FileHandler(os.path.join(wd, "output.log"))
        log_file.setFormatter(logging.Formatter(fmt))
        root.addHandler(log_file)
    try:
        logging.info(f"workdir: {wd}")
        from .evaluation import runner

        return action(config, wd, opts["device"], opts["inception"] or runner.INCEPTION_WEIGHTS)
    finally:
        if log_file is not None:
            root.removeHandler(log_file)
            log_file.close()


def _train(config, workdir, device, inception):
    from .evaluation import runner
    from .train.trainer import Trainer

    trainer = Trainer(config, workdir, device=init_distributed(device))
    return trainer.fit(
        eval_callback=runner.make_fid_gated_callback(inception_path=inception),
        vis_callback=runner.make_vis_callback(sample_steps=config.sample.sample_steps))


def _evaluate(config, workdir, device, inception):
    from .evaluation import runner

    return runner.evaluate(config, workdir, inception_path=inception, device=device)


def _sample(config, workdir, device, inception):
    from .evaluation import runner

    return runner.sample_only(config, workdir, inception_path=inception, device=device)


def main_train(argv: List[str]):
    return _run(argv, _train)


def main_eval(argv: List[str]):
    return _run(argv, _evaluate, hparams="eval")


def main_sample(argv: List[str]):
    return _run(argv, _sample, hparams="sample")


COMMANDS = {"train": main_train, "eval": main_eval, "sample": main_sample}


def main(argv: Optional[List[str]] = None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] not in COMMANDS:
        raise SystemExit(f"usage: python -m panopticdiffusionmodels_torch "
                         f"{{{'|'.join(COMMANDS)}}} ...")
    return COMMANDS[argv[0]](argv[1:])
