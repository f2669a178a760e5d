"""Turn a reference PyTorch checkpoint into a checkpoint that `train` resumes.

    python -m panopticdiffusionmodels_torch.scripts.convert_checkpoint \
        --config mscoco_uvit_small --nnet path/to/nnet_ema.pth \
        --out results/converted/ckpts [--device cuda|cpu]

Port of `scripts/convert_checkpoint.py`.  Writes `{out}/0.ckpt` with
`train/checkpoint.py`: step 0, parameters and EMA both the converted
weights (the `.pth` read strictly by `utils/weights.py::load_nnet_state_dict`
into the config's network, as `serving.GenerationPipeline.from_config`
reads `nnet_path`), and a fresh optimizer state.  The train state is built
exactly as `Trainer` builds it (`train/trainer.py::make_train_state`): when
`config.pretrained` is set, the image stream is frozen and left out of the
optimizer, so `train --workdir results/converted` resumes the file
strictly.  `eval` and `sample` can read the `.pth` directly through
`--config.nnet_path` without this step.
"""
from __future__ import annotations

import argparse

import torch


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config", required=True, help="zoo name or config .py")
    p.add_argument("--nnet", required=True, help="reference .pth state dict")
    p.add_argument("--out", required=True, help="checkpoint root directory")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    from ..cli import load_config
    from ..models import get_nnet
    from ..train.checkpoint import save_checkpoint
    from ..train.trainer import infer_task, make_train_state
    from ..utils.weights import load_nnet_state_dict, load_torch_state_dict

    config = load_config(args.config)
    kwargs = dict(config.nnet)
    with torch.random.fork_rng(devices=[]):  # the Trainer's initialisation
        torch.manual_seed(config.seed)
        nnet = get_nnet(kwargs.pop("name"), **kwargs)
    load_nnet_state_dict(nnet, load_torch_state_dict(args.nnet), config.nnet)
    nnet.to(torch.device(args.device))
    state = make_train_state(config, nnet, config.get("task", None) or infer_task(config))
    path = save_checkpoint(args.out, state)
    n = sum(p.numel() for p in nnet.parameters())
    print(f"wrote {path} ({n} params)")
    return path


if __name__ == "__main__":
    main()
