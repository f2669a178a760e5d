"""One rank of the two-process data-parallel run of
`test_torch_port_ddp_gloo.py` (not collected itself):

    python tests/torch_port_ddp_worker.py RANK WORLD PORT OUT_DIR

Sets the variables `torchrun` sets (RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR, MASTER_PORT) and trains through the command line, as a user
launches it: `train --config=synthetic_tiny --device=cpu` with the default
mesh (dp = -1, sp = 1), a checkpoint every step and every step logged.

  a. three steps, each rank in its own workdir OUT_DIR/wd{RANK}, so that
     what each rank wrote can be told apart;
  b. one more step with both ranks in OUT_DIR/wd0: every rank resumes from
     rank 0's checkpoint of step 3.

After each, writes OUT_DIR/rank{RANK}_{a|b}.pt: the layout the trainer saw,
its step, parameters and EMA.
"""
import os
import sys

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from panopticdiffusionmodels_torch import cli  # noqa: E402
from panopticdiffusionmodels_torch.train.trainer import Trainer  # noqa: E402

ARGS = ["--config=synthetic_tiny", "--device=cpu", "--config.train.save_interval=1",
        "--config.train.log_interval=1", "--config.num_workers=0"]


def run(workdir: str, steps: int) -> Trainer:
    """`train` through the CLI; returns the trainer it built."""
    built = []
    fit = Trainer.fit

    def capture(self, *args, **kwargs):
        built.append(self)
        return fit(self, *args, **kwargs)

    Trainer.fit = capture
    try:
        cli.main(["train", f"--workdir={workdir}", f"--config.train.n_steps={steps}", *ARGS])
    finally:
        Trainer.fit = fit
    return built[0]


def record(trainer: Trainer, path: str) -> None:
    dp = getattr(trainer, "dp", None)
    torch.save(dict(step=trainer.state.step, is_main=trainer.is_main,
                    dp_world=None if dp is None else dp.world_size,
                    params={n: p.detach().clone() for n, p in trainer.state.params.items()},
                    ema={n: e.clone() for n, e in trainer.state.ema.items()}), path)


def main(rank: int, world: int, port: int, out_dir: str) -> None:
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    try:
        record(run(os.path.join(out_dir, f"wd{rank}"), 3),
               os.path.join(out_dir, f"rank{rank}_a.pt"))
        record(run(os.path.join(out_dir, "wd0"), 4), os.path.join(out_dir, f"rank{rank}_b.pt"))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main(*map(int, sys.argv[1:4]), sys.argv[4])
