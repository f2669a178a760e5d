"""One rank of the fully sharded runs of `test_torch_port_fsdp_gloo.py` (not
collected itself):

    python tests/torch_port_fsdp_worker.py RANK WORLD PORT OUT_DIR MODE

Sets the variables `torchrun` sets and joins a gloo group of WORLD CPU
processes.  `synthetic_tiny` is widened (embed_dim 128, mlp_ratio 4) so that
its MLP weights pass 2**16 elements, as `tests/test_spmd_equivalence.py::
_embiggen` widens JAX's.  MODE:

  * `fsdp` (mesh.fsdp = WORLD) and `hsdp` (mesh.dp = 2, mesh.fsdp = WORLD /
    2): train through the command line, as a user launches it:
      a. three steps, each rank in its own workdir OUT_DIR/wd{RANK}, a
         checkpoint (asynchronous) and a log line every step;
      b. (fsdp) one more step with every rank in OUT_DIR/wd0, resuming from
         rank 0's checkpoint of step 3;
      c. (fsdp) one more step with every rank in OUT_DIR/single, resuming
         from the checkpoint of step 3 that one process wrote there;
    after each, OUT_DIR/{MODE}{RANK}_{a|b|c}.pt holds the layout, the step,
    the gathered parameters and EMA, and (a) the elements this rank holds
    of each parameter, EMA and AdamW moment;
  * `jax` (mesh.fsdp = WORLD): the steps of OUT_DIR/jax_inputs.pt (initial
    parameters, global batches and the JAX trainer's draws), each rank on
    its rows, through `Trainer.train_step`; writes OUT_DIR/jax{RANK}.pt.
"""
import os
import sys

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from panopticdiffusionmodels_torch import cli  # noqa: E402
from panopticdiffusionmodels_torch.configs import get_config  # noqa: E402
from panopticdiffusionmodels_torch.parallel.sharding import full, local  # noqa: E402
from panopticdiffusionmodels_torch.train.trainer import Trainer  # noqa: E402

WIDE = ["--config.nnet.embed_dim=128", "--config.nnet.mlp_ratio=4"]
ARGS = ["--config=synthetic_tiny", "--device=cpu", "--config.train.save_interval=1",
        "--config.train.log_interval=1", "--config.num_workers=0", *WIDE]


def widened(config):
    config.nnet.embed_dim, config.nnet.mlp_ratio = 128, 4
    config.num_workers = 0
    return config


def run(workdir: str, steps: int, mesh: list) -> Trainer:
    """`train` through the CLI; returns the trainer it built."""
    built = []
    fit = Trainer.fit

    def capture(self, *args, **kwargs):
        built.append(self)
        return fit(self, *args, **kwargs)

    Trainer.fit = capture
    try:
        cli.main(["train", f"--workdir={workdir}", f"--config.train.n_steps={steps}", *ARGS,
                  *mesh])
    finally:
        Trainer.fit = fit
    return built[0]


def record(trainer: Trainer, path: str, shards: bool = False) -> None:
    state = trainer.state
    out = dict(step=state.step, is_main=trainer.is_main, dp=trainer.fsdp.dp,
               fsdp=trainer.fsdp.fsdp, params=full({n: p.detach() for n, p in
                                                    state.params.items()}),
               ema=full(dict(state.ema)))
    if shards:
        moments = {n: state.optimizer.state[p] for n, p in state.params.items()
                   if p in state.optimizer.state}
        out["held"] = {n: dict(param=local(p).numel(), ema=local(state.ema[n]).numel(),
                               exp_avg=local(moments[n]["exp_avg"]).numel(),
                               exp_avg_sq=local(moments[n]["exp_avg_sq"]).numel(),
                               numel=p.numel())
                       for n, p in state.params.items()}
    torch.save(out, path)


def train_given(out_dir: str) -> Trainer:
    inputs = torch.load(os.path.join(out_dir, "jax_inputs.pt"), weights_only=True)
    config = widened(get_config("synthetic_tiny"))
    config.mesh.fsdp = dist.get_world_size()
    trainer = Trainer(config, os.path.join(out_dir, "jaxwd"), device="cpu")
    trainer.state.load_state_dict(dict(step=0, params=inputs["init"], ema_params=inputs["init"],
                                       opt_state=trainer.state.optimizer.state_dict()))
    rows = trainer.dp.process_batch_slice(inputs["batches"][0][0].shape[0])
    metrics = []
    for batch, draws in zip(inputs["batches"], inputs["draws"]):
        m = trainer.train_step(tuple(x[rows] for x in batch),
                               {k: v[rows] for k, v in draws.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    torch.save(metrics, os.path.join(out_dir, f"jax_metrics{dist.get_rank()}.pt"))
    return trainer


def main(rank: int, world: int, port: int, out_dir: str, mode: str) -> None:
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    try:
        if mode == "jax":
            cli.init_distributed("cpu")
            record(train_given(out_dir), os.path.join(out_dir, f"jax{rank}.pt"))
            return
        mesh = ([f"--config.mesh.fsdp={world}"] if mode == "fsdp" else
                ["--config.mesh.dp=2", f"--config.mesh.fsdp={world // 2}"])
        record(run(os.path.join(out_dir, f"wd{rank}"), 3, mesh),
               os.path.join(out_dir, f"{mode}{rank}_a.pt"), shards=True)
        if mode == "fsdp":
            for phase, wd in (("b", "wd0"), ("c", "single")):
                record(run(os.path.join(out_dir, wd), 4, mesh),
                       os.path.join(out_dir, f"{mode}{rank}_{phase}.pt"))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main(*map(int, sys.argv[1:4]), *sys.argv[4:6])
