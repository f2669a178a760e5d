"""One rank of the process-mesh runs of `test_torch_port_tensor_parallel.py`,
`test_torch_port_pipeline_gloo.py`, `test_torch_port_pp_fsdp_gloo.py` and
`test_torch_port_sp_layouts.py` (not collected itself):

    python tests/torch_port_mesh_worker.py RANK WORLD PORT OUT_DIR JOB

Sets the variables `torchrun` sets, joins a gloo group of WORLD CPU
processes through `cli.init_distributed` and runs the job that
OUT_DIR/JOB.pt describes (`job_spec` builds it):

  * `config`: overrides of `synthetic_tiny` (nested dicts are merged, an
    `nnet` with a name replaces it), the mesh among them;
  * `init`: whole initial parameters by the port's names, or None for the
    trainer's own seeded ones;
  * `steps`: [(global batch, global draws)], each rank training on its
    rows through `Trainer.train_step`;
  * `sample`: (cond, z, m0, steps) to sample with `build_sample_fn` after
    the steps, then the vis callback (rank 0 writes its grid), or None;
  * `resume`: (a checkpoint file, a batch, draws): after the steps, every
    rank loads that file and takes one more step, or None;
  * `stream`: a number of batches to take from `Trainer.data_stream`
    after the steps, or None.

After the steps every rank enters the train state's gathers and rank 0
writes its checkpoint under OUT_DIR/JOB_ckpts.  Each rank writes
OUT_DIR/JOB_rank{RANK}.pt: its layout's coordinates, the metrics of each
step, the whole state after the steps (`TrainState.state_dict()`, one
process's), the elements it holds of each parameter, of its EMA and of its
AdamW moments, the samples, and the
whole state after the resumed step, the streamed batches and the input
pipeline that read them.
"""
import os
import sys

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from panopticdiffusionmodels_torch import cli  # noqa: E402
from panopticdiffusionmodels_torch.configs import get_config  # noqa: E402
from panopticdiffusionmodels_torch.configs.base import d  # noqa: E402
from panopticdiffusionmodels_torch.parallel.sharding import local  # noqa: E402
from panopticdiffusionmodels_torch.train import checkpoint as ckpt_lib  # noqa: E402
from panopticdiffusionmodels_torch.train.trainer import Trainer  # noqa: E402


def merge(config, overrides: dict):
    """Nested overrides merged into `config`; a dict with a `name` (an
    `nnet`) replaces the one it names."""
    for k, v in overrides.items():
        if isinstance(v, dict) and isinstance(config.get(k), dict) and "name" not in v:
            merge(config[k], v)
        else:
            config[k] = d(**v) if isinstance(v, dict) else v
    return config


def make_config(overrides: dict):
    config = merge(get_config("synthetic_tiny"), overrides)
    config.num_workers = overrides.get("num_workers", 0)
    return config


def load_init(trainer: Trainer, init: dict) -> None:
    groups = trainer.state.optimizer.state_dict()["param_groups"]
    trainer.state.load_state_dict(dict(step=0, params=init, ema_params=init,
                                       opt_state=dict(state={}, param_groups=groups)))


def rows_of(trainer: Trainer, batch_size: int) -> slice:
    return slice(None) if trainer.dp is None else trainer.dp.process_batch_slice(batch_size)


def step(trainer: Trainer, batch, draws) -> dict:
    rows = rows_of(trainer, batch[0].shape[0])
    metrics = trainer.train_step(tuple(x[rows] for x in batch),
                                 {k: v[rows] for k, v in draws.items()})
    return {k: float(v) for k, v in metrics.items()}


def whole(trainer: Trainer) -> dict:
    sd = trainer.state.state_dict()
    return dict(params={k: v.detach().cpu().clone() for k, v in sd["params"].items()},
                ema={k: v.detach().cpu().clone() for k, v in sd["ema_params"].items()})


def sample(trainer: Trainer, spec) -> tuple:
    from panopticdiffusionmodels_torch.evaluation import runner  # scipy: only where sampled

    cond, z, m0, steps = spec
    out = trainer.build_sample_fn(steps)(cond, z, m0)
    runner.make_vis_callback(n_images=z.shape[0], sample_steps=steps)(trainer,
                                                                      trainer.state.step)
    return tuple(t.detach().cpu() for t in out)


def run_job(spec: dict, out_dir: str, job: str, rank: int) -> dict:
    trainer = Trainer(make_config(spec["config"]), os.path.join(out_dir, f"{job}_wd{rank}"),
                      device="cpu")
    if spec.get("init") is not None:
        load_init(trainer, spec["init"])
    layout = trainer.dp
    out = dict(coords=None if layout is None else dict(layout.coords),
               is_main=trainer.is_main,
               metrics=[step(trainer, b, d) for b, d in spec["steps"]],
               held={n: local(p).numel() for n, p in trainer.state.params.items()})
    out["held_ema"] = {n: local(e).numel() for n, e in trainer.state.ema.items()}
    out["held_moments"] = {n: sum(local(v).numel() for v in st.values() if torch.is_tensor(v)
                                  and v.dim())
                           for n, p in trainer.state.params.items()
                           if (st := trainer.state.optimizer.state.get(p))}
    out["state"] = whole(trainer)
    ckpt_lib.save_checkpoint(os.path.join(out_dir, f"{job}_ckpts"), trainer.state,
                             write=trainer.is_main)
    ckpt_lib.wait_for_saves()
    if spec.get("sample") is not None:
        out["samples"] = sample(trainer, spec["sample"])
    if spec.get("stream"):
        stream = trainer.data_stream()
        out["stream"] = [tuple(t.cpu() for t in next(stream)) for _ in range(spec["stream"])]
        out["input_pipeline"] = trainer.input_pipeline
    if spec.get("resume") is not None:
        path, batch, draws = spec["resume"]
        trainer.state.load_state_dict(ckpt_lib.load_checkpoint(path))
        out["resumed_metrics"] = step(trainer, batch, draws)
        out["resumed"] = whole(trainer)
    return out


def main(rank: int, world: int, port: int, out_dir: str, job: str) -> None:
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    try:
        cli.init_distributed("cpu")
        spec = torch.load(os.path.join(out_dir, f"{job}.pt"), weights_only=False)
        out = run_job(spec, out_dir, job, rank)
        if rank:  # one copy of the whole state is enough
            out.pop("state", None), out.pop("resumed", None)
        torch.save(out, os.path.join(out_dir, f"{job}_rank{rank}.pt"))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main(*map(int, sys.argv[1:4]), *sys.argv[4:6])
