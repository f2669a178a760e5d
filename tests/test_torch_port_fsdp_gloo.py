"""Fully sharded data parallelism over processes (`mesh.fsdp`), and HSDP.

CPU processes joined over gloo (`tests/torch_port_fsdp_worker.py`) train
`synthetic_tiny`, widened past 2**16-element weights as JAX's
`tests/test_spmd_equivalence.py::_embiggen` widens it, through `python -m
panopticdiffusionmodels_torch train --config.mesh.fsdp=2`, as `torchrun
--nproc_per_node=2` launches it.  FSDP2 shards every parameter on dim 0 (JAX
shards the large ones on their largest dim); the numbers are the same:

  * after three steps both ranks' gathered parameters and EMA equal one
    process at the global batch of 16 to 1e-5, and so do the loss,
    loss_mask and grad_norm that rank 0 logs (grad_norm over every shard);
  * each rank holds at most half of every large weight, of its EMA and of
    its AdamW moments;
  * only rank 0 writes: rank 1's workdir stays absent, and every step's
    asynchronous checkpoint is on disk in rank 0's;
  * a fourth step resumed by both ranks from rank 0's checkpoint, one
    process resuming that checkpoint, and both ranks resuming one
    process's checkpoint, all equal one process's fourth step;
  * given the JAX trainer's draws on the same batches, the two ranks'
    parameters and EMA after three steps equal the JAX `Trainer` at mesh
    dp = 1, fsdp = 2 on the 8-device CPU mesh, to 1e-5;
  * HSDP at dp = 2, fsdp = 2 over four processes equals the same single
    process.

Every subprocess has 120 s."""
import json
import os
import shutil
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from panopticdiffusionmodels_torch.configs import get_config
from panopticdiffusionmodels_torch.train.trainer import Trainer
from torch_port_train_common import batches, jax_reference

WORKER = Path(__file__).resolve().parent / "torch_port_fsdp_worker.py"
WIDE = dict(embed_dim=128, mlp_ratio=4)
TOL = dict(rtol=1e-5, atol=1e-5)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(tmp_path: Path, world: int, mode: str) -> None:
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(r), str(world), str(port),
                               str(tmp_path), mode], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env, cwd=tmp_path)
             for r in range(world)]
    try:
        logs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)


def _config(steps: int):
    config = get_config("synthetic_tiny")
    config.nnet.update(WIDE)
    config.num_workers = 0
    config.train.update(n_steps=steps, save_interval=1, log_interval=1)
    return config


def single(workdir: Path, steps: int):
    trainer = Trainer(_config(steps), str(workdir), device="cpu")
    trainer.fit()
    return ({n: p.detach().clone() for n, p in trainer.state.params.items()},
            {n: e.clone() for n, e in trainer.state.ema.items()})


def _metrics(path: Path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def assert_equal_state(got: dict, params: dict, ema: dict, what: str) -> None:
    assert sorted(got["params"]) == sorted(params), what
    for name in params:
        np.testing.assert_allclose(got["params"][name].numpy(), params[name].numpy(), **TOL,
                                   err_msg=f"{what}: param {name}")
        np.testing.assert_allclose(got["ema"][name].numpy(), ema[name].numpy(), **TOL,
                                   err_msg=f"{what}: ema {name}")


def test_fsdp_over_two_processes_equals_one_process_and_resumes_both_ways(tmp_path):
    ref3 = single(tmp_path / "ref", 3)
    (tmp_path / "single" / "ckpts").mkdir(parents=True)
    shutil.copy(tmp_path / "ref" / "ckpts" / "3.ckpt", tmp_path / "single" / "ckpts")
    ref4 = single(tmp_path / "ref", 4)
    launch(tmp_path, 2, "fsdp")

    for phase, steps, (params, ema) in (("a", 3, ref3), ("b", 4, ref4), ("c", 4, ref4)):
        got = [torch.load(tmp_path / f"fsdp{r}_{phase}.pt", weights_only=True)
               for r in range(2)]
        assert [g["is_main"] for g in got] == [True, False]
        assert all((g["dp"], g["fsdp"], g["step"]) == (1, 2, steps) for g in got)
        for g in got:
            assert_equal_state(g, params, ema, f"phase {phase}")

    held = torch.load(tmp_path / "fsdp1_a.pt", weights_only=True)["held"]
    large = [n for n, h in held.items() if h["numel"] >= 1 << 16]
    assert len(large) >= 8, "the MLP weights of every block"
    for name in large:
        h = held[name]
        assert max(h["param"], h["ema"], h["exp_avg"], h["exp_avg_sq"]) <= h["numel"] // 2, name
    assert sum(h["param"] for h in held.values()) <= sum(h["numel"] for h in held.values()) // 2 + 4096

    want = _metrics(tmp_path / "ref" / "metrics.jsonl")
    logged = _metrics(tmp_path / "wd0" / "metrics.jsonl")
    assert [m["step"] for m in logged] == [m["step"] for m in want] == [1, 2, 3, 4]
    for m, w in zip(logged, want):
        for k in ("loss", "loss_mask", "grad_norm"):
            np.testing.assert_allclose(m[k], w[k], **TOL, err_msg=f"step {w['step']} {k}")
    assert sorted(os.listdir(tmp_path / "wd0" / "ckpts")) == [f"{s}.ckpt" for s in (1, 2, 3, 4)]
    assert not (tmp_path / "wd1").exists()

    # rank 0's checkpoint of step 3, resumed by one process
    (tmp_path / "from_fsdp" / "ckpts").mkdir(parents=True)
    shutil.copy(tmp_path / "wd0" / "ckpts" / "3.ckpt", tmp_path / "from_fsdp" / "ckpts")
    params, ema = single(tmp_path / "from_fsdp", 4)
    assert_equal_state(dict(params=params, ema=ema), *ref4, "one process from fsdp's step 3")
    fsdp_ckpt = torch.load(tmp_path / "wd0" / "ckpts" / "3.ckpt", weights_only=True)
    one_ckpt = torch.load(tmp_path / "single" / "ckpts" / "3.ckpt", weights_only=True)
    assert fsdp_ckpt.keys() == one_ckpt.keys()
    assert fsdp_ckpt["opt_state"]["param_groups"] == one_ckpt["opt_state"]["param_groups"]


def test_hsdp_over_four_processes_equals_one_process(tmp_path):
    params, ema = single(tmp_path / "ref", 3)
    launch(tmp_path, 4, "hsdp")
    for r in range(4):
        got = torch.load(tmp_path / f"hsdp{r}_a.pt", weights_only=True)
        assert (got["dp"], got["fsdp"], got["step"], got["is_main"]) == (2, 2, 3, r == 0)
        assert_equal_state(got, params, ema, f"rank {r}")
        held = got["held"]["in_blocks.0.mlp.fc1.weight"]
        assert held["param"] == held["numel"] // 2
    assert sorted(os.listdir(tmp_path / "wd0" / "ckpts")) == ["1.ckpt", "2.ckpt", "3.ckpt"]
    assert not any((tmp_path / f"wd{r}").exists() for r in (1, 2, 3))


def test_fsdp_equals_the_jax_trainer_on_its_fsdp_mesh(tmp_path):
    steps = batches(3)
    init, ref = jax_reference(tmp_path / "jax_ref", steps, mesh=dict(dp=1, fsdp=2),
                              with_grads=False, nnet=WIDE)
    as_tensors = {k: torch.from_numpy(np.array(v)) for k, v in init.items()}
    torch.save(dict(init=as_tensors, batches=[tuple(torch.from_numpy(x) for x in b)
                                              for b in steps],
                    draws=[{k: torch.from_numpy(v) for k, v in r["draws"].items()} for r in ref]),
               tmp_path / "jax_inputs.pt")
    launch(tmp_path, 2, "jax")
    want = {k: torch.from_numpy(np.array(v)) for k, v in ref[-1]["params"].items()}
    want_ema = {k: torch.from_numpy(np.array(v)) for k, v in ref[-1]["ema"].items()}
    for r in range(2):
        got = torch.load(tmp_path / f"jax{r}.pt", weights_only=True)
        assert got["step"] == 3
        assert_equal_state(got, want, want_ema, f"rank {r} vs JAX fsdp=2")
        metrics = torch.load(tmp_path / f"jax_metrics{r}.pt", weights_only=True)
        for m, w in zip(metrics, ref):
            for k in ("loss", "loss_mask", "grad_norm"):
                np.testing.assert_allclose(m[k], w["metrics"][k], rtol=1e-5, atol=1e-6, err_msg=k)
