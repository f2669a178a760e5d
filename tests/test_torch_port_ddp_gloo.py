"""Data-parallel training over processes, and the layouts the port refuses.

Two CPU processes joined over gloo (`tests/torch_port_ddp_worker.py`) train
`synthetic_tiny` through `python -m panopticdiffusionmodels_torch train`
with the default mesh (dp = -1, sp = 1), as `torchrun --nproc_per_node=2`
launches it.  They must train one data-parallel run, as the JAX trainer's
`dp = -1` does over every process (JAX `train/trainer.py:105-113`,
`parallel/mesh.py:41-66`): after three steps both ranks hold the same
parameters and EMA, and those equal one process at the same global batch
of 16 (each rank loads 8 rows of it and keeps its rows of the global
batch's draws) to 1e-5; the losses and grad_norm that rank 0 logs equal the
single process's; only rank 0 writes (JAX l.101, 834, 846), so rank 1's own
workdir stays absent; and a fourth step, both ranks resuming from rank 0's
checkpoint, equals the single process's fourth.  The processes have 120 s.

Every other layout is built over the world it finds, with its coordinates
in JAX's (pp, dp, fsdp, sp, tp) order and its rows, or raises `ValueError`
when that world cannot hold it (the world faked by monkeypatching `dist`);
the layouts themselves are held in test_torch_port_fsdp_gloo.py,
_tensor_parallel.py, _pipeline_gloo.py and _sp_layouts.py.
"""
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from panopticdiffusionmodels_torch.configs import get_config
from panopticdiffusionmodels_torch.parallel import mesh as mesh_lib
from panopticdiffusionmodels_torch.train.trainer import Trainer

WORKER = Path(__file__).resolve().parent / "torch_port_ddp_worker.py"
WORLD = 2


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _config(steps: int):
    config = get_config("synthetic_tiny")
    config.num_workers = 0
    config.train.update(n_steps=steps, save_interval=1, log_interval=1)
    return config


def _metrics(path: Path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def _close(a, b, what):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-5, err_msg=what)


def test_default_mesh_over_two_processes_trains_one_data_parallel_run(tmp_path):
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(r), str(WORLD), str(port),
                               str(tmp_path)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env, cwd=tmp_path)
             for r in range(WORLD)]
    try:
        logs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)

    ref_dir = tmp_path / "single"
    ref = Trainer(_config(3), str(ref_dir), device="cpu")
    ref.fit()
    ref3 = ({n: p.detach().clone() for n, p in ref.state.params.items()},
            {n: e.clone() for n, e in ref.state.ema.items()})
    ref = Trainer(_config(4), str(ref_dir), device="cpu")
    ref.fit()
    ref4 = (dict(ref.state.params), ref.state.ema)

    for phase, steps, (params, ema) in (("a", 3, ref3), ("b", 4, ref4)):
        got = [torch.load(tmp_path / f"rank{r}_{phase}.pt", weights_only=True)
               for r in range(WORLD)]
        assert [g["is_main"] for g in got] == [True, False]
        assert all(g["dp_world"] == WORLD and g["step"] == steps for g in got)
        for name in params:
            assert torch.equal(got[1]["params"][name], got[0]["params"][name]), name
            assert torch.equal(got[1]["ema"][name], got[0]["ema"][name]), name
            _close(got[0]["params"][name].numpy(), params[name].detach().numpy(),
                   f"{phase}: param {name}")
            _close(got[0]["ema"][name].numpy(), ema[name].numpy(), f"{phase}: ema {name}")

    want = _metrics(ref_dir / "metrics.jsonl")
    logged = _metrics(tmp_path / "wd0" / "metrics.jsonl")
    assert [m["step"] for m in logged] == [m["step"] for m in want] == [1, 2, 3, 4]
    for m, w in zip(logged, want):
        for k in ("loss", "loss_mask", "grad_norm"):
            _close(m[k], w[k], f"step {w['step']} {k}")
    assert sorted(os.listdir(tmp_path / "wd0" / "ckpts")) == [f"{s}.ckpt" for s in (1, 2, 3, 4)]
    assert (tmp_path / "wd0" / "output.log").exists()
    assert not (tmp_path / "wd1").exists(), sorted(os.listdir(tmp_path / "wd1"))


class _World:
    """A default process group of `world` processes as the mesh sees it."""

    def __init__(self, monkeypatch, world: int, rank: int = 0):
        monkeypatch.setattr(dist, "is_initialized", lambda: True)
        monkeypatch.setattr(dist, "get_world_size", lambda *a, **k: world)
        monkeypatch.setattr(dist, "get_rank", lambda *a, **k: rank)


# Each layout either is built over the (faked) world, rank 3 of it: (its
# coordinates (pp, dp, fsdp, sp, tp), its rows of a global batch of 64, the
# sp rank and ring of its global ranks) or raises ValueError saying why the
# world cannot hold it.
@pytest.mark.parametrize("mesh,world,want", [
    (dict(dp=2), 1, "dp = 2 is not the world of 1 processes"),
    (dict(dp=3), 2, "dp = 3 is not the world of 2 processes"),
    (dict(dp=1), 2, "dp = 1 is not the world of 2 processes"),
    (dict(dp=2, sp=2, sp_mode="in_process"), 1, "dp = 2 is not the world of 1 processes"),
    (dict(dp=2, sp=2, sp_mode="process_group"), 4, ((0, 1, 0, 1, 0), slice(32, 64), 1, [2, 3])),
    (dict(sp=2, sp_mode="process_group"), 4, ((0, 1, 0, 1, 0), slice(32, 64), 1, [2, 3])),
    (dict(fsdp=2), 1, "fsdp = 2 needs 2 processes, got 1"),
    (dict(tp=2), 1, "tp = 2 needs 2 processes, got 1"),
    (dict(pp=2), 1, "pp = 2 needs 2 processes, got 1"),
])
def test_layouts_the_port_cannot_run_raise(monkeypatch, mesh, world, want):
    if world > 1:
        _World(monkeypatch, world, rank=3)
    if isinstance(want, str):
        with pytest.raises(ValueError, match=want):
            mesh_lib.from_mesh(mesh)
        return
    layout = mesh_lib.from_mesh(mesh)
    coords, rows, sp_rank, ring = want
    assert tuple(layout.coords[a] for a in mesh_lib.AXES) == coords
    assert layout.process_batch_slice(64) == rows
    assert isinstance(layout.seq, mesh_lib.ProcessGroupSP)
    assert (layout.seq.rank, layout.seq.peers) == (sp_rank, ring)


@pytest.mark.parametrize("field,value", [("dp", 2), ("fsdp", 2), ("tp", 2), ("pp", 2)])
def test_trainer_refuses_a_layout_before_training(tmp_path, field, value):
    config = _config(3)
    config.mesh[field] = value
    # one process cannot hold any of them
    match = "is not the world of 1" if field == "dp" else f"{field} = 2 needs 2 processes"
    with pytest.raises(ValueError, match=match):
        Trainer(config, str(tmp_path), device="cpu")


@pytest.mark.parametrize("mesh,world,match", [
    (dict(fsdp=4), 2, "fsdp = 4 needs 4 processes"),
    (dict(fsdp=2), 3, "does not divide 3 processes"),
    (dict(dp=3, fsdp=2), 4, "dp x fsdp = 6"),
])
def test_fsdp_layouts_the_world_cannot_hold_raise(monkeypatch, mesh, world, match):
    _World(monkeypatch, world)
    with pytest.raises(ValueError, match=match):
        mesh_lib.from_mesh(mesh)


# fsdp beside sp, tp or pp over four processes, rank 3: (pp, dp, fsdp, sp, tp)
@pytest.mark.parametrize("mesh,coords", [
    (dict(fsdp=2, sp=2), (0, 0, 1, 1, 0)),
    (dict(fsdp=2, tp=2), (0, 0, 1, 0, 1)),
    (dict(fsdp=2, pp=2), (1, 0, 1, 0, 0)),
])
def test_fsdp_beside_sp_tp_or_pp_raises(monkeypatch, mesh, coords):
    _World(monkeypatch, 4, rank=3)
    layout = mesh_lib.from_mesh(mesh)
    assert isinstance(layout, mesh_lib.FullyShardedDataParallel)
    assert tuple(layout.coords[a] for a in mesh_lib.AXES) == coords
    assert (layout.dp, layout.fsdp) == (1, 2)
    assert layout.process_batch_slice(64) == slice(32, 64)  # its fsdp index's rows


def test_fsdp_layout_follows_the_world(monkeypatch):
    _World(monkeypatch, 4, rank=3)
    hsdp = mesh_lib.from_mesh(dict(dp=-1, fsdp=2))
    assert isinstance(hsdp, mesh_lib.FullyShardedDataParallel)
    assert (hsdp.dp, hsdp.fsdp, hsdp.world_size, hsdp.rank, hsdp.is_main) == (2, 2, 4, 3, False)
    assert hsdp.process_batch_slice(64) == slice(48, 64)  # the global rank over (dp, fsdp)
    assert mesh_lib.from_mesh(dict(dp=1, fsdp=4)).dp == 1


def test_the_layout_follows_the_world(monkeypatch):
    assert mesh_lib.from_mesh(dict(dp=-1)) is None
    assert mesh_lib.from_mesh(dict(dp=1)) is None
    _World(monkeypatch, 4, rank=3)
    dp = mesh_lib.from_mesh(dict(dp=-1, sp=1))
    assert isinstance(dp, mesh_lib.DataParallel)
    assert (dp.world_size, dp.rank, dp.is_main) == (4, 3, False)
    assert dp.process_batch_slice(64) == slice(48, 64) and dp.local_batch_size(64) == 16
    assert mesh_lib.from_mesh(dict(dp=4)).world_size == 4
    with pytest.raises(ValueError, match="divide"):
        dp.process_batch_slice(30)
