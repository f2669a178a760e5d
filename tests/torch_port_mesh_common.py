"""Shared harness of the process-mesh tests (not collected itself; imports
no JAX): write a job for `tests/torch_port_mesh_worker.py`, start its gloo
processes, read what each rank wrote, and run the same job in this one
process as the reference.  Every set of processes has `TIMEOUT` seconds.
"""
from __future__ import annotations

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

import torch_port_mesh_worker as worker

WORKER = Path(__file__).resolve().parent / "torch_port_mesh_worker.py"
TIMEOUT = 120
TOL = dict(rtol=1e-5, atol=1e-5)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def tiny_steps(n: int, batch: int = 16, seed: int = 0, clip_tokens: int = 7):
    """n global batches of synthetic_tiny's shapes with seeded draws."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        b = (rng.normal(size=(batch, 8, 8, 8)).astype(np.float32),
             rng.normal(size=(batch, clip_tokens, 16)).astype(np.float32),
             rng.integers(0, 201, size=(batch, 16, 16, 1)).astype(np.int32))
        draws = {"z": rng.normal(size=(batch, 8, 8, 4)).astype(np.float32),
                 "n": rng.integers(1, 1001, size=(batch,)),
                 "eps": rng.normal(size=(batch, 8, 8, 4)).astype(np.float32),
                 "eps_m": 2.0 * rng.normal(size=(batch, 16, 16, 8)).astype(np.float32)}
        out.append(as_tensors(b, draws))
    return out


def as_tensors(batch, draws):
    return (tuple(torch.from_numpy(np.asarray(x)) for x in batch),
            {k: torch.from_numpy(np.asarray(v)) for k, v in draws.items()})


def sample_inputs(n: int = 4, seed: int = 1, clip_tokens: int = 7):
    """(cond, z, m0, steps) of a 3-step request of n samples."""
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.normal(size=(n, clip_tokens, 16)).astype(np.float32)),
            torch.from_numpy(rng.normal(size=(n, 8, 8, 4)).astype(np.float32)),
            torch.from_numpy(rng.normal(size=(n, 16, 16, 8)).astype(np.float32)), 3)


def start(tmp: Path, job: str, world: int, spec: dict) -> list:
    """Write the job and start its WORLD processes (not waited for)."""
    torch.save(spec, tmp / f"{job}.pt")
    port = free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["OMP_NUM_THREADS"] = "1"
    return [subprocess.Popen([sys.executable, str(WORKER), str(r), str(world), str(port),
                              str(tmp), job], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True, env=env, cwd=tmp) for r in range(world)]


def finish(tmp: Path, job: str, procs: list) -> list:
    """Wait for a job's processes; each rank's results."""
    try:
        logs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    return [torch.load(tmp / f"{job}_rank{r}.pt", weights_only=False) for r in range(len(procs))]


def one_process(tmp: Path, job: str, spec: dict) -> dict:
    """The job in this process, its mesh at every axis 1: the reference."""
    spec = dict(spec, config=dict(spec["config"], mesh=dict(dp=-1, fsdp=1, sp=1, tp=1, pp=1)))
    return worker.run_job(spec, str(tmp), job, 0)


def close(a, b, what, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), err_msg=what, **tol)


def assert_state(got: dict, want: dict, what: str, tol=TOL) -> None:
    for part in ("params", "ema"):
        assert sorted(got[part]) == sorted(want[part]), f"{what}: {part}"
        for name, w in want[part].items():
            close(got[part][name].numpy(), w.numpy(), f"{what}: {part} {name}", tol)


def assert_metrics(got: list, want: list, what: str, keys=("loss", "loss_mask", "grad_norm"),
                   tol=TOL) -> None:
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        for k in keys:
            close(g[k], w[k], f"{what}: step {i + 1} {k}", tol)
