"""The process-group sequence-parallel transport against the in-process one.

Two processes joined over gloo on the CPU (`tests/torch_port_sp_worker.py`,
`ProcessGroupSP`: the rotation a `batch_isend_irecv`, the gather an
all-gather whose backward is a reduce-scatter) must give what `InProcessSP`
gives in one process: ring attention's output and gradient, and one train
step of the port's `Trainer` (metrics, every gradient, the updated
parameters), to 1e-6, on both ranks.  The two processes have 120 s.
"""
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from panopticdiffusionmodels_torch.ops.ring_attention import ring_attention_qkv
from panopticdiffusionmodels_torch.parallel.mesh import InProcessSP
from torch_port_sp_worker import C, HEADS, SP, ring_inputs, sp_trainer, train_step

WORKER = Path(__file__).resolve().parent / "torch_port_sp_worker.py"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _close(a, b, what):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6, atol=1e-6, err_msg=what)


def test_two_gloo_processes_equal_in_process(tmp_path):
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(r), str(port), str(tmp_path)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env) for r in range(SP)]
    try:
        logs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)

    qkv = ring_inputs().requires_grad_()
    out = ring_attention_qkv(qkv, HEADS, (C // HEADS) ** -0.5, InProcessSP(SP))
    (out ** 2).sum().backward()
    metrics, grads, params = train_step(sp_trainer(str(tmp_path / "in_process"), "in_process"))
    for r in range(SP):
        got = torch.load(tmp_path / f"rank{r}.pt", weights_only=True)
        _close(got["out"], out.detach(), "ring output")
        _close(got["grad"], qkv.grad, "ring gradient")
        for k, v in metrics.items():
            _close(got["metrics"][k], v, k)
        for name in grads:
            _close(got["grads"][name], grads[name], f"grad {name}")
            _close(got["params"][name], params[name], f"param {name}")
