"""One rank of the two-process sequence-parallel run of
`test_torch_port_sp_gloo.py` (not collected itself):

    python tests/torch_port_sp_worker.py RANK PORT OUT_DIR

Joins a 2-process gloo group on tcp://localhost:PORT, then runs (a) ring
attention over the `ProcessGroupSP` of `from_mesh(dict(sp=2))` on all
tokens of a seeded (B, L, 3C) qkv, forward and gradient (the loss scaled by
1/sp and the gradients summed over the ranks, as the trainer does), and (b)
one train step of the port's `Trainer` (synthetic_tiny, mesh.sp = 2,
sp_mode 'process_group') on a seeded batch with seeded draws.  Writes OUT_DIR/rank{RANK}.pt.
"""
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from panopticdiffusionmodels_torch.configs import get_config  # noqa: E402
from panopticdiffusionmodels_torch.ops.ring_attention import ring_attention_qkv  # noqa: E402
from panopticdiffusionmodels_torch.parallel.mesh import from_mesh  # noqa: E402
from panopticdiffusionmodels_torch.train.trainer import Trainer  # noqa: E402

SP, HEADS, C, L = 2, 4, 32, 17  # L = 17 pads to 18: the second shard holds one padding row
BATCH = 4


def ring_inputs():
    return torch.from_numpy(np.random.default_rng(0).normal(size=(2, L, 3 * C)).astype(np.float32))


def train_inputs():
    rng = np.random.default_rng(1)
    batch = (rng.normal(size=(BATCH, 8, 8, 8)).astype(np.float32),
             rng.normal(size=(BATCH, 7, 16)).astype(np.float32),
             rng.integers(0, 201, size=(BATCH, 16, 16, 1)).astype(np.int32))
    draws = {"z": rng.normal(size=(BATCH, 8, 8, 4)).astype(np.float32),
             "n": rng.integers(1, 1001, size=(BATCH,)),
             "eps": rng.normal(size=(BATCH, 8, 8, 4)).astype(np.float32),
             "eps_m": 2.0 * rng.normal(size=(BATCH, 16, 16, 8)).astype(np.float32)}
    return batch, draws


def sp_trainer(workdir, mode):
    config = get_config("synthetic_tiny")
    config.mesh.update(sp=SP, sp_mode=mode)
    config.train.batch_size = BATCH
    return Trainer(config, workdir, device="cpu")


def train_step(trainer):
    """One step; (metrics, gradients, parameters after the update)."""
    batch, draws = train_inputs()
    metrics = trainer.loss_and_grads(batch, draws)
    grads = {n: p.grad.clone() for n, p in trainer.state.params.items()}
    trainer.state.apply_gradients(ema_rate=trainer.config.get("ema_rate", 0.9999))
    return ({k: float(v) for k, v in metrics.items()}, grads,
            {n: p.detach().clone() for n, p in trainer.state.params.items()})


def main(rank: int, port: int, out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=SP,
                            rank=rank)
    try:
        layout = from_mesh(dict(sp=SP))
        layout.init_groups("cpu")
        sp = layout.seq
        qkv = ring_inputs().requires_grad_()
        out = ring_attention_qkv(qkv, HEADS, (C // HEADS) ** -0.5, sp)
        ((out ** 2).sum() / sp.world_size).backward()
        grad = qkv.grad.clone()
        dist.all_reduce(grad)
        metrics, grads, params = train_step(sp_trainer(os.path.join(out_dir, f"run{rank}"),
                                                       "process_group"))
        torch.save(dict(out=out.detach(), grad=grad, metrics=metrics, grads=grads,
                        params=params), os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
