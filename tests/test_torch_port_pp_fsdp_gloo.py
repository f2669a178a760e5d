"""Pipeline parallelism beside fully sharded data parallelism (`mesh.pp = 2`,
`mesh.fsdp = 2`) over four gloo processes (`tests/torch_port_mesh_worker.py`;
120 s), `synthetic_tiny` (the tiny dual-stream panoptic U-ViT) in f32 with
remat on (its replay runs on the gathered parameters) on the global batch of
16, from the JAX trainer's initial parameters on its draws:

  * the loss, loss_mask and grad_norm of three steps and the parameters and
    EMA after them equal one process's at 1e-6, and the JAX `Trainer`'s at
    the same mesh (`nnet.scan_blocks=True`, its pipeline's requirement; the
    8-device CPU mesh puts dp = 2 beside) at rtol 1e-4 / atol 1e-5;
  * each rank holds about a quarter of the block parameters, of their EMA
    and of their AdamW moments (its stage's blocks, dim 0 cut over fsdp);
  * rank 0's checkpoint is one process's file: a fourth step resumed from it
    in one process, and one resumed by the four ranks from one process's
    checkpoint, equal one process's fourth step;
  * every rank samples, and its images and mask equal one process's.
"""
import numpy as np
import pytest
import torch

from panopticdiffusionmodels_torch.parallel.pipeline import owner_stage
from panopticdiffusionmodels_torch.train import checkpoint as ckpt_lib
import torch_port_mesh_common as mc
import torch_port_mesh_worker as worker
from torch_port_train_common import (batches, jax_mesh_draws, jax_mesh_steps, jax_mesh_trainer,
                                     to_port)

STEPS = 3
ONE_TOL = dict(rtol=1e-6, atol=1e-6)
JAX_TOL = dict(rtol=1e-4, atol=1e-5)
MESH = dict(pp=2, fsdp=2)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ppfsdp")
    jt = jax_mesh_trainer(tmp / "jax", MESH, nnet=dict(scan_blocks=True))
    init = {k: torch.from_numpy(np.array(v)) for k, v in to_port(jt.state.params).items()}
    raw = batches(STEPS + 1)
    steps = [mc.as_tensors(*s) for s in jax_mesh_draws(jt, raw)]
    one_ckpt = tmp / "one_ckpts" / f"{STEPS}.ckpt"
    spec = dict(init=init, steps=steps[:STEPS], sample=mc.sample_inputs(),
                config=dict(mesh=MESH, nnet=dict(use_checkpoint=True)),
                resume=(str(one_ckpt), *steps[STEPS]))
    ref = mc.one_process(tmp, "one", spec)  # writes one_ckpt first
    procs = mc.start(tmp, "ppfsdp", 4, spec)
    jax_run = jax_mesh_steps(jt, raw[:STEPS])
    got = mc.finish(tmp, "ppfsdp", procs)
    return dict(tmp=tmp, got=got, ref=ref, jax=jax_run, spec=spec)


def test_pp_fsdp_equals_one_process_and_jax(runs):
    got, ref = runs["got"], runs["ref"]
    assert [(g["coords"]["pp"], g["coords"]["fsdp"]) for g in got] == \
        [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert [g["is_main"] for g in got] == [True, False, False, False]
    for g in got:
        mc.assert_metrics(g["metrics"], ref["metrics"], "pp x fsdp vs one process", tol=ONE_TOL)
    mc.assert_state(got[0]["state"], ref["state"], "pp x fsdp vs one process", tol=ONE_TOL)
    jax_metrics, jax_state = runs["jax"]
    mc.assert_metrics(got[0]["metrics"], jax_metrics, "pp x fsdp vs JAX", tol=JAX_TOL)
    mc.assert_state(got[0]["state"], jax_state, "pp x fsdp vs JAX", tol=JAX_TOL)


@pytest.mark.parametrize("part", ["held", "held_ema", "held_moments"])
def test_a_rank_holds_a_quarter_of_the_blocks(runs, part):
    got, ref = runs["got"], runs["ref"]
    names = list(ref["state"]["params"])
    blocks = [n for n in names if owner_stage(n, 2, 2) is not None]
    whole = {n: ref["state"]["params"][n].numel() for n in names}
    # dim 0 cut in two, the last chunk padded: at most ceil(rows / 2) rows
    cap = {n: -(-p.shape[0] // 2) * (p.numel() // p.shape[0])
           for n, p in ref["state"]["params"].items()}
    per = 2 if part == "held_moments" else 1  # exp_avg and exp_avg_sq
    total = per * sum(whole[n] for n in blocks)
    for g in got:
        held = g[part]
        # its stage's blocks and every replicated tensor, each cut over fsdp
        assert sorted(held) == sorted(n for n in names if owner_stage(n, 2, 2)
                                      in (g["coords"]["pp"], None))
        assert all(held[n] <= per * cap[n] for n in held)
        share = sum(held[n] for n in held if n in blocks) / total
        assert 0.2 < share < 0.3, (g["coords"], part, share)
    # the four ranks hold every block element exactly once
    assert sum(sum(g[part][n] for n in g[part] if n in blocks) for g in got) == total


def test_pp_fsdp_checkpoints_are_one_process_files_both_ways(runs):
    tmp, got, ref = runs["tmp"], runs["got"], runs["ref"]
    for g in got:
        mc.assert_metrics([g["resumed_metrics"]], [ref["resumed_metrics"]], "step 4",
                          tol=ONE_TOL)
    mc.assert_state(got[0]["resumed"], ref["resumed"], "pp x fsdp resumed from one process",
                    tol=ONE_TOL)
    mine = ckpt_lib.load_checkpoint(str(tmp / "ppfsdp_ckpts" / f"{STEPS}.ckpt"))
    one = ckpt_lib.load_checkpoint(str(tmp / "one_ckpts" / f"{STEPS}.ckpt"))
    assert mine.keys() == one.keys()
    assert list(mine["params"]) == list(one["params"])
    assert mine["opt_state"]["param_groups"] == one["opt_state"]["param_groups"]
    for i, st in one["opt_state"]["state"].items():
        for k in ("exp_avg", "exp_avg_sq"):
            mc.close(mine["opt_state"]["state"][i][k].numpy(), st[k].numpy(), f"{k} {i}",
                     ONE_TOL)
    trainer = worker.Trainer(worker.make_config({}), str(tmp / "from_ppfsdp"), device="cpu")
    trainer.state.load_state_dict(mine)
    metrics = worker.step(trainer, *runs["spec"]["resume"][1:])
    mc.assert_metrics([metrics], [ref["resumed_metrics"]], "one process from pp x fsdp",
                      tol=ONE_TOL)
    mc.assert_state(worker.whole(trainer), ref["resumed"], "one process from pp x fsdp",
                    tol=ONE_TOL)


def test_every_rank_samples_as_one_process(runs):
    tmp, ref = runs["tmp"], runs["ref"]["samples"]
    for r, g in enumerate(runs["got"]):
        for a, b, what in zip(g["samples"], ref, ("images", "mask")):
            mc.close(a.numpy(), b.numpy(), f"rank {r} {what}", tol=dict(rtol=1e-5, atol=1e-5))
    assert (tmp / "ppfsdp_wd0" / "train_samples" / f"{STEPS}.png").exists()
    assert not any((tmp / f"ppfsdp_wd{r}" / "train_samples").exists() for r in (1, 2, 3))
