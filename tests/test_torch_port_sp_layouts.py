"""Sequence parallelism beside the other mesh axes, and token streams that
do not divide sp.

Over gloo (`tests/torch_port_mesh_worker.py`, one set of processes for
every check, started together; 120 s), each against this one process on
the global batch of 16, f32, at rtol / atol 1e-5
(`test_torch_port_fsdp_gloo.py`'s tolerance), three steps:

  * sp = 2 beside dp = 2 over four processes (sp_mode 'process_group') and
    over two ('in_process'), with `num_clip_token=6`: the image stream's 23
    tokens pad to 24, so one shard of the mask stream is reordered for the
    ring.  Both start from the JAX trainer's initial parameters and take its
    draws, and are held to the JAX `Trainer` at mesh.sp = 2, mesh.dp = 2 on
    the 8-device CPU mesh too; the samples on every rank equal one
    process's and only rank 0 writes the grid;
  * sp = 2 beside tp = 2 over four processes (the ring on each rank's two
    heads of four), and beside fsdp = 2 (the sp sum on each rank's shards).

In this process: the port's `Trainer` at sp = 2 'in_process' with
`num_clip_token=6` (23 image tokens, 16 + 23 in the mask stream), from the
JAX trainer's initial parameters on its draws, against the JAX `Trainer` at
mesh.sp = 2 with the same streams (GSPMD pads the uneven token sharding;
JAX's ring masks the pad keys through `nvalid`).

Against JAX, the loss, loss_mask and grad_norm of three steps and the
parameters and EMA after them are held at rtol 1e-4 / atol 1e-5
(`test_torch_port_train_sp.py`'s tolerance).
"""
import jax
import numpy as np
import pytest
import torch

import torch_port_mesh_common as mc
import torch_port_mesh_worker as worker
from torch_port_train_common import jax_mesh_draws, jax_mesh_steps, jax_mesh_trainer, to_port

STEPS = 3
UNEVEN = dict(nnet=dict(num_clip_token=6), dataset=dict(clip_shape=(6, 16)))
JAX_TOL = dict(rtol=1e-4, atol=1e-5)


def _jax(tmp, mesh, seed, params=None):
    """A JAX trainer at `mesh` with 6 context tokens, from `params` if given:
    (its initial parameters, its steps as tensors, the trainer, the numpy
    batches)."""
    jt = jax_mesh_trainer(tmp / f"jax_{seed}", mesh, clip_tokens=6, params=params)
    init = {k: torch.from_numpy(np.array(v)) for k, v in to_port(jt.state.params).items()}
    raw = [tuple(x.numpy() for x in b) for b, _ in mc.tiny_steps(STEPS, seed=seed,
                                                                 clip_tokens=6)]
    return init, [mc.as_tensors(*s) for s in jax_mesh_draws(jt, raw)], jt, raw


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sp")
    dp_init, dp_steps, dp_jax, dp_raw = _jax(tmp, dict(sp=2, dp=2), 3)
    params = jax.device_get(dp_jax.state.params)  # the sp = 2 trainer's too
    sample = mc.sample_inputs(clip_tokens=6)
    specs = dict(
        spdp=(4, dict(config=dict(UNEVEN, mesh=dict(sp=2, dp=2)), init=dp_init,
                      steps=dp_steps, sample=sample)),
        spdp_in=(2, dict(config=dict(UNEVEN, mesh=dict(sp=2, dp=2, sp_mode="in_process")),
                         init=dp_init, steps=dp_steps, sample=sample)),
        sptp=(4, dict(config=dict(mesh=dict(sp=2, tp=2)), steps=mc.tiny_steps(STEPS, seed=4))),
        spfsdp=(4, dict(config=dict(mesh=dict(sp=2, fsdp=2)),
                        steps=mc.tiny_steps(STEPS, seed=6))))
    procs = {job: mc.start(tmp, job, world, spec) for job, (world, spec) in specs.items()}
    jax_runs = dict(spdp=jax_mesh_steps(dp_jax, dp_raw))
    init, steps, jt, raw = _jax(tmp, dict(sp=2), 5, params)
    jax_runs["uneven"] = jax_mesh_steps(jt, raw)
    uneven = worker.run_job(dict(init=init, steps=steps, config=dict(
        UNEVEN, mesh=dict(sp=2, sp_mode="in_process"))), str(tmp), "uneven", 0)
    refs = {job: mc.one_process(tmp, f"{job}_one", spec) for job, (_, spec) in specs.items()
            if job != "spdp_in"}
    refs["spdp_in"] = refs["spdp"]  # the same job
    got = {job: mc.finish(tmp, job, p) for job, p in procs.items()}
    return dict(tmp=tmp, got=got, refs=refs, jax=jax_runs, uneven=uneven)


@pytest.mark.parametrize("job", ["spdp", "spdp_in", "sptp", "spfsdp"])
def test_sp_beside_dp_or_tp_equals_one_process(runs, job):
    got, ref = runs["got"][job], runs["refs"][job]
    for g in got:
        mc.assert_metrics(g["metrics"], ref["metrics"], f"{job} vs one process")
    mc.assert_state(got[0]["state"], ref["state"], f"{job} vs one process")
    coords = [(g["coords"]["dp"], g["coords"]["sp"], g["coords"]["tp"]) for g in got]
    assert coords == {"spdp": [(0, 0, 0), (0, 1, 0), (1, 0, 0), (1, 1, 0)],
                      "spdp_in": [(0, 0, 0), (1, 0, 0)],
                      "sptp": [(0, 0, 0), (0, 0, 1), (0, 1, 0), (0, 1, 1)],
                      "spfsdp": [(0, 0, 0), (0, 1, 0), (0, 0, 0), (0, 1, 0)]}[job]


@pytest.mark.parametrize("job", ["spdp", "spdp_in"])
def test_samples_under_sp_equal_one_process(runs, job):
    tmp, ref = runs["tmp"], runs["refs"][job]["samples"]
    for r, g in enumerate(runs["got"][job]):
        for a, b, what in zip(g["samples"], ref, ("images", "mask")):
            mc.close(a.numpy(), b.numpy(), f"{job} rank {r} {what}",
                     tol=dict(rtol=1e-4, atol=1e-4))
    assert (tmp / f"{job}_wd0" / "train_samples" / f"{STEPS}.png").exists()
    assert not (tmp / f"{job}_wd1" / "train_samples").exists()


def test_a_stream_that_does_not_divide_sp_equals_the_jax_trainer(runs):
    jax_metrics, jax_state = runs["jax"]["uneven"]
    mc.assert_metrics(runs["uneven"]["metrics"], jax_metrics, "uneven sp vs JAX sp=2",
                      tol=JAX_TOL)
    mc.assert_state(runs["uneven"]["state"], jax_state, "uneven sp vs JAX sp=2", tol=JAX_TOL)


@pytest.mark.parametrize("job", ["spdp", "spdp_in"])
def test_sp_beside_dp_equals_the_jax_trainer(runs, job):
    jax_metrics, jax_state = runs["jax"]["spdp"]
    got = runs["got"][job]
    for g in got:
        mc.assert_metrics(g["metrics"], jax_metrics, f"{job} vs JAX sp=2 x dp=2", tol=JAX_TOL)
    mc.assert_state(got[0]["state"], jax_state, f"{job} vs JAX sp=2 x dp=2", tol=JAX_TOL)
