"""Pipeline parallelism (`mesh.pp`) over processes: the boomerang schedule's
stages as gloo processes (`tests/torch_port_mesh_worker.py`, one set of
processes for every check, started together; 120 s), each trained on the
global batch of 16 in f32 and held at rtol / atol 1e-5
(`test_torch_port_fsdp_gloo.py`'s tolerance):

  * pp = 2 (2 microbatches), from the JAX trainer's initial parameters on
    its draws: the loss, loss_mask and grad_norm of three steps, and the
    parameters and EMA after them, equal one process's and the JAX
    `Trainer`'s at mesh.pp = 2 with `nnet.scan_blocks=True` (its pipeline's
    requirement) on the 8-device CPU mesh; each stage holds its own blocks
    (of the depth-4 model, stage 0 in-layer 0 and out-layer 1, stage 1
    in-layer 1, the mid layer and out-layer 0) and every replicated tensor;
    rank 0's checkpoint is one
    process's file, and a fourth step resumed from it in one process, and
    one resumed by both stages from one process's checkpoint, equal one
    process's fourth; the sampler's images and mask on both stages equal
    one process's, and only rank 0 writes the grid;
  * pp = 2 with `train.pp_microbatches=4`, with `train.grad_accum=2`, and
    beside dp = 2 over four processes: three steps each on the same batches,
    against one process; the first two also against the JAX `Trainer` at
    mesh.pp = 2 with the same `pp_microbatches` / `grad_accum` (whose draws
    grad_accum takes: the JAX step splits its key over the micro-batches);
  * pp = 2 under bf16 autocast against one process under it (the carries'
    dtypes differ by direction): losses at rtol 1e-4, grad_norm at 1e-2,
    parameters and EMA at atol 2e-5.
"""
import jax
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
JAX_METRIC_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pp")
    scan = dict(scan_blocks=True)
    jt = jax_mesh_trainer(tmp / "jax", dict(pp=2), nnet=scan)
    params = jax.device_get(jt.state.params)  # every JAX trainer's here
    init = {k: torch.from_numpy(np.array(v)) for k, v in to_port(params).items()}
    raw = batches(STEPS + 1)
    steps = [mc.as_tensors(*s) for s in jax_mesh_draws(jt, raw)]
    one_ckpt = tmp / "pp_one_ckpts" / f"{STEPS}.ckpt"
    pp_spec = dict(init=init, steps=steps[:STEPS], sample=mc.sample_inputs(),
                   config=dict(mesh=dict(pp=2)), resume=(str(one_ckpt), *steps[STEPS]))
    micro_spec = dict(init=init, steps=steps[:STEPS], config=dict(
        mesh=dict(pp=2), train=dict(pp_microbatches=4)))
    accum_steps = [mc.as_tensors(*s) for s in jax_mesh_draws(jt, raw[:STEPS], accum=2)]
    accum_spec = dict(init=init, steps=accum_steps, config=dict(
        mesh=dict(pp=2), train=dict(grad_accum=2)))
    dp_spec = dict(init=init, steps=steps[:STEPS], config=dict(mesh=dict(pp=2, dp=2)))
    bf16_spec = dict(init=init, steps=steps[:STEPS],
                     config=dict(mesh=dict(pp=2), compute_dtype="bfloat16"))
    refs = dict(pp=mc.one_process(tmp, "pp_one", pp_spec))  # writes one_ckpt first
    procs = dict(pp=mc.start(tmp, "pp", 2, pp_spec), micro=mc.start(tmp, "micro", 2, micro_spec),
                 accum=mc.start(tmp, "accum", 2, accum_spec),
                 ppdp=mc.start(tmp, "ppdp", 4, dp_spec), bf16=mc.start(tmp, "bf16", 2, bf16_spec))
    jax_runs = dict(pp=jax_mesh_steps(jt, raw[:STEPS]))
    for job, spec in (("micro", micro_spec), ("accum", accum_spec)):
        trainer = jax_mesh_trainer(tmp / f"jax_{job}", dict(pp=2), nnet=scan,
                                   train=spec["config"]["train"], params=params)
        jax_runs[job] = jax_mesh_steps(trainer, raw[:STEPS])
    refs["accum"] = mc.one_process(tmp, "accum_one", accum_spec)
    refs["bf16"] = mc.one_process(tmp, "bf16_one", bf16_spec)
    got = {job: mc.finish(tmp, job, p) for job, p in procs.items()}
    return dict(tmp=tmp, got=got, refs=refs, jax=jax_runs, pp_spec=pp_spec)


def test_pp_over_two_processes_equals_one_process_and_jax(runs):
    got, ref = runs["got"]["pp"], runs["refs"]["pp"]
    assert [g["coords"]["pp"] for g in got] == [0, 1]
    for g in got:
        mc.assert_metrics(g["metrics"], ref["metrics"], "pp vs one process")
    mc.assert_state(got[0]["state"], ref["state"], "pp vs one process")
    jax_metrics, jax_state = runs["jax"]["pp"]
    mc.assert_metrics(got[0]["metrics"], jax_metrics, "pp vs JAX pp=2", tol=JAX_METRIC_TOL)
    mc.assert_state(got[0]["state"], jax_state, "pp vs JAX pp=2")
    names = list(ref["state"]["params"])
    for stage, g in enumerate(got):  # its own blocks and every replicated tensor
        want = [n for n in names if owner_stage(n, 2, 2) in (stage, None)]
        assert sorted(g["held"]) == sorted(want)
    assert any(n.startswith("mid_block") for n in got[1]["held"])
    assert not any(n.startswith("mid_block") for n in got[0]["held"])


@pytest.mark.parametrize("job", ["micro", "accum", "ppdp"])
def test_pp_variants_equal_one_process(runs, job):
    ref = runs["refs"]["accum" if job == "accum" else "pp"]
    got = runs["got"][job]
    for g in got:
        mc.assert_metrics(g["metrics"], ref["metrics"], f"{job} vs one process")
    mc.assert_state(got[0]["state"], ref["state"], f"{job} vs one process")


def test_pp_under_bf16_autocast_equals_one_process(runs):
    """Under autocast the out-layers return bf16 carries while the in-layers
    keep f32 ones: each exchange must post its receives in the sender's
    dtype.  Posted in the receiver's own dtype, a bf16 carry landed in an
    f32 buffer (half of it the sent bytes, the rest whatever memory held):
    loss 1.3e-3-2.7e-3, grad_norm 0.21-0.27 and parameters 1.2e-4 from one
    process on this job.  Received right, what is left is bf16's rounding of
    the GEMMs of two microbatches of 8 rows, not one of 16: losses 1.9e-5, grad_norm
    2.8e-3, parameters and EMA 7.1e-6."""
    got, ref = runs["got"]["bf16"], runs["refs"]["bf16"]
    for g in got:
        mc.assert_metrics(g["metrics"], ref["metrics"], "bf16 pp vs one process",
                          keys=("loss", "loss_mask"), tol=dict(rtol=1e-4, atol=0))
        mc.assert_metrics(g["metrics"], ref["metrics"], "bf16 pp vs one process",
                          keys=("grad_norm",), tol=dict(rtol=1e-2, atol=0))
    mc.assert_state(got[0]["state"], ref["state"], "bf16 pp vs one process",
                    tol=dict(rtol=0, atol=2e-5))


@pytest.mark.parametrize("job", ["micro", "accum"])
def test_pp_variants_equal_the_jax_trainer(runs, job):
    jax_metrics, jax_state = runs["jax"][job]
    what = f"{job} vs JAX pp=2"
    for g in runs["got"][job]:
        mc.assert_metrics(g["metrics"], jax_metrics, what, tol=JAX_METRIC_TOL)
    mc.assert_state(runs["got"][job][0]["state"], jax_state, what)


def test_pp_checkpoints_are_one_process_files_both_ways(runs):
    tmp, got, ref = runs["tmp"], runs["got"]["pp"], runs["refs"]["pp"]
    mc.assert_metrics([got[0]["resumed_metrics"]], [ref["resumed_metrics"]], "pp step 4")
    mc.assert_state(got[0]["resumed"], ref["resumed"], "pp resumed from one process")
    pp_ckpt = ckpt_lib.load_checkpoint(str(tmp / "pp_ckpts" / f"{STEPS}.ckpt"))
    one_ckpt = ckpt_lib.load_checkpoint(str(tmp / "pp_one_ckpts" / f"{STEPS}.ckpt"))
    assert pp_ckpt.keys() == one_ckpt.keys()
    assert list(pp_ckpt["params"]) == list(one_ckpt["params"])
    assert pp_ckpt["opt_state"]["param_groups"] == one_ckpt["opt_state"]["param_groups"]
    for i, st in one_ckpt["opt_state"]["state"].items():
        mc.close(pp_ckpt["opt_state"]["state"][i]["exp_avg"].numpy(), st["exp_avg"].numpy(),
                 f"moment {i}")
    trainer = worker.Trainer(worker.make_config({}), str(tmp / "from_pp"), device="cpu")
    trainer.state.load_state_dict(pp_ckpt)
    metrics = worker.step(trainer, *runs["pp_spec"]["resume"][1:])
    mc.assert_metrics([metrics], [ref["resumed_metrics"]], "one process from pp's step 3")
    mc.assert_state(worker.whole(trainer), ref["resumed"], "one process from pp's step 3")


def test_samples_under_pp_equal_one_process(runs):
    tmp, ref = runs["tmp"], runs["refs"]["pp"]["samples"]
    for r, g in enumerate(runs["got"]["pp"]):
        for a, b, what in zip(g["samples"], ref, ("images", "mask")):
            mc.close(a.numpy(), b.numpy(), f"pp stage {r} {what}", tol=dict(rtol=1e-4, atol=1e-4))
    assert (tmp / "pp_wd0" / "train_samples" / f"{STEPS}.png").exists()
    assert not (tmp / "pp_wd1" / "train_samples").exists()
