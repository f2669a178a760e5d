"""Tensor parallelism (`mesh.tp`), beside fsdp, for the U-ViT and the UNet.

In process: the per-head qkv split, the GEGLU split and their gathers are
exact round trips, and a rank's heads and gated features are those of the
whole layer.

Over gloo (`tests/torch_port_mesh_worker.py`, one set of processes for
every check, started together: two at tp = 2, four at tp = 2 x fsdp = 2,
two for a tiny UNet at tp = 2; 120 s), each against this one process
running the same job on the global batch of 16, f32, at rtol / atol 1e-5
(`test_torch_port_fsdp_gloo.py`'s tolerance):

  * tp = 2, from the JAX trainer's initial parameters on its draws: the
    loss, loss_mask and grad_norm of three steps, and the parameters and
    EMA after them, equal one process's and the JAX `Trainer`'s at
    mesh.tp = 2 on the 8-device CPU mesh; a rank holds half of every
    tp-split weight; rank 0's checkpoint is one process's file, and a
    fourth step resumed from it in one process, and one resumed by the
    tp ranks from one process's checkpoint, equal one process's fourth;
    the sampler's images and mask, on every rank, equal one process's,
    and only rank 0 writes the grid;
  * tp = 2 beside fsdp = 2 on the same inputs: the same three steps, also
    equal to the JAX `Trainer`'s at mesh.tp = 2, mesh.fsdp = 2, and the
    samples (the EMA gathered whole over fsdp);
  * the UNet at tp = 2 (its GEGLU split per value / gate pair): three steps.
"""
import os

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from panopticdiffusionmodels_torch.parallel import tensor as tp_lib
from panopticdiffusionmodels_torch.train import checkpoint as ckpt_lib
import torch_port_mesh_common as mc
import torch_port_mesh_worker as worker
from torch_port_train_common import (batches, jax_mesh_draws, jax_mesh_steps, jax_mesh_trainer,
                                     to_port)
from torch_port_unet_common import unet_fields

STEPS = 3
JAX_METRIC_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    jt = jax_mesh_trainer(tmp / "jax", dict(tp=2))
    params = jax.device_get(jt.state.params)  # the tp x fsdp trainer's too
    init = {k: torch.from_numpy(np.array(v)) for k, v in to_port(params).items()}
    raw = batches(STEPS + 1)
    steps = [mc.as_tensors(*s) for s in jax_mesh_draws(jt, raw)]
    one_ckpt = tmp / "tp_one_ckpts" / f"{STEPS}.ckpt"
    base = dict(init=init, steps=steps[:STEPS], sample=mc.sample_inputs())
    tp_spec = dict(base, config=dict(mesh=dict(tp=2)), resume=(str(one_ckpt), *steps[STEPS]))
    fsdp_spec = dict(base, config=dict(mesh=dict(tp=2, fsdp=2)))
    unet_spec = dict(config=dict(nnet=unet_fields(channel_mult=[2, 2]), mesh=dict(tp=2),
                                 sample=dict(algorithm="pndm")),
                     steps=mc.tiny_steps(STEPS, seed=2))
    refs = dict(tp=mc.one_process(tmp, "tp_one", tp_spec))  # writes one_ckpt first
    procs = dict(tp=mc.start(tmp, "tp", 2, tp_spec),
                 tpfsdp=mc.start(tmp, "tpfsdp", 4, fsdp_spec),
                 unet=mc.start(tmp, "unet", 2, unet_spec))
    jax_runs = dict(tp=jax_mesh_steps(jt, raw[:STEPS]), tpfsdp=jax_mesh_steps(
        jax_mesh_trainer(tmp / "jax_fsdp", dict(tp=2, fsdp=2), params=params), raw[:STEPS]))
    refs["tpfsdp"] = refs["tp"]  # the same job
    refs["unet"] = mc.one_process(tmp, "unet_one", unet_spec)
    got = {job: mc.finish(tmp, job, p) for job, p in procs.items()}
    return dict(tmp=tmp, got=got, refs=refs, jax=jax_runs, tp_spec=tp_spec)


def test_per_head_and_geglu_splits_round_trip():
    torch.manual_seed(0)
    c, heads, x = 32, 8, torch.randn(2, 5, 32)
    qkv = torch.randn(3 * c, c)
    for tp in (2, 4):
        parts = [tp_lib.split(qkv, (0, 3), tp, r) for r in range(tp)]
        assert torch.equal(tp_lib.join(parts, (0, 3)), qkv)
        whole = (x @ qkv.T).reshape(2, 5, 3, heads, c // heads)
        for r, w in enumerate(parts):  # rank r's columns are [q_r | k_r | v_r] of its heads
            mine = (x @ w.T).reshape(2, 5, 3, heads // tp, c // heads)
            assert torch.equal(mine, whole[:, :, :, r * heads // tp:(r + 1) * heads // tp])
    ff = torch.randn(8 * c, c)  # GEGLU: [value | gate], 4c each
    a, g = (x @ ff.T).chunk(2, -1)
    full = a * F.gelu(g)
    for tp in (2, 4):
        parts = [tp_lib.split(ff, (0, 2), tp, r) for r in range(tp)]
        assert torch.equal(tp_lib.join(parts, (0, 2)), ff)
        for r, w in enumerate(parts):
            ar, gr = (x @ w.T).chunk(2, -1)
            width = 4 * c // tp
            torch.testing.assert_close(ar * F.gelu(gr), full[..., r * width:(r + 1) * width])
    proj = torch.randn(c, c)  # row-parallel: input columns
    parts = [tp_lib.split(proj, (1, 1), 2, r) for r in range(2)]
    assert torch.equal(tp_lib.join(parts, (1, 1)), proj)


def test_tp_over_two_processes_equals_one_process_and_jax(runs):
    got, ref = runs["got"]["tp"], runs["refs"]["tp"]
    assert [g["coords"]["tp"] for g in got] == [0, 1]
    assert [g["is_main"] for g in got] == [True, False]
    for g in got:
        mc.assert_metrics(g["metrics"], ref["metrics"], "tp vs one process")
    mc.assert_state(got[0]["state"], ref["state"], "tp vs one process")
    jax_metrics, jax_state = runs["jax"]["tp"]
    mc.assert_metrics(got[0]["metrics"], jax_metrics, "tp vs JAX tp=2", tol=JAX_METRIC_TOL)
    mc.assert_state(got[0]["state"], jax_state, "tp vs JAX tp=2")
    held, numel = got[1]["held"], {n: v.numel() for n, v in ref["state"]["params"].items()}
    split = [n for n in numel if "block" in n and n.endswith(
        (".qkv.weight", ".proj.weight", ".fc1.weight", ".fc2.weight", ".fc1.bias"))]
    assert len(split) == 5 * 10  # the 10 blocks' qkv, proj, fc1, fc2 and fc1's bias
    assert all(held[n] * 2 == numel[n] for n in split)
    # the rest (norms, row-parallel biases, skip projections, embeddings,
    # heads) whole on every rank
    assert all(held[n] == numel[n] for n in numel if n not in split)


def test_tp_checkpoints_are_one_process_files_both_ways(runs):
    tmp, got, ref = runs["tmp"], runs["got"]["tp"], runs["refs"]["tp"]
    # the tp ranks resumed one process's checkpoint of step 3: their step 4
    mc.assert_metrics([got[0]["resumed_metrics"]], [ref["resumed_metrics"]], "tp step 4")
    mc.assert_state(got[0]["resumed"], ref["resumed"], "tp resumed from one process")
    # one process resumes rank 0's checkpoint
    tp_ckpt = ckpt_lib.load_checkpoint(str(tmp / "tp_ckpts" / f"{STEPS}.ckpt"))
    one_ckpt = ckpt_lib.load_checkpoint(str(tmp / "tp_one_ckpts" / f"{STEPS}.ckpt"))
    assert tp_ckpt.keys() == one_ckpt.keys()
    assert tp_ckpt["opt_state"]["param_groups"] == one_ckpt["opt_state"]["param_groups"]
    assert sorted(tp_ckpt["opt_state"]["state"]) == sorted(one_ckpt["opt_state"]["state"])
    spec = runs["tp_spec"]
    path = str(tmp / "tp_ckpts" / f"{STEPS}.ckpt")
    trainer = worker.Trainer(worker.make_config({}), str(tmp / "from_tp"), device="cpu")
    trainer.state.load_state_dict(ckpt_lib.load_checkpoint(path))
    metrics = worker.step(trainer, *spec["resume"][1:])
    mc.assert_metrics([metrics], [ref["resumed_metrics"]], "one process from tp's step 3")
    mc.assert_state(worker.whole(trainer), ref["resumed"], "one process from tp's step 3")
    assert not (tmp / "tp_wd1").exists() or not os.listdir(tmp / "tp_wd1")


def test_samples_under_tp_and_fsdp_equal_one_process(runs):
    tmp = runs["tmp"]
    for job in ("tp", "tpfsdp"):
        ref = runs["refs"][job]["samples"]
        for r, g in enumerate(runs["got"][job]):
            for a, b, what in zip(g["samples"], ref, ("images", "mask")):
                mc.close(a.numpy(), b.numpy(), f"{job} rank {r} {what}",
                         tol=dict(rtol=1e-4, atol=1e-4))
        assert (tmp / f"{job}_wd0" / "train_samples" / f"{STEPS}.png").exists()
        assert not (tmp / f"{job}_wd1" / "train_samples").exists()


def test_tp_beside_fsdp_over_four_processes_equals_one_process(runs):
    got, ref = runs["got"]["tpfsdp"], runs["refs"]["tpfsdp"]
    coords = [(g["coords"]["fsdp"], g["coords"]["tp"]) for g in got]
    assert coords == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for g in got:
        mc.assert_metrics(g["metrics"], ref["metrics"], "tp x fsdp vs one process")
    mc.assert_state(got[0]["state"], ref["state"], "tp x fsdp vs one process")
    w = "in_blocks.0.attn.qkv.weight"
    assert got[3]["held"][w] * 4 == ref["state"]["params"][w].numel()


def test_tp_beside_fsdp_equals_the_jax_trainer(runs):
    jax_metrics, jax_state = runs["jax"]["tpfsdp"]
    got = runs["got"]["tpfsdp"]
    for g in got:
        mc.assert_metrics(g["metrics"], jax_metrics, "tp x fsdp vs JAX tp=2 x fsdp=2",
                          tol=JAX_METRIC_TOL)
    mc.assert_state(got[0]["state"], jax_state, "tp x fsdp vs JAX tp=2 x fsdp=2")


def test_unet_at_tp_2_equals_one_process(runs):
    got, ref = runs["got"]["unet"], runs["refs"]["unet"]
    for g in got:
        mc.assert_metrics(g["metrics"], ref["metrics"], "UNet tp vs one process")
    mc.assert_state(got[0]["state"], ref["state"], "UNet tp vs one process")
    ff = [n for n in ref["state"]["params"] if n.endswith("ff_proj.weight")]
    assert ff and all(got[1]["held"][n] * 2 == ref["state"]["params"][n].numel() for n in ff)
