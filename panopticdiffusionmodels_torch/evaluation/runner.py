"""Evaluation and sampling entry points behind `python -m panopticdiffusionmodels_torch
eval|sample`, and the training callbacks.

Port of `panopticdiffusionmodels_tpu/evaluation/runner.py` (the reference's
`eval.py`, `eval_ldm*.py`, `eval_t2i_discrete.py`,
`sample_t2i_discrete.py`): load weights (a reference-format `.pth` or a
checkpoint of the trainer), generate `config.sample.n_samples` with the
trainer's sampler (`Trainer.build_sample_fn`, kernel 1 in every attention
on the card), write PNGs under the FID / CLIP naming contract with the mask
metrics (`sampler_io.sample2dir`), and take FID against the dataset's
reference stats when the stats file and the Inception weights both exist
(else `metrics` has no `fid` key).  Every entry point runs on the card
unless the caller passes device="cpu".

The port's initial draws and labels come from a `torch.Generator` seeded
from `config.seed + 777` (the vis callback: from (`config.seed + 99`,
step)), where JAX splits a key seeded the same way: the same protocol, other
random numbers.
"""
from __future__ import annotations

import logging
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from ..data.loader import _collate
from ..diffusion.analog_bits import ints_to_analog
from ..diffusion.math import mos
from ..train import checkpoint as ckpt_lib
from ..train.trainer import Trainer, step_seed
from ..utils.misc import amortize, to_numpy
from ..utils.weights import load_torch_state_dict, reference_nnet_state_dict
from .fid import INCEPTION_WEIGHTS, fid_given_paths
from .sampler_io import mask_ids, sample2dir, save_grid
from .mask_metrics import color_map

log = logging.getLogger(__name__)


def _load_weights(trainer: Trainer, config):
    """`config.nnet_path`: a reference-format `.pth` into the EMA weights (a
    file that matches no parameter raises), or a checkpoint directory's latest
    checkpoint; else the trainer's own latest checkpoint."""
    nnet_path = config.get("nnet_path", "")
    if nnet_path and os.path.exists(nnet_path):
        if nnet_path.endswith(".pth"):
            loaded = reference_nnet_state_dict(load_torch_state_dict(nnet_path))
            ema = trainer.state.ema
            matched = [k for k, v in loaded.items() if k in ema and ema[k].shape == v.shape]
            if not matched:
                raise ValueError(f"{nnet_path!r} matched ZERO parameters: a layout mismatch "
                                 "(check enable_panoptic / separate in the config)")
            with torch.no_grad():
                for k in matched:
                    ema[k].copy_(loaded[k])
            log.info(f"loaded reference weights {nnet_path}: {len(matched)}/{len(ema)} matched")
            return
        if ckpt_lib.resume(os.path.dirname(nnet_path), trainer.state):
            return
    trainer.resume()


def _context_stream(trainer: Trainer, batch_size: int):
    """Deterministic test contexts (+ panoptic + index), cyclic over the test
    split with wrap-around, so every sample appears once a cycle as the
    `idx + 10000 * (idx // 4992)` naming contract assumes.  The worker threads
    are shut down when the generator is closed or collected."""
    test = trainer.dataset.get_split("test", labeled=True)
    n = len(test)
    ex = ThreadPoolExecutor(max_workers=4)
    pos = 0
    try:
        while True:
            idxs = [(pos + j) % n for j in range(batch_size)]
            pos = (pos + batch_size) % n
            yield _collate(list(ex.map(test.__getitem__, idxs)))
    finally:
        ex.shutdown(wait=False)


def _n_real_classes(config) -> int:
    """Real (non-null) class count for conditional sampling: with CFG,
    `nnet.num_classes` includes the null class (reference `eval.py:43-46`:
    labels in [0, K), null = K); without CFG every class id is real."""
    k = config.nnet.get("num_classes", -1)
    if k <= 0:
        raise ValueError("conditional sampling needs config.nnet.num_classes")
    return k - 1 if config.sample.get("cfg", False) else k


def _draw(trainer: Trainer, n: int, g: torch.Generator):
    """The initial draws of n samples, channel-last: z, and the panoptic
    mask's m0 (None without a mask stream)."""
    config = trainer.config
    pipe = trainer.sample_pipeline()
    z = torch.randn((n, *pipe.z_shape), generator=g, device=trainer.device)
    m0 = None
    if pipe.panoptic:
        ms, bits = config.nnet.mask_size, config.nnet.mask_bits
        m0 = torch.randn((n, ms, ms, bits), generator=g, device=trainer.device)
    return z, m0


def make_eval_sample_fn(trainer: Trainer, sample_steps: int, batch_size: int,
                        cache: Optional[dict] = None):
    """(sample_fn(n) with the sample2dir contract, panoptic?).

    `cache`: a dict that keeps the built sampler across calls (the FID gate
    runs every save_interval); the sampler takes the trainer's EMA weights at
    every batch.  Nothing is copied back to the host here, so sample2dir can
    enqueue batch i + 1 before it waits for batch i."""
    config = trainer.config
    if cache is None:
        cache = {}
    key = ("sample_fn", sample_steps)
    if key not in cache:
        cache[key] = trainer.build_sample_fn(sample_steps)
    fn = cache[key]
    g = torch.Generator(device=trainer.device).manual_seed(config.seed + 777)
    counter = {"n": 0}

    def next_indices(n):
        # a running counter modulo the 4992-name bucket: unique names across
        # batches under sample2dir's `i + 10000 * (written // 4992)` scheme
        idx = np.arange(counter["n"], counter["n"] + n) % 4992
        counter["n"] += n
        return idx

    if trainer.task == "t2i_discrete":
        prev = cache.pop("ctx_stream", None)
        if prev is not None:
            prev.close()  # the previous round's worker threads
        ctx_stream = _context_stream(trainer, batch_size)
        cache["ctx_stream"] = ctx_stream
        panoptic_on = bool(config.nnet.enable_panoptic)
        gt_mode = bool(config.nnet.get("use_ground_truth", False))

        def sample_fn(n):
            batch = next(ctx_stream)
            fallback_index = next_indices(n)
            if len(batch) >= 4:
                _, context, panoptic, index = batch[:4]
            elif len(batch) == 3:
                _, context, third = batch
                if np.ndim(third) <= 1:  # (moments, context, index)
                    panoptic, index = None, third
                else:
                    panoptic, index = third, fallback_index
            else:
                _, context = batch[:2]
                panoptic, index = None, fallback_index
            z, m0 = _draw(trainer, n, g)
            out = fn(context, z, m0, panoptic=panoptic if gt_mode else None)
            if not panoptic_on:
                return np.asarray(index), out
            samples, pred_mask = out
            if panoptic is not None:
                target = ints_to_analog(torch.as_tensor(panoptic, device=trainer.device),
                                        n=config.nnet.mask_bits)
                loss_mask = mos(target - pred_mask)  # stays on the card
            else:
                loss_mask = np.nan
            return np.asarray(index), samples, pred_mask, loss_mask, panoptic

        return sample_fn, panoptic_on

    if trainer.task == "latent_discrete" or config.train.get("mode") == "cond":
        n_classes = _n_real_classes(config)

        def sample_fn(n):
            y = torch.randint(0, n_classes, (n,), generator=g, device=trainer.device)
            z, _ = _draw(trainer, n, g)
            return next_indices(n), fn(y, z, generator=g)

        return sample_fn, False

    def sample_fn(n):
        z, _ = _draw(trainer, n, g)
        return next_indices(n), fn(None, z, generator=g)

    return sample_fn, False


def _log_captions(trainer: Trainer, workdir: str, indices):
    """The prompts of the first sampled batch (the reference's
    eval_caption.log, `train_t2i_discrete.py:645-653`), from the `{i}_text.txt`
    files of the extraction scripts."""
    base = getattr(trainer.dataset, "path", None)
    if not base:
        return
    lines = []
    for i in indices:
        p = os.path.join(base, "val", f"{int(i)}_text.txt")
        if os.path.exists(p):
            with open(p) as f:
                lines.append(f"{int(i)}: {f.readline().strip()}")
    if lines:
        with open(os.path.join(workdir, "eval_caption.log"), "a") as f:
            f.write("\n".join(lines) + "\n")


def evaluate(config, workdir: str, n_samples: Optional[int] = None,
             inception_path: str = INCEPTION_WEIGHTS, device="cuda"):
    """Sample `n_samples` (default `config.sample.n_samples`) into
    workdir/samples (+ workdir/mask), then FID; returns the metrics."""
    trainer = Trainer(config, workdir, device=device)
    _load_weights(trainer, config)
    sample_dir = os.path.join(workdir, "samples")
    n = n_samples or config.sample.n_samples
    bs = config.sample.mini_batch_size
    sample_fn, use_panoptic = make_eval_sample_fn(trainer, config.sample.sample_steps, bs)
    if trainer.task == "t2i_discrete":
        inner, first = sample_fn, {"done": False}

        def sample_fn(nb):  # noqa: F811: log the first batch's captions
            out = inner(nb)
            if not first["done"]:
                first["done"] = True
                _log_captions(trainer, workdir, out[0])
            return out

    metrics = sample2dir(sample_dir, n, bs, sample_fn,
                         unpreprocess_fn=trainer.dataset.unpreprocess,
                         use_panoptic=use_panoptic, mask_path=os.path.join(workdir, "mask"),
                         mask_bits=config.nnet.get("mask_bits", 8))
    fid = _score_fid(trainer, sample_dir, workdir, n, metrics, inception_path=inception_path)
    if fid is not None:
        log.info(f"FID{n}: {fid}")
    log.info(f"eval metrics: {metrics}")
    return metrics


def _fid_ready(trainer: Trainer, inception_path: str) -> bool:
    fid_stat = trainer.dataset.fid_stat
    return bool(fid_stat and os.path.exists(fid_stat) and os.path.exists(inception_path))


def _score_fid(trainer: Trainer, sample_dir: str, workdir: str, n: int, metrics: dict,
               step: Optional[int] = None, inception_path: str = INCEPTION_WEIGHTS):
    """FID against the dataset's reference stats when the stats file and the
    Inception weights exist: adds metrics['fid'] and a line to eval.log.  A
    weights file that is there but does not load raises."""
    if not _fid_ready(trainer, inception_path):
        return None
    from .inception import load_inception_weights, make_extractor

    extractor = make_extractor(load_inception_weights(inception_path), device=trainer.device)
    fid = fid_given_paths(trainer.dataset.fid_stat, sample_dir, extractor)
    metrics["fid"] = fid
    with open(os.path.join(workdir, "eval.log"), "a") as f:
        tag = f"step={step} " if step is not None else ""
        print(f"{tag}fid{n}={fid} {metrics}", file=f)
    return fid


def sample_only(config, workdir: str, inception_path: str = INCEPTION_WEIGHTS, device="cuda"):
    """One mini-batch of samples (the reference's sample scripts)."""
    return evaluate(config, workdir, n_samples=config.sample.mini_batch_size,
                    inception_path=inception_path, device=device)


def _agree(trainer: Trainer, value):
    """Rank 0's `value` on every rank of a multi-process trainer."""
    if trainer.dp is None:
        return value
    import torch.distributed as dist

    box = [value]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def _samples_here(trainer: Trainer) -> bool:
    """Whether this rank samples: rank 0, and every rank of a layout whose
    sampler needs them all (the gathers, rings and sends of fsdp, sp, tp
    and pp); under plain data parallelism the sampler has no collectives."""
    return trainer.is_main or not trainer.dp.pure_data_parallel


def make_vis_callback(n_images: int = 16, sample_steps: int = 50):
    """Periodic sample-grid writer (the reference's wandb image grids,
    `train.py:166-178`, `train_t2i_discrete.py:637-689`): writes
    workdir/train_samples/{step}.png (+ {step}_mask.png for panoptic).
    Under a process mesh every rank whose sampler needs it
    (`_samples_here`) samples the same grid; rank 0 writes it."""
    cache = {}

    def callback(trainer: Trainer, step: int):
        if not _samples_here(trainer):
            return
        config = trainer.config
        n = min(n_images, config.sample.mini_batch_size)
        if "fn" not in cache:
            cache["fn"] = trainer.build_sample_fn(sample_steps)
        g = torch.Generator(device=trainer.device).manual_seed(
            step_seed(config.seed + 99, step))
        out_dir = os.path.join(trainer.workdir, "train_samples")
        if trainer.task == "t2i_discrete":
            test = trainer.dataset.get_split("test", labeled=True)
            cond = np.stack([np.asarray(test[i][1]) for i in range(n)])
        elif trainer.task == "latent_discrete" or config.train.get("mode") == "cond":
            # labels first, then the initial noise: independent draws
            cond = torch.randint(0, _n_real_classes(config), (n,), generator=g,
                                 device=trainer.device)
        else:
            cond = None
        z, m0 = _draw(trainer, n, g)
        out = cache["fn"](cond, z, m0, generator=g)
        if not trainer.is_main:
            return
        os.makedirs(out_dir, exist_ok=True)
        if isinstance(out, tuple):
            samples, pred_mask = out
            colors = color_map(mask_ids(pred_mask, config.nnet.get("mask_bits", 8)))
            save_grid(colors.astype(np.float32) / 255.0,
                      os.path.join(out_dir, f"{step}_mask.png"))
        else:
            samples = out
        samples01 = trainer.dataset.unpreprocess(to_numpy(samples).astype(np.float32))
        save_grid(samples01, os.path.join(out_dir, f"{step}.png"))
        log.info(f"wrote sample grid at step {step}")

    return callback


def make_fid_gated_callback(n_samples: Optional[int] = None,
                            inception_path: str = INCEPTION_WEIGHTS):
    """In-training eval callback with best-FID checkpoint retention (reference
    `train.py:182-196`, `train_t2i_discrete.py:694-710`): every
    save_interval, sample + score, and keep the checkpoint only when FID
    improves; without the FID assets, save every checkpoint and sample
    nothing.  Every rank of a multi-process trainer enters the checkpoint's
    gathers, and samples where its sampler needs it (`_samples_here`);
    rank 0 writes the samples and the checkpoint, computes FID and
    decides."""
    best = {"fid": None}
    cache: dict = {}  # one sampler reused across eval rounds

    def callback(trainer: Trainer, step: int):
        config = trainer.config
        ckpt_lib.wait_for_saves()  # the last round's write is on disk before this one decides
        if not _agree(trainer, _fid_ready(trainer, inception_path)):
            log.info("FID assets missing; saving ungated checkpoint")
            trainer.save_checkpoint()
            return {}
        n = n_samples or config.sample.n_samples
        bs = config.sample.mini_batch_size
        sample_dir = os.path.join(trainer.workdir, "samples")
        fid, metrics = None, {}
        if _samples_here(trainer):
            sample_fn, use_panoptic = make_eval_sample_fn(trainer, config.sample.sample_steps,
                                                          bs, cache=cache)
        if trainer.is_main:
            metrics = sample2dir(sample_dir, n, bs, sample_fn,
                                 unpreprocess_fn=trainer.dataset.unpreprocess,
                                 use_panoptic=use_panoptic,
                                 mask_path=os.path.join(trainer.workdir, "mask"),
                                 mask_bits=config.nnet.get("mask_bits", 8))
            fid = _score_fid(trainer, sample_dir, trainer.workdir, n, metrics, step=step,
                             inception_path=inception_path)
            log.info(f"eval@{step}: {metrics}")
        elif _samples_here(trainer):  # the same batches, for the collectives
            for _ in amortize(n, bs):
                sample_fn(bs)
        fid = _agree(trainer, fid)
        if fid is None or best["fid"] is None or fid <= best["fid"]:
            if fid is not None:
                best["fid"] = fid
            log.info(f"saving best checkpoint at step {step}")
            trainer.save_checkpoint()
        return metrics

    return callback
