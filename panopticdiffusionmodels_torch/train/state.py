"""Train state: f32 parameters, their EMA and AdamW or Adam, with a frozen subset.

Port of `panopticdiffusionmodels_tpu/train/state.py`.  The JAX state is one
pytree updated by a jitted step; here the model's own parameters are the
f32 master weights, the EMA is a dict of f32 tensors beside them, updated
in place after every optimizer step (`e * rate + (1 - rate) * p`, over every
parameter, frozen ones too, as the JAX `tree.map` does), and
`torch.optim.AdamW` takes the optax `adamw` update: the same bias-corrected
moments, eps outside the square root, decoupled weight decay scaled by the
learning rate.  The learning rate of update k (k = 0, 1, ...) is the
schedule at count k, as optax evaluates it, so the first update's warm-up
lr is 0.  `optimizer='adam'` is `torch.optim.Adam` for optax `adam` (no
weight decay; the same m_hat / (sqrt(v_hat) + eps)).  Frozen parameters
(the pretrained image stream) are left out of the optimizer, which the JAX
`multi_transform` + `set_to_zero` amounts to.

Built from a network that `parallel/sharding.py` has sharded (FSDP), the
parameters are `DTensor`s, and so are the moments and the EMA made from
them: each rank updates its own shards.  Under a process mesh the trainer
hands the state a `parallel/placement.py::Placement` (a rank may hold tp
slices and one pipeline stage's blocks): `state_dict` then gathers whole
tensors and merges the stages (a collective every rank enters), so a
checkpoint holds what one process's holds, with the optimizer's state in
one process's order, and `load_state_dict` keeps each rank's part of the
whole tensors it reads.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Optional, Sequence

import numpy as np
import torch

from ..parallel.sharding import full, is_sharded, local, shard_like

# Top-level modules of the image stream that fine-tuning the panoptic model
# freezes (reference `train_t2i_discrete.py:313-319`; JAX
# `panoptic_image_stream_mask`).  Everything else trains: pos_embed, the
# mask stream (`*_mask`, mid_block_mask), the zero convs, norm and the heads.
IMAGE_STREAM = ("patch_embed", "context_embed", "time_embed", "mid_block", "in_blocks",
                "out_blocks")


def panoptic_image_stream_frozen(names: Iterable[str]) -> set:
    """The parameter names (port / reference names) the JAX mask freezes."""
    return {n for n in names if n.split(".")[0] in IMAGE_STREAM}


def make_lr_schedule(base_lr: float, name: str = "customized", warmup_steps: int = -1,
                     total_steps: Optional[int] = None) -> Callable[[int], float]:
    """count -> lr (reference `utils.py:319-336`): 'customized' is a linear
    warm-up then constant, 'cosine' optax's cosine decay to 0.  Evaluated in
    float32, as the JAX schedules are."""
    f32 = np.float32
    if name == "customized":
        if warmup_steps > 0:
            return lambda count: float(f32(base_lr) * np.minimum(
                f32(count) / f32(warmup_steps), f32(1.0)))
        return lambda count: float(base_lr)
    if name == "cosine":
        assert total_steps is not None

        def cosine(count):
            frac = f32(min(count, total_steps)) / f32(total_steps)
            return float(f32(base_lr) * f32(0.5) * (f32(1.0) + np.cos(f32(math.pi) * frac)))

        return cosine
    raise NotImplementedError(name)


class TrainState:
    """step, the model's parameters, their EMA and the optimizer."""

    def __init__(self, model: torch.nn.Module, lr_schedule: Callable[[int], float],
                 betas: Sequence[float] = (0.9, 0.999), weight_decay: float = 0.0,
                 eps: float = 1e-8, frozen: Iterable[str] = (), optimizer: str = "adamw",
                 placement=None):
        self.step = 0
        self.params: Dict[str, torch.nn.Parameter] = dict(model.named_parameters())
        # Under a process mesh (`parallel/placement.py`) this rank may hold a
        # part of the network: `full_names` are the whole network's, in one
        # process's order, and `frozen` may name parameters of other stages.
        self.placement = placement
        self.full_names = list(self.params) if placement is None else placement.full_names
        self.frozen = set(frozen)
        unknown = self.frozen - set(self.full_names)
        if unknown:
            raise ValueError(f"frozen names not in the model: {sorted(unknown)[:5]}")
        self.lr_schedule = lr_schedule
        trainable = [p for n, p in self.params.items() if n not in self.frozen]
        if optimizer == "adamw":
            self.optimizer = torch.optim.AdamW(
                trainable, lr=0.0, betas=tuple(betas), eps=eps, weight_decay=weight_decay)
        elif optimizer == "adam":  # optax.adam takes no weight decay
            self.optimizer = torch.optim.Adam(trainable, lr=0.0, betas=tuple(betas), eps=eps)
        else:
            raise NotImplementedError(f"optimizer {optimizer!r}: one of 'adamw', 'adam'")
        self.ema: Dict[str, torch.Tensor] = {n: p.detach().clone()
                                             for n, p in self.params.items()}

    def apply_gradients(self, ema_rate: float = 0.9999) -> None:
        """One optimizer update from the parameters' .grad, then the EMA."""
        for group in self.optimizer.param_groups:
            group["lr"] = self.lr_schedule(self.step)
        self.optimizer.step()
        with torch.no_grad():  # on this rank's shards when sharded
            ema = [local(e) for e in self.ema.values()]
            params = [local(p.detach()) for p in self.params.values()]
            torch._foreach_mul_(ema, ema_rate)
            torch._foreach_add_(ema, params, alpha=1.0 - ema_rate)
        self.step += 1

    @property
    def sharded(self) -> bool:
        return any(is_sharded(p) for p in self.params.values())

    def _trainable(self, names) -> list:
        return [n for n in names if n not in self.frozen]

    def state_dict(self) -> dict:
        """{step, params, ema_params, opt_state}: the live tensors, not
        copies (`checkpoint.save_checkpoint` copies them to the host); when
        sharded, whole tensors gathered from every rank, and under a process
        mesh one process's state (a collective every rank enters)."""
        if self.placement is not None:
            return self._whole_state_dict()
        sd = {"step": self.step, "params": {k: v.detach() for k, v in self.params.items()},
              "ema_params": self.ema, "opt_state": self.optimizer.state_dict()}
        return full(sd) if self.sharded else sd

    def _whole_state_dict(self) -> dict:
        pl = self.placement
        by_name = {}
        for name, p in self.params.items():
            st = self.optimizer.state.get(p, {})
            moments = {k: pl.whole(name, v) if torch.is_tensor(v) and v.dim() else v
                       for k, v in st.items()} if st else None
            by_name[name] = (pl.whole(name, p.detach()), pl.whole(name, self.ema[name]), moments)
        merged = pl.merge_stages(by_name)
        missing = set(self.full_names) - set(merged)
        if missing:
            raise RuntimeError(f"no stage holds {sorted(missing)[:5]}")
        trainable = self._trainable(self.full_names)
        groups = [{k: v for k, v in g.items() if k != "params"}
                  for g in self.optimizer.state_dict()["param_groups"]]
        return {"step": self.step,
                "params": {n: merged[n][0] for n in self.full_names},
                "ema_params": {n: merged[n][1] for n in self.full_names},
                "opt_state": {"state": {i: merged[n][2] for i, n in enumerate(trainable)
                                        if merged[n][2] is not None},
                              "param_groups": [dict(groups[0], params=list(range(len(trainable))))]}}

    def _load_placed(self, payload: dict) -> None:
        pl = self.placement
        with torch.no_grad():
            for name, p in self.params.items():
                p.copy_(pl.part(name, payload["params"][name], p))
                self.ema[name].copy_(pl.part(name, payload["ema_params"][name], self.ema[name]))
        opt_state = payload["opt_state"]
        index = {n: i for i, n in enumerate(self._trainable(self.full_names))}
        mine = self._trainable(self.params)
        state = {}
        for j, name in enumerate(mine):
            st = opt_state["state"].get(index[name])
            if st is not None:
                state[j] = {k: pl.part(name, v, self.params[name])
                            if torch.is_tensor(v) and v.dim() else v for k, v in st.items()}
        groups = [dict(opt_state["param_groups"][0], params=list(range(len(mine))))]
        self.optimizer.load_state_dict(dict(state=state, param_groups=groups))
        self.step = int(payload["step"])

    def load_state_dict(self, payload: dict) -> None:
        if self.placement is not None:
            return self._load_placed(payload)
        opt_state = payload["opt_state"]
        with torch.no_grad():
            for name, p in self.params.items():
                for dst, src in ((p, payload["params"][name]),
                                 (self.ema[name], payload["ema_params"][name])):
                    dst.copy_(shard_like(src, dst) if is_sharded(dst) else src)
        if self.sharded:  # each moment as its parameter is laid out
            trainable = [p for g in self.optimizer.param_groups for p in g["params"]]
            opt_state = dict(opt_state, state={
                i: {k: shard_like(v, trainable[i]) if torch.is_tensor(v) and v.dim() else v
                    for k, v in st.items()}
                for i, st in opt_state["state"].items()})
        self.optimizer.load_state_dict(opt_state)
        self.step = int(payload["step"])

