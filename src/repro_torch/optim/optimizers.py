# Port of repro/optim/optimizers.py: rmsprop and constant_schedule.
"""Optimizers (pure transforms over parameter dicts, init/update pairs).

``rmsprop`` matches the paper's LSTM experiment (§5: a manual RMSProp).
AdamW, SGD, the cosine schedule and clipping come with the launchers
(ROADMAP queue 1, item 14).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import torch
from torch.utils import _pytree as pytree

Params = Any
tmap = pytree.tree_map


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Params], Any]
    update: Callable[[Params, Any, Params, int], Tuple[Params, Any]]
    # update(grads, state, params, step) -> (new_params, new_state)


def constant_schedule(lr: float) -> Callable:
    return lambda step: lr


def rmsprop(lr: Callable | float = 1e-3, *, decay: float = 0.9,
            eps: float = 1e-8) -> Optimizer:
    """The paper's §5 optimizer (manual RMSProp in its LSTM test case)."""
    sched = lr if callable(lr) else constant_schedule(lr)

    def init(params):
        return {"sq": tmap(lambda p: torch.zeros_like(p, dtype=torch.float32),
                           params)}

    def update(grads, state, params, step):
        g32 = tmap(lambda g: g.to(torch.float32), grads)
        sq = tmap(lambda s, g: decay * s + (1 - decay) * g * g,
                  state["sq"], g32)
        lr_t = float(sched(step))
        new_params = tmap(
            lambda p, g, s: (p.to(torch.float32) -
                             lr_t * g / (torch.sqrt(s) + eps)).to(p.dtype),
            params, g32, sq)
        return new_params, {"sq": sq}

    return Optimizer(init=init, update=update)
