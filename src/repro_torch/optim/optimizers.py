"""Optimizers as pure transforms on parameter dicts.

``make_optimizer(cfg)`` -> (init_fn, update_fn):
    state = init_fn(params)
    new_params, new_state = update_fn(params, grads, state)

The port carries ``sgd`` and ``sgdm``, with the reference's arithmetic
(``repro.optim.optimizers``).  Parameters may be a stack of B models (the
clients a shard trains together); gradient clipping then takes each model's
own global norm, as the reference's per-client vmap does.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import torch

from repro_torch.configs.base import OptimizerConfig


class OptState(NamedTuple):
    step: int
    mu: Any          # momentum; None for sgd


def _clip_by_global_norm(grads: dict, max_norm: float, stacked: bool):
    if not max_norm:
        return grads
    if stacked:
        b = next(iter(grads.values())).shape[0]
        sq = sum(torch.sum(torch.square(g.float().reshape(b, -1)), dim=1)
                 for g in grads.values())
    else:
        sq = sum(torch.sum(torch.square(g.float())) for g in grads.values())
    scale = torch.clamp(max_norm / torch.clamp_min(torch.sqrt(sq), 1e-12),
                        max=1.0)

    def clip(g):
        s = scale.reshape((-1,) + (1,) * (g.dim() - 1)) if stacked else scale
        return (g.float() * s).to(g.dtype)
    return {k: clip(g) for k, g in grads.items()}


def make_optimizer(cfg: OptimizerConfig, stacked: bool = True
                   ) -> Tuple[Callable, Callable]:
    name = cfg.name
    if name not in ("sgd", "sgdm"):
        raise NotImplementedError(
            f"optimizer {name!r} is not ported yet; the port has sgd and sgdm")

    def init_fn(params) -> OptState:
        if name == "sgd":
            return OptState(0, None)
        return OptState(0, {k: torch.zeros_like(p, dtype=torch.float32)
                            for k, p in params.items()})

    def update_fn(params, grads, state: OptState):
        grads = _clip_by_global_norm(grads, cfg.grad_clip, stacked)
        step = state.step + 1
        if name == "sgd":
            new = {k: p - cfg.lr * grads[k].to(p.dtype)
                   for k, p in params.items()}
            return new, OptState(step, None)
        mu = {k: (cfg.momentum * m.float() + grads[k].float()).to(m.dtype)
              for k, m in state.mu.items()}
        new = {k: p - cfg.lr * mu[k].to(p.dtype) for k, p in params.items()}
        return new, OptState(step, mu)

    return init_fn, update_fn
