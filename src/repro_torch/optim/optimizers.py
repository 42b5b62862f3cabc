"""Optimizers as pure transforms on parameter trees.

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
from repro_torch.core.tree import (tree_leaves, tree_map,
                                   tree_replace_leaves)


class OptState(NamedTuple):
    step: int
    mu: Any          # momentum; None for sgd


def _clip_by_global_norm(grads, max_norm: float, stacked: bool):
    if not max_norm:
        return grads
    leaves = tree_leaves(grads)
    if stacked:
        b = leaves[0].shape[0]
        sq = sum(torch.sum(torch.square(g.float().reshape(b, -1)), dim=1)
                 for g in leaves)
    else:
        sq = sum(torch.sum(torch.square(g.float())) for g in leaves)
    scale = torch.clamp(max_norm / torch.clamp_min(torch.sqrt(sq), 1e-12),
                        max=1.0)

    def clip(g):
        s = scale.reshape((-1,) + (1,) * (g.dim() - 1)) if stacked else scale
        return (g.float() * s).to(g.dtype)
    return tree_map(clip, grads)


def make_optimizer(cfg: OptimizerConfig, stacked: bool = True
                   ) -> Tuple[Callable, Callable]:
    name = cfg.name
    if name not in ("sgd", "sgdm"):
        raise NotImplementedError(
            f"optimizer {name!r} is not ported yet; the port has sgd and sgdm")

    def init_fn(params) -> OptState:
        if name == "sgd":
            return OptState(0, None)
        return OptState(0, tree_map(
            lambda p: torch.zeros_like(p, dtype=torch.float32), params))

    def update_fn(params, grads, state: OptState):
        grads = _clip_by_global_norm(grads, cfg.grad_clip, stacked)
        step = state.step + 1
        # one multi-tensor op per update over every leaf, in tree order
        ps = tree_leaves(params)
        gs = [g.to(p.dtype) for p, g in zip(ps, tree_leaves(grads))]
        if name == "sgd":
            new = torch._foreach_add(ps, gs, alpha=-cfg.lr)
            return tree_replace_leaves(params, new), OptState(step, None)
        mus = torch._foreach_add(
            torch._foreach_mul(tree_leaves(state.mu), cfg.momentum), gs)
        new = torch._foreach_add(ps, mus, alpha=-cfg.lr)
        return (tree_replace_leaves(params, new),
                OptState(step, tree_replace_leaves(state.mu, mus)))

    return init_fn, update_fn
