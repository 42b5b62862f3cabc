"""Optimizers as pure transforms on parameter trees.

``make_optimizer(cfg)`` -> (init_fn, update_fn):
    state = init_fn(params)
    new_params, new_state = update_fn(params, grads, state)

Supported, with the reference's arithmetic (``repro.optim.optimizers``):
sgd, sgdm, adamw (fp32 moments) and adamw_bf16 (bf16 moments, rounded to
nearest even as ``jnp.bfloat16`` is).  Parameters may be a stack of B models
(the clients a shard trains together); gradient clipping then takes each
model's own global norm, as the reference's per-client vmap does.

Parameters may be DTensors on a device mesh (``launch.shardings``): each
gradient is first laid out as its parameter is (a ``Partial`` sum reduced
to the parameter's shards), the multi-tensor updates then run shard by
shard, and the clip's global norm sums every shard.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import OptimizerConfig
from repro_torch.core.tree import (tree_leaves, tree_map,
                                   tree_replace_leaves)


class OptState(NamedTuple):
    step: int
    mu: Any          # first moment (or momentum); None for sgd
    nu: Any = None   # second moment; None for sgd / sgdm


def like_params(params, grads):
    """Each DTensor gradient redistributed to its parameter's placements
    (plain gradients as they are)."""
    def one(p, g):
        if isinstance(g, DTensor) and tuple(g.placements) != tuple(
                p.placements):
            return g.redistribute(p.device_mesh, p.placements)
        return g
    return tree_map(one, params, grads)


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
    if name not in ("sgd", "sgdm", "adamw", "adamw_bf16"):
        raise ValueError(f"unknown optimizer {name!r}")
    mom_dtype = torch.bfloat16 if name == "adamw_bf16" else torch.float32

    def init_fn(params) -> OptState:
        def zeros():
            return tree_map(lambda p: torch.zeros_like(p, dtype=mom_dtype),
                            params)
        if name == "sgd":
            return OptState(0, None)
        if name == "sgdm":
            return OptState(0, zeros())
        return OptState(0, zeros(), zeros())

    def update_fn(params, grads, state: OptState):
        grads = _clip_by_global_norm(like_params(params, grads),
                                     cfg.grad_clip, stacked)
        step = state.step + 1
        if name in ("adamw", "adamw_bf16"):
            return _adamw(cfg, params, grads, state, step)
        # one multi-tensor op per update over every leaf, in tree order
        ps = tree_leaves(params)
        gs = [g.to(p.dtype) for p, g in zip(ps, tree_leaves(grads))]
        if name == "sgd":
            new = torch._foreach_sub(ps, _times_lr(gs, cfg.lr))
            return tree_replace_leaves(params, new), OptState(step, None)
        mus = torch._foreach_add(
            torch._foreach_mul(tree_leaves(state.mu), cfg.momentum), gs)
        new = torch._foreach_sub(ps, _times_lr(
            [m.to(p.dtype) for m, p in zip(mus, ps)], cfg.lr))
        return (tree_replace_leaves(params, new),
                OptState(step, tree_replace_leaves(state.mu, mus)))

    return init_fn, update_fn


def _times_lr(ts, lr: float):
    """lr * t for each leaf in the leaf's own dtype, as the reference's
    ``p - lr * g.astype(p.dtype)`` computes it: the Python ``lr`` is a
    weak-typed constant that JAX rounds to the leaf's dtype (bf16(0.01) =
    0.0100098), the product is rounded to that dtype, and so is the
    difference (two roundings; exact fp32 products of bf16 values)."""
    kinds = {t.dtype for t in ts}
    if len(kinds) == 1:
        return torch._foreach_mul(ts, float(torch.tensor(lr,
                                                         dtype=kinds.pop())))
    return [t * float(torch.tensor(lr, dtype=t.dtype)) for t in ts]


def _adamw(cfg: OptimizerConfig, params, grads, state: OptState, step: int):
    """The reference's adamw step: fp32 arithmetic, moments stored in their
    own dtype, bias corrections 1 - beta^t computed in fp32."""
    b1, b2 = cfg.beta1, cfg.beta2
    gs = [g.float() for g in tree_leaves(grads)]
    m0, v0 = tree_leaves(state.mu), tree_leaves(state.nu)
    mus = torch._foreach_add(torch._foreach_mul([m.float() for m in m0], b1),
                             torch._foreach_mul(gs, 1 - b1))
    nus = torch._foreach_add(torch._foreach_mul([v.float() for v in v0], b2),
                             torch._foreach_mul(torch._foreach_mul(gs, gs),
                                                1 - b2))
    mus = [m.to(o.dtype) for m, o in zip(mus, m0)]
    nus = [v.to(o.dtype) for v, o in zip(nus, v0)]
    t = torch.tensor(float(step), dtype=torch.float32)
    bc1 = float(1 - torch.tensor(b1, dtype=torch.float32) ** t)
    bc2 = float(1 - torch.tensor(b2, dtype=torch.float32) ** t)
    ps = tree_leaves(params)
    mhat = torch._foreach_div([m.float() for m in mus], bc1)
    vhat = torch._foreach_div([v.float() for v in nus], bc2)
    delta = torch._foreach_div(mhat, torch._foreach_add(
        torch._foreach_sqrt(vhat), cfg.eps))
    if cfg.weight_decay:
        delta = torch._foreach_add(
            delta, torch._foreach_mul([p.float() for p in ps],
                                      cfg.weight_decay))
    new = torch._foreach_sub([p.float() for p in ps],
                             torch._foreach_mul(delta, cfg.lr))
    new = [n.to(p.dtype) for n, p in zip(new, ps)]
    return (tree_replace_leaves(params, new),
            OptState(step, tree_replace_leaves(state.mu, mus),
                     tree_replace_leaves(state.nu, nus)))


def init_optimizer(cfg: OptimizerConfig, params) -> OptState:
    return make_optimizer(cfg)[0](params)
