"""Diagonal empirical Fisher information (RapidRetrain's accelerator), on
parameter trees of tensors (``repro.optim.fisher`` on torch).

RapidRetrain [Liu et al. 2022] expedites retraining with a diagonal empirical
FIM second-order update: g_precond = g / (F_diag + lambda).  F_diag is the
running mean of squared per-batch gradients, in fp32, with the reference's
arithmetic in the same order.  Gradients may be a stack of B models' (B, ...)
leaves; one unstacked Fisher then broadcasts over B, as the reference's
per-client vmap with an unmapped Fisher does.
"""
from __future__ import annotations

import torch

from repro_torch.core.tree import tree_leaves, tree_map, tree_replace_leaves


def diag_fisher(fisher, grads, count: int):
    """Online mean of squared gradients.  fisher=None initialises."""
    sq = tree_map(lambda g: torch.square(g.float()), grads)
    if fisher is None:
        return sq
    t = float(count)
    return tree_map(lambda f, s: f + (s - f) / (t + 1.0), fisher, sq)


def fisher_precondition(grads, fisher, damping: float = 1e-3):
    """g / (F + lambda) — the diagonal natural-gradient step, cast back to
    the gradient's dtype.  One multi-tensor op over every leaf."""
    if fisher is None:
        return grads
    gs = tree_leaves(grads)
    out = torch._foreach_div([g.float() for g in gs],
                             torch._foreach_add(tree_leaves(fisher), damping))
    return tree_replace_leaves(grads, [o.to(g.dtype) for o, g in zip(out, gs)])
