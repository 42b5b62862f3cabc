"""SE (Sharding Eraser) unlearning engine: preparation (eq. 2) and calibrated
retraining (eq. 3), on parameter trees of tensors.

The algebraic operations only, in both of the reference's forms: the list
form (``calibrate``, ``remove_client_effect``) over one tree per client,
and the stacked form (``calibrate_stacked``) over a (M, ...) stack, which
the FL loop in ``repro_torch.fl.simulator`` drives.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core import coding
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.kernels.calibrate.ops import calibrate_update


def tree_mean(trees: Sequence):
    """Average a list of trees — eq. (2)'s aggregation."""
    n = float(len(trees))
    return tree_map(lambda *xs: sum(x.float() for x in xs) / n, *trees)


def tree_add(a, b, scale: float = 1.0):
    return tree_map(lambda x, y: x + scale * y.to(x.dtype), a, b)


def tree_sub(a, b):
    return tree_map(lambda x, y: x - y.to(x.dtype), a, b)


def tree_norm(tree) -> torch.Tensor:
    """Global L2 norm of a tree (f32 accumulate)."""
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float()))
                          for leaf in tree_leaves(tree)))


def tree_scale(tree, s):
    return tree_map(lambda x: (x.float() * s).to(x.dtype), tree)


def stacked_mean(stacked, dim: int = 0) -> object:
    """FedAvg over the ``dim`` axis of a stacked tree: a strict left fold
    over the rows (row 0, + row 1, + row 2, ...) divided by their count, the
    association of ``tree_mean``'s Python ``sum`` — so the round engines
    agree with one another bit for bit."""
    def mean_leaf(a):
        a = a.float()
        acc = a.select(dim, 0)
        for i in range(1, a.shape[dim]):
            acc = acc + a.select(dim, i)
        return acc / a.shape[dim]
    return tree_map(mean_leaf, stacked)


def stacked_norms(stacked) -> torch.Tensor:
    """(M,) global L2 norms of the rows of a stacked (M, ...) tree."""
    leaves = tree_leaves(stacked)
    m = leaves[0].shape[0]
    sq = sum(torch.sum(torch.square(leaf.float().reshape(m, -1)), dim=1)
             for leaf in leaves)
    return torch.sqrt(sq)


def stacked_sub(stacked, base):
    """Row-wise ``stacked - base`` (``base`` broadcasts over the rows)."""
    return tree_map(lambda a, b: a.float() - b.float(), stacked, base)


def calibrate_stacked(global_model, stacked_deltas,
                      stored_norms: torch.Tensor, eps: float = 1e-12):
    """eq. (3) on a stacked (M, ...) delta tree:

        w <- w + sum_m (||old_m|| / ||new_m|| / M) * new_m

    ``stored_norms``: (M,) historical update norms.  The accumulate runs on
    the flattened (M, P) delta matrix through ``calibrate_update`` — the
    CUDA kernel for tensors on the card, its plain version on the CPU.
    """
    m = tree_leaves(stacked_deltas)[0].shape[0]
    new_norms = stacked_norms(stacked_deltas)
    coeffs = (stored_norms.float() / torch.clamp_min(new_norms, eps)) / m
    wf, spec = coding.tree_to_flat(global_model)
    df, _ = coding.tree_to_flat_stacked(stacked_deltas)
    return coding.flat_to_tree(calibrate_update(wf, df, coeffs.contiguous()),
                               spec)


def prepare_initial_model(retained_locals: Sequence) -> object:
    """eq. (2): the initial unlearned global model is the average of the
    retained clients' stored local models."""
    if not retained_locals:
        raise ValueError("no retained clients in shard")
    return tree_mean(retained_locals)


def calibrate(global_model, retrained_deltas: Sequence,
              stored_deltas: Sequence, eps: float = 1e-12):
    """eq. (3): one calibrated-retraining aggregation round.

        w^{g'+1} = w^{g'} + (1/M) * sum_m  (||w^g_m|| / ||w'^{g'}_m||) w'^{g'}_m

    ``retrained_deltas``: the retained clients' *new* local updates at
    unlearning round g'; ``stored_deltas``: the same clients' *historical*
    updates at the matching learning round g = g' — only their norms are
    used.  Client by client in list order, as the reference adds them, so
    fp32 sums associate alike."""
    if len(retrained_deltas) != len(stored_deltas):
        raise ValueError(f"{len(retrained_deltas)} retrained deltas but "
                         f"{len(stored_deltas)} stored ones")
    m = len(retrained_deltas)
    out = global_model
    for new, old in zip(retrained_deltas, stored_deltas):
        ratio = tree_norm(old) / torch.clamp_min(tree_norm(new), eps)
        out = tree_add(out, tree_scale(new, ratio / m))
    return out


def remove_client_effect(all_locals: dict,
                         unlearn_clients: Sequence[int]) -> dict:
    """Preparation step: drop the unlearning clients' stored parameters from a
    {client_id: tree} mapping (w^g_{s_i} = w^g_{C_si} - w^g_{C'_si})."""
    gone = set(unlearn_clients)
    return {c: p for c, p in all_locals.items() if c not in gone}
