"""Production training steps on one card (``repro.launch.train``): one
per-shard FedAvg round with a server optimizer, the centralized step and
the calibration round (eq. 3).

``make_fedavg_step`` is the paper's per-shard learning unit at production
scale.  The clients run client-serially, one after another, never stacked,
so one client's copy of the parameters lives at a time: each client takes
``fl.fl_local_steps`` SGD steps at ``LOCAL_LR`` from the same parameters
(fp32 arithmetic, cast back to the param dtype), and its delta joins the
mean, ``acc += delta / n_clients`` in client order.  The server optimizer
(FedOpt) applies the pseudo-gradient ``-acc`` through
``make_optimizer(opt, stacked=False)``, its global-norm clip included.
``make_central_step`` is FR's and pretraining's step;
``make_calibration_step`` is eq. 3 at scale: each retained client runs
``max(int(L / r), 1)`` local steps and its delta is rescaled to its stored
historical norm before the mean.

The reference jits each step; the port runs it eagerly with the same
per-leaf association (``acc + d / n``, the clip, the SGD update), so that
the CPU parity holds at fp32 rounding.  The state is ``(params,
opt_state)``; the steps take no mesh-sharding context (the reference's
``ctx``), which one card has no counterpart for.  ``remat`` is
``loss_fn``'s: "block" (the default) recomputes each superblock in
backward.

Run as a module for a demonstration on a reduced config, on the card
unless ``--device cpu`` is given:
    python -m repro_torch.launch.train --arch olmo-1b --steps 4 [--device cpu]
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.configs.base import FLConfig, ModelConfig, OptimizerConfig
from repro_torch.core.tree import tree_leaves, tree_map, tree_replace_leaves
from repro_torch.core.unlearning import tree_norm
from repro_torch.models import loss_fn
from repro_torch.optim import make_optimizer

LOCAL_LR = 1e-2   # clients' local SGD step (FedAvg inner loop)


def _value_and_grad(lf, params, batch):
    """(loss, metrics, grads) of ``lf`` at ``params``: the gradient tree
    has the params' keys, a zero leaf where the loss does not reach."""
    q = tree_map(lambda v: v.detach().requires_grad_(True), params)
    loss, mets = lf(q, batch)
    grads = torch.autograd.grad(loss, tree_leaves(q), allow_unused=True,
                                materialize_grads=True)
    return (loss.detach(), {k: v.detach() for k, v in mets.items()},
            tree_replace_leaves(params, list(grads)))


def _client_round(lf, params, cbatch, local_steps: int):
    """One client: ``local_steps`` (at least one) SGD steps from
    ``params`` on its batch.  Returns (delta = new - params in the param
    dtype, the mean loss)."""
    if local_steps < 1:
        raise ValueError(f"local_steps {local_steps}: a client takes at "
                         f"least one step")
    p, losses = params, []
    for _ in range(local_steps):
        loss, _m, grads = _value_and_grad(lf, p, cbatch)
        gs = [g.float() for g in tree_leaves(grads)]
        del grads
        torch._foreach_mul_(gs, LOCAL_LR)
        new = [(w.float() - g).to(w.dtype)
               for w, g in zip(tree_leaves(p), gs)]
        del gs
        p = tree_replace_leaves(p, new)
        losses.append(loss)
    # p's leaves are this round's own tensors: the delta is taken in place
    delta = tree_map(lambda a, b: a.sub_(b.to(a.dtype)), p, params)
    return delta, torch.stack(losses).mean()


def _client_batch(batch, c: int):
    return {k: v[c] for k, v in batch.items()}


def make_fedavg_step(cfg: ModelConfig, fl: FLConfig, opt: OptimizerConfig,
                     remat: str = "block"):
    """Returns step(state, batch) -> (state, metrics).

    batch: {"tokens": (n_clients, bpc, S), ...}, the client-serial layout
    (``launch.inputs.train_batch_specs``); state: (params, opt_state);
    metrics: {"loss", "delta_norm"} (0-d tensors).
    """
    lf = loss_fn(cfg, remat=remat)
    _, opt_update = make_optimizer(opt, stacked=False)
    n_clients = fl.fl_clients_per_step
    local_steps = fl.fl_local_steps

    def step(state, batch):
        params, opt_state = state
        acc = tree_map(torch.zeros_like, params)
        losses = []
        for c in range(n_clients):
            delta, loss = _client_round(lf, params, _client_batch(batch, c),
                                        local_steps)
            for a, d in zip(tree_leaves(acc), tree_leaves(delta)):
                a.add_(d.to(a.dtype).div_(n_clients))
            del delta
            losses.append(loss)
        metrics = {"loss": torch.stack(losses).mean(),
                   "delta_norm": tree_norm(acc)}
        # server update (FedOpt): pseudo-gradient = -mean delta
        pseudo_grad = tree_map(torch.Tensor.neg_, acc)
        del acc
        new_params, new_opt = opt_update(params, pseudo_grad, opt_state)
        return (new_params, new_opt), metrics

    return step


def make_central_step(cfg: ModelConfig, opt: OptimizerConfig,
                      remat: str = "block"):
    """Plain training step (FR baseline / pretraining).  batch: {"tokens":
    (B, S), ...}; returns step(state, batch) -> (state, loss_fn's
    metrics)."""
    lf = loss_fn(cfg, remat=remat)
    _, opt_update = make_optimizer(opt, stacked=False)

    def step(state, batch):
        params, opt_state = state
        _loss, mets, grads = _value_and_grad(lf, params, batch)
        new_params, new_opt = opt_update(params, grads, opt_state)
        return (new_params, new_opt), mets

    return step


def make_calibration_step(cfg: ModelConfig, fl: FLConfig,
                          remat: str = "block"):
    """One production-scale calibrated retraining round (paper eq. 3).

    step(params, batch, stored_norms) -> (params, {"loss"}).  batch is
    client-serial; stored_norms: (n_clients,) historical ||delta||
    (retrieved through the coded store).  Retained clients run L/r local
    steps; each client's delta is rescaled to its historical norm, then
    averaged, and the mean is added to the parameters.
    """
    lf = loss_fn(cfg, remat=remat)
    n_clients = fl.fl_clients_per_step
    local_steps = max(int(fl.fl_local_steps / fl.retrain_ratio), 1)

    def step(params, batch, stored_norms):
        acc = tree_map(torch.zeros_like, params)
        losses = []
        for c in range(n_clients):
            delta, loss = _client_round(lf, params, _client_batch(batch, c),
                                        local_steps)
            ratio = stored_norms[c].float() / torch.clamp_min(
                tree_norm(delta), 1e-12)
            for a, d in zip(tree_leaves(acc), tree_leaves(delta)):
                a.add_(d.float().mul_(ratio).div_(n_clients).to(a.dtype))
            del delta
            losses.append(loss)
        new_params = tree_map(lambda p, a: p + a.to(p.dtype), params, acc)
        return new_params, {"loss": torch.stack(losses).mean()}

    return step


# ---------------------------------------------------------------------------
# Demo on a reduced config
# ---------------------------------------------------------------------------

def demo_batch(cfg: ModelConfig, rng, n_clients: int, bpc: int, seq: int,
               device) -> dict:
    """A client-serial batch drawn from the numpy generator ``rng`` (the
    reference demo's draw): tokens as their own labels, zero patches or
    frames (64 of them) where the family reads them."""
    import numpy as np
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                         (n_clients, bpc, seq))
                            .astype(np.int32)).to(device)
    batch = {"tokens": toks, "labels": toks}
    if cfg.family == "vlm":
        batch["patches"] = torch.zeros((n_clients, bpc, cfg.vision_tokens,
                                        cfg.d_model), device=device)
    if cfg.family == "audio":
        batch["frames"] = torch.zeros((n_clients, bpc, 64, cfg.d_model),
                                      device=device)
    return batch


def _demo(argv=None, init_fn=None) -> Tuple[list, list]:
    """The reference's demo with its flags, plus ``--device`` (the card by
    default).  ``init_fn(cfg)``, when given, returns the initial parameter
    tree (moved to the device), e.g. the reference's weights through
    ``from_numpy_params``; else ``init_params(cfg, 0)``.  Returns each
    round's (loss, delta_norm) as floats."""
    import argparse

    import numpy as np

    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.kernels import resolve_device
    from repro_torch.models import init_params
    from repro_torch.optim import init_optimizer

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--clients", type=int, default=2)
    ap.add_argument("--local-steps", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = reduce_for_smoke(get_config(args.arch))
    dev = resolve_device(args.device)
    fl = FLConfig(fl_clients_per_step=args.clients,
                  fl_local_steps=args.local_steps)
    opt = OptimizerConfig(name="adamw", lr=1e-3)
    params = (tree_map(lambda v: v.to(dev), init_fn(cfg)) if init_fn
              else init_params(cfg, 0, device=dev))
    state = (params, init_optimizer(opt, params))
    step = make_fedavg_step(cfg, fl, opt)
    rng = np.random.default_rng(0)
    losses, norms = [], []
    for i in range(args.steps):
        batch = demo_batch(cfg, rng, args.clients, 2, 64, dev)
        state, mets = step(state, batch)
        losses.append(float(mets["loss"]))
        norms.append(float(mets["delta_norm"]))
        print(f"fedavg round {i}: loss={losses[-1]:.4f} "
              f"delta={norms[-1]:.4f}")
    return losses, norms


if __name__ == "__main__":
    _demo()
