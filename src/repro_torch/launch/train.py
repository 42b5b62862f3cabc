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
opt_state)``.  ``remat`` is ``loss_fn``'s: "block" (the default)
recomputes each superblock in backward.

``ctx`` (``models.ShardCtx``) runs a step sharded over a device mesh: the
params, optimizer state and batch are DTensors laid out by
``launch.shardings`` (``distribute_tree``), the loss runs under the
context's constraints, each gradient is reduced to its parameter's
placements, and the client-serial loop carries DTensor deltas.  Every
rank runs the same step on its shards; the metrics are replicated 0-d
DTensors.

Run as a module for a demonstration on a reduced config, on the card
unless ``--device cpu`` is given; ``--mesh DxM`` runs it over D * M ranks
(NCCL, one card a rank, or gloo with ``--device cpu``) with the published
config's training rules:
    python -m repro_torch.launch.train --arch olmo-1b --steps 4 [--device cpu]
    python -m repro_torch.launch.train --arch rwkv6-3b --mesh 2x2 --device cpu
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.configs.base import FLConfig, ModelConfig, OptimizerConfig
from repro_torch.core.tree import (leaves_with_paths, tree_leaves, tree_map,
                                   tree_replace_leaves)
from repro_torch.core.unlearning import tree_norm
from repro_torch.models import NULL_CTX, ShardCtx, loss_fn
from repro_torch.optim import make_optimizer
from repro_torch.optim.optimizers import like_params

LOCAL_LR = 1e-2   # clients' local SGD step (FedAvg inner loop)


def _value_and_grad(lf, params, batch, ctx: ShardCtx = NULL_CTX):
    """(loss, metrics, grads) of ``lf`` at ``params``: the gradient tree
    has the params' keys, a zero leaf where the loss does not reach, each
    leaf laid out as its parameter is."""
    q = tree_map(lambda v: v.detach().requires_grad_(True), params)
    with ctx.scope():
        loss, mets = lf(q, batch)
        grads = torch.autograd.grad(loss, tree_leaves(q), allow_unused=True,
                                    materialize_grads=True)
    return (loss.detach(), {k: v.detach() for k, v in mets.items()},
            like_params(params, tree_replace_leaves(params, list(grads))))


def _client_round(lf, params, cbatch, local_steps: int,
                  ctx: ShardCtx = NULL_CTX):
    """One client: ``local_steps`` (at least one) SGD steps from
    ``params`` on its batch.  Returns (delta = new - params in the param
    dtype, the mean loss)."""
    if local_steps < 1:
        raise ValueError(f"local_steps {local_steps}: a client takes at "
                         f"least one step")
    p, losses = params, []
    for _ in range(local_steps):
        loss, _m, grads = _value_and_grad(lf, p, cbatch, ctx)
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


def _in_scope(step, ctx: ShardCtx):
    """``step`` run under ``ctx.scope()`` (plain tensors such as the
    stored norms meet the DTensors as replicated values)."""
    def run(*args):
        with ctx.scope():
            return step(*args)
    return run


def _client_batch(batch, c: int):
    return {k: v[c] for k, v in batch.items()}


def make_fedavg_step(cfg: ModelConfig, fl: FLConfig, opt: OptimizerConfig,
                     ctx: ShardCtx = NULL_CTX, remat: str = "block"):
    """Returns step(state, batch) -> (state, metrics).

    batch: {"tokens": (n_clients, bpc, S), ...}, the client-serial layout
    (``launch.inputs.train_batch_specs``); state: (params, opt_state);
    metrics: {"loss", "delta_norm"} (0-d tensors).
    """
    lf = loss_fn(cfg, remat=remat, ctx=ctx)
    _, opt_update = make_optimizer(opt, stacked=False)
    n_clients = fl.fl_clients_per_step
    local_steps = fl.fl_local_steps

    def step(state, batch):
        params, opt_state = state
        acc = tree_map(torch.zeros_like, params)
        losses = []
        for c in range(n_clients):
            delta, loss = _client_round(lf, params, _client_batch(batch, c),
                                        local_steps, ctx)
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

    return _in_scope(step, ctx)


def make_central_step(cfg: ModelConfig, opt: OptimizerConfig,
                      ctx: ShardCtx = NULL_CTX, remat: str = "block"):
    """Plain training step (FR baseline / pretraining).  batch: {"tokens":
    (B, S), ...}; returns step(state, batch) -> (state, loss_fn's
    metrics)."""
    lf = loss_fn(cfg, remat=remat, ctx=ctx)
    _, opt_update = make_optimizer(opt, stacked=False)

    def step(state, batch):
        params, opt_state = state
        _loss, mets, grads = _value_and_grad(lf, params, batch, ctx)
        new_params, new_opt = opt_update(params, grads, opt_state)
        return (new_params, new_opt), mets

    return _in_scope(step, ctx)


def make_calibration_step(cfg: ModelConfig, fl: FLConfig,
                          ctx: ShardCtx = NULL_CTX, remat: str = "block"):
    """One production-scale calibrated retraining round (paper eq. 3).

    step(params, batch, stored_norms) -> (params, {"loss"}).  batch is
    client-serial; stored_norms: (n_clients,) historical ||delta||
    (retrieved through the coded store).  Retained clients run L/r local
    steps; each client's delta is rescaled to its historical norm, then
    averaged, and the mean is added to the parameters.
    """
    lf = loss_fn(cfg, remat=remat, ctx=ctx)
    n_clients = fl.fl_clients_per_step
    local_steps = max(int(fl.fl_local_steps / fl.retrain_ratio), 1)

    def step(params, batch, stored_norms):
        acc = tree_map(torch.zeros_like, params)
        losses = []
        for c in range(n_clients):
            delta, loss = _client_round(lf, params, _client_batch(batch, c),
                                        local_steps, ctx)
            ratio = stored_norms[c].float() / torch.clamp_min(
                tree_norm(delta), 1e-12)
            for a, d in zip(tree_leaves(acc), tree_leaves(delta)):
                a.add_(d.float().mul_(ratio).div_(n_clients).to(a.dtype))
            del delta
            losses.append(loss)
        new_params = tree_map(lambda p, a: p + a.to(p.dtype), params, acc)
        return new_params, {"loss": torch.stack(losses).mean()}

    return _in_scope(step, ctx)


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
    default) and ``--mesh DxM``.  ``init_fn(cfg)``, when given, returns the
    initial parameter tree (moved to the device), e.g. the reference's
    weights through ``from_numpy_params``; else ``init_params(cfg, 0)``.
    With ``--mesh``, the step runs over a (data, model) mesh of D * M
    ranks under the published config's training rules (``param_rules``
    with its FSDP choice, ``act_rules``): inside a running world of that
    size, or else in D * M processes started here (``launch.mesh.spawn``;
    ``init_fn`` must then pickle).  Returns each round's (loss,
    delta_norm) as floats."""
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
    ap.add_argument("--mesh", default=None,
                    help="DxM: run over a (data, model) mesh of D*M ranks")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    if args.mesh and not torch.distributed.is_initialized():
        from repro_torch.launch.mesh import BACKENDS, parse_mesh, spawn
        ms = parse_mesh(args.mesh)
        return spawn(_demo_rank, int(np.prod(ms.shape)), BACKENDS[dev.type],
                     argv, init_fn)

    cfg = reduce_for_smoke(get_config(args.arch))
    fl = FLConfig(fl_clients_per_step=args.clients,
                  fl_local_steps=args.local_steps)
    opt = OptimizerConfig(name="adamw", lr=1e-3)
    params = (tree_map(lambda v: v.to(dev), init_fn(cfg)) if init_fn
              else init_params(cfg, 0, device=dev))
    state = (params, init_optimizer(opt, params))
    ctx, place = NULL_CTX, None
    if args.mesh:
        ctx, place = mesh_context(get_config(args.arch), args.mesh, dev)
        state = place(state, cfg)
    step = make_fedavg_step(cfg, fl, opt, ctx)
    rng = np.random.default_rng(0)
    losses, norms = [], []
    for i in range(args.steps):
        batch = demo_batch(cfg, rng, args.clients, 2, 64, dev)
        if place:
            batch = place(batch, cfg, batch=True)
        state, mets = step(state, batch)
        losses.append(float(_whole(mets["loss"])))
        norms.append(float(_whole(mets["delta_norm"])))
        if not torch.distributed.is_initialized() or \
                torch.distributed.get_rank() == 0:
            print(f"fedavg round {i}: loss={losses[-1]:.4f} "
                  f"delta={norms[-1]:.4f}")
    return losses, norms


def _whole(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _demo_rank(rank, world_size, argv, init_fn):
    return _demo(argv, init_fn)


def mesh_context(published: ModelConfig, mesh_spec, device,
                 kind: str = "train", strategy: str = "tp"):
    """(ctx, place) for a step of ``kind`` ("train", "prefill" or
    "decode") under ``strategy`` ("tp" or "seq_parallel") over a (data,
    model) mesh: ``mesh_spec`` "DxM" of the running world, or a
    ``DeviceMesh`` already made.  ``ctx`` carries the activation rules of
    ``published`` (the config as the reference ships it, which decides
    FSDP), ``place(tree, cfg, batch=False)`` lays out, by the same policy
    on a config ``cfg`` (the published one, or cut to size), a (params,
    opt_state) pair, a params tree alone (a dict), or with ``batch`` a
    batch (client-serial unless ``client_leading=False``)."""
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.launch import shardings as sh
    from repro_torch.launch.mesh import make_debug_mesh, parse_mesh
    from repro_torch.optim import OptState
    if isinstance(mesh_spec, DeviceMesh):
        mesh = mesh_spec
    else:
        d, m = parse_mesh(mesh_spec).shape
        mesh = make_debug_mesh(d, m, device_type=torch.device(device).type)
    prules = sh.param_rules(published, kind, False, strategy)
    arules = sh.act_rules(published, kind, False, strategy)
    ctx = ShardCtx(mesh, arules)

    def place(tree, cfg, batch=False, client_leading=True):
        if batch:
            return sh.distribute_tree(tree, sh.batch_shardings(
                tree, mesh, arules, client_leading=client_leading), mesh)
        psh = sh.param_shardings(cfg, mesh, prules)
        if isinstance(tree, dict):
            return sh.distribute_tree(tree, psh, mesh)
        params, opt_state = tree
        osh = sh.opt_state_shardings(opt_state, psh, mesh)
        moments = [None if t is None else sh.distribute_tree(t, s, mesh)
                   for t, s in ((opt_state.mu, osh.mu),
                                (opt_state.nu, osh.nu))]
        return (sh.distribute_tree(params, psh, mesh),
                OptState(opt_state.step, *moments))
    return ctx, place


def steps_on_mesh(rank: int, world_size: int, arch: str, mesh_spec: str,
                  weights, batch, stored_norms, fl: FLConfig,
                  fedavg_opt: OptimizerConfig, central_opt: OptimizerConfig,
                  device=None, changes: Optional[dict] = None) -> dict:
    """The three steps run sharded on this rank of a (data, model) mesh
    ``mesh_spec``, for checks against the unsharded steps: the config is
    ``reduce_for_smoke(get_config(arch))`` under the published config's
    training rules (``mesh_context``), ``weights`` and ``batch`` numpy
    trees (the batch client-serial; the central step takes client 0's),
    ``stored_norms`` the calibration's (n_clients,) norms.  Returns, as
    numpy on every rank: per step its new params (gathered), moments and
    metrics, and ``spec`` (each param leaf's mesh dims, "/"-joined path ->
    list of dim names it shards over).  ``device`` is the card unless the
    caller passes ``"cpu"``; ``changes`` change the reduced config (e.g.
    its numerics back to the published bf16, with bf16 ``weights``).  Run
    it through ``launch.mesh.spawn``."""
    import numpy as np

    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.kernels import resolve_device
    from repro_torch.models import from_numpy_params, to_numpy_params
    from repro_torch.optim import init_optimizer

    device = resolve_device(device)
    cfg = dataclasses.replace(reduce_for_smoke(get_config(arch)),
                              **(changes or {}))
    ctx, place = mesh_context(get_config(arch), mesh_spec, device)
    mesh = ctx.mesh
    tb = {k: torch.from_numpy(np.asarray(v)).to(device)
          for k, v in batch.items()}
    sb = place(tb, cfg, batch=True)

    def params():
        return from_numpy_params(weights, device=device)

    def moments(st):
        return {k: None if t is None else to_numpy_params(t)
                for k, t in (("mu", st.mu), ("nu", st.nu))}

    def mets(m):
        return {k: float(_whole(v)) for k, v in m.items()}

    out = {}
    p0 = params()
    state = place((p0, init_optimizer(fedavg_opt, p0)), cfg)
    names = mesh.mesh_dim_names
    out["spec"] = {"/".join(path): sorted({names[i] for i, pl in
                                           enumerate(t.placements)
                                           if pl.is_shard()})
                   for path, t in leaves_with_paths(state[0])}
    (new, st), m = make_fedavg_step(cfg, fl, fedavg_opt, ctx)(state, sb)
    out["fedavg"] = (to_numpy_params(new), moments(st), mets(m))
    p0 = params()
    state = place((p0, init_optimizer(central_opt, p0)), cfg)
    cb = place({k: v[0] for k, v in tb.items()}, cfg, batch=True,
               client_leading=False)
    (new, st), m = make_central_step(cfg, central_opt, ctx)(state, cb)
    out["central"] = (to_numpy_params(new), moments(st), mets(m))
    pp, _ = place((params(), init_optimizer(central_opt, params())), cfg)
    norms = torch.from_numpy(np.asarray(stored_norms)).to(device)
    new, m = make_calibration_step(cfg, fl, ctx)(pp, sb, norms)
    out["calibration"] = (to_numpy_params(new), {}, mets(m))
    return out


if __name__ == "__main__":
    _demo()
