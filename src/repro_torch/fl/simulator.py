"""Federated learning + unlearning simulator (paper Sec 5), on torch.

Runs the paper's protocol on a registered task x model family: C clients, a
sampled subset per stage split into S isolated shards, FedAvg within
shards, intermediate-parameter storage (full / uncoded-shard / coded), and
the unlearning frameworks.  The simulator owns the client data, the batched
training / calibration steps and evaluation; orchestration lives in
``repro_torch.fl.experiment`` (``train_stage``, ``run_unlearn``,
``FederatedSession``), as in ``repro.fl.simulator``.

Batching.  Where the reference vmaps local training over the M clients of
a shard (and, on the stage engine, over the S shards), the port stacks the
models along one leading axis and runs the stack through one grouped
forward/backward (``models.cnn.cnn_forward_stacked``): the fused engine
trains a stack of M clients, the stage engine a stack of S*M.  Each
client's arithmetic is the same in both, so the engines agree.

Device.  The simulator runs on the CUDA card unless built with
``device="cpu"``; with no card and no ``device="cpu"`` it raises.  On the
card the coded store's encode and decode and the eq. 3 accumulate run
through the hand-written kernels; on the CPU through their plain versions.
"""
from __future__ import annotations

import json
import warnings
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import FLConfig, ModelConfig, OptimizerConfig
from repro_torch.core import coding, unlearning
from repro_torch.core.sharding import ShardManager, StagePlan
from repro_torch.core.tree import tree_leaves, tree_map, tree_replace_leaves
from repro_torch.fl.tasks import resolve_task
from repro_torch.kernels import resolve_device
from repro_torch.models import (init_params, predict_fn, stacked_loss_fn,
                                stacked_predict_fn)
from repro_torch.optim import make_optimizer
from repro_torch.optim.fisher import diag_fisher, fisher_precondition
from repro_torch.stores.store import StoreStats, make_store


def _broadcast(params, lead: Tuple[int, ...]):
    """Each leaf of a stacked (K, ...) tree repeated over new axes after K:
    (K, ...) -> (K*prod(lead), ...).  ``lead`` = (M,) turns K shard models
    into the K*M clients' starting models."""
    def rep(v):
        k0 = v.shape[0]
        shape = (k0, *lead, *v.shape[1:])
        return (v.float().reshape(k0, *(1,) * len(lead), *v.shape[1:])
                .expand(shape).reshape(-1, *v.shape[1:]).contiguous())
    return tree_map(rep, params)


def _stack(trees: Sequence):
    return tree_map(lambda *vs: torch.stack(vs), *trees)


def _row(tree, i: int):
    return tree_map(lambda v: v[i], tree)


def _lift(tree):
    """One model as a stack of one."""
    return tree_map(lambda v: v.unsqueeze(0), tree)


class StackedRoundGlobals:
    """List-like view of one shard's per-round global models, backed by the
    stage engine's per-round stacked ``(S, ...)`` inputs — length G+1 like
    the fused engine's lists, each element sliced out only on access."""

    def __init__(self, round_inputs: Sequence[dict], final: dict,
                 shard_index: int):
        self._inputs = round_inputs               # G stacked (S, ...) trees
        self._final = final                       # (S, ...) stacked tree
        self._idx = shard_index
        self._len = len(round_inputs) + 1

    def __len__(self) -> int:
        return self._len

    def __getitem__(self, g):
        if isinstance(g, slice):
            return [self[i] for i in range(*g.indices(self._len))]
        if g < 0:
            g += self._len
        if not 0 <= g < self._len:
            raise IndexError(g)
        if g == self._len - 1:
            return _row(self._final, self._idx)
        return _row(self._inputs[g], self._idx)

    def __iter__(self):
        return (self[i] for i in range(self._len))


@dataclass
class StageRecord:
    plan: StagePlan
    shard_models: Dict[int, object]               # final per-shard globals
    round_globals: Dict[int, object]              # shard -> [w^g inputs], G+1
    store: object                                 # parameter store
    history_norms: Dict[Tuple[int, int, int], float] = field(default_factory=dict)
    # (shard, round, client) -> ||delta|| of the stored update


@dataclass
class UnlearnResult:
    framework: str
    models: Dict[int, object]        # shard -> unlearned model (single: {0: w})
    wall_time: float
    cost_units: float                # client-epochs of retraining
    store_stats: Optional[StoreStats]
    impacted_shards: Sequence[int]
    request_id: str = ""

    def to_dict(self) -> dict:
        return {
            "request_id": self.request_id,
            "framework": self.framework,
            "wall_time_s": self.wall_time,
            "cost_units": self.cost_units,
            "impacted_shards": [int(s) for s in self.impacted_shards],
            "num_models": len(self.models),
            "store_stats": (self.store_stats.to_dict()
                            if self.store_stats is not None else None),
        }

    def to_json(self, **kw) -> str:
        kw.setdefault("indent", 2)
        return json.dumps(self.to_dict(), **kw)


def mean_logits(stacked_predict: Callable, make_batch: Callable,
                    stacked: dict, k: int, x: torch.Tensor,
                    y: torch.Tensor) -> torch.Tensor:
    """Mean fp32 logits of K models on one batch: the stacked (K, ...)
    models run as one stack over the batch repeated K times."""
    b = make_batch(x.unsqueeze(0).expand(k, *x.shape), y)
    return stacked_predict(stacked, b).float().sum(0) / k


@dataclass(frozen=True)
class PredictInterface:
    """The simulator's public evaluation surface.

    Everything an external evaluator (the MIA attack, canary probes,
    benchmarks) needs to score models without reaching into
    ``FLSimulator`` internals: ``predict(model, batch) -> logits`` for one
    model, ``stacked_predict(models, batch)`` for a (K, ...) stack of models
    on a batch with a leading K axis, the task's batch constructor, the
    ``TaskSpec`` itself (which owns metric and MIA-feature shapes) and the
    device the models live on.  Obtained via
    ``FLSimulator.predict_interface``.
    """
    predict: Callable
    make_batch: Callable
    task: object                       # the simulator's TaskSpec instance
    stacked_predict: Callable
    device: torch.device

    @torch.no_grad()
    def ensemble_logits(self, models: Dict[int, object], x, y):
        """Mean float32 logits of a model ensemble on one batch."""
        x = torch.as_tensor(np.asarray(x)).to(self.device)
        y = torch.as_tensor(np.asarray(y)).to(self.device)
        return mean_logits(self.stacked_predict, self.make_batch,
                           _stack(list(models.values())), len(models), x, y)


class FLSimulator:
    """``init_fn(salt) -> params``, when given, supplies every initial model
    the protocol draws: stage ``k``'s w0 (salt ``k``) and FR's restart
    (salt 777), where the reference draws
    ``init_params(cfg, jax.random.key(seed + salt))``.  Without it the port
    draws from a ``torch.Generator`` seeded ``seed + salt``."""

    def __init__(self, model_cfg: ModelConfig, fl_cfg: FLConfig,
                 client_data: Dict[int, Tuple[np.ndarray, np.ndarray]],
                 task, opt_cfg: Optional[OptimizerConfig] = None,
                 local_batch: int = 20, seed: int = 0, device=None,
                 init_fn: Optional[Callable[[int], dict]] = None):
        self.device = resolve_device(device)
        self.cfg = model_cfg
        self.fl = fl_cfg
        self.task_spec = resolve_task(task)
        self.task = self.task_spec.name
        self.opt = opt_cfg or OptimizerConfig(name="sgdm", lr=0.05,
                                              grad_clip=0.0)
        self.client_data = client_data
        self.local_batch = local_batch
        self.seed = seed
        self.init_fn = init_fn
        self.mgr = ShardManager(fl_cfg.num_clients, fl_cfg.num_shards,
                                fl_cfg.clients_per_round, seed)
        self._loss = stacked_loss_fn(model_cfg)
        self._pf = predict_fn(model_cfg)
        self._spf = stacked_predict_fn(model_cfg)
        self._opt_init, self._opt_update = make_optimizer(self.opt)

    # ------------------------------------------------------------ models
    def init_model(self, salt: int):
        if self.init_fn is not None:
            return tree_map(lambda v: v.to(self.device, torch.float32),
                            self.init_fn(salt))
        return init_params(self.cfg, self.seed + salt, self.device)

    def _stack_client_data(self, clients: Sequence[int]):
        """(M, n, ...) device tensors, every client cut to the smallest n."""
        n_min = min(self.client_data[c][0].shape[0] for c in clients)
        xs = np.stack([self.client_data[c][0][:n_min] for c in clients])
        ys = np.stack([self.client_data[c][1][:n_min] for c in clients])
        return (torch.from_numpy(xs).to(self.device),
                torch.from_numpy(ys).to(self.device))

    def _make_store(self, store_kind: str, plan: StagePlan,
                    group_rounds: int = 1, slice_dtype=None, **store_options):
        return make_store(store_kind, plan.shard_clients,
                          num_shards=self.fl.num_shards,
                          num_clients=self.fl.clients_per_round,
                          group_rounds=group_rounds, slice_dtype=slice_dtype,
                          **store_options)

    # --------------------------------------------------- deprecated shims
    def train_stage(self, store_kind: str = "coded",
                    rounds: Optional[int] = None, engine: str = "fused",
                    encode_group: Optional[int] = None,
                    slice_dtype=None) -> StageRecord:
        """Deprecated shim over ``repro_torch.fl.experiment.train_stage``."""
        warnings.warn(
            "FLSimulator.train_stage is deprecated; use "
            "repro_torch.fl.experiment.train_stage(sim, ...) or "
            "FederatedSession",
            DeprecationWarning, stacklevel=2)
        from repro_torch.fl.experiment.stage import train_stage
        return train_stage(self, store_kind=store_kind, rounds=rounds,
                           engine=engine, encode_group=encode_group,
                           slice_dtype=slice_dtype)

    def unlearn(self, framework: str, record: StageRecord,
                requests: Sequence[int], rounds: Optional[int] = None,
                available: Optional[Sequence[int]] = None,
                corrupt: Optional[np.ndarray] = None) -> UnlearnResult:
        """Deprecated shim over ``repro_torch.fl.experiment.run_unlearn``."""
        warnings.warn(
            "FLSimulator.unlearn is deprecated; use "
            "repro_torch.fl.experiment.run_unlearn(sim, ...) or "
            "FederatedSession",
            DeprecationWarning, stacklevel=2)
        from repro_torch.fl.experiment.frameworks import run_unlearn
        return run_unlearn(self, framework, record, requests, rounds=rounds,
                           available=available, corrupt=corrupt)

    # ------------------------------------------------------------ training
    def _grads(self, params, x: torch.Tensor, y: torch.Tensor):
        """Per-model gradients of a stack of B models, one backward pass."""
        with torch.enable_grad():
            leaves = tree_map(lambda v: v.detach().requires_grad_(True),
                              params)
            batch = self.task_spec.make_batch(x, y)
            loss = self._loss(leaves, batch).sum()
            grads = torch.autograd.grad(loss, tree_leaves(leaves))
        return tree_replace_leaves(leaves, grads)

    @torch.no_grad()
    def local_train(self, params: dict, xs: torch.Tensor, ys: torch.Tensor,
                    epochs: int, fisher=None) -> dict:
        """Minibatch SGD of a stack of B client models: params (B, ...),
        xs (B, n, ...).  Minibatches in the reference's order: the first
        ``n // bs * bs`` examples, consecutive, no shuffle.  With ``fisher``
        (one unstacked tree, RR's), each step's gradients are divided by
        F + 1e-3 before the optimizer (and its clip) sees them."""
        bs = self.local_batch
        nb = xs.shape[1] // bs
        state = self._opt_init(params)
        for _ in range(epochs):
            for i in range(nb):
                x = xs[:, i * bs:(i + 1) * bs]
                y = ys[:, i * bs:(i + 1) * bs]
                grads = self._grads(params, x, y)
                if fisher is not None:
                    grads = fisher_precondition(grads, fisher)
                params, state = self._opt_update(params, grads, state)
        return params

    @torch.no_grad()
    def shard_round(self, ws: dict, xs: torch.Tensor, ys: torch.Tensor,
                    epochs: int, payload: str):
        """One FedAvg round of K shards at once: ws (K, ...) shard globals,
        xs (K, M, n, ...).  Returns ``(new_ws (K, ...), out, norms (K, M))``
        where ``out`` is the (K, M, P) flat client matrix (``"flat"``) or
        the (K, M, ...) stacked client trees (``"stacked"``)."""
        k, m = xs.shape[:2]
        p0 = _broadcast(ws, (m,))
        locals_ = self.local_train(p0, xs.reshape(k * m, *xs.shape[2:]),
                                   ys.reshape(k * m, *ys.shape[2:]), epochs)
        deltas = unlearning.stacked_sub(locals_, p0)
        norms = unlearning.stacked_norms(deltas).reshape(k, m)
        grouped = tree_map(lambda v: v.reshape(k, m, *v.shape[1:]), locals_)
        new_ws = unlearning.stacked_mean(grouped, dim=1)
        if payload == "flat":
            out = coding.tree_to_flat_stacked(locals_)[0].reshape(k, m, -1)
        else:
            out = grouped
        return new_ws, out, norms

    @torch.no_grad()
    def calib_round(self, w: dict, xs: torch.Tensor, ys: torch.Tensor,
                    stored_norms: torch.Tensor, epochs: int) -> dict:
        """One SE/FE calibrated-retraining round (eq. 3) of one shard:
        stacked retraining of its M clients + the stacked calibration."""
        p0 = _broadcast(_lift(w), (xs.shape[0],))
        locals_ = self.local_train(p0, xs, ys, epochs)
        deltas = unlearning.stacked_sub(locals_, w)
        return unlearning.calibrate_stacked(w, deltas, stored_norms)

    @torch.no_grad()
    def calib_stage(self, ws: dict, xs: torch.Tensor, ys: torch.Tensor,
                    nmats: torch.Tensor, epochs: int) -> dict:
        """The calibrated-retraining pass of K shards together: each of the
        G' rounds retrains all K*M' clients as one stack, then calibrates
        each shard.  ws (K, ...); xs (K, M', n, ...); nmats (G', K, M')."""
        k, m = xs.shape[:2]
        xf = xs.reshape(k * m, *xs.shape[2:])
        yf = ys.reshape(k * m, *ys.shape[2:])
        for g in range(nmats.shape[0]):
            p0 = _broadcast(ws, (m,))
            locals_ = self.local_train(p0, xf, yf, epochs)
            deltas = unlearning.stacked_sub(locals_, p0)
            ws = _stack([unlearning.calibrate_stacked(
                _row(ws, i),
                tree_map(lambda v, i=i: v[i * m:(i + 1) * m], deltas),
                nmats[g, i]) for i in range(k)])
        return ws

    @torch.no_grad()
    def retrain_shards(self, w0: dict, xs: torch.Tensor, ys: torch.Tensor,
                       g_rounds: int) -> dict:
        """From-scratch FedAvg of K shards at once at the full L local
        epochs (the retrain oracle's pass, ``repro_torch.verify.oracle``):
        every shard starts from the one model ``w0`` and runs ``g_rounds``
        of ``shard_round``; xs (K, M, n, ...).  Returns only the final
        (K, ...) shard models."""
        ws = _broadcast(_lift(w0), (xs.shape[0],))
        for _ in range(g_rounds):
            ws = self.shard_round(ws, xs, ys, self.fl.local_epochs,
                                  "stacked")[0]
        return ws

    def _estimate_fisher(self, params: dict, clients: Sequence[int],
                         n_batches: int = 4):
        """RR's diagonal Fisher at ``params``: the running mean of squared
        single-model gradients on the first ``local_batch`` examples of each
        of the first ``n_batches`` clients, in that order."""
        fisher = None
        for i, c in enumerate(clients[:n_batches]):
            x, y = self.client_data[c]
            x = torch.from_numpy(x[: self.local_batch]).to(self.device)
            y = torch.from_numpy(y[: self.local_batch]).to(self.device)
            g = self._grads(_lift(params), x.unsqueeze(0), y.unsqueeze(0))
            fisher = diag_fisher(fisher, _row(g, 0), i)
        return fisher

    def _get_stage_program(self, epochs: int, kind: str, g_rounds: int,
                           encode: bool, out_dtype=None):
        """The whole-stage program for ``engine="stage"``: all S shards
        advance together through the G rounds, and, with ``encode``, the
        stacked (G, S, M*P) history is Lagrange-encoded in one
        ``coded_matmul_rounds`` launch.

        Returns ``program(w0, xs, ys[, enc])`` producing ``(final (S, ...),
        round_inputs [G x (S, ...)], history, norms (G, S, M))`` where
        ``history`` is the coded ``(G, C, M*P)`` slices (``encode``), the
        flat ``(G, S, M, P)`` matrices (``kind == "flat"``) or the per-round
        stacked client trees (``kind == "stacked"``)."""

        @torch.no_grad()
        def stage_body(w0, xs, ys):
            s, m = xs.shape[:2]
            ws = _broadcast(_lift(w0), (s,))
            round_in, hist = [], []
            norms = torch.empty((g_rounds, s, m), device=xs.device)
            for g in range(g_rounds):
                round_in.append(ws)
                ws, out, norms[g] = self.shard_round(ws, xs, ys, epochs, kind)
                if kind != "flat":
                    hist.append(out)
                    continue
                if g == 0:      # (G, S, M, P), filled round by round
                    hist = torch.empty((g_rounds, *out.shape),
                                       device=xs.device)
                hist[g] = out
            return ws, round_in, hist, norms

        if encode:
            def program(w0, xs, ys, enc):
                final, round_in, hist, norms = stage_body(w0, xs, ys)
                g, s = hist.shape[:2]
                coded = coding.encode_rounds(enc, hist.reshape(g, s, -1),
                                             out_dtype=out_dtype)
                return final, round_in, coded, norms
            return program
        return stage_body

    # ------------------------------------------------------------ evaluate
    def predict_interface(self) -> PredictInterface:
        """Public evaluation surface (see ``PredictInterface``) — the API
        the verification suite evaluates through."""
        return PredictInterface(self._pf, self.task_spec.make_batch,
                                self.task_spec, self._spf, self.device)

    @torch.no_grad()
    def evaluate(self, models: Dict[int, object], xs: np.ndarray,
                 ys: np.ndarray, batch: int = 200) -> Dict[str, float]:
        """Ensemble evaluation: mean fp32 logits across the shard models,
        which run as one stack; correct/loss accumulate on the device and
        are read once."""
        batch = min(batch, len(xs))
        nb = len(xs) // batch
        if nb == 0:
            return {"acc": 0.0, "loss": 0.0}
        stacked = _stack(list(models.values()))
        k = len(models)
        correct = torch.zeros((), dtype=torch.int64, device=self.device)
        loss = torch.zeros((), dtype=torch.float32, device=self.device)
        x_all = torch.from_numpy(np.ascontiguousarray(xs[:nb * batch]))
        y_all = torch.from_numpy(np.ascontiguousarray(ys[:nb * batch]))
        x_all, y_all = x_all.to(self.device), y_all.to(self.device)
        for i in range(nb):
            x = x_all[i * batch:(i + 1) * batch]
            y = y_all[i * batch:(i + 1) * batch].long()
            logits = mean_logits(self._spf, self.task_spec.make_batch,
                                 stacked, k, x, y)
            ll = torch.log_softmax(logits, -1)
            correct = correct + (logits.argmax(-1) == y).sum()
            loss = loss + (-ll.gather(-1, y.unsqueeze(-1))).sum()
        total = nb * batch * self.task_spec.labels_per_example(ys.shape)
        return self.task_spec.eval_metrics(int(correct.item()),
                                           float(loss.item()), max(total, 1))

    @torch.no_grad()
    def evaluate_host(self, models: Dict[int, object], xs: np.ndarray,
                      ys: np.ndarray, batch: int = 200) -> Dict[str, float]:
        """Per-batch, per-model eval loop, one model at a time — the
        reference implementation ``evaluate`` is held to."""
        total, correct, loss_sum = 0, 0, 0.0
        batch = min(batch, len(xs))
        for i in range(0, len(xs) - batch + 1, batch):
            x = torch.from_numpy(np.ascontiguousarray(xs[i:i + batch]))
            y = torch.from_numpy(np.ascontiguousarray(ys[i:i + batch]))
            x, y = x.to(self.device), y.to(self.device).long()
            b = self.task_spec.make_batch(x, y)
            logits = None
            for m in models.values():
                lg = self._pf(m, b)
                logits = lg if logits is None else logits + lg
            logits = logits / len(models)
            ll = torch.log_softmax(logits.float(), -1)
            gold = ll.gather(-1, y.unsqueeze(-1)).squeeze(-1)
            loss_sum += float(-gold.sum())
            correct += int((logits.argmax(-1) == y).sum())
            total += y.shape[0] * self.task_spec.labels_per_example(y.shape)
        return self.task_spec.eval_metrics(correct, loss_sum, max(total, 1))
