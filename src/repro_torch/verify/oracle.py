"""Retrain-from-scratch oracle — the ground truth that defines EXACT
unlearning (Halimi et al., arXiv 2207.05521): the model the federation would
have produced had the requested clients never participated
(``repro.verify.oracle`` on torch).

Under the paper's isolation a shard's model is a pure function of its own
clients' data, so the exact counterfactual is computable per shard: restart
from the stage's actual initial model (``plan.stage``'s draw, through the
simulator's ``init_fn`` hook), run the stage's G rounds at the FULL L local
epochs, with the requested clients' data simply absent.  Impacted shards of
one geometry retrain together as one stack through the simulator's
``retrain_shards`` (the fused engine's ``shard_round``).

Registered as an unlearning framework (``"oracle"``), so every entry point can
dispatch to it by name, and the verification suite scores approximate
frameworks (SE/FE/RR) against it with the same ``UnlearnResult`` wall/cost
accounting.  It is NOT a practical serving framework: its cost is the full
retraining bill the paper's SE exists to avoid.
"""
from __future__ import annotations

import torch

from repro_torch.core.tree import tree_map
from repro_torch.fl.experiment.frameworks import (UnlearnContext,
                                                  UnlearnFramework,
                                                  register_framework)


@register_framework("oracle", "retrain-oracle")
class RetrainOracle(UnlearnFramework):
    """Exact per-shard retraining on retained data only — the reference
    every approximate framework's forgetting is measured against."""

    shard_level = True
    exact = True     # marks the ground-truth framework for reports/tests

    def run(self, ctx: UnlearnContext):
        models = dict(ctx.record.shard_models)
        w0 = ctx.stage_init_model()
        jobs = []
        for s in ctx.impacted:
            retained = ctx.retained(s)
            # the stage's ACTUAL round count, not the request's G' budget:
            # the oracle replays history, it doesn't serve a reduced retrain
            g = len(ctx.record.round_globals[s]) - 1
            if not retained:
                # every client of the shard was erased: the counterfactual
                # shard never trained, its model is the from-scratch init
                models[s] = w0
                continue
            xs, ys = ctx.stack_client_data(retained)
            jobs.append((s, retained, xs, ys, g))

        cost = 0.0
        groups: dict = {}
        for job in jobs:
            groups.setdefault((tuple(job[2].shape), job[4]), []).append(job)
        for (_shape, g), group in groups.items():
            xs = torch.stack([j[2] for j in group])    # (K, M', n, ...)
            ys = torch.stack([j[3] for j in group])
            final = ctx.retrain_shards(w0, xs, ys, g)
            for i, (s, retained, *_rest) in enumerate(group):
                models[s] = tree_map(lambda v, i=i: v[i], final)
                cost += g * len(retained) * ctx.fl.local_epochs
        return models, cost

    @classmethod
    def impacted_shards(cls, plan, clients):
        hit = set(clients)
        return sorted(s for s, cs in plan.shard_clients.items()
                      if hit & set(cs))
