"""Stage-based isolated sharding (paper Sec 3.2).

The learning/unlearning timeline is divided into *stages*; within a stage the
participating clients are partitioned into ``S`` isolated shards, each with
its own aggregation server. No cross-shard interaction happens inside a stage,
which is what makes shard-local retraining a *provable* unlearning operation
(eq. 4): a shard's model is a pure function of its own clients' data.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Set

import numpy as np


@dataclass
class StagePlan:
    """Client -> shard assignment for one stage."""
    stage: int
    shard_clients: Dict[int, List[int]]          # shard id -> client ids

    @property
    def num_shards(self) -> int:
        return len(self.shard_clients)

    def shard_of(self, client: int) -> int:
        for s, cs in self.shard_clients.items():
            if client in cs:
                return s
        raise KeyError(f"client {client} not in stage {self.stage}")

    @property
    def clients(self) -> List[int]:
        return sorted(c for cs in self.shard_clients.values() for c in cs)


class ShardManager:
    """Stage/shard bookkeeping: sampling, assignment, impact analysis."""

    def __init__(self, num_clients: int, num_shards: int,
                 clients_per_round: int, seed: int = 0):
        self.num_clients = num_clients
        self.num_shards = num_shards
        self.clients_per_round = clients_per_round
        self._rng = np.random.default_rng(seed)
        self.stages: List[StagePlan] = []

    def new_stage(self) -> StagePlan:
        """Sample participating clients and split them into isolated shards."""
        chosen = self._rng.choice(self.num_clients, self.clients_per_round,
                                  replace=False)
        per = self.clients_per_round // self.num_shards
        plan = StagePlan(
            stage=len(self.stages),
            shard_clients={s: sorted(int(c) for c in chosen[s * per:(s + 1) * per])
                           for s in range(self.num_shards)},
        )
        self.stages.append(plan)
        return plan

    # -- unlearning impact ---------------------------------------------------
    def impacted_shards(self, plan: StagePlan,
                        unlearn_clients: Sequence[int]) -> Set[int]:
        """S' — shards containing at least one unlearning client (isolation
        means only these retrain)."""
        out = set()
        for c in unlearn_clients:
            for s, cs in plan.shard_clients.items():
                if c in cs:
                    out.add(s)
        return out

    def retained(self, plan: StagePlan, shard: int,
                 unlearn_clients: Sequence[int]) -> List[int]:
        return [c for c in plan.shard_clients[shard] if c not in unlearn_clients]


def even_requests(plan: StagePlan, k: int, seed: int = 0) -> List[int]:
    """'Even' request pattern: requests spread evenly across shards."""
    rng = np.random.default_rng(seed)
    out: List[int] = []
    shards = sorted(plan.shard_clients)
    i = 0
    while len(out) < k:
        pool = [c for c in plan.shard_clients[shards[i % len(shards)]]
                if c not in out]
        if pool:
            out.append(int(rng.choice(pool)))
        i += 1
    return out


def adaptive_requests(plan: StagePlan, k: int, seed: int = 0) -> List[int]:
    """'Adapt' request pattern: all requests hit one shard (paper Sec 5.1)."""
    rng = np.random.default_rng(seed)
    shard = int(rng.choice(sorted(plan.shard_clients)))
    pool = list(plan.shard_clients[shard])
    k = min(k, max(len(pool) - 1, 1))
    return [int(c) for c in rng.choice(pool, size=k, replace=False)]
