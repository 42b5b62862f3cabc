"""Theoretical analysis (paper Sec 4): closed forms + Monte-Carlo validators.

Time efficiency of isolated sharding (eq. 8-10) and storage effectiveness of
coded sharding (eq. 11-13).  A copy of ``repro.core.theory``: the same
float64 arithmetic and numpy RNG stream, so the same arguments give the
same bytes.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np


# --- Sec 4.1: time efficiency ------------------------------------------------

def sequential_time(num_shards: int, num_requests: int, avg_cost: float) -> float:
    """eq. (9): T_s = K * C_t (each request retrains one shard)."""
    return num_requests * avg_cost


def concurrent_time(num_shards: int, num_requests: int, avg_cost: float) -> float:
    """eq. (10): T_c = S * C_t * (1 - (1 - 1/S)^K)."""
    s, k = num_shards, num_requests
    return s * avg_cost * (1.0 - (1.0 - 1.0 / s) ** k)


def unsharded_time(num_clients_scope: float, num_requests: int,
                   avg_cost: float, concurrent: bool) -> float:
    """Benchmark without isolation: every request retrains the full federation
    (S=1). Sequential: K * S*C_t-equivalent; concurrent: one full retrain."""
    full = num_clients_scope * avg_cost
    return full if concurrent else num_requests * full


def mc_sequential_time(num_shards: int, num_requests: int, avg_cost: float,
                       trials: int = 20_000, seed: int = 0) -> float:
    """Monte-Carlo estimate of the sequential expected cost, for validating
    eq. (9) (requests land on uniformly random shards; each is processed
    individually at cost avg_cost)."""
    rng = np.random.default_rng(seed)
    hits = rng.integers(0, num_shards, size=(trials, num_requests))
    return float(np.mean((hits >= 0).sum(axis=1)) * avg_cost)


def mc_concurrent_time(num_shards: int, num_requests: int, avg_cost: float,
                       trials: int = 20_000, seed: int = 0) -> float:
    """Monte-Carlo estimate for eq. (10): cost = (#distinct impacted shards)
    * avg_cost when the K requests are batched."""
    rng = np.random.default_rng(seed)
    hits = rng.integers(0, num_shards, size=(trials, num_requests))
    distinct = np.array([len(np.unique(h)) for h in hits])
    return float(distinct.mean() * avg_cost)


# --- Sec 4.2: storage effectiveness ------------------------------------------

def storage_efficiency_bounds(num_clients: int, num_shards: int,
                              mu: float) -> Tuple[float, float]:
    """eq. (12): S <= gamma_c <= (1 - 2 mu) C, with feasibility eq. (11)."""
    assert 2 * mu * num_clients <= num_clients - num_shards + 1e-9, \
        "violates 2*mu*C <= C - S (eq. 11)"
    return float(num_shards), (1.0 - 2.0 * mu) * num_clients


def coded_throughput(num_clients: int, num_shards: int) -> float:
    """eq. (13): lambda_c = S / O(C^2 log^2 C loglog C) — relative units."""
    c = max(num_clients, 3)
    denom = c ** 2 * math.log(c) ** 2 * math.log(math.log(c))
    return num_shards / denom


def storage_bytes(model_bytes: int, num_clients: int, num_shards: int,
                  rounds: int, mechanism: str) -> dict:
    """Byte-level accounting used by the Fig. 5 benchmark.

    Returns dict with per-server and per-client storage for one stage.
    ``model_bytes`` is the size of ONE client's parameter vector.
    mechanism in {"full", "uncoded", "coded"}:
      full    — FedEraser: the central server stores every participating
                client's params for every round.
      uncoded — isolated sharding: each shard server stores only its own
                clients' params per round.
      coded   — coded sharding: servers store only the interpolation keys;
                each client stores one coded slice per round (a mix of the
                S shard vectors, each sized clients_per_shard*model_bytes).
    """
    per_shard_clients = num_clients // num_shards
    shard_vec = per_shard_clients * model_bytes
    if mechanism == "full":
        return {"server_bytes": num_clients * rounds * model_bytes,
                "client_bytes": 0,
                "total_bytes": num_clients * rounds * model_bytes}
    if mechanism == "uncoded":
        return {"server_bytes": per_shard_clients * rounds * model_bytes,
                "client_bytes": 0,
                "total_bytes": num_clients * rounds * model_bytes}
    if mechanism == "coded":
        keys = 16 * num_clients  # alpha/omega points + MACs, negligible
        return {"server_bytes": keys,
                "client_bytes": rounds * shard_vec,
                "total_bytes": keys * num_shards + num_clients * rounds * shard_vec}
    raise ValueError(mechanism)
