"""Federated data partitioning (paper Sec 5.1), behind a registry — a numpy
copy of ``repro.data.federated`` with the same RNG calls.

Every partitioner maps ``(n, labels, num_clients, seed)`` to a list of
``num_clients`` disjoint index arrays and registers under a name
(``@register_partitioner``), generalizing the old ``iid: bool`` flag:

* ``iid``           — random equal split (the paper's IID setting).
* ``primary-class`` — 80% of each client from one class [Wang et al., 2020]
                      (the paper's non-IID classification setting).
* ``buckets``       — unbalanced dirichlet buckets, two per client (the
                      paper's non-IID language setting).
* ``dirichlet``     — Dirichlet(alpha) label skew [Hsu et al., 2019]: small
                      alpha -> each client concentrated on few classes.
* ``zipf``          — Zipf quantity skew: client k holds ~k^-exponent of the
                      data; large exponent -> heavy imbalance.

``labels`` may be ``None`` (generation tasks have no class labels);
label-skew partitioners raise an actionable error in that case.  All
partitioners are deterministic in ``seed`` — identical inputs reproduce the
partition bit-for-bit.
"""
from __future__ import annotations

import inspect
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.data.synthetic import ImageData

Partitioner = Callable[..., List[np.ndarray]]

PARTITIONERS: Dict[str, Partitioner] = {}


def register_partitioner(*names: str):
    """Decorator registering ``fn(n, labels, num_clients, seed, **params)``
    under ``names`` (the first is canonical)."""
    if not names:
        raise ValueError("register_partitioner needs at least one name")

    def deco(fn: Partitioner) -> Partitioner:
        fn.partitioner_name = names[0]
        for n in names:
            PARTITIONERS[n] = fn
        return fn
    return deco


def get_partitioner(name: str, **params) -> Partitioner:
    """Resolve a registered partitioner, with ``params`` (e.g. dirichlet
    ``alpha``) bound.  Unknown parameter names fail here — at resolution
    time — with the partitioner's accepted names, not as a deep
    ``TypeError`` inside data building."""
    try:
        fn = PARTITIONERS[name]
    except KeyError:
        raise ValueError(f"unknown partitioner {name!r}; registered: "
                         f"{sorted(PARTITIONERS)}") from None
    if not params:
        return fn
    sig = inspect.signature(fn)
    accepted = list(sig.parameters)[4:]          # after (n, labels, nc, seed)
    bad = sorted(set(params) - set(accepted))
    if bad:
        raise ValueError(
            f"invalid parameter(s) {bad} for partitioner {name!r}; "
            f"accepted: {accepted}")
    return lambda n, labels, num_clients, seed=0: fn(n, labels, num_clients,
                                                     seed, **params)


def _require_labels(labels, name: str):
    if labels is None:
        raise ValueError(
            f"partitioner {name!r} needs class labels (label skew), but the "
            f"task provides none (generation examples are unlabeled); use a "
            f"quantity-skew partitioner such as 'zipf' or 'buckets'")


def _spread_to_empty(parts: List[List[int]]) -> List[np.ndarray]:
    """Deterministically move samples from the largest clients to empty ones
    so every client trains on >=1 example."""
    total = sum(len(p) for p in parts)
    if total < len(parts):
        raise ValueError(
            f"cannot give each of {len(parts)} clients >=1 example from "
            f"{total} examples; increase samples_per_client or reduce "
            f"num_clients")
    for k, p in enumerate(parts):
        if not p:
            donor = max(range(len(parts)), key=lambda j: len(parts[j]))
            parts[k] = [parts[donor].pop()]
    return [np.asarray(sorted(p), np.int64) for p in parts]


# ---------------------------------------------------------------------------
# Seed partitioners (the paper's settings)
# ---------------------------------------------------------------------------

def partition_iid(n: int, num_clients: int, seed: int = 0) -> List[np.ndarray]:
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    return [np.sort(p) for p in np.array_split(perm, num_clients)]


def partition_noniid_classes(labels: np.ndarray, num_clients: int,
                             primary_frac: float = 0.8,
                             seed: int = 0) -> List[np.ndarray]:
    rng = np.random.default_rng(seed)
    n = len(labels)
    num_classes = int(labels.max()) + 1
    per_client = n // num_clients
    by_class = {c: list(rng.permutation(np.where(labels == c)[0]))
                for c in range(num_classes)}
    rest_pool = list(rng.permutation(n))
    out = []
    for k in range(num_clients):
        primary = k % num_classes
        n_prim = int(per_client * primary_frac)
        take = []
        pool = by_class[primary]
        take.extend(pool[:n_prim])
        by_class[primary] = pool[n_prim:]
        while len(take) < per_client and rest_pool:
            cand = rest_pool.pop()
            take.append(cand)
        out.append(np.asarray(sorted(take[:per_client]), np.int64))
    return out


def partition_noniid_buckets(n_examples: int, num_clients: int,
                             seed: int = 0) -> List[np.ndarray]:
    """Unbalanced buckets; each client is assigned two buckets."""
    rng = np.random.default_rng(seed)
    n_buckets = num_clients * 2
    # unbalanced bucket sizes via dirichlet
    sizes = rng.dirichlet(np.full(n_buckets, 0.5)) * n_examples
    sizes = np.maximum(sizes.astype(np.int64), 1)
    edges = np.minimum(np.cumsum(sizes), n_examples)
    buckets = np.split(np.arange(n_examples), edges[:-1])
    order = rng.permutation(n_buckets)
    return [np.concatenate([buckets[order[2 * k]], buckets[order[2 * k + 1]]])
            for k in range(num_clients)]


@register_partitioner("iid")
def _iid(n: int, labels, num_clients: int, seed: int = 0):
    return partition_iid(n, num_clients, seed)


@register_partitioner("primary-class", "noniid-classes")
def _primary_class(n: int, labels, num_clients: int, seed: int = 0,
                   primary_frac: float = 0.8):
    _require_labels(labels, "primary-class")
    return partition_noniid_classes(labels, num_clients,
                                    primary_frac=primary_frac, seed=seed)


@register_partitioner("buckets", "noniid-buckets")
def _buckets(n: int, labels, num_clients: int, seed: int = 0):
    return partition_noniid_buckets(n, num_clients, seed)


# ---------------------------------------------------------------------------
# Heterogeneity axes beyond the paper (FedShard / Hsu et al. style)
# ---------------------------------------------------------------------------

@register_partitioner("dirichlet")
def partition_dirichlet(n: int, labels, num_clients: int, seed: int = 0,
                        alpha: float = 0.5) -> List[np.ndarray]:
    """Dirichlet(alpha) label skew: for each class, the class's samples are
    split across clients by proportions drawn from Dir(alpha * 1).  Small
    alpha concentrates each class on few clients; alpha -> inf recovers an
    even spread."""
    _require_labels(labels, "dirichlet")
    if alpha <= 0:
        raise ValueError(f"dirichlet alpha must be > 0, got {alpha}")
    rng = np.random.default_rng(seed)
    num_classes = int(labels.max()) + 1
    parts: List[List[int]] = [[] for _ in range(num_clients)]
    for c in range(num_classes):
        idx = rng.permutation(np.where(labels == c)[0])
        props = rng.dirichlet(np.full(num_clients, alpha))
        cuts = (np.cumsum(props)[:-1] * len(idx)).astype(np.int64)
        for k, chunk in enumerate(np.split(idx, cuts)):
            parts[k].extend(int(i) for i in chunk)
    return _spread_to_empty(parts)


@register_partitioner("zipf")
def partition_zipf(n: int, labels, num_clients: int, seed: int = 0,
                   exponent: float = 1.2) -> List[np.ndarray]:
    """Zipf quantity skew: client k receives a share ~ (k+1)^-exponent of the
    examples (client 0 largest).  exponent=0 is an equal split; larger
    exponents concentrate the data on few clients."""
    if exponent < 0:
        raise ValueError(f"zipf exponent must be >= 0, got {exponent}")
    rng = np.random.default_rng(seed)
    weights = (1.0 / np.arange(1, num_clients + 1) ** exponent)
    shares = weights / weights.sum()
    sizes = np.maximum((shares * n).astype(np.int64), 1)
    # deterministic fixup so sizes sum exactly to n: trim/pad the largest
    sizes[0] += n - int(sizes.sum())
    if sizes[0] < 1:
        raise ValueError(
            f"zipf partition infeasible: {n} examples over {num_clients} "
            f"clients at exponent {exponent}; increase samples_per_client")
    perm = rng.permutation(n)
    edges = np.cumsum(sizes)[:-1]
    return [np.sort(p) for p in np.split(perm, edges)]


# ---------------------------------------------------------------------------
# Client-dataset builders (the ``iid: bool`` flag lives on as a shim)
# ---------------------------------------------------------------------------

def _resolve(partitioner: Optional[str], iid: Optional[bool],
             legacy_skew: str, **params) -> Partitioner:
    if partitioner is None:
        partitioner = "iid" if (iid is None or iid) else legacy_skew
    return get_partitioner(partitioner, **params)


def client_datasets_images(data: ImageData, num_clients: int,
                           iid: Optional[bool] = None, seed: int = 0,
                           partitioner: Optional[str] = None,
                           **params) -> Dict[int, Tuple[np.ndarray, np.ndarray]]:
    part = _resolve(partitioner, iid, "primary-class", **params)
    parts = part(len(data.labels), data.labels, num_clients, seed)
    return {k: (data.images[idx], data.labels[idx])
            for k, idx in enumerate(parts)}


def client_datasets_lm(tokens: np.ndarray, labels: np.ndarray,
                       num_clients: int, iid: Optional[bool] = None,
                       seed: int = 0, partitioner: Optional[str] = None,
                       **params) -> Dict[int, Tuple[np.ndarray, np.ndarray]]:
    part = _resolve(partitioner, iid, "buckets", **params)
    parts = part(len(tokens), None, num_clients, seed)
    return {k: (tokens[idx], labels[idx]) for k, idx in enumerate(parts)}
