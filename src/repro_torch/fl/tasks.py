"""Task registry — the learning tasks a federated scenario can run.

A ``TaskSpec`` owns data synthesis + client partitioning, batch
construction, per-example label counting and the eval metrics.  The port
carries the classification task (the paper's CNN track) and the generation
task (accuracy, perplexity and bits per char; its default family is the
paper's NanoGPT, ``"transformer"``, and ``model="mamba"`` or ``"rwkv6"``
picks another).  Each task also owns its membership-inference features and
its canaries (``repro_torch.fl.mia``, ``repro_torch.verify``).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple, Type

import numpy as np
import torch

from repro_torch.data.synthetic import (lm_examples, make_char_data,
                                        make_image_data)


class TaskSpec:
    """Base class for tasks.  Subclass, implement the hooks, and register
    with ``@register_task(name, *aliases)``."""

    name: str = ""
    kind: str = ""              # batch/metric shape family; defaults to name
    default_family: str = ""    # model family used when ScenarioConfig.model=""
    legacy_skew: str = ""       # partitioner the deprecated iid=False maps to
    default_lr: float = 0.05
    default_batch: int = 20

    def build_data(self, cfg, model_cfg, partition) -> Tuple[Dict, Tuple]:
        """Synthesize the federation's data: ``(clients, test)`` where
        ``clients`` maps client id -> (x, y) numpy arrays."""
        raise NotImplementedError

    def make_batch(self, x, y) -> Dict:
        raise NotImplementedError

    def labels_per_example(self, y_shape) -> int:
        raise NotImplementedError

    def eval_metrics(self, correct: int, loss: float,
                     total: int) -> Dict[str, float]:
        return {"acc": correct / max(total, 1), "loss": loss / max(total, 1)}

    def mia_features(self, logits: torch.Tensor,
                     y: torch.Tensor) -> torch.Tensor:
        """Per-example membership features ``[nll, max_prob, entropy]`` from
        the (already ensemble-averaged) float32 logits: an ``(n, 3)`` tensor
        consumed by ``repro_torch.fl.mia`` and the shadow attack in
        ``repro_torch.verify``."""
        raise NotImplementedError

    def make_canaries(self, model_cfg, like_x, like_y, n: int, seed: int):
        """``n`` seeded memorization-only canary examples, shaped and dtyped
        like the ``(like_x, like_y)`` exemplars: inputs off the task's data
        manifold mapped to random targets (``repro_torch.verify.canary``).
        Returns ``(xs, ys, chance_rate)``, numpy."""
        raise NotImplementedError


TASKS: Dict[str, Type[TaskSpec]] = {}


def register_task(*names: str):
    """Class decorator registering a ``TaskSpec`` under ``names``."""
    if not names:
        raise ValueError("register_task needs at least one name")

    def deco(cls: Type[TaskSpec]) -> Type[TaskSpec]:
        cls.name = names[0]
        if not cls.kind:
            cls.kind = names[0]
        for n in names:
            TASKS[n] = cls
        return cls
    return deco


def get_task(name: str) -> TaskSpec:
    try:
        return TASKS[name]()
    except KeyError:
        raise ValueError(f"unknown task {name!r}; registered: "
                         f"{sorted(TASKS)}") from None


def resolve_task(task) -> TaskSpec:
    """Accept a ``TaskSpec`` instance, class, or registered name."""
    if isinstance(task, TaskSpec):
        return task
    if isinstance(task, type) and issubclass(task, TaskSpec):
        return task()
    return get_task(task)


def _check_parts(parts, num_clients: int, partitioner_desc: str):
    empty = [k for k, idx in enumerate(parts) if len(idx) == 0]
    if len(parts) != num_clients or empty:
        raise ValueError(
            f"partitioner {partitioner_desc} produced "
            f"{len(parts)} partitions with empty clients {empty} for "
            f"{num_clients} clients; increase samples_per_client or soften "
            f"the skew parameters")


@register_task("classification", "image")
class ClassificationTask(TaskSpec):
    """Image classification (the paper's CNN track): class-conditional
    synthetic images, accuracy + mean NLL metrics."""

    default_family = "cnn"
    legacy_skew = "primary-class"
    default_lr = 0.05
    default_batch = 20

    def build_data(self, cfg, model_cfg, partition):
        data = make_image_data(cfg.num_clients * cfg.samples_per_client,
                               image_size=cfg.image_size, seed=cfg.seed,
                               noise=cfg.noise)
        parts = partition(len(data.labels), data.labels, cfg.num_clients,
                          cfg.seed)
        _check_parts(parts, cfg.num_clients, cfg.partitioner)
        clients = {k: (data.images[idx], data.labels[idx])
                   for k, idx in enumerate(parts)}
        test = make_image_data(cfg.test_n, image_size=cfg.image_size,
                               seed=cfg.seed + 999, noise=cfg.noise)
        return clients, (test.images, test.labels)

    def make_batch(self, x, y):
        return {"images": x, "labels": y}

    def labels_per_example(self, y_shape) -> int:
        return 1

    def mia_features(self, logits, y):
        ll = torch.log_softmax(logits, -1)
        nll = -ll.gather(-1, y.long()[:, None])[:, 0]
        p = torch.exp(ll)
        return torch.stack([nll, p.max(-1).values, -(p * ll).sum(-1)], dim=1)

    def make_canaries(self, model_cfg, like_x, like_y, n: int, seed: int):
        # high-contrast binary noise images: maximally off the smooth
        # class-prototype manifold, random labels -> chance = 1/num_classes
        rng = np.random.default_rng(seed)
        xs = rng.integers(0, 2, (n,) + like_x.shape[1:]).astype(like_x.dtype)
        ys = rng.integers(0, model_cfg.num_classes, n).astype(like_y.dtype)
        return xs, ys, 1.0 / model_cfg.num_classes


@register_task("generation", "lm")
class GenerationTask(TaskSpec):
    """Next-token generation (the paper's NanoGPT track, open to every LM
    family): zipfian char stream, perplexity / bits-per-char metrics."""

    default_family = "transformer"
    legacy_skew = "buckets"
    default_lr = 0.3
    default_batch = 10

    def build_data(self, cfg, model_cfg, partition):
        stream = make_char_data(cfg.num_clients * cfg.samples_per_client
                                * cfg.seq_len + cfg.seq_len + 1,
                                vocab_size=model_cfg.vocab_size, seed=cfg.seed)
        toks, labs = lm_examples(stream, cfg.seq_len)
        # generation examples carry no class label: label-skew partitioners
        # raise their own error
        parts = partition(len(toks), None, cfg.num_clients, cfg.seed)
        _check_parts(parts, cfg.num_clients, cfg.partitioner)
        clients = {k: (toks[idx], labs[idx]) for k, idx in enumerate(parts)}
        test_stream = make_char_data(cfg.test_n * cfg.seq_len + 1,
                                     vocab_size=model_cfg.vocab_size,
                                     seed=cfg.seed + 999)
        return clients, lm_examples(test_stream, cfg.seq_len)

    def make_batch(self, x, y):
        return {"tokens": x, "labels": y}

    def labels_per_example(self, y_shape) -> int:
        return int(np.prod(y_shape[1:]))

    def eval_metrics(self, correct, loss, total):
        nll = loss / max(total, 1)
        return {"acc": correct / max(total, 1), "loss": nll,
                "ppl": float(math.exp(min(nll, 30.0))),
                "bpc": nll / math.log(2.0)}

    def mia_features(self, logits, y):
        # per-sequence means over the position axis
        ll = torch.log_softmax(logits, -1)
        gold = ll.gather(-1, y.long()[..., None])[..., 0]
        p = torch.exp(ll)
        return torch.stack([-gold.mean(-1), p.max(-1).values.mean(-1),
                            (-(p * ll).sum(-1)).mean(-1)], dim=1)

    def make_canaries(self, model_cfg, like_x, like_y, n: int, seed: int):
        # random token sequences mapped to random (NOT next-token) targets:
        # no n-gram structure to generalize from, chance = 1/vocab
        rng = np.random.default_rng(seed)
        v = model_cfg.vocab_size
        xs = rng.integers(0, v, (n,) + like_x.shape[1:]).astype(like_x.dtype)
        ys = rng.integers(0, v, (n,) + like_y.shape[1:]).astype(like_y.dtype)
        return xs, ys, 1.0 / v
