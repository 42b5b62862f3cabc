"""Canary injection — forgetting measured as memorization collapse.

Seeded memorization-only examples (canaries) are planted into each victim
client's training data BEFORE the stage trains: inputs off the task's data
manifold mapped to random targets, so no model can score above the chance
rate on them without having memorized the victim's data.  Construction is
task-owned (``TaskSpec.make_canaries``): high-contrast binary noise images
with random labels for classification, random token→token mappings for
generation — the probe works for every registered task × model family.

After unlearning, canary accuracy is the forgetting verdict:

* no-unlearn model      — memorized, accuracy ≫ chance;
* retrain oracle        — never saw them, accuracy ≈ chance;
* a correct framework   — indistinguishable from the oracle.

This is the backdoor-style check of the federated-unlearning literature
(Halimi et al., arXiv 2207.05521 §5: a backdoor that survives unlearning is
data that survived unlearning).  (``repro.verify.canary`` on torch; the
canaries are numpy, byte for byte the reference's.)
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.verify.registry import ForgettingVerifier, register_verifier


def plant_canaries(client_data: Dict[int, Tuple[np.ndarray, np.ndarray]],
                   victims, task_spec, model_cfg, n: int, seed: int):
    """Replace the first ``n`` examples of every victim client with seeded
    canaries (in place).  Replacement — not appending — keeps every client's
    example count unchanged, so stage stacking and shard geometry are
    untouched.  Returns ``(cx, cy, chance)``: all planted canaries
    concatenated, plus the task's chance rate."""
    if n < 1:
        raise ValueError(f"need at least 1 canary per victim, got {n}")
    all_x, all_y, chance = [], [], None
    for v in victims:
        x, y = client_data[v]
        k = min(n, len(x))
        cx, cy, chance = task_spec.make_canaries(model_cfg, x, y, k,
                                                 seed=seed * 9176 + int(v))
        x, y = np.array(x), np.array(y)
        x[:k], y[:k] = cx, cy
        client_data[v] = (x, y)
        all_x.append(cx)
        all_y.append(cy)
    return np.concatenate(all_x), np.concatenate(all_y), chance


@register_verifier("canary")
class CanaryVerifier(ForgettingVerifier):
    """Pareto axis: canary accuracy (down toward the chance rate = data
    actually forgotten).  ``plant`` injects at partition time — the hook runs
    before the victim stage trains — and ``score`` evaluates each candidate
    model set on the planted canaries through the standard task metrics."""

    def __init__(self, n_canaries: Optional[int] = None):
        self.n_canaries = n_canaries       # None -> the suite's default
        self.cx = self.cy = None
        self.chance: float = 0.0

    def plant(self, suite) -> None:
        n = self.n_canaries or suite.n_canaries
        self.cx, self.cy, self.chance = plant_canaries(
            suite.sim.client_data, suite.victims, suite.sim.task_spec,
            suite.sim.cfg, n, seed=suite.seed)

    def score(self, suite, models: Dict[int, object]) -> Dict[str, float]:
        if self.cx is None:
            raise RuntimeError("CanaryVerifier.score before plant: the "
                               "canaries were never injected")
        m = suite.eval_models(models, self.cx, self.cy)
        return {"canary_acc": m["acc"], "canary_chance": self.chance}
