"""Shadow-model membership inference — the attack calibrated WITHOUT access
to the victim's membership ground truth ([Shokri et al. 2017]; the protocol
Halimi et al., arXiv 2207.05521 use to audit federated unlearning)
(``repro.verify.shadow`` on torch).

The threshold attack in ``repro_torch.fl.mia`` fits its classifier on the
victim model's own member/non-member features — fine as a unit-level
separability probe, but it hands the attacker labels no real attacker has.
The shadow attack trains N *shadow federations* (same ``ScenarioConfig``,
different seeds → disjoint synthetic draws of the same distribution, fresh
inits), where the attacker KNOWS which examples were members, fits the
logistic attack on the pooled shadow features, and only then scores the
victim's models.  Evaluating that fixed attack on the forgotten client's
data for the unlearned / oracle / no-unlearn models is the reported
forgetting metric: an exactly-unlearned model scores the no-information F1
(~0.5 under the balanced decision rule), a model that still remembers scores
higher.

Each shadow is a scenario at another seed, so its initial models come from
``init_for_seed(seed)`` — an ``init_fn(salt)`` hook per seed — or, without
it, from the port's own initialiser at that seed.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np

from repro_torch.fl import mia
from repro_torch.fl.experiment.scenario import build_simulator
from repro_torch.fl.experiment.stage import train_stage
from repro_torch.verify.registry import ForgettingVerifier, register_verifier

InitForSeed = Optional[Callable[[int], Callable[[int], dict]]]


@dataclass
class ShadowAttack:
    """A fitted membership attack: logistic model + balanced threshold,
    calibrated purely on shadow-federation features."""

    model: tuple                  # (w, b, mu, sd) from mia._logreg_fit
    threshold: float              # balanced decision threshold (shadow median)
    n_shadows: int
    train_acc: float              # member/non-member acc on shadow features

    def member_flags(self, iface, models: Dict[int, object],
                     xs, ys) -> np.ndarray:
        """Attack decisions (1 = 'member') on ``(xs, ys)`` under ``models``,
        features extracted through the public ``PredictInterface``."""
        fx = mia._features(iface.stacked_predict, models, iface.make_batch,
                           xs, ys, iface.task)
        return mia._logreg_predict(self.model, fx, self.threshold)

    def f1(self, iface, models: Dict[int, object], forgotten_data,
           nonmember_data) -> float:
        """F1 of the attack claiming 'member' on the forgotten data (false
        positives from an equal-sized true non-member split).  Lower =
        better forgotten; the retrain oracle scores ~the no-information
        rate."""
        flags_f = self.member_flags(iface, models, *forgotten_data)
        flags_n = self.member_flags(iface, models, *nonmember_data)
        n_eval = min(len(flags_f), len(flags_n))
        return mia.attack_f1(flags_f[:n_eval], flags_n[:n_eval])


def shadow_features(cfg, n_shadows: int = 3, rounds: Optional[int] = None,
                    seed: Optional[int] = None, device=None,
                    init_for_seed: InitForSeed = None):
    """The pooled shadow features and membership labels ``(x, y)`` that
    ``train_shadow_attack`` fits on: each shadow re-runs ``cfg`` at
    ``seed + 7919*(i+1)``, trains one stage on ``device``, and contributes a
    balanced batch (a seeded subsample of its stage members vs its held-out
    test split)."""
    if n_shadows < 1:
        raise ValueError(f"need at least 1 shadow model, got {n_shadows}")
    base_seed = cfg.seed if seed is None else seed
    feats, labels = [], []
    for i in range(n_shadows):
        scfg = dataclasses.replace(cfg, seed=base_seed + 7919 * (i + 1),
                                   schedule=None, num_stages=1)
        init_fn = init_for_seed(scfg.seed) if init_for_seed else None
        sim, test = build_simulator(scfg, device=device, init_fn=init_fn)
        record = train_stage(sim, store_kind=scfg.store, rounds=rounds,
                             engine=scfg.engine)
        iface = sim.predict_interface()
        mx = np.concatenate([sim.client_data[c][0]
                             for c in record.plan.clients])
        my = np.concatenate([sim.client_data[c][1]
                             for c in record.plan.clients])
        fm = mia._features(iface.stacked_predict, record.shard_models,
                           iface.make_batch, mx, my, iface.task)
        fn = mia._features(iface.stacked_predict, record.shard_models,
                           iface.make_batch, *test, iface.task)
        # balanced member/non-member batch, deterministic member subsample
        k = min(len(fm), len(fn))
        idx = np.random.default_rng(scfg.seed).choice(len(fm), k,
                                                      replace=False)
        feats.extend([fm[idx], fn[:k]])
        labels.extend([np.ones(k), np.zeros(k)])
    return np.concatenate(feats), np.concatenate(labels)


def train_shadow_attack(cfg, n_shadows: int = 3,
                        rounds: Optional[int] = None,
                        seed: Optional[int] = None, device=None,
                        init_for_seed: InitForSeed = None) -> ShadowAttack:
    """Train N seeded shadow federations and fit the attack on their pooled
    member/non-member features (``shadow_features``).

    ``rounds`` optionally shortens the shadows' stage (the attack transfers
    as long as shadows and victim overfit comparably; default = the
    victim's round count).  Deterministic in (cfg, n_shadows, rounds, seed)
    and the initial weights ``init_for_seed`` gives each shadow.
    """
    x, y = shadow_features(cfg, n_shadows, rounds, seed, device,
                           init_for_seed)
    model = mia._logreg_fit(x, y)
    threshold = float(np.median(mia._logreg_score(model, x)))
    pred = mia._logreg_predict(model, x, threshold)
    return ShadowAttack(model, threshold, n_shadows,
                        train_acc=float((pred == y).mean()))


@register_verifier("shadow-mia")
class ShadowMIAVerifier(ForgettingVerifier):
    """Pareto axis: shadow-attack F1 on the forgotten client's data (down =
    better forgotten).  Trains the attack once per suite (``prepare``), on
    the victim's device and with its ``init_for_seed`` hook, and scores
    every candidate with the same fixed attack."""

    def __init__(self, attack: Optional[ShadowAttack] = None):
        self.attack = attack          # pre-fitted attack skips the shadows

    def prepare(self, suite) -> None:
        if self.attack is None:
            self.attack = train_shadow_attack(
                suite.cfg, n_shadows=suite.n_shadows,
                rounds=suite.shadow_rounds, device=suite.sim.device,
                init_for_seed=suite.init_for_seed)

    def score(self, suite, models: Dict[int, object]) -> Dict[str, float]:
        f1 = self.attack.f1(suite.iface, models, suite.forgotten_data,
                            suite.nonmember_data)
        return {"mia_f1": f1}
