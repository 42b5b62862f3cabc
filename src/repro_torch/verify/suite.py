"""The verification suite — one victim scenario, every framework, every probe.

``run_verification`` is the subsystem's entry point: it builds the victim
federation from a ``ScenarioConfig``, lets the verifiers plant (canaries go
into the victim clients BEFORE the stage trains), trains the stage, prepares
the probes (the shadow attack fits here), then scores every candidate model
set — the untouched no-unlearn record, each requested framework's unlearned
models, and the retrain oracle — producing the forgetting × utility × cost
``VerifyReport`` (``repro.verify.suite`` on torch).

Victim choice is deterministic: ``ShardManager`` sampling depends only on
``(num_clients, num_shards, clients_per_round, seed)``, so
``predict_stage_victim`` replays the stage-0 plan before any training and
canaries can be planted for a client that is guaranteed to participate.

Everything runs on the device ``build_simulator`` resolved (the CUDA card
unless ``device="cpu"``): the victim's stage and unlearning, the shadows,
and every evaluation.  ``init_for_seed(seed) -> init_fn`` supplies the
initial models of the scenario at each seed (the victim's and each
shadow's); without it the port's own initialiser draws them.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.sharding import ShardManager
from repro_torch.fl.experiment.frameworks import run_unlearn
from repro_torch.fl.experiment.scenario import (ScenarioConfig,
                                                build_simulator)
from repro_torch.fl.experiment.session import FederatedSession
from repro_torch.verify.registry import (ForgettingVerifier,
                                         register_verifier, resolve_verifiers)
from repro_torch.verify.report import CandidateScore, VerifyReport
from repro_torch.verify.shadow import InitForSeed

DEFAULT_FRAMEWORKS = ("SE", "FE", "FR", "RR")
DEFAULT_VERIFIERS = ("shadow-mia", "canary", "utility")


class VerificationSuite:
    """Shared state the verifiers hook into: the victim scenario's config,
    simulator, trained record, victim client ids, and the evaluation
    surfaces (``predict_interface``, forgotten/retained/non-member splits)."""

    def __init__(self, cfg: ScenarioConfig, sim, test, victims: Sequence[int],
                 n_shadows: int = 3, n_canaries: int = 8,
                 shadow_rounds: Optional[int] = None,
                 init_for_seed: InitForSeed = None):
        self.cfg = cfg
        self.sim = sim
        self.test = test
        self.victims = [int(v) for v in victims]
        self.seed = cfg.seed
        self.n_shadows = n_shadows
        self.n_canaries = n_canaries
        self.shadow_rounds = shadow_rounds
        self.init_for_seed = init_for_seed
        self.iface = sim.predict_interface()
        self.record = None                      # set once the stage trained
        self.session: Optional[FederatedSession] = None

    # ------------------------------------------------------------ data splits
    @property
    def forgotten_data(self) -> Tuple[np.ndarray, np.ndarray]:
        """The victim clients' training data as it entered the stage (post
        planting) — what the attack probes for residual membership."""
        xs = np.concatenate([self.sim.client_data[v][0] for v in self.victims])
        ys = np.concatenate([self.sim.client_data[v][1] for v in self.victims])
        return xs, ys

    @property
    def nonmember_data(self) -> Tuple[np.ndarray, np.ndarray]:
        """True non-members: the held-out test split."""
        return self.test

    def retained_data(self, cap_per_client: int = 40
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """Training data of the stage's NON-victim participants (capped per
        client) — the utility the unlearning must not destroy."""
        if self.record is None:
            raise RuntimeError("retained_data before the stage trained")
        keep = [c for c in self.record.plan.clients if c not in self.victims]
        xs = np.concatenate([self.sim.client_data[c][0][:cap_per_client]
                             for c in keep])
        ys = np.concatenate([self.sim.client_data[c][1][:cap_per_client]
                             for c in keep])
        return xs, ys

    # ------------------------------------------------------------- evaluation
    def eval_models(self, models: Dict[int, object], xs, ys) -> Dict[str, float]:
        """Task metrics of the shard-ensemble on ``(xs, ys)``."""
        return self.sim.evaluate(models, xs, ys)


@register_verifier("utility")
class UtilityVerifier(ForgettingVerifier):
    """Pareto axis: retained-client + test utility (up = unlearning that did
    not damage what it was supposed to keep).  Task-aware: perplexity rides
    along for generation tasks."""

    def __init__(self, cap_per_client: int = 40):
        self.cap_per_client = cap_per_client
        self._retain = None

    def prepare(self, suite) -> None:
        self._retain = suite.retained_data(self.cap_per_client)

    def score(self, suite, models: Dict[int, object]) -> Dict[str, float]:
        r = suite.eval_models(models, *self._retain)
        t = suite.eval_models(models, *suite.test)
        out = {"retain_acc": r["acc"], "retain_loss": r["loss"],
               "test_acc": t["acc"], "test_loss": t["loss"]}
        if "ppl" in r:
            out["retain_ppl"] = r["ppl"]
            out["test_ppl"] = t["ppl"]
        return out


def predict_stage_victim(cfg: ScenarioConfig) -> int:
    """The id of a client guaranteed to participate in stage 0 — replayed
    from a throwaway ``ShardManager`` with the scenario's seed (sampling is
    deterministic, so the real stage produces the identical plan)."""
    mgr = ShardManager(cfg.num_clients, cfg.num_shards,
                       cfg.clients_per_round, cfg.seed)
    plan = mgr.new_stage()
    s = min(plan.shard_clients)
    return int(sorted(plan.shard_clients[s])[0])


def run_verification(cfg: ScenarioConfig,
                     frameworks: Sequence[str] = DEFAULT_FRAMEWORKS,
                     verifiers: Sequence = DEFAULT_VERIFIERS,
                     victims: Optional[Sequence[int]] = None,
                     n_shadows: int = 3, n_canaries: int = 8,
                     shadow_rounds: Optional[int] = None,
                     include_oracle: bool = True,
                     include_baseline: bool = True, device=None,
                     init_for_seed: InitForSeed = None,
                     keep_models: bool = False) -> VerifyReport:
    """Run the full forgetting-verification protocol for one scenario.

    Returns a ``VerifyReport`` whose candidates are ``"none"`` (the trained
    stage untouched, when ``include_baseline``), each framework in
    ``frameworks``, and ``"oracle"`` (exact retrain, when
    ``include_oracle``) — each scored by every verifier.  ``device`` and
    ``init_for_seed`` as in the module docstring; with ``keep_models`` the
    report also holds each candidate's models and the suite
    (``VerifyReport.models`` / ``.suite``).
    """
    probes = resolve_verifiers(verifiers)
    if victims is None:
        victims = [predict_stage_victim(cfg)]
    victims = [int(v) for v in victims]

    sim, test = build_simulator(
        cfg, device=device,
        init_fn=init_for_seed(cfg.seed) if init_for_seed else None)
    suite = VerificationSuite(cfg, sim, test, victims, n_shadows=n_shadows,
                              n_canaries=n_canaries,
                              shadow_rounds=shadow_rounds,
                              init_for_seed=init_for_seed)

    # plant BEFORE training — canaries must be in the victims' data when the
    # stage stacks it
    for probe in probes:
        probe.plant(suite)

    session = FederatedSession(sim, store_kind=cfg.store, engine=cfg.engine,
                               encode_group=cfg.encode_group,
                               slice_dtype=cfg.slice_dtype)
    record = session.run_stage()
    suite.record = record
    suite.session = session

    missing = [v for v in victims if v not in record.plan.clients]
    if missing:
        raise ValueError(f"victims {missing} did not participate in the "
                         f"trained stage (clients: {record.plan.clients}); "
                         "pick victims via predict_stage_victim(cfg)")

    for probe in probes:
        probe.prepare(suite)

    kept: Dict[str, Dict[int, object]] = {}

    def scored(name: str, framework: Optional[str], models,
               wall_s: float, cost_units: float) -> CandidateScore:
        if keep_models:
            kept[name] = models
        cand = CandidateScore(name=name, framework=framework, wall_s=wall_s,
                              cost_units=cost_units)
        for probe in probes:
            cand.metrics.update(probe.score(suite, models))
        return cand

    candidates: List[CandidateScore] = []
    if include_baseline:
        candidates.append(scored("none", None, record.shard_models, 0.0, 0.0))
    for fw in frameworks:
        res = run_unlearn(sim, fw, record, victims)
        candidates.append(scored(fw, fw, res.models, res.wall_time,
                                 res.cost_units))
    if include_oracle:
        res = run_unlearn(sim, "oracle", record, victims)
        candidates.append(scored("oracle", "oracle", res.models,
                                 res.wall_time, res.cost_units))

    return VerifyReport(
        task=cfg.task, store=cfg.store, seed=cfg.seed, victims=victims,
        n_shadows=n_shadows, n_canaries=n_canaries,
        verifiers=[p.name or type(p).__name__ for p in probes],
        candidates=candidates, models=kept,
        suite=suite if keep_models else None)
