"""Pareto report — forgetting × utility × cost, per unlearning framework.

One ``CandidateScore`` per candidate model set (the ``"none"`` no-unlearn
baseline, each framework SE/FE/FR/RR, the ``"oracle"`` ground truth), each
carrying the merged metrics of every verifier that scored it plus the
serve's wall time and retraining cost.  ``VerifyReport`` aggregates them:
per-candidate gap-to-oracle, the non-dominated Pareto front over
(forgetting ↓, utility ↑, cost ↓), and JSON export (``to_json``).
(``repro.verify.report`` on torch: pure Python.)
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

# default Pareto axes: (metric, maximize?) — forgetting metrics fall, utility
# rises, retraining cost falls.  Candidates missing an axis (e.g. no canary
# verifier ran) are compared on the axes they have.
DEFAULT_AXES: Tuple[Tuple[str, bool], ...] = (
    ("mia_f1", False), ("canary_acc", False),
    ("retain_acc", True), ("cost_units", False),
)


@dataclass
class CandidateScore:
    """One candidate model set's verification scores."""
    name: str                         # "none", "SE", ..., "oracle"
    framework: Optional[str]          # FRAMEWORKS key (None for "none")
    wall_s: float
    cost_units: float
    metrics: Dict[str, float] = field(default_factory=dict)

    def axis(self, name: str) -> Optional[float]:
        """A metric by name, with the cost/wall accounting addressable as
        pseudo-metrics (the Pareto cost axis)."""
        if name == "wall_s":
            return self.wall_s
        if name == "cost_units":
            return self.cost_units
        return self.metrics.get(name)

    def to_dict(self) -> dict:
        return {"name": self.name, "framework": self.framework,
                "wall_s": self.wall_s, "cost_units": self.cost_units,
                "metrics": dict(self.metrics)}


@dataclass
class VerifyReport:
    """The forgetting-verification report for one victim scenario."""
    task: str
    store: str
    seed: int
    victims: List[int]
    n_shadows: int
    n_canaries: int
    verifiers: List[str]
    candidates: List[CandidateScore] = field(default_factory=list)
    oracle_name: str = "oracle"
    baseline_name: str = "none"
    # run_verification(keep_models=True) keeps each candidate's models and
    # the suite that scored them here; neither is exported
    models: Dict[str, Dict[int, object]] = field(default_factory=dict,
                                                 repr=False)
    suite: Optional[object] = field(default=None, repr=False)

    # -------------------------------------------------------------- accessors
    def candidate(self, name: str) -> CandidateScore:
        for c in self.candidates:
            if c.name == name:
                return c
        raise KeyError(f"no candidate {name!r}; scored: "
                       f"{[c.name for c in self.candidates]}")

    @property
    def oracle(self) -> CandidateScore:
        return self.candidate(self.oracle_name)

    def gap(self, name: str, metric: str) -> float:
        """|candidate − oracle| on one metric: the forgetting gap the
        acceptance tests bound (≈0 for a correct framework)."""
        return abs(self.candidate(name).metrics[metric]
                   - self.oracle.metrics[metric])

    def gaps(self, name: str) -> Dict[str, float]:
        oracle = self.oracle.metrics
        return {m: abs(v - oracle[m])
                for m, v in self.candidate(name).metrics.items()
                if m in oracle}

    # ----------------------------------------------------------------- pareto
    def pareto_front(self, axes: Sequence[Tuple[str, bool]] = DEFAULT_AXES
                     ) -> List[str]:
        """Names of the non-dominated candidates over ``axes`` (each a
        ``(metric, maximize?)`` pair), in report order.  A dominates B when
        A is at least as good on every shared axis and strictly better on
        one."""
        def dominates(a: CandidateScore, b: CandidateScore) -> bool:
            strictly = False
            shared = 0
            for m, maximize in axes:
                va, vb = a.axis(m), b.axis(m)
                if va is None or vb is None:
                    continue
                shared += 1
                if not maximize:
                    va, vb = -va, -vb
                if va < vb:
                    return False
                if va > vb:
                    strictly = True
            return strictly and shared > 0

        return [c.name for c in self.candidates
                if not any(dominates(o, c) for o in self.candidates
                           if o is not c)]

    # ------------------------------------------------------------------ export
    def metrics_dict(self) -> Dict[str, Dict[str, float]]:
        """The deterministic slice of the report — per-candidate metrics and
        cost units, NO wall times — for bit-reproducibility assertions
        (identical configs + seeds must produce identical dicts)."""
        return {c.name: dict(c.metrics, cost_units=c.cost_units)
                for c in self.candidates}

    def to_dict(self) -> dict:
        oracle_known = any(c.name == self.oracle_name for c in self.candidates)
        return {
            "task": self.task,
            "store": self.store,
            "seed": self.seed,
            "victims": [int(v) for v in self.victims],
            "n_shadows": self.n_shadows,
            "n_canaries": self.n_canaries,
            "verifiers": list(self.verifiers),
            "oracle": self.oracle_name if oracle_known else None,
            "pareto_front": self.pareto_front(),
            "candidates": [c.to_dict() for c in self.candidates],
            "gaps_to_oracle": ({c.name: self.gaps(c.name)
                                for c in self.candidates
                                if c.name != self.oracle_name}
                               if oracle_known else {}),
        }

    def to_json(self, **kw) -> str:
        kw.setdefault("indent", 2)
        return json.dumps(self.to_dict(), **kw)
