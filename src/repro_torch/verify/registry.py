"""Verifier registry — forgetting probes behind the same registry idiom as
``STORES`` / ``FRAMEWORKS`` / ``TASKS`` / ``FAMILIES`` / ``PARTITIONERS``.

A ``ForgettingVerifier`` measures ONE axis of the forgetting-vs-utility
Pareto report for every candidate model set (no-unlearn baseline, each
unlearning framework, the retrain oracle).  It gets three hooks around the
victim scenario's lifecycle:

* ``plant(suite)``   — before training: mutate the victim clients' data
                       (canary injection) or precompute nothing.
* ``prepare(suite)`` — after the victim stage trained: build whatever the
                       scoring needs once (train the shadow-model attack,
                       stack the retained-client eval split).
* ``score(suite, models)`` — evaluate one candidate model set, returning a
                       flat ``{metric: value}`` dict merged into that
                       candidate's ``CandidateScore``.

Registered probes: ``shadow-mia`` (attack F1), ``canary`` (memorization
collapse), ``utility`` (retained/test accuracy — forgetting that destroys
retained-client utility is damage, not unlearning).  A third-party probe is
one subclass + ``@register_verifier`` away from appearing in every
``VerifyReport``.  (``repro.verify.registry`` on torch: pure Python.)
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Type


class ForgettingVerifier:
    """Base class for forgetting probes.  Subclass, implement ``score`` (and
    optionally ``plant``/``prepare``), register with
    ``@register_verifier(name, *aliases)``."""

    name: str = ""

    # ------------------------------------------------------------ lifecycle
    def plant(self, suite) -> None:
        """Pre-training hook: may mutate ``suite.sim.client_data`` for the
        suite's victim clients (e.g. canary injection).  Default: no-op."""

    def prepare(self, suite) -> None:
        """Post-training hook: one-time setup against the trained victim
        stage (``suite.record``) before candidates are scored."""

    def score(self, suite, models: Dict[int, object]) -> Dict[str, float]:
        """Score one candidate model set (a shard-model dict, or ``{0: w}``
        for federation-level frameworks).  Returns ``{metric: value}``."""
        raise NotImplementedError


VERIFIERS: Dict[str, Type[ForgettingVerifier]] = {}


def register_verifier(*names: str):
    """Class decorator registering a ``ForgettingVerifier`` under ``names``
    (the first is canonical)."""
    if not names:
        raise ValueError("register_verifier needs at least one name")

    def deco(cls: Type[ForgettingVerifier]) -> Type[ForgettingVerifier]:
        cls.name = names[0]
        for n in names:
            VERIFIERS[n] = cls
        return cls
    return deco


def get_verifier(name: str, **kwargs) -> ForgettingVerifier:
    """Resolve a registered verifier, with constructor ``kwargs`` applied."""
    try:
        cls = VERIFIERS[name]
    except KeyError:
        raise ValueError(f"unknown verifier {name!r}; registered: "
                         f"{sorted(VERIFIERS)}") from None
    return cls(**kwargs)


def resolve_verifiers(specs: Iterable) -> List[ForgettingVerifier]:
    """Accept registered names, ``ForgettingVerifier`` classes, or instances
    (mixed freely) and return instances."""
    out: List[ForgettingVerifier] = []
    for spec in specs:
        if isinstance(spec, ForgettingVerifier):
            out.append(spec)
        elif isinstance(spec, type) and issubclass(spec, ForgettingVerifier):
            out.append(spec())
        else:
            out.append(get_verifier(spec))
    return out
