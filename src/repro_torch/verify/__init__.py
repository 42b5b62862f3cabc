"""Forgetting verification — did the unlearning actually unlearn?

The subsystem answers with three registered probes scored against the exact
ground truth:

* ``oracle``      — per-shard retrain-from-scratch on retained data (exact
                    unlearning; registered as a framework so every entry point
                    can dispatch it);
* ``shadow-mia``  — N shadow federations calibrate a membership attack with
                    no access to the victim's labels; attack F1 on the
                    forgotten client's data is the reported metric;
* ``canary``      — seeded memorization-only examples planted into the
                    victim clients; forgetting = accuracy collapse to chance;
* ``utility``     — retained/test accuracy, the axis forgetting must not buy
                    itself with.

``run_verification`` drives one victim scenario through all of it and emits
a forgetting × utility × cost Pareto ``VerifyReport`` per framework.
(``repro.verify`` on torch, with the reference's names.)
"""
from repro_torch.verify.canary import CanaryVerifier, plant_canaries
from repro_torch.verify.oracle import RetrainOracle
from repro_torch.verify.registry import (VERIFIERS, ForgettingVerifier,
                                   get_verifier, register_verifier,
                                   resolve_verifiers)
from repro_torch.verify.report import CandidateScore, VerifyReport
from repro_torch.verify.shadow import (ShadowAttack, ShadowMIAVerifier,
                                 train_shadow_attack)
from repro_torch.verify.suite import (UtilityVerifier, VerificationSuite,
                                predict_stage_victim, run_verification)

__all__ = [
    "VERIFIERS", "ForgettingVerifier", "register_verifier", "get_verifier",
    "resolve_verifiers", "RetrainOracle", "ShadowAttack",
    "train_shadow_attack", "ShadowMIAVerifier", "CanaryVerifier",
    "plant_canaries", "UtilityVerifier", "VerificationSuite",
    "predict_stage_victim", "run_verification", "VerifyReport",
    "CandidateScore",
]
