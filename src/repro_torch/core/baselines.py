"""Baseline framework descriptors (paper Sec 5.1), ``repro.core.baselines``
unchanged: the registry and metadata benchmarks and docs read.  The
algorithms run in ``repro_torch.fl.experiment.frameworks``.

  FR  FedRetrain   — retrain from scratch on retained clients (provable,
                     no storage, slowest). [Liu et al. 2021]
  FE  FedEraser    — calibrated retraining from full central storage of every
                     client's per-round parameters (provable, huge storage).
                     [Liu et al. 2021]
  RR  RapidRetrain — retraining accelerated with a diagonal empirical Fisher
                     preconditioner (unprovable). [Liu et al. 2022]
  SE  ShardEraser  — OURS: stage-based isolated sharding + coded storage
                     (provable at shard granularity, minimal server storage).
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Framework:
    key: str
    name: str
    provable: bool
    uses_storage: bool
    sharded: bool
    coded: bool
    retrain_epoch_scale: float   # local epochs used in retraining = L * scale


FRAMEWORKS = {
    "FR": Framework("FR", "FedRetrain", True, False, False, False, 1.0),
    "FE": Framework("FE", "FedEraser", True, True, False, False, 0.5),
    "RR": Framework("RR", "RapidRetrain", False, False, False, False, 0.5),
    "SE": Framework("SE", "ShardEraser (ours)", True, True, True, True, 0.5),
    "SE-uncoded": Framework("SE-uncoded", "ShardEraser (uncoded)", True, True,
                            True, False, 0.5),
}
