"""Scenario runner: one config -> simulator -> multi-stage session -> report
(``repro.fl.experiment.scenario`` on torch).

``ScenarioConfig`` names the task (``TASKS``), the model family
(``FAMILIES``), the client partitioner (``PARTITIONERS``), the store kind,
the engine, the stage count and the unlearning request schedule; every
registry key is validated at construction.  ``build_simulator``,
``build_session`` and ``run_scenario`` run on the CUDA card unless given
``device="cpu"``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

from repro_torch.configs import FLConfig, OptimizerConfig
from repro_torch.core.coding import as_dtype
from repro_torch.data.federated import get_partitioner
from repro_torch.fl.experiment.frameworks import FRAMEWORKS
from repro_torch.fl.experiment.session import (FederatedSession,
                                               RequestSchedule, SessionReport)
from repro_torch.fl.experiment.stage import ENGINES
from repro_torch.fl.families import get_model_family
from repro_torch.fl.simulator import FLSimulator
from repro_torch.fl.tasks import get_task
from repro_torch.stores.store import STORES

InitFn = Optional[Callable[[int], dict]]


@dataclass
class ScenarioConfig:
    """One experiment scenario (defaults = the reference's CPU scale)."""
    # task / model / data — registry keys (TASKS / FAMILIES / PARTITIONERS)
    task: str = "classification"
    model: str = ""                   # "" -> the task's default family
    partitioner: str = "iid"
    partitioner_kwargs: Dict[str, Any] = field(default_factory=dict)
    seed: int = 0
    samples_per_client: int = 80
    image_size: int = 14
    noise: float = 0.25
    seq_len: int = 48
    test_n: int = 400
    # federation
    num_clients: int = 20
    clients_per_round: int = 12
    num_shards: int = 4
    local_epochs: int = 4
    global_rounds: int = 6
    retrain_ratio: float = 2.0
    # optimizer (None -> per-family/per-task default)
    opt_name: str = "sgd"
    lr: Optional[float] = None
    local_batch: Optional[int] = None
    # orchestration
    store: str = "coded"
    store_options: Dict[str, Any] = field(default_factory=dict)
    engine: str = "fused"                # "stage" | "fused"
    encode_group: Optional[int] = None
    slice_dtype: Optional[Any] = None
    num_stages: int = 1
    schedule: Optional[RequestSchedule] = None
    batch_requests: bool = False         # merge requests due after each stage
    strict_schedule: bool = False        # raise on never-served requests

    def __post_init__(self):
        task = get_task(self.task)           # raises listing TASKS
        self.task = task.name
        if not self.model:
            self.model = task.default_family
        family = get_model_family(self.model)  # raises listing FAMILIES
        self.model = family.name
        if family.task != task.kind:
            raise ValueError(
                f"model family {self.model!r} plays task {family.task!r}, "
                f"not {task.name!r}")
        get_partitioner(self.partitioner, **self.partitioner_kwargs)
        if self.store not in STORES:
            raise ValueError(f"unknown store {self.store!r}; registered: "
                             f"{sorted(STORES)}")
        if self.engine not in ENGINES:
            raise ValueError(f"unknown engine {self.engine!r}; use one of "
                             f"{ENGINES}")
        if self.schedule is not None:
            for r in self.schedule.requests:
                if r.framework not in FRAMEWORKS:
                    raise ValueError(
                        f"scheduled request uses unknown unlearning "
                        f"framework {r.framework!r}; registered: "
                        f"{sorted(FRAMEWORKS)}")
        if self.clients_per_round > self.num_clients:
            raise ValueError(
                f"clients_per_round={self.clients_per_round} exceeds "
                f"num_clients={self.num_clients}")
        if self.num_shards < 1 or self.clients_per_round % self.num_shards:
            raise ValueError(
                f"num_shards={self.num_shards} must divide the "
                f"clients_per_round={self.clients_per_round} clients sampled "
                f"per stage")
        as_dtype(self.slice_dtype)           # raises on a non-dtype

    def fl_config(self) -> FLConfig:
        return FLConfig(num_clients=self.num_clients,
                        clients_per_round=self.clients_per_round,
                        num_shards=self.num_shards,
                        local_epochs=self.local_epochs,
                        global_rounds=self.global_rounds,
                        retrain_ratio=self.retrain_ratio)

    @classmethod
    def paper_full(cls, **overrides) -> "ScenarioConfig":
        """The paper's full setting (100 clients, G=30, L=10)."""
        base = dict(num_clients=100, clients_per_round=20, num_shards=4,
                    local_epochs=10, global_rounds=30, samples_per_client=100,
                    image_size=28, seq_len=64, test_n=1000)
        base.update(overrides)
        return cls(**base)


TestData = Tuple[np.ndarray, np.ndarray]


def build_simulator(cfg: ScenarioConfig, device=None,
                    init_fn: InitFn = None) -> Tuple[FLSimulator, TestData]:
    """The paper-protocol simulator + held-out test set for a scenario."""
    task = get_task(cfg.task)
    family = get_model_family(cfg.model)
    model_cfg = family.build(cfg)
    partition = get_partitioner(cfg.partitioner, **cfg.partitioner_kwargs)
    clients, test = task.build_data(cfg, model_cfg, partition)
    opt = OptimizerConfig(name=cfg.opt_name,
                          lr=cfg.lr or family.default_lr or task.default_lr,
                          grad_clip=0.0)
    sim = FLSimulator(model_cfg, cfg.fl_config(), clients, task=task,
                      opt_cfg=opt,
                      local_batch=(cfg.local_batch or family.default_batch
                                   or task.default_batch),
                      seed=cfg.seed, device=device, init_fn=init_fn)
    return sim, test


def build_session(cfg: ScenarioConfig, device=None, init_fn: InitFn = None
                  ) -> Tuple[FederatedSession, TestData]:
    """Simulator wrapped in a session configured from the scenario."""
    sim, test = build_simulator(cfg, device=device, init_fn=init_fn)
    session = FederatedSession(sim, store_kind=cfg.store, engine=cfg.engine,
                               encode_group=cfg.encode_group,
                               slice_dtype=cfg.slice_dtype,
                               batch_requests=cfg.batch_requests,
                               strict_schedule=cfg.strict_schedule,
                               store_options=cfg.store_options)
    return session, test


def run_scenario(cfg: ScenarioConfig, device=None,
                 init_fn: InitFn = None) -> SessionReport:
    """Execute the scenario: K stages with the scheduled unlearning stream."""
    session, _test = build_session(cfg, device=device, init_fn=init_fn)
    return session.run(cfg.num_stages, schedule=cfg.schedule)
