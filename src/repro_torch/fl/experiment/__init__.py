"""Experiment-orchestration layer: the stores, frameworks, tasks, families
and partitioners registries, ``train_stage``, ``FederatedSession`` and
``run_scenario``."""
from repro_torch.stores.store import (ParameterStore, RoundPayload,  # noqa: F401
                                      STORES, StoreStats, make_store,
                                      register_store)
from repro_torch.data.federated import (PARTITIONERS,  # noqa: F401
                                        get_partitioner, register_partitioner)
from repro_torch.fl.experiment.frameworks import (FRAMEWORKS,  # noqa: F401
                                                  UnlearnContext,
                                                  UnlearnFramework,
                                                  get_framework,
                                                  register_framework,
                                                  run_unlearn)
from repro_torch.fl.families import (FAMILIES, ModelFamily,  # noqa: F401
                                     get_model_family, register_model_family)
from repro_torch.fl.tasks import (TASKS, TaskSpec, get_task,  # noqa: F401
                                  register_task)
from repro_torch.fl.experiment.scenario import (ScenarioConfig,  # noqa: F401
                                                build_session,
                                                build_simulator, run_scenario)
from repro_torch.fl.experiment.session import (FederatedSession,  # noqa: F401
                                               RequestSchedule, SessionReport,
                                               StageReport, UnlearnRequest)
from repro_torch.fl.experiment.stage import train_stage  # noqa: F401
from repro_torch.fl.simulator import StageRecord, UnlearnResult  # noqa: F401

# Auto-register the verification subsystem (the retrain ``oracle`` framework
# and the VERIFIERS registry).  ``repro_torch.verify`` imports only
# submodules of this package, never the package itself, so the cycle is safe
# at any import order.
import repro_torch.verify  # noqa: F401, E402
