from repro_torch.fl.simulator import FLSimulator, StageRecord, UnlearnResult  # noqa: F401
from repro_torch.fl import experiment  # noqa: F401
