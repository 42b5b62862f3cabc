from repro_torch.core import coding, sharding, theory, unlearning  # noqa: F401
from repro_torch.core.baselines import FRAMEWORKS, Framework  # noqa: F401
