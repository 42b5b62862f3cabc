from repro_torch.optim.optimizers import (  # noqa: F401
    OptState, init_optimizer, make_optimizer)
from repro_torch.optim.fisher import diag_fisher, fisher_precondition  # noqa: F401
