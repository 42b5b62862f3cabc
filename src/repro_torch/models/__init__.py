from repro_torch.models.model import (  # noqa: F401
    init_params,
    loss_fn,
    predict_fn,
    stacked_loss_fn,
    stacked_predict_fn,
)
from repro_torch.models.params import (  # noqa: F401
    from_numpy_params,
    to_numpy_params,
)
