from repro_torch.models.model import (  # noqa: F401
    abstract_params,
    decode_fn,
    init_cache,
    init_params,
    loss_fn,
    num_params,
    param_axes,
    predict_fn,
    prefill_fn,
    stacked_loss_fn,
    stacked_predict_fn,
)
from repro_torch.models.params import (  # noqa: F401
    NULL_CTX,
    ShardCtx,
    from_numpy_params,
    spec_for,
    to_numpy_params,
    tree_shardings,
)
