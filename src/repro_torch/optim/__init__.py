from repro_torch.optim.optimizers import OptState, make_optimizer  # noqa: F401
