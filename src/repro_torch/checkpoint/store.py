"""Deprecated alias for :mod:`repro_torch.stores.store` — see the package
docstring of :mod:`repro_torch.checkpoint`."""
from repro_torch.stores.store import *  # noqa: F401,F403
from repro_torch.stores.store import _StackedRow  # noqa: F401
