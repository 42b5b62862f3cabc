"""Parameter initialization and the bridge to the reference's weights.

The init rules are ``repro.models.params.RealInit``'s: ``normal`` leaves
draw N(0, 1) * scale / sqrt(fan_in), with fan_in the product of the first
``in_dims`` dims (the last dim for vectors); ``uniform`` leaves draw
U[0, scale); ``zeros``, ``ones`` and ``constant`` (= scale) leaves are
filled.
The draws come from a ``torch.Generator``, so they follow the same
distribution as ``jax.random`` but not its bits; a run that needs the
reference's exact weights passes them in through ``from_numpy_params``.

``ShapeOnly`` is the reference's factory of the same name: each leaf an
empty tensor on the ``meta`` device (shape and dtype, no memory), for the
one-card dry run.  The reference's ``AxesOnly`` (a tree of logical-axis
names), ``spec_for`` and ``tree_shardings`` map those names onto a TPU
pod's mesh axes; one card shards nothing, so they have no counterpart.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.tree import tree_map
from repro_torch.kernels import resolve_device

Device = Union[str, torch.device]


def draw(gen: torch.Generator, shape: Tuple[int, ...], init: str = "normal",
         scale: float = 1.0, in_dims: int = 1,
         fan_in: Optional[int] = None) -> torch.Tensor:
    """One float32 CPU leaf under the reference's init rules."""
    if init == "normal":
        if fan_in is None:
            fan_in = (int(np.prod(shape[:in_dims])) if len(shape) > 1
                      else max(shape[-1], 1))
        std = scale / np.sqrt(fan_in)
        return torch.randn(shape, generator=gen, dtype=torch.float32) * std
    if init == "zeros":
        return torch.zeros(shape, dtype=torch.float32)
    if init == "ones":
        return torch.ones(shape, dtype=torch.float32)
    if init == "uniform":
        return torch.rand(shape, generator=gen, dtype=torch.float32) * scale
    if init == "constant":
        return torch.full(shape, float(scale), dtype=torch.float32)
    raise ValueError(init)


class RealInit:
    """Draws real leaves from one CPU generator: the port's counterpart of
    ``repro.models.params.RealInit`` (without names or logical axes, which
    only the reference's mesh sharding reads)."""

    def __init__(self, gen: torch.Generator):
        self.gen = gen

    def param(self, shape: Tuple[int, ...], init: str = "normal",
              scale: float = 1.0, in_dims: int = 1,
              fan_in: Optional[int] = None) -> torch.Tensor:
        return draw(self.gen, tuple(shape), init, scale, in_dims, fan_in)


class ShapeOnly:
    """Leaves as empty ``meta`` tensors of ``dtype``: the tree's keys,
    shapes and bytes without allocating or drawing anything."""

    def __init__(self, dtype=torch.float32):
        self.dtype = dtype

    def param(self, shape: Tuple[int, ...], init: str = "normal",
              scale: float = 1.0, in_dims: int = 1,
              fan_in: Optional[int] = None) -> torch.Tensor:
        return torch.empty(tuple(shape), dtype=self.dtype, device="meta")


def from_numpy_params(tree, device: Optional[Device] = None):
    """A tree of numpy arrays (e.g. the reference's ``init_params`` pulled
    to the host) as a tree of tensors on ``device``, bit for bit: the CUDA
    card unless the caller passes ``"cpu"``."""
    dev = resolve_device(device)
    return tree_map(lambda a: torch.from_numpy(np.array(a, copy=True)).to(
        dev), tree)


def to_numpy_params(tree):
    """The inverse of ``from_numpy_params``."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)
