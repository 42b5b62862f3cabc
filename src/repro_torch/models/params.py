"""Parameter initialization, the logical axes of the parameters and
their layout on a device mesh, and the bridge to the reference's weights.

The init rules are ``repro.models.params.RealInit``'s: ``normal`` leaves
draw N(0, 1) * scale / sqrt(fan_in), with fan_in the product of the first
``in_dims`` dims (the last dim for vectors); ``uniform`` leaves draw
U[0, scale); ``zeros``, ``ones`` and ``constant`` (= scale) leaves are
filled.
The draws come from a ``torch.Generator``, so they follow the same
distribution as ``jax.random`` but not its bits; a run that needs the
reference's exact weights passes them in through ``from_numpy_params``.

The init code calls ``param(fac, shape, axes, ...)``, naming the logical
axis of each dim (``embed``, ``heads``, ``mlp``, ``vocab``, ...); a
factory's ``param(shape, init=..., ...)`` makes the leaf: ``RealInit``
draws it, ``ShapeOnly`` gives an empty ``meta`` tensor (shape and dtype,
no memory; the dry run's), and ``AxesOnly``, which reads the axes
(``reads_axes``), the tuple of axis names (``param_axes``).

``spec_for`` maps a leaf's logical axes onto a mesh's named dims under a
rule table, greedily and divisibility-checked, as the reference's does; it
returns the reference's ``PartitionSpec`` as a tuple (a mesh-dim name, a
tuple of names, or None a dim).  ``spec_to_placements`` turns it into
DTensor placements, one a mesh dim (``Shard(d)`` or ``Replicate()``);
``distribute_tree`` / ``gather_tree`` carry a tree onto a
``torch.distributed`` ``DeviceMesh`` and back.  The mesh here is a
``DeviceMesh`` or a ``MeshShape`` (names and sizes without devices or a
process group, enough for specs, placements and local shapes).

``ShardCtx(mesh, rules)`` is the model's sharding context, the reference's
``models.transformer.ShardCtx``: ``constrain(x, axes)`` redistributes an
activation to ``spec_for``'s placements (the reference's
``with_sharding_constraint``), ``run_local`` runs a kernel on each rank's
local shards; with ``mesh`` None both do nothing but call through.
"""
from __future__ import annotations

import contextlib
from typing import Dict, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.experimental import local_map

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


Axes = Tuple[Optional[str], ...]


class RealInit:
    """Draws real leaves from one CPU generator: the port's counterpart of
    ``repro.models.params.RealInit`` (without its per-path key folding)."""

    def __init__(self, gen: torch.Generator):
        self.gen = gen

    def param(self, shape: Tuple[int, ...], init: str = "normal",
              scale: float = 1.0, in_dims: int = 1,
              fan_in: Optional[int] = None) -> torch.Tensor:
        return draw(self.gen, tuple(shape), init, scale, in_dims, fan_in)


class AxesOnly:
    """Leaves as their logical-axis tuples (``param_axes``)."""
    reads_axes = True

    def param(self, shape: Tuple[int, ...], axes: Axes, init: str = "normal",
              scale: float = 1.0, in_dims: int = 1,
              fan_in: Optional[int] = None) -> Axes:
        assert len(axes) == len(shape), (shape, axes)
        return tuple(axes)


def param(fac, shape: Tuple[int, ...], axes: Axes, **kw):
    """``fac.param(shape, **kw)``, with the dims' logical ``axes`` passed
    on to a factory that reads them (``reads_axes``)."""
    if getattr(fac, "reads_axes", False):
        return fac.param(shape, tuple(axes), **kw)
    return fac.param(shape, **kw)


class ShapeOnly:
    """Leaves as empty ``meta`` tensors of ``dtype``: the tree's keys,
    shapes and bytes without allocating or drawing anything."""

    def __init__(self, dtype=torch.float32):
        self.dtype = dtype

    def param(self, shape: Tuple[int, ...], init: str = "normal",
              scale: float = 1.0, in_dims: int = 1,
              fan_in: Optional[int] = None) -> torch.Tensor:
        return torch.empty(tuple(shape), dtype=self.dtype, device="meta")


# ---------------------------------------------------------------------------
# logical axes -> mesh dims -> placements
# ---------------------------------------------------------------------------

class MeshShape(NamedTuple):
    """A mesh's dim names and sizes without devices or a process group:
    ``DeviceMesh``'s ``mesh_dim_names`` and ``shape``, which is all
    ``spec_for``, ``spec_to_placements`` and ``local_shape`` read."""
    mesh_dim_names: Tuple[str, ...]
    shape: Tuple[int, ...]


def mesh_sizes(mesh) -> Dict[str, int]:
    """{dim name: size} of a ``DeviceMesh`` or ``MeshShape``."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


Spec = Tuple[Union[None, str, Tuple[str, ...]], ...]


def spec_for(shape: Sequence[int], axes: Axes, rules: Dict[str, tuple],
             mesh) -> Spec:
    """Greedy, divisibility-checked mapping of logical axes to mesh dims.

    ``rules[logical]`` is an ordered tuple of candidates; each candidate is
    a mesh-dim name or a tuple of names (the dim shards over their
    product).  The first candidate that (a) divides the dim and (b) does
    not reuse a mesh dim already taken by another dim of this tensor wins.
    Dims with no viable candidate stay replicated (None); trailing Nones
    are trimmed, as the reference's ``PartitionSpec`` is built."""
    used = set()
    out = []
    sizes = mesh_sizes(mesh)
    for dim, logical in zip(shape, axes):
        assigned = None
        for cand in rules.get(logical, ()):
            if cand is None:
                continue
            names = (cand,) if isinstance(cand, str) else tuple(cand)
            if any(n in used or n not in sizes for n in names):
                continue
            total = int(np.prod([sizes[n] for n in names]))
            if dim % total == 0 and dim >= total:
                assigned = cand if isinstance(cand, str) else tuple(cand)
                used.update(names)
                break
        out.append(assigned)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _spec_dims(entry) -> Tuple[str, ...]:
    return () if entry is None else ((entry,) if isinstance(entry, str)
                                     else tuple(entry))


def spec_to_placements(spec: Spec, mesh) -> tuple:
    """One placement a mesh dim: ``Shard(d)`` where tensor dim d names it,
    else ``Replicate()``.  A tensor dim over several mesh dims (e.g.
    ("pod", "data")) shards over each, the first the major one, as the
    product is laid out; they must come in the mesh's own order.  A mesh
    dim of size 1 cuts nothing and is ``Replicate()`` (a size-1 tensor dim
    "sharded" over it would block every view that folds it)."""
    names = tuple(mesh.mesh_dim_names)
    sizes = tuple(mesh.shape)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        idx = [names.index(n) for n in _spec_dims(entry)]
        if idx != sorted(idx):
            raise ValueError(f"{entry}: a multi-dim shard must follow the "
                             f"mesh's order {names}")
        for i in idx:
            if sizes[i] > 1:
                out[i] = Shard(d)
    return tuple(out)


def local_shape(shape: Sequence[int], spec: Spec, mesh) -> Tuple[int, ...]:
    """Each rank's shard of a tensor of ``shape`` laid out by ``spec``
    (``spec_for`` only assigns dims that divide evenly)."""
    sizes = mesh_sizes(mesh)
    out = list(shape)
    for d, entry in enumerate(spec):
        out[d] //= int(np.prod([sizes[n] for n in _spec_dims(entry)]))
    return tuple(out)


def tree_shardings(params_axes, params_shapes, rules, mesh):
    """A tree of placements parallel to the param tree: each leaf's
    ``spec_for`` over its logical axes, as placements on ``mesh``
    (``params_shapes``' leaves are tensors or shape tuples)."""
    def one(axes, arr):
        shape = tuple(arr.shape) if hasattr(arr, "shape") else tuple(arr)
        return spec_to_placements(spec_for(shape, axes, rules, mesh), mesh)
    return tree_map(one, params_axes, params_shapes)


# ---------------------------------------------------------------------------
# The model's sharding context
# ---------------------------------------------------------------------------

def _placed(x, mesh, placements):
    """x on ``mesh`` with ``placements``: a DTensor is redistributed (a
    no-op when it already has them); a plain tensor, the same on every
    rank, is cut into its local shard without communication."""
    if isinstance(x, DTensor):
        if tuple(x.placements) == tuple(placements):
            return x
        return x.redistribute(mesh, placements)
    return distribute_tensor(x, mesh, placements, src_data_rank=None)


@contextlib.contextmanager
def _implicit_replication():
    """``torch.distributed.tensor.experimental.implicit_replication`` that
    nests: the flag is restored on exit, not cleared (it is thread-local
    state, which the autograd engine carries to its device threads)."""
    disp = DTensor._op_dispatcher
    prev = disp._allow_implicit_replication
    disp._allow_implicit_replication = True
    try:
        yield
    finally:
        disp._allow_implicit_replication = prev


class ShardCtx:
    """Activation layouts from logical axes (the reference's ``ShardCtx``).

    ``rules`` maps a logical axis to its ordered mesh-dim candidates,
    divisibility-checked per dim (``spec_for``).  ``mesh`` None: no-op."""

    def __init__(self, mesh=None, rules: Optional[Dict[str, tuple]] = None):
        self.mesh = mesh
        self.rules = rules or {}

    def placements(self, shape: Sequence[int], axes: Axes) -> tuple:
        return spec_to_placements(spec_for(tuple(shape), axes, self.rules,
                                           self.mesh), self.mesh)

    def constrain(self, x, axes: Axes):
        """x redistributed to ``spec_for``'s placements of ``axes``."""
        if self.mesh is None or x is None:
            return x
        return _placed(x, self.mesh, self.placements(x.shape, axes))

    def place(self, x, placements):
        """x on the context's mesh with ``placements`` (``constrain`` with
        the placements given, not derived from axes)."""
        return _placed(x, self.mesh, placements)

    def scope(self):
        """The context a sharded forward and backward run in: plain
        tensors made inside the model (positions, masks, zero states) meet
        DTensors as replicated values.  A null context without a mesh."""
        if self.mesh is None:
            return contextlib.nullcontext()
        return _implicit_replication()

    def shard_offset(self, x, dim: int) -> int:
        """The global index of this rank's first element of DTensor x
        along ``dim`` (mesh dims that shard it taken major first)."""
        coord = self.mesh.get_coordinate()
        idx, parts = 0, 1
        for i, p in enumerate(x.placements):
            if isinstance(p, Shard) and p.dim == dim:
                idx = idx * self.mesh.shape[i] + coord[i]
                parts *= self.mesh.shape[i]
        return idx * (x.shape[dim] // parts)

    def run_local(self, fn, args: Sequence, axes: Sequence[Axes],
                  outs: Sequence[int]):
        """``fn(*local shards)`` on each rank, for a kernel whose work is
        independent along the dims the mesh splits (sequences, heads,
        channels).  Each arg is first constrained to its ``axes``; output i
        takes the placements of arg ``outs[i]``.  An arg left replicated
        on a mesh dim along which another arg is split gets a ``Partial``
        gradient there: each rank's gradient holds its own share of the
        work, and the sum over the dim is the whole.  Without a mesh:
        ``fn(*args)``."""
        if self.mesh is None:
            return fn(*args)
        args = [self.constrain(a, ax) for a, ax in zip(args, axes)]
        pls = [tuple(a.placements) for a in args]
        split = [any(isinstance(p[i], Shard) for p in pls)
                 for i in range(self.mesh.ndim)]
        grads = [tuple(Partial() if split[i] and isinstance(q, Replicate)
                       else q for i, q in enumerate(p)) for p in pls]
        out_pl = tuple(pls[j] for j in outs)
        return local_map(fn, out_placements=out_pl, in_placements=tuple(pls),
                         in_grad_placements=tuple(grads),
                         device_mesh=self.mesh)(*args)


NULL_CTX = ShardCtx()


def local(x):
    """This rank's shard of a DTensor; a plain tensor as it is."""
    return x.to_local() if isinstance(x, DTensor) else x


def _view_groups(old: Sequence[int], new: Sequence[int]):
    """The (old dims, new dims) groups a view maps onto each other, in
    order: equal products, each group as small as it can be."""
    groups, i, j = [], 0, 0
    while i < len(old) and j < len(new):
        gi, gj, po, pn = [i], [j], old[i], new[j]
        i, j = i + 1, j + 1
        while po != pn:
            if po < pn:
                gi.append(i)
                po *= old[i]
                i += 1
            else:
                gj.append(j)
                pn *= new[j]
                j += 1
        groups.append((gi, gj))
    return groups


def _safe_view(x, shape: Tuple[int, ...]):
    """A DTensor's view after replicating the mesh dims whose shard the
    view cannot carry (``reshape``)."""
    old = tuple(x.shape)
    sizes = tuple(x.device_mesh.shape)
    parts = {}
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard):
            parts[p.dim] = parts.get(p.dim, 1) * sizes[i]
    keep = set()
    for gi, gj in _view_groups(old, shape):
        major = next((d for d in gi if old[d] > 1), gi[0])
        first = next((d for d in gj if shape[d] > 1), gj[0])
        for d in gi:
            n = parts.get(d)
            if n is not None and d == major and (len(gj) == 1 or (
                    len(gi) == 1 and shape[first] % n == 0)):
                keep.add(d)
    pl = tuple(p if not isinstance(p, Shard) or p.dim in keep
               else Replicate() for p in x.placements)
    if pl != tuple(x.placements):
        x = x.redistribute(x.device_mesh, pl)
    return x.reshape(shape)


class _SafeReshape(torch.autograd.Function):
    """``_safe_view`` forward, and backward on the gradient."""

    @staticmethod
    def forward(ctx, x, shape):
        ctx.old = tuple(x.shape)
        return _safe_view(x, shape)

    @staticmethod
    def backward(ctx, g):
        return _safe_view(g, ctx.old), None


def reshape(x, *shape):
    """``x.reshape(*shape)``; a DTensor (and, in backward, its gradient)
    is first replicated on every mesh dim whose shard the view cannot
    carry: DTensor refuses, or mislays, a shard that is not the major
    factor of its group of dims, or that does not divide the group's
    first new dim (a flat ``heads * head_dim`` split into heads that do
    not divide the mesh dim)."""
    if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
        shape = tuple(shape[0])
    if not isinstance(x, DTensor):
        return x.reshape(*shape)
    new = list(shape)
    if -1 in new:
        known = int(np.prod([n for n in new if n != -1]))
        new[new.index(-1)] = x.numel() // max(known, 1)
    if x.requires_grad and torch.is_grad_enabled():
        return _SafeReshape.apply(x, tuple(new))
    return _safe_view(x, tuple(new))


def zero_pad(x, dim: int, before: int = 0, after: int = 0):
    """x with ``before`` and ``after`` zeros along ``dim``: ``F.pad``'s
    constant 0, and on a DTensor the same values as a concatenation,
    which DTensor lays out as x, where its ``constant_pad_nd`` rule
    returns a spec of one placement on a 2-d mesh in torch 2.11."""
    if not (before or after):
        return x
    dim = dim % x.dim()
    if not isinstance(x, DTensor):
        return torch.nn.functional.pad(
            x, (0, 0) * (x.dim() - 1 - dim) + (before, after))

    def zeros(n):
        shape = list(x.shape)
        shape[dim] = n
        return torch.zeros(shape, dtype=x.dtype, device=x.device)
    parts = ([zeros(before)] if before else []) + [x] + \
        ([zeros(after)] if after else [])
    return torch.cat(parts, dim=dim)


# ---------------------------------------------------------------------------
# Trees on a mesh, and the bridge to the reference's weights
# ---------------------------------------------------------------------------

def distribute_tree(tree, shardings, mesh):
    """Each leaf of ``tree`` (the same on every rank) as a DTensor on
    ``mesh`` with the placements of ``shardings``' leaf (a tree of the
    same keys, e.g. ``launch.shardings.param_shardings``).  Only each
    rank's own shard is kept; nothing is communicated."""
    return tree_map(lambda t, pl: _placed(t, mesh, pl), tree, shardings)


def gather_tree(tree):
    """The whole tensors of a tree of DTensors (plain leaves as they
    are): the inverse of ``distribute_tree`` (an all-gather a leaf)."""
    return tree_map(lambda t: t.full_tensor() if isinstance(t, DTensor)
                    else t, tree)


def from_numpy_params(tree, device: Optional[Device] = None, mesh=None,
                      shardings=None):
    """A tree of numpy arrays (e.g. the reference's ``init_params`` pulled
    to the host, bf16 leaves included) as a tree of tensors on ``device``,
    bit for bit: the CUDA
    card unless the caller passes ``"cpu"``.  With ``mesh`` and
    ``shardings``, each leaf is laid out on the mesh as it is made
    (``distribute_tree``; ``device`` must be the mesh's device type), so
    the device never holds more than one leaf whole."""
    dev = resolve_device(device)

    def lay(a, placements=None):
        a = np.array(a, copy=True)
        if a.dtype.name == "bfloat16":     # ml_dtypes' bf16: the same bits
            t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(a)
        t = t.to(dev)
        return t if mesh is None else _placed(t, mesh, placements)
    if mesh is None:
        return tree_map(lay, tree)
    return tree_map(lay, tree, shardings)


def to_numpy_params(tree):
    """The inverse of ``from_numpy_params`` (a mesh's leaves gathered); a
    bf16 leaf comes back widened to float32, exactly (numpy has no bf16
    of its own)."""
    def host(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return tree_map(host, gather_tree(tree))
