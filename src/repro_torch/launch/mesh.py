"""Device meshes and the process worlds under them (``repro.launch.mesh``).

A mesh is a ``torch.distributed`` ``DeviceMesh`` with named dims, over a
process group of one rank a device.  ``make_production_mesh`` lays out the
reference's pod: (data=16, model=16), 256 ranks, or (pod=2, data=16,
model=16), 512; ``make_debug_mesh(data, model)`` a small one.  Both are
functions, so importing this module touches no process group.

The backend is explicit: NCCL on CUDA, gloo on the CPU (``BACKENDS``).
Nothing moves to gloo or the CPU when NCCL or the card is missing: that
raises.  ``init_world`` starts the process group of one rank from a store
(``FileStore`` or ``TCPStore`` on localhost); ``spawn(fn, world_size,
backend)`` runs ``fn(rank, world_size, *args)`` on every rank in its own
process and returns rank 0's result.  ``fake_world(world_size)`` is a
one-process world of ``world_size`` ranks whose collectives move nothing
(the ``fake`` backend of ``torch.testing``): the dry run builds production
meshes on it and traces a step's collectives.
"""
from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.models.params import MeshShape

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def parse_mesh(spec: str) -> MeshShape:
    """"16x16" -> (data, model); "2x16x16" -> (pod, data, model)."""
    sizes = tuple(int(n) for n in spec.lower().split("x"))
    names = {2: ("data", "model"), 3: ("pod", "data", "model")}
    if len(sizes) not in names or min(sizes) < 1:
        raise ValueError(f"mesh {spec!r}: expected DxM or PxDxM")
    return MeshShape(names[len(sizes)], sizes)


def mesh_name(mesh) -> str:
    return "x".join(str(n) for n in tuple(mesh.shape))


def _device_type(device_type: Optional[str]) -> str:
    dt = device_type or "cuda"
    if dt not in BACKENDS:
        raise ValueError(f"device type {dt!r}; expected one of "
                         f"{sorted(BACKENDS)}")
    return dt


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device_type: Optional[str] = None) -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the current world
    (whose size must be the mesh's), on the card unless ``device_type``
    is "cpu"."""
    return init_device_mesh(_device_type(device_type), tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(multi_pod: bool = False,
                         device_type: Optional[str] = None) -> DeviceMesh:
    """(data=16, model=16) over 256 ranks; ``multi_pod`` adds a leading
    pod=2 dim (512 ranks)."""
    shape, axes = PRODUCTION[bool(multi_pod)]
    return make_mesh(shape, axes, device_type)


def make_debug_mesh(data: int = 1, model: int = 1,
                    device_type: Optional[str] = None) -> DeviceMesh:
    """A small (data, model) mesh over a world of data * model ranks."""
    return make_mesh((data, model), ("data", "model"), device_type)


def init_world(backend: str, rank: int, world_size: int, store) -> None:
    """Start this process's rank of a world of ``world_size`` over
    ``store``.  ``backend`` is "nccl" (one CUDA card a rank: rank r uses
    card r % device_count) or "gloo"; NCCL without a card raises."""
    if backend not in BACKENDS.values():
        raise ValueError(f"backend {backend!r}; expected nccl or gloo")
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("NCCL needs a CUDA card; none is visible")
        if not dist.is_nccl_available():
            raise RuntimeError("this torch build has no NCCL")
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, rank=rank, world_size=world_size,
                            store=store)


def _rank_main(rank, world_size, backend, store_path, fn, args, queue):
    try:
        if backend == "gloo":       # the ranks share the host's cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1)
                                      // world_size))
        store = dist.FileStore(store_path, world_size)
        init_world(backend, rank, world_size, store)
        try:
            out = fn(rank, world_size, *args)
        finally:
            dist.destroy_process_group()
        if rank == 0:
            queue.put(("ok", out))
    except BaseException as e:  # noqa: BLE001 — reported to the parent
        import traceback
        queue.put(("error", f"rank {rank}: {type(e).__name__}: {e}\n"
                   f"{traceback.format_exc()[-3000:]}"))
        raise


def spawn(fn: Callable, world_size: int, backend: str, *args,
          timeout: float = 600.0):
    """Run ``fn(rank, world_size, *args)`` on ``world_size`` ranks, one
    process each, in a world over a ``FileStore``; returns rank 0's
    result (which must pickle).  A rank that raises makes ``spawn``
    raise with its error; every process is joined before it returns."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        store_path = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main,
                             args=(r, world_size, backend, store_path, fn,
                                   args, queue), daemon=True)
                 for r in range(world_size)]
        for p in procs:
            p.start()
        try:
            status, out = _first_result(queue, procs, timeout)
        finally:
            for p in procs:
                p.join(timeout=60)
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
    if status != "ok":
        raise RuntimeError(out)
    return out


def _first_result(queue, procs, timeout: float):
    """The first (status, value) a rank reports; an error when a rank
    dies without reporting or ``timeout`` seconds pass."""
    import queue as q
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            return queue.get(timeout=1.0)
        except q.Empty:
            dead = [p.exitcode for p in procs
                    if p.exitcode not in (None, 0)]
            if dead:
                try:
                    return queue.get(timeout=5.0)
                except q.Empty:
                    return "error", f"a rank exited with {dead[0]}"
    return "error", f"no rank reported within {timeout} s"


@contextlib.contextmanager
def fake_world(world_size: int):
    """A world of ``world_size`` ranks in this process (this one rank 0)
    whose collectives move nothing: for building production meshes and
    tracing a step's collectives on ``meta`` tensors.  Torn down on
    exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already running")
    dist.init_process_group("fake", rank=0, world_size=world_size,
                            store=FakeStore())
    try:
        yield
    finally:
        dist.destroy_process_group()
