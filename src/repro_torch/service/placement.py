"""Slot placement for the online service's shard-retraining jobs
(``repro.service.placement`` on torch).

``DevicePlacement`` holds a list of **slots**, one per entry of ``devices``
(``torch.device``s).  Each slot has its own worker thread and, on CUDA, its
own ``torch.cuda.Stream``, so ``devices=[torch.device("cuda")] * 4`` gives
four slots on one card, and ``devices=["cpu"] * 4`` four CPU slots in this
process.  Jobs are assigned to slots round-robin (reset per serve) and
routed to the slot's worker without blocking the submitting thread.

How a job crosses streams (``submit`` + ``run``):

1. ``submit`` records an event on the submitting thread's current stream:
   everything the job reads that was enqueued before it (the trained
   session's tensors, the stored slices) is ordered before that event.
2. ``run`` enters ``torch.cuda.stream(slot stream)``, makes the stream wait
   on that event, and runs the job body there: the body's kernels (the
   store's decode through ``coded_matmul``, eq. 3 through ``calibrate``)
   and allocations belong to the slot's stream.
3. The worker synchronizes the slot's stream before the job's result is
   handed to the ledger (the counterpart of ``jax.block_until_ready``).
4. Every tensor of the result is marked ``record_stream`` for the
   submitting thread's stream, where the session uses it next, so the
   caching allocator does not hand its memory to the slot's next job while
   that stream may still read it.

On the CPU a slot is just its worker thread.
"""
from __future__ import annotations

import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, List, Optional, Sequence

import torch

from repro_torch.core.tree import tree_leaves


def _cuda_devices() -> List[torch.device]:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass devices=['cpu'] (or "
            "['cpu'] * n for n slots) to place jobs on the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _as_device(d) -> torch.device:
    dev = torch.device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class _Ticket:
    """What ``submit`` records on the submitting thread: one event per CUDA
    device of the placement, and that thread's stream on each (where the
    job's result is consumed)."""

    __slots__ = ("events", "consumers")

    def __init__(self, devices: Sequence[torch.device]):
        self.events, self.consumers = {}, {}
        for dev in {d for d in devices if d.type == "cuda"}:
            stream = torch.cuda.current_stream(dev)
            ev = torch.cuda.Event()
            ev.record(stream)
            self.events[dev] = ev
            self.consumers[dev] = stream


class DevicePlacement:
    """Round-robin job -> slot assignment plus one worker per slot.

    ``devices`` defaults to every CUDA device, one slot each (raises when
    there is no card).
    """

    def __init__(self, devices: Optional[Sequence] = None):
        self.devices: List[torch.device] = (
            [_as_device(d) for d in devices] if devices
            else _cuda_devices())
        if not self.devices:
            raise ValueError("DevicePlacement needs at least one device")
        self._rr = 0
        self._lock = threading.Lock()
        self._pools: Optional[List[ThreadPoolExecutor]] = None
        self._streams: dict = {}
        self._local = threading.local()
        self._submitted = 0
        self._unhealthy: set = set()

    # ------------------------------------------------------------ assignment
    @property
    def num_devices(self) -> int:
        return len(self.devices)

    @property
    def max_workers(self) -> int:
        """One worker per slot (the reference's report key)."""
        return len(self.devices)

    def reset_assignment(self) -> None:
        """Restart the round-robin cursor — the engine calls this at the top
        of every ``serve`` so slot assignment is a deterministic function of
        the dispatch plan."""
        with self._lock:
            self._rr = 0

    def assign(self) -> int:
        """Next slot index for a job: round-robin, reset per serve."""
        with self._lock:
            idx = self._rr % len(self.devices)
            self._rr += 1
            return idx

    def device_of(self, index: int) -> torch.device:
        return self.devices[index % len(self.devices)]

    def stream_of(self, index: int) -> Optional["torch.cuda.Stream"]:
        """The slot's own CUDA stream (made at first use); None on the CPU."""
        slot = index % len(self.devices)
        dev = self.devices[slot]
        if dev.type != "cuda":
            return None
        with self._lock:
            stream = self._streams.get(slot)
            if stream is None:
                stream = self._streams[slot] = torch.cuda.Stream(dev)
        return stream

    # ---------------------------------------------------------------- health
    def mark_unhealthy(self, index: int) -> None:
        """Flag a slot as failed.  ``assign`` keeps routing round-robin over
        ALL slots — the initial dispatch plan stays a deterministic function
        of the trace even under faults — and only ``reassign`` (the retry
        path) avoids unhealthy slots."""
        with self._lock:
            self._unhealthy.add(index % len(self.devices))
        from repro_torch.telemetry import get_tracer
        tr = get_tracer()
        if tr.enabled:
            tr.event("placement.unhealthy",
                     device=index % len(self.devices))
            tr.metrics.counter("placement.marked_unhealthy").inc()

    def reset_health(self) -> None:
        """Clear fault state — called at the top of every serve."""
        with self._lock:
            self._unhealthy.clear()

    def reassign(self, avoid: int) -> int:
        """Deterministic re-dispatch target after a slot fault: the first
        healthy slot after ``avoid``; ``avoid`` itself when every slot is
        unhealthy (the caller's bounded-retry abort path still ends)."""
        with self._lock:
            n = len(self.devices)
            for step in range(1, n + 1):
                idx = (avoid + step) % n
                if idx not in self._unhealthy:
                    return idx
            return avoid % n

    # -------------------------------------------------------------- dispatch
    def submit(self, fn: Callable, *args, slot: int = 0, **kw) -> Future:
        """Run ``fn(*args, **kw)`` on the worker of ``slot``.  Records the
        submitting thread's ticket (see the module docstring), which ``run``
        inside the job orders its slot stream after."""
        with self._lock:
            if self._pools is None:
                self._pools = [ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix=f"unlearn-serve-{i}")
                    for i in range(len(self.devices))]
            pool = self._pools[slot % len(self.devices)]
            self._submitted += 1
        ticket = _Ticket(self.devices)

        def job():
            self._local.ticket = ticket
            try:
                return fn(*args, **kw)
            finally:
                self._local.ticket = None
        return pool.submit(job)

    def run(self, index: int, body: Callable):
        """Run ``body(device)`` for slot ``index`` on the calling worker:
        on CUDA inside the slot's stream, after the job's submission event,
        then wait for the stream and mark every tensor of the result for
        the submitting thread's stream."""
        dev = self.device_of(index)
        stream = self.stream_of(index)
        if stream is None:
            return body(dev)
        ticket = getattr(self._local, "ticket", None)
        with torch.cuda.stream(stream):
            if ticket is not None and dev in ticket.events:
                stream.wait_event(ticket.events[dev])
            out = body(dev)
        stream.synchronize()
        consumer = (ticket.consumers[dev]
                    if ticket is not None and dev in ticket.consumers
                    else torch.cuda.default_stream(dev))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.is_cuda:
                t.record_stream(consumer)
        return out

    def shutdown(self):
        """Idempotent and thread-safe: the workers are detached under the
        lock, torn down outside it, and later calls are no-ops."""
        with self._lock:
            pools, self._pools = self._pools, None
        for pool in pools or ():
            pool.shutdown(wait=True)

    # ------------------------------------------------------- context manager
    def __enter__(self) -> "DevicePlacement":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        """Always shut the workers down — a serve raising mid-flight must
        not leak threads."""
        self.shutdown()
        return False

    def describe(self) -> dict:
        with self._lock:
            unhealthy = sorted(self._unhealthy)
        return {"devices": [str(d) for d in self.devices],
                "num_devices": self.num_devices,
                "max_workers": self.max_workers,
                "jobs_submitted": self._submitted,
                "unhealthy": unhealthy}


def single_device_placement(device=None) -> DevicePlacement:
    """The sequential baseline: one slot, one worker — jobs execute in
    submission order, bit-identical to the synchronous session path.
    ``device`` defaults to the first CUDA device."""
    devices = [device] if device is not None else _cuda_devices()[:1]
    return DevicePlacement(devices=devices)
