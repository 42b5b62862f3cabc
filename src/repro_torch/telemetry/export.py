"""Trace exporters: Chrome/Perfetto ``trace.json``, JSONL event log, and the
human summary tree.

* ``write_chrome_trace`` — the Chrome trace-event format Perfetto loads
  directly (https://ui.perfetto.dev): one complete ("X") event per span and
  one instant ("i") event per tracer event, laid out one lane per
  placement slot/worker — spans labelled ``device=<i>`` (the service's
  jobs, ``i`` the slot index) land on a ``device-<i>`` lane, everything
  else on its recording thread's lane.  With ``annotate_costs`` the stage
  engine's ``device.stage_program`` span carries analytic FLOP and byte
  counts in its ``args``: its training steps' (``stage_cost``) and, where
  the program encodes, its encode's (``encode_cost``).  They take the
  place of the reference's ``hlo_cost_of``, whose XLA cost analysis counts
  a loop's body once, whatever its trip count.
* ``validate_chrome_trace`` — structural validation against the trace-event
  schema (required keys, phase-specific fields, numeric timestamps).
* ``write_jsonl`` — one JSON object per span, flat, for ad-hoc ``jq``-style
  analysis and the audit trail next to the Perfetto file.
* ``render_tree`` — spans aggregated by name at each nesting level with
  call counts and total wall.
"""
from __future__ import annotations

import json
from typing import Dict, List


def encode_cost(num_clients: int, num_shards: int, rounds: int,
                width: int, out_bytes: int = 4) -> dict:
    """Analytic counts of the all-rounds encode ``(C, S) @ (G, S, P)`` that
    ``coded_matmul_rounds`` runs inside the stage program: 2·G·C·S·P FLOPs,
    and the bytes it must move (the coefficients and the history read once,
    the slices written once).  This counts the encode only, not the training
    steps of the program around it."""
    c, s, g, p = (int(num_clients), int(num_shards), int(rounds),
                  int(width))
    return {"encode_flops": float(2 * g * c * s * p),
            "encode_bytes": float(4 * (c * s + g * s * p)
                                  + int(out_bytes) * g * c * p)}


def stage_cost(sim, w0, xs, ys, rounds: int) -> dict:
    """Analytic counts of the training in the stage program: G rounds of
    every model of the (S, M) stack, each ``sim.fl.local_epochs`` epochs of
    ``n // sim.local_batch`` SGD steps (the simulator's last-batch rule:
    a partial batch is dropped), with ``w0`` one client's parameters and
    xs / ys the stage's (S, M, n, ...) data.

    ``train_flops``: the steps times one client's step
    (``roofline.analysis.train_step_flops``: every matrix product forward
    and backward, plus the recurrence and window kernels' arithmetic).
    ``train_bytes``: a lower bound, the bytes each step must move — it
    reads and writes the client's parameters and optimizer state once and
    reads its batch once; activations, gradients and the round's means and
    norms are not counted."""
    from repro_torch.core.tree import tree_leaves
    from repro_torch.optim import make_optimizer
    from repro_torch.roofline.analysis import train_step_flops

    models, n = int(xs.shape[0]) * int(xs.shape[1]), int(xs.shape[2])
    bs = sim.local_batch
    steps = models * int(rounds) * sim.fl.local_epochs * (n // bs)
    per_step = train_step_flops(sim.cfg, bs, tuple(xs.shape[3:]))["total"]
    # one client's fp32 parameters and its optimizer's moments, in bytes
    opt = make_optimizer(sim.opt)[0](w0)
    state = sum(4 * v.numel() for v in tree_leaves(w0)) + sum(
        v.numel() * v.element_size() for t in (opt.mu, opt.nu)
        if t is not None for v in tree_leaves(t))
    batch = bs * (xs[0, 0, 0].numel() * xs.element_size()
                  + ys[0, 0, 0].numel() * ys.element_size())
    return {"train_flops": float(steps * per_step),
            "train_bytes": float(steps * (2 * state + batch))}


# ---------------------------------------------------------------------------
# Chrome / Perfetto
# ---------------------------------------------------------------------------

def _lane_of(span) -> str:
    """Perfetto lane: one per placement slot for placed jobs, one per
    recording thread otherwise (the service's ``unlearn-serve`` workers each
    get a lane; the main thread gets its own)."""
    if "device" in span.labels:
        return f"device-{span.labels['device']}"
    return span.lane or "main"


def to_chrome_trace(tracer) -> dict:
    """The Perfetto-loadable trace object (see module docstring)."""
    spans = tracer.all_spans()
    lanes = sorted({_lane_of(s) for s in spans})
    # MainThread lane first so the session timeline tops the view
    lanes.sort(key=lambda x: (x != "MainThread", x))
    tid_of = {lane: i + 1 for i, lane in enumerate(lanes)}
    events: List[dict] = [
        {"name": "process_name", "ph": "M", "pid": 1, "tid": 0,
         "args": {"name": "repro"}}]
    for lane, tid in tid_of.items():
        events.append({"name": "thread_name", "ph": "M", "pid": 1,
                       "tid": tid, "args": {"name": lane}})
    for s in spans:
        args = {k: (v if isinstance(v, (bool, int, float, str)) else str(v))
                for k, v in sorted(s.labels.items())}
        if s.v0 is not None:
            args["t_virtual_s"] = s.v0
        ev = {"name": s.name, "cat": s.name.split(".", 1)[0],
              "pid": 1, "tid": tid_of[_lane_of(s)],
              "ts": round(s.t0 * 1e6, 3), "args": args}
        if s.kind == "event":
            ev.update(ph="i", s="t")
        else:
            ev.update(ph="X", dur=round(max(s.t1 - s.t0, 0.0) * 1e6, 3))
        events.append(ev)
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"producer": "repro_torch.telemetry",
                          "span_signature": tracer.signature()}}


def write_chrome_trace(tracer, path: str) -> str:
    with open(path, "w") as f:
        json.dump(to_chrome_trace(tracer), f, indent=1)
    tracer.trace_path = path
    return path


_PHASES = {"X", "B", "E", "i", "I", "M", "C", "b", "e", "n", "s", "t", "f"}


def validate_chrome_trace(obj) -> List[str]:
    """Structural validation against the Chrome trace-event schema.  Returns
    a list of findings — empty means Perfetto-loadable."""
    errors: List[str] = []
    if not isinstance(obj, dict):
        return [f"top level must be an object, got {type(obj).__name__}"]
    events = obj.get("traceEvents")
    if not isinstance(events, list):
        return ["missing/invalid 'traceEvents' array"]
    for i, ev in enumerate(events):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            errors.append(f"{where}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in _PHASES:
            errors.append(f"{where}: invalid phase {ph!r}")
            continue
        if not isinstance(ev.get("name"), str) or not ev["name"]:
            errors.append(f"{where}: missing event name")
        for key in ("pid", "tid"):
            if not isinstance(ev.get(key), int):
                errors.append(f"{where}: {key} must be an int")
        if ph == "M":
            continue                       # metadata carries no timestamp
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            errors.append(f"{where}: ts must be a non-negative number")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errors.append(f"{where}: 'X' event needs non-negative dur")
        if ph == "i" and ev.get("s") not in (None, "g", "p", "t"):
            errors.append(f"{where}: instant scope must be g/p/t")
    return errors


# ---------------------------------------------------------------------------
# JSONL event log
# ---------------------------------------------------------------------------

def write_jsonl(tracer, path: str) -> str:
    """One flat JSON object per span/event, in canonical (deterministic
    tree) order, wall and virtual clocks side by side."""
    with open(path, "w") as f:
        for s in tracer.all_spans():
            row = {"name": s.name, "kind": s.kind, "lane": s.lane,
                   "t0_s": s.t0, "t1_s": s.t1, "wall_s": s.t1 - s.t0,
                   "v0_s": s.v0, "v1_s": s.v1}
            row.update({f"l_{k}": (v if isinstance(v, (bool, int, float,
                                                       str)) else str(v))
                        for k, v in sorted(s.labels.items())})
            f.write(json.dumps(row, sort_keys=True) + "\n")
    return path


# ---------------------------------------------------------------------------
# Human summary
# ---------------------------------------------------------------------------

def render_tree(tracer, max_depth: int = 8) -> str:
    """The summary view: spans aggregated by name per nesting level, with
    call counts and total wall.

    stage.train x3                 412.1 ms
      store.encode x3                8.4 ms
    service.serve x1               130.0 ms
      ...
    """
    lines: List[str] = []

    def walk(spans, depth):
        if depth >= max_depth or not spans:
            return
        groups: Dict[str, list] = {}
        for s in spans:
            groups.setdefault(s.name, []).append(s)
        for name, group in groups.items():
            total_ms = sum(s.t1 - s.t0 for s in group) * 1e3
            label = f"{'  ' * depth}{name} x{len(group)}"
            lines.append(f"{label:<48s} {total_ms:10.1f} ms")
            walk([c for s in group for c in s.children], depth + 1)

    walk(tracer.sorted_roots(), 0)
    if not lines:
        return "(no spans recorded)"
    return "\n".join(lines)
