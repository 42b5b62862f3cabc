"""Unified telemetry: span tracing, metrics, Perfetto export, audit chain
(``repro.telemetry`` on torch; host-side, with the same span names and
labels, except that the stage engine's program span is
``device.stage_program``).

The single entry point every instrumented layer uses::

    from repro_torch.telemetry import get_tracer

    with get_tracer().span("stage.train", stage=k, engine="stage") as sp:
        ...
        sp.annotate(cost_units=cost)

``get_tracer()`` returns a no-op tracer until ``configure(enabled=True)``
installs a recording one — the hot path pays nothing when disabled.  See
``tracer`` (spans, dual clocks, determinism), ``metrics`` (registry),
``export`` (Perfetto/JSONL/summary, the stage program's analytic
training and encode counts) and ``audit``
(hash-chained unlearning event log).
"""
from repro_torch.telemetry.audit import (
    GENESIS,
    AuditChainError,
    AuditLog,
    chain_hash,
    journal_chain,
    verify_chain,
    verify_journal,
)
from repro_torch.telemetry.export import (
    encode_cost,
    render_tree,
    stage_cost,
    to_chrome_trace,
    validate_chrome_trace,
    write_chrome_trace,
    write_jsonl,
)
from repro_torch.telemetry.metrics import MetricsRegistry, NullMetrics
from repro_torch.telemetry.tracer import (
    NULL_TRACER,
    NullTracer,
    Span,
    Tracer,
    configure,
    get_tracer,
    set_tracer,
)

__all__ = [
    "GENESIS",
    "AuditChainError",
    "AuditLog",
    "chain_hash",
    "journal_chain",
    "verify_chain",
    "verify_journal",
    "encode_cost",
    "render_tree",
    "stage_cost",
    "to_chrome_trace",
    "validate_chrome_trace",
    "write_chrome_trace",
    "write_jsonl",
    "MetricsRegistry",
    "NullMetrics",
    "NULL_TRACER",
    "NullTracer",
    "Span",
    "Tracer",
    "configure",
    "get_tracer",
    "set_tracer",
]
