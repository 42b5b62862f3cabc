"""Online unlearning service — event-driven request scheduling with async
dispatch over placement slots and SLA-measured serving
(``repro.service`` on torch).

The batch-replay ``FederatedSession`` serves a *fixed* schedule between
training stages; this package serves an *online stream*: seeded workload
generators produce arrival traces on a virtual clock (``workload``),
pluggable scheduling policies decide when and how requests coalesce
(``policy``: ``fifo`` / ``window`` / ``sla``), a ``DevicePlacement`` spreads
the independent shard-retraining jobs over its slots — one worker thread
and, on CUDA, one stream each, so several slots can share one card
(``placement``) — and the engine's ledger measures per-request latency
(queue wait, batch wait, retrain wall), p50/p95/p99, throughput, and SLA
hit rate (``engine``).

    trace = poisson_trace(plan.clients, n=16, rate=8.0, seed=0)
    service = UnlearningService(
        session, policy="window", policy_opts={"width": 0.5},
        placement=DevicePlacement(devices=[torch.device("cuda")] * 4))
    report = service.serve(trace)
    print(report.p95, report.throughput)
"""
from repro_torch.service.engine import (LedgerEntry,  # noqa: F401
                                        RetryPolicy, ServiceReport,
                                        UnlearningService)
from repro_torch.service.placement import (DevicePlacement,  # noqa: F401
                                           single_device_placement)
from repro_torch.service.policy import (POLICIES,  # noqa: F401
                                        BatchWindowPolicy, FIFOPolicy,
                                        Pending, SLAPolicy, SchedulingPolicy,
                                        make_policy, register_policy)
from repro_torch.service.workload import (ServiceRequest,  # noqa: F401
                                          VirtualClock, bursty_trace,
                                          client_sampler, iter_poisson_trace,
                                          iter_trace, load_trace,
                                          poisson_trace, save_trace,
                                          save_trace_jsonl, sequenced_trace,
                                          service_request_id)
