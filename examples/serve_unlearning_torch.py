"""Online unlearning serving demo on the PyTorch port: trace -> policy ->
placement -> report, on the CUDA card unless ``--device cpu`` is given.

Trains one coded-sharded stage, generates a seeded bursty request stream
with hot-client skew and per-request SLAs, and serves it three ways —
sequential FIFO on one slot, batch-window coalescing and deadline-aware
SLA admission on every slot (``DevicePlacement``: a worker thread and, on
the card, a CUDA stream each; one slot a card by default) — printing each
run's latency ledger in the lines of ``examples/serve_unlearning.py``.

    PYTHONPATH=src python examples/serve_unlearning_torch.py \
        [--requests 6] [--deadline 20] [--device cpu]
"""
import argparse

from repro_torch.fl.experiment import ScenarioConfig, build_session
from repro_torch.service import (DevicePlacement, UnlearningService,
                                 bursty_trace, single_device_placement)


def config(**overrides) -> ScenarioConfig:
    """The reference example's scenario (``overrides`` cut it for tests)."""
    base = dict(task="classification", num_clients=16, clients_per_round=12,
                num_shards=4, local_epochs=3, global_rounds=4,
                samples_per_client=60, image_size=12, test_n=100,
                store="coded")
    base.update(overrides)
    return ScenarioConfig(**base)


def run(cfg: ScenarioConfig, requests: int = 6, deadline: float = 20.0,
        device=None, init_fn=None) -> dict:
    """Train one stage and serve one bursty trace under each policy;
    returns the trace, each serve's label, ``ServiceReport`` and the
    session results it added, and the slots of the all-slot placement."""
    session, _test = build_session(cfg, device=device, init_fn=init_fn)
    dev = session.sim.device
    record = session.run_stage()
    trace = bursty_trace(record.plan.clients, n=requests, burst_rate=2.0,
                         mean_burst=3.0, seed=0, skew=1.5, deadline=deadline,
                         rounds=cfg.global_rounds)

    def every_slot():
        return DevicePlacement(devices=None if dev.type == "cuda"
                               else [dev])
    configs = [
        ("fifo / 1 device", "fifo", {}, single_device_placement(dev)),
        ("window(1s) / all devices", "window", {"width": 1.0},
         every_slot()),
        ("sla / all devices", "sla",
         {"default_deadline": deadline, "est_serve": 2.0, "max_hold": 1.0},
         every_slot()),
    ]
    slots = len(configs[1][3].devices)
    serves = []
    for label, policy, opts, placement in configs:
        with placement:
            n0 = len(session.report.stages[-1].unlearn)
            service = UnlearningService(session, policy=policy,
                                        policy_opts=opts,
                                        placement=placement)
            report = service.serve(trace)
            serves.append({"label": label, "report": report,
                           "results": session.report.stages[-1]
                           .unlearn[n0:]})
    return {"record": record, "trace": trace, "serves": serves,
            "slots": slots}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--deadline", type=float, default=20.0)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    cfg = config()
    out = run(cfg, args.requests, args.deadline, device=args.device)

    print(f"== train: {cfg.num_shards} isolated shards, coded store, "
          f"{out['slots']} device(s) ==")
    print(f"== workload: {args.requests} bursty erasure requests, "
          f"hot-client skew, {args.deadline:.0f}s SLA ==")
    for r in out["trace"]:
        print(f"   t={r.t:6.2f}s  client(s) {list(r.clients)}")
    for serve in out["serves"]:
        report = serve["report"]
        print(f"== {serve['label']} ==")
        print(f"   wall={report.serve_wall:.2f}s  batches="
              f"{report.num_batches}  throughput="
              f"{report.throughput:.2f} req/s  p50={report.p50:.2f}s  "
              f"p95={report.p95:.2f}s  p99={report.p99:.2f}s  "
              f"sla_hit={report.sla_hit_rate}")
        for e in report.entries:
            devs = ",".join(str(d) for d in e.devices) or "-"
            print(f"   req {e.rid}: queue={e.queue_wait:5.2f}s "
                  f"batch={e.batch_wait:5.2f}s "
                  f"retrain={e.retrain_wall:5.2f}s latency={e.latency:5.2f}s "
                  f"jobs={e.n_jobs} dev[{devs}] "
                  f"{'OK' if e.sla_met else 'LATE'}")
    return out


if __name__ == "__main__":
    main()
