"""The port's telemetry layer on the CPU (``repro_torch.telemetry``: the
tracer, metrics, the audit chain, the exporters; the journal), against the
reference (``repro.telemetry``) on the same inputs.

Held exactly: metric snapshots, audit-chain hashes and journal bytes for
the same records, and — the anchor — one traced SE session (tests/
test_telemetry.py's workload: the tiny CNN, two stage-engine stages, a
window serve of three SE requests on one slot) in both packages, the port
from the reference's initial weights: the canonical span forests and their
signatures are equal once the reference's ``xla.stage_program`` is read as
the port's ``device.stage_program``, and the audit chains' heads are
equal.  Also the disabled tracer's overhead bound (tests/test_telemetry.py's
arithmetic, against the port's stage wall) and the analytic encode counts
the stage program's span carries under ``annotate_costs``."""
import dataclasses
import hashlib
import json
import threading
import time

import jax
import numpy as np
import pytest
import torch

import repro.telemetry as JT
import repro_torch.telemetry as TT
from repro.configs import FLConfig as JFL
from repro.configs import OptimizerConfig as JOpt
from repro.configs import get_config as jget
from repro.data import client_datasets_images, make_image_data
from repro.durability import Journal as JJournal
from repro.fl import FLSimulator as JSim
from repro.fl.experiment import FederatedSession as JSession
from repro.models import init_params as jinit
from repro.service import ServiceRequest as JRequest
from repro.service import UnlearningService as JService
from repro.service import single_device_placement as j_single
from repro_torch.configs import FLConfig, OptimizerConfig, get_config
from repro_torch.core.coding import CodingScheme
from repro_torch.durability import Journal
from repro_torch.faults import FaultPlan
from repro_torch.fl import FLSimulator
from repro_torch.fl.experiment import (FederatedSession, RequestSchedule,
                                       UnlearnRequest, train_stage)
from repro_torch.models import from_numpy_params
from repro_torch.service import (DevicePlacement, ServiceRequest,
                                 UnlearningService, VirtualClock)
from repro_torch.stores.store import CodedStore, RoundPayload

torch.set_num_threads(1)
TINY = dict(image_size=8, d_model=16, cnn_channels=(4, 4))
FL_TINY = dict(num_clients=10, clients_per_round=8, num_shards=2,
               local_epochs=2, global_rounds=3, retrain_ratio=2.0)
JCFG = dataclasses.replace(jget("cnn-paper"), **TINY)
TCFG = dataclasses.replace(get_config("cnn-paper"), **TINY)
RENAMED = {"xla.stage_program": "device.stage_program"}


def _clients():
    data = make_image_data(10 * 30, image_size=8, seed=0)
    return client_datasets_images(data, 10, iid=True)


def _jax_init(salt):
    return from_numpy_params(jax.tree.map(
        np.asarray, jinit(JCFG, jax.random.key(salt))), device="cpu")


def _tsim():
    return FLSimulator(TCFG, FLConfig(**FL_TINY), _clients(), task="image",
                       opt_cfg=OptimizerConfig(name="sgdm", lr=0.05,
                                               grad_clip=0.0),
                       local_batch=10, seed=0, device="cpu",
                       init_fn=_jax_init)


def _jsim():
    return JSim(JCFG, JFL(**FL_TINY), _clients(), task="image",
                opt_cfg=JOpt(name="sgdm", lr=0.05, grad_clip=0.0),
                local_batch=10, seed=0)


@pytest.fixture(autouse=True)
def _restore_default_tracers():
    """Both packages' process-wide tracers go back to their no-op default
    after every test."""
    yield
    TT.set_tracer(TT.NULL_TRACER)
    JT.set_tracer(JT.NULL_TRACER)


# -------------------------------------------------------------------- tracer
def test_default_is_noop():
    tr = TT.get_tracer()
    assert tr is TT.NULL_TRACER and not tr.enabled
    with tr.span("anything", label=1) as sp:
        sp.annotate(more=2)
    tr.event("instant", x=3)
    tr.metrics.counter("c").inc()
    tr.metrics.histogram("h").observe(1.0)
    assert tr.all_spans() == [] and tr.signature() == ""
    assert tr.metrics.snapshot() == {}
    assert tr.describe() == {"enabled": False}
    tr2 = TT.configure(enabled=True)
    assert TT.get_tracer() is tr2 and tr2.enabled
    assert TT.configure(enabled=False) is TT.NULL_TRACER


def _forest(m, clock_cls, extra=None):
    tr = m.Tracer()
    clock = clock_cls()
    tr.attach_clock(clock)
    clock.advance_to(0.5)
    with tr.span("service.dispatch", batch=0, clients=[3, 1]):
        clock.advance_to(1.0)
        with tr.span("service.job", device=1, shard=0, **(extra or {})):
            pass
        tr.event("fault.inject", kind="slice_corruption")
    tr.detach_clock()
    with tr.span("store.read", round=0, shard=1) as sp:
        sp.annotate(recovered=True, erased=0)
    return tr


@pytest.mark.parametrize("extra", [None, {"attempts": 2}, {"x": (1, "a")}])
def test_span_forests_sign_like_the_reference(extra):
    from repro.service import VirtualClock as JClock
    t, j = _forest(TT, VirtualClock, extra), _forest(JT, JClock, extra)
    assert t.tree() == j.tree()
    assert t.signature() == j.signature()
    assert t.span_names() == j.span_names()


def test_nesting_threads_and_wall_time_independence():
    def run(order, sleep):
        tr = TT.Tracer()
        barrier = threading.Barrier(len(order))

        def worker(i):
            barrier.wait()
            with tr.span("job", idx=i):
                time.sleep(sleep * (i + 1))

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in order]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        return tr

    a, b = run([0, 1, 2], 0.0), run([2, 1, 0], 0.002)
    assert a.signature() == b.signature()
    assert [r.labels["idx"] for r in a.sorted_roots()] == [0, 1, 2]
    tr = TT.Tracer()
    with tr.span("outer", stage=0):
        with tr.span("inner", shard=1):
            pass
        tr.event("mark", hit=True)
    kids = tr.tree()[0]["children"]
    assert [n["name"] for n in kids] == ["inner", "mark"]
    assert kids[1]["kind"] == "event"


# ------------------------------------------------------------------- metrics
def _metric_ops(reg):
    reg.counter("reads", store="coded").inc()
    reg.counter("reads", store="coded").inc(2)
    reg.gauge("depth").set(4)
    reg.gauge("depth").set(7)
    for v in range(1, 101):
        reg.histogram("lat_s", client=3).observe(v / 100)
    faults = {"injected": 5, "recovered_reads": 2, "note": "x"}
    reg.absorb_faults(faults)
    reg.absorb_faults(faults)
    for c, lat in ((0, 1.0), (0, 3.0), (7, 0.5)):
        reg.histogram("service.client_latency_s", client=c).observe(lat)
    return reg.snapshot(), reg.per_client_p99()


def test_metrics_match_reference():
    got = _metric_ops(TT.MetricsRegistry())
    assert got == _metric_ops(JT.MetricsRegistry())
    snap, p99 = got
    assert snap["counters"]["reads{store=coded}"] == 3
    assert snap["gauges"]["depth"] == 7
    assert p99[0] == pytest.approx(2.98)


# --------------------------------------------------------------------- audit
def _audit(m, journal=None):
    log = m.AuditLog(journal=journal)
    log.record("received", request_id="svc-0", clients=[7], t_virtual=0.25)
    log.record("scheduled", request_id="svc-0", batch_id=0,
               shards=[[0, 1]])
    log.record("committed", request_id="svc-0", batch_id=0,
               queue_wait_virtual_s=0.5)
    return log


def test_audit_chain_matches_reference_and_detects_tampering():
    t, j = _audit(TT), _audit(JT)
    assert t.records == j.records and t.head == j.head
    assert t.verify() == t.head != TT.GENESIS
    assert TT.chain_hash(t.records[0]["hash"], t.records[1]["event"]) == \
        t.records[1]["hash"]
    tampered = [dict(r, event=dict(r["event"])) for r in t.records]
    tampered[1]["event"]["request_id"] = "svc-999"
    for bad in (tampered, t.records[:1] + t.records[2:],
                list(reversed(t.records))):
        with pytest.raises(TT.AuditChainError):
            TT.verify_chain(bad)


def test_journal_bytes_match_reference_and_splice(tmp_path):
    tp, jp = tmp_path / "t.journal", tmp_path / "j.journal"
    t = _audit(TT, Journal(str(tp)))
    _audit(JT, JJournal(str(jp)))
    assert tp.read_bytes() == jp.read_bytes()
    resumed = TT.AuditLog(journal=Journal(str(tp)))
    assert resumed.head == t.head and len(resumed) == 3
    resumed.record("retrained", request_id="svc-1", shards=[0])
    assert resumed.verify() == resumed.head != t.head
    assert TT.verify_journal(Journal(str(tp))) == resumed.head
    assert TT.verify_journal(Journal(str(tmp_path / "none"))) is None
    # a torn tail: replay stops at the first line failing its checksum
    with open(tp, "ab") as f:
        f.write(b"deadbeef {\"seq\": 9")
    assert len(Journal(str(tp)).records()) == 4


# -------------------------------------------------------------------- export
def test_chrome_trace_validates_with_one_lane_per_slot(tmp_path):
    tr = _forest(TT, VirtualClock)
    obj = TT.to_chrome_trace(tr)
    assert TT.validate_chrome_trace(obj) == []
    lanes = {e["args"]["name"] for e in obj["traceEvents"]
             if e["name"] == "thread_name"}
    assert "device-1" in lanes
    inst = [e for e in obj["traceEvents"] if e.get("ph") == "i"]
    assert inst and all(e.get("s") == "t" for e in inst)
    path = str(tmp_path / "trace.json")
    TT.write_chrome_trace(tr, path)
    assert TT.validate_chrome_trace(json.loads(open(path).read())) == []
    assert tr.trace_path == path
    rows = TT.write_jsonl(tr, str(tmp_path / "spans.jsonl"))
    names = {json.loads(ln)["name"] for ln in open(rows)}
    assert {"service.dispatch", "service.job", "store.read"} <= names
    text = TT.render_tree(tr)
    assert "service.dispatch" in text and "service.job" in text


@pytest.mark.parametrize("bad", [
    {"traceEvents": [{"ph": "X"}]},
    {"traceEvents": [{"ph": "??", "name": "x", "pid": 0, "tid": 0,
                      "ts": 0.0}]},
    {"traceEvents": [{"ph": "X", "name": "x", "pid": 0, "tid": 0,
                      "ts": -1.0, "dur": 1.0}]},
    {"traceEvents": [{"ph": "i", "name": "x", "pid": 0, "tid": "a",
                      "ts": 1.0, "s": "q"}]},
    [], {"traceEvents": 3}])
def test_validator_findings_match_reference(bad):
    got = TT.validate_chrome_trace(bad)
    assert got and got == JT.validate_chrome_trace(bad)


def test_encode_cost_counts_the_encode():
    # (C, S) @ (G, S, P): the bytes and FLOPs chip_smoke.py's bound counts
    c, s, g, p = 20, 4, 10, 5 * 206_922
    got = TT.encode_cost(c, s, g, p)
    assert got["encode_flops"] == 2 * g * c * s * p
    assert got["encode_bytes"] == 4 * (c * s + g * s * p + g * c * p)
    assert TT.encode_cost(c, s, g, p, out_bytes=2)["encode_bytes"] == \
        4 * (c * s + g * s * p) + 2 * g * c * p


def test_stage_program_span_carries_encode_counts_when_asked():
    tr = TT.configure(enabled=True, annotate_costs=True)
    sim = _tsim()
    rec = train_stage(sim, store_kind="coded", engine="stage")
    (sp,) = [x for x in tr.all_spans() if x.name == "device.stage_program"]
    m = len(rec.plan.shard_clients[0])
    p = sum(v.numel() for v in sim.init_model(0).values())
    assert sp.labels["encode_flops"] == 2 * 3 * 8 * 2 * m * p
    assert "hlo_flops" not in sp.labels
    TT.configure(enabled=True)
    train_stage(sim, store_kind="coded", engine="stage")
    (sp,) = [x for x in TT.get_tracer().all_spans()
             if x.name == "device.stage_program"]
    assert "encode_flops" not in sp.labels


# ------------------------------------------------------------- integration
def _port_run():
    tr = TT.configure(enabled=True)
    session = FederatedSession(_tsim(), store_kind="coded", engine="stage")
    session.run_stage()
    session.run_stage()
    svc = UnlearningService(session, policy="window",
                            policy_opts={"width": 0.5},
                            placement=DevicePlacement(devices=["cpu"]))
    report = svc.serve([ServiceRequest(t=t, clients=(c,), rid=i)
                        for i, (t, c) in enumerate(((0.1, 0), (0.2, 5),
                                                    (0.9, 1)))])
    return tr, svc, report


def _reference_run():
    tr = JT.configure(enabled=True)
    session = JSession(_jsim(), store_kind="coded", engine="stage")
    session.run_stage()
    session.run_stage()
    svc = JService(session, policy="window", policy_opts={"width": 0.5},
                   placement=j_single())
    svc.serve([JRequest(t=t, clients=(c,), rid=i)
               for i, (t, c) in enumerate(((0.1, 0), (0.2, 5), (0.9, 1)))])
    return tr, svc


def _renamed(tree):
    return [dict(n, name=RENAMED.get(n["name"], n["name"]),
                 children=_renamed(n["children"])) for n in tree]


@pytest.fixture(scope="module")
def traced():
    try:
        jtr, jsvc = _reference_run()
        out = _port_run() + (jtr, jsvc)
    finally:
        TT.set_tracer(TT.NULL_TRACER)
        JT.set_tracer(JT.NULL_TRACER)
    return out


def test_traced_session_span_forest_equals_reference(traced):
    tr, svc, _report, jtr, jsvc = traced
    want = _renamed(jtr.tree())
    assert tr.tree() == want
    blob = json.dumps(want, sort_keys=True, separators=(",", ":"))
    assert tr.signature() == hashlib.sha256(blob.encode()).hexdigest()
    assert svc.audit.head == jsvc.audit.head
    assert svc.audit.verify() == svc.audit.head


def test_report_telemetry_section_and_span_names(traced):
    tr, svc, report, _jtr, _jsvc = traced
    TT.set_tracer(tr)
    d = report.to_dict()
    assert d["telemetry"]["enabled"] is True
    assert d["telemetry"]["span_signature"] == tr.signature()
    assert d["telemetry"]["metrics"]["gauges"]["service.num_requests"] == 3
    assert d["client_latency_p99_s"]
    required = {"session.stage", "stage.train", "device.stage_program",
                "store.put_stage", "store.read", "service.serve",
                "service.plan", "service.dispatch", "service.job",
                "unlearn.shard"}
    assert required <= set(tr.span_names())
    kinds = svc.audit.kinds()
    assert kinds.count("received") == 3 and kinds.count("committed") == 3
    TT.set_tracer(TT.NULL_TRACER)
    assert "telemetry" not in report.to_dict()


def test_session_audit_chain_and_report_section():
    TT.configure(enabled=True)
    session = FederatedSession(_tsim(), store_kind="coded", engine="stage",
                               batch_requests=True)
    schedule = RequestSchedule([
        UnlearnRequest(lambda p, s=s: [p.shard_clients[s][0]],
                       framework="SE", after_stage=0) for s in (0, 1)])
    report = session.run(1, schedule=schedule)
    head = session.audit.verify()
    kinds = session.audit.kinds()
    assert kinds == ["received", "received", "retrained", "retrained",
                     "committed", "committed"]
    assert head == session.audit.head
    d = report.to_dict()
    assert d["telemetry"]["enabled"] is True
    assert any(k.startswith("store.reads") for k in
               d["telemetry"]["metrics"]["gauges"])


def test_chaos_read_records_injection_and_recovery():
    TT.configure(enabled=True)
    c, s = 12, 4
    per = c // s
    shard_clients = {i: list(range(i * per, (i + 1) * per))
                     for i in range(s)}
    store = CodedStore(CodingScheme(s, c), shard_clients)
    rng = np.random.default_rng(1)
    store.put_round(RoundPayload.from_clients(0, shard_clients, {
        cl: {"w": torch.from_numpy(rng.standard_normal(5).astype(
            np.float32))} for cl in range(c)}))
    store.attach_faults(FaultPlan(seed=7).add("slice_corruption", count=2))
    store.get_shard(0, 1)
    tr = TT.get_tracer()
    reads = [sp for sp in tr.all_spans() if sp.name == "store.read"]
    assert reads[-1].labels.get("recovered") is True
    assert reads[-1].labels.get("corrupted") == 2
    assert {"fault.inject", "fault.recovery"} <= set(tr.span_names())
    assert any(k.startswith("fault.")
               for k in tr.metrics.snapshot()["counters"])


def test_null_tracer_overhead_bounded_below_2pct():
    """tests/test_telemetry.py's arithmetic bound on the port: four no-op
    calls per span one traced stage records, against the untraced stage's
    wall."""
    tr = TT.get_tracer()
    n = 100_000
    t0 = time.perf_counter()
    for _ in range(n):
        with tr.span("stage.train", engine="stage", shards=2) as sp:
            sp.annotate(stage=1)
    per_call = (time.perf_counter() - t0) / n
    sim = _tsim()
    train_stage(sim, store_kind="coded", engine="stage")
    t0 = time.perf_counter()
    train_stage(sim, store_kind="coded", engine="stage")
    stage_wall = time.perf_counter() - t0
    TT.configure(enabled=True)
    train_stage(sim, store_kind="coded", engine="stage")
    n_sites = len(TT.get_tracer().all_spans())
    TT.set_tracer(TT.NULL_TRACER)
    overhead = per_call * 4 * max(n_sites, 1)
    assert overhead < 0.02 * stage_wall, (overhead, n_sites, stage_wall)
