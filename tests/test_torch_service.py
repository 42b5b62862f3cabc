"""The online unlearning service of the PyTorch port on the CPU, against the
reference (``repro.service``) on the same inputs.

Tiny sizes of tests/test_service.py: cnn-paper at 8x8, channels (4, 4), fc
16, sgdm lr 0.05, batch 10, 30 samples a client; 10 clients, 8 a stage, S =
2, L = 2, G = 3 for the serving checks, and 12 clients in S = 4 shards of 2
(G = 2) for the four-slot one.  The port's simulators start from the
reference's initial weights (``init_fn``).  Held exactly: traces, samplers,
JSON/JSONL bytes, policy releases and ``plan_schedule``'s batches (host
code); held to tests/test_torch_session.py's rtol 1e-4 / atol 1e-5: the
FIFO one-slot serve's models against the reference's serve of the same
trace.  Bit for bit: that serve against the port's own
``FederatedSession.run``, and four CPU slots in this process against the
sequential serve.  Also the kernel layer's thread repairs: launch counts
from eight threads, and one build for sixteen concurrent ``load_library``
calls."""
import dataclasses
import json
import sys
import threading

import jax
import numpy as np
import pytest
import torch

import repro.service as J
import repro_torch.service as T
from repro.configs import FLConfig as JFL
from repro.configs import OptimizerConfig as JOpt
from repro.configs import get_config as jget
from repro.data import client_datasets_images, make_image_data
from repro.fl import FLSimulator as JSim
from repro.fl.experiment import FederatedSession as JSession
from repro.models import init_params as jinit
from repro_torch import kernels as K
from repro_torch.configs import FLConfig, OptimizerConfig, get_config
from repro_torch.core.sharding import even_requests
from repro_torch.core.tree import tree_leaves
from repro_torch.durability import Journal
from repro_torch.fl import FLSimulator
from repro_torch.fl.experiment import (FederatedSession, RequestSchedule,
                                       UnlearnRequest)
from repro_torch.models import from_numpy_params

torch.set_num_threads(1)
TINY = dict(image_size=8, d_model=16, cnn_channels=(4, 4))
FL_TINY = dict(num_clients=10, clients_per_round=8, num_shards=2,
               local_epochs=2, global_rounds=3, retrain_ratio=2.0)
FL_FOUR = dict(num_clients=12, clients_per_round=8, num_shards=4,
               local_epochs=2, global_rounds=2, retrain_ratio=2.0)
TOL = dict(rtol=1e-4, atol=1e-5)
JCFG = dataclasses.replace(jget("cnn-paper"), **TINY)
TCFG = dataclasses.replace(get_config("cnn-paper"), **TINY)


def _clients(n):
    data = make_image_data(n * 30, image_size=8, seed=0)
    return client_datasets_images(data, n, iid=True)


def _jax_init(salt):
    return from_numpy_params(jax.tree.map(
        np.asarray, jinit(JCFG, jax.random.key(salt))), device="cpu")


def _jsim(fl=FL_TINY):
    return JSim(JCFG, JFL(**fl), _clients(fl["num_clients"]), task="image",
                opt_cfg=JOpt(name="sgdm", lr=0.05, grad_clip=0.0),
                local_batch=10, seed=0)


def _tsim(fl=FL_TINY):
    return FLSimulator(TCFG, FLConfig(**fl), _clients(fl["num_clients"]),
                       task="image",
                       opt_cfg=OptimizerConfig(name="sgdm", lr=0.05,
                                               grad_clip=0.0),
                       local_batch=10, seed=0, device="cpu",
                       init_fn=_jax_init)


def _cpu(n=1):
    return T.DevicePlacement(devices=["cpu"] * n)


def _dicts(trace):
    return [r.to_dict() for r in trace]


def _batches(batches):
    return [(b.bid, b.time, [(p.req.rid, sorted(p.impacted))
                             for p in b.pendings]) for b in batches]


def _results(session):
    return [u for st in session.report.stages for u in st.unlearn]


# ------------------------------------------------------------------ workload
TRACES = {
    "poisson": lambda m: m.poisson_trace(range(10), n=8, rate=4.0, seed=3,
                                         skew=1.0),
    "poisson_deadline_groups": lambda m: m.poisson_trace(
        range(30), n=12, rate=2.0, seed=5, deadline=3.0,
        victims_per_request=2, replace=False),
    "bursty": lambda m: m.bursty_trace(range(10), n=12, burst_rate=2.0,
                                       mean_burst=4.0, seed=7),
    "iter_poisson": lambda m: list(m.iter_poisson_trace(
        range(10), n=16, rate=4.0, seed=3, skew=1.0,
        victims_per_request=2)),
    "sequenced": lambda m: m.sequenced_trace([3, (4, 5), 6], spacing=0.5,
                                             rounds=2, framework="FE"),
}


@pytest.mark.parametrize("kind", sorted(TRACES))
def test_traces_match_reference(kind):
    assert _dicts(TRACES[kind](T)) == _dicts(TRACES[kind](J))


@pytest.mark.parametrize("skew,replace", [(0.0, True), (2.0, True),
                                          (1.0, False)])
def test_client_sampler_matches_reference(skew, replace):
    a = T.client_sampler(range(30), seed=4, skew=skew, replace=replace)
    b = J.client_sampler(range(30), seed=4, skew=skew, replace=replace)
    assert [a(3) for _ in range(6)] == [b(3) for _ in range(6)]


def test_sampler_without_replacement_exhausts():
    sample = T.client_sampler([1, 2, 3], seed=0, replace=False)
    assert {sample(1)[0] for _ in range(3)} == {1, 2, 3}
    with pytest.raises(ValueError, match="exhausted"):
        sample(1)


def test_trace_files_byte_identical_and_round_trip(tmp_path):
    trace = TRACES["poisson_deadline_groups"](T)
    jtrace = TRACES["poisson_deadline_groups"](J)
    for name, save in (("trace.json", "save_trace"),
                       ("trace.jsonl", "save_trace_jsonl")):
        tp, jp = tmp_path / f"t_{name}", tmp_path / f"j_{name}"
        getattr(T, save)(str(tp), iter(trace))
        getattr(J, save)(str(jp), jtrace)
        assert tp.read_bytes() == jp.read_bytes()
        assert _dicts(T.iter_trace(str(jp))) == _dicts(trace)
    assert _dicts(T.load_trace(str(tmp_path / "j_trace.json"))) == \
        _dicts(trace)


def test_virtual_clock_is_monotone():
    clk = T.VirtualClock()
    assert clk.advance_to(2.0) == 2.0
    assert clk.advance_to(1.0) == 2.0
    assert clk.advance(0.5) == 2.5
    assert clk.advance(-1.0) == 2.5


# ------------------------------------------------------------------ policies
def _queue(m):
    reqs = [(0, 0.0, {(0, 0)}), (1, 0.8, {(0, 0), (0, 1)}),
            (2, 0.9, {(0, 2)}), (3, 1.2, {(0, 1)}), (4, 2.6, {(1, 0)})]
    return [m.Pending(m.ServiceRequest(t=t, clients=(rid,), rid=rid),
                      impacted=frozenset(imp)) for rid, t, imp in reqs]


POLICY_CASES = [("fifo", {}, 1.0), ("window", {"width": 1.0}, 1.0),
                ("window", {"width": 0.5}, 3.0),
                ("sla", {"default_deadline": 1.0,
                         "max_hold": float("inf")}, 1.0),
                ("sla", {"default_deadline": 2.0, "est_serve": 0.5}, 2.0)]


@pytest.mark.parametrize("name,opts,now", POLICY_CASES)
def test_policy_releases_match_reference(name, opts, now):
    got = []
    for m in (T, J):
        pol, q = m.make_policy(name, **opts), _queue(m)
        ev = pol.next_event(q, 0.0)
        rel = pol.release(q, now)
        fin = pol.release(q, now + 5.0, final=True)
        got.append((ev, [[p.req.rid for p in b] for b in rel],
                    [[p.req.rid for p in b] for b in fin], pol.describe()))
    assert got[0] == got[1]


def test_policy_registry():
    assert {"fifo", "window", "sla"} <= set(T.POLICIES)
    with pytest.raises(ValueError, match="unknown scheduling policy"):
        T.make_policy("nope")
    with pytest.raises(ValueError, match="positive"):
        T.BatchWindowPolicy(width=0.0)


# ------------------------------------------------------ sessions, both sides
@pytest.fixture(scope="module")
def trained():
    """A trained stage on each side (reference, port), plus a second port
    session serving through ``FederatedSession.run`` for the bit check."""
    jsess = JSession(_jsim(), store_kind="coded")
    jrec = jsess.run_stage()
    tsess = FederatedSession(_tsim(), store_kind="coded")
    trec = tsess.run_stage()
    assert trec.plan.shard_clients == jrec.plan.shard_clients
    victims = [trec.plan.shard_clients[0][0], trec.plan.shard_clients[1][0]]
    tref = FederatedSession(_tsim(), store_kind="coded")
    tref.run(1, schedule=RequestSchedule([
        UnlearnRequest([v], framework="SE", after_stage=0, rounds=2)
        for v in victims]))
    return jsess, tsess, tref, victims


SCHEDULES = [("fifo", {}), ("window", {"width": 0.5}),
             ("sla", {"default_deadline": 3.0})]


@pytest.mark.parametrize("stream", [False, True], ids=["list", "stream"])
@pytest.mark.parametrize("policy,opts", SCHEDULES)
def test_plan_schedule_matches_reference(trained, policy, opts, stream):
    jsess, tsess, _, _ = trained
    pool = tsess.records[0].plan.clients + [99]      # 99: in no stage
    trace = T.poisson_trace(pool, n=10, rate=3.0, seed=2, skew=1.0)
    jtrace = J.poisson_trace(pool, n=10, rate=3.0, seed=2, skew=1.0)
    tsvc = T.UnlearningService(tsess, policy=policy, policy_opts=opts,
                               placement=_cpu())
    jsvc = J.UnlearningService(jsess, policy=policy, policy_opts=opts,
                               placement=J.single_device_placement())
    got = tsvc.plan_schedule(iter(trace) if stream else trace)
    want = jsvc.plan_schedule(iter(jtrace) if stream else jtrace)
    assert _batches(got) == _batches(want)
    assert tsvc.audit.head == jsvc.audit.head


def test_fifo_one_slot_serve_matches_reference_and_session_run(trained):
    jsess, tsess, tref, victims = trained
    n0, j0 = len(_results(tsess)), len(_results(jsess))
    trace = T.sequenced_trace(victims, spacing=0.1, rounds=2)
    report = T.UnlearningService(tsess, policy="fifo",
                                 placement=_cpu()).serve(trace)
    J.UnlearningService(jsess, policy="fifo",
                        placement=J.single_device_placement()).serve(
        J.sequenced_trace(victims, spacing=0.1, rounds=2))
    assert len(report.entries) == 2 and report.num_batches == 2
    got, want, ref = (_results(tsess)[n0:], _results(jsess)[j0:],
                      _results(tref))
    assert len(got) == len(want) == len(ref) == 2
    for g, w, r in zip(got, want, ref):
        assert g.impacted_shards == w.impacted_shards == r.impacted_shards
        assert g.cost_units == w.cost_units == r.cost_units
        for s in g.models:
            for k in g.models[s]:
                torch.testing.assert_close(g.models[s][k], r.models[s][k],
                                           rtol=0, atol=0)
                np.testing.assert_allclose(g.models[s][k].numpy(),
                                           np.asarray(w.models[s][k]),
                                           err_msg=f"{s}/{k}", **TOL)


def test_ledger_fields_and_json(trained):
    _, tsess, _, victims = trained
    trace = T.sequenced_trace(victims, spacing=0.05, rounds=1,
                              deadline=120.0)
    report = T.UnlearningService(tsess, policy="window",
                                 policy_opts={"width": 1.0},
                                 placement=_cpu()).serve(trace)
    assert report.num_batches == 1
    d = json.loads(report.to_json())
    assert d["num_requests"] == 2 and d["throughput_rps"] > 0
    assert d["latency_p50_s"] <= d["latency_p95_s"] <= d["latency_p99_s"]
    for e in report.entries:
        assert e.queue_wait >= 0 and e.batch_wait >= 0
        assert e.retrain_wall > 0
        assert e.latency == pytest.approx(e.queue_wait + e.batch_wait
                                          + e.retrain_wall)
        assert e.sla_met is True
    assert report.sla_hit_rate == 1.0


def test_generator_serve_equals_list_serve(trained):
    _, tsess, _, victims = trained
    trace = T.sequenced_trace(victims, spacing=0.1, rounds=1)
    reps = [T.UnlearningService(tsess, placement=_cpu()).serve(t)
            for t in (list(trace), iter(trace))]
    assert [e.rid for e in reps[0].entries] == \
        [e.rid for e in reps[1].entries]
    a, b = _results(tsess)[-4:-2], _results(tsess)[-2:]
    for ra, rb in zip(a, b):
        for s in ra.models:
            for k in ra.models[s]:
                assert torch.equal(ra.models[s][k], rb.models[s][k])


def test_requests_outside_stage_and_errors(trained):
    _, tsess, _, victims = trained
    absent = [c for c in range(10)
              if c not in set(tsess.records[0].plan.clients)]
    (entry,) = T.UnlearningService(tsess, placement=_cpu()).serve(
        T.sequenced_trace(absent[:1], rounds=1)).entries
    assert entry.n_jobs == 0 and entry.retrain_wall == 0.0
    with pytest.raises(ValueError, match="unknown unlearning framework"):
        T.UnlearningService(tsess).serve(
            T.sequenced_trace(victims[:1], framework="NOPE"))
    bad = iter([T.ServiceRequest(t=1.0, clients=(victims[0],), rid=0),
                T.ServiceRequest(t=0.5, clients=(victims[0],), rid=1)])
    with pytest.raises(ValueError, match="time-ordered"):
        T.UnlearningService(tsess, placement=_cpu()).serve(bad)
    with pytest.raises(RuntimeError, match="train at least one stage"):
        T.UnlearningService(FederatedSession(_tsim())).serve(
            T.sequenced_trace([0]))


def test_resume_from_journal_redispatches_only_uncommitted(trained,
                                                           tmp_path):
    """A journal whose first two requests are committed: ``serve(resume=
    True)`` replays their entries and re-dispatches only the other two,
    and the audit chain splices onto the journaled one."""
    _, tsess, _, victims = trained
    trace = T.sequenced_trace(victims + victims, spacing=0.1, rounds=1)
    path = str(tmp_path / "svc.journal")
    first = T.UnlearningService(tsess, placement=_cpu(),
                                journal=Journal(path))
    done = first.serve(trace[:2])
    n0 = len(_results(tsess))
    resumed = T.UnlearningService(tsess, placement=_cpu(),
                                  journal=Journal(path))
    assert resumed.audit.head == first.audit.head
    rep = resumed.serve(trace, resume=True)
    assert [e.rid for e in rep.entries] == [0, 1, 2, 3]
    assert [e.to_dict() for e in rep.entries[:2]] == \
        [e.to_dict() for e in done.entries]
    assert len(_results(tsess)) - n0 == 2             # only rids 2 and 3
    evs = Journal(path).events()
    dispatched = [e["request_id"] for e in evs if e["ev"] == "svc_dispatch"]
    assert dispatched == ["svc-0", "svc-1", "svc-2", "svc-3"]
    assert resumed.audit.verify() == resumed.audit.head


# --------------------------------------------------------- four CPU slots
def test_four_cpu_slots_serve_one_batch_bit_identical():
    session = FederatedSession(_tsim(FL_FOUR), store_kind="coded")
    record = session.run_stage()
    trace = T.sequenced_trace(even_requests(record.plan, 4), spacing=0.0,
                              rounds=2)
    seq = T.UnlearningService(session, policy="fifo",
                              placement=T.single_device_placement("cpu"))
    seq.serve(trace)
    with T.DevicePlacement(devices=["cpu"] * 4) as slots:
        rep = T.UnlearningService(session, policy="window",
                                  policy_opts={"width": 1.0},
                                  placement=slots).serve(trace)
    assert rep.num_batches == 1
    assert max(e.n_jobs for e in rep.entries) == 4
    assert sorted({d for e in rep.entries for d in e.devices}) == \
        [0, 1, 2, 3]
    results = _results(session)
    merged = results[4]
    assert sorted(merged.impacted_shards) == [0, 1, 2, 3]
    for r in results[:4]:
        (s,) = r.impacted_shards
        for a, b in zip(tree_leaves(r.models[s]),
                        tree_leaves(merged.models[s])):
            assert torch.equal(a, b)


# ---------------------------------------------------------------- placement
def test_placement_workers_shut_down():
    with _cpu() as p:
        assert p.submit(lambda: 41 + 1).result() == 42
        assert p._pools is not None
    assert p._pools is None
    p.shutdown()                                      # idempotent
    with pytest.raises(RuntimeError, match="boom"):
        with p:
            p.submit(lambda: None).result()
            raise RuntimeError("boom")
    assert p._pools is None


def test_placement_health_and_round_robin():
    p = T.DevicePlacement(devices=["cpu"] * 3)
    p.mark_unhealthy(1)
    assert p.reassign(0) == 2 and p.reassign(1) == 2
    assert p.describe()["unhealthy"] == [1]
    p.mark_unhealthy(0)
    p.mark_unhealthy(2)
    assert p.reassign(0) == 0
    p.reset_health()
    assert p.reassign(0) == 1
    assert [p.assign() for _ in range(4)] == [0, 1, 2, 0]
    p.reset_assignment()
    assert p.assign() == 0
    assert p.run(1, lambda dev: dev.type) == "cpu"


def test_placement_default_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="devices=\\['cpu'\\]"):
        T.DevicePlacement()
    with pytest.raises(RuntimeError):
        T.single_device_placement()
    assert T.single_device_placement("cpu").max_workers == 1


# ----------------------------------------------------- report and retry
def test_report_guards_and_backoff():
    rep = T.ServiceReport()
    assert np.isnan(rep.p95) and np.isnan(rep.throughput)
    assert rep.sla_hit_rate is None
    json.dumps(rep.to_dict())
    rep = T.ServiceReport(serve_wall=2.0)
    rep.entries = [
        T.LedgerEntry(rid=0, arrival=0.0, clients=(0,), framework="SE",
                      batch_id=0, latency=1.0, sla_met=True),
        T.LedgerEntry(rid=1, arrival=0.0, clients=(1,), framework="SE",
                      batch_id=0, latency=3.0, aborted=True)]
    assert rep.percentile(50) == 1.0 and rep.throughput == 0.5
    assert rep.num_aborted == 1
    e = rep.entries[1]
    assert T.LedgerEntry.from_dict(e.to_dict()).to_dict() == e.to_dict()
    rp = T.RetryPolicy(backoff=0.1, backoff_factor=2.0, max_backoff=0.35)
    assert [rp.backoff_for(i) for i in (1, 2, 3, 9)] == \
        pytest.approx([0.1, 0.2, 0.35, 0.35])


# ------------------------------------------------- kernel-layer thread repairs
def _run_threads(target, n):
    threads = [threading.Thread(target=target) for _ in range(n)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)          # switch often: races show up
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)


def test_launch_counts_exact_from_eight_threads():
    K.reset_launches()
    barrier = threading.Barrier(8)

    def count():
        barrier.wait(timeout=30)
        for _ in range(10_000):
            K.count_launch("calibrate")

    _run_threads(count, 8)
    assert K.LAUNCHES["calibrate"] == 80_000
    K.reset_launches()
    assert all(v == 0 for v in K.LAUNCHES.values())


def test_load_library_builds_once_under_sixteen_threads(monkeypatch):
    builds = []
    lib = object()

    def stub():
        builds.append(threading.get_ident())
        threading.Event().wait(0.05)          # a slow build: others queue
        return lib

    monkeypatch.setattr(K, "_build_and_load", stub)
    monkeypatch.setattr(K, "_LIBRARY", None)
    barrier = threading.Barrier(16)
    got = []

    def call():
        barrier.wait(timeout=30)
        got.append(K.load_library())

    _run_threads(call, 16)
    assert len(builds) == 1
    assert len(got) == 16 and all(g is lib for g in got)
