"""The port's chaos harness on the CPU (``repro_torch.faults``, the coded
store's quorum reads, the service's retries and the stage's dropout),
against the reference (``repro.faults``) on the same inputs.

Sizes of tests/test_faults.py: the coding scheme C = 12, S = 4 (and C = 8
for the budget case); the tiny CNN session (cnn-paper at 8x8, channels
(4, 4), 10 clients, 8 a stage, S = 2, L = 2, G = 3, sgdm lr 0.05), the
port's from the reference's initial weights; a four-shard session for the
slot-failure serve.  Held exactly: every injector decision (pure numpy,
keyed on (seed, site)), ``dropped_clients``, which rows a read corrupts or
erases, and the ``FaultLedger.signature()`` of a chaotic serve.  The noise
values: within 1e-6 relative, since the port takes the noise scale (mean
|slice|) in float64 on the slices' device and the reference in float32 on
the host.  Bit for bit: models of a faulted serve against the fault-free
serve, in the port."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.faults as JF
import repro_torch.faults as TF
from repro.configs import FLConfig as JFL
from repro.configs import OptimizerConfig as JOpt
from repro.configs import get_config as jget
from repro.core.coding import CodingScheme as JScheme
from repro.data import client_datasets_images, make_image_data
from repro.fl import FLSimulator as JSim
from repro.fl.experiment import FederatedSession as JSession
from repro.models import init_params as jinit
from repro.service import RetryPolicy as JRetry
from repro.service import UnlearningService as JService
from repro.service import sequenced_trace as j_sequenced_trace
from repro.service import single_device_placement as j_single
from repro.stores.store import CodedStore as JStore
from repro.stores.store import RoundPayload as JPayload
from repro_torch.configs import FLConfig, OptimizerConfig, get_config
from repro_torch.core.coding import CodingBudgetExceeded, CodingScheme
from repro_torch.core.sharding import even_requests
from repro_torch.core.tree import tree_leaves
from repro_torch.fl import FLSimulator
from repro_torch.fl.experiment import FederatedSession
from repro_torch.models import from_numpy_params
from repro_torch.service import (DevicePlacement, RetryPolicy,
                                 UnlearningService, sequenced_trace)
from repro_torch.stores.store import CodedStore, RoundPayload

torch.set_num_threads(1)
FAULT_SEED = int(os.environ.get("REPRO_FAULT_SEED", "7"))
TINY = dict(image_size=8, d_model=16, cnn_channels=(4, 4))
FL_TINY = dict(num_clients=10, clients_per_round=8, num_shards=2,
               local_epochs=2, global_rounds=3, retrain_ratio=2.0)
FL_FOUR = dict(num_clients=12, clients_per_round=8, num_shards=4,
               local_epochs=2, global_rounds=2, retrain_ratio=2.0)
JCFG = dataclasses.replace(jget("cnn-paper"), **TINY)
TCFG = dataclasses.replace(get_config("cnn-paper"), **TINY)
NOISE_RTOL = 1e-6


def _clients(n):
    data = make_image_data(n * 30, image_size=8, seed=0)
    return client_datasets_images(data, n, iid=True)


def _jax_init(salt):
    return from_numpy_params(jax.tree.map(
        np.asarray, jinit(JCFG, jax.random.key(salt))), device="cpu")


def _tsim(fl=FL_TINY):
    return FLSimulator(TCFG, FLConfig(**fl), _clients(fl["num_clients"]),
                       task="image",
                       opt_cfg=OptimizerConfig(name="sgdm", lr=0.05,
                                               grad_clip=0.0),
                       local_batch=10, seed=0, device="cpu",
                       init_fn=_jax_init)


def _jsim():
    return JSim(JCFG, JFL(**FL_TINY), _clients(10), task="image",
                opt_cfg=JOpt(name="sgdm", lr=0.05, grad_clip=0.0),
                local_batch=10, seed=0)


def _chaotic(m, seed=FAULT_SEED):
    return (m.FaultPlan(seed=seed)
            .add("slice_corruption", count=2, scale=10.0)
            .add("job_exception", rate=1.0, fail_attempts=1))


def _models(session):
    return {s: dict(w) for s, w in
            session.report.stages[0].unlearn[-1].models.items()}


def _same(a, b):
    assert set(a) == set(b)
    for s in a:
        for x, y in zip(tree_leaves(a[s]), tree_leaves(b[s])):
            assert torch.equal(x, y)


# ------------------------------------------------------- plan decisions
PLANS = {
    "corrupt": lambda m: m.FaultPlan(FAULT_SEED).add("slice_corruption",
                                                     count=2),
    "corrupt_all_rows": lambda m: m.FaultPlan(FAULT_SEED).add(
        "slice_corruption", count=3, scale=4.0, spare_quorum=False),
    "erase": lambda m: m.FaultPlan(FAULT_SEED + 1).add("slice_erasure",
                                                       count=3),
    "erase_some_rounds": lambda m: m.FaultPlan(3).add(
        "slice_erasure", count=1, rounds=(1, 4)),
    "cold": lambda m: m.FaultPlan(5).add("cold_corrupt", count=2),
    "chaos": lambda m: m.chaos_plan(11, corrupt=1, erase=2, job_rate=0.5,
                                    dead_device=2, dropout=0.4),
}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_slice_fault_decisions_byte_identical(name):
    tp, jp = PLANS[name](TF), PLANS[name](JF)
    tsch, jsch = CodingScheme(4, 12), JScheme(num_shards=4, num_clients=12)
    for rnd in range(6):
        tl, tn = tp.slice_faults(rnd, tsch, width=9, scale_ref=0.37)
        jl, jn = jp.slice_faults(rnd, jsch, width=9, scale_ref=0.37)
        assert tl == jl and sorted(tn) == sorted(jn)
        for r in tn:
            assert tn[r].tobytes() == jn[r].tobytes()
        tc = tp.cold_faults(rnd, tsch, width=5, scale_ref=2.0)
        jc = jp.cold_faults(rnd, jsch, width=5, scale_ref=2.0)
        assert sorted(tc) == sorted(jc)
        for r in tc:
            assert tc[r].tobytes() == jc[r].tobytes()
    assert tp.describe() == jp.describe()
    assert tp.ledger.signature() == jp.ledger.signature()


@pytest.mark.parametrize("name", sorted(PLANS))
def test_job_and_dropout_decisions_byte_identical(name):
    tp, jp = PLANS[name](TF), PLANS[name](JF)
    shard_clients = {0: [1, 2, 3, 4], 1: [5, 6, 7], 2: [8, 9]}
    for stage in range(3):
        assert tp.dropped_clients(stage, shard_clients) == \
            jp.dropped_clients(stage, shard_clients)
    for key in [("shard", 0, 1, (5,)), ("federation", 1, (2, 3))]:
        for attempt in (1, 2, 3):
            for dev in (0, 2):
                td, te = tp.job_action(key, attempt, dev)
                jd, je = jp.job_action(key, attempt, dev)
                assert td == jd
                assert type(te).__name__ == type(je).__name__
    assert tp.ledger.signature() == jp.ledger.signature()
    assert tp.ledger.kinds() == jp.ledger.kinds()


@pytest.mark.parametrize("rate,min_keep", [(0.5, 1), (1.0, 1), (1.0, 2)])
def test_client_dropout_matches_reference(rate, min_keep):
    shard_clients = {0: [1, 2, 3], 1: [4, 5], 2: [6, 7, 8, 9]}
    got = [m.FaultPlan(FAULT_SEED).add("client_dropout", rate=rate,
                                        min_keep=min_keep)
           .dropped_clients(2, shard_clients) for m in (TF, JF)]
    assert got[0] == got[1]


def test_registry_and_rng():
    for name in ("client_dropout", "straggler", "slice_erasure",
                 "slice_corruption", "cold_corrupt", "device_failure",
                 "device_hang", "job_exception", "process_kill",
                 "torn_write"):
        assert name in TF.INJECTORS
    with pytest.raises(ValueError, match="unknown fault injector"):
        TF.make_injector("nope")
    a = TF.FaultPlan(seed=FAULT_SEED).rng("x", 1, (2, 3)).random(4)
    b = JF.FaultPlan(seed=FAULT_SEED).rng("x", 1, (2, 3)).random(4)
    assert a.tobytes() == b.tobytes()


def test_ledger_signature_is_thread_order_independent():
    ev = [TF.RecoveryEvent("retry", site=("j", i)) for i in range(5)]
    a, b = TF.FaultLedger(), TF.FaultLedger()
    for e in ev:
        a.record(e)
    for e in reversed(ev):
        b.record(e)
    assert a.signature() == b.signature()
    assert a.count("retry") == 5 and a.kinds() == {"retry": 5}


def test_process_kill_raises_at_its_site():
    plan = TF.FaultPlan().add("process_kill", stage=0, phase="after_stage")
    session = FederatedSession(_tsim(), store_kind="coded", faults=plan)
    with pytest.raises(TF.InjectedCrash):
        session.run(1)
    assert plan.ledger.count("process_kill") == 1


# ---------------------------------------------------------- quorum reads
def _stores(plan_t=None, plan_j=None, c=12, s=4):
    per = c // s
    shard_clients = {i: list(range(i * per, (i + 1) * per))
                     for i in range(s)}
    rng = np.random.default_rng(1)
    raw = {cl: rng.standard_normal(5).astype(np.float32) for cl in range(c)}
    ts = CodedStore(CodingScheme(s, c), shard_clients)
    ts.put_round(RoundPayload.from_clients(
        0, shard_clients, {k: {"w": torch.from_numpy(v)}
                           for k, v in raw.items()}))
    js = JStore(JScheme(num_shards=s, num_clients=c), shard_clients)
    js.put_round(JPayload.from_clients(
        0, shard_clients, {k: {"w": jnp.asarray(v)} for k, v in raw.items()}))
    for store, plan in ((ts, plan_t), (js, plan_j)):
        if plan is not None:
            store.attach_faults(plan)
    return ts, js


def _recording(plan):
    got = []
    orig = plan.slice_faults

    def rec(*a, **kw):
        got.append(orig(*a, **kw))
        return got[-1]
    plan.slice_faults = rec
    return got


@pytest.mark.parametrize("name", ["corrupt", "erase", "corrupt_all_rows"])
def test_faulted_reads_match_reference(name):
    tp, jp = PLANS[name](TF), PLANS[name](JF)
    tgot, jgot = _recording(tp), _recording(jp)
    base = _stores()[0].get_shard(0, 1)
    ts, js = _stores(tp, jp)
    got, want = ts.get_shard(0, 1), js.get_shard(0, 1)
    (tl, tn), (jl, jn) = tgot[0], jgot[0]
    assert tl == jl and sorted(tn) == sorted(jn)
    for r in tn:
        np.testing.assert_allclose(tn[r], jn[r], rtol=NOISE_RTOL, atol=0)
    assert ts.stats.to_dict() == js.stats.to_dict()
    assert tp.ledger.signature() == jp.ledger.signature()
    for cl in got:
        np.testing.assert_allclose(got[cl]["w"].numpy(),
                                   np.asarray(want[cl]["w"]),
                                   rtol=1e-4, atol=1e-5)
        if name != "corrupt_all_rows":         # spares the quorum: exact
            assert torch.equal(got[cl]["w"], base[cl]["w"])


def test_budget_exceeded_read_fails_typed_and_counted():
    plan = TF.FaultPlan(seed=FAULT_SEED).add("slice_corruption", count=3,
                                             spare_quorum=False)
    ts, _ = _stores(plan, None, c=8, s=4)
    with pytest.raises(CodingBudgetExceeded):
        ts.get_shard(0, 0)
    assert ts.stats.failed_reads == 1


def test_decode_tol_takes_the_reference_signature():
    ts, js = _stores()
    sl = ts._slices[0]
    assert ts._decode_tol(0, sl) == js._decode_tol(0, js._slices[0]) == 1e-3
    assert ts._decode_tol(0, sl.to(torch.bfloat16)) == 3e-2


# -------------------------------------------------------- chaotic serves
@pytest.fixture(scope="module")
def sessions():
    jsess = JSession(_jsim(), store_kind="coded", engine="fused")
    jsess.run_stage()
    tsess = FederatedSession(_tsim(), store_kind="coded", engine="fused")
    tsess.run_stage()
    return jsess, tsess


def _tserve(session, plan, retry=None, trace=None, placement=None):
    svc = UnlearningService(
        session, policy="fifo",
        placement=placement or DevicePlacement(devices=["cpu"]),
        faults=plan, retry=retry or RetryPolicy(backoff=0.001))
    trace = trace or sequenced_trace([session.records[0].plan.clients[0]],
                                     spacing=0.1)
    try:
        report = svc.serve(trace)
    finally:
        svc.placement.shutdown()
        for rec in session.records:
            rec.store.attach_faults(None)
    report.audit_head = svc.audit.head
    return report, _models(session)


def _jserve(session, plan):
    svc = JService(session, policy="fifo", placement=j_single(),
                   faults=plan, retry=JRetry(backoff=0.001))
    try:
        svc.serve(j_sequenced_trace([session.records[0].plan.clients[0]],
                                    spacing=0.1))
    finally:
        svc.placement.shutdown()
        for rec in session.records:
            rec.store.attach_faults(None)
    return svc.audit.head


def test_chaotic_serve_bit_identical_and_ledger_matches_reference(sessions):
    jsess, tsess = sessions
    rep0, m0 = _tserve(tsess, None)
    tplan, jplan = _chaotic(TF), _chaotic(JF)
    rep1, m1 = _tserve(tsess, tplan)
    jhead = _jserve(jsess, jplan)
    _same(m0, m1)
    assert rep1.faults["retries"] > 0 and rep1.faults["recoveries"] > 0
    assert rep1.faults["aborts"] == 0
    assert all(e.job_retries > 0 and not e.aborted for e in rep1.entries)
    assert rep0.faults["retries"] == 0 and rep0.faults["recoveries"] == 0
    assert tplan.ledger.signature() and \
        tplan.ledger.signature() == jplan.ledger.signature()
    assert rep1.audit_head == jhead
    other = _chaotic(TF, FAULT_SEED + 1)
    _tserve(tsess, other)
    assert other.ledger.signature() != tplan.ledger.signature()


def test_retry_budget_exhaustion_aborts_cleanly(sessions):
    _, tsess = sessions
    plan = TF.FaultPlan(seed=FAULT_SEED).add("job_exception", rate=1.0,
                                             fail_attempts=99)
    rep, _ = _tserve(tsess, plan,
                     retry=RetryPolicy(max_retries=1, backoff=0.001))
    assert rep.faults["aborts"] > 0
    assert all(e.aborted for e in rep.entries)
    assert np.isnan(rep.p50) and np.isnan(rep.throughput)
    assert plan.ledger.count("abort") > 0 and plan.ledger.count("retry") > 0
    d = rep.to_dict()
    assert d["num_aborted"] == len(rep.entries)


def test_slot_failure_on_four_cpu_slots_completes_bit_identical():
    """A dead slot among four: every request completes, the models equal
    the fault-free serve's, and the slot is marked unhealthy."""
    session = FederatedSession(_tsim(FL_FOUR), store_kind="coded")
    record = session.run_stage()
    trace = sequenced_trace(even_requests(record.plan, 4), spacing=0.0,
                            rounds=2)

    def serve(plan):
        slots = DevicePlacement(devices=["cpu"] * 4)
        svc = UnlearningService(session, policy="window",
                                policy_opts={"width": 1.0}, placement=slots,
                                faults=plan,
                                retry=RetryPolicy(backoff=0.001))
        try:
            rep = svc.serve(trace)
        finally:
            slots.shutdown()
            record.store.attach_faults(None)
        return rep, _models(session)

    rep0, m0 = serve(None)
    plan = _chaotic(TF).add("device_failure", device=1)
    rep1, m1 = serve(plan)
    _same(m0, m1)
    assert rep1.num_aborted == 0 and rep1.faults["retries"] > 0
    assert rep1.faults["recoveries"] > 0
    assert rep1.placement["unhealthy"] == [1]
    assert plan.ledger.count("redispatch") > 0
    replay = _chaotic(TF).add("device_failure", device=1)
    serve(replay)
    assert replay.ledger.signature() == plan.ledger.signature()


# ----------------------------------------------------- degraded training
def test_dropout_degrades_stage_engine_with_event():
    @TF.register_injector("_test_drop_first_of_shard0")
    class _DropOne(TF.FaultInjector):
        def stage_dropout(self, plan, stage, shard_clients):
            s = sorted(shard_clients)[0]
            return {s: [shard_clients[s][0]]}

    plan = TF.FaultPlan(seed=FAULT_SEED).add("_test_drop_first_of_shard0")
    sess = FederatedSession(_tsim(), store_kind="coded", engine="stage",
                            faults=plan)
    record = sess.run_stage()
    assert sorted(len(cs) for cs in record.plan.shard_clients.values()) == \
        [3, 4]
    (ev,) = [e for e in plan.ledger.events
             if isinstance(e, TF.DegradedModeEvent)]
    assert (ev.fallback, ev.reason, len(ev.dropped_clients)) == \
        ("fused", "ragged_stage", 1)
    assert plan.ledger.count("client_dropout") == 1
    assert set(record.shard_models) == set(record.plan.shard_clients)
    assert record.store.faults is plan


def test_dropout_stage_matches_reference():
    """A seeded dropout plan on both packages' fused stage: the same
    clients drop, and the dropout ledgers are equal."""
    jp = JF.FaultPlan(seed=3).add("client_dropout", rate=0.3)
    tp = TF.FaultPlan(seed=3).add("client_dropout", rate=0.3)
    jrec = JSession(_jsim(), store_kind="coded", faults=jp).run_stage()
    trec = FederatedSession(_tsim(), store_kind="coded",
                            faults=tp).run_stage()
    assert trec.plan.shard_clients == jrec.plan.shard_clients
    assert tp.ledger.signature() == jp.ledger.signature()
    assert tp.ledger.count("client_dropout") == 1
    for s in jrec.shard_models:
        for k, v in jrec.shard_models[s].items():
            np.testing.assert_allclose(trec.shard_models[s][k].numpy(),
                                       np.asarray(v), rtol=1e-4, atol=1e-5)


def test_legacy_engine_refuses_fault_plans():
    from repro_torch.fl.experiment import train_stage
    with pytest.raises(ValueError, match="fault plans"):
        train_stage(_tsim(), engine="legacy", faults=TF.FaultPlan())
