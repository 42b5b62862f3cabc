"""The tiered coded store of the PyTorch port on the CPU, against the
reference (``repro.tiering``): the int8 codec byte for byte (q, scales,
dequantized f32 and bf16, re-quantization with stored scales, the cold
file's bytes and CRC); the hot/warm/cold ladder bit-stable through promote,
demote and read; an unlimited budget bit-identical to the coded store;
every budget and eviction policy making the reference's tier decisions
(``tier_of`` per round and every ``tier_*`` dict, exactly); cold serving
within tests/test_tiering.py's 2e-2 of the exact store; cold-tier
corruption; snapshots of tiered stores with their cold-file pointers; and
the per-tier gauges.

Sessions are tests/test_tiering.py's tiny CNN (8x8, channels 4/4, fc 16;
8 clients, all in each stage, S = 2, L = 1, G = 3, seed 3) on the stage
engine, fed the reference's initial weights through ``init_fn``; unit
stores are its ``_unit_store`` (12 clients in 4 shards, a 5-float
parameter each)."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import FLConfig as JFL
from repro.configs import OptimizerConfig as JOpt
from repro.configs import get_config as jget
from repro.data import client_datasets_images, make_image_data
from repro.fl import FLSimulator as JSim
from repro.fl.experiment import FederatedSession as JSession
from repro.fl.experiment import RequestSchedule as JSchedule
from repro.fl.experiment import UnlearnRequest as JRequest
from repro.models import init_params as jinit
from repro.stores.store import RoundPayload as JPayload
from repro.stores.store import make_store as j_make_store
from repro.tiering import dequantize_int8 as j_dequantize
from repro.tiering import quantize_int8 as j_quantize
from repro.tiering.tiers import _write_cold_file as j_write_cold_file
from repro_torch.configs import FLConfig, OptimizerConfig, get_config
from repro_torch.core.tree import tree_leaves
from repro_torch.durability import load_snapshot, save_snapshot
from repro_torch.durability.session_state import (_capture_store,
                                                  _restore_store)
from repro_torch.faults import FaultPlan
from repro_torch.fl import FLSimulator
from repro_torch.fl.experiment import (FederatedSession, RequestSchedule,
                                       UnlearnRequest)
from repro_torch.models import from_numpy_params
from repro_torch.stores import STORES, RoundPayload, StoreStats, make_store
from repro_torch.telemetry.metrics import MetricsRegistry
from repro_torch.tiering import (EVICTION, TIER_ORDER, TIERS, TierEntry,
                                 TieredStore, dequantize_int8, make_eviction,
                                 quant_error_bound, quantize_int8)
from repro_torch.tiering.tiers import _write_cold_file, cold_file_crc

torch.set_num_threads(1)
FAULT_SEED = 20240                # tests/test_tiering.py's
TINY = dict(image_size=8, d_model=16, cnn_channels=(4, 4))
FL_TINY = dict(num_clients=8, clients_per_round=8, num_shards=2,
               local_epochs=1, global_rounds=3, retrain_ratio=2.0)
SEED = 3
JCFG = dataclasses.replace(jget("cnn-paper"), **TINY)
TCFG = dataclasses.replace(get_config("cnn-paper"), **TINY)
POLICIES = ("lru", "stage_age", "heat")


def _clients():
    data = make_image_data(FL_TINY["num_clients"] * 12, image_size=8, seed=0)
    return client_datasets_images(data, FL_TINY["num_clients"], iid=True)


def _jax_init(salt):
    return from_numpy_params(jax.tree.map(
        np.asarray, jinit(JCFG, jax.random.key(SEED + salt))), device="cpu")


def _jsim():
    return JSim(JCFG, JFL(**FL_TINY), _clients(), task="image",
                opt_cfg=JOpt(name="sgdm", lr=0.05, grad_clip=0.0),
                local_batch=10, seed=SEED)


def _tsim():
    return FLSimulator(TCFG, FLConfig(**FL_TINY), _clients(), task="image",
                       opt_cfg=OptimizerConfig(name="sgdm", lr=0.05,
                                               grad_clip=0.0),
                       local_batch=10, seed=SEED, device="cpu",
                       init_fn=_jax_init)


def _bits(t) -> bytes:
    if isinstance(t, torch.Tensor):
        return t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.asarray(t).tobytes()


def _trees_equal(a, b):
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert x.dtype == y.dtype and _bits(x) == _bits(y)


def _unit_params(c=12, rounds=1, seed=1):
    rng = np.random.default_rng(seed)
    return [{cl: rng.standard_normal(5).astype(np.float32)
             for cl in range(c)} for _ in range(rounds)]


def _shards(c=12, s=4):
    per = c // s
    return {i: list(range(i * per, (i + 1) * per)) for i in range(s)}


def _unit_store(kind="tiered", rounds=1, seed=1, **opts):
    """tests/test_tiering.py's ``_unit_store`` on the port."""
    shards = _shards()
    store = make_store(kind, shards, num_shards=4, num_clients=12, **opts)
    for rnd, params in enumerate(_unit_params(rounds=rounds, seed=seed)):
        store.put_round(RoundPayload.from_clients(
            rnd, shards, {c: {"w": torch.from_numpy(v)}
                          for c, v in params.items()}))
    store.flush()
    return store


def _j_unit_store(kind="tiered", rounds=1, seed=1, **opts):
    shards = _shards()
    store = j_make_store(kind, shards, num_shards=4, num_clients=12, **opts)
    for rnd, params in enumerate(_unit_params(rounds=rounds, seed=seed)):
        store.put_round(JPayload.from_clients(
            rnd, shards, {c: {"w": jnp.asarray(v)}
                          for c, v in params.items()}))
    store.flush()
    return store


# ------------------------------------------------------------- quantization
@pytest.mark.parametrize("seed,mag,bf16", [(0, 1.0, False), (1, 1e-3, False),
                                           (2, 1e3, False), (3, 1.0, True)])
def test_codec_byte_identical_to_reference(seed, mag, bf16):
    """Same float32 (or bf16) input: the same q, scales and dequantized
    bits, a zero row included; re-quantizing the dequantized tensor with
    the stored scales gives q again, in both packages."""
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal((9, 33)) * mag).astype(np.float32)
    a[4] = 0.0
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else \
        (jnp.float32, torch.float32)
    ja = jnp.asarray(a, jdt)
    ta = torch.from_numpy(a).to(tdt)
    jq, js = j_quantize(ja)
    tq, ts = quantize_int8(ta)
    assert tq.dtype == np.int8 and ts.dtype == np.float32
    assert tq.tobytes() == np.asarray(jq).tobytes()
    assert ts.tobytes() == np.asarray(js).tobytes()
    assert ts[4] == 1.0 and not tq[4].any()
    jback = j_dequantize(jq, js, dtype=jdt)
    tback = dequantize_int8(tq, ts, dtype=tdt)
    assert tback.dtype == tdt and tback.device.type == "cpu"
    assert _bits(tback) == np.asarray(jback).tobytes()
    tq2, ts2 = quantize_int8(tback, scales=ts)
    assert tq2.tobytes() == tq.tobytes() and ts2.tobytes() == ts.tobytes()
    err = np.abs(a.astype(np.float64) - tback.double().numpy())
    if not bf16:
        assert err.max() <= quant_error_bound(ts) + 1e-12


def test_cold_file_bytes_and_crc_match_reference(tmp_path):
    rng = np.random.default_rng(5)
    q, scales = quantize_int8(rng.standard_normal((6, 11)).astype(np.float32))
    crc = _write_cold_file(str(tmp_path / "port.tier"), q, scales)
    jcrc = j_write_cold_file(str(tmp_path / "ref.tier"), q, scales)
    assert crc == jcrc == cold_file_crc(str(tmp_path / "port.tier"))
    with open(tmp_path / "port.tier", "rb") as f, \
            open(tmp_path / "ref.tier", "rb") as g:
        assert f.read() == g.read()
    assert sorted(os.listdir(tmp_path)) == ["port.tier", "ref.tier"]


def test_dequantize_from_read_only_memmap(tmp_path):
    """A cold read hands ``dequantize_int8`` a read-only ``np.memmap``: the
    multiply goes to a fresh array, so no non-writable buffer reaches
    torch."""
    q, scales = quantize_int8(np.ones((3, 4), np.float32))
    path = str(tmp_path / "r.tier")
    _write_cold_file(path, q, scales)
    mm = np.memmap(path, dtype=np.int8, mode="r", shape=(3, 4))
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        back = dequantize_int8(mm, scales)
    assert back.tolist() == [[1.0] * 4] * 3


# -------------------------------------------------------------- tier ladder
def test_tiered_registered_and_unlimited_stays_hot():
    assert "tiered" in STORES
    store = _unit_store()
    assert isinstance(store, TieredStore)
    assert store.tier_of(0) == "hot"
    assert store.stats.tier_bytes["hot"] > 0
    store.get_shard(0, 0)
    assert store.stats.tier_hits == {"hot": 1}
    assert store.stats.tier_misses == {}


def test_zero_hot_budget_lands_warm_and_stays():
    store = _unit_store(hot_bytes=0)
    assert store.tier_of(0) == "warm"
    assert store.stats.tier_bytes["hot"] == 0
    store.get_shard(0, 0)
    assert store.tier_of(0) == "warm"
    assert store.stats.tier_hits == {"warm": 1}
    assert store.stats.tier_misses == {"hot": 1}
    assert store.stats.tier_promotions == {}


@pytest.mark.parametrize("slice_dtype", [None, "bfloat16"])
def test_promote_demote_read_is_bit_stable(tmp_path, slice_dtype):
    """Once lossy, every read reconstructs the same bits: through warm,
    cold, and promote-back-to-hot cycles; the cold file is written once,
    atomically, and its CRC is the entry's."""
    store = _unit_store(slice_dtype=slice_dtype, offload_dir=str(tmp_path))
    store.demote_all("warm")
    first = store.get_shard(0, 0)
    assert store.tier_of(0) == "hot"
    store.demote_all("warm")
    _trees_equal(first, store.get_shard(0, 0))
    store.demote_all("cold")
    assert store.tier_of(0) == "cold"
    e = store._slices.entry(0)
    assert cold_file_crc(e.path) == e.file_crc
    assert not any(f.endswith(".tmp") for f in os.listdir(store.cold_dir))
    before = os.path.getmtime(e.path)
    _trees_equal(first, store.get_shard(0, 0))
    store.demote_all("cold")
    _trees_equal(first, store.get_shard(0, 0))
    assert os.path.getmtime(e.path) == before
    assert store.stats.tier_promotions["hot"] == 4


def test_registries_and_victims():
    assert tuple(TIER_ORDER) == ("hot", "warm", "cold")
    assert set(TIER_ORDER) <= set(TIERS)
    assert set(POLICIES) <= set(EVICTION)
    with pytest.raises(KeyError):
        make_eviction("nope")
    with pytest.raises(ValueError, match="unknown tier"):
        _unit_store().demote_all("lukewarm")

    def entry(key, hits, last, stage):
        return TierEntry(key=key, shape=(2, 2), dtype=torch.float32,
                         hits=hits, last_access=last, stage=stage)
    cands = [entry(0, 9, 5, 2), entry(1, 1, 9, 0), entry(2, 1, 2, 1)]
    assert make_eviction("lru")(cands).key == 2
    assert make_eviction("stage_age")(cands).key == 1
    assert make_eviction("heat")(cands).key == 2
    assert cands[0].hot_nbytes() == 16
    e = TierEntry(key=0, shape=(2, 3), dtype=torch.bfloat16)
    assert (e.hot_nbytes(), e.warm_nbytes()) == (12, 14)


def test_admitted_view_is_copied_so_demotion_frees_it():
    """A round admitted as a view of the stage's (G, C, P) encode owns its
    storage in the table (demoting it frees its bytes)."""
    store = _unit_store()
    coded = torch.arange(2 * 12 * 5, dtype=torch.float32).reshape(2, 12, 5)
    with store._lock:
        store._slices[7] = coded[1]
    held = store._slices.entry(7).device
    assert torch.equal(held, coded[1])
    assert held.untyped_storage().data_ptr() != \
        coded.untyped_storage().data_ptr()


# --------------------------------------------- tier decisions vs reference
READS = [(0, 0), (1, 1), (2, 0), (0, 2), (3, 3), (1, 0), (2, 1), (3, 2),
         (0, 3), (2, 2), (1, 3), (0, 0)]
ROUND = 12 * 15 * 4               # hot bytes of one unit-store round
BUDGETS = {"unlimited": {}, "hot_two_rounds": dict(hot_bytes=2 * ROUND),
           "hot_two_warm_one": dict(hot_bytes=2 * ROUND,
                                    warm_bytes=12 * 15 + 48),
           "hot_below_a_round": dict(hot_bytes=ROUND - 1),
           "warm_only": dict(hot_bytes=0), "cold_only": dict(hot_bytes=0,
                                                            warm_bytes=0)}


def _tiers(store, rounds):
    return ({g: store.tier_of(g) for g in range(rounds)},
            {k: v for k, v in store.stats.to_dict().items()
             if k.startswith("tier_")})


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("budget", sorted(BUDGETS))
def test_tier_decisions_match_reference(tmp_path, budget, policy):
    """Four rounds put, then a fixed sequence of shard reads: after the puts
    and after every read, each round's tier and every ``tier_*`` dict equal
    the reference's; decoded shards agree within 1e-5."""
    opts = dict(BUDGETS[budget], eviction=policy)
    port = _unit_store(rounds=4, offload_dir=str(tmp_path / "p"), **opts)
    ref = _j_unit_store(rounds=4, offload_dir=str(tmp_path / "r"), **opts)
    assert _tiers(port, 4) == _tiers(ref, 4)
    for rnd, shard in READS:
        got, want = port.get_shard(rnd, shard), ref.get_shard(rnd, shard)
        assert _tiers(port, 4) == _tiers(ref, 4), (rnd, shard)
        for c in want:
            np.testing.assert_allclose(got[c]["w"].numpy(),
                                       np.asarray(want[c]["w"]),
                                       rtol=1e-5, atol=1e-5)
    assert port.stats.to_dict() == ref.stats.to_dict()


def _schedule(request=UnlearnRequest, schedule=RequestSchedule):
    return schedule([request(lambda p: [p.shard_clients[0][0]],
                             framework="SE", after_stage=0, rounds=1)])


@pytest.mark.parametrize("policy", POLICIES)
def test_session_tier_decisions_match_reference(tmp_path, policy):
    """The tiny session on a tiered store at half the stage's slice bytes
    under each policy, one SE request: per-round tiers and every ``tier_*``
    dict equal the reference's, and the SE models agree within the session
    tests' rtol 1e-4 / atol 1e-5."""
    half = 3 * 8 * 2520 * 4 // 2
    opts = dict(hot_bytes=half, eviction=policy)
    ref = JSession(_jsim(), store_kind="tiered", engine="stage",
                   store_options=dict(opts, offload_dir=str(tmp_path / "r")))
    ref.run(1, schedule=_schedule(JRequest, JSchedule))
    port = FederatedSession(_tsim(), store_kind="tiered", engine="stage",
                            store_options=dict(opts,
                                               offload_dir=str(tmp_path)))
    port.run(1, schedule=_schedule())
    assert port.records[0].store._slices.entry(0).shape == (8, 2520)
    assert _tiers(port.records[0].store, 3) == _tiers(ref.records[0].store,
                                                      3)
    assert port.report.store_stats.to_dict() == \
        ref.report.store_stats.to_dict()
    (jres,), (tres,) = ref.report.stages[0].unlearn, \
        port.report.stages[0].unlearn
    assert tres.impacted_shards == jres.impacted_shards
    for s in jres.models:
        for a, b in zip(jax.tree.leaves(jres.models[s]),
                        tree_leaves(tres.models[s])):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4,
                                       atol=1e-5)


# ------------------------------------------------- session-level acceptance
def _run(store, store_options=None):
    session = FederatedSession(_tsim(), store_kind=store, engine="stage",
                               store_options=store_options or {})
    return session, session.run(1, schedule=_schedule())


@pytest.fixture(scope="module")
def coded_run():
    return _run("coded")


def test_unlimited_is_bit_identical_to_coded(coded_run):
    sess_c, rep_c = coded_run
    sess_t, rep_t = _run("tiered")
    for s in sess_c.records[0].shard_models:
        _trees_equal(sess_c.records[0].shard_models[s],
                     sess_t.records[0].shard_models[s])
    store_c, store_t = sess_c.records[0].store, sess_t.records[0].store
    assert sorted(store_c._slices) == sorted(store_t._slices)
    for g in store_c._slices:
        assert _bits(store_c._slices[g]) == _bits(store_t._slices[g])
    (res_c,), (res_t,) = rep_c.stages[0].unlearn, rep_t.stages[0].unlearn
    assert res_c.impacted_shards == res_t.impacted_shards
    assert res_c.cost_units == res_t.cost_units
    for s in res_c.models:
        _trees_equal(res_c.models[s], res_t.models[s])
    got_c, got_t = rep_c.store_stats.to_dict(), rep_t.store_stats.to_dict()
    for k in got_c:
        if not k.startswith("tier_"):
            assert got_c[k] == got_t[k], k
    assert got_t["tier_hits"].get("hot", 0) > 0
    assert got_t["tier_misses"] == {}
    assert rep_t.to_dict()["store_stats"]["tier_bytes"]["hot"] > 0


def test_se_served_from_cold_within_reference_bound(coded_run, tmp_path):
    """hot = warm = 0: every stored round is on disk and every decode an
    int8 reconstruction; SE lands within tests/test_tiering.py's relative
    2e-2 and max-abs 2e-2 of the exact store's models."""
    sess, rep = _run("tiered", dict(hot_bytes=0, warm_bytes=0,
                                    offload_dir=str(tmp_path)))
    stats = rep.store_stats
    assert set(stats.tier_hits) == {"cold"}
    assert stats.tier_bytes.get("hot", 0) == 0
    assert stats.tier_bytes.get("warm", 0) == 0
    assert stats.tier_hits["cold"] == stats.tier_misses["hot"] \
        == stats.tier_misses["warm"]
    sess_c, rep_c = coded_run
    for s in sess_c.records[0].shard_models:
        _trees_equal(sess_c.records[0].shard_models[s],
                     sess.records[0].shard_models[s])
    (res_c,), (res_t,) = rep_c.stages[0].unlearn, rep.stages[0].unlearn
    assert res_c.impacted_shards == res_t.impacted_shards
    for s in res_c.models:
        diff = torch.cat([(x.double() - y.double()).reshape(-1) for x, y in
                          zip(tree_leaves(res_c.models[s]),
                              tree_leaves(res_t.models[s]))])
        ref = torch.cat([x.double().reshape(-1)
                         for x in tree_leaves(res_c.models[s])])
        assert float(diff.norm() / (ref.norm() + 1e-12)) < 2e-2
        assert float(diff.abs().max()) < 2e-2


# ------------------------------------------------------ cold-tier corruption
def test_cold_corrupt_recovers_and_is_accounted():
    clean = _unit_store(seed=7)
    clean.demote_all("cold")
    base = clean.get_shard(0, 0)
    store = _unit_store(seed=7)
    store.demote_all("cold")
    plan = FaultPlan(seed=FAULT_SEED).add("cold_corrupt", count=2,
                                          scale=10.0)
    store.attach_faults(plan)
    got = store.get_shard(0, 0)
    for cl in base:
        np.testing.assert_allclose(got[cl]["w"].numpy(),
                                   base[cl]["w"].numpy(), atol=1e-4)
    assert store.stats.corrupted_slices == 2
    assert store.stats.recovered_reads == 1
    assert plan.ledger.count("cold_corrupt") == 1
    assert plan.ledger.count("quorum_read") == 1
    # the reference flags the same rows of the same round
    from repro.faults import FaultPlan as JFaultPlan
    jstore = _j_unit_store(seed=7)
    jstore.demote_all("cold")
    jplan = JFaultPlan(seed=FAULT_SEED).add("cold_corrupt", count=2,
                                            scale=10.0)
    jstore.attach_faults(jplan)
    jstore.get_shard(0, 0)
    assert [(e.kind, e.site, e.detail) for e in plan.ledger.events] == \
        [(e.kind, e.site, e.detail) for e in jplan.ledger.events]


def test_cold_corrupt_is_inert_for_hot_reads():
    store = _unit_store(seed=7)
    store.attach_faults(FaultPlan(seed=FAULT_SEED).add("cold_corrupt",
                                                       count=2, scale=10.0))
    store.get_shard(0, 0)
    assert store.stats.corrupted_slices == 0
    assert store.stats.recovered_reads == 0


def test_quant_residue_is_not_flagged_as_corruption():
    store = _unit_store(seed=7)
    store.demote_all("cold")
    store.attach_faults(FaultPlan(seed=FAULT_SEED))
    store.get_shard(0, 0)
    assert store.stats.corrupted_slices == 0
    assert store.stats.recovered_reads == 0


# ------------------------------------------------------- snapshot round-trip
def _mixed_store(tmp_path):
    store = _unit_store(rounds=2, offload_dir=str(tmp_path))
    store.demote_all("cold")
    store.get_shard(1, 0)          # promote round 1 back to hot
    assert store.tier_of(0) == "cold" and store.tier_of(1) == "hot"
    return store


def test_tiered_snapshot_round_trip_is_bit_identical(tmp_path):
    store = _mixed_store(tmp_path)
    path = str(tmp_path / "store.ckpt")
    save_snapshot(path, _capture_store(store))
    back = _restore_store(load_snapshot(path))
    assert isinstance(back, TieredStore)
    assert back.budget == store.budget and back.eviction == store.eviction
    for rnd in (0, 1):
        assert back.tier_of(rnd) == store.tier_of(rnd)
    assert back.stats.to_dict() == store.stats.to_dict()
    for rnd in (0, 1):
        for s in range(4):
            want, got = store.get_shard(rnd, s), back.get_shard(rnd, s)
            for cl in want:
                _trees_equal(want[cl], got[cl])


@pytest.mark.parametrize("how", ["corrupt", "missing"])
def test_restore_rejects_bad_cold_file(tmp_path, how):
    store = _mixed_store(tmp_path)
    state = _capture_store(store)
    cold = store._slices.entry(0).path
    if how == "missing":
        os.remove(cold)
        with pytest.raises(FileNotFoundError):
            _restore_store(state)
    else:
        with open(cold, "r+b") as f:
            f.seek(3)
            f.write(b"\xff\xff")
        with pytest.raises(IOError, match="crc"):
            _restore_store(state)


# ------------------------------------------------------------------ threads
def test_concurrent_reads_keep_table_consistent(tmp_path):
    """Sixteen threads (more than the cores) read a lossy store under a
    tight budget with a shortened switch interval: every read returns the
    canonical bits, every read counts one hit, and each tier's byte count
    equals the bytes of the entries it holds (a lost update would break
    either count)."""
    import random
    import sys
    import threading
    store = _unit_store(rounds=4, hot_bytes=2 * ROUND,
                        warm_bytes=12 * 15 + 48, offload_dir=str(tmp_path))
    store.demote_all("cold")
    want = {(r, s): store.get_shard(r, s) for r in range(4) for s in range(4)}
    hits0 = sum(store.stats.tier_hits.values())
    bad, per = [], 40

    def reader(seed):
        rng = random.Random(seed)
        for _ in range(per):
            key = (rng.randrange(4), rng.randrange(4))
            got = store.get_shard(*key)
            if any(_bits(got[c]["w"]) != _bits(want[key][c]["w"])
                   for c in got):
                bad.append(key)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=reader, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not bad
    assert sum(store.stats.tier_hits.values()) - hits0 == 16 * per
    held = {}
    for e in store._slices.entries().values():
        held[e.tier] = held.get(e.tier, 0) + e.nbytes()
    assert {t: b for t, b in store.stats.tier_bytes.items() if b} == held
    assert held.get("hot", 0) <= 2 * ROUND


# ------------------------------------------------------------------ metrics
def test_tier_stats_fan_out_into_per_tier_gauges():
    a = StoreStats(tier_bytes={"hot": 10}, tier_hits={"hot": 2})
    b = StoreStats(tier_bytes={"hot": 5, "warm": 7}, tier_evictions={"hot": 1})
    assert (a + b).tier_bytes == {"hot": 15, "warm": 7}
    reg = MetricsRegistry()
    reg.absorb_store_stats(StoreStats(reads=3,
                                      tier_bytes={"hot": 8, "warm": 2},
                                      tier_hits={"cold": 1}), stage=0)
    gauges = reg.snapshot()["gauges"]
    tiered = {k: v for k, v in gauges.items() if "tier=" in k}
    assert any("store.tier_bytes" in k and "tier=hot" in k and v == 8
               for k, v in tiered.items())
    assert any("store.tier_bytes" in k and "tier=warm" in k and v == 2
               for k, v in tiered.items())
    assert any("store.tier_hits" in k and "tier=cold" in k and v == 1
               for k, v in tiered.items())
