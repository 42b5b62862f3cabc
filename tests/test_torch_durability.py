"""Durability of the PyTorch port on the CPU: the checksummed snapshot format
(torch tensors as raw bytes, every dtype bit-exact and never promoted; the
reference's files read back), checkpoint rotation with corrupt-snapshot
fallback, the ``ScenarioConfig`` checkpoint knobs, in-process crash and
resume bit-identical to the uninterrupted run, the same crash scenario in
both packages (journal events and audit heads equal, models within the
session tests' rtol 1e-4 / atol 1e-5), and a real ``os._exit(137)`` kill
and resume through ``chip_smoke.py durability-child --device cpu``.

The sessions are tests/test_durability.py's tiny CNN (8x8, channels 4/4,
fc 16; 10 clients, 8 a stage, S = 2, L = 2, G = 2), fed the reference's
initial weights through ``init_fn``."""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import FLConfig as JFL
from repro.configs import OptimizerConfig as JOpt
from repro.configs import get_config as jget
from repro.core.coding import CodingScheme as JScheme
from repro.core.sharding import StagePlan as JPlan
from repro.data import client_datasets_images, make_image_data
from repro.durability import save_snapshot as j_save_snapshot
from repro.faults import FaultPlan as JFaultPlan
from repro.faults import InjectedCrash as JInjectedCrash
from repro.fl import FLSimulator as JSim
from repro.fl.experiment import FederatedSession as JSession
from repro.fl.experiment import RequestSchedule as JSchedule
from repro.fl.experiment import UnlearnRequest as JRequest
from repro.models import init_params as jinit
from repro.stores.store import StoreStats as JStats
from repro_torch.configs import FLConfig, OptimizerConfig, get_config
from repro_torch.core.coding import CodingScheme, StackedRowSpec
from repro_torch.core.sharding import StagePlan
from repro_torch.core.tree import tree_leaves
from repro_torch.durability import (CheckpointManager, Journal,
                                    SnapshotCorruption, capture_session,
                                    load_snapshot, restore_session,
                                    save_snapshot)
from repro_torch.faults import FaultPlan, InjectedCrash
from repro_torch.fl import FLSimulator
from repro_torch.fl.experiment import (FederatedSession, RequestSchedule,
                                       ScenarioConfig, UnlearnRequest)
from repro_torch.models import from_numpy_params
from repro_torch.stores import StoreStats

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from chip_smoke import session_signature  # noqa: E402

torch.set_num_threads(1)
TINY = dict(image_size=8, d_model=16, cnn_channels=(4, 4))
FL_TINY = dict(num_clients=10, clients_per_round=8, num_shards=2,
               local_epochs=2, global_rounds=2, retrain_ratio=2.0)
NUM_STAGES = 2
TOL = dict(rtol=1e-4, atol=1e-5)          # tests/test_torch_session.py's
JCFG = dataclasses.replace(jget("cnn-paper"), **TINY)
TCFG = dataclasses.replace(get_config("cnn-paper"), **TINY)


def _clients():
    data = make_image_data(FL_TINY["num_clients"] * 30, image_size=8, seed=0)
    return client_datasets_images(data, FL_TINY["num_clients"], iid=True)


def _jax_init(salt):
    return from_numpy_params(jax.tree.map(
        np.asarray, jinit(JCFG, jax.random.key(salt))), device="cpu")


def _jsim():
    return JSim(JCFG, JFL(**FL_TINY), _clients(), task="image",
                opt_cfg=JOpt(name="sgdm", lr=0.05, grad_clip=0.0),
                local_batch=10, seed=0)


def _tsim():
    return FLSimulator(TCFG, FLConfig(**FL_TINY), _clients(), task="image",
                       opt_cfg=OptimizerConfig(name="sgdm", lr=0.05,
                                               grad_clip=0.0),
                       local_batch=10, seed=0, device="cpu",
                       init_fn=_jax_init)


def _schedule(request=UnlearnRequest, schedule=RequestSchedule):
    return schedule([
        request(lambda p: [p.shard_clients[0][0]], framework="SE",
                after_stage=0, rounds=1),
        request(lambda p: [p.shard_clients[1][0]], framework="SE",
                after_stage=1, rounds=1),
    ])


def _pairs(session):
    return [(i, u.request_id) for i, st in enumerate(session.report.stages)
            for u in st.unlearn]


def _bits(t: torch.Tensor) -> bytes:
    return t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


# -------------------------------------------------------------- snapshot fmt
_DTYPES = ["float32", "float16", "bfloat16", "int32", "int8", "uint8"]


def _tensor(dtype: str, seed: int = 0, n: int = 37) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    dt = getattr(torch, dtype)
    if not dt.is_floating_point:
        info = torch.iinfo(dt)
        return torch.as_tensor(rng.integers(info.min, info.max, size=n)
                               ).to(dt)
    return torch.as_tensor(rng.standard_normal(n) * 1e3, dtype=torch.float32
                           ).to(dt)


@pytest.mark.parametrize("dtype", _DTYPES)
def test_tensor_roundtrip_bit_exact_never_promoted(tmp_path, dtype):
    """A tensor of every slice/parameter dtype comes back with its dtype,
    shape and bits (a strided view, a 0-d and an empty tensor too)."""
    t = _tensor(dtype).reshape(1, 37)
    obj = {("coded", 0): [t, None], "view": t[:, ::3], "scalar": t[0, 5],
           "empty": t[:, :0], "dtype": t.dtype}
    path = str(tmp_path / "s.ckpt")
    assert save_snapshot(path, obj) == os.path.getsize(path)
    back = load_snapshot(path)
    for key, want in ((("coded", 0), t), ("view", t[:, ::3]),
                      ("scalar", t[0, 5]), ("empty", t[:, :0])):
        got = back[key][0] if key == ("coded", 0) else back[key]
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        assert got.dtype == want.dtype and got.shape == want.shape
        assert _bits(got) == _bits(want)
    assert back[("coded", 0)][1] is None
    assert back["dtype"] is t.dtype


def test_object_graph_roundtrip(tmp_path):
    """numpy arrays, StoreStats, CodingScheme, a StackedRowSpec with its
    torch-dtype row spec, StagePlan, sets, tuples and int-keyed dicts."""
    rng = np.random.default_rng(0)
    row_spec = ([("b",), ("w",)], [((2,), torch.float32),
                                   ((3, 2), torch.bfloat16)], [("rem",)])
    obj = {
        "arr": rng.standard_normal((3, 4)),
        "i8": rng.integers(-127, 127, (2, 5)).astype(np.int8),
        "np_scalar": np.float32(2.5),
        "np_dtype": np.dtype("int16"),
        "stats": StoreStats(server_bytes=12, reads=3,
                            tier_bytes={"hot": 8, "warm": 2},
                            tier_hits={"cold": 1}),
        "scheme": CodingScheme(num_shards=2, num_clients=5),
        "spec": StackedRowSpec((0, 1, 2), 8, row_spec),
        "plan": StagePlan(stage=3, shard_clients={0: [1, 4], 1: [2, 7]}),
        "served": {"req-s0-0", "req-s1-0"},
        "norms": {(0, 1, 7): 0.25, (1, 0, 2): -0.0},
        "rng": {"state": 12345678901234567890, "pos": 17},
        "scalars": (None, True, 2.5, -0.0, "text"),
    }
    path = str(tmp_path / "s.ckpt")
    save_snapshot(path, obj)
    back = load_snapshot(path)
    for k in ("arr", "i8", "np_scalar"):
        assert back[k].dtype == np.asarray(obj[k]).dtype
        assert back[k].shape == np.asarray(obj[k]).shape
        assert back[k].tobytes() == np.asarray(obj[k]).tobytes()
    assert back["np_dtype"] == np.dtype("int16")
    assert back["stats"] == obj["stats"]
    assert back["scheme"].num_shards == 2 and back["scheme"].num_clients == 5
    assert back["scheme"].alpha.tobytes() == obj["scheme"].alpha.tobytes()
    assert back["scheme"].omega.tobytes() == obj["scheme"].omega.tobytes()
    assert back["spec"] == obj["spec"]
    assert back["plan"] == obj["plan"]
    for k in ("served", "norms", "rng", "scalars"):
        assert back[k] == obj[k] and type(back[k]) is type(obj[k])


def test_atomic_commit_leaves_no_tmp(tmp_path):
    save_snapshot(str(tmp_path / "s.ckpt"), {"a": torch.ones(3)})
    assert os.listdir(tmp_path) == ["s.ckpt"]


def _corrupt(path, how):
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        if how == "truncate":
            f.truncate(size // 2)
        elif how == "torn_tail":
            f.truncate(size - 3)
        elif how == "bit_flip":
            f.seek(size - 8)
            chunk = f.read(8)
            f.seek(size - 8)
            f.write(bytes(b ^ 0xFF for b in chunk))
        else:
            f.seek(0)
            f.write(b"NOTASNAP")


@pytest.mark.parametrize("how,match", [
    ("truncate", "torn write"), ("torn_tail", "torn write"),
    ("bit_flip", "checksum mismatch"), ("magic", "bad magic")])
def test_corruption_detected(tmp_path, how, match):
    path = str(tmp_path / "s.ckpt")
    save_snapshot(path, {"w": _tensor("bfloat16"), "n": np.arange(9)})
    _corrupt(path, how)
    with pytest.raises(SnapshotCorruption, match=match):
        load_snapshot(path)


def test_missing_file_is_corruption(tmp_path):
    with pytest.raises(SnapshotCorruption, match="unreadable"):
        load_snapshot(str(tmp_path / "nope.ckpt"))


def test_reads_reference_snapshot(tmp_path):
    """A file the reference's ``save_snapshot`` wrote (numpy arrays with
    bfloat16 through ml_dtypes, a device array, StoreStats, CodingScheme,
    StagePlan) loads in the port to equal values: numpy's own dtypes as
    numpy arrays, bf16 and the device array as torch tensors."""
    import ml_dtypes
    rng = np.random.default_rng(1)
    f32 = rng.standard_normal((4, 3)).astype(np.float32)
    bf16 = f32.astype(ml_dtypes.bfloat16)
    obj = {"f32": f32, "bf16": bf16, "i8": np.arange(-3, 4, dtype=np.int8),
           "dev": jax.numpy.arange(6, dtype=jax.numpy.int32),
           "stats": JStats(server_bytes=40, corrupted_slices=2,
                           tier_hits={"warm": 3}),
           "scheme": JScheme(num_shards=3, num_clients=7),
           "plan": JPlan(stage=1, shard_clients={0: [3, 5], 1: [1, 8]}),
           "keys": {(0, 1): "a", 2: [1.5, None]}}
    path = str(tmp_path / "ref.ckpt")
    j_save_snapshot(path, obj)
    back = load_snapshot(path)
    assert back["f32"].dtype == np.float32
    assert back["f32"].tobytes() == f32.tobytes()
    assert back["i8"].tobytes() == obj["i8"].tobytes()
    assert isinstance(back["bf16"], torch.Tensor)
    assert back["bf16"].dtype == torch.bfloat16
    assert _bits(back["bf16"]) == bf16.tobytes()
    assert isinstance(back["dev"], torch.Tensor)
    assert back["dev"].tolist() == list(range(6))
    assert back["dev"].dtype == torch.int32
    assert back["stats"].to_dict() == obj["stats"].to_dict()
    assert back["scheme"].alpha.tobytes() == obj["scheme"].alpha.tobytes()
    assert back["scheme"].omega.tobytes() == obj["scheme"].omega.tobytes()
    assert (back["plan"].stage, back["plan"].shard_clients) == \
        (1, {0: [3, 5], 1: [1, 8]})
    assert back["keys"] == obj["keys"]


# -------------------------------------------------------- checkpoint manager
def test_checkpoint_rotation_keeps_the_newest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for step in range(4):
        mgr.save({"step": step, "w": torch.full((2,), float(step))}, step)
    assert mgr.steps() == [2, 3]
    state, step, path = mgr.load_latest()
    assert step == 3 and state["step"] == 3
    assert state["w"].tolist() == [3.0, 3.0]
    assert path.endswith("snap-000003.ckpt")
    assert CheckpointManager(str(tmp_path), keep=1).keep == 2


def test_checkpoint_corrupt_newest_falls_back(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    for step in range(3):
        mgr.save({"step": step}, step)
    bad = mgr.snapshot_path(2)
    _corrupt(bad, "truncate")
    state, step, _path = mgr.load_latest()
    assert state == {"step": 1} and step == 1
    assert mgr.skipped == [bad]
    assert CheckpointManager(str(tmp_path / "empty")).load_latest() is None


# ---------------------------------------------------------- scenario knobs
@pytest.mark.parametrize("kwargs,match", [
    (dict(checkpoint_every=-1), "checkpoint_every=-1"),
    (dict(checkpoint_every=2), "needs a checkpoint_dir"),
    (dict(checkpoint_dir="/proc/definitely/not/writable"), "not writable"),
])
def test_scenario_checkpoint_validation(kwargs, match):
    with pytest.raises(ValueError, match=match):
        ScenarioConfig(**kwargs)


def test_scenario_checkpoint_knobs_reach_the_session(tmp_path):
    from repro_torch.fl.experiment import build_session
    ck = str(tmp_path / "ck")
    cfg = ScenarioConfig(checkpoint_every=2, checkpoint_dir=ck,
                         num_clients=4, clients_per_round=4, num_shards=2,
                         samples_per_client=4, test_n=4)
    session, _test = build_session(cfg, device="cpu")
    assert session.checkpoint_every == 2
    assert os.path.abspath(session.checkpointer.directory) == \
        os.path.abspath(ck)
    with pytest.raises(ValueError, match="needs a"):
        FederatedSession(_tsim(), checkpoint_every=1)


# --------------------------------------------------- crash/resume in process
@pytest.fixture(scope="module")
def baseline():
    """The uninterrupted, checkpoint-free port run: the oracle every
    crashed and resumed run must match bit for bit."""
    session = FederatedSession(_tsim(), store_kind="coded")
    session.run(NUM_STAGES, schedule=_schedule())
    return session_signature(session)


def test_crash_after_requests_resumes_bit_identical(tmp_path, baseline):
    ck = str(tmp_path / "ck")
    plan = FaultPlan(seed=7).add("process_kill", stage=1,
                                 phase="after_requests", mode="raise")
    crashed = FederatedSession(_tsim(), store_kind="coded", faults=plan,
                               checkpoint_every=1, checkpoint_dir=ck)
    with pytest.raises(InjectedCrash):
        crashed.run(NUM_STAGES, schedule=_schedule())
    assert plan.ledger.count("process_kill") == 1
    assert crashed.checkpointer.steps() == [0]     # died before snap-1
    resumed = FederatedSession(_tsim(), store_kind="coded",
                               checkpoint_every=1, checkpoint_dir=ck)
    resumed.run(NUM_STAGES, schedule=_schedule(), resume_from=ck)
    info = resumed.last_resume_info
    assert info["step"] == 0 and info["start_stage"] == 1
    assert session_signature(resumed) == baseline
    pairs = _pairs(resumed)
    assert len(pairs) == len(set(pairs))           # once per impacted stage
    assert {rid for _, rid in pairs} == {"req-s0-0", "req-s1-0"}


def test_torn_snapshot_falls_back_to_previous_good(tmp_path, baseline):
    ck = str(tmp_path / "ck")
    plan = (FaultPlan(seed=7).add("torn_write", step=1, frac=0.4)
            .add("process_kill", stage=1, phase="after_snapshot",
                 mode="raise"))
    crashed = FederatedSession(_tsim(), store_kind="coded", faults=plan,
                               checkpoint_every=1, checkpoint_dir=ck)
    with pytest.raises(InjectedCrash):
        crashed.run(NUM_STAGES, schedule=_schedule())
    assert plan.ledger.count("torn_write") == 1
    resumed = FederatedSession(_tsim(), store_kind="coded")
    resumed.run(NUM_STAGES, schedule=_schedule(), resume_from=ck)
    info = resumed.last_resume_info
    assert len(info["skipped_snapshots"]) == 1
    assert info["step"] == 0 and info["start_stage"] == 1
    assert session_signature(resumed) == baseline
    pairs = _pairs(resumed)
    assert len(pairs) == len(set(pairs))


def test_resume_from_empty_dir_raises(tmp_path):
    session = FederatedSession(_tsim(), store_kind="coded")
    with pytest.raises(FileNotFoundError, match="no usable snapshot"):
        session.run(NUM_STAGES, resume_from=str(tmp_path / "empty"))


def test_resume_rejects_mismatched_store_kind(tmp_path):
    ck = str(tmp_path / "ck")
    session = FederatedSession(_tsim(), store_kind="coded",
                               checkpoint_every=1, checkpoint_dir=ck)
    session.run(1)
    other = FederatedSession(_tsim(), store_kind="full")
    with pytest.raises(ValueError, match="store_kind"):
        other.run(NUM_STAGES, resume_from=ck)


@pytest.mark.parametrize("store_kind", ["full", "uncoded", "tiered"])
def test_capture_restore_other_stores(tmp_path, store_kind):
    """A stage on each other store kind captures, saves, loads and restores
    into a fresh session to the same signature (lazy stacked rows of the
    uncoded stores materialized; the tiered store's table rebuilt)."""
    session = FederatedSession(_tsim(), store_kind=store_kind)
    session.run(1, schedule=RequestSchedule(_schedule().requests[:1]))
    path = str(tmp_path / "s.ckpt")
    save_snapshot(path, capture_session(session))
    back = FederatedSession(_tsim(), store_kind=store_kind)
    assert restore_session(back, load_snapshot(path)) == 1
    assert session_signature(back) == session_signature(session)


# --------------------------------------------------- against the reference
@pytest.fixture(scope="module")
def crashed_pair(tmp_path_factory):
    """The same crash (stage 1, after its requests) and resume, in both
    packages, each from the reference's initial weights."""
    out = {}
    for name, session_cls, plan_cls, crash, req, sched, sim in (
            ("ref", JSession, JFaultPlan, JInjectedCrash, JRequest,
             JSchedule, _jsim),
            ("port", FederatedSession, FaultPlan, InjectedCrash,
             UnlearnRequest, RequestSchedule, _tsim)):
        ck = str(tmp_path_factory.mktemp(name) / "ck")
        plan = plan_cls(seed=7).add("process_kill", stage=1,
                                    phase="after_requests", mode="raise")
        crashed = session_cls(sim(), store_kind="coded", faults=plan,
                              checkpoint_every=1, checkpoint_dir=ck)
        with pytest.raises(crash):
            crashed.run(NUM_STAGES, schedule=_schedule(req, sched))
        resumed = session_cls(sim(), store_kind="coded", checkpoint_every=1,
                              checkpoint_dir=ck)
        resumed.run(NUM_STAGES, schedule=_schedule(req, sched),
                    resume_from=ck)
        out[name] = (resumed, ck)
    return out


def test_journal_and_audit_match_reference(crashed_pair):
    (ref, ref_ck), (port, port_ck) = crashed_pair["ref"], crashed_pair["port"]
    from repro.durability import Journal as JJournal
    want = JJournal(os.path.join(ref_ck, "journal.wal")).events()
    got = Journal(os.path.join(port_ck, "journal.wal")).events()
    assert [e["ev"] for e in got] == [e["ev"] for e in want]
    assert got == want
    assert port.audit.head == ref.audit.head
    assert port.audit.verify() == ref.audit.verify()
    assert port.last_resume_info["inflight"] == \
        ref.last_resume_info["inflight"]


def test_resumed_models_match_reference(crashed_pair):
    ref, port = crashed_pair["ref"][0], crashed_pair["port"][0]
    assert [r.plan.shard_clients for r in port.records] == \
        [r.plan.shard_clients for r in ref.records]
    for jr, tr in zip(ref.records, port.records):
        for s in jr.shard_models:
            for a, b in zip(jax.tree.leaves(jr.shard_models[s]),
                            tree_leaves(tr.shard_models[s])):
                np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)
        for g in jr.store._slices:
            np.testing.assert_allclose(tr.store._slices[g].numpy(),
                                       np.asarray(jr.store._slices[g]),
                                       **TOL)
        assert tr.store.stats.to_dict() == jr.store.stats.to_dict()
    assert _pairs(port) == _pairs(ref)
    jres = [u for st in ref.report.stages for u in st.unlearn]
    tres = [u for st in port.report.stages for u in st.unlearn]
    for ju, tu in zip(jres, tres):
        assert tu.impacted_shards == ju.impacted_shards
        assert tu.cost_units == ju.cost_units
        for s in ju.models:
            for a, b in zip(jax.tree.leaves(ju.models[s]),
                            tree_leaves(tu.models[s])):
                np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)


# --------------------------------------------------- kill in a subprocess
def test_killed_session_resumes_bit_identical(tmp_path):
    """``os._exit(137)`` after stage 1's requests (no atexit, no flushes),
    then a fresh process resumes from the snapshots and the journal to the
    uninterrupted run's signature, through the child mode of
    ``chip_smoke.py`` on the CPU."""
    def run(mode, ckpt):
        return subprocess.run(
            [sys.executable, str(ROOT / "chip_smoke.py"), "durability-child",
             mode, ckpt, "--device", "cpu"], cwd=str(ROOT),
            capture_output=True, text=True, timeout=300)

    ck = str(tmp_path / "ck")
    crash = run("crash", ck)
    assert crash.returncode == 137, crash.stderr[-2000:]
    assert sorted(os.listdir(ck)) == ["journal.wal", "snap-000000.ckpt"]
    resume = run("resume", ck)
    assert resume.returncode == 0, resume.stderr[-2000:]
    got = json.loads(resume.stdout.strip().splitlines()[-1])
    assert got["start_stage"] == 1 and got["resumed_step"] == 0
    assert got["request_ids"] == ["req-s0-0", "req-s1-0", "req-s2-0"]
    assert got["once_per_stage"]
    base = run("baseline", str(tmp_path / "unused"))
    assert base.returncode == 0, base.stderr[-2000:]
    assert got["sig"] == json.loads(
        base.stdout.strip().splitlines()[-1])["sig"]
