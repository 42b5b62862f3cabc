"""The generation task with the mamba family through the port's federated
path, against the reference on the CPU (kernels' plain versions).

The reference runs the tiny scenario of tests/test_scenario_zoo.py once
(8 clients, 4 per stage, S=2, L=1, G=2, zipf-partitioned char data, 6
sequences of 16 tokens per client, batch 2, sgd lr 0.1) with one SE
request; the port runs the same scenario from the reference's stage-0
weights (its ``init_fn`` hook).  StoreStats and cost units are exact, SE
isolation is bit-identical, and models, coded slices and update norms agree
within rtol 1e-4 / atol 1e-4: five times the largest difference measured
(2.0e-5 abs, on the coded slices; fp32 sums in another order, amplified by
the stage's SGD steps at lr 0.1).
"""
import jax
import numpy as np
import pytest
import torch

from repro.data.federated import get_partitioner as jpartitioner
from repro.data.synthetic import lm_examples as j_lm_examples
from repro.data.synthetic import make_char_data as j_make_char_data
from repro.fl.experiment import RequestSchedule as JSchedule
from repro.fl.experiment import ScenarioConfig as JScenario
from repro.fl.experiment import UnlearnRequest as JRequest
from repro.fl.experiment import build_session as j_build_session
from repro.fl.families import get_model_family as jfamily
from repro.fl.tasks import get_task as jtask
from repro_torch.core import coding
from repro_torch.core.tree import leaves_with_paths, tree_leaves, tree_map
from repro_torch.data.federated import get_partitioner
from repro_torch.data.synthetic import lm_examples, make_char_data
from repro_torch.fl.experiment import (RequestSchedule, ScenarioConfig,
                                       UnlearnRequest, build_session,
                                       run_scenario, train_stage)
from repro_torch.fl.experiment import build_simulator
from repro_torch.fl.families import get_model_family
from repro_torch.fl.tasks import get_task
from repro_torch.models import from_numpy_params, init_params
from repro_torch.stores.store import RoundPayload, make_store

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-4)
ZOO = dict(task="generation", model="mamba", partitioner="zipf",
           partitioner_kwargs={"exponent": 0.5}, store="coded", num_clients=8,
           clients_per_round=4, num_shards=2, local_epochs=1, global_rounds=2,
           samples_per_client=6, seq_len=16, test_n=20, local_batch=2,
           num_stages=1)


def _first_of_shard0(plan):
    return [plan.shard_clients[0][0]]


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _assert_trees_close(got, want, **tol):
    for (path, g), w in zip(leaves_with_paths(got), tree_leaves(want)):
        np.testing.assert_allclose(_np(g), _np(w), err_msg="/".join(path),
                                   **tol)


# ------------------------------------------------------------------ data

@pytest.mark.parametrize("n,vocab,seed", [(500, 109, 0), (2049, 37, 3)])
def test_char_data_byte_identical(n, vocab, seed):
    stream = make_char_data(n, vocab_size=vocab, seed=seed)
    want = j_make_char_data(n, vocab_size=vocab, seed=seed)
    assert stream.dtype == want.dtype and stream.tobytes() == want.tobytes()
    for got, ref in zip(lm_examples(stream, 16), j_lm_examples(want, 16)):
        assert got.dtype == ref.dtype and got.tobytes() == ref.tobytes()


@pytest.mark.parametrize("partitioner,kwargs", [("zipf", {"exponent": 0.5}),
                                                ("buckets", {})])
def test_build_data_byte_identical(partitioner, kwargs):
    kw = dict(ZOO, partitioner=partitioner, partitioner_kwargs=kwargs)
    jcfg, tcfg = JScenario(**kw), ScenarioConfig(**kw)
    jclients, jtest = jtask("generation").build_data(
        jcfg, jfamily("mamba").build(jcfg),
        jpartitioner(partitioner, **kwargs))
    tclients, ttest = get_task("generation").build_data(
        tcfg, get_model_family("mamba").build(tcfg),
        get_partitioner(partitioner, **kwargs))
    assert sorted(tclients) == sorted(jclients)
    for k in jclients:
        for got, want in zip(tclients[k], jclients[k]):
            assert got.tobytes() == np.asarray(want).tobytes()
    for got, want in zip(ttest, jtest):
        assert got.tobytes() == np.asarray(want).tobytes()


def test_generation_batches_and_metrics():
    task = get_task("generation")
    assert task.labels_per_example((7, 16)) == 16
    m = task.eval_metrics(3, 2.0 * 64, 64)
    assert m["ppl"] == pytest.approx(np.exp(2.0))
    assert m["bpc"] == pytest.approx(2.0 / np.log(2.0))
    assert set(task.make_batch(1, 2)) == {"tokens", "labels"}
    # the task's default family is the paper's NanoGPT
    sim, _ = build_simulator(ScenarioConfig(task="generation",
                                            samples_per_client=2),
                             device="cpu")
    assert sim.cfg.name == "nanogpt-paper"


# -------------------------------------------------- LM trees in the store

def test_lm_tree_round_trips_through_the_coded_store():
    """The mamba tree's empty ``"rem"`` survives flattening, the coded
    store's encode/decode and the stacked-row layout."""
    cfg = get_model_family("mamba").build(None)
    w = init_params(cfg, 0, device="cpu")
    assert w["rem"] == {}
    flat, spec = coding.tree_to_flat(w)
    assert flat.numel() == 61_984
    back = coding.flat_to_tree(flat, spec)
    assert back["rem"] == {}
    _assert_trees_close(back, w, rtol=0, atol=0)
    clients = {0: [10, 11], 1: [12, 13]}
    stacked = {s: tree_map(lambda v, s=s: torch.stack(
        [v * (1 + s), v * (2 + s)]), w) for s in clients}
    store = make_store("coded", clients, num_shards=2, num_clients=4)
    store.put_round(RoundPayload.from_stacked(0, clients, stacked))
    got = store.get_shard(0, 1)
    assert sorted(got) == [12, 13]
    for i, c in enumerate(clients[1]):
        assert got[c]["rem"] == {}
        _assert_trees_close(got[c], tree_map(lambda v: v[i], stacked[1]),
                            rtol=1e-5, atol=1e-6)


# ------------------------------------------------ the federated path

@pytest.fixture(scope="module")
def jax_run():
    """The reference's session: one stage, one SE request on shard 0."""
    cfg = JScenario(schedule=JSchedule([JRequest(
        _first_of_shard0, framework="SE", rounds=1)]), **ZOO)
    session, test = j_build_session(cfg)
    report = session.run(cfg.num_stages, schedule=cfg.schedule)
    return session, report, test


def _port_cfg(engine):
    return ScenarioConfig(schedule=RequestSchedule([UnlearnRequest(
        _first_of_shard0, framework="SE", rounds=1)]), engine=engine, **ZOO)


def _init_fn(jax_run):
    """The reference's stage-0 initial model, for the port's init_fn hook."""
    w0 = jax.tree.map(np.asarray, jax_run[0].records[0].round_globals[0][0])
    return lambda salt: from_numpy_params(w0, device="cpu")


def _port_run(jax_run, engine):
    cfg = _port_cfg(engine)
    session, test = build_session(cfg, device="cpu",
                                  init_fn=_init_fn(jax_run))
    report = session.run(cfg.num_stages, schedule=cfg.schedule)
    return session, report, test


@pytest.fixture(scope="module")
def port_runs(jax_run):
    return {e: _port_run(jax_run, e) for e in ("fused", "stage")}


@pytest.mark.parametrize("engine", ["fused", "stage"])
def test_run_scenario_matches_reference(jax_run, engine):
    _, jrep, _ = jax_run
    trep = run_scenario(_port_cfg(engine), device="cpu",
                        init_fn=_init_fn(jax_run))
    assert trep.store_stats.to_dict() == jrep.store_stats.to_dict()
    assert trep.total_cost_units == jrep.total_cost_units
    jd, td = jrep.to_dict(), trep.to_dict()
    for js, ts in zip(jd["stages"], td["stages"]):
        assert ts["clients"] == js["clients"]
        assert ts["store_stats"] == js["store_stats"]
        assert [u["impacted_shards"] for u in ts["unlearn"]] == \
            [u["impacted_shards"] for u in js["unlearn"]] == [[0]]
        assert [u["cost_units"] for u in ts["unlearn"]] == \
            [u["cost_units"] for u in js["unlearn"]]


@pytest.mark.parametrize("engine", ["fused", "stage"])
def test_stage_matches_reference(jax_run, port_runs, engine):
    jrec = jax_run[0].records[0]
    trec = port_runs[engine][0].records[0]
    for s in jrec.shard_models:
        _assert_trees_close(trec.shard_models[s], jrec.shard_models[s], **TOL)
    keys = sorted(jrec.history_norms)
    assert sorted(trec.history_norms) == keys
    np.testing.assert_allclose([trec.history_norms[k] for k in keys],
                               [jrec.history_norms[k] for k in keys], **TOL)
    for g in range(ZOO["global_rounds"]):
        np.testing.assert_allclose(_np(trec.store._slices[g]),
                                   _np(jrec.store._slices[g]), **TOL)


@pytest.mark.parametrize("engine", ["fused", "stage"])
def test_se_request_matches_reference(jax_run, port_runs, engine):
    jres = jax_run[1].stages[0].unlearn[0]
    tsession, trep, _ = port_runs[engine]
    tres = trep.stages[0].unlearn[0]
    assert tres.impacted_shards == jres.impacted_shards == [0]
    assert tres.cost_units == jres.cost_units
    _assert_trees_close(tres.models[0], jres.models[0], **TOL)
    # the untouched shard is the trained model, bit for bit
    trained = tsession.records[0].shard_models[1]
    for g, w in zip(tree_leaves(tres.models[1]), tree_leaves(trained)):
        assert torch.equal(g, w)
    assert tres.models[1]["rem"] == {} and tres.models[0]["rem"] == {}


def test_engines_agree_on_a_stackable_stage():
    """On an iid split every shard stacks, so the stage engine runs its
    whole-stage program: shard models and norms bit-identical to the fused
    engine on the CPU, coded slices within 1e-5 rel."""
    cfg = ScenarioConfig(**dict(ZOO, partitioner="iid",
                                partitioner_kwargs={}))
    out = {}
    for engine in ("fused", "stage"):
        sim, _ = build_simulator(cfg, device="cpu")
        out[engine] = train_stage(sim, engine=engine)
    fr, sr = out["fused"], out["stage"]
    for s in fr.shard_models:
        for g, w in zip(tree_leaves(sr.shard_models[s]),
                        tree_leaves(fr.shard_models[s])):
            assert torch.equal(g, w)
    assert sr.history_norms == fr.history_norms
    for g in range(ZOO["global_rounds"]):
        torch.testing.assert_close(sr.store._slices[g], fr.store._slices[g],
                                   rtol=1e-5, atol=1e-6)
    assert sr.store.stats.to_dict() == fr.store.stats.to_dict()


def test_evaluate_matches_reference(jax_run, port_runs):
    jsession, jrep, (tx, ty) = jax_run
    tsession, trep, (px, py) = port_runs["fused"]
    assert px.tobytes() == np.asarray(tx).tobytes()
    jm = jsession.sim.evaluate(jrep.stages[0].unlearn[0].models, tx, ty)
    tm = tsession.sim.evaluate(trep.stages[0].unlearn[0].models, px, py)
    assert tm["ppl"] == pytest.approx(np.exp(tm["loss"]), rel=1e-6)
    assert tm["bpc"] == pytest.approx(tm["loss"] / np.log(2.0), rel=1e-6)
    assert abs(tm["acc"] - jm["acc"]) <= 1 / (len(px) * px.shape[1])
    np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=1e-4)
    np.testing.assert_allclose(tm["ppl"], jm["ppl"], rtol=1e-4)
