"""The port's MoE FFN, moe family, MoE configurations and jamba's MoE layer
against the reference on the CPU.

The router, dispatch, expert products and combine are plain torch ops in
the port, as they are plain jnp ops in the reference (no Pallas kernel
computes them).  ``jax.lax.top_k`` and ``torch.topk`` may order equal
probabilities differently, so every comparison first asserts that the
routing (``expert_idx``) is equal.

Tolerances: routing, capacity slots and ``keep`` exact; gates and the aux
loss at rtol 1e-6 (the router's fp32 product and softmax in another order;
measured: 1 ulp); ``apply_moe`` at rtol / atol 1e-5 for both dispatch forms;
the moe family's and ``reduce_for_smoke(jamba)``'s loss at rtol 1e-5 and
gradients at rtol 1e-4 / atol 1e-6 (as tests/test_torch_mamba.py; measured:
7e-7 abs at most on the family); ``param_count``, ``active_param_count``
and ``reduce_for_smoke`` equal.  On the federated path StoreStats, cost
units, client draws and SE isolation are exact, and the models, coded
slices and update norms within 1e-4 (measured: 1.1e-6; the moe stage does
not amplify rounding the way rwkv6's does, so no spread yardstick is
needed).
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs import reduce_for_smoke as j_reduce
from repro.fl.experiment import RequestSchedule as JSchedule
from repro.fl.experiment import ScenarioConfig as JScenario
from repro.fl.experiment import UnlearnRequest as JRequest
from repro.fl.experiment import build_session as j_build_session
from repro.fl.families import canonical_families as j_canonical
from repro.fl.families import get_model_family as jfamily
from repro.models import init_params as jinit
from repro.models import loss_fn as jloss
from repro.models import moe as jmoe
from repro.models.params import RealInit as JRealInit
from repro_torch.configs import (ASSIGNED_ARCHS, ModelConfig, get_config,
                                 reduce_for_smoke)
from repro_torch.core.tree import leaves_with_paths, tree_leaves, tree_map
from repro_torch.fl.experiment import (RequestSchedule, ScenarioConfig,
                                       UnlearnRequest, build_session,
                                       run_scenario)
from repro_torch.fl.families import canonical_families, get_model_family
from repro_torch.models import from_numpy_params, init_params, loss_fn
from repro_torch.models import moe
from repro_torch.models.transformer import forward_train

torch.set_num_threads(1)


def _port_cfg(jcfg):
    return ModelConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(ModelConfig)})


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _assert_trees_close(got, want, **tol):
    for (path, g), w in zip(leaves_with_paths(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(_np(g), _np(w), err_msg="/".join(
            str(k) for k in path), **tol)


def _lift(tree):
    return tree_map(lambda v: v.unsqueeze(0), tree)


def _moe_cfg(**change):
    return dataclasses.replace(jfamily("moe").build(None), **change)


def _moe_case(jcfg, seed=0, b=2, s=24):
    """The reference's MoE weights and a (b, s, d) input from a numpy seed."""
    jp = jmoe.init_moe(JRealInit(jax.random.key(seed), jnp.float32), jcfg)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, jcfg.d_model)).astype(np.float32)
    return jp, x, from_numpy_params(jax.tree.map(np.asarray, jp))


# ----------------------------------------------------------------- router

@pytest.mark.parametrize("cf", [1.25, 0.25])
def test_route_matches_reference(cf):
    jcfg = _moe_cfg(moe_capacity_factor=cf)
    jp, x, tp = _moe_case(jcfg)
    xg = x.reshape(4, 12, jcfg.d_model)                  # (N, T, d)
    g, k, e = 12, jcfg.experts_per_token, jcfg.num_experts
    cap = max(int(g * k / e * cf), 4)
    jgate, jidx, jpos, jkeep, _, jaux = jmoe._route(jp, jnp.asarray(xg),
                                                    jcfg, cap)
    tgate, tidx, tpos, tkeep, _, taux = moe._route(
        _lift(tp), torch.from_numpy(xg)[None], _port_cfg(jcfg), cap)
    np.testing.assert_array_equal(tidx[0].numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(tpos[0].numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(tkeep[0].numpy(), np.asarray(jkeep))
    np.testing.assert_allclose(tgate[0].numpy(), np.asarray(jgate),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(float(taux[0]), float(jaux), rtol=1e-6)
    if cf < 1:                 # the small capacity forces drops
        assert not bool(tkeep.all())


@pytest.mark.parametrize("impl", ["einsum", "gather"])
@pytest.mark.parametrize("cf", [1.25, 0.25])
@pytest.mark.parametrize("s,group", [(24, 8), (20, 8), (7, 512)])
def test_apply_moe_matches_reference(impl, cf, s, group):
    """Both dispatch forms, with and without forced drops, with S a
    multiple of the group, S padded to the next group, and S < group."""
    jcfg = _moe_cfg(moe_capacity_factor=cf, moe_impl=impl)
    jp, x, tp = _moe_case(jcfg, seed=1, s=s)
    jy, jaux = jmoe.apply_moe(jp, jnp.asarray(x), jcfg, group_size=group)
    ty, taux = moe.apply_moe(_lift(tp), torch.from_numpy(x)[None],
                             _port_cfg(jcfg), group_size=group)
    assert tuple(ty.shape) == (1, *x.shape) and tuple(taux.shape) == (1,)
    np.testing.assert_allclose(ty[0].numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(taux[0]), float(jaux), rtol=1e-6)


def test_dispatch_forms_agree_with_drops():
    """The gather form equals the einsum form with drops forced: the pad
    slot every dropped pair writes is never read."""
    cfg = _port_cfg(_moe_cfg(moe_capacity_factor=0.25))
    _, x, tp = _moe_case(_moe_cfg(), seed=2, s=32)
    xs = torch.from_numpy(x)[None]
    ye, ae = moe.apply_moe(_lift(tp), xs, cfg, group_size=16)
    yg, ag = moe.apply_moe(_lift(tp), xs, dataclasses.replace(
        cfg, moe_impl="gather"), group_size=16)
    torch.testing.assert_close(yg, ye, rtol=1e-6, atol=1e-6)
    assert torch.equal(ag, ae)


def test_aux_loss_is_per_model():
    """A stack of two models on two inputs: each model's output and aux
    come from its own tokens (the reference vmaps each client's loss)."""
    jcfg = _moe_cfg()
    jp0, x0, tp0 = _moe_case(jcfg, seed=3)
    jp1, x1, tp1 = _moe_case(jcfg, seed=4)
    both = tree_map(lambda a, b: torch.stack([a, b]), tp0, tp1)
    ty, taux = moe.apply_moe(both, torch.from_numpy(np.stack([x0, x1])),
                             _port_cfg(jcfg), group_size=8)
    for k, (jp, x) in enumerate(((jp0, x0), (jp1, x1))):
        jy, jaux = jmoe.apply_moe(jp, jnp.asarray(x), jcfg, group_size=8)
        np.testing.assert_allclose(ty[k].numpy(), np.asarray(jy), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(float(taux[k]), float(jaux), rtol=1e-6)
    assert float(taux[0]) != float(taux[1])


def test_init_moe_fan_in_is_the_reference_s():
    """The experts' normal draws scale by d (and f for wo), not by E."""
    cfg = get_model_family("moe").build(None)
    p = init_params(dataclasses.replace(cfg, d_model=256, moe_d_ff=64,
                                        num_layers=1), 0, "cpu")
    ffn = p["stack"]["p0"]["ffn"]
    for name, fan_in in (("router", 256), ("wi_gate", 256), ("wi_up", 256),
                         ("wo", 64)):
        std = float(ffn[name].std())
        assert abs(std * np.sqrt(fan_in) - 1.0) < 0.05, (name, std)


# --------------------------------------------------------------- the family

@pytest.fixture(scope="module")
def family_weights():
    jcfg = jfamily("moe").build(None)
    jp = jax.jit(lambda key: jinit(jcfg, key))(jax.random.key(0))
    return jcfg, jp, from_numpy_params(jax.tree.map(np.asarray, jp))


def test_family_tree_matches_reference(family_weights):
    jcfg, jp, _ = family_weights
    cfg = get_model_family("moe").build(None)
    assert cfg == _port_cfg(jcfg)
    tp = init_params(cfg, 3, device="cpu")
    jleaves = jax.tree_util.tree_leaves_with_path(jp)
    tleaves = list(leaves_with_paths(tp))
    assert len(tleaves) == len(jleaves)
    for (jpath, jv), (tpath, tv) in zip(jleaves, tleaves):
        assert tuple(k.key for k in jpath) == tpath
        assert tuple(jv.shape) == tuple(tv.shape)
    # the embedding is padded to 512 rows; the analytic counts are not
    assert sum(v.numel() for v in tree_leaves(tp)) == 63_904
    assert cfg.param_count() == jcfg.param_count() == 38_112
    assert cfg.active_param_count() == jcfg.active_param_count() == 25_824
    assert tp["rem"] == {}
    assert get_model_family("moe").kernel_ops == ()


@pytest.mark.parametrize("impl", ["einsum", "gather"])
def test_family_loss_and_grads_match_reference(family_weights, impl):
    jcfg, jp, tp = family_weights
    jcfg = dataclasses.replace(jcfg, moe_impl=impl)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 109, (4, 16)).astype(np.int32)
    labs = rng.integers(0, 109, (4, 16)).astype(np.int32)
    labs[0, :3] = -100                                  # ignored labels
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jloss(jcfg)(p, b), has_aux=True))(
        jp, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labs)})
    tp = tree_map(lambda v: v.clone().requires_grad_(True), tp)
    tl, mets = loss_fn(_port_cfg(jcfg))(
        tp, {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labs)})
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(mets["aux"].detach()), float(jm["aux"]),
                               rtol=1e-5)
    assert float(mets["aux"].detach()) > 0
    grads = torch.autograd.grad(tl, tree_leaves(tp))
    for (path, _), g, w in zip(leaves_with_paths(tp), grads,
                               jax.tree.leaves(jg)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-6, err_msg="/".join(path))


def test_stacked_forward_is_per_model(family_weights):
    """A stack of two models over two batches gives each model's logits
    and its own aux loss."""
    _, _, tp = family_weights
    cfg = get_model_family("moe").build(None)
    other = tree_map(lambda v: v * 0.9, tp)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, 109, (2, 3, 12)).astype(np.int32))
    both = tree_map(lambda a, b: torch.stack([a, b]), tp, other)
    logits, aux = forward_train(both, cfg, {"tokens": toks})
    assert tuple(aux.shape) == (2,)
    for k, p in enumerate((tp, other)):
        one, one_aux = forward_train(tree_map(lambda v: v[None], p), cfg,
                                     {"tokens": toks[k:k + 1]})
        torch.testing.assert_close(logits[k], one[0], rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(aux[k], one_aux[0], rtol=1e-6, atol=0)


def test_jamba_smoke_loss_and_grads_match_reference():
    """reduce_for_smoke(jamba-1.5-large): a global layer, then a mamba layer
    with an MoE FFN (the ssm_scan kernels' plain versions beside it)."""
    jcfg = j_reduce(jget("jamba-1.5-large-398b"))
    cfg = reduce_for_smoke(get_config("jamba-1.5-large-398b"))
    assert cfg == _port_cfg(jcfg)
    assert cfg.layer_kinds == ("global", "mamba")
    assert [cfg.ffn_is_moe(i) for i in range(2)] == [False, True]
    jp = jax.jit(lambda key: jinit(jcfg, key))(jax.random.key(1))
    tp = from_numpy_params(jax.tree.map(np.asarray, jp))
    assert tuple(tp["stack"]["p1"]["ffn"]["wi_gate"].shape) == (1, 4, 256,
                                                                256)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, 512, (2, 32)).astype(np.int32)
    labs = rng.integers(0, 512, (2, 32)).astype(np.int32)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jloss(jcfg)(p, b), has_aux=True))(
        jp, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labs)})
    tp = tree_map(lambda v: v.clone().requires_grad_(True), tp)
    tl, mets = loss_fn(cfg)(tp, {"tokens": torch.from_numpy(toks),
                                 "labels": torch.from_numpy(labs)})
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(mets["aux"].detach()), float(jm["aux"]),
                               rtol=1e-5)
    grads = torch.autograd.grad(tl, tree_leaves(tp))
    for (path, _), g, w in zip(leaves_with_paths(tp), grads,
                               jax.tree.leaves(jg)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-6, err_msg="/".join(path))


# ---------------------------------------------------------------- configs

@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m",
                                  "granite-moe-3b-a800m"])
def test_granite_configs_match_reference(arch):
    jcfg, tcfg = jget(arch), get_config(arch)
    for f in dataclasses.fields(ModelConfig):
        assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    assert tcfg.layer_kinds == jcfg.layer_kinds
    assert [tcfg.ffn_is_moe(i) for i in range(tcfg.num_layers)] == \
        [jcfg.ffn_is_moe(i) for i in range(jcfg.num_layers)]
    assert tcfg.family == "moe" and tcfg.moe_impl == "einsum"


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS + ("nanogpt-paper",
                                                   "cnn-paper"))
def test_param_counts_and_smoke_reduction_match_reference(arch):
    """Integer counts, equal; ``reduce_for_smoke`` field by field (the CNN
    has no heads, and both packages divide by zero there)."""
    jcfg, tcfg = jget(arch), get_config(arch)
    assert tcfg.param_count() == jcfg.param_count()
    assert tcfg.active_param_count() == jcfg.active_param_count()
    if arch == "cnn-paper":
        for fn, c in ((j_reduce, jcfg), (reduce_for_smoke, tcfg)):
            with pytest.raises(ZeroDivisionError):
                fn(c)
        return
    jr, tr = j_reduce(jcfg), reduce_for_smoke(tcfg)
    assert tr == _port_cfg(jr)
    assert tr.param_count() == jr.param_count()
    assert tr.active_param_count() == jr.active_param_count()


def test_assigned_archs_are_the_reference_s_that_the_port_runs():
    from repro.configs import ASSIGNED_ARCHS as J_ASSIGNED
    assert ASSIGNED_ARCHS == tuple(a for a in J_ASSIGNED if a not in (
        "internvl2-2b", "whisper-tiny"))


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m",
                                  "granite-moe-3b-a800m"])
def test_granite_smoke_trains(arch):
    """The reduced granite configs build and take one SGD step."""
    cfg = reduce_for_smoke(get_config(arch))
    p = tree_map(lambda v: v.requires_grad_(True),
                 init_params(cfg, 0, "cpu"))
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16))
                                 .astype(np.int32)) for k in ("tokens",
                                                              "labels")}
    loss, _ = loss_fn(cfg)(p, batch)
    grads = torch.autograd.grad(loss, tree_leaves(p))
    assert np.isfinite(float(loss.detach()))
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert any(float(g.abs().max()) > 0 for (path, _), g in zip(
        leaves_with_paths(p), grads) if "wi_gate" in path)


# ------------------------------------------------------ the federated path

ZOO = dict(task="generation", model="moe", partitioner="zipf",
           partitioner_kwargs={"exponent": 0.5}, store="coded", num_clients=8,
           clients_per_round=4, num_shards=2, local_epochs=1, global_rounds=2,
           samples_per_client=6, seq_len=16, test_n=20, local_batch=2,
           num_stages=1)
TOL = dict(rtol=1e-4, atol=1e-4)


def _first_of_shard0(plan):
    return [plan.shard_clients[0][0]]


@pytest.fixture(scope="module")
def jax_run():
    """The reference's moe session: one stage, one SE request on shard 0
    (tests/test_scenario_zoo.py's configuration)."""
    cfg = JScenario(schedule=JSchedule([JRequest(
        _first_of_shard0, framework="SE", rounds=1)]), **ZOO)
    session, _ = j_build_session(cfg)
    return session, session.run(cfg.num_stages, schedule=cfg.schedule)


def _port_cfg_run(engine):
    return ScenarioConfig(schedule=RequestSchedule([UnlearnRequest(
        _first_of_shard0, framework="SE", rounds=1)]), engine=engine, **ZOO)


def _init_fn(jax_run):
    w0 = jax.tree.map(np.asarray, jax_run[0].records[0].round_globals[0][0])
    return lambda salt: from_numpy_params(w0)


@pytest.fixture(scope="module")
def port_runs(jax_run):
    out = {}
    for engine in ("fused", "stage"):
        cfg = _port_cfg_run(engine)
        session, _ = build_session(cfg, device="cpu",
                                   init_fn=_init_fn(jax_run))
        out[engine] = session, session.run(cfg.num_stages,
                                           schedule=cfg.schedule)
    return out


@pytest.mark.parametrize("engine", ["fused", "stage"])
def test_run_scenario_matches_reference(jax_run, engine):
    jrep = jax_run[1]
    trep = run_scenario(_port_cfg_run(engine), device="cpu",
                        init_fn=_init_fn(jax_run))
    assert trep.store_stats.to_dict() == jrep.store_stats.to_dict()
    assert trep.total_cost_units == jrep.total_cost_units
    for js, ts in zip(jrep.to_dict()["stages"], trep.to_dict()["stages"]):
        assert ts["clients"] == js["clients"]
        assert ts["store_stats"] == js["store_stats"]
        assert [u["impacted_shards"] for u in ts["unlearn"]] == \
            [u["impacted_shards"] for u in js["unlearn"]] == [[0]]
        assert [u["cost_units"] for u in ts["unlearn"]] == \
            [u["cost_units"] for u in js["unlearn"]]


@pytest.mark.parametrize("engine", ["fused", "stage"])
def test_stage_and_se_match_reference(jax_run, port_runs, engine):
    jsession, jrep = jax_run
    tsession, trep = port_runs[engine]
    jrec, trec = jsession.records[0], tsession.records[0]
    for s in jrec.shard_models:
        _assert_trees_close(trec.shard_models[s], jrec.shard_models[s], **TOL)
    keys = sorted(jrec.history_norms)
    assert sorted(trec.history_norms) == keys
    np.testing.assert_allclose([trec.history_norms[k] for k in keys],
                               [jrec.history_norms[k] for k in keys], **TOL)
    for g in range(ZOO["global_rounds"]):
        np.testing.assert_allclose(_np(trec.store._slices[g]),
                                   _np(jrec.store._slices[g]), **TOL)
    jres, tres = jrep.stages[0].unlearn[0], trep.stages[0].unlearn[0]
    assert tres.impacted_shards == jres.impacted_shards == [0]
    _assert_trees_close(tres.models[0], jres.models[0], **TOL)
    for g, w in zip(tree_leaves(tres.models[1]),
                    tree_leaves(trec.shard_models[1])):
        assert torch.equal(g, w)


# ------------------------------------------- the scenario zoo, every family

def test_canonical_families_match_reference():
    assert canonical_families() == j_canonical()
    assert "moe" in canonical_families()


# kernel op -> the model module that calls it (imported there by name)
_OP_MODULES = {"ssm_scan": "repro_torch.models.mamba",
               "wkv": "repro_torch.models.rwkv6"}


def _family_cfg(family: str) -> ScenarioConfig:
    """tests/test_scenario_zoo.py's per-family configuration."""
    fam = get_model_family(family)
    schedule = RequestSchedule([UnlearnRequest(
        lambda plan: [plan.shard_clients[0][0]], framework="SE", rounds=1)])
    common = dict(model=family, store="coded", num_clients=8,
                  clients_per_round=4, num_shards=2, local_epochs=1,
                  global_rounds=2, num_stages=1, schedule=schedule)
    if fam.task == "classification":
        return ScenarioConfig(task="classification", partitioner="dirichlet",
                              partitioner_kwargs={"alpha": 1.0},
                              samples_per_client=12, image_size=8, test_n=40,
                              local_batch=2, **common)
    return ScenarioConfig(task="generation", partitioner="zipf",
                          partitioner_kwargs={"exponent": 0.5},
                          samples_per_client=6, seq_len=16, test_n=20,
                          local_batch=2, **common)


@pytest.mark.parametrize("family", canonical_families())
def test_family_end_to_end(family, monkeypatch):
    """One tiny stage + one SE request per family through the port's
    ``build_session`` on the CPU, each family's declared kernel ops
    exercised (tests/test_scenario_zoo.py's smoke)."""
    fam = get_model_family(family)
    counts = {}
    for op in fam.kernel_ops:
        mod = importlib.import_module(_OP_MODULES[op])
        real = getattr(mod, op)

        def spy(*a, _real=real, _op=op, **kw):
            counts[_op] = counts.get(_op, 0) + 1
            return _real(*a, **kw)

        monkeypatch.setattr(mod, op, spy)
    cfg = _family_cfg(family)
    session, (tx, ty) = build_session(cfg, device="cpu")
    report = session.run(cfg.num_stages, schedule=cfg.schedule)
    assert len(report.stages) == 1
    (res,) = report.stages[0].unlearn
    assert res.framework == "SE"
    assert list(res.impacted_shards) == [0]
    assert res.cost_units > 0
    assert report.store_stats.client_bytes > 0
    for op in fam.kernel_ops:
        assert counts.get(op, 0) > 0, f"{family} never routed through {op!r}"
    metrics = session.sim.evaluate(res.models, tx, ty)
    assert all(np.isfinite(v) for v in metrics.values()), metrics
    if fam.task == "generation":
        assert metrics["ppl"] == pytest.approx(np.exp(metrics["loss"]),
                                               rel=1e-6)
