"""The paper's NanoGPT (the generation task's default family) and the
attention layer kinds through the port, against the reference on the CPU.

The local-attention model is NanoGPT's configuration cut as
``chip_smoke.py`` cuts it: 2 layers ("local", "global"), d_model 64, 4
heads of 16 over 2 kv heads, sliding window 16, run at 40 tokens so that
its local layer takes the sliding-window path (``window_attention``; the
reference runs ``local_blockwise_attention`` there).

Tolerances: one attention layer at rtol 1e-5 / atol 1e-5; the models'
loss at rtol 1e-5 and each gradient leaf at rtol 1e-4 / atol 5e-5 of the
leaf's largest entry (as tests/test_torch_rwkv6.py holds its family); the
federated path (tests/test_scenario_zoo.py's tiny scenario with no
``model=``, one SE request) exact on StoreStats, cost units, client draws
and SE isolation, and within rtol 1e-4 / atol 1e-4 on models, coded slices
and update norms, as tests/test_torch_generation.py holds the mamba
family (the worst entry measured uses 0.54 of that bound: 5.6e-5 abs on
the coded slices, whose entries reach 2.5; fp32 sums in another order,
amplified by the stage's SGD steps at lr 0.3).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.fl.experiment import RequestSchedule as JSchedule
from repro.fl.experiment import ScenarioConfig as JScenario
from repro.fl.experiment import UnlearnRequest as JRequest
from repro.fl.experiment import build_session as j_build_session
from repro.fl.families import get_model_family as jfamily
from repro.models import init_params as jinit
from repro.models import loss_fn as jloss
from repro.models import transformer as jtfm
from repro.models.params import RealInit as JRealInit
from repro_torch.configs import ModelConfig, get_config
from repro_torch.core.tree import leaves_with_paths, tree_leaves, tree_map
from repro_torch.fl.experiment import (RequestSchedule, ScenarioConfig,
                                       UnlearnRequest, build_session,
                                       build_simulator, run_scenario,
                                       train_stage)
from repro_torch.fl.families import TransformerFamily, get_model_family
from repro_torch.models import from_numpy_params, init_params, loss_fn
from repro_torch.models.attention import init_attention
from repro_torch.models.layers import init_mlp, init_norm
from repro_torch.models.transformer import apply_block_train, forward_train

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-4)
LOCAL = dict(name="nanogpt-local", num_layers=2,
             layer_pattern=("local", "global"), d_model=64, num_heads=4,
             num_kv_heads=2, head_dim=16, sliding_window=16)


def _port_cfg(jcfg):
    return ModelConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(ModelConfig)})


def _jcfg(which):
    base = jget("nanogpt-paper")
    return base if which == "nanogpt" else dataclasses.replace(base, **LOCAL)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _assert_trees_close(got, want, **tol):
    for (path, g), w in zip(leaves_with_paths(got), tree_leaves(want)):
        np.testing.assert_allclose(_np(g), _np(w), err_msg="/".join(path),
                                   **tol)


class _ShapeOnly:
    """A parameter factory that returns each leaf's shape."""

    def param(self, shape, init="normal", scale=1.0, in_dims=1,
              fan_in=None):
        return tuple(shape)


# ---------------------------------------------------------------- configs

@pytest.mark.parametrize("arch", ["nanogpt-paper", "gemma3-27b"])
def test_config_matches_reference(arch):
    jcfg, tcfg = jget(arch), get_config(arch)
    for f in dataclasses.fields(ModelConfig):
        assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    assert tcfg.layer_kinds == jcfg.layer_kinds


def test_gemma3_local_layer_size():
    """One gemma3-27b local layer: init_attention + init_mlp + 2 rmsnorms
    hold 412,887,552 parameters, as the reference's count has them."""
    cfg = get_config("gemma3-27b")
    fac = _ShapeOnly()
    shapes = [*init_attention(fac, cfg).values(), *init_mlp(fac, cfg).values(),
              init_norm(fac, cfg)["scale"], init_norm(fac, cfg)["scale"]]
    assert sum(int(np.prod(s)) for s in shapes) == 412_887_552
    jcfg = jget("gemma3-27b")
    per_layer = (jcfg.param_count() - jcfg.vocab_size * jcfg.d_model
                 - jcfg.d_model) // jcfg.num_layers      # embed, final norm
    assert per_layer == 412_887_552
    assert cfg.layer_pattern.count("local") == 5


@pytest.fixture(scope="module", params=["nanogpt", "local"])
def weights(request):
    jcfg = _jcfg(request.param)
    jp = jax.jit(lambda key: jinit(jcfg, key))(jax.random.key(0))
    return (request.param, jcfg, jp,
            from_numpy_params(jax.tree.map(np.asarray, jp), device="cpu"))


def test_family_tree_matches_reference(weights):
    which, jcfg, jp, _ = weights
    cfg = _port_cfg(jcfg)
    tp = init_params(cfg, 3, device="cpu")
    jleaves = jax.tree_util.tree_leaves_with_path(jp)
    tleaves = list(leaves_with_paths(tp))
    assert len(tleaves) == len(jleaves)
    for (jpath, jv), (tpath, tv) in zip(jleaves, tleaves):
        assert tuple(k.key for k in jpath) == tpath
        assert tuple(jv.shape) == tuple(tv.shape)
    if which == "nanogpt":
        assert sum(v.numel() for v in tree_leaves(tp)) == 32_912
        fam = get_model_family("transformer")
        assert type(get_model_family("nanogpt")) is type(fam) \
            is TransformerFamily
        assert fam.build(None) == cfg == _port_cfg(jfamily(
            "transformer").build(None))
        assert fam.kernel_ops == () and fam.default_lr is None
    # the draws follow the reference's init rules
    wq = tp["stack"]["p0"]["attn"]["wq"]
    assert abs(float(wq.std()) - cfg.d_model ** -0.5) < 0.1 * \
        cfg.d_model ** -0.5
    wo = tp["stack"]["p0"]["attn"]["wo"]
    fan_in = cfg.num_heads * cfg.head_dim
    assert abs(float(wo.std()) - fan_in ** -0.5) < 0.1 * fan_in ** -0.5


def test_loss_and_grads_match_reference(weights):
    which, jcfg, jp, tp = weights
    seq = 16 if which == "nanogpt" else 40      # 40 > the window of 16
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 109, (4, seq)).astype(np.int32)
    labs = rng.integers(0, 109, (4, seq)).astype(np.int32)
    labs[0, :3] = -100                                  # ignored labels
    jl, jg = jax.jit(jax.value_and_grad(lambda p, b: jloss(jcfg)(p, b)[0]))(
        jp, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labs)})
    tp = tree_map(lambda v: v.clone().requires_grad_(True), tp)
    tl, mets = loss_fn(_port_cfg(jcfg))(
        tp, {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labs)})
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    assert float(mets["aux"]) == 0.0
    grads = torch.autograd.grad(tl, tree_leaves(tp))
    for (path, _), g, w in zip(leaves_with_paths(tp), grads,
                               jax.tree.leaves(jg)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=5e-5 * float(np.abs(w).max()),
                                   err_msg="/".join(path))


def test_stacked_forward_is_per_model(weights):
    """A stack of two models over two batches gives each model's logits."""
    _, jcfg, _, tp = weights
    cfg = _port_cfg(jcfg)
    other = tree_map(lambda v: v * 0.9, tp)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, 109, (2, 3, 24)).astype(np.int32))
    both = tree_map(lambda a, b: torch.stack([a, b]), tp, other)
    logits, _ = forward_train(both, cfg, {"tokens": toks})
    for k, p in enumerate((tp, other)):
        one, _ = forward_train(tree_map(lambda v: v[None], p), cfg,
                               {"tokens": toks[k:k + 1]})
        torch.testing.assert_close(logits[k], one[0], rtol=1e-5, atol=1e-5)
    assert bool((logits[..., 109:] == -1e9).all())


@pytest.mark.parametrize("kind", ["local", "global"])
def test_attention_layer_matches_reference(kind):
    """One layer of the local-attention model at S = 40: the local kind
    through the sliding-window path, the global kind through the
    blockwise path."""
    jcfg = _jcfg("local")
    jp = jtfm._init_block(JRealInit(jax.random.key(0), jnp.float32), jcfg,
                          kind, 0)
    x = jax.random.normal(jax.random.key(2), (2, 40, jcfg.d_model),
                          jnp.float32)
    jy, aux, _ = jtfm.apply_block_train(jp, x, jcfg, kind, 0, jtfm.NULL_CTX)
    tp = tree_map(lambda v: v.unsqueeze(0),
                  from_numpy_params(jax.tree.map(np.asarray, jp), device="cpu"))
    ty, taux, _ = apply_block_train(tp, torch.from_numpy(np.array(x))[None],
                                 _port_cfg(jcfg), kind, 0)
    np.testing.assert_allclose(ty[0].detach().numpy(), np.asarray(jy),
                               rtol=1e-5, atol=1e-5)
    assert float(taux) == float(aux) == 0.0


# ------------------------------------------------------ the federated path

ZOO = dict(task="generation", partitioner="zipf",
           partitioner_kwargs={"exponent": 0.5}, store="coded", num_clients=8,
           clients_per_round=4, num_shards=2, local_epochs=1, global_rounds=2,
           samples_per_client=6, seq_len=16, test_n=20, local_batch=2,
           num_stages=1)


def _first_of_shard0(plan):
    return [plan.shard_clients[0][0]]


@pytest.fixture(scope="module")
def jax_run():
    """The reference's session with the task's default family: one stage,
    one SE request on shard 0."""
    cfg = JScenario(schedule=JSchedule([JRequest(
        _first_of_shard0, framework="SE", rounds=1)]), **ZOO)
    session, _ = j_build_session(cfg)
    assert session.sim.cfg.name == "nanogpt-paper"
    return session, session.run(cfg.num_stages, schedule=cfg.schedule)


def _port_cfg_run(engine):
    return ScenarioConfig(schedule=RequestSchedule([UnlearnRequest(
        _first_of_shard0, framework="SE", rounds=1)]), engine=engine, **ZOO)


def _init_fn(jax_run):
    """The reference's stage-0 initial model, for the port's init_fn hook."""
    w0 = jax.tree.map(np.asarray, jax_run[0].records[0].round_globals[0][0])
    return lambda salt: from_numpy_params(w0, device="cpu")


@pytest.fixture(scope="module")
def port_runs(jax_run):
    out = {}
    for engine in ("fused", "stage"):
        cfg = _port_cfg_run(engine)
        assert cfg.model == "transformer"
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
    # the untouched shard is the trained model, bit for bit
    for g, w in zip(tree_leaves(tres.models[1]),
                    tree_leaves(trec.shard_models[1])):
        assert torch.equal(g, w)


def test_engines_agree_on_a_stackable_stage():
    """On an iid split every shard stacks, so the stage engine runs its
    whole-stage program over all S*M clients while the fused engine runs
    M at a time: on the CPU the NanoGPT shard models, norms and coded
    slices come out bit-identical."""
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
        assert torch.equal(sr.store._slices[g], fr.store._slices[g])
