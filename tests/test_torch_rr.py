"""RR (RapidRetrain) and its pieces through the PyTorch port against the
reference on the CPU: the diagonal Fisher and its preconditioning (rtol
1e-6), adamw and adamw_bf16 on a stacked tree (fp32 rtol 1e-6, the moments
also atol 1e-6 of their leaf's largest entry; bf16 moments within one bf16
ulp), the simulator's Fisher estimate (rtol 1e-5), RR on
tests/test_torch_scenario.py's tiny CNN stage (cost units exact; the model
within rtol 1e-4 / atol 1e-5, or within twice the reference's own one-ulp
spread where RR's large weights amplify rounding past that) and a tiny
``opt_name="adamw"`` scenario (StoreStats and cost units exact, models
within rtol 1e-4 / atol 1e-5)."""
import dataclasses

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
from repro.fl.experiment import RequestSchedule as JSchedule
from repro.fl.experiment import ScenarioConfig as JScenario
from repro.fl.experiment import UnlearnRequest as JRequest
from repro.fl.experiment import run_scenario as j_run_scenario
from repro.fl.experiment import run_unlearn as j_run_unlearn
from repro.fl.experiment import stage as j_stage
from repro.fl.experiment import train_stage as j_train_stage
from repro.fl.experiment.frameworks import UnlearnContext as JContext
from repro.fl.families import get_model_family as jfamily
from repro.models import init_params as jinit
from repro.optim import make_optimizer as j_make_optimizer
from repro.optim.fisher import diag_fisher as j_diag_fisher
from repro.optim.fisher import fisher_precondition as j_precondition
from repro_torch.configs import FLConfig, OptimizerConfig, get_config
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.fl import FLSimulator
from repro_torch.fl.experiment import (FRAMEWORKS, RequestSchedule,
                                       ScenarioConfig, UnlearnRequest,
                                       build_session, run_unlearn,
                                       train_stage)
from repro_torch.models import from_numpy_params
from repro_torch.optim import (diag_fisher, fisher_precondition,
                               init_optimizer, make_optimizer)

torch.set_num_threads(1)
TINY = dict(image_size=8, cnn_channels=(4, 8), d_model=16)
FL = dict(num_clients=8, clients_per_round=4, num_shards=2, local_epochs=2,
          global_rounds=2)
TOL = dict(rtol=1e-4, atol=1e-5)
JCFG = dataclasses.replace(jget("cnn-paper"), **TINY)
TCFG = dataclasses.replace(get_config("cnn-paper"), **TINY)
SHAPES = {"conv": {"b": (4,), "w": (3, 3, 2, 4)}, "fc": {"w": (6, 5)}}


def _tree(rng, lead=(), scale=1.0):
    return {k: ({n: (rng.normal(size=lead + s) * scale).astype(np.float32)
                 for n, s in v.items()} if isinstance(v, dict)
                else (rng.normal(size=lead + v) * scale).astype(np.float32))
            for k, v in SHAPES.items()}


def _t(tree):
    return tree_map(torch.from_numpy, tree)


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _close(port, ref, **tol):
    for t, j in zip(tree_leaves(port), jax.tree.leaves(ref)):
        np.testing.assert_allclose(_np(t), _np(j), **tol)


def _jax_init(cfg, seed=0):
    return lambda salt: from_numpy_params(jax.tree.map(
        np.asarray, jinit(cfg, jax.random.key(seed + salt))), device="cpu")


def test_diag_fisher_and_precondition_match_reference():
    rng = np.random.default_rng(0)
    grads = [_tree(rng) for _ in range(4)]
    jf = tf = None
    for i, g in enumerate(grads):
        jf = j_diag_fisher(jf, _j(g), i)
        tf = diag_fisher(tf, _t(g), i)
    _close(tf, jf, rtol=1e-6)
    # a stack of B = 3 models' gradients, one Fisher broadcast over B (the
    # reference's per-client vmap with an unmapped Fisher)
    stacked = _tree(rng, lead=(3,))
    got = fisher_precondition(_t(stacked), tf)
    want = jax.vmap(lambda g: j_precondition(g, jf))(_j(stacked))
    _close(got, want, rtol=1e-6)
    assert fisher_precondition(_t(stacked), None)["fc"]["w"] is not None


@pytest.mark.parametrize("name", ["adamw", "adamw_bf16"])
def test_adamw_matches_reference_per_model(name):
    """Three steps on a stack of B = 3 models, with weight decay and a clip
    that binds for some models only (each keeps its own norm)."""
    b = 3
    cfg = dict(name=name, lr=0.01, weight_decay=0.1, grad_clip=4.0)
    rng = np.random.default_rng(1)
    params = _tree(rng, lead=(b,))
    grads = [_tree(rng, lead=(b,), scale=s) for s in (0.3, 2.0, 0.05)]
    init, update = make_optimizer(OptimizerConfig(**cfg))
    tp, state = _t(params), None
    state = init(tp)
    for g in grads:
        tp, state = update(tp, _t(g), state)
    assert state.step == 3
    j_init, j_update = j_make_optimizer(JOpt(**cfg))
    mom = torch.bfloat16 if name == "adamw_bf16" else torch.float32
    assert all(m.dtype == mom for m in tree_leaves(state.mu))
    for i in range(b):
        jp = jax.tree.map(lambda a, i=i: jnp.asarray(a[i]), params)
        js = j_init(jp)
        for g in grads:
            jp, js = j_update(jp, jax.tree.map(lambda a, i=i: jnp.asarray(
                a[i]), g), js)
        row = tree_map(lambda v, i=i: v[i], tp)
        _close(row, jp, rtol=1e-6, atol=1e-7)
        for moment, jmoment in ((state.mu, js.mu), (state.nu, js.nu)):
            got = tree_map(lambda v, i=i: v[i], moment)
            for t, j in zip(tree_leaves(got), jax.tree.leaves(jmoment)):
                j = np.asarray(j.astype(jnp.float32))
                if name == "adamw":
                    # the clip's norm sums in another order than XLA's: one
                    # ulp of its scale, relatively larger where b m and
                    # (1 - b) g cancel
                    np.testing.assert_allclose(
                        _np(t), j, rtol=1e-6, atol=1e-6 * np.abs(j).max())
                    continue
                # one bf16 ulp: 2^-7 of the value's binade
                ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(j),
                                                          1e-30))) - 7)
                assert np.all(np.abs(_np(t) - j) <= ulp)


def test_init_optimizer_states():
    p = _t(_tree(np.random.default_rng(2)))
    assert init_optimizer(OptimizerConfig(name="sgd"), p).mu is None
    st = init_optimizer(OptimizerConfig(name="adamw"), p)
    assert st.step == 0 and st.nu["fc"]["w"].shape == (6, 5)
    assert OptimizerConfig().name == "adamw"
    assert (OptimizerConfig().beta2, OptimizerConfig().eps) == (0.95, 1e-8)
    with pytest.raises(ValueError):
        make_optimizer(OptimizerConfig(name="lion"))


def _clients():
    data = make_image_data(8 * 20, image_size=8, seed=0)
    return client_datasets_images(data, 8, iid=True)


@pytest.fixture(scope="module")
def full_stages():
    """One stage on the full store in both packages (RR reads no stored
    parameter, so the store kind does not matter to it)."""
    jsim = JSim(JCFG, JFL(**FL), _clients(), task="classification",
                opt_cfg=JOpt(name="sgd", lr=0.05, grad_clip=0.0),
                local_batch=10)
    tsim = FLSimulator(TCFG, FLConfig(**FL), _clients(),
                       task="classification",
                       opt_cfg=OptimizerConfig(name="sgd", lr=0.05,
                                               grad_clip=0.0),
                       local_batch=10, device="cpu", init_fn=_jax_init(JCFG))
    return (jsim, j_train_stage(jsim, store_kind="full"),
            tsim, train_stage(tsim, store_kind="full"))


def test_estimate_fisher_matches_reference(full_stages):
    jsim, jrec, tsim, trec = full_stages
    clients = jrec.plan.clients
    jf = jsim._estimate_fisher(jinit(JCFG, jax.random.key(777)), clients)
    tf = tsim._estimate_fisher(tsim.init_model(777), clients)
    _close(tf, jf, rtol=1e-5, atol=1e-9)


def _ulp_moved(a, rng):
    """Each float32 entry of ``a`` moved one ulp up or down."""
    a = np.asarray(a, np.float32)
    to = np.where(rng.random(a.shape) < 0.5, -np.inf, np.inf)
    return np.nextafter(a, to.astype(np.float32))


def _ulp_restart(monkeypatch):
    """The reference's restart model (salt 777) with every entry moved by
    one ulp, the direction drawn from a fixed generator."""
    rng = np.random.default_rng(9)
    orig = JContext.init_model

    def moved(self, salt=777):
        return jax.tree.map(lambda a: jnp.asarray(_ulp_moved(a, rng)),
                            orig(self, salt))
    monkeypatch.setattr(JContext, "init_model", moved)


def _held(port, ref, spread: float) -> float:
    """Max |port - ref| over two model trees; where an entry misses rtol
    1e-4 / atol 1e-5, the whole gap must stay within twice ``spread``."""
    worst, missed = 0.0, False
    for t, j in zip(tree_leaves(port), jax.tree.leaves(ref)):
        t, j = _np(t), _np(j)
        worst = max(worst, float(np.abs(t - j).max()))
        missed |= not np.all(np.abs(t - j)
                             <= TOL["atol"] + TOL["rtol"] * np.abs(j))
    assert not missed or worst <= 2 * spread, (worst, spread)
    return worst


def test_rr_matches_reference_on_the_tiny_cnn_stage(full_stages, monkeypatch):
    assert FRAMEWORKS["RR"].use_fisher and not FRAMEWORKS["FR"].use_fisher
    jsim, jrec, tsim, trec = full_stages
    assert trec.store.stats.to_dict() == jrec.store.stats.to_dict()
    victim = jrec.plan.shard_clients[1][0]
    jres = j_run_unlearn(jsim, "RR", jrec, [victim], rounds=2)
    tres = run_unlearn(tsim, "RR", trec, [victim], rounds=2)
    # G' * |retained| * L/r, exactly
    assert tres.cost_units == jres.cost_units == 2 * 3 * 1
    _ulp_restart(monkeypatch)
    jmoved = j_run_unlearn(jsim, "RR", jrec, [victim], rounds=2)
    spread = _gap(jmoved.models[0], jres.models[0])
    biggest = max(float(np.abs(_np(a)).max())
                  for a in jax.tree.leaves(jres.models[0]))
    # the reference's own sensitivity: RR divides by F + 1e-3 with a Fisher
    # taken once at the restart, so its weights grow large (about 2.4e3
    # here) and one ulp of the restart moves them by about 4e-4
    assert biggest > 100.0
    assert 1e-4 < spread < 2e-3, spread
    _held(tres.models[0], jres.models[0], spread)


def _gap(a, b) -> float:
    return max(float(np.abs(_np(x) - _np(y)).max())
               for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)))


def test_adamw_scenario_matches_reference(monkeypatch):
    """adamw's m / (sqrt(v) + eps) turns a gradient near eps that is
    rounding noise into a sizeable step, so where rtol 1e-4 / atol 1e-5
    misses, the SE models are held to twice the reference's own spread
    under one-ulp-moved stage weights."""
    kw = dict(num_clients=8, clients_per_round=4, num_shards=2,
              local_epochs=2, global_rounds=2, samples_per_client=20,
              image_size=8, local_batch=10, opt_name="adamw", lr=0.01)

    def schedule(request_cls, schedule_cls):
        return schedule_cls([request_cls(
            lambda plan: [plan.shard_clients[0][0]])])

    jcfg = JScenario(schedule=schedule(JRequest, JSchedule), **kw)
    tcfg = ScenarioConfig(schedule=schedule(UnlearnRequest, RequestSchedule),
                          **kw)
    jrep = j_run_scenario(jcfg)
    session, _ = build_session(tcfg, device="cpu",
                               init_fn=_jax_init(jfamily("cnn").build(jcfg)))
    trep = session.run(tcfg.num_stages, schedule=tcfg.schedule)
    assert session.sim.opt.name == "adamw"
    assert trep.store_stats.to_dict() == jrep.store_stats.to_dict()
    assert trep.total_cost_units == jrep.total_cost_units
    jres, tres = jrep.stages[0].unlearn[0], trep.stages[0].unlearn[0]
    assert tres.impacted_shards == jres.impacted_shards

    # the reference's own spread, shard by shard: the largest gap three
    # draws of one-ulp-moved stage weights open (a single draw ranged
    # 1.5e-6 to 4.5e-5 on shard 1)
    orig = j_stage.init_params
    spread = {s: 0.0 for s in jres.models}
    for seed in range(3):
        rng = np.random.default_rng(seed)
        monkeypatch.setattr(j_stage, "init_params", lambda *a, rng=rng:
                            jax.tree.map(lambda v: jnp.asarray(
                                _ulp_moved(v, rng)), orig(*a)))
        jm = j_run_scenario(dataclasses.replace(
            jcfg, schedule=schedule(JRequest, JSchedule))).stages[0]
        for s in spread:
            spread[s] = max(spread[s], _gap(jm.unlearn[0].models[s],
                                            jres.models[s]))
    assert all(v > 0.0 for v in spread.values())
    for s in jres.models:
        _held(tres.models[s], jres.models[s], spread[s])
