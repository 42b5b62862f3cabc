"""Forgetting verification (``repro_torch.verify``, ``repro_torch.fl.mia``)
through the PyTorch port against the reference on the CPU.

Host-side numpy pieces are held byte for byte: the logistic attack, the
attack's F1, canary synthesis and planting, and the stage-victim replay.
Device pieces: the tasks' MIA features (rtol 1e-5), the ensemble logits and
the per-model evaluation loop (rtol 1e-5), the retrain oracle's models (rtol
1e-4 / atol 1e-5, cost units exact) and the shadow attack's features (rtol
1e-4; its training accuracy within one decision), all from the reference's
initial weights at every seed (``init_for_seed``).

The whole suite runs in both packages with SE, FE, FR and RR, cost units
exact, at tests/test_verify.py's scenario (``CFG``: lr 0.3, L 8, G 6) and
at the same scenario cut to G 3 (``CALM``).  CFG is chaotic in fp32: from
round 4 on, a 1e-6 change of a shard's model grows to 1e-3-7e-3 in one
round (the port from its own round-3 model and from the reference's), so
the two packages' stages end 0.066 apart and the port's own two CPU
convolution algorithms (oneDNN and the native one) move a candidate's gap
to the oracle by up to 0.32.  So each candidate's MIA-F1 and canary-accuracy
gap to the oracle is held within 0.05 of the reference's at CALM (where the
two packages' metrics agree exactly), and at CFG within 0.05 or twice the
largest gap change of the port's second convolution algorithm, metric by
metric.  The port's CFG report is bit-reproducible, and the reference's
acceptance checks that it passes are mirrored on it."""
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fl import mia as jmia
from repro.fl.experiment import ScenarioConfig as JScenario
from repro.fl.experiment import build_simulator as j_build_simulator
from repro.fl.experiment import run_unlearn as j_run_unlearn
from repro.fl.experiment import train_stage as j_train_stage
from repro.fl.families import get_model_family as jfamily
from repro.fl.tasks import resolve_task as j_resolve_task
from repro.models import init_params as jinit
from repro.verify import plant_canaries as j_plant_canaries
from repro.verify import predict_stage_victim as j_predict_stage_victim
from repro.verify import ShadowMIAVerifier as JShadowMIAVerifier
from repro.verify import run_verification as j_run_verification
from repro_torch.core.tree import tree_leaves
from repro_torch.fl import mia
from repro_torch.fl.experiment import (FRAMEWORKS, ScenarioConfig,
                                       UnlearnContext, build_simulator,
                                       run_unlearn, train_stage)
from repro_torch.fl.tasks import resolve_task
from repro_torch.models import from_numpy_params
from repro_torch.verify import (VERIFIERS, CanaryVerifier, ForgettingVerifier,
                                ShadowMIAVerifier, UtilityVerifier,
                                get_verifier, plant_canaries,
                                predict_stage_victim, resolve_verifiers,
                                run_verification)
from repro_torch.verify.report import CandidateScore, VerifyReport
from repro_torch.verify.shadow import shadow_features

torch.set_num_threads(1)
# tests/test_verify.py's victim scenario: the memorization regime at CI scale
KW = dict(task="classification", num_clients=8, clients_per_round=8,
          num_shards=2, samples_per_client=32, image_size=10,
          local_epochs=8, global_rounds=6, test_n=160, seed=3, lr=0.3,
          noise=0.35, store="coded", engine="fused")
JCFG, CFG = JScenario(**KW), ScenarioConfig(**KW)
JCALM, CALM = (dataclasses.replace(c, global_rounds=3) for c in (JCFG, CFG))
SMALL = dict(local_epochs=3, global_rounds=3, test_n=80)
N_SHADOWS = 2
N_CANARIES = 12
FRAMEWORK_ORDER = ("SE", "FE", "FR", "RR")
GAP_TOL = 0.05          # port's gap to the oracle vs the reference's gap
MODEL_TOL = dict(rtol=1e-4, atol=1e-5)
# tests/test_verify.py's acceptance margins
MARGIN_MIA = 0.05
MARGIN_CANARY = 0.10


def _init_for_seed(jcfg):
    """The reference's initial weights of the scenario at each seed."""
    model_cfg = jfamily(jcfg.model).build(jcfg)

    def for_seed(seed):
        return lambda salt: from_numpy_params(jax.tree.map(
            np.asarray, jinit(model_cfg, jax.random.key(seed + salt))), device="cpu")
    return for_seed


INIT_FOR_SEED = _init_for_seed(JCFG)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


@pytest.fixture(scope="module")
def reports():
    """The suite in both packages at CFG (SE, FE, FR, RR, the oracle and the
    no-unlearn baseline, two shadows, canaries); the port again with SE
    only, for bit-reproducibility, and again with its native CPU
    convolution instead of oneDNN's, for its own rounding spread."""
    kw = dict(frameworks=FRAMEWORK_ORDER, n_shadows=N_SHADOWS,
              n_canaries=N_CANARIES)
    port_kw = dict(kw, device="cpu", init_for_seed=INIT_FOR_SEED)
    ref = j_run_verification(JCFG, **kw)
    port = run_verification(CFG, **port_kw)
    repeat = run_verification(CFG, **dict(port_kw, frameworks=("SE",)))
    with torch.backends.mkldnn.flags(enabled=False):
        native = run_verification(CFG, **port_kw)
    return ref, port, repeat, native


@pytest.fixture(scope="module")
def calm_reports():
    """The suite in both packages at CALM, with the shadow attacks kept."""
    kw = dict(frameworks=FRAMEWORK_ORDER, n_shadows=N_SHADOWS,
              n_canaries=N_CANARIES)
    jshadow, shadow = JShadowMIAVerifier(), ShadowMIAVerifier()
    ref = j_run_verification(JCALM, verifiers=(jshadow, "canary", "utility"),
                             **kw)
    port = run_verification(CALM, verifiers=(shadow, "canary", "utility"),
                            device="cpu", init_for_seed=INIT_FOR_SEED, **kw)
    return ref, port, jshadow.attack, shadow.attack


@pytest.fixture(scope="module")
def stages():
    """One stage of the smaller victim scenario in both packages, from the
    reference's weights."""
    jcfg = dataclasses.replace(JCFG, **SMALL)
    cfg = dataclasses.replace(CFG, **SMALL)
    jsim, jtest = j_build_simulator(jcfg)
    tsim, ttest = build_simulator(cfg, device="cpu",
                                  init_fn=INIT_FOR_SEED(cfg.seed))
    return (jsim, j_train_stage(jsim, store_kind=jcfg.store,
                                engine=jcfg.engine), jtest,
            tsim, train_stage(tsim, store_kind=cfg.store, engine=cfg.engine),
            ttest)


# ---------------------------------------------------------------------------
# host-side numpy: byte for byte
# ---------------------------------------------------------------------------

def test_logistic_attack_is_byte_identical():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(300, 3)) * [2.0, 0.1, 5.0] + [1.0, 0.5, -3.0]
    y = (rng.random(300) < 0.5).astype(np.float64)
    a, b = mia._logreg_fit(x, y), jmia._logreg_fit(x, y)
    for u, v in zip(a, b):
        assert np.asarray(u).tobytes() == np.asarray(v).tobytes()
    t = float(np.median(mia._logreg_score(a, x)))
    assert t == float(np.median(jmia._logreg_score(b, x)))
    flags = mia._logreg_predict(a, x, t)
    assert flags.tobytes() == jmia._logreg_predict(b, x, t).tobytes()
    half = len(flags) // 2
    assert mia.attack_f1(flags[:half], flags[half:]) == \
        jmia.attack_f1(flags[:half], flags[half:])
    assert mia.attack_f1(np.zeros(5), np.zeros(5)) == \
        jmia.attack_f1(np.zeros(5), np.zeros(5))


def _client_data(task, n_clients=4, n=10, seed=0):
    rng = np.random.default_rng(seed)
    if task == "classification":
        def mk():
            return (rng.normal(size=(n, 6, 6, 1)).astype(np.float32),
                    rng.integers(0, 10, n).astype(np.int64))
    else:
        def mk():
            return (rng.integers(0, 30, (n, 12)).astype(np.int32),
                    rng.integers(0, 30, (n, 12)).astype(np.int32))
    return {c: mk() for c in range(n_clients)}


@pytest.mark.parametrize("task,model_cfg", [
    ("classification", SimpleNamespace(num_classes=10)),
    ("generation", SimpleNamespace(vocab_size=30)),
])
def test_canaries_are_byte_identical(task, model_cfg):
    x, y = _client_data(task)[0]
    got = resolve_task(task).make_canaries(model_cfg, x, y, 4, seed=11)
    want = j_resolve_task(task).make_canaries(model_cfg, x, y, 4, seed=11)
    assert got[2] == want[2]
    for a, b in zip(got[:2], want[:2]):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    data, jdata = _client_data(task), _client_data(task)
    got = plant_canaries(data, [1, 3], resolve_task(task), model_cfg, n=4,
                         seed=7)
    want = j_plant_canaries(jdata, [1, 3], j_resolve_task(task), model_cfg,
                            n=4, seed=7)
    assert got[2] == want[2]
    for a, b in zip(got[:2], want[:2]):
        assert a.tobytes() == b.tobytes()
    for c in data:
        for a, b in zip(data[c], jdata[c]):
            assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("seed", [0, 3, 17])
def test_predict_stage_victim_matches_reference(seed):
    kw = dict(KW, seed=seed, num_clients=20, clients_per_round=8)
    assert predict_stage_victim(ScenarioConfig(**kw)) == \
        j_predict_stage_victim(JScenario(**kw))


def test_plant_canaries_rejects_zero():
    with pytest.raises(ValueError, match="at least 1 canary"):
        plant_canaries(_client_data("classification"), [1],
                       resolve_task("classification"),
                       SimpleNamespace(num_classes=10), n=0, seed=0)


# ---------------------------------------------------------------------------
# device pieces against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("task,shape", [("classification", (16, 10)),
                                        ("generation", (6, 12, 30))])
def test_mia_features_match_reference(task, shape):
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=shape) * 3).astype(np.float32)
    y = rng.integers(0, shape[-1], shape[:-1])
    got = resolve_task(task).mia_features(torch.from_numpy(logits),
                                          torch.from_numpy(y))
    want = j_resolve_task(task).mia_features(jnp.asarray(logits),
                                             jnp.asarray(y))
    assert tuple(got.shape) == (shape[0], 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def test_ensemble_logits_and_host_eval_match_reference(stages):
    jsim, jrec, jtest, tsim, trec, ttest = stages
    for a, b in zip(jtest, ttest):
        assert a.tobytes() == b.tobytes()
    x, y = ttest[0][:40], ttest[1][:40]
    iface, jiface = tsim.predict_interface(), jsim.predict_interface()
    assert iface.task is tsim.task_spec and iface.device == tsim.device
    lg = iface.ensemble_logits(trec.shard_models, x, y)
    jlg = jiface.ensemble_logits(jrec.shard_models, x, y)
    assert lg.dtype == torch.float32 and tuple(lg.shape) == (40, 10)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), rtol=1e-5,
                               atol=1e-5)
    got = tsim.evaluate_host(trec.shard_models, *ttest, batch=32)
    want = jsim.evaluate_host(jrec.shard_models, *jtest, batch=32)
    stacked = tsim.evaluate(trec.shard_models, *ttest, batch=32)
    assert got["acc"] == want["acc"] == stacked["acc"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["loss"], stacked["loss"], rtol=1e-5)


def test_mia_f1_matches_reference(stages):
    """The threshold attack end to end: features through the stacked
    predict, the numpy attack on them."""
    jsim, jrec, jtest, tsim, trec, ttest = stages
    c = trec.plan.clients
    member = tuple(np.concatenate([tsim.client_data[k][i] for k in c[1:]])
                   for i in (0, 1))
    forgotten = tsim.client_data[c[0]]
    iface, jiface = tsim.predict_interface(), jsim.predict_interface()
    fx = mia._features(iface.stacked_predict, trec.shard_models,
                       iface.make_batch, *member, iface.task)
    jfx = jmia._features(jiface.predict, jrec.shard_models,
                         jiface.make_batch, *member, jiface.task)
    np.testing.assert_allclose(fx, jfx, rtol=1e-4, atol=1e-6)
    got = mia.mia_f1(iface.stacked_predict, trec.shard_models,
                     iface.make_batch, iface.task, member, ttest, forgotten)
    want = jmia.mia_f1(jiface.predict, jrec.shard_models, jiface.make_batch,
                       jiface.task, member, jtest, forgotten)
    assert abs(got - want) <= 0.05


def test_oracle_matches_reference(stages):
    jsim, jrec, _, tsim, trec, _ = stages
    assert trec.store.stats.to_dict() == jrec.store.stats.to_dict()
    victim = jrec.plan.clients[0]
    jres = j_run_unlearn(jsim, "oracle", jrec, [victim])
    tres = run_unlearn(tsim, "oracle", trec, [victim])
    assert tres.cost_units == jres.cost_units
    assert tres.impacted_shards == jres.impacted_shards
    for s in jres.models:
        for t, j in zip(tree_leaves(tres.models[s]),
                        jax.tree.leaves(jres.models[s])):
            np.testing.assert_allclose(_np(t), _np(j), **MODEL_TOL)


def test_oracle_matches_manual_retrain_loop(stages):
    *_, tsim, trec, _ = stages
    victim = trec.plan.clients[0]
    res = run_unlearn(tsim, "oracle", trec, [victim])
    ctx = UnlearnContext(tsim, trec, [victim], tsim.fl.global_rounds)
    w0 = ctx.stage_init_model()
    for s in trec.shard_models:
        if s not in res.impacted_shards:
            for a, b in zip(tree_leaves(trec.shard_models[s]),
                            tree_leaves(res.models[s])):
                assert torch.equal(a, b)
            continue
        retained = ctx.retained(s)
        assert victim not in retained
        xs, ys = ctx.stack_client_data(retained)
        w = w0
        for _ in range(len(trec.round_globals[s]) - 1):
            w = ctx.stacked_mean(ctx.local_train(w, xs, ys,
                                                 tsim.fl.local_epochs))
        for a, b in zip(tree_leaves(w), tree_leaves(res.models[s])):
            np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6, atol=1e-6)


def test_oracle_of_a_fully_erased_shard_is_the_stage_init(stages):
    *_, tsim, trec, _ = stages
    erased = trec.plan.shard_clients[1]
    res = run_unlearn(tsim, "oracle", trec, erased)
    w0 = UnlearnContext(tsim, trec, erased, 1).stage_init_model()
    assert res.impacted_shards == [1] and res.cost_units == 0.0
    for a, b in zip(tree_leaves(res.models[1]), tree_leaves(w0)):
        assert torch.equal(a, b)


def test_oracle_registered_as_framework_alias():
    assert FRAMEWORKS["oracle"] is FRAMEWORKS["retrain-oracle"]
    assert FRAMEWORKS["oracle"].exact
    assert {"SE", "SE-uncoded", "FE", "FR", "RR", "oracle",
            "retrain-oracle"} <= set(FRAMEWORKS)


def test_shadow_features_match_reference():
    """Two shadows, each from the reference's weights at its own seed, at
    CALM's rounds (CFG's six are chaotic)."""
    x, y = shadow_features(CALM, n_shadows=N_SHADOWS, device="cpu",
                           init_for_seed=INIT_FOR_SEED)
    jx, jy = [], []
    for i in range(N_SHADOWS):
        scfg = dataclasses.replace(JCALM, seed=JCALM.seed + 7919 * (i + 1))
        sim, test = j_build_simulator(scfg)
        rec = j_train_stage(sim, store_kind=scfg.store, engine=scfg.engine)
        iface = sim.predict_interface()
        mx, my = (np.concatenate([sim.client_data[c][j]
                                  for c in rec.plan.clients]) for j in (0, 1))
        fm = jmia._features(iface.predict, rec.shard_models,
                            iface.make_batch, mx, my, iface.task)
        fn = jmia._features(iface.predict, rec.shard_models,
                            iface.make_batch, *test, iface.task)
        k = min(len(fm), len(fn))
        idx = np.random.default_rng(scfg.seed).choice(len(fm), k,
                                                      replace=False)
        jx.extend([fm[idx], fn[:k]])
        jy.extend([np.ones(k), np.zeros(k)])
    jx, jy = np.concatenate(jx), np.concatenate(jy)
    assert y.tobytes() == jy.tobytes()
    np.testing.assert_allclose(x, jx, rtol=1e-4, atol=1e-6)


def test_shadow_attack_matches_reference(calm_reports):
    """The attacks both suites fitted at CALM: training accuracy within one
    decision of the reference's."""
    _, _, jattack, attack = calm_reports
    n = 2 * N_SHADOWS * min(CALM.test_n, CALM.clients_per_round
                            * CALM.samples_per_client)
    assert attack.n_shadows == jattack.n_shadows == N_SHADOWS
    assert abs(attack.train_acc - jattack.train_acc) <= 1.0 / n


# ---------------------------------------------------------------------------
# the whole suite against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scenario", ["cfg", "calm"])
def test_cost_units_match_reference(reports, calm_reports, scenario):
    ref, port = (reports if scenario == "cfg" else calm_reports)[:2]
    assert [c.name for c in port.candidates] == \
        [c.name for c in ref.candidates] == \
        ["none", *FRAMEWORK_ORDER, "oracle"]
    for c in ref.candidates:
        assert port.candidate(c.name).cost_units == c.cost_units


@pytest.mark.parametrize("name", ["none", *FRAMEWORK_ORDER])
def test_gaps_to_oracle_match_reference(calm_reports, name):
    ref, port = calm_reports[:2]
    for metric in ("mia_f1", "canary_acc"):
        assert abs(port.gap(name, metric) - ref.gap(name, metric)) \
            <= GAP_TOL, (metric, port.gap(name, metric),
                         ref.gap(name, metric))


@pytest.mark.parametrize("name", ["none", *FRAMEWORK_ORDER])
def test_gaps_at_the_chaotic_scenario_within_rounding_spread(reports, name):
    ref, port, _, native = reports
    for metric in ("mia_f1", "canary_acc"):
        spread = max(abs(port.gap(n, metric) - native.gap(n, metric))
                     for n in ("none", *FRAMEWORK_ORDER))
        tol = max(GAP_TOL, 2 * spread)
        assert abs(port.gap(name, metric) - ref.gap(name, metric)) <= tol, \
            (metric, port.gap(name, metric), ref.gap(name, metric), spread)


def test_bit_reproducible_under_fixed_seed(reports):
    _, port, repeat, _ = reports
    a, b = port.metrics_dict(), repeat.metrics_dict()
    for name in b:                           # repeat ran a candidate subset
        assert a[name] == b[name], f"candidate {name} not reproducible"


# the reference's acceptance checks (tests/test_verify.py) that it passes,
# on the port's report; not its FE-indistinguishability check, which the
# reference itself fails (its FE canary gap 0.167 > 0.15)

def test_probes_detect_remembered_data(reports):
    port = reports[1]
    none, oracle = port.candidate("none"), port.candidate("oracle")
    assert none.metrics["mia_f1"] > oracle.metrics["mia_f1"] + MARGIN_MIA
    assert (none.metrics["canary_acc"]
            > oracle.metrics["canary_acc"] + MARGIN_CANARY)


def test_oracle_calibrates_at_no_information(reports):
    port = reports[1]
    oracle = port.candidate("oracle")
    assert 0.3 <= oracle.metrics["mia_f1"] <= 0.65
    chance = oracle.metrics["canary_chance"]
    assert chance == pytest.approx(1 / 10)
    assert oracle.metrics["canary_acc"] <= chance + 0.15


def test_unlearning_preserves_retained_utility(reports):
    port = reports[1]
    none = port.candidate("none")
    for fw in ("SE", "FE", "oracle"):
        c = port.candidate(fw)
        assert c.metrics["retain_acc"] >= none.metrics["retain_acc"] - 0.25


def test_oracle_pays_the_full_retraining_bill(reports):
    port = reports[1]
    se, oracle = port.candidate("SE"), port.candidate("oracle")
    assert oracle.cost_units > se.cost_units
    assert port.candidate("none").cost_units == 0.0


def test_report_export_shape(reports):
    port = reports[1]
    d = port.to_dict()
    assert d["task"] == "classification" and d["seed"] == CFG.seed
    assert {c["name"] for c in d["candidates"]} == {
        "none", *FRAMEWORK_ORDER, "oracle"}
    assert set(d["gaps_to_oracle"]) == {"none", *FRAMEWORK_ORDER}
    assert "none" in d["pareto_front"]
    assert port.to_json().startswith("{")
    assert "models" not in d and "suite" not in d


def test_keep_models_holds_each_candidates_models():
    cfg = dataclasses.replace(CFG, local_epochs=1, global_rounds=1,
                              test_n=40)
    rep = run_verification(cfg, frameworks=("SE",), verifiers=("utility",),
                           device="cpu", keep_models=True)
    assert sorted(rep.models) == ["SE", "none", "oracle"]
    assert rep.suite.sim.device.type == "cpu"
    se = rep.suite.eval_models(rep.models["SE"], *rep.suite.test)
    assert se["acc"] == rep.candidate("SE").metrics["test_acc"]


# ---------------------------------------------------------------------------
# registry and report mechanics (pure Python, as the reference's)
# ---------------------------------------------------------------------------

def test_verifier_registry():
    assert {"shadow-mia", "canary", "utility"} <= set(VERIFIERS)
    assert isinstance(get_verifier("canary"), CanaryVerifier)
    with pytest.raises(ValueError, match="unknown verifier"):
        get_verifier("nope")
    got = resolve_verifiers(["shadow-mia", UtilityVerifier,
                             CanaryVerifier(n_canaries=3)])
    assert isinstance(got[0], ShadowMIAVerifier)
    assert isinstance(got[1], UtilityVerifier)
    assert got[2].n_canaries == 3
    assert all(isinstance(v, ForgettingVerifier) for v in got)


def test_canary_score_before_plant_raises():
    with pytest.raises(RuntimeError, match="before plant"):
        CanaryVerifier().score(None, {})


def _mk_report():
    def mk(name, fw, cost, mia_f1, can, ret):
        return CandidateScore(name, fw, 0.0, cost, {
            "mia_f1": mia_f1, "canary_acc": can, "retain_acc": ret})
    return VerifyReport(
        task="classification", store="coded", seed=0, victims=[2],
        n_shadows=2, n_canaries=8, verifiers=["shadow-mia"],
        candidates=[mk("none", None, 0.0, 0.8, 0.6, 0.7),
                    mk("SE", "SE", 10.0, 0.5, 0.1, 0.68),
                    mk("slow", "FR", 99.0, 0.5, 0.1, 0.68),
                    mk("oracle", "oracle", 50.0, 0.5, 0.1, 0.7)])


def test_pareto_front_gaps_and_metrics_dict():
    rep = _mk_report()
    front = rep.pareto_front()
    assert "slow" not in front and {"SE", "oracle"} <= set(front)
    assert rep.gap("SE", "mia_f1") == pytest.approx(0.0)
    assert rep.gap("none", "canary_acc") == pytest.approx(0.5)
    with pytest.raises(KeyError, match="no candidate"):
        rep.candidate("missing")
    md = rep.metrics_dict()
    assert "wall_s" not in md["SE"] and md["SE"]["cost_units"] == 10.0
