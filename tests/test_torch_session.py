"""Stage / unlearning / scenario parity of the PyTorch port on the CPU.

One tiny stage (cnn-paper at 8x8 with channels 4/8 and fc 16; 8 clients, 4
per stage, S=2, L=2, G=2, 20 samples per client, batch 10) runs on the
reference and on the port from the reference's initial weights (the port's
``init_fn`` hook): shard models, coded slices, update norms and StoreStats
are compared, then SE requests.  The port's two engines are compared with
each other.  Tolerances: StoreStats exact, SE isolation bit-identical,
the rest rtol 1e-4 / atol 1e-5."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import FLConfig as JFL
from repro.configs import OptimizerConfig as JOpt
from repro.configs import get_config as jget
from repro.data import client_datasets_images, make_image_data
from repro.fl import FLSimulator as JSim
from repro.fl.experiment import run_unlearn as j_run_unlearn
from repro.fl.experiment import train_stage as j_train_stage
from repro.models import init_params as jinit
from repro_torch.configs import FLConfig, OptimizerConfig, get_config
from repro_torch.fl import FLSimulator
from repro_torch.fl.experiment import run_unlearn, train_stage
from repro_torch.models import from_numpy_params

torch.set_num_threads(1)
TINY = dict(image_size=8, cnn_channels=(4, 8), d_model=16)
FL = dict(num_clients=8, clients_per_round=4, num_shards=2, local_epochs=2,
          global_rounds=2)
TOL = dict(rtol=1e-4, atol=1e-5)
JCFG = dataclasses.replace(jget("cnn-paper"), **TINY)
TCFG = dataclasses.replace(get_config("cnn-paper"), **TINY)


def _clients():
    data = make_image_data(8 * 20, image_size=8, seed=0)
    return client_datasets_images(data, 8, iid=True)


def _jax_init(cfg, seed=0):
    """The reference's initial weights, by salt, for the port's hook."""
    return lambda salt: from_numpy_params(jax.tree.map(
        np.asarray, jinit(cfg, jax.random.key(seed + salt))), device="cpu")


def _jsim():
    return JSim(JCFG, JFL(**FL), _clients(), task="classification",
                opt_cfg=JOpt(name="sgd", lr=0.05, grad_clip=0.0),
                local_batch=10)


def _tsim():
    return FLSimulator(TCFG, FLConfig(**FL), _clients(),
                       task="classification",
                       opt_cfg=OptimizerConfig(name="sgd", lr=0.05,
                                               grad_clip=0.0),
                       local_batch=10, device="cpu", init_fn=_jax_init(JCFG))


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


@pytest.fixture(scope="module")
def jstage():
    sim = _jsim()
    return sim, j_train_stage(sim, engine="fused")


@pytest.fixture(scope="module")
def tstages():
    out = {}
    for engine in ("fused", "stage"):
        sim = _tsim()
        out[engine] = (sim, train_stage(sim, engine=engine))
    return out


@pytest.mark.parametrize("engine", ["fused", "stage"])
def test_stage_matches_reference(jstage, tstages, engine):
    _, jrec = jstage
    _, trec = tstages[engine]
    assert jrec.plan.shard_clients == trec.plan.shard_clients
    for s in jrec.shard_models:
        for k, v in jrec.shard_models[s].items():
            np.testing.assert_allclose(_np(trec.shard_models[s][k]), _np(v),
                                       err_msg=k, **TOL)
        for g in range(FL["global_rounds"] + 1):
            for k, v in jrec.round_globals[s][g].items():
                np.testing.assert_allclose(_np(trec.round_globals[s][g][k]),
                                           _np(v), **TOL)
    assert trec.history_norms.keys() == jrec.history_norms.keys()
    np.testing.assert_allclose(
        [trec.history_norms[k] for k in sorted(jrec.history_norms)],
        [jrec.history_norms[k] for k in sorted(jrec.history_norms)], **TOL)
    for g in range(FL["global_rounds"]):
        np.testing.assert_allclose(_np(trec.store._slices[g]),
                                   _np(jrec.store._slices[g]), **TOL)
    assert trec.store.stats.to_dict() == jrec.store.stats.to_dict()


def test_engines_agree(tstages):
    """The port's fused and stage engines: shard models and norms
    bit-identical on the CPU, coded slices within 1e-5 rel."""
    (_, fr), (_, sr) = tstages["fused"], tstages["stage"]
    for s in fr.shard_models:
        for k in fr.shard_models[s]:
            torch.testing.assert_close(sr.shard_models[s][k],
                                       fr.shard_models[s][k], rtol=0, atol=0)
    assert sr.history_norms == fr.history_norms
    for g in range(FL["global_rounds"]):
        torch.testing.assert_close(sr.store._slices[g], fr.store._slices[g],
                                   rtol=1e-5, atol=1e-6)
    assert sr.store.stats.to_dict() == fr.store.stats.to_dict()


@pytest.mark.parametrize("engine", ["fused", "stage"])
def test_se_request_matches_reference(jstage, tstages, engine):
    jsim, jrec = jstage
    tsim, trec = tstages[engine]
    victim = jrec.plan.shard_clients[0][0]
    before = {s: {k: v.clone() for k, v in m.items()}
              for s, m in trec.shard_models.items()}
    jstats0 = jrec.store.stats.snapshot()
    tstats0 = trec.store.stats.snapshot()
    jres = j_run_unlearn(jsim, "SE", jrec, [victim])
    tres = run_unlearn(tsim, "SE", trec, [victim])
    assert tres.impacted_shards == jres.impacted_shards == [0]
    assert tres.cost_units == jres.cost_units
    for k, v in jres.models[0].items():
        np.testing.assert_allclose(_np(tres.models[0][k]), _np(v),
                                   err_msg=k, **TOL)
        assert np.isfinite(_np(tres.models[0][k])).all()
    for s in before:
        if s != 0:
            for k in before[s]:
                torch.testing.assert_close(tres.models[s][k], before[s][k],
                                           rtol=0, atol=0)
    for f in ("reads", "decode_flops", "comm_bytes_retrieve"):
        assert getattr(tres.store_stats, f) - getattr(tstats0, f) == \
            getattr(jres.store_stats, f) - getattr(jstats0, f)


def test_batched_se_matches_reference(jstage, tstages):
    """A request over both shards retrains them together (calib_stage)."""
    jsim, jrec = jstage
    tsim, trec = tstages["fused"]
    victims = [jrec.plan.shard_clients[s][0] for s in (0, 1)]
    jres = j_run_unlearn(jsim, "SE", jrec, victims, rounds=1)
    tres = run_unlearn(tsim, "SE", trec, victims, rounds=1)
    assert tres.cost_units == jres.cost_units
    for s in (0, 1):
        for k, v in jres.models[s].items():
            np.testing.assert_allclose(_np(tres.models[s][k]), _np(v), **TOL)


def test_evaluate_matches_reference(jstage, tstages):
    """The ensemble evaluation (mean fp32 logits of the shard models)."""
    jsim, jrec = jstage
    tsim, trec = tstages["stage"]
    test = make_image_data(120, image_size=8, seed=99)
    jm = jsim.evaluate(jrec.shard_models, test.images, test.labels, batch=50)
    tm = tsim.evaluate(trec.shard_models, test.images, test.labels, batch=50)
    assert tm["acc"] == jm["acc"]
    np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=1e-4)
