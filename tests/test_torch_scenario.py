"""Framework and scenario parity of the PyTorch port on the CPU: FE and FR
against the reference from the same stage and weights, and
``run_scenario`` with a scheduled SE request against the reference's
(StoreStats and cost units exact).  Same tiny configuration as
tests/test_torch_session.py; model tolerances rtol 1e-4 / atol 1e-5."""
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
from repro.fl.experiment import RequestSchedule as JSchedule
from repro.fl.experiment import ScenarioConfig as JScenario
from repro.fl.experiment import UnlearnRequest as JRequest
from repro.fl.experiment import run_scenario as j_run_scenario
from repro.fl.experiment import run_unlearn as j_run_unlearn
from repro.fl.experiment import train_stage as j_train_stage
from repro.fl.families import get_model_family as jfamily
from repro.models import init_params as jinit
from repro_torch.configs import FLConfig, OptimizerConfig, get_config
from repro_torch.fl import FLSimulator
from repro_torch.fl.experiment import (RequestSchedule, ScenarioConfig,
                                       UnlearnRequest, run_scenario,
                                       run_unlearn, train_stage)
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
    return lambda salt: from_numpy_params(jax.tree.map(
        np.asarray, jinit(cfg, jax.random.key(seed + salt))), device="cpu")


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


@pytest.fixture(scope="module")
def full_stages():
    """One stage on the full store in both packages, shared by FE and FR
    (neither changes the record)."""
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


@pytest.mark.parametrize("fw", ["FE", "FR"])
def test_federation_frameworks_match_reference(full_stages, fw):
    jsim, jrec, tsim, trec = full_stages
    assert trec.store.stats.to_dict() == jrec.store.stats.to_dict()
    victim = jrec.plan.shard_clients[1][0]
    jres = j_run_unlearn(jsim, fw, jrec, [victim], rounds=1)
    tres = run_unlearn(tsim, fw, trec, [victim], rounds=1)
    assert tres.cost_units == jres.cost_units
    for k, v in jres.models[0].items():
        np.testing.assert_allclose(_np(tres.models[0][k]), _np(v), **TOL)


@pytest.mark.parametrize("engine", ["fused", "stage"])
def test_run_scenario_matches_reference(engine):
    kw = dict(num_clients=8, clients_per_round=4, num_shards=2,
              local_epochs=2, global_rounds=2, samples_per_client=20,
              image_size=8, local_batch=10, engine=engine)

    def first_of_shard0(plan):
        return [plan.shard_clients[0][0]]

    jcfg = JScenario(schedule=JSchedule([JRequest(first_of_shard0)]), **kw)
    tcfg = ScenarioConfig(schedule=RequestSchedule(
        [UnlearnRequest(first_of_shard0)]), **kw)
    jrep = j_run_scenario(jcfg)
    trep = run_scenario(tcfg, device="cpu",
                        init_fn=_jax_init(jfamily("cnn").build(jcfg)))
    assert trep.store_stats.to_dict() == jrep.store_stats.to_dict()
    assert trep.total_cost_units == jrep.total_cost_units
    jd, td = jrep.to_dict(), trep.to_dict()
    for js, ts in zip(jd["stages"], td["stages"]):
        assert ts["clients"] == js["clients"]
        assert ts["store_stats"] == js["store_stats"]
        assert [u["impacted_shards"] for u in ts["unlearn"]] == \
            [u["impacted_shards"] for u in js["unlearn"]]


def test_run_scenario_matches_reference_at_20_shards():
    """S = 20 shards of 2 clients (C = 40 coded slices): past the register
    tile of the CUDA coding kernels (S <= 16); one round, one local epoch."""
    kw = dict(num_clients=40, clients_per_round=40, num_shards=20,
              local_epochs=1, global_rounds=1, samples_per_client=10,
              image_size=8, local_batch=10, engine="fused")

    def first_of_shard0(plan):
        return [plan.shard_clients[0][0]]

    jcfg = JScenario(schedule=JSchedule([JRequest(first_of_shard0)]), **kw)
    tcfg = ScenarioConfig(schedule=RequestSchedule(
        [UnlearnRequest(first_of_shard0)]), **kw)
    jrep = j_run_scenario(jcfg)
    trep = run_scenario(tcfg, device="cpu",
                        init_fn=_jax_init(jfamily("cnn").build(jcfg)))
    assert trep.store_stats.to_dict() == jrep.store_stats.to_dict()
    assert trep.total_cost_units == jrep.total_cost_units
    jd, td = jrep.to_dict(), trep.to_dict()
    assert len(td["stages"][0]["clients"]) == 40
    for js, ts in zip(jd["stages"], td["stages"]):
        assert ts["clients"] == js["clients"]
        assert ts["store_stats"] == js["store_stats"]
        assert [u["impacted_shards"] for u in ts["unlearn"]] == \
            [u["impacted_shards"] for u in js["unlearn"]]
        assert [u["cost_units"] for u in ts["unlearn"]] == \
            [u["cost_units"] for u in js["unlearn"]]


def test_use_kernel_store_option_builds():
    """``store_options={"use_kernel": True}`` is accepted and ignored: the
    tensor's device picks the kernel or its plain version."""
    cfg = ScenarioConfig(num_clients=8, clients_per_round=4, num_shards=2,
                         local_epochs=1, global_rounds=1,
                         samples_per_client=20, image_size=8, local_batch=10,
                         store_options={"use_kernel": True})
    rep = run_scenario(cfg, device="cpu")
    assert rep.store_stats.client_bytes > 0
