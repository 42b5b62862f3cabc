"""FE, FR and SE-uncoded on the generation task, with the mamba family and
with the task's default family (the paper's NanoGPT), through the PyTorch
port against the reference on the CPU.  tests/test_scenario_zoo.py's tiny
configuration (as tests/test_torch_generation.py and test_torch_nanogpt.py
run it), one stage from the reference's initial weights (FR restarts from
the reference's salt-777 model): FE and FR on the full store, one request
each; SE-uncoded on the uncoded store.  Exact: StoreStats, clients,
impacted shards and cost units; the unlearned models within those files'
rtol 1e-4 / atol 1e-4."""
import jax
import numpy as np
import pytest
import torch

from repro.fl.experiment import RequestSchedule as JSchedule
from repro.fl.experiment import ScenarioConfig as JScenario
from repro.fl.experiment import UnlearnRequest as JRequest
from repro.fl.experiment import build_session as j_build_session
from repro.models import init_params as jinit
from repro_torch.core.tree import tree_leaves
from repro_torch.fl.experiment import (RequestSchedule, ScenarioConfig,
                                       UnlearnRequest, build_session)
from repro_torch.models import from_numpy_params

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-4)
ZOO = dict(task="generation", partitioner="zipf",
           partitioner_kwargs={"exponent": 0.5}, num_clients=8,
           clients_per_round=4, num_shards=2, local_epochs=1, global_rounds=2,
           samples_per_client=6, seq_len=16, test_n=20, local_batch=2,
           num_stages=1)
# store -> the requests served after stage 0: (framework, shard of the
# client named)
REQUESTS = {"full": (("FE", 0), ("FR", 1)), "uncoded": (("SE-uncoded", 0),)}


def _requests(request_cls, store):
    return [request_cls(lambda plan, s=shard: [plan.shard_clients[s][0]],
                        framework=fw, rounds=1)
            for fw, shard in REQUESTS[store]]


@pytest.mark.parametrize("store", sorted(REQUESTS))
@pytest.mark.parametrize("model", ["mamba", ""])
def test_frameworks_match_reference_on_generation(model, store):
    kw = dict(ZOO, model=model, store=store)
    jcfg = JScenario(schedule=JSchedule(_requests(JRequest, store)), **kw)
    jsession, _ = j_build_session(jcfg)
    jrep = jsession.run(jcfg.num_stages, schedule=jcfg.schedule)
    jsim = jsession.sim

    def init_fn(salt):
        return from_numpy_params(jax.tree.map(
            np.asarray, jinit(jsim.cfg, jax.random.key(jsim.seed + salt))))
    tcfg = ScenarioConfig(schedule=RequestSchedule(
        _requests(UnlearnRequest, store)), **kw)
    tsession, _ = build_session(tcfg, device="cpu", init_fn=init_fn)
    trep = tsession.run(tcfg.num_stages, schedule=tcfg.schedule)
    assert tsession.sim.cfg.name == jsim.cfg.name
    assert trep.store_stats.to_dict() == jrep.store_stats.to_dict()
    assert trep.total_cost_units == jrep.total_cost_units
    js, ts = jrep.stages[0], trep.stages[0]
    assert ts.clients == js.clients
    assert ts.store_stats.to_dict() == js.store_stats.to_dict()
    assert len(ts.unlearn) == len(js.unlearn) == len(REQUESTS[store])
    for jres, tres in zip(js.unlearn, ts.unlearn):
        assert tres.impacted_shards == jres.impacted_shards
        assert tres.cost_units == jres.cost_units
        assert sorted(tres.models) == sorted(jres.models)
        for s in jres.models:
            for t, j in zip(tree_leaves(tres.models[s]),
                            jax.tree.leaves(jres.models[s])):
                np.testing.assert_allclose(t.float().numpy(),
                                           np.asarray(j, np.float32), **TOL)
