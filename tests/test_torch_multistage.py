"""Two-stage sessions of the PyTorch port against the reference on the CPU:
four SE requests, two after each stage, through ``run_scenario`` with
batched and sequential requests, the uncoded store with "SE-uncoded",
bf16 slices encoded two rounds at a time, and the stage engine batched.
Same tiny CNN configuration as tests/test_torch_scenario.py, from the
reference's initial weights.  Exact: each stage's clients and StoreStats,
each request's impacted shards and cost units, the session's StoreStats
and cost; the unlearned models within that file's rtol 1e-4 / atol 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fl.experiment import RequestSchedule as JSchedule
from repro.fl.experiment import ScenarioConfig as JScenario
from repro.fl.experiment import UnlearnRequest as JRequest
from repro.fl.experiment import run_scenario as j_run_scenario
from repro.fl.families import get_model_family as jfamily
from repro.models import init_params as jinit
from repro_torch.fl.experiment import (RequestSchedule, ScenarioConfig,
                                       UnlearnRequest, run_scenario)
from repro_torch.models import from_numpy_params

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-5)
KW = dict(num_clients=8, clients_per_round=4, num_shards=2, local_epochs=1,
          global_rounds=2, samples_per_client=20, image_size=8,
          local_batch=10, num_stages=2)
# name -> (scenario options of the reference, of the port; framework)
SESSIONS = {
    "se_batched": (dict(batch_requests=True),) * 2 + ("SE",),
    "se_sequential": (dict(batch_requests=False),) * 2 + ("SE",),
    "se_uncoded": (dict(store="uncoded"),) * 2 + ("SE-uncoded",),
    "bf16_slices_group2": (dict(encode_group=2, slice_dtype=jnp.bfloat16),
                           dict(encode_group=2, slice_dtype="bfloat16"),
                           "SE"),
    "stage_engine_batched": (dict(engine="stage", batch_requests=True),) * 2
    + ("SE",),
}


def _nth_of_shard(shard, n):
    return lambda plan: [plan.shard_clients[shard][n]]


def _requests(request_cls, framework):
    """Two requests after each stage, on each shard's n-th client."""
    return [request_cls(_nth_of_shard(shard, stage), framework=framework,
                        after_stage=stage, rounds=1)
            for stage in (0, 1) for shard in (0, 1)]


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


@pytest.mark.parametrize("name", sorted(SESSIONS))
def test_two_stage_session_matches_reference(name):
    jopt, topt, fw = SESSIONS[name]
    jcfg = JScenario(schedule=JSchedule(_requests(JRequest, fw)),
                     **KW, **jopt)
    tcfg = ScenarioConfig(schedule=RequestSchedule(
        _requests(UnlearnRequest, fw)), **KW, **topt)
    jrep = j_run_scenario(jcfg)
    model_cfg = jfamily("cnn").build(jcfg)
    trep = run_scenario(tcfg, device="cpu", init_fn=lambda salt: (
        from_numpy_params(jax.tree.map(
            np.asarray, jinit(model_cfg, jax.random.key(jcfg.seed + salt))), device="cpu")))
    assert trep.store_stats.to_dict() == jrep.store_stats.to_dict()
    assert trep.total_cost_units == jrep.total_cost_units
    jd, td = jrep.to_dict(), trep.to_dict()
    assert len(td["stages"]) == len(jd["stages"]) == 2
    for js, ts in zip(jd["stages"], td["stages"]):
        assert ts["clients"] == js["clients"]
        assert ts["store_stats"] == js["store_stats"]
        for key in ("impacted_shards", "cost_units"):
            assert [u[key] for u in ts["unlearn"]] == \
                [u[key] for u in js["unlearn"]]
    served = 0
    for jstage, tstage in zip(jrep.stages, trep.stages):
        for jres, tres in zip(jstage.unlearn, tstage.unlearn):
            assert sorted(tres.models) == sorted(jres.models)
            for s in jres.models:
                for k, v in jres.models[s].items():
                    np.testing.assert_allclose(_np(tres.models[s][k]),
                                               _np(v), err_msg=k, **TOL)
            served += 1
    assert served == (2 if jcfg.batch_requests else 4)
