"""The published bf16 numerics sharded over a (data=2, model=2)
``DeviceMesh`` of 4 gloo ranks, against the reference's unsharded jitted
steps on the CPU: one training case (rwkv6-3b's three steps,
``launch.train.steps_on_mesh``) and one serving case (gemma3-27b's prefill
and four teacher-forced decode steps, ``launch.serve.serve_on_mesh``), at
``reduce_for_smoke`` widths with bf16 params and compute and the
reference's bf16 weights, under the published config's rules.

Tolerance: ``tests/test_torch_bf16.py``'s, twice the reference's own
one-ulp spread of each output, piece by piece (each leaf's update, each
logits row), measured unsharded: the sharded step is the unsharded one's
arithmetic on each rank's shards."""
import functools

import numpy as np
import pytest
import torch
from test_torch_bf16 import (BF16, FL, GEN, HIST, assert_within_spread,
                             client_batch, configs, port_outputs,
                             reference_serve, reference_step,
                             leaves, reference_weights, rows, serve_batch,
                             serve_spread, step_spread)

from repro_torch.configs import FLConfig, OptimizerConfig
from repro_torch.launch.mesh import spawn
from repro_torch.launch.serve import serve_on_mesh
from repro_torch.launch.train import steps_on_mesh

torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def train_world():
    jcfg, _ = configs("rwkv6-3b")
    return spawn(steps_on_mesh, 4, "gloo", "rwkv6-3b", "2x2",
                 reference_weights(jcfg), client_batch(jcfg), HIST,
                 FLConfig(**FL), OptimizerConfig(name="adamw", lr=1e-3),
                 OptimizerConfig(name="sgdm", lr=1e-2), "cpu", BF16,
                 timeout=600)


@pytest.mark.parametrize("step", ["fedavg", "central", "calibration"])
def test_bf16_sharded_step_matches_reference(step):
    out = train_world()
    spec = out["spec"]
    assert any("data" in d for d in spec.values()), spec
    assert any("model" in d for d in spec.values()), spec
    jcfg, _ = configs("rwkv6-3b")
    new, moments, mets = out[step]
    got = port_outputs(reference_weights(jcfg), new,
                       moments["mu"] if moments else None, mets)
    assert_within_spread(got, reference_step(jcfg, step),
                         step_spread(jcfg, step), ("rwkv6-3b", step, "2x2"))


def test_bf16_sharded_serving_matches_reference():
    jcfg, _ = configs("gemma3-27b")
    w = reference_weights(jcfg)
    batch, nxt = serve_batch(jcfg)
    max_len = batch["tokens"].shape[1] + GEN
    (res,) = spawn(serve_on_mesh, 4, "gloo",
                   [dict(arch="gemma3-27b", changes=BF16, weights=w,
                         batch=batch, feed=nxt, max_len=max_len)],
                   "2x2", "cpu", timeout=600)
    assert any(len(p) > 0 for p in res["placements"])
    got = {"logits": rows(res["logits"]),
           "cache": leaves(res["caches"][-1])}
    assert all(np.isfinite(r).all() for r in got["logits"])
    assert_within_spread(got, reference_serve(jcfg), serve_spread(jcfg),
                         ("gemma3-27b", "serve", "2x2"))
