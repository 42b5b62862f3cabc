"""The PyTorch port's examples (``examples/*_torch.py``) against the
reference on the CPU: each example's ``run`` at a tiny size, fed the
reference's weights (``init_fn`` through ``from_numpy_params``), against
the reference example's own calls repeated on the same configuration.

* quickstart: StoreStats, cost units, impacted shards and accuracies
  exactly; the SE models within rtol 1e-4 / atol 1e-5 (the session
  tests' tolerance); the attack's F1 within 0.05, as
  tests/test_torch_verify.py holds it (ROADMAP queue 3, item 9).
* coded_storage: slices and decodes within 1e-5 (1 + |r|); the located
  clients equal, and the truth.
* unlearn_generation: per-client sizes, cost units and impacted shards
  exactly; perplexity and bits per char within twice the rwkv6 spread of
  ROADMAP queue 3, item 6 (the reference's two WKV forms end its stage
  3.5e-3 apart: 7e-3 relative here).
* serve_unlearning: the trace, each policy's batches and each request's
  jobs exactly; the unlearned models within rtol 1e-4 / atol 1e-5.  Walls
  are not compared.
* serve_batched: each reduced arch at prompt 8 and 4 generated tokens, the
  prefill's logits within 1e-4 and the greedy tokens equal (jamba against
  the reference's ``pallas`` scan route: its chunked route decays the
  cached state through the prompt's padding, ROADMAP queue 3, item 16).

Each example's ``main`` also runs once at the reference's own sizes on the
CPU (a few seconds each) and prints its lines.
"""
import contextlib
import dataclasses
import importlib.util
import io
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs import reduce_for_smoke as jreduce
from repro.core import coding as jcoding
from repro.fl.experiment import ScenarioConfig as JScenario
from repro.fl.experiment import UnlearnRequest as JRequest
from repro.fl.experiment import build_session as j_build_session
from repro.fl.families import get_model_family as jfamily
from repro.fl.mia import mia_f1 as j_mia_f1
from repro.launch.serve import make_decode_step as j_decode_step
from repro.launch.serve import make_prefill_step as j_prefill_step
from repro.models import init_params as jinit
from repro.service import DevicePlacement as JPlacement
from repro.service import UnlearningService as JService
from repro.service import bursty_trace as j_bursty_trace
from repro.service import single_device_placement as j_single
from repro_torch.core.tree import leaves_with_paths
from repro_torch.models import from_numpy_params

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-4, atol=1e-5)


def example(name):
    """``examples/<name>_torch.py`` as a module."""
    path = ROOT / "examples" / f"{name}_torch.py"
    spec = importlib.util.spec_from_file_location(f"{name}_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference_config(cfg):
    """The reference's ``ScenarioConfig`` with the port's field values."""
    return JScenario(**{f.name: getattr(cfg, f.name)
                        for f in dataclasses.fields(JScenario)})


def jax_init(jcfg):
    """The port's ``init_fn(salt)``: the reference simulator's draw for
    that salt, ``init_params(cfg, key(seed + salt))``."""
    model_cfg = jfamily(jcfg.model).build(jcfg)
    return lambda salt: from_numpy_params(jax.tree.map(np.asarray, jinit(
        model_cfg, jax.random.key(jcfg.seed + salt))), device="cpu")


def assert_models_close(got, want, **tol):
    for (path, g), w in zip(leaves_with_paths(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   err_msg="/".join(path), **tol)


# --------------------------------------------------------------- quickstart

QUICK = dict(num_clients=8, clients_per_round=4, num_shards=2,
             local_epochs=2, global_rounds=2, samples_per_client=40,
             image_size=8, test_n=80)


def test_quickstart_matches_reference():
    qs = example("quickstart")
    cfg = qs.config(**QUICK)
    jcfg = reference_config(cfg)
    got = qs.run(cfg, device="cpu", init_fn=jax_init(jcfg))

    session, (test_x, test_y) = j_build_session(jcfg)
    sim = session.sim
    record = session.run_stage()
    assert got["store_stats"] == record.store.stats.to_dict()
    assert got["base"]["acc"] == sim.evaluate(record.shard_models, test_x,
                                              test_y)["acc"]
    victim = record.plan.shard_clients[0][0]
    assert got["victim"] == victim
    for fw in ("SE", "FR"):
        res = session.unlearn(JRequest([victim], framework=fw))[0]
        mine = got["unlearn"][fw]
        assert mine["result"].cost_units == res.cost_units
        assert mine["result"].impacted_shards == res.impacted_shards == [0]
        assert mine["acc"] == sim.evaluate(res.models, test_x,
                                           test_y)["acc"]
        for s in res.models:
            assert_models_close(mine["result"].models[s], res.models[s],
                                **TOL)
    res = session.unlearn(JRequest([victim], framework="SE"))[0]
    members = [c for c in record.plan.clients if c != victim][:4]
    mx = np.concatenate([sim.client_data[c][0][:40] for c in members])
    my = np.concatenate([sim.client_data[c][1][:40] for c in members])
    iface = sim.predict_interface()
    f1 = j_mia_f1(iface.predict, res.models, iface.make_batch, iface.task,
                  (mx, my), (test_x, test_y), sim.client_data[victim])
    assert abs(got["mia_f1"] - f1) <= 0.05
    report = session.report.to_dict()
    for key in ("num_stages", "total_cost_units", "store_stats"):
        assert got["report"][key] == report[key], key


# ------------------------------------------------------------ coded storage

@pytest.mark.parametrize("width,use_kernel", [(1_000, True),
                                              (100_000, False)])
def test_coded_storage_matches_reference(width, use_kernel):
    """At P 1,000 against the reference's interpret-mode Pallas kernel, at
    the example's P 100,000 against its XLA path."""
    got = example("coded_storage").run(width=width, device="cpu")
    c, s = 24, 4
    scheme = jcoding.CodingScheme(num_shards=s, num_clients=c)
    rng = np.random.default_rng(0)
    shard_params = jnp.asarray(rng.standard_normal((s, width)), jnp.float32)
    slices = jcoding.encode(scheme, shard_params, use_kernel=use_kernel)
    ids = [1, 7, 13, 22]
    rec_a = jcoding.decode_erasure(scheme, slices[jnp.asarray(ids)], ids,
                                   use_kernel=use_kernel)
    avail = [0, 4, 9, 15, 18, 23]
    rec_b = jcoding.decode_erasure(scheme, slices[jnp.asarray(avail)], avail)
    bad = [2, 11, 19]
    corrupted = np.array(slices)
    corrupted[bad] += rng.standard_normal((len(bad), width)) * 10
    rec_c, located = jcoding.decode_with_errors(scheme,
                                                jnp.asarray(corrupted))

    def close(t, r):
        r = np.asarray(r)
        assert np.all(np.abs(t.numpy() - r) <= 1e-5 * (1 + np.abs(r)))
    close(got["slices"], slices)
    for key, ref in (("a", rec_a), ("b", rec_b), ("c", rec_c)):
        close(got["decoded"][key], ref)
        assert got["err"][key] <= 1e-3
    assert got["located"] == np.asarray(located).tolist() == bad


# ------------------------------------------------------- unlearn generation

GEN = dict(num_clients=8, clients_per_round=4, num_shards=2,
           local_epochs=1, global_rounds=2, samples_per_client=6,
           seq_len=16, test_n=20, local_batch=2)
RWKV6_SPREAD = 3.5e-3            # ROADMAP queue 3, item 6


def test_unlearn_generation_matches_reference():
    ug = example("unlearn_generation")
    cfg = ug.config(**GEN)
    jcfg = reference_config(cfg)
    got = ug.run(cfg, device="cpu", init_fn=jax_init(jcfg))

    session, (test_x, test_y) = j_build_session(jcfg)
    sim = session.sim
    record = session.run_stage()
    sizes = {c: len(sim.client_data[c][0]) for c in record.plan.clients}
    assert got["sizes"] == sizes
    victim = record.plan.shard_clients[0][0]
    assert got["victim"] == victim
    res = session.unlearn(JRequest([victim], framework="SE"))[0]
    assert got["se"].cost_units == res.cost_units
    assert list(got["se"].impacted_shards) == list(res.impacted_shards) \
        == [0]
    for mine, ref in ((got["base"], sim.evaluate(record.shard_models,
                                                 test_x, test_y)),
                      (got["after"], sim.evaluate(res.models, test_x,
                                                  test_y))):
        for key in ("ppl", "bpc"):
            np.testing.assert_allclose(mine[key], ref[key],
                                       rtol=2 * RWKV6_SPREAD, err_msg=key)


# --------------------------------------------------------- serve unlearning

SERVE = dict(num_clients=8, clients_per_round=4, num_shards=2,
             local_epochs=1, global_rounds=2, samples_per_client=20,
             image_size=8, test_n=20)


def _entry(e):
    return (e.rid, e.batch_id, tuple(e.clients), e.n_jobs,
            sorted(map(tuple, e.impacted)), e.cost_units, e.queue_wait,
            list(e.devices))


def test_serve_unlearning_matches_reference():
    su = example("serve_unlearning")
    cfg = su.config(**SERVE)
    jcfg = reference_config(cfg)
    got = su.run(cfg, requests=6, deadline=20.0, device="cpu",
                 init_fn=jax_init(jcfg))
    assert got["slots"] == 1

    session, _ = j_build_session(jcfg)
    record = session.run_stage()
    trace = j_bursty_trace(record.plan.clients, n=6, burst_rate=2.0,
                           mean_burst=3.0, seed=0, skew=1.5, deadline=20.0,
                           rounds=cfg.global_rounds)
    assert [dataclasses.astuple(r) for r in got["trace"]] == \
        [dataclasses.astuple(r) for r in trace]
    policies = [("fifo", {}, j_single()), ("window", {"width": 1.0},
                                           JPlacement()),
                ("sla", {"default_deadline": 20.0, "est_serve": 2.0,
                         "max_hold": 1.0}, JPlacement())]
    assert len(got["serves"]) == len(policies)
    for mine, (policy, opts, placement) in zip(got["serves"], policies):
        n0 = len(session.report.stages[-1].unlearn)
        report = JService(session, policy=policy, policy_opts=opts,
                          placement=placement).serve(trace)
        results = session.report.stages[-1].unlearn[n0:]
        assert mine["report"].num_batches == report.num_batches
        assert [_entry(e) for e in mine["report"].entries] == \
            [_entry(e) for e in report.entries]
        assert len(mine["results"]) == len(results)
        for a, b in zip(mine["results"], results):
            assert a.impacted_shards == b.impacted_shards
            assert a.cost_units == b.cost_units
            for s in b.models:
                assert_models_close(a.models[s], b.models[s], **TOL)


# ------------------------------------------------------------ serve batched

ARCHS = ("olmo-1b", "granite-moe-1b-a400m", "rwkv6-3b",
         "jamba-1.5-large-398b", "whisper-tiny", "internvl2-2b")


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_batched_matches_reference(arch):
    sb = example("serve_batched")
    assert sb.ARCHS == ARCHS
    jcfg = jreduce(jget(arch))
    if jcfg.family == "hybrid":
        jcfg = dataclasses.replace(jcfg, mamba_impl="pallas")
    w = jax.tree.map(np.asarray, jinit(jcfg, jax.random.key(0)))
    batch, prompt, gen = 8, 8, 4
    got = sb.run(arch, batch, prompt, gen, device="cpu",
                 init_fn=lambda cfg: from_numpy_params(w, device="cpu"))

    params = jax.tree.map(jnp.asarray, w)
    rng = np.random.default_rng(0)
    b = {"tokens": jnp.asarray(rng.integers(0, jcfg.vocab_size,
                                            (batch, prompt)), jnp.int32)}
    if jcfg.family == "vlm":
        b["patches"] = jnp.zeros((batch, jcfg.vision_tokens, jcfg.d_model),
                                 jnp.float32)
    if jcfg.family == "audio":
        b["frames"] = jnp.zeros((batch, 64, jcfg.d_model), jnp.float32)
    prefill = jax.jit(j_prefill_step(jcfg, max_len=prompt + gen))
    decode = jax.jit(j_decode_step(jcfg))
    logits, cache = prefill(params, b)
    np.testing.assert_allclose(got["prefill_logits"].numpy(),
                               np.asarray(logits[:, -1], np.float32),
                               rtol=1e-4, atol=1e-4)
    tok = jnp.argmax(logits[:, -1:], -1).astype(jnp.int32)
    out = [np.asarray(tok)[:, 0]]
    for _ in range(gen - 1):
        logits, cache = decode(params, tok, cache)
        tok = jnp.argmax(logits[:, -1:], -1).astype(jnp.int32)
        out.append(np.asarray(tok)[:, 0])
    np.testing.assert_array_equal(got["tokens"], np.stack(out, 1))


# --------------------------------------------------------------- the mains

@pytest.mark.parametrize("name,lines", [
    ("quickstart", 10), ("coded_storage", 10), ("unlearn_generation", 5),
    ("serve_unlearning", 32), ("serve_batched", 6)])
def test_main_prints_the_reference_lines(name, lines):
    """Each example's ``main`` at the reference's sizes on the CPU: the
    reference example's number of lines, every number finite."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        example(name).main(["--device", "cpu"])
    text = buf.getvalue().splitlines()
    assert len(text) == lines, text
    assert not re.search(r"\b(nan|inf)\b", "\n".join(text))
