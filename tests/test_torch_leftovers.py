"""The port's host-side and API leftovers against the reference on the CPU:
the client-dataset builders and ``batch_iterator``, ``core.theory``,
``core.baselines``, ``decode_vandermonde`` / ``decode_with_errors`` /
``encode_pytrees`` / ``decode_pytrees``, the coded store's tree path, the
deprecated spellings and shims, the ``legacy`` round engine, and the dense
configurations (llama3.2-3b, olmo-1b, yi-6b, ``cnn-paper-cifar``).

Host-side numpy/float64 output is compared byte for byte (arrays with
``assert_array_equal`` and equal dtypes, floats with ``==``).  fp32 products
are held at rtol / atol 1e-5 (the coding tests' tolerance); the legacy
engine's stage at 1e-4, as the other engines' stages are held; the dense
configs' smoke loss at rtol 1e-5 and gradients at rtol 1e-4 / atol 1e-6.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as jbase
from repro.core import coding as jc
from repro.core import theory as jtheory
from repro.data import federated as jfed
from repro.data import synthetic as jsyn
from repro.fl.experiment import ScenarioConfig as JScenario
from repro.fl.experiment import build_simulator as j_build_simulator
from repro.fl.experiment.stage import train_stage as j_train_stage
from repro.models import init_params as jinit
from repro_torch.core import baselines as tbase
from repro_torch.core import coding as tc
from repro_torch.core import theory as ttheory
from repro_torch.core.tree import leaves_with_paths, tree_leaves, tree_map
from repro_torch.data import federated as tfed
from repro_torch.data import synthetic as tsyn
from repro_torch.fl.experiment import ScenarioConfig, build_simulator
from repro_torch.fl.experiment.stage import ENGINES, train_stage
from repro_torch.models import from_numpy_params
from repro_torch.stores.store import CodedStore, RoundPayload

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


# ------------------------------------------------------------------- data

@pytest.mark.parametrize("iid,partitioner,kwargs", [
    (None, None, {}), (True, None, {}), (False, None, {}),
    (None, "dirichlet", {"alpha": 0.4}), (None, "zipf", {"exponent": 0.7})])
@pytest.mark.parametrize("seed", [0, 3])
def test_client_datasets_images_identical(iid, partitioner, kwargs, seed):
    data = jsyn.make_image_data(120, image_size=8, seed=seed)
    a = jfed.client_datasets_images(data, 6, iid=iid, seed=seed,
                                    partitioner=partitioner, **kwargs)
    b = tfed.client_datasets_images(
        tsyn.ImageData(data.images, data.labels), 6, iid=iid, seed=seed,
        partitioner=partitioner, **kwargs)
    assert sorted(a) == sorted(b) == list(range(6))
    for k in a:
        for x, y in zip(a[k], b[k]):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("iid,partitioner", [(None, None), (False, None),
                                             (None, "zipf")])
def test_client_datasets_lm_identical(iid, partitioner):
    toks, labs = jsyn.lm_examples(jsyn.make_char_data(3_000, seed=2), 16)
    a = jfed.client_datasets_lm(toks, labs, 5, iid=iid, seed=2,
                                partitioner=partitioner)
    b = tfed.client_datasets_lm(toks, labs, 5, iid=iid, seed=2,
                                partitioner=partitioner)
    for k in a:
        for x, y in zip(a[k], b[k]):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("n,batch,epochs,seed", [(50, 8, 2, 0), (33, 33, 1, 4),
                                                 (10, 4, 3, 7)])
def test_batch_iterator_identical(n, batch, epochs, seed):
    data = jsyn.make_image_data(n, image_size=6, seed=seed)
    a = list(jsyn.batch_iterator(data.images, data.labels, batch, seed,
                                 epochs))
    b = list(tsyn.batch_iterator(data.images, data.labels, batch, seed,
                                 epochs))
    assert len(a) == len(b) == epochs * (n // batch)
    for (xa, ya), (xb, yb) in zip(a, b):
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)


# ------------------------------------------------------- theory, baselines

def _same(a, b):
    """Byte equality of floats, tuples and dicts of them."""
    assert type(a) is type(b), (a, b)
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, tuple):
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert np.float64(a).tobytes() == np.float64(b).tobytes(), (a, b)


@pytest.mark.parametrize("s", [1, 4, 7])
@pytest.mark.parametrize("k", [1, 3, 10])
def test_theory_time_identical(s, k):
    for fn in ("sequential_time", "concurrent_time"):
        _same(getattr(jtheory, fn)(s, k, 1.7), getattr(ttheory, fn)(s, k, 1.7))
    for conc in (False, True):
        _same(jtheory.unsharded_time(s * 5, k, 0.3, conc),
              ttheory.unsharded_time(s * 5, k, 0.3, conc))
    for fn in ("mc_sequential_time", "mc_concurrent_time"):
        _same(getattr(jtheory, fn)(s, k, 2.5, trials=500, seed=s + k),
              getattr(ttheory, fn)(s, k, 2.5, trials=500, seed=s + k))


@pytest.mark.parametrize("c,s", [(20, 4), (100, 4), (40, 20), (3, 1)])
def test_theory_storage_identical(c, s):
    _same(jtheory.coded_throughput(c, s), ttheory.coded_throughput(c, s))
    mu = 0.1 if 0.2 * c <= c - s else 0.0
    _same(jtheory.storage_efficiency_bounds(c, s, mu),
          ttheory.storage_efficiency_bounds(c, s, mu))
    for mech in ("full", "uncoded", "coded"):
        _same(jtheory.storage_bytes(206_922 * 4, c, s, 30, mech),
              ttheory.storage_bytes(206_922 * 4, c, s, 30, mech))
    for mod in (jtheory, ttheory):
        with pytest.raises(ValueError):
            mod.storage_bytes(4, c, s, 1, "tiered")
        with pytest.raises(AssertionError, match="eq. 11"):
            mod.storage_efficiency_bounds(c, s, 0.5)


def test_frameworks_identical():
    assert sorted(jbase.FRAMEWORKS) == sorted(tbase.FRAMEWORKS)
    for key, f in jbase.FRAMEWORKS.items():
        assert dataclasses.asdict(f) == dataclasses.asdict(
            tbase.FRAMEWORKS[key])


# ----------------------------------------------------------------- coding

def _slices(c, s, p, seed, bad=(), scale=10.0):
    rng = np.random.default_rng(seed)
    w = jnp.asarray(rng.standard_normal((s, p)), jnp.float32)
    out = np.array(jc.encode(jc.CodingScheme(s, c), w))
    out[list(bad)] += rng.standard_normal((len(bad), p)).astype(
        np.float32) * scale
    return out


@pytest.mark.parametrize("c,s,p", [(6, 3, 40), (8, 4, 130), (5, 5, 9)])
def test_decode_vandermonde_matches_reference(c, s, p):
    slices = _slices(c, s, p, seed=c)
    ref = jc.decode_vandermonde(jc.CodingScheme(s, c), jnp.asarray(slices))
    got = tc.decode_vandermonde(tc.CodingScheme(s, c),
                                torch.from_numpy(slices))
    assert tuple(got.shape) == (s, p) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(ref), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("bad", [[], [3], [1, 7, 12], [0, 4, 9, 13, 17]])
def test_decode_with_errors_matches_reference(bad):
    """Under eq. 11's budget (8 of 20 at S = 4): the same located rows,
    byte for byte, and the same decode."""
    slices = _slices(20, 4, 64, seed=len(bad), bad=bad)
    rw, rbad = jc.decode_with_errors(jc.CodingScheme(4, 20),
                                     jnp.asarray(slices))
    tw, tbad = tc.decode_with_errors(tc.CodingScheme(4, 20),
                                     torch.from_numpy(slices))
    assert rbad.dtype == tbad.dtype
    np.testing.assert_array_equal(tbad, rbad)
    np.testing.assert_array_equal(tbad, bad)
    np.testing.assert_allclose(_np(tw), _np(rw), **TOL)


def test_decode_with_errors_over_budget_raises_as_reference():
    slices = _slices(20, 4, 64, seed=4, bad=list(range(0, 20, 2)))
    with pytest.raises(jc.CodingBudgetExceeded) as ej:
        jc.decode_with_errors(jc.CodingScheme(4, 20), jnp.asarray(slices))
    with pytest.raises(tc.CodingBudgetExceeded) as et:
        tc.decode_with_errors(tc.CodingScheme(4, 20),
                              torch.from_numpy(slices))
    assert (ej.value.observed, ej.value.max_errors) == \
        (et.value.observed, et.value.max_errors)


def _shard_trees(seed, s=3):
    """S parameter trees of unequal sizes (the encode pads to the longest)."""
    rng = np.random.default_rng(seed)
    return [{"a": {"w": rng.standard_normal((3, 4 + i)).astype(np.float32)},
             "b": rng.standard_normal((5,)).astype(np.float32)}
            for i in range(s)]


def test_encode_and_decode_pytrees_match_reference():
    trees = _shard_trees(0)
    jsl, jspecs = jc.encode_pytrees(jc.CodingScheme(3, 9),
                                    [jax.tree.map(jnp.asarray, t)
                                     for t in trees])
    tsl, tspecs = tc.encode_pytrees(tc.CodingScheme(3, 9),
                                    [from_numpy_params(t, device="cpu") for t in trees])
    np.testing.assert_allclose(_np(tsl), _np(jsl), **TOL)
    ids = [0, 4, 8]
    jback = jc.decode_pytrees(jc.CodingScheme(3, 9), jsl[jnp.asarray(ids)],
                              ids, jspecs)
    tback = tc.decode_pytrees(tc.CodingScheme(3, 9), tsl[ids], ids, tspecs)
    for jt, tt, t in zip(jback, tback, trees):
        for (path, g), w, orig in zip(leaves_with_paths(tt),
                                      jax.tree.leaves(jt),
                                      jax.tree.leaves(t)):
            assert tuple(g.shape) == orig.shape, path
            np.testing.assert_allclose(_np(g), _np(w), **TOL)
            np.testing.assert_allclose(_np(g), orig, rtol=1e-4, atol=1e-4)


# ------------------------------------------------------ the store's tree path

def test_store_tree_path_matches_flat_path():
    """``RoundPayload.from_clients`` through ``CodedStore._put_trees``: the
    slices and every decoded shard equal the flat path's.  The shard vector
    is the concat of per-client flats either way: in sorted client order
    on the tree path (a dict's sorted keys, as in the reference), in the
    shard's order on the flat path, and ``ShardManager`` lists each
    shard's clients sorted."""
    rng = np.random.default_rng(1)
    shard_clients = {0: [1, 3], 1: [0, 5], 2: [2, 4]}
    params = {c: {"conv": {"w": torch.from_numpy(rng.standard_normal(
        (2, 3)).astype(np.float32))}, "fc": torch.from_numpy(
        rng.standard_normal((4,)).astype(np.float32))} for c in range(6)}
    scheme = tc.CodingScheme(3, 6)
    tree_store = CodedStore(scheme, shard_clients)
    tree_store.put_round(RoundPayload.from_clients(0, shard_clients, params))
    flat_store = CodedStore(scheme, shard_clients)
    flat, row_spec = {}, None
    for s, cs in shard_clients.items():
        stacked = tree_map(lambda *vs: torch.stack(vs),
                           *[params[c] for c in cs])
        flat[s], row_spec = tc.tree_to_flat_stacked(stacked)
    flat_store.put_round(RoundPayload.from_flat(0, shard_clients, flat,
                                                row_spec))
    flat_store.flush()
    assert torch.equal(tree_store._slices[0], flat_store._slices[0])
    assert tree_store.stats.to_dict() == flat_store.stats.to_dict()
    for s, cs in shard_clients.items():
        got, want = tree_store.get_shard(0, s), flat_store.get_shard(0, s)
        assert sorted(got) == sorted(want) == sorted(cs)
        for c in cs:
            for g, w in zip(tree_leaves(got[c]), tree_leaves(want[c])):
                assert torch.equal(g, w)
            for g, w in zip(tree_leaves(got[c]), tree_leaves(params[c])):
                torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
    assert tree_store.clients_at(0) == list(range(6))


def test_uncoded_stores_take_client_payloads():
    from repro_torch.stores.store import make_store
    shard_clients = {0: [0, 1], 1: [2, 3]}
    params = {c: {"w": torch.full((3,), float(c))} for c in range(4)}
    for kind in ("full", "uncoded"):
        store = make_store(kind, shard_clients)
        store.put_round(RoundPayload.from_clients(0, shard_clients, params))
        assert store.stats.comm_bytes_store == 4 * 12
        assert torch.equal(store.get_shard(0, 1)[3]["w"], params[3]["w"])
    with pytest.raises(ValueError, match="exactly one"):
        RoundPayload(0, shard_clients)


# ------------------------------------------- deprecated spellings and shims

@pytest.mark.parametrize("kw", [dict(task="image"), dict(task="lm"),
                                dict(iid=True), dict(iid=False),
                                dict(task="lm", iid=False)])
def test_deprecated_spellings_warn_as_reference(kw):
    with pytest.warns(DeprecationWarning) as jrec:
        jcfg = JScenario(**kw)
    with pytest.warns(DeprecationWarning) as trec:
        tcfg = ScenarioConfig(**kw)
    assert [str(w.message) for w in trec] == [str(w.message) for w in jrec]
    assert (tcfg.task, tcfg.model, tcfg.partitioner, tcfg.iid) == \
        (jcfg.task, jcfg.model, jcfg.partitioner, jcfg.iid)


def test_iid_and_partitioner_conflict():
    with pytest.warns(DeprecationWarning):
        with pytest.raises(ValueError, match="not both"):
            ScenarioConfig(iid=True, partitioner="zipf")


def test_checkpoint_alias_is_the_stores_package():
    import importlib
    import sys
    sys.modules.pop("repro_torch.checkpoint", None)
    with pytest.warns(DeprecationWarning, match="import repro_torch.stores"):
        alias = importlib.import_module("repro_torch.checkpoint")
    from repro_torch import stores
    from repro_torch.checkpoint import store as alias_store
    for name in ("CodedStore", "FullStore", "RoundPayload", "STORES",
                 "StoreStats", "make_store", "register_store"):
        assert getattr(alias, name) is getattr(stores, name)
    assert alias_store.CodedStore is stores.CodedStore


# ---------------------------------------------------------- legacy engine

SMALL = dict(task="classification", num_clients=8, clients_per_round=4,
             num_shards=2, local_epochs=2, global_rounds=2,
             samples_per_client=20, image_size=8, local_batch=10)


@pytest.fixture(scope="module")
def legacy_runs():
    """One legacy-engine stage in each package, the port fed the
    reference's initial weights through ``init_fn``."""
    jsim, _ = j_build_simulator(JScenario(**SMALL))
    jrec = j_train_stage(jsim, store_kind="coded", engine="legacy")
    w0 = jax.tree.map(np.asarray, jinit(jsim.cfg, jax.random.key(
        jsim.seed + jrec.plan.stage)))
    sim, _ = build_simulator(ScenarioConfig(**SMALL), device="cpu",
                             init_fn=lambda salt: from_numpy_params(w0, device="cpu"))
    return jrec, train_stage(sim, store_kind="coded", engine="legacy"), w0


def test_legacy_engine_matches_reference(legacy_runs):
    jrec, trec, w0 = legacy_runs
    assert "legacy" in ENGINES
    assert trec.plan.shard_clients == jrec.plan.shard_clients
    for s in jrec.shard_models:
        for (path, g), w in zip(leaves_with_paths(trec.shard_models[s]),
                                jax.tree.leaves(jrec.shard_models[s])):
            np.testing.assert_allclose(_np(g), _np(w), rtol=1e-4, atol=1e-4,
                                       err_msg="/".join(path))
        assert len(trec.round_globals[s]) == len(jrec.round_globals[s]) == 3
        for g, w in zip(tree_leaves(trec.round_globals[s][0]),
                        jax.tree.leaves(w0)):
            np.testing.assert_array_equal(_np(g), w)
    keys = sorted(jrec.history_norms)
    assert sorted(trec.history_norms) == keys
    np.testing.assert_allclose([trec.history_norms[k] for k in keys],
                               [jrec.history_norms[k] for k in keys],
                               rtol=1e-4, atol=1e-4)
    for g in range(SMALL["global_rounds"]):
        np.testing.assert_allclose(_np(trec.store._slices[g]),
                                   _np(jrec.store._slices[g]), rtol=1e-4,
                                   atol=1e-4)
    assert trec.store.stats.to_dict() == jrec.store.stats.to_dict()


def test_legacy_engine_serves_se_and_agrees_with_fused(legacy_runs):
    """The legacy store decodes per-client trees for SE, and the legacy
    stage ends where the fused engine's does."""
    from repro_torch.fl.experiment import run_unlearn
    _, trec, w0 = legacy_runs
    sim, _ = build_simulator(ScenarioConfig(**SMALL), device="cpu",
                             init_fn=lambda salt: from_numpy_params(w0, device="cpu"))
    frec = train_stage(sim, store_kind="coded", engine="fused")
    for s in frec.shard_models:
        for g, w in zip(tree_leaves(trec.shard_models[s]),
                        tree_leaves(frec.shard_models[s])):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
    victim = trec.plan.shard_clients[0][0]
    res = run_unlearn(sim, "SE", trec, [victim])
    assert res.impacted_shards == [0]
    for g, w in zip(tree_leaves(res.models[1]),
                    tree_leaves(trec.shard_models[1])):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="encode_group"):
        train_stage(sim, engine="legacy", encode_group=2)


def test_simulator_shims_warn_and_delegate():
    sim, _ = build_simulator(ScenarioConfig(**SMALL), device="cpu")
    with pytest.warns(DeprecationWarning,
                      match="FLSimulator.train_stage is deprecated"):
        rec = sim.train_stage(engine="legacy", rounds=1)
    assert len(rec.round_globals[0]) == 2
    with pytest.warns(DeprecationWarning,
                      match="FLSimulator.unlearn is deprecated"):
        res = sim.unlearn("SE", rec, [rec.plan.shard_clients[1][0]])
    assert res.framework == "SE" and res.impacted_shards == [1]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        ScenarioConfig(engine="legacy")


# ---------------------------------------------------------- dense configs

@pytest.mark.parametrize("arch", ["llama3.2-3b", "olmo-1b", "yi-6b",
                                  "cnn-paper-cifar"])
def test_dense_configs_match_reference(arch):
    from repro.configs import get_config as jget
    from repro.configs.cnn_paper import CONFIG_CIFAR as J_CIFAR
    from repro_torch.configs import ModelConfig, get_config
    from repro_torch.configs.cnn_paper import CONFIG_CIFAR
    jcfg, tcfg = ((J_CIFAR, CONFIG_CIFAR) if arch == "cnn-paper-cifar"
                  else (jget(arch), get_config(arch)))
    for f in dataclasses.fields(ModelConfig):
        assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    assert tcfg.layer_kinds == jcfg.layer_kinds


@pytest.mark.parametrize("arch", ["llama3.2-3b", "olmo-1b", "yi-6b"])
def test_dense_smoke_loss_and_grads_match_reference(arch):
    """``reduce_for_smoke`` of each dense config (rmsnorm or OLMo's
    nonparametric norm, tied or separate embeddings, its RoPE theta):
    loss at rtol 1e-5 and gradients at rtol 1e-4 / atol 1e-6."""
    from repro.configs import get_config as jget
    from repro.configs import reduce_for_smoke as j_reduce
    from repro.models import loss_fn as jloss
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.models import loss_fn
    jcfg = j_reduce(jget(arch))
    cfg = reduce_for_smoke(get_config(arch))
    jp = jax.jit(lambda key: jinit(jcfg, key))(jax.random.key(2))
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    labs = rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jloss(jcfg)(p, b), has_aux=True))(
        jp, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labs)})
    tp = tree_map(lambda v: v.requires_grad_(True), from_numpy_params(
        jax.tree.map(np.asarray, jp), device="cpu"))
    tl, _ = loss_fn(cfg)(tp, {"tokens": torch.from_numpy(toks),
                              "labels": torch.from_numpy(labs)})
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    grads = torch.autograd.grad(tl, tree_leaves(tp))
    for (path, _), g, w in zip(leaves_with_paths(tp), grads,
                               jax.tree.leaves(jg)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-6, err_msg="/".join(path))
