"""The port's WKV recurrence, rwkv6 model and rwkv6 family against the
reference on the CPU (the kernels' plain versions; the CUDA kernels are
held to the same plain versions on the card by ``chip_smoke.py``).

Tolerances: the recurrence against the reference's oracle and its
interpret-mode Pallas kernel at |d| <= 5e-4 + 5e-4|r| (tests/
test_kernels.py's tolerance for this kernel); gradients of all six inputs
against ``jax.vjp`` of the reference's multi-head oracle at rtol 1e-4 /
atol 1e-5, by autograd through the plain loop and by the backward kernel's
two-sweep algorithm (``wkv_bwd_sweeps_ref``); the forward kernel's order
of y's row sum (``wkv_fwd_rowgroup_ref``) at 5e-4 with three decay
regimes; ``time_mix``, ``channel_mix`` and one rwkv layer at 2e-4
against the reference's kernel path (``rwkv_impl="pallas"``) and 1e-3
against its chunk-parallel ``wkv_scan`` (``"chunked"``), as tests/
test_kernels.py holds the two reference forms to each other; the family's
loss at rtol 1e-5 and each gradient leaf at rtol 1e-4 / atol 5e-5 of the
leaf's largest entry (measured: 3.1e-5 abs on ``embed/table``, whose
entries reach 2.66, i.e. 1.2e-5 of it; fp32 sums in another order through
the recurrence); on the federated path StoreStats, cost units and SE
isolation are exact and the models are held to the reference's own spread
(see the section's note).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs import reduce_for_smoke
from repro.fl.experiment import RequestSchedule as JSchedule
from repro.fl.experiment import ScenarioConfig as JScenario
from repro.fl.experiment import UnlearnRequest as JRequest
from repro.fl.experiment import build_session as j_build_session
from repro.fl.families import RWKV6Family as JRWKV6Family
from repro.fl.families import get_model_family as jfamily
from repro.kernels.wkv.ops import _wkv_ref_mh as j_wkv_ref_mh
from repro.kernels.wkv.ops import wkv as j_wkv
from repro.kernels.wkv.ref import wkv_ref as j_wkv_ref
from repro.models import init_params as jinit
from repro.models import loss_fn as jloss
from repro.models import rwkv6 as jrw
from repro.models import transformer as jtfm
from repro.models.params import RealInit as JRealInit
from repro_torch.configs import ModelConfig, get_config
from repro_torch.core.tree import leaves_with_paths, tree_leaves, tree_map
from repro_torch.fl.experiment import (RequestSchedule, ScenarioConfig,
                                       UnlearnRequest, build_session,
                                       run_scenario)
from repro_torch.fl.families import get_model_family
from repro_torch.kernels.wkv import ops
from repro_torch.kernels.wkv.ops import wkv
from repro_torch.kernels.wkv.ref import (wkv_bwd_sweeps_ref,
                                         wkv_fwd_rowgroup_ref)
from repro_torch.models import from_numpy_params, init_params, loss_fn
from repro_torch.models import rwkv6 as rw
from repro_torch.models.transformer import apply_block_train, forward_train

torch.set_num_threads(1)
WKV_TOL = dict(rtol=5e-4, atol=5e-4)


def _inputs(b, s, h, n, seed=0, groups=0):
    """tests/test_kernels.py's inputs; ``groups`` > 0 draws (G, H, N) u."""
    rng = np.random.default_rng(seed)
    r = rng.standard_normal((b, s, h, n))
    k = rng.standard_normal((b, s, h, n)) * 0.3
    v = rng.standard_normal((b, s, h, n))
    lw = -np.abs(rng.standard_normal((b, s, h, n))) - 0.05
    u = rng.standard_normal((groups, h, n) if groups else (h, n)) * 0.5
    h0 = rng.standard_normal((b, h, n, n)) * 0.1
    return [np.asarray(a, np.float32) for a in (r, k, v, lw, u, h0)]


def _torch(args, grad=False):
    return [torch.from_numpy(a.copy()).requires_grad_(grad) for a in args]


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **tol)


# ------------------------------------------------------------ the kernel

@pytest.mark.parametrize("b,s,h,n", [(1, 32, 2, 16), (2, 48, 1, 64)])
def test_wkv_matches_reference_oracle_and_kernel(b, s, h, n):
    args = _inputs(b, s, h, n)
    y, hl = wkv(*_torch(args))
    jargs = [jnp.asarray(a) for a in args]
    for hi in range(h):                 # the single-head oracle, per head
        yr, hr = j_wkv_ref(*[a[:, :, hi] for a in jargs[:4]], jargs[4][hi],
                           jargs[5][:, hi])
        _close(y[:, :, hi], yr, **WKV_TOL)
        _close(hl[:, hi], hr, **WKV_TOL)
    yk, hk = j_wkv(*jargs, chunk=16)    # the Pallas kernel, interpret mode
    _close(y, yk, **WKV_TOL)
    _close(hl, hk, **WKV_TOL)


@pytest.mark.parametrize("b,s,h,n,seed", [(1, 1, 1, 1, 1), (3, 7, 2, 5, 2),
                                          (2, 33, 3, 17, 3),
                                          (1, 20, 1, 64, 4),
                                          (2, 9, 2, 33, 5)])
def test_wkv_ragged_sweep(b, s, h, n, seed):
    args = _inputs(b, s, h, n, seed=seed)
    y, hl = wkv(*_torch(args))
    yr, hr = j_wkv_ref_mh(*[jnp.asarray(a) for a in args])
    _close(y, yr, **WKV_TOL)
    _close(hl, hr, **WKV_TOL)


def test_grouped_u_matches_single_group_calls():
    """Sequence b of a (G, H, N) call uses u[b // (B // G)]: the same
    numbers, forward and backward, as one call per group."""
    g, per = 3, 2
    args = _inputs(g * per, 12, 2, 8, seed=7, groups=g)
    t = _torch(args, grad=True)
    y, hl = wkv(*t)
    gy = torch.from_numpy(np.random.default_rng(8).standard_normal(
        y.shape).astype(np.float32))
    grads = torch.autograd.grad((y * gy).sum() + hl.sum(), t)
    for i in range(g):
        rows = slice(i * per, (i + 1) * per)
        one = [v.detach()[rows].clone().requires_grad_(True)
               for v in (t[0], t[1], t[2], t[3])]
        u_i = t[4].detach()[i].clone().requires_grad_(True)
        h0_i = t[5].detach()[rows].clone().requires_grad_(True)
        yi, hi = wkv(*one, u_i, h0_i)
        torch.testing.assert_close(yi, y[rows], rtol=0, atol=0)
        torch.testing.assert_close(hi, hl[rows], rtol=0, atol=0)
        gi = torch.autograd.grad((yi * gy[rows]).sum() + hi.sum(),
                                 [*one, u_i, h0_i])
        for want, got in zip([v[rows] for v in grads[:4]], gi[:4]):
            torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)
        torch.testing.assert_close(gi[4], grads[4][i], rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(gi[5], grads[5][rows], rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("b,s,h,n", [(2, 24, 2, 16), (3, 17, 1, 9)])
def test_wkv_gradients_match_reference_vjp(b, s, h, n):
    args = _inputs(b, s, h, n, seed=11)
    rng = np.random.default_rng(12)
    gy = rng.standard_normal((b, s, h, n)).astype(np.float32)
    gh = rng.standard_normal((b, h, n, n)).astype(np.float32)
    _, vjp = jax.vjp(j_wkv_ref_mh, *[jnp.asarray(a) for a in args])
    want = vjp((jnp.asarray(gy), jnp.asarray(gh)))
    t = _torch(args, grad=True)
    y, hl = wkv(*t)
    got = torch.autograd.grad(
        (y * torch.from_numpy(gy)).sum() + (hl * torch.from_numpy(gh)).sum(),
        t)
    for name, g, w in zip(("r", "k", "v", "lw", "u", "h0"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("decay", ["model", "near1", "clip"])
@pytest.mark.parametrize("b,s,h,n,chunk", [(2, 24, 2, 16, 8), (3, 17, 1, 9, 8),
                                           (1, 70, 1, 8, 64)])
def test_wkv_bwd_sweeps_match_reference_vjp(b, s, h, n, chunk, decay):
    """The backward kernel's two-sweep algorithm (chunk-parallel dr' and a,
    the reverse dlw sum) as a float32 loop, against ``jax.vjp`` of the
    reference's oracle: the model's decays, decays within 1e-2 of 1, and
    the clip's w = exp(-exp(3)) = 1.9e-9 everywhere."""
    args = _inputs(b, s, h, n, seed=13)
    z = np.random.default_rng(14).standard_normal((b, s, h, n))
    args[3] = np.asarray({"model": -np.exp(np.clip(z - 0.5, -10.0, 3.0)),
                          "near1": -np.exp(z - 6.5),
                          "clip": np.full_like(z, -np.exp(3.0))}[decay],
                         np.float32)
    rng = np.random.default_rng(15)
    gy = rng.standard_normal((b, s, h, n)).astype(np.float32)
    gh = rng.standard_normal((b, h, n, n)).astype(np.float32)
    _, vjp = jax.vjp(j_wkv_ref_mh, *[jnp.asarray(a) for a in args])
    want = vjp((jnp.asarray(gy), jnp.asarray(gh)))
    got = wkv_bwd_sweeps_ref(*_torch(args), torch.from_numpy(gy),
                             torch.from_numpy(gh), chunk=chunk)
    for name, g, w in zip(("r", "k", "v", "lw", "u", "h0"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("decay", ["model", "near1", "clip"])
@pytest.mark.parametrize("b,s,h,n", [(2, 24, 2, 16), (3, 17, 1, 9),
                                     (1, 30, 2, 40)])
def test_wkv_fwd_rowgroup_order_matches_reference(b, s, h, n, decay):
    """The forward kernel's order of y's row sum (4-row groups, the u term
    folded in per group, the groups summed by halving) as a float32 loop,
    against the reference's multi-head oracle at the kernel's tolerance:
    the model's decays, decays within 1e-2 of 1, and the clip's w =
    exp(-exp(3)) = 1.9e-9 everywhere."""
    args = _inputs(b, s, h, n, seed=16)
    z = np.random.default_rng(17).standard_normal((b, s, h, n))
    args[3] = np.asarray({"model": -np.exp(np.clip(z - 0.5, -10.0, 3.0)),
                          "near1": -np.exp(z - 6.5),
                          "clip": np.full_like(z, -np.exp(3.0))}[decay],
                         np.float32)
    y, hl = wkv_fwd_rowgroup_ref(*_torch(args))
    yr, hr = j_wkv_ref_mh(*[jnp.asarray(a) for a in args])
    _close(y, yr, **WKV_TOL)
    _close(hl, hr, **WKV_TOL)


def test_wrapper_checks_shapes_and_dtypes():
    args = _torch(_inputs(2, 8, 3, 4, groups=2))
    assert ops._check(*args) == 2
    r, k, v, lw, u, h0 = args
    with pytest.raises(ValueError, match="N=65"):
        wide = torch.zeros(2, 8, 3, 65)
        ops._check(wide, wide, wide, wide, torch.zeros(3, 65),
                   torch.zeros(2, 3, 65, 65))
    with pytest.raises(ValueError, match="groups"):
        ops._check(r, k, v, lw, torch.zeros(3, 3, 4), h0)
    with pytest.raises(ValueError, match=r"\(B, S, H, N\)"):
        ops._check(r, k[:, :7], v, lw, u, h0)
    with pytest.raises(ValueError, match="h0"):
        ops._check(r, k, v, lw, u, h0[:, :, :3])
    with pytest.raises(TypeError, match="float32"):
        ops._check(r.double(), k, v, lw, u, h0)
    with pytest.raises(ValueError, match="contiguous"):
        ops._check(r, k, v, lw.transpose(2, 3).contiguous().transpose(2, 3),
                   u, h0)


# ------------------------------------------------------------- the model

def _port_cfg(jcfg):
    return ModelConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(ModelConfig)})


def _smoke(impl):
    return dataclasses.replace(reduce_for_smoke(jget("rwkv6-3b")),
                               rwkv_impl=impl, param_dtype="float32",
                               compute_dtype="float32")


_IMPL_TOL = {"pallas": dict(rtol=2e-4, atol=2e-4),
             "chunked": dict(rtol=1e-3, atol=1e-3)}


@pytest.fixture(scope="module")
def layer_case():
    """One rwkv block's reference weights (d_model 256, 4 heads of 64,
    d_ff 512) and an input (2, 40, 256)."""
    jcfg = _smoke("pallas")
    jp = jtfm._init_block(JRealInit(jax.random.key(0), jnp.float32), jcfg,
                          "rwkv", 0)
    x = jax.random.normal(jax.random.key(2), (2, 40, jcfg.d_model),
                          jnp.float32)
    tp = tree_map(lambda v: v.unsqueeze(0),
                  from_numpy_params(jax.tree.map(np.asarray, jp), device="cpu"))
    return jp, tp, x, torch.from_numpy(np.array(x))[None]


@pytest.mark.parametrize("impl", ["pallas", "chunked"])
def test_time_mix_matches_reference(layer_case, impl):
    jp, tp, x, tx = layer_case
    jcfg = _smoke(impl)
    hh, nn = jrw.rwkv_heads(jcfg)
    rng = np.random.default_rng(3)
    prev = rng.standard_normal((2, jcfg.d_model)).astype(np.float32)
    h0 = (rng.standard_normal((2, hh, nn, nn)) * 0.1).astype(np.float32)
    jy, (jprev, jh) = jrw.time_mix(jp["rwkv"], x, jcfg,
                                   (jnp.asarray(prev), jnp.asarray(h0)))
    ty, (tprev, th) = rw.time_mix(tp["rwkv"], tx, _port_cfg(jcfg),
                                  (torch.from_numpy(prev)[None],
                                   torch.from_numpy(h0)[None]))
    _close(ty[0], jy, **_IMPL_TOL[impl])
    _close(th[0], jh, **_IMPL_TOL[impl])
    assert torch.equal(tprev[0], torch.from_numpy(np.array(jprev)))


def test_channel_mix_matches_reference(layer_case):
    jp, tp, x, tx = layer_case
    jcfg = _smoke("pallas")
    prev = np.random.default_rng(4).standard_normal(
        (2, jcfg.d_model)).astype(np.float32)
    jy, _ = jrw.channel_mix(jp["rwkv"], x, jcfg, jnp.asarray(prev))
    ty, tprev = rw.channel_mix(tp["rwkv"], tx, _port_cfg(jcfg),
                               torch.from_numpy(prev)[None])
    _close(ty[0], jy, rtol=1e-5, atol=1e-5)
    assert torch.equal(tprev, tx[..., -1, :])


@pytest.mark.parametrize("impl", ["pallas", "chunked"])
def test_rwkv_layer_matches_reference(layer_case, impl):
    jp, tp, x, tx = layer_case
    jcfg = _smoke(impl)
    jy, aux, _ = jtfm.apply_block_train(jp, x, jcfg, "rwkv", 0,
                                        jtfm.NULL_CTX)
    ty, taux, _ = apply_block_train(tp, tx, _port_cfg(jcfg), "rwkv", 0)
    _close(ty[0], jy, **_IMPL_TOL[impl])
    assert float(taux) == float(aux) == 0.0


@pytest.fixture(scope="module")
def family_weights():
    jcfg = jfamily("rwkv6").build(None)
    jp = jax.jit(lambda key: jinit(jcfg, key))(jax.random.key(0))
    return jcfg, jp, from_numpy_params(jax.tree.map(np.asarray, jp), device="cpu")


def test_family_tree_matches_reference(family_weights):
    jcfg, jp, _ = family_weights
    fam = get_model_family("rwkv6")
    tp = init_params(fam.build(None), 3, device="cpu")
    jleaves = jax.tree_util.tree_leaves_with_path(jp)
    tleaves = list(leaves_with_paths(tp))
    assert len(tleaves) == len(jleaves)
    assert sum(v.numel() for v in tree_leaves(tp)) == 62_304
    for (jpath, jv), (tpath, tv) in zip(jleaves, tleaves):
        assert tuple(k.key for k in jpath) == tpath
        assert tuple(jv.shape) == tuple(tv.shape)
    assert tp["rem"] == {}
    assert fam.kernel_ops == ("wkv",) and fam.default_lr == 0.1
    assert type(get_model_family("rwkv")) is type(fam)
    assert _port_cfg(jcfg) == fam.build(None)
    # the draws follow the reference's init rules
    p = tp["stack"]["p0"]["rwkv"]
    assert bool((p["w_base"] == 0.5).all())
    assert 0.0 <= float(p["mu"].min()) and float(p["mu"].max()) < 1.0
    assert 0.0 <= float(p["u"].min()) and float(p["u"].max()) < 0.5
    assert bool((p["ln_x_scale"] == 1).all()) and not p["ln_x_bias"].any()


def test_family_loss_and_grads_match_reference(family_weights):
    jcfg, jp, tp = family_weights
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 109, (4, 16)).astype(np.int32)
    labs = rng.integers(0, 109, (4, 16)).astype(np.int32)
    labs[0, :3] = -100                                  # ignored labels
    jl, jg = jax.jit(jax.value_and_grad(lambda p, b: jloss(jcfg)(p, b)[0]))(
        jp, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labs)})
    tp = tree_map(lambda v: v.clone().requires_grad_(True), tp)
    tl, mets = loss_fn(get_model_family("rwkv6").build(None))(
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


def test_stacked_forward_is_per_model(family_weights):
    """A stack of two models over two batches gives each model's logits."""
    _, _, tp = family_weights
    cfg = get_model_family("rwkv6").build(None)
    other = tree_map(lambda v: v * 0.9, tp)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, 109, (2, 3, 12)).astype(np.int32))
    both = tree_map(lambda a, b: torch.stack([a, b]), tp, other)
    logits, _ = forward_train(both, cfg, {"tokens": toks})
    for k, p in enumerate((tp, other)):
        one, _ = forward_train(tree_map(lambda v: v[None], p), cfg,
                               {"tokens": toks[k:k + 1]})
        torch.testing.assert_close(logits[k], one[0], rtol=1e-5, atol=1e-5)
    assert bool((logits[..., 109:] == -1e9).all())


def test_config_matches_reference():
    """``rwkv6-3b``: the same values as the reference's, field by field,
    and 85,557,760 parameters in one rwkv layer."""
    jcfg, tcfg = jget("rwkv6-3b"), get_config("rwkv6-3b")
    for f in dataclasses.fields(ModelConfig):
        assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    assert tcfg.layer_kinds == jcfg.layer_kinds
    assert rw.rwkv_heads(tcfg) == (40, 64)
    shapes = rw.init_rwkv(_ShapeOnly(), tcfg)
    norms = 2 * tcfg.d_model                            # ln1, ln2
    assert sum(int(np.prod(s)) for s in shapes.values()) + norms \
        == 85_557_760


class _ShapeOnly:
    """A parameter factory that returns each leaf's shape."""

    def param(self, shape, init="normal", scale=1.0, in_dims=1,
              fan_in=None):
        return tuple(shape)


# ------------------------------------------------------ the federated path
#
# One stage of this scenario (six SGD steps per client at lr 0.1) amplifies
# fp32 rounding about a thousandfold: the reference's own two WKV forms
# (its kernel path and its chunk-parallel ``wkv_scan``) end the stage
# 3.5e-3 apart on the shard and SE models, 7.6e-3 on the coded slices and
# 5.9e-3 on the update norms (measured), and the port's gaps to the
# reference are of the same size.  So the port is held to the reference by
# that yardstick: in each category its largest gap to the reference must
# stay within SPREAD_FACTOR times the reference's spread between its two
# forms (measured ratios on both engines: 0.85 models, 0.94 slices, 1.17
# norms).  StoreStats, cost units, client draws and SE isolation are
# exact.

ZOO = dict(task="generation", model="rwkv6", partitioner="zipf",
           partitioner_kwargs={"exponent": 0.5}, store="coded", num_clients=8,
           clients_per_round=4, num_shards=2, local_epochs=1, global_rounds=2,
           samples_per_client=6, seq_len=16, test_n=20, local_batch=2,
           num_stages=1)
SPREAD_FACTOR = 2.0


def _first_of_shard0(plan):
    return [plan.shard_clients[0][0]]


def _gap(got, want) -> float:
    """Largest absolute difference between two trees (sorted-key leaves,
    CPU tensors or arrays) or two arrays."""
    return max(float(np.abs(np.asarray(g, np.float32)
                            - np.asarray(w, np.float32)).max())
               for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)))


def _categories(rec, rep):
    """The compared quantities of a run, by category."""
    return {"models": list(rec.shard_models.values())
            + [rep.stages[0].unlearn[0].models[0]],
            "slices": [rec.store._slices[g]
                       for g in range(ZOO["global_rounds"])],
            "norms": [np.asarray([rec.history_norms[k] for k in
                                  sorted(rec.history_norms)], np.float64)]}


def _gaps(a, b):
    return {c: max(_gap(x, y) for x, y in zip(a[c], b[c])) for c in a}


@pytest.fixture(scope="module")
def jax_run():
    """The reference's session (one stage, one SE request on shard 0) with
    the family's kernel form, and the spread of each category against the
    same run with its chunk-parallel form."""
    runs = {}
    for impl in ("chunked", "pallas"):
        build = JRWKV6Family.build
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(JRWKV6Family, "build",
                       lambda self, cfg, _b=build, _i=impl:
                       dataclasses.replace(_b(self, cfg), rwkv_impl=_i))
            cfg = JScenario(schedule=JSchedule([JRequest(
                _first_of_shard0, framework="SE", rounds=1)]), **ZOO)
            session, _ = j_build_session(cfg)
            runs[impl] = session, session.run(cfg.num_stages,
                                              schedule=cfg.schedule)
    session, report = runs["pallas"]
    spread = _gaps(_categories(session.records[0], report),
                   _categories(runs["chunked"][0].records[0],
                               runs["chunked"][1]))
    return session, report, spread


def _port_session(jax_run, engine):
    cfg = ScenarioConfig(schedule=RequestSchedule([UnlearnRequest(
        _first_of_shard0, framework="SE", rounds=1)]), engine=engine, **ZOO)
    w0 = jax.tree.map(np.asarray, jax_run[0].records[0].round_globals[0][0])
    session, _ = build_session(cfg, device="cpu",
                               init_fn=lambda salt: from_numpy_params(w0, device="cpu"))
    return cfg, session


@pytest.fixture(scope="module")
def port_runs(jax_run):
    out = {}
    for engine in ("fused", "stage"):
        cfg, session = _port_session(jax_run, engine)
        out[engine] = session, session.run(cfg.num_stages,
                                           schedule=cfg.schedule)
    return out


@pytest.mark.parametrize("engine", ["fused", "stage"])
def test_run_scenario_matches_reference(jax_run, engine):
    jrep = jax_run[1]
    cfg, _ = _port_session(jax_run, engine)
    w0 = jax.tree.map(np.asarray, jax_run[0].records[0].round_globals[0][0])
    trep = run_scenario(cfg, device="cpu",
                        init_fn=lambda salt: from_numpy_params(w0, device="cpu"))
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
    jsession, jrep, spread = jax_run
    tsession, trep = port_runs[engine]
    jrec, trec = jsession.records[0], tsession.records[0]
    assert sorted(trec.history_norms) == sorted(jrec.history_norms)
    gaps = _gaps(_categories(trec, trep), _categories(jrec, jrep))
    for cat, gap in gaps.items():
        assert 0 < spread[cat] < 1e-2, (cat, spread[cat])
        assert gap <= SPREAD_FACTOR * spread[cat], (cat, gap, spread[cat])
    tres = trep.stages[0].unlearn[0]
    assert tres.impacted_shards == jrep.stages[0].unlearn[0].impacted_shards
    # the untouched shard is the trained model, bit for bit
    trained = trec.shard_models[1]
    for g, w in zip(tree_leaves(tres.models[1]), tree_leaves(trained)):
        assert torch.equal(g, w)
    assert tres.models[0]["rem"] == {} == tres.models[1]["rem"]


@pytest.mark.parametrize("b,s,h,n", [(1, 32, 2, 16), (2, 20, 1, 27)])
def test_wkv_bf16_inputs_match_reference_kernel(b, s, h, n):
    """bf16 r, k, v, lw (u and h0 fp32), as the TPU kernel takes them:
    against that kernel in interpret mode on the same bf16 operands at the
    fp32 tolerance (both widen each load; y and h_last fp32); the result
    equals the fp32 call on the widened operands bit for bit, and the
    gradients come back bf16."""
    args = _inputs(b, s, h, n, seed=12)
    t = _torch(args)
    t[:4] = [v.bfloat16() for v in t[:4]]
    y, hl = wkv(*t)
    assert y.dtype == hl.dtype == torch.float32
    jargs = [jnp.asarray(v.float().numpy()) for v in t]
    jargs[:4] = [a.astype(jnp.bfloat16) for a in jargs[:4]]
    yr, hr = j_wkv(*jargs)
    _close(y, yr, **WKV_TOL)
    _close(hl, hr, **WKV_TOL)
    yw, hw = wkv(*[v.float() for v in t])
    assert torch.equal(y, yw) and torch.equal(hl, hw)
    leaves = [v.clone().requires_grad_(True) for v in t]
    grads = torch.autograd.grad(wkv(*leaves)[0].sum(), leaves)
    assert [g.dtype for g in grads] == [v.dtype for v in t]
