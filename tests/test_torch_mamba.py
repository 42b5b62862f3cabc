"""The port's selective-SSM scan and mamba model against the reference on
the CPU (the kernels' plain versions; the CUDA kernels are held to the same
plain versions on the card by ``chip_smoke.py``).

Tolerances: the scan against the reference's oracle and its interpret-mode
Pallas kernel at 2e-4 on the fixed shapes of tests/test_kernels.py and 5e-4
on a ragged sweep; gradients against ``jax.vjp(ssm_scan_ref)`` at rtol 1e-4 /
atol 1e-5 (measured: 1.1e-5 abs at most, on gradients of magnitude up to
82); the forward kernel's sub-chunk algorithm (``ssm_scan_subchunk_ref``)
against the reference's oracle at 2e-4 with the model's, tiny and large dt;
``mamba_block`` at 2e-3 as tests/test_perf_variants.py; the
family's loss at rtol 1e-5 and its gradients at rtol 1e-4 / atol 1e-6
(measured: 1.5e-6 abs at most)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs import reduce_for_smoke
from repro.fl.families import get_model_family as jfamily
from repro.kernels.ssm_scan.ops import ssm_scan as j_ssm_scan
from repro.kernels.ssm_scan.ref import ssm_scan_ref as j_ssm_scan_ref
from repro.models import init_params as jinit
from repro.models import loss_fn as jloss
from repro.models.mamba import init_mamba as j_init_mamba
from repro.models.mamba import mamba_block as j_mamba_block
from repro.models.params import RealInit as JRealInit
from repro_torch.configs import ModelConfig
from repro_torch.core.tree import leaves_with_paths, tree_leaves, tree_map
from repro_torch.fl.families import get_model_family
from repro_torch.kernels.ssm_scan import ops
from repro_torch.kernels.ssm_scan.ops import ssm_scan
from repro_torch.kernels.ssm_scan.ref import (ssm_abar, ssm_advance,
                                              ssm_scan_subchunk_ref)
from repro_torch.models import from_numpy_params, init_params, loss_fn
from repro_torch.models.mamba import mamba_block
from repro_torch.models.transformer import forward_train

torch.set_num_threads(1)


def _inputs(bsz, s, d, n, seed=0, groups=0):
    """tests/test_kernels.py's inputs; ``groups`` > 0 draws (G, D, n) a."""
    rng = np.random.default_rng(seed)
    dt = (np.abs(rng.standard_normal((bsz, s, d))) * 0.1 + 0.01)
    b = rng.standard_normal((bsz, s, n))
    c = rng.standard_normal((bsz, s, n))
    x = rng.standard_normal((bsz, s, d))
    a_shape = (groups, d, n) if groups else (d, n)
    a = -np.abs(rng.standard_normal(a_shape)) - 0.1
    h0 = rng.standard_normal((bsz, d, n)) * 0.1
    return [np.asarray(v, np.float32) for v in (dt, b, c, x, a, h0)]


def _torch(args, grad=False):
    return [torch.from_numpy(a.copy()).requires_grad_(grad) for a in args]


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("bsz,s,d,n", [(1, 32, 128, 16), (2, 64, 256, 16),
                                       (1, 48, 200, 8)])
def test_scan_matches_reference_oracle_and_kernel(bsz, s, d, n):
    args = _inputs(bsz, s, d, n)
    y, h = ssm_scan(*_torch(args))
    jargs = [jnp.asarray(a) for a in args]
    for yr, hr in (j_ssm_scan_ref(*jargs),
                   j_ssm_scan(*jargs, chunk=16, blk_d=128)):
        _close(y, yr, 2e-4)
        _close(h, hr, 2e-4)


@pytest.mark.parametrize("bsz,s,d,n,seed", [(1, 1, 1, 1, 1), (3, 7, 5, 3, 2),
                                            (2, 33, 17, 16, 3),
                                            (4, 9, 130, 8, 4),
                                            (1, 70, 3, 11, 5)])
def test_scan_ragged_sweep(bsz, s, d, n, seed):
    args = _inputs(bsz, s, d, n, seed=seed)
    y, h = ssm_scan(*_torch(args))
    yr, hr = j_ssm_scan_ref(*[jnp.asarray(a) for a in args])
    _close(y, yr, 5e-4)
    _close(h, hr, 5e-4)


def test_grouped_a_matches_single_group_calls():
    """Sequence i of a (G, D, n) call uses a[i // (B // G)]: the same
    numbers, forward and backward, as one call per group."""
    g, per = 3, 2
    args = _inputs(g * per, 20, 24, 8, seed=7, groups=g)
    t = _torch(args, grad=True)
    y, h = ssm_scan(*t)
    gy = torch.from_numpy(np.random.default_rng(8).standard_normal(
        y.shape).astype(np.float32))
    grads = torch.autograd.grad((y * gy).sum() + h.sum(), t)
    for k in range(g):
        rows = slice(k * per, (k + 1) * per)
        one = [v.detach()[rows].clone().requires_grad_(True)
               for v in (t[0], t[1], t[2], t[3])]
        a_k = t[4].detach()[k].clone().requires_grad_(True)
        h0_k = t[5].detach()[rows].clone().requires_grad_(True)
        yk, hk = ssm_scan(*one, a_k, h0_k)
        torch.testing.assert_close(yk, y[rows], rtol=0, atol=0)
        torch.testing.assert_close(hk, h[rows], rtol=0, atol=0)
        gk = torch.autograd.grad((yk * gy[rows]).sum() + hk.sum(),
                                 [*one, a_k, h0_k])
        for want, got in zip([v[rows] for v in grads[:4]], gk[:4]):
            torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)
        torch.testing.assert_close(gk[4], grads[4][k], rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(gk[5], grads[5][rows], rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("bsz,s,d,n", [(2, 24, 40, 16), (3, 17, 9, 8)])
def test_scan_gradients_match_reference_vjp(bsz, s, d, n):
    args = _inputs(bsz, s, d, n, seed=11)
    rng = np.random.default_rng(12)
    gy = rng.standard_normal((bsz, s, d)).astype(np.float32)
    gh = rng.standard_normal((bsz, d, n)).astype(np.float32)
    _, vjp = jax.vjp(j_ssm_scan_ref, *[jnp.asarray(a) for a in args])
    want = vjp((jnp.asarray(gy), jnp.asarray(gh)))
    t = _torch(args, grad=True)
    y, h = ssm_scan(*t)
    got = torch.autograd.grad(
        (y * torch.from_numpy(gy)).sum() + (h * torch.from_numpy(gh)).sum(),
        t)
    for name, g, w in zip(("dt", "b", "c", "x", "a", "h0"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


def _regime_dt(regime, bsz, s, d, seed):
    """dt in three regimes: the model's softplus-sized dt; tiny dt
    (softplus(-9), abar within 1e-3 of 1); large dt (dt a down to -60 with
    |a| <= e^1.5, so abar underflows inside a sub-chunk's product)."""
    rng = np.random.default_rng(seed)
    if regime == "large":
        return rng.uniform(0.0, 60.0 / np.exp(1.5), (bsz, s, d)).astype(
            np.float32)
    z = rng.standard_normal((bsz, s, d))
    shift, scale = {"model": (-2.0, 0.5), "tiny": (-9.0, 0.1)}[regime]
    return np.log1p(np.exp(z * scale + shift)).astype(np.float32)


@pytest.mark.parametrize("regime", ["model", "tiny", "large"])
@pytest.mark.parametrize("bsz,s,d,n,subs", [(2, 37, 70, 8, 8),
                                            (3, 19, 33, 16, 4),
                                            (2, 45, 9, 5, 2),
                                            (1, 70, 5, 3, 1)])
def test_subchunk_algorithm_matches_reference(bsz, s, d, n, subs, regime):
    """The forward kernel's algorithm (composites folded over each tile's
    sub-chunks, every sub-chunk walked from its start) against the
    reference's oracle at the kernel's tolerance; and walking each sub-chunk
    from the checkpoints it returns, as the backward's recompute does,
    rebuilds its y and h_last bit for bit."""
    args = _inputs(bsz, s, d, n, seed=21)
    args[0] = _regime_dt(regime, bsz, s, d, seed=22)
    args[4] = -np.exp(np.random.default_rng(23).uniform(
        0.0, 1.5, (d, n))).astype(np.float32)
    t = _torch(args)
    y, h, ckpt = ssm_scan_subchunk_ref(*t, subs=subs)
    yr, hr = j_ssm_scan_ref(*[jnp.asarray(a) for a in args])
    _close(y, yr, 2e-4)
    _close(h, hr, 2e-4)
    ab = ssm_abar(t[0], t[4])
    dtx = t[0] * t[3]
    y2 = torch.empty_like(y)
    for sub in range(ckpt.shape[1]):
        hw = ckpt[:, sub]
        for step in range(8 * sub, min(s, 8 * sub + 8)):
            hw = ssm_advance(hw, ab[:, step], dtx[:, step], t[1][:, step])
            y2[:, step] = torch.einsum("bn,bdn->bd", t[2][:, step], hw)
    assert torch.equal(y2, y)
    assert torch.equal(hw, h)


def test_wrapper_checks_shapes_and_dtypes():
    args = _torch(_inputs(2, 8, 6, 4, groups=2))
    assert ops._check(*args) == 2
    dt, b, c, x, a, h0 = args
    with pytest.raises(ValueError, match="n=17"):
        wide = torch.zeros(2, 8, 17)
        ops._check(dt, wide, wide, x, torch.zeros(6, 17),
                   torch.zeros(2, 6, 17))
    with pytest.raises(ValueError, match="groups"):
        ops._check(dt, b, c, x, torch.zeros(3, 6, 4), h0)
    with pytest.raises(TypeError, match="float32"):
        ops._check(dt.double(), b, c, x.double(), a, h0)
    with pytest.raises(ValueError, match="contiguous"):
        ops._check(dt, b, c, x, a.transpose(1, 2).contiguous().transpose(
            1, 2), h0)


def _port_cfg(jcfg):
    return ModelConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(ModelConfig)})


@pytest.mark.parametrize("impl", ["chunked", "pallas"])
def test_mamba_block_matches_reference(impl):
    jcfg = dataclasses.replace(
        reduce_for_smoke(jget("jamba-1.5-large-398b")), mamba_impl=impl)
    jp = j_init_mamba(JRealInit(jax.random.key(0), jnp.float32), jcfg)
    x = jax.random.normal(jax.random.key(2), (1, 64, jcfg.d_model),
                          jnp.float32) * 0.5
    jy, (_, jh) = j_mamba_block(jp, x, jcfg)
    tp = tree_map(lambda v: v.unsqueeze(0),
                  from_numpy_params(jax.tree.map(np.asarray, jp), device="cpu"))
    ty, (_, th) = mamba_block(tp, torch.from_numpy(np.array(x))[None],
                              _port_cfg(jcfg))
    _close(ty[0], jy, 2e-3)
    _close(th[0], jh, 2e-3)


def test_mamba_block_rejects_bf16_chunks():
    """``ssm_chunk_dtype``: "bfloat16" (the reference's option for its
    chunked XLA path's chunk tensors, which the port's scan never writes)
    is accepted and gives the float32 option's result bit for bit; a
    dtype the reference does not offer is rejected."""
    cfg = get_model_family("mamba").build(None)
    p = init_params(cfg, 0, device="cpu")["stack"]["p0"]["mamba"]
    p = tree_map(lambda v: v[:1], p)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (1, 1, 4, 32)).astype(np.float32))
    want = mamba_block(p, x, cfg)[0]
    got = mamba_block(p, x, dataclasses.replace(
        cfg, ssm_chunk_dtype="bfloat16"))[0]
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        mamba_block(p, x, dataclasses.replace(cfg, ssm_chunk_dtype="float16"))


@pytest.fixture(scope="module")
def family_weights():
    jcfg = jfamily("mamba").build(None)
    jp = jax.jit(lambda key: jinit(jcfg, key))(jax.random.key(0))
    return jcfg, jp, from_numpy_params(jax.tree.map(np.asarray, jp), device="cpu")


def test_family_tree_matches_reference(family_weights):
    jcfg, jp, _ = family_weights
    tp = init_params(get_model_family("mamba").build(None), 3, device="cpu")
    jleaves = jax.tree_util.tree_leaves_with_path(jp)
    tleaves = list(leaves_with_paths(tp))
    assert len(tleaves) == len(jleaves)
    assert sum(v.numel() for v in tree_leaves(tp)) == 61_984
    for (jpath, jv), (tpath, tv) in zip(jleaves, tleaves):
        assert tuple(k.key for k in jpath) == tpath
        assert tuple(jv.shape) == tuple(tv.shape)
    assert tp["rem"] == {}
    assert get_model_family("mamba").kernel_ops == ("ssm_scan",)


def test_family_loss_and_grads_match_reference(family_weights):
    jcfg, jp, tp = family_weights
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 109, (4, 16)).astype(np.int32)
    labs = rng.integers(0, 109, (4, 16)).astype(np.int32)
    labs[0, :3] = -100                                  # ignored labels
    jl, jg = jax.jit(jax.value_and_grad(lambda p, b: jloss(jcfg)(p, b)[0]))(
        jp, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labs)})
    tp = tree_map(lambda v: v.clone().requires_grad_(True), tp)
    tl, mets = loss_fn(get_model_family("mamba").build(None))(
        tp, {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labs)})
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    assert float(mets["aux"]) == 0.0
    grads = torch.autograd.grad(tl, tree_leaves(tp))
    for g, w in zip(grads, jax.tree.leaves(jg)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-6)


def test_stacked_forward_is_per_model(family_weights):
    """A stack of two models over two batches gives each model's logits."""
    _, _, tp = family_weights
    cfg = get_model_family("mamba").build(None)
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


def test_configs_match_reference():
    """``jamba-1.5-large-398b``, ``SHAPES["train_4k"]`` and the derived
    layer layout: the same values as the reference's."""
    from repro.configs import SHAPES as JSHAPES
    from repro_torch.configs import SHAPES, get_config
    jcfg, tcfg = jget("jamba-1.5-large-398b"), get_config(
        "jamba-1.5-large-398b")
    for f in dataclasses.fields(ModelConfig):
        assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    assert tcfg.layer_kinds == jcfg.layer_kinds
    assert [tcfg.ffn_is_moe(i) for i in range(tcfg.num_layers)] == \
        [jcfg.ffn_is_moe(i) for i in range(jcfg.num_layers)]
    assert dataclasses.asdict(SHAPES["train_4k"]) == \
        dataclasses.asdict(JSHAPES["train_4k"])


@pytest.mark.parametrize("change,match", [
    (dict(family="audio"), "frontend"),
    (dict(frontend="vision"), "frontend"),
    (dict(num_experts=4, experts_per_token=2), None)])
def test_unported_layer_kinds_raise(change, match):
    """Nothing of these is unported any more: the audio family's encoder
    and cross-attention, the vision frontend's projection and the MoE FFN
    each build on the mamba stack with the reference's tree."""
    cfg = dataclasses.replace(get_model_family("mamba").build(None), **change)
    jcfg = dataclasses.replace(jfamily("mamba").build(None), **change)
    jshapes = jax.eval_shape(lambda key: jinit(jcfg, key), jax.random.key(0))
    tp = init_params(cfg, 0, device="cpu")
    jleaves = jax.tree_util.tree_leaves_with_path(jshapes)
    tleaves = list(leaves_with_paths(tp))
    assert len(tleaves) == len(jleaves)
    for (jpath, jv), (tpath, tv) in zip(jleaves, tleaves):
        assert tuple(k.key for k in jpath) == tpath
        assert tuple(jv.shape) == tuple(tv.shape)
    if match == "frontend":
        assert {"enc_ln", "frontend_proj"} & set(tp)
    else:
        assert "router" in tp["stack"]["p0"]["ffn"]


@pytest.mark.parametrize("bsz,s,d,n", [(1, 32, 128, 16), (1, 48, 200, 8)])
def test_scan_bf16_inputs_match_reference_kernel(bsz, s, d, n):
    """bf16 dt, b, c, x (a and h0 fp32), as the reference's
    ``mamba_impl="pallas"`` route hands its TPU kernel: against that
    kernel in interpret mode on the same bf16 operands at 2e-4 (both widen
    each load; y and h_last fp32); the result equals the fp32 call on the
    widened operands bit for bit, and the gradients come back bf16."""
    args = _inputs(bsz, s, d, n, seed=11)
    t = _torch(args)
    t[:4] = [v.bfloat16() for v in t[:4]]
    y, h = ssm_scan(*t)
    assert y.dtype == h.dtype == torch.float32
    jargs = [jnp.asarray(v.float().numpy()) for v in t]
    jargs[:4] = [a.astype(jnp.bfloat16) for a in jargs[:4]]
    yr, hr = j_ssm_scan(*jargs, chunk=16, blk_d=128)
    _close(y, yr, 2e-4)
    _close(h, hr, 2e-4)
    yw, hw = ssm_scan(*[v.float() for v in t])
    assert torch.equal(y, yw) and torch.equal(h, hw)
    leaves = [v.clone().requires_grad_(True) for v in t]
    grads = torch.autograd.grad(ssm_scan(*leaves)[0].sum(), leaves)
    assert [g.dtype for g in grads] == [v.dtype for v in t]
