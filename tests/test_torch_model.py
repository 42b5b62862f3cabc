"""Model-level parity of the PyTorch port on the CPU: the paper CNN's
logits, loss and gradients from the reference's weights, one local-training
epoch under sgd and sgdm, and the stacked unlearning algebra
(``stacked_mean``, ``stacked_norms``, ``calibrate_stacked``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import FLConfig as JFL
from repro.configs import OptimizerConfig as JOpt
from repro.configs import get_config as jget
from repro.core import unlearning as ju
from repro.fl import FLSimulator as JSim
from repro.models import init_params as jinit
from repro.models import loss_fn as jloss
from repro.models.cnn import cnn_forward as jforward
from repro_torch.configs import FLConfig, OptimizerConfig, get_config
from repro_torch.core import unlearning as tu
from repro_torch.fl import FLSimulator
from repro_torch.fl.simulator import _broadcast
from repro_torch.models import (from_numpy_params, init_params, loss_fn,
                                predict_fn, to_numpy_params)
from repro_torch.models.cnn import cnn_forward

torch.set_num_threads(1)
TINY = dict(image_size=8, cnn_channels=(4, 8), d_model=16)
JCFG = dataclasses.replace(jget("cnn-paper"), **TINY)
TCFG = dataclasses.replace(get_config("cnn-paper"), **TINY)


def _jparams(seed=0):
    return jax.tree.map(np.asarray, jinit(JCFG, jax.random.key(seed)))


def _images(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (n, 8, 8, 1)).astype(np.float32)
    y = rng.integers(0, 10, n).astype(np.int32)
    return x, y


def _close(a, b, rtol, atol):
    for k in a:
        np.testing.assert_allclose(np.asarray(b[k]), np.asarray(a[k]),
                                   rtol=rtol, atol=atol, err_msg=k)


def test_from_numpy_params_round_trips():
    p = _jparams(3)
    t = from_numpy_params(p, device="cpu")
    assert sorted(t) == sorted(p)
    back = to_numpy_params(t)
    for k in p:
        assert t[k].dtype == torch.float32 and tuple(t[k].shape) == p[k].shape
        np.testing.assert_array_equal(back[k], p[k])


def test_port_init_follows_reference_rules():
    """Same keys, shapes and per-leaf std rules as the reference."""
    p, t = _jparams(0), init_params(TCFG, seed=0, device="cpu")
    assert sorted(t) == sorted(p)
    for k in p:
        assert tuple(t[k].shape) == p[k].shape
        if k.startswith(("b", "fb")):
            assert not t[k].any()
    fan_in = 3 * 3 * 4
    assert abs(float(t["conv2"].std()) - 1.4 / np.sqrt(fan_in)) < 0.05


@pytest.mark.parametrize("seed", [0, 1])
def test_cnn_logits_loss_grads_match(seed):
    p = _jparams(seed)
    x, y = _images(12, seed)
    jl = jforward(jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    tp = from_numpy_params(p, device="cpu")
    tl = cnn_forward(tp, torch.from_numpy(x))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-6)
    pl = predict_fn(TCFG)(tp, {"images": torch.from_numpy(x)})
    torch.testing.assert_close(pl, tl, rtol=0, atol=0)
    batch_j = {"images": jnp.asarray(x), "labels": jnp.asarray(y)}
    (jv, _), jg = jax.value_and_grad(jloss(JCFG), has_aux=True)(
        jax.tree.map(jnp.asarray, p), batch_j)
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    tv, _ = loss_fn(TCFG)(leaves, {"images": torch.from_numpy(x),
                                   "labels": torch.from_numpy(y)})
    tv.backward()
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-5,
                               atol=1e-6)
    _close({k: np.asarray(v) for k, v in jg.items()},
           {k: v.grad.numpy() for k, v in leaves.items()}, 1e-5, 1e-6)


@pytest.mark.parametrize("opt", ["sgd", "sgdm"])
def test_local_train_epoch_matches(opt):
    fl = dict(num_clients=4, clients_per_round=4, num_shards=2,
              local_epochs=1, global_rounds=1)
    data = {c: _images(20, 10 + c) for c in range(4)}
    jsim = JSim(JCFG, JFL(**fl), data, task="classification",
                opt_cfg=JOpt(name=opt, lr=0.05, grad_clip=0.0),
                local_batch=10)
    tsim = FLSimulator(TCFG, FLConfig(**fl), data, task="classification",
                       opt_cfg=OptimizerConfig(name=opt, lr=0.05,
                                               grad_clip=0.0),
                       local_batch=10, device="cpu")
    p = _jparams(2)
    xs = np.stack([data[c][0] for c in range(3)])
    ys = np.stack([data[c][1] for c in range(3)])
    jout = jsim._local_train[1](jax.tree.map(jnp.asarray, p),
                                jnp.asarray(xs), jnp.asarray(ys))
    p0 = _broadcast({k: v.unsqueeze(0) for k, v in
                     from_numpy_params(p, device="cpu").items()}, (3,))
    tout = tsim.local_train(p0, torch.from_numpy(xs), torch.from_numpy(ys), 1)
    _close(jax.tree.map(np.asarray, jout), tout, 1e-4, 1e-5)


def _stacked(m, seed):
    rng = np.random.default_rng(seed)
    return {"conv1": rng.standard_normal((m, 3, 3, 1, 4)).astype(np.float32),
            "b1": rng.standard_normal((m, 4)).astype(np.float32),
            "fc1": rng.standard_normal((m, 32, 16)).astype(np.float32)}


@pytest.mark.parametrize("m", [1, 4, 5])
def test_stacked_mean_and_norms_match(m):
    st = _stacked(m, m)
    jst = jax.tree.map(jnp.asarray, st)
    tst = from_numpy_params(st, device="cpu")
    _close(jax.tree.map(np.asarray, ju.stacked_mean(jst)),
           tu.stacked_mean(tst), 1e-5, 1e-5)
    np.testing.assert_allclose(tu.stacked_norms(tst).numpy(),
                               np.asarray(ju.stacked_norms(jst)),
                               rtol=1e-5, atol=1e-5)


def test_stacked_mean_is_a_left_fold():
    """The port's FedAvg mean is bit-identical to the sequential sum."""
    st = from_numpy_params(_stacked(5, 0), device="cpu")
    got = tu.stacked_mean(st)
    for k, v in st.items():
        acc = v[0]
        for i in range(1, 5):
            acc = acc + v[i]
        torch.testing.assert_close(got[k], acc / 5, rtol=0, atol=0)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("m", [1, 4])
def test_calibrate_stacked_matches(use_kernel, m):
    w = jax.tree.map(lambda a: a[0], _stacked(1, 7))
    deltas = _stacked(m, 8)
    norms = np.random.default_rng(9).uniform(0.5, 2.0, m).astype(np.float32)
    jout = ju.calibrate_stacked(jax.tree.map(jnp.asarray, w),
                                jax.tree.map(jnp.asarray, deltas),
                                jnp.asarray(norms), use_kernel=use_kernel)
    tout = tu.calibrate_stacked(from_numpy_params(w, device="cpu"),
                                from_numpy_params(deltas, device="cpu"),
                                torch.from_numpy(norms))
    _close(jax.tree.map(np.asarray, jout), tout, 1e-5, 1e-5)
