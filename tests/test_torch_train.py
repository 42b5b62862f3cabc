"""The production training steps of the PyTorch port
(``repro_torch.launch.train``) against the reference on the CPU, at
``reduce_for_smoke`` configs with the reference's weights
(``from_numpy_params``): one parametrised test, each ``make_*_step`` on seven
archs.  ``test_torch_train_launch.py`` holds the slice's other tests
(block remat, the input specs, the demo and the example).

Each step function runs once on the same weights and batch in both
packages (the reference jitted, the port eager), 2 clients of 2 sequences
and 2 local steps (calibration: max(int(2 / 2), 1) = 1):
- ``make_fedavg_step`` with the adamw server (the dry run's and the
  demo's): ``loss`` and ``delta_norm`` (computed before the update) within
  rtol 1e-5; the new first moment (0.1 x the clipped pseudo-gradient)
  within 2e-3 of its largest entry: the pseudo-gradient is a mean of
  deltas, differences of weights that agree to about an fp32 ulp (1e-8)
  against deltas of about 1e-5 (measured: at most 7.4e-4, whisper-tiny).
  adamw's first step is about sign(g) * lr, so the new params are held by
  a rule: where |m| is above 1 % of its largest entry (|g| far above
  adam's eps and the rounding), within one fp32 ulp, 1e-7 + 1.2e-7 |p|;
  elsewhere a sign that differs by one rounding moves an entry by up to
  2 lr, and those entries are counted and held under 1 % of the tree.
- ``make_central_step`` with the sgdm server: the metrics within rtol
  1e-5, the new params and momentum within 1e-6 abs.
- ``make_calibration_step``: ``loss`` within rtol 1e-5, the new params
  within 1e-6 abs (measured: at most 4.8e-7, gemma3-27b).
gemma3-27b runs 80 tokens, past its reduced window of 64, so its local
layers go through ``window_attention``'s plain version; jamba's mamba layer
through ``ssm_scan``'s, rwkv6's through ``wkv``'s.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import FLConfig as JFL
from repro.configs import OptimizerConfig as JOpt
from repro.configs import get_config as jget
from repro.configs import reduce_for_smoke as jreduce
from repro.launch.train import make_calibration_step as jcal
from repro.launch.train import make_central_step as jcentral
from repro.launch.train import make_fedavg_step as jfedavg
from repro.models import init_params as jinit
from repro.optim import init_optimizer as j_init_opt
from repro_torch.configs import (FLConfig, OptimizerConfig, get_config,
                                 reduce_for_smoke)
from repro_torch.core.tree import leaves_with_paths
from repro_torch.launch.train import (make_calibration_step,
                                      make_central_step, make_fedavg_step)
from repro_torch.models import from_numpy_params
from repro_torch.optim import init_optimizer

torch.set_num_threads(1)
ARCHS = ("olmo-1b", "rwkv6-3b", "jamba-1.5-large-398b", "gemma3-27b",
         "granite-moe-1b-a400m", "whisper-tiny", "internvl2-2b")
NC, BPC, FRAMES = 2, 2, 20
SEQ = {"gemma3-27b": 80}          # past the reduced window (64)
FL = dict(fl_clients_per_step=NC, fl_local_steps=2)
RTOL = 1e-5


def configs(arch):
    return jreduce(jget(arch)), reduce_for_smoke(get_config(arch))


@functools.lru_cache(maxsize=None)
def reference_weights(jcfg, seed=0):
    """The reference's initial weights as numpy (read only: callers copy
    them through ``from_numpy_params`` or ``jnp.asarray``)."""
    return jax.tree.map(np.asarray, jinit(jcfg, jax.random.key(seed)))


def client_batch(cfg, seed=1, lead=(NC, BPC)):
    """Tokens, other labels and the family's frames or patches (numpy)."""
    rng = np.random.default_rng(seed)
    s = SEQ.get(cfg.name, 32)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, lead + (s,)),
             "labels": rng.integers(0, cfg.vocab_size, lead + (s,))}
    batch = {k: v.astype(np.int32) for k, v in batch.items()}
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal(
            lead + (cfg.vision_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal(
            lead + (FRAMES, cfg.d_model)).astype(np.float32)
    return batch


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _pairs(port_tree, ref_tree):
    """(path, port numpy, reference numpy) leaf by leaf, same order."""
    jl = jax.tree_util.tree_leaves_with_path(ref_tree)
    tl = list(leaves_with_paths(port_tree))
    assert [tuple(k.key for k in p) for p, _ in jl] == [p for p, _ in tl]
    return [("/".join(p), t.detach().numpy(), np.asarray(r))
            for (p, t), (_, r) in zip(tl, jl)]


def assert_tree_close(port_tree, ref_tree, atol, what):
    for path, t, r in _pairs(port_tree, ref_tree):
        assert t.shape == r.shape and t.dtype == r.dtype, (what, path)
        np.testing.assert_allclose(t, r, rtol=0, atol=atol,
                                   err_msg=f"{what}: {path}")


def assert_adamw_params(port_params, ref_params, ref_mu, lr):
    """The first adamw step's rule (module docstring): entries whose
    moment is above 1 % of the tree's largest agree within one ulp; the
    rest move by at most 2 lr apart, and fewer than 1 % of all entries
    differ by more than an ulp."""
    mu_max = max(float(np.abs(np.asarray(m)).max())
                 for m in jax.tree.leaves(ref_mu))
    off, total = 0, 0
    for (path, t, r), m in zip(_pairs(port_params, ref_params),
                               jax.tree.leaves(ref_mu)):
        d = np.abs(t - r)
        ulp = 1e-7 + 1.2e-7 * np.abs(r)
        big = np.abs(np.asarray(m)) > 0.01 * mu_max
        assert (d[big] <= ulp[big]).all(), (path, float(d[big].max()))
        assert (d <= 2 * lr + ulp).all(), (path, float(d.max()))
        off += int((d > ulp).sum())
        total += d.size
    assert off < 0.01 * total, (off, total)


@pytest.mark.parametrize("step", ["fedavg", "central", "calibration"])
@pytest.mark.parametrize("arch", ARCHS)
def test_step_matches_reference(arch, step):
    jcfg, tcfg = configs(arch)
    w = reference_weights(jcfg)
    jp = jax.tree.map(jnp.asarray, w)
    tp = from_numpy_params(w, device="cpu")
    if step == "fedavg":
        jo, to = JOpt(name="adamw", lr=1e-3), OptimizerConfig(name="adamw",
                                                              lr=1e-3)
        batch = client_batch(jcfg)
        (jnew, jstate), jm = jax.jit(jfedavg(jcfg, JFL(**FL), jo))(
            (jp, j_init_opt(jo, jp)), _j(batch))
        (tnew, tstate), tm = make_fedavg_step(tcfg, FLConfig(**FL), to)(
            (tp, init_optimizer(to, tp)), _t(batch))
        for k in ("loss", "delta_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=RTOL, err_msg=k)
        mu_max = max(float(np.abs(np.asarray(m)).max())
                     for m in jax.tree.leaves(jstate.mu))
        assert_tree_close(tstate.mu, jstate.mu, 2e-3 * mu_max, "mu")
        assert_adamw_params(tnew, jnew, jstate.mu, jo.lr)
        assert int(tstate.step) == int(jstate.step) == 1
    elif step == "central":
        jo, to = JOpt(name="sgdm", lr=1e-2), OptimizerConfig(name="sgdm",
                                                             lr=1e-2)
        batch = {k: v[0] for k, v in client_batch(jcfg).items()}
        (jnew, jstate), jm = jax.jit(jcentral(jcfg, jo))(
            (jp, j_init_opt(jo, jp)), _j(batch))
        (tnew, tstate), tm = make_central_step(tcfg, to)(
            (tp, init_optimizer(to, tp)), _t(batch))
        assert sorted(tm) == sorted(jm) == ["aux", "loss"]
        for k in tm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=RTOL, atol=1e-7, err_msg=k)
        assert_tree_close(tnew, jnew, 1e-6, "params")
        assert_tree_close(tstate.mu, jstate.mu, 1e-6, "momentum")
    else:
        batch = client_batch(jcfg)
        hist = np.asarray([0.5, 0.3], np.float32)
        jnew, jm = jax.jit(jcal(jcfg, JFL(**FL)))(jp, _j(batch),
                                                   jnp.asarray(hist))
        tnew, tm = make_calibration_step(tcfg, FLConfig(**FL))(
            tp, _t(batch), torch.from_numpy(hist))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=RTOL)
        assert_tree_close(tnew, jnew, 1e-6, "params")
