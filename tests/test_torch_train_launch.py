"""The rest of the training slice's CPU tests (``repro_torch.launch.train``,
``launch.inputs``, block remat), beside ``test_torch_train.py``'s step
parity, which they share helpers with:
- the fedavg step with the sgd and sgdm servers (olmo-1b) against the
  reference's: ``loss`` and ``delta_norm`` within rtol 1e-5, the new params
  within 1e-7 abs (measured 1.5e-8);
- ``remat="block"`` against ``"none"``: the same loss and every gradient
  bit for bit (the recompute is the same arithmetic on the CPU), for the
  seven reduced archs;
- ``launch.inputs``' specs against the reference's for every arch x shape;
- tests/test_system.py's ``TestLaunchSteps`` on the port, the demo against
  the reference's demo, and ``examples/fedavg_pod_step_torch.py`` on the
  CPU.
"""
import dataclasses
import io
import re
import subprocess
import sys
from contextlib import redirect_stdout
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import FLConfig as JFL
from repro.configs import OptimizerConfig as JOpt
from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget
from repro.core.unlearning import tree_norm as j_tree_norm
from repro.launch import inputs as jinp
from repro.launch.train import _demo as j_demo
from repro.launch.train import make_fedavg_step as jfedavg
from repro.optim import init_optimizer as j_init_opt
from repro_torch.configs import (ASSIGNED_ARCHS, SHAPES, FLConfig,
                                 OptimizerConfig, get_config)
from repro_torch.core.tree import leaves_with_paths, tree_leaves, tree_map
from repro_torch.core.unlearning import tree_norm, tree_sub
from repro_torch.launch import inputs as inp
from repro_torch.launch.train import (_demo, make_calibration_step,
                                      make_fedavg_step)
from repro_torch.models import from_numpy_params, init_params, loss_fn
from repro_torch.optim import init_optimizer
from test_torch_train import (ARCHS, FL, RTOL, _j, _t, assert_tree_close,
                              client_batch, configs, reference_weights)

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("server", ["sgd", "sgdm"])
def test_fedavg_sgd_servers_match_reference_tightly(server):
    jcfg, tcfg = configs("olmo-1b")
    w = reference_weights(jcfg, 2)
    jp = jax.tree.map(jnp.asarray, w)
    tp = from_numpy_params(w, device="cpu")
    jo, to = JOpt(name=server, lr=0.5), OptimizerConfig(name=server, lr=0.5)
    batch = client_batch(jcfg, seed=3)
    (jnew, _), jm = jax.jit(jfedavg(jcfg, JFL(**FL), jo))(
        (jp, j_init_opt(jo, jp)), _j(batch))
    (tnew, _), tm = make_fedavg_step(tcfg, FLConfig(**FL), to)(
        (tp, init_optimizer(to, tp)), _t(batch))
    for k in ("loss", "delta_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=RTOL)
    assert_tree_close(tnew, jnew, 1e-7, "params")


@pytest.mark.parametrize("arch", ARCHS)
def test_block_remat_gives_the_same_loss_and_gradients(arch):
    _jcfg, tcfg = configs(arch)
    params = init_params(tcfg, 5, device="cpu")
    batch = _t({k: v[0] for k, v in client_batch(tcfg, seed=6).items()})
    out = {}
    for remat in ("none", "block"):
        q = tree_map(lambda v: v.detach().requires_grad_(True), params)
        loss, _ = loss_fn(tcfg, remat=remat)(q, batch)
        out[remat] = (loss, torch.autograd.grad(loss, tree_leaves(q)))
    assert torch.equal(out["none"][0], out["block"][0])
    for (path, _), a, b in zip(leaves_with_paths(params), out["none"][1],
                               out["block"][1]):
        assert torch.equal(a, b), "/".join(path)


def test_remat_rejects_unknown_policy():
    _jcfg, tcfg = configs("olmo-1b")
    params = init_params(tcfg, 0, device="cpu")
    batch = _t({k: v[0] for k, v in client_batch(tcfg).items()})
    with pytest.raises(ValueError, match="remat"):
        loss_fn(tcfg, remat="everything")(params, batch)


def _spec(t):
    return tuple(t.shape), str(t.dtype).replace("torch.", "")


def _jspec(s):
    return tuple(s.shape), str(s.dtype)


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_input_specs_match_reference(arch):
    """Every shape's specs: the same shapes and dtypes, on ``meta``."""
    jcfg, tcfg = jget(arch), get_config(arch)
    jfl, tfl = JFL(), FLConfig()
    assert inp.AUDIO_ENC_FRAMES == jinp.AUDIO_ENC_FRAMES
    for name, shape in SHAPES.items():
        jshape = JSHAPES[name]
        assert dataclasses.asdict(shape) == dataclasses.asdict(jshape)
        if shape.kind == "train":
            got = inp.train_batch_specs(tcfg, shape, tfl)
            want = jinp.train_batch_specs(jcfg, jshape, jfl)
        else:
            got = inp.prefill_batch_specs(tcfg, shape)
            want = jinp.prefill_batch_specs(jcfg, jshape)
            assert _spec(inp.decode_token_specs(shape)) == _jspec(
                jinp.decode_token_specs(jshape))
            assert inp.cache_len_for(tcfg, shape) == jinp.cache_len_for(
                jcfg, jshape)
        assert sorted(got) == sorted(want), name
        for k in got:
            assert got[k].device.type == "meta"
            assert _spec(got[k]) == _jspec(want[k]), (name, k)


def test_fl_config_fields_match_reference():
    assert dataclasses.asdict(FLConfig()) == dataclasses.asdict(JFL())


def test_fedavg_step_decreases_loss():
    """tests/test_system.py's ``TestLaunchSteps`` on the port."""
    _jcfg, cfg = configs("olmo-1b")
    fl = FLConfig(fl_clients_per_step=2, fl_local_steps=2)
    opt = OptimizerConfig(name="adamw", lr=5e-3)
    params = init_params(cfg, 0, device="cpu")
    state = (params, init_optimizer(opt, params))
    step = make_fedavg_step(cfg, fl, opt)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 2, 32)).astype(np.int32))
    batch = {"tokens": toks, "labels": toks}
    losses = []
    for _ in range(8):
        state, mets = step(state, batch)
        losses.append(float(mets["loss"]))
    assert losses[-1] < losses[0], losses


def test_calibration_step_rescales_to_history():
    _jcfg, cfg = configs("olmo-1b")
    fl = FLConfig(fl_clients_per_step=2, fl_local_steps=2)
    params = init_params(cfg, 0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 2, 32)).astype(np.int32))
    batch = {"tokens": toks, "labels": toks}
    hist = torch.tensor([0.5, 0.5])
    new_params, _ = make_calibration_step(cfg, fl)(params, batch, hist)
    delta = float(tree_norm(tree_sub(new_params, params)))
    # the mean of two deltas each rescaled to 0.5: at most 0.5 + rounding
    assert 0.05 < delta < 0.75
    # one client: its delta rescaled to exactly the stored norm
    one = FLConfig(fl_clients_per_step=1, fl_local_steps=2)
    new1, _ = make_calibration_step(cfg, one)(
        params, {k: v[:1] for k, v in batch.items()}, torch.tensor([0.25]))
    np.testing.assert_allclose(float(tree_norm(tree_sub(new1, params))),
                               0.25, rtol=1e-5)


def test_demo_matches_reference_demo():
    """``_demo`` with the reference's flags and weights prints the
    reference's rounds (4 decimals) and returns their values."""
    jcfg, _tcfg = configs("olmo-1b")
    w = reference_weights(jcfg)
    argv = ["--steps", "2"]
    buf = io.StringIO()
    with redirect_stdout(buf):
        j_demo(argv)
    want = re.findall(r"loss=([\d.]+) delta=([\d.]+)", buf.getvalue())
    losses, norms = _demo(argv + ["--device", "cpu"],
                          init_fn=lambda cfg: from_numpy_params(
                              w, device="cpu"))
    assert len(want) == 2
    for (wl, wd), tl, td in zip(want, losses, norms):
        assert abs(float(wl) - tl) <= 1e-4 and abs(float(wd) - td) <= 1e-4


def test_fedavg_pod_step_example_runs_on_cpu():
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "fedavg_pod_step_torch.py"),
         "--device", "cpu", "--rounds", "2", "--arch", "olmo-1b"],
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             "OMP_NUM_THREADS": "1"},
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    rounds = re.findall(r"round \d: loss=([\d.]+) \|mean delta\|=([\d.]+)",
                        proc.stdout)
    assert len(rounds) == 2
    assert all(np.isfinite(float(v)) for r in rounds for v in r)
    assert "calibration loss=" in proc.stdout


def test_train_steps_without_device_raise_when_no_gpu(monkeypatch):
    """The demo, like every entry point, runs on the card unless the
    caller asks for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _demo(["--steps", "1"])


def test_reference_tree_norm_agrees():
    """``metrics["delta_norm"]`` is ``tree_norm`` of the mean delta in both
    packages: the port's norm of a tree equals the reference's."""
    rng = np.random.default_rng(9)
    tree = {"a": rng.standard_normal((3, 5)).astype(np.float32),
            "b": {"c": rng.standard_normal(7).astype(np.float32)}}
    np.testing.assert_allclose(
        float(tree_norm(from_numpy_params(tree, device="cpu"))),
        float(j_tree_norm(jax.tree.map(jnp.asarray, tree))), rtol=1e-6)
