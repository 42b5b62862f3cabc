"""Eq. 3's list form and the stage program's training-cost annotation of
the PyTorch port, on the CPU.

* ``core.unlearning.calibrate`` and ``remove_client_effect`` against the
  reference's: fp32 within 1e-6 relative, and 1e-6 of each leaf's largest
  entry where an entry is near 0 (``tree_norm``'s sums associate in
  another order in XLA and torch: one ulp of a norm, measured 2.4e-7 abs
  on entries up to 3.2); the kept keys exactly.
* ``roofline.analysis.train_step_flops`` and ``telemetry.stage_cost``
  against ``torch.utils.flop_counter.FlopCounterMode`` run over the same
  SGD steps: exactly, for every family the stage engine trains.  Two
  things stand between the counter and the count.  (1) torch's formula for
  a convolution's weight gradient ignores ``groups``, so on a grouped
  convolution (the CNN's stack of B models) it counts B times each
  model's work; the counter is given a formula that divides that part by
  ``groups``, and a stack of one model needs no correction.  (2) The
  ``ssm_scan`` and ``wkv`` recurrences are not matrix products: the test
  swaps them for elementwise stand-ins the counter sees as 0 FLOPs, and
  holds the count's recurrence term to the formulas (``ssm_work``,
  ``wkv_work``) that give ``chip_smoke.py`` the kernels' bounds, whose
  values are pinned to those the script computed before they moved.
* ``train_flops`` doubles exactly with G: the loops are counted with their
  trip counts (the reference's XLA cost analysis counts a loop body once).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode, conv_backward_flop

from repro.core import unlearning as junl
from repro_torch import telemetry as TT
from repro_torch.configs import get_config
from repro_torch.core import unlearning
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.fl.experiment import (ScenarioConfig, build_simulator,
                                       train_stage)
from repro_torch.fl.families import MoEFamily
from repro_torch.models import init_params, stacked_loss_fn
from repro_torch.models import mamba as mb
from repro_torch.models import rwkv6 as rw
from repro_torch.roofline import analysis as A

torch.set_num_threads(1)
aten = torch.ops.aten


# ------------------------------------------------------------ eq. 3, lists

def _trees(rng, m, scale=1.0):
    shapes = {"conv": (3, 3, 1, 4), "b": (4,), "fc": (36, 10)}
    return [{k: (rng.standard_normal(s) * scale).astype(np.float32)
             for k, s in shapes.items()} for _ in range(m)]


@pytest.mark.parametrize("m,zero_new", [(1, False), (3, False), (5, False),
                                        (3, True)])
def test_calibrate_matches_reference(m, zero_new):
    rng = np.random.default_rng(m)
    w = _trees(rng, 1)[0]
    new, old = _trees(rng, m, 0.1), _trees(rng, m, 0.3)
    if zero_new:                          # ||new|| = 0: the eps clamp
        new[1] = {k: np.zeros_like(v) for k, v in new[1].items()}

    def port(t):
        return {k: torch.from_numpy(v) for k, v in t.items()}

    def ref(t):
        return {k: jnp.asarray(v) for k, v in t.items()}
    got = unlearning.calibrate(port(w), [port(t) for t in new],
                               [port(t) for t in old])
    want = junl.calibrate(ref(w), [ref(t) for t in new],
                          [ref(t) for t in old])
    assert sorted(got) == sorted(want)
    for k in want:
        ref_k = np.asarray(want[k])
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), ref_k, rtol=1e-6,
                                   atol=1e-6 * np.abs(ref_k).max(),
                                   err_msg=k)
    with pytest.raises(ValueError):
        unlearning.calibrate(port(w), [port(t) for t in new],
                             [port(t) for t in old] + [port(w)])


@pytest.mark.parametrize("gone", [[], [3], [1, 3, 9], [7, 7]])
def test_remove_client_effect_matches_reference(gone):
    locals_ = {c: {"w": torch.full((2,), float(c))} for c in (1, 3, 5, 7)}
    got = unlearning.remove_client_effect(locals_, gone)
    want = junl.remove_client_effect(locals_, gone)
    assert list(got) == list(want)
    assert all(got[c] is locals_[c] for c in got)


def test_calibrate_agrees_with_calibrate_stacked():
    """The list form and the stacked form are one eq. 3 (the stacked form
    sums in another order: float32 rounding apart)."""
    rng = np.random.default_rng(0)
    w = {k: torch.from_numpy(v) for k, v in _trees(rng, 1)[0].items()}
    new = [{k: torch.from_numpy(v) for k, v in t.items()}
           for t in _trees(rng, 4, 0.1)]
    old = [{k: torch.from_numpy(v) for k, v in t.items()}
           for t in _trees(rng, 4, 0.3)]
    stacked = tree_map(lambda *vs: torch.stack(vs), *new)
    norms = torch.stack([unlearning.tree_norm(t) for t in old])
    a = unlearning.calibrate(w, new, old)
    b = unlearning.calibrate_stacked(w, stacked, norms)
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=1e-6, atol=1e-6)


# ------------------------------------------- the moved kernel formulas

PINNED = [  # chip_smoke.py's values, computed before the formulas moved
    (A.ssm_work, (50, 64, 64, 8, 5), (2877440, 9830400, 1638400),
     (3696640, 9830400, 1638400), (4833280, 32768000, 1638400)),
    (A.ssm_work, (2, 4096, 16384, 16, 1),
     (1616904192, 12884901888, 2147483648),
     (2690646016, 12884901888, 2147483648),
     (2694840320, 42949672960, 2147483648)),
    (A.ssm_work, (3, 37, 130, 4, 3), (195432, 346320, 57720),
     (226632, 346320, 57720), (326904, 1154400, 57720)),
    (A.wkv_work, (50, 64, 2, 16, 5), (2253440, 6553600, 102400),
     (2355840, 6553600, 102400), (3994880, 19660800, 102400)),
    (A.wkv_work, (8, 4096, 40, 64, 1), (1688217600, 21474836480, 83886080),
     (2023761920, 21474836480, 83886080),
     (3035648000, 64424509440, 83886080)),
    (A.wkv_work, (3, 37, 3, 5, 3), (35280, 33300, 1665),
     (36180, 33300, 1665), (63000, 99900, 1665)),
]


@pytest.mark.parametrize("fn,shape,fwd,fwd_train,bwd", PINNED,
                         ids=lambda v: getattr(v, "__name__", None))
def test_moved_recurrence_formulas_keep_their_values(fn, shape, fwd,
                                                     fwd_train, bwd):
    assert fn(*shape, backward=False) == fwd
    assert fn(*shape, backward=False, train=True) == fwd_train
    assert fn(*shape, backward=True) == bwd
    assert fn(*shape, backward=True, train=True) == bwd


@pytest.mark.parametrize("shape,fwd,bwd", [
    ((2, 4096, 32, 16, 128, 1024), (403701760, 120275861504, 234913792),
     (806354944, 300689653760, 234913792)),
    ((8, 64, 4, 2, 16, 16), (401408, 1851392, 28928),
     (794624, 4628480, 28928))])
def test_moved_window_formulas_keep_their_values(shape, fwd, bwd):
    assert A.window_work(*shape, backward=False) == fwd
    assert A.window_work(*shape, backward=True) == bwd


# --------------------------------------------- one SGD step, counted

def grouped_conv_backward_flop(grad_out_shape, x_shape, w_shape, bias,
                               stride, padding, dilation, transposed,
                               output_padding, groups, output_mask,
                               out_shape):
    """torch's convolution-backward count with the weight gradient's part
    divided by ``groups`` (torch's formula ignores groups there)."""
    args = (grad_out_shape, x_shape, w_shape, bias, stride, padding,
            dilation, transposed, output_padding, groups)
    return (conv_backward_flop(*args, [output_mask[0], False],
                               out_val=out_shape)
            + conv_backward_flop(*args, [False, output_mask[1]],
                                 out_val=out_shape) // groups)


def _counter():
    return FlopCounterMode(display=False, custom_mapping={
        aten.convolution_backward: grouped_conv_backward_flop})


def _step_count(cfg, params, batch, counter):
    loss = stacked_loss_fn(cfg)
    leaves = tree_map(lambda v: v.detach().requires_grad_(True), params)
    with counter as fc:
        torch.autograd.grad(loss(leaves, batch).sum(), tree_leaves(leaves))
    return fc.get_total_flops()


def test_paper_cnn_step_at_batch_20():
    """One SGD step of the paper CNN at full width (batch 20) by torch's
    own counter, uncorrected: a stack of one model is an ungrouped
    convolution."""
    cfg = get_config("cnn-paper")
    p = tree_map(lambda v: v.unsqueeze(0),
                 init_params(cfg, 0, device="cpu"))
    images = torch.randn(1, 20, 28, 28, 1)
    labels = torch.zeros(1, 20, dtype=torch.int32)
    got = _step_count(cfg, p, {"images": images, "labels": labels},
                      FlopCounterMode(display=False))
    want = A.train_step_flops(cfg, 20, (28, 28, 1))
    assert got == want["products"] == want["total"] == 141_649_920


def ssm_stand_in(dt, b, c, x, a, h0):
    """The scan's shapes and gradient paths, elementwise: 0 counted FLOPs."""
    return x * dt + (b * c).sum(-1, keepdim=True) + 0 * a.sum(), h0


def wkv_stand_in(r, k, v, lw, u, h0):
    return r * k * v * lw + 0 * u.sum(), h0


@pytest.fixture
def stand_ins(monkeypatch):
    monkeypatch.setattr(mb, "ssm_scan", ssm_stand_in)
    monkeypatch.setattr(rw, "wkv", wkv_stand_in)


FAMILIES = {"cnn": dict(task="classification", image_size=14),
            "transformer": dict(task="generation", seq_len=16),
            "mamba": dict(task="generation", seq_len=16),
            "rwkv6": dict(task="generation", seq_len=16),
            "moe": dict(task="generation", seq_len=16),
            "moe-gather": dict(task="generation", seq_len=16)}


def _sim(family, monkeypatch, rounds=3, **kw):
    model = family.split("-")[0]
    if family == "moe-gather":
        build = MoEFamily.build
        monkeypatch.setattr(MoEFamily, "build", lambda self, cfg: dataclasses
                            .replace(build(self, cfg), moe_impl="gather"))
    cfg = ScenarioConfig(model=model, num_clients=8, clients_per_round=4,
                         num_shards=2, samples_per_client=10, local_batch=4,
                         local_epochs=2, global_rounds=rounds, test_n=8,
                         **{**FAMILIES[family], **kw})
    return build_simulator(cfg, device="cpu")[0]


def _kernel_term(cfg, b, s):
    """The recurrences' FLOPs of one model's step, from the formulas'
    constants."""
    if "rwkv" in cfg.layer_kinds:
        h, n = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
        per = b * s * h * n * n * (A.WKV_FWD_FLOPS + A.WKV_BWD_FLOPS)
        return per * cfg.layer_kinds.count("rwkv")
    di, n = cfg.ssm_expand * cfg.d_model, cfg.ssm_state_dim
    per = b * s * di * n * (A.SSM_FWD_FLOPS + A.SSM_BWD_FLOPS)
    return per * cfg.layer_kinds.count("mamba")


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_stage_train_flops_equal_the_counted_program(family, monkeypatch,
                                                     stand_ins):
    """The stage engine's whole program (G 3, L 2, 10 examples at batch 4:
    two steps an epoch, the last 2 examples dropped) under the counter:
    its FLOPs are the span's ``train_flops`` less the recurrence term, plus
    its encode."""
    sim = _sim(family, monkeypatch)
    tr = TT.configure(enabled=True, annotate_costs=True)
    try:
        with _counter() as fc:
            rec = train_stage(sim, store_kind="coded", engine="stage")
        (sp,) = [x for x in tr.all_spans()
                 if x.name == "device.stage_program"]
    finally:
        TT.configure(enabled=False)
    models = sum(len(cs) for cs in rec.plan.shard_clients.values())
    steps = models * 3 * 2 * (10 // 4)
    shape = (14, 14, 1) if family == "cnn" else (16,)
    step = A.train_step_flops(sim.cfg, 4, shape)
    kernels = 0 if family in ("cnn", "transformer") or "moe" in family \
        else _kernel_term(sim.cfg, 4, 16)
    assert step["kernels"] == kernels
    assert step["total"] == step["products"] + kernels
    assert sp.labels["train_flops"] == steps * step["total"]
    assert fc.get_total_flops() == (sp.labels["train_flops"]
                                    - steps * kernels
                                    + sp.labels["encode_flops"])
    assert "hlo_flops" not in sp.labels


@pytest.mark.parametrize("family", ["cnn", "rwkv6"])
def test_train_flops_scale_exactly_with_rounds(family, monkeypatch):
    got = {}
    for g in (3, 6):
        tr = TT.configure(enabled=True, annotate_costs=True)
        try:
            train_stage(_sim(family, monkeypatch, rounds=g),
                        store_kind="full", engine="stage")
            (sp,) = [x for x in tr.all_spans()
                     if x.name == "device.stage_program"]
        finally:
            TT.configure(enabled=False)
        got[g] = sp.labels
        assert "encode_flops" not in sp.labels        # no in-program encode
    assert got[6]["train_flops"] == 2 * got[3]["train_flops"] > 0
    assert got[6]["train_bytes"] == 2 * got[3]["train_bytes"] > 0


@pytest.mark.parametrize("opt,state", [("sgd", 0), ("sgdm", 4),
                                       ("adamw", 8)])
def test_train_bytes_count_params_state_and_batch(opt, state, monkeypatch):
    sim = _sim("cnn", monkeypatch, opt_name=opt)
    w0 = sim.init_model(0)
    xs, ys = (torch.zeros(2, 3, 10, 14, 14, 1),
              torch.zeros(2, 3, 10, dtype=torch.int32))
    got = TT.stage_cost(sim, w0, xs, ys, rounds=3)
    p = sum(v.numel() for v in tree_leaves(w0))
    steps = 2 * 3 * 3 * 2 * (10 // 4)
    assert got["train_bytes"] == steps * (2 * (4 + state) * p
                                          + 4 * (14 * 14 * 4 + 4))
    assert got["train_flops"] == steps * A.train_step_flops(
        sim.cfg, 4, (14, 14, 1))["total"]
