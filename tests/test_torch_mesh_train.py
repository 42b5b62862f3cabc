"""The production training steps of the PyTorch port run sharded over a
(data=2, model=2) ``DeviceMesh`` of 4 gloo ranks, against the reference's
unsharded jitted steps on the CPU.

Each arch's three steps run in one world (``launch.mesh.spawn`` of
``launch.train.steps_on_mesh``), at ``reduce_for_smoke`` configs with the
reference's weights, under the rules of the *published* config
(``param_rules(get_config(arch), "train", False)``), so FSDP over ``data``
is on for all three: rwkv6-3b (the ``wkv`` kernel's plain version on each
rank's heads), jamba-1.5-large-398b (mamba's ``ssm_scan`` on each rank's
channels, MoE, attention) and gemma3-27b (80 tokens, past its reduced
window of 64: ``window_attention`` on each rank's heads).  Each arch must
have leaves sharded over ``data`` and over ``model``, so the check cannot
pass on replicated weights.  The tolerances are
``tests/test_torch_train.py``'s (its module docstring).

Also here: the window kernel's GQA case (query heads split over ``model``,
kv heads not: each rank reads the kv heads of its own groups, and their
gradients sum over the ranks), and ``collective_link_bytes`` against the
reference's ``parse_collectives`` on synthetic HLO lines of each kind.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import FLConfig as JFL
from repro.configs import OptimizerConfig as JOpt
from repro.launch.train import make_calibration_step as jcal
from repro.launch.train import make_central_step as jcentral
from repro.launch.train import make_fedavg_step as jfedavg
from repro.optim import init_optimizer as j_init_opt
from repro.roofline.analysis import parse_collectives
from repro_torch.configs import FLConfig, OptimizerConfig
from repro_torch.launch.mesh import spawn
from repro_torch.launch.train import steps_on_mesh
from repro_torch.roofline.analysis import (COLLECTIVE_KINDS,
                                           collective_link_bytes)
from test_torch_train import (FL, RTOL, _j, assert_adamw_params,
                              client_batch, configs, reference_weights)

ARCHS = ("rwkv6-3b", "jamba-1.5-large-398b", "gemma3-27b")
HIST = np.asarray([0.5, 0.3], np.float32)
FEDAVG_OPT = dict(name="adamw", lr=1e-3)
CENTRAL_OPT = dict(name="sgdm", lr=1e-2)


@functools.lru_cache(maxsize=None)
def port_results(arch):
    """The three sharded steps of ``arch`` on 4 gloo ranks (one world)."""
    jcfg, _ = configs(arch)
    return spawn(steps_on_mesh, 4, "gloo", arch, "2x2",
                 reference_weights(jcfg), client_batch(jcfg), HIST,
                 FLConfig(**FL), OptimizerConfig(**FEDAVG_OPT),
                 OptimizerConfig(**CENTRAL_OPT), "cpu", timeout=400)


def _close(port_tree, ref_tree, atol, what):
    flat = jax.tree_util.tree_leaves_with_path(ref_tree)
    for path, r in flat:
        t = port_tree
        for k in path:
            t = t[k.key]
        assert t.shape == r.shape and t.dtype == r.dtype, (what, path)
        np.testing.assert_allclose(t, np.asarray(r), rtol=0, atol=atol,
                                   err_msg=f"{what}: {path}")


@pytest.mark.parametrize("step", ["fedavg", "central", "calibration"])
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_matches_reference(arch, step):
    out = port_results(arch)
    spec = out["spec"]
    assert any("data" in d for d in spec.values()), spec
    assert any("model" in d for d in spec.values()), spec
    jcfg, _ = configs(arch)
    w = reference_weights(jcfg)
    jp = jax.tree.map(jnp.asarray, w)
    batch = client_batch(jcfg)
    tnew, tmom, tm = out[step]
    if step == "fedavg":
        jo = JOpt(**FEDAVG_OPT)
        (jnew, jstate), jm = jax.jit(jfedavg(jcfg, JFL(**FL), jo))(
            (jp, j_init_opt(jo, jp)), _j(batch))
        for k in ("loss", "delta_norm"):
            np.testing.assert_allclose(tm[k], float(jm[k]), rtol=RTOL,
                                       err_msg=k)
        mu_max = max(float(np.abs(np.asarray(m)).max())
                     for m in jax.tree.leaves(jstate.mu))
        _close(tmom["mu"], jstate.mu, 2e-3 * mu_max, "mu")
        assert_adamw_params(_as_torch(tnew), jnew, jstate.mu, jo.lr)
    elif step == "central":
        jo = JOpt(**CENTRAL_OPT)
        cb = {k: v[0] for k, v in batch.items()}
        (jnew, jstate), jm = jax.jit(jcentral(jcfg, jo))(
            (jp, j_init_opt(jo, jp)), _j(cb))
        assert sorted(tm) == sorted(jm) == ["aux", "loss"]
        for k in tm:
            np.testing.assert_allclose(tm[k], float(jm[k]), rtol=RTOL,
                                       atol=1e-7, err_msg=k)
        _close(tnew, jnew, 1e-6, "params")
        _close(tmom["mu"], jstate.mu, 1e-6, "momentum")
    else:
        jnew, jm = jax.jit(jcal(jcfg, JFL(**FL)))(jp, _j(batch),
                                                   jnp.asarray(HIST))
        np.testing.assert_allclose(tm["loss"], float(jm["loss"]), rtol=RTOL)
        _close(tnew, jnew, 1e-6, "params")


def _as_torch(tree):
    if isinstance(tree, dict):
        return {k: _as_torch(v) for k, v in tree.items()}
    return torch.from_numpy(tree)


# ---------------------------------------------------------------------------
# GQA in the window kernel: query heads split, kv heads not
# ---------------------------------------------------------------------------

GQA = dict(b=2, s=40, h=4, kv=1, hd=8, window=16)


def gqa_inputs():
    rng = np.random.default_rng(3)
    g = GQA
    q = rng.standard_normal((g["b"], g["s"], g["h"], g["hd"]))
    k = rng.standard_normal((g["b"], g["s"], g["kv"], g["hd"]))
    v = rng.standard_normal((g["b"], g["s"], g["kv"], g["hd"]))
    w = rng.standard_normal((g["b"], g["s"], g["h"], g["hd"]))
    return [a.astype(np.float32) for a in (q, k, v, w)]


def _gqa_rank(rank, world_size):
    """o and the gradients of sum(o * w) through ``sharded_attention``
    of ``window_attention`` on a (2, 2) mesh, gathered."""
    from torch.distributed.tensor import (DTensor, Replicate,
                                          distribute_tensor)

    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.shardings import act_rules
    from repro_torch.configs import get_config
    from repro_torch.models import ShardCtx
    from repro_torch.kernels.window_attn.ops import window_attention
    from repro_torch.models.attention import (KV_KERNEL_AXES,
                                              sharded_attention)
    mesh = make_debug_mesh(2, 2, device_type="cpu")
    ctx = ShardCtx(mesh, act_rules(get_config("gemma3-27b"), "train",
                                   False))
    q, k, v, w = (torch.from_numpy(a) for a in gqa_inputs())
    rep = [Replicate(), Replicate()]
    ins = [distribute_tensor(t, mesh, rep).requires_grad_(True)
           for t in (q, k, v)]
    with ctx.scope():
        o = sharded_attention(lambda a, b, c: window_attention(
            a, b, c, GQA["window"]), *ins, ctx)
        placements = [str(p) for p in o.placements]
        kv_placements = [str(p) for p in
                         ctx.constrain(ins[1], KV_KERNEL_AXES).placements]
        (o * w).sum().backward()
    full = [t.full_tensor() if isinstance(t, DTensor) else t
            for t in (o, *(i.grad for i in ins))]
    return ([t.detach().numpy() for t in full], placements, kv_placements)


def test_window_gqa_kv_heads_not_split():
    from repro_torch.kernels.window_attn.ref import window_attention_ref
    (o, dq, dk, dv), o_pl, kv_pl = spawn(_gqa_rank, 4, "gloo", timeout=200)
    assert o_pl == ["S(0)", "S(2)"]                       # batch, heads
    assert kv_pl == ["S(0)", "R"]                          # kv heads whole
    q, k, v, w = (torch.from_numpy(a) for a in gqa_inputs())
    ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ro = window_attention_ref(*ins, GQA["window"])
    (ro * w).sum().backward()
    for got, want in zip((o, dq, dk, dv), (ro, *(i.grad for i in ins))):
        np.testing.assert_allclose(got, want.detach().numpy(), rtol=0,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# Collective link bytes: the reference's ring formulas
# ---------------------------------------------------------------------------

HLO_KIND = {"all-reduce": "all-reduce", "all-gather": "all-gather",
            "reduce-scatter": "reduce-scatter", "all-to-all": "all-to-all",
            "permute": "collective-permute"}


@pytest.mark.parametrize("kind", COLLECTIVE_KINDS)
@pytest.mark.parametrize("n,devices", [(2, 4), (4, 4), (16, 256)])
def test_collective_link_bytes_match_reference(kind, n, devices):
    shape = (3, 1024)                     # f32: 12288 bytes a device
    line = (f"  %x.1 = f32[{shape[0]},{shape[1]}]{{1,0}} "
            f"{HLO_KIND[kind]}(f32[3,1024]{{1,0}} %p), "
            f"replica_groups=[{devices // n},{n}]<=[{devices}]")
    ref = parse_collectives(line, devices)
    nbytes = 4 * shape[0] * shape[1]
    got = collective_link_bytes(kind, nbytes, n) * (devices // n)
    assert ref["collective_op_counts"][HLO_KIND[kind]] == 1
    assert got == ref["collective_bytes_by_kind"][HLO_KIND[kind]]
