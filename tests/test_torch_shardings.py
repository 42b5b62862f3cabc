"""The port's sharding policy (``repro_torch.launch.shardings``,
``models.params.spec_for``) against the reference's, exactly, on the
production meshes.

One parametrised test over every ``ASSIGNED_ARCHS`` x {train, prefill,
decode} x {16x16, 2x16x16}, strategy ``tp`` and, where the reference's
``resolve_strategy`` picks it ("auto"), ``seq_parallel`` too.  The
reference's mesh is mocked as ``tests/test_system.py`` mocks it (axis
names and a device array), the port's is a ``MeshShape``:
- ``needs_fsdp``, ``param_rules``, ``act_rules`` and ``resolve_strategy``
  are equal;
- every param leaf's spec equals the reference's ``spec_for`` over its
  ``param_axes``; the optimizer moments' placements are their params';
- every batch leaf's (client-leading for train) equals ``spec_for`` over
  the reference's ``_BATCH_AXES``, every cache leaf's over its
  ``_cache_leaf_axes``;
- on a ``fake_world`` of the mesh's size, ``distribute_tree`` of the
  ``meta`` params gives each leaf the local shape dim // prod(mesh sizes)
  of the reference's spec.
"""
import os
import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import ASSIGNED_ARCHS, FLConfig as JFL, SHAPES
from repro.configs import get_config as jget
from repro.launch import inputs as jinp
from repro.launch import shardings as jsh
from repro.models import abstract_params as jabstract
from repro.models import init_cache as jinit_cache
from repro.models import param_axes as jparam_axes
from repro.models.params import spec_for as jspec_for
from repro_torch.configs import FLConfig, get_config
from repro_torch.core.tree import leaves_with_paths
from repro_torch.launch import inputs as inp
from repro_torch.launch import shardings as sh
from repro_torch.launch.mesh import fake_world, make_mesh, parse_mesh
from repro_torch.models import abstract_params, init_cache
from repro_torch.models.params import spec_to_placements
from repro_torch.optim import make_optimizer

_xla = os.environ.get("XLA_FLAGS")
from repro.launch.dryrun import resolve_strategy as jresolve  # noqa: E402
if _xla is None:          # the reference's dry run sets it on import
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _xla

from repro_torch.launch.dryrun import resolve_strategy  # noqa: E402

KINDS = {"train": "train_4k", "prefill": "prefill_32k",
         "decode": "decode_32k"}
MESHES = ("16x16", "2x16x16")
FL = dict(fl_clients_per_step=4, fl_local_steps=1)


def ref_mesh(spec):
    ms = parse_mesh(spec)
    fake = mock.Mock()
    fake.axis_names = ms.mesh_dim_names
    fake.devices = np.zeros(ms.shape)
    return fake


def _jpaths(tree, is_leaf=None):
    return {tuple(k.key for k in p): v for p, v in
            jax.tree_util.tree_leaves_with_path(tree, is_leaf=is_leaf)}


def _tpaths(tree):
    return dict(leaves_with_paths(tree))


def _assert_specs(port, ref, what):
    assert sorted(port) == sorted(ref), what
    for path in ref:
        assert port[path] == tuple(ref[path]), (what, path, port[path],
                                                ref[path])


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_policy_matches_reference(arch, kind, mesh):
    jcfg, tcfg = jget(arch), get_config(arch)
    shape = SHAPES[KINDS[kind]]
    ms, jm = parse_mesh(mesh), ref_mesh(mesh)
    multi = mesh == "2x16x16"
    assert sh.needs_fsdp(tcfg, kind) == jsh.needs_fsdp(jcfg, kind)
    strategies = ["tp"]
    picked = jresolve(jcfg, kind, "auto")
    assert resolve_strategy(tcfg, kind, "auto") == picked
    if picked != "tp":
        strategies.append(picked)
    p_abs = abstract_params(tcfg)
    jp_abs = jabstract(jcfg)
    jaxes = _jpaths(jparam_axes(jcfg), is_leaf=jsh._is_axes)
    jshapes = _jpaths(jp_abs)
    for strategy in strategies:
        prules = sh.param_rules(tcfg, kind, multi, strategy)
        arules = sh.act_rules(tcfg, kind, multi, strategy)
        jprules = jsh.param_rules(jcfg, kind, multi, strategy)
        jarules = jsh.act_rules(jcfg, kind, multi, strategy)
        assert prules == jprules and arules == jarules
        # params (and the optimizer moments, placed as their params)
        ref = {p: jspec_for(tuple(jshapes[p].shape), a, jprules, jm)
               for p, a in jaxes.items()}
        _assert_specs(_tpaths(sh.param_specs(tcfg, ms, prules, p_abs)),
                      ref, "params")
        psh = sh.param_shardings(tcfg, ms, prules, p_abs)
        if kind == "train":
            state = make_optimizer(sh_opt(), stacked=False)[0](p_abs)
            osh = sh.opt_state_shardings(state, psh, ms)
            for tree in (osh.mu, osh.nu):
                got = _tpaths(tree)
                for p, spec in ref.items():
                    assert got[p] == spec_to_placements(tuple(spec), ms), p
        # batch
        if kind == "train":
            b, jb = (inp.train_batch_specs(tcfg, shape, FLConfig(**FL)),
                     jinp.train_batch_specs(jcfg, shape, JFL(**FL)))
        elif kind == "prefill":
            b, jb = (inp.prefill_batch_specs(tcfg, shape),
                     jinp.prefill_batch_specs(jcfg, shape))
        else:
            b, jb = ({"tokens": inp.decode_token_specs(shape)},
                     {"tokens": jinp.decode_token_specs(shape)})
        lead = kind == "train"
        ref = {}
        for p, leaf in _jpaths(jb).items():
            axes = tuple(jsh._BATCH_AXES.get(p[-1], ()))
            axes = ((None,) + axes if lead else axes)[:len(leaf.shape)]
            axes = axes + (None,) * (len(leaf.shape) - len(axes))
            ref[p] = jspec_for(tuple(leaf.shape), axes, jarules, jm)
        _assert_specs(_tpaths(sh.batch_specs(b, ms, arules, lead)), ref,
                      "batch")
        # decode cache
        if kind == "decode":
            cache_len, enc_len = inp.cache_len_for(tcfg, shape)
            cache = init_cache(tcfg, shape.global_batch, cache_len,
                               enc_len=enc_len, device="meta")
            jc = jax.eval_shape(lambda: jinit_cache(
                jcfg, shape.global_batch, cache_len,
                dtype=jnp.dtype(jcfg.compute_dtype), enc_len=enc_len))
            ref = {tuple(k.key for k in p): jspec_for(
                tuple(leaf.shape), jsh._cache_leaf_axes(p, leaf), jarules,
                jm) for p, leaf in jax.tree_util.tree_leaves_with_path(jc)}
            _assert_specs(_tpaths(sh.cache_specs(cache, ms, arules)), ref,
                          "cache")
    # local shapes on a fake world of the mesh's size
    prules = sh.param_rules(tcfg, kind, multi, "tp")
    jprules = jsh.param_rules(jcfg, kind, multi, "tp")
    sizes = dict(zip(ms.mesh_dim_names, ms.shape))
    with fake_world(int(np.prod(ms.shape))):
        dm = make_mesh(ms.shape, ms.mesh_dim_names, "cpu")
        dist = sh.distribute_tree(p_abs, sh.param_shardings(
            tcfg, dm, prules, p_abs), dm)
        for p, t in leaves_with_paths(dist):
            spec = jspec_for(tuple(jshapes[p].shape), jaxes[p], jprules, jm)
            want = list(jshapes[p].shape)
            for d, entry in enumerate(spec):
                names = () if entry is None else (
                    (entry,) if isinstance(entry, str) else entry)
                want[d] //= int(np.prod([sizes[n] for n in names]))
            assert t.is_meta and tuple(t.to_local().shape) == tuple(want), p


def sh_opt():
    from repro_torch.configs import OptimizerConfig
    return OptimizerConfig(name="adamw")
