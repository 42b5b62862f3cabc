"""The one-card dry run of the PyTorch port (``repro_torch.launch.dryrun``,
``models.abstract_params``, ``init_cache`` on ``meta``,
``roofline.analysis`` and ``roofline.report``) against the reference on
the CPU, at full width: nothing is allocated on either side (the
reference's trees are ``ShapeDtypeStruct``s, its caches taken through
``jax.eval_shape``).  Shapes, dtypes, FLOP counts and the long-context
policy must be equal, not close."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget
from repro.launch import inputs as jinp
from repro.models import abstract_params as j_abstract_params
from repro.models import init_cache as j_init_cache
from repro.roofline.analysis import model_flops as j_model_flops
from repro_torch.configs import ASSIGNED_ARCHS, SHAPES, get_config
from repro_torch.core.tree import leaves_with_paths
from repro_torch.launch import dryrun
from repro_torch.launch import inputs as inp
from repro_torch.launch.mesh import parse_mesh
from repro_torch.models import abstract_params, init_cache
from repro_torch.roofline import analysis as rl
from repro_torch.roofline import report

# every (arch, decode shape) cell the dry run resolves (whisper-tiny skips
# long_500k: test_exactly_one_cell_is_skipped)
DECODE_CELLS = [(a, s) for a in ASSIGNED_ARCHS for s, v in SHAPES.items()
                if v.kind == "decode"
                and dryrun.resolve_config(a, s)[0] is not None]


def _reference_resolve_config():
    """``repro.launch.dryrun.resolve_config`` and ``optimizer_for``.
    Importing the reference's dry run sets ``XLA_FLAGS`` (512 host
    devices) for backends not yet started: start this process's first,
    then give the variable back so that subprocesses do not inherit it."""
    import os
    jax.devices()
    before = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.dryrun import optimizer_for, resolve_config
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    return resolve_config, optimizer_for


def _same_tree(port, ref, what):
    jl = jax.tree_util.tree_leaves_with_path(ref)
    tl = list(leaves_with_paths(port))
    assert [tuple(k.key for k in p) for p, _ in jl] == [p for p, _ in tl], \
        what
    for (path, r), (_, t) in zip(jl, tl):
        name = f"{what}: " + "/".join(k.key for k in path)
        assert t.device.type == "meta", name
        assert tuple(t.shape) == tuple(r.shape), name
        assert str(t.dtype).replace("torch.", "") == str(r.dtype), name


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_abstract_params_match_reference(arch):
    _same_tree(abstract_params(get_config(arch)),
               j_abstract_params(jget(arch)), arch)
    _same_tree(abstract_params(get_config(arch), "float32"),
               j_abstract_params(jget(arch), jnp.float32), arch)


@pytest.mark.parametrize("arch,shape", DECODE_CELLS)
def test_meta_cache_shapes_match_reference(arch, shape):
    resolve, _ = _reference_resolve_config()
    jcfg, _notes = resolve(arch, shape)
    cfg, _notes = dryrun.resolve_config(arch, shape)
    b = SHAPES[shape].global_batch
    cache_len, enc_len = inp.cache_len_for(cfg, SHAPES[shape])
    want = jax.eval_shape(lambda: j_init_cache(jcfg, b, cache_len,
                                               enc_len=enc_len))
    got = init_cache(cfg, b, cache_len, enc_len=enc_len, device="meta")
    # the reference's pos is a 0-d int32 like the port's
    _same_tree(got, want, f"{arch} {shape}")


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_model_flops_and_config_resolution_match_reference(arch):
    resolve, optimizer_for = _reference_resolve_config()
    for shape in SHAPES:
        jcfg, jnotes = resolve(arch, shape)
        cfg, notes = dryrun.resolve_config(arch, shape)
        assert notes == jnotes, (arch, shape)
        if jcfg is None:
            assert cfg is None
            continue
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert rl.model_flops(cfg, SHAPES[shape]) == j_model_flops(
            jcfg, JSHAPES[shape]), (arch, shape)
        assert dataclasses.asdict(dryrun.optimizer_for(cfg)) == \
            dataclasses.asdict(optimizer_for(jcfg))


def test_exactly_one_cell_is_skipped():
    resolve, _ = _reference_resolve_config()
    skipped = [(a, s) for a in ASSIGNED_ARCHS for s in SHAPES
               if dryrun.resolve_config(a, s)[0] is None]
    assert skipped == [("whisper-tiny", "long_500k")]
    assert [(a, s) for a in ASSIGNED_ARCHS for s in SHAPES
            if resolve(a, s)[0] is None] == skipped


def test_inputs_of_the_frontends_use_the_reference_frame_count():
    cfg = get_config("whisper-tiny")
    spec = inp.prefill_batch_specs(cfg, SHAPES["prefill_32k"])["frames"]
    want = jinp.prefill_batch_specs(jget("whisper-tiny"),
                                    JSHAPES["prefill_32k"])["frames"]
    assert tuple(spec.shape) == want.shape
    assert spec.shape[1] == inp.AUDIO_ENC_FRAMES == 1500


def test_dry_run_writes_json_and_report_renders(tmp_path):
    """Two archs through ``main``: every cell a JSON record with the
    counts, the report's two tables over them; a cut-down train cell that
    fits the card (rwkv6-3b, 8 layers, 4 sequences in fp32: the train case
    chip_smoke.py drives) and its bytes."""
    for arch in ("olmo-1b", "whisper-tiny"):
        assert dryrun.main(["--arch", arch, "--out", str(tmp_path)]) == 0
    recs = report.load(tmp_path)
    assert len(recs) == 8
    skipped = recs[("whisper-tiny", "long_500k")]
    assert skipped["status"] == "skipped" and skipped["notes"]
    olmo = recs[("olmo-1b", "train_4k")]
    assert olmo["status"] == "ok" and olmo["optimizer"] == "adamw"
    assert olmo["param_bytes"] == 2 * olmo["params"]          # bfloat16
    assert olmo["opt_state_bytes"] == 8 * olmo["params"]      # fp32 m, v
    assert olmo["fedavg_buffer_bytes"] == 2 * olmo["param_bytes"]
    assert olmo["roofline"]["dominant"] == "compute_s"
    assert olmo["model_flops"] == 6.0 * get_config(
        "olmo-1b").active_param_count() * 256 * 4096
    dec = recs[("olmo-1b", "decode_32k")]
    assert dec["cache_bytes"] > 0 and dec["opt_state_bytes"] == 0
    assert 0 <= dec["max_depth_fit"] < dec["num_layers"] and not dec["fits"]
    assert recs[("olmo-1b", "long_500k")]["fits"]
    roof, table = report.roofline_table(recs), report.dryrun_table(recs)
    assert "| olmo-1b | train_4k |" in roof and "compute" in roof
    assert "| whisper-tiny | long_500k |" in table and "skipped" in table
    assert "| rwkv6-3b | train_4k | - |" in roof           # not run: missing
    rec = dryrun.run_one("rwkv6-3b", "train_4k", save=False,
                         changes=dict(num_layers=8, param_dtype="float32",
                                      compute_dtype="float32"),
                         global_batch=4)
    assert rec["fits"] and rec["max_depth_fit"] == 8
    assert rec["params"] * 4 == rec["param_bytes"]
    assert json.loads(json.dumps(rec)) == rec
    assert rec["peak_flops"] == rl.PEAK_FLOPS


def test_abstract_params_allocate_nothing():
    """The full-width jamba tree (398 B parameters) on ``meta``."""
    tree = abstract_params(get_config("jamba-1.5-large-398b"))
    leaves = [t for _p, t in leaves_with_paths(tree)]
    assert all(t.device.type == "meta" for t in leaves)
    n = sum(t.numel() for t in leaves)
    assert n > 390e9
    assert all(t.dtype == torch.bfloat16 for t in leaves)


# serving cells traced on a small fake world: (arch, shape, strategy,
# mesh); prefill at 2048 tokens (the meta trace walks the blockwise
# attention's tiles one by one), past gemma3's local window of 1024;
# rwkv6-3b's 40 heads do not divide a model dim of 16 (the decode step's
# head views)
SERVE_TRACE = [("gemma3-27b", "prefill_32k", "tp", "2x2"),
               ("llama3.2-3b", "prefill_32k", "auto", "2x2"),
               ("gemma3-27b", "decode_32k", "tp", "2x2"),
               ("gemma3-27b", "long_500k", "tp", "2x2"),
               ("whisper-tiny", "long_500k", "auto", "2x2"),
               ("rwkv6-3b", "decode_32k", "tp", "2x16")]


@pytest.mark.parametrize("arch,shape,strategy,mesh", SERVE_TRACE)
def test_serving_cells_trace_their_collectives(arch, shape, strategy, mesh):
    """Prefill and decode cells on a small ``fake_world``: each step's
    collectives traced (link bytes above 0; llama3.2-3b's prefill
    sequence-parallel under auto), and a cell the reference skips stays
    skipped, untraced."""
    resolve, _ = _reference_resolve_config()
    kind = SHAPES[shape].kind
    rec = dryrun.run_one(arch, shape, save=False, mesh=mesh,
                         strategy=strategy,
                         seq_len=2048 if kind == "prefill" else None)
    if resolve(arch, shape)[0] is None:
        assert rec["status"] == "skipped"
        assert "collective_bytes_total" not in rec
        return
    assert rec["status"] == "ok", rec.get("error")
    assert rec["kind"] == kind
    assert rec["num_devices"] == int(np.prod(parse_mesh(mesh).shape))
    assert rec["collective_bytes_total"] > 0
    assert rec["collective_s"] > 0
    assert sum(rec["collective_op_counts"].values()) > 0
    want = "seq_parallel" if arch == "llama3.2-3b" else "tp"
    assert rec["strategy"] == want
